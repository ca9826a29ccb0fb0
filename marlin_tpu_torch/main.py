"""CLI entry point: run a MOOSE-format deck with the PyTorch port.

    python -m marlin_tpu_torch deck.i [path/to/param=value ...] [--compute-device cpu]
        [--timing] [--x64]

The device is ``--compute-device``, else ``MARLIN_TORCH_DEVICE``, else
``cuda`` (as marlin_tpu/main.py:41-51 reads them); without a card only an
explicit ``cpu`` runs.  ``--timing`` is ``[Outputs] perf_graph = true``;
``--x64`` makes ``floating_precision = DEVICE_DEFAULT`` (the default)
float64 on the card too.

Launched by ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node P -m marlin_tpu_torch deck.i``: ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK`` set), each process joins the default group, NCCL on
``cuda:LOCAL_RANK`` or gloo on the CPU (the counterpart of
marlin_tpu/main.py:84-91's ``jax.distributed.initialize``), and a deck
with ``[Domain] parallel_mode`` FFT_SLAB, FFT_PENCIL or REAL_SPACE runs on
the mesh of every process (``make_mesh``'s default: one axis of all the
ranks; a near-square p1 × p2 for FFT_PENCIL).  Another mesh, such as a
REAL_SPACE z cut, is ``run_deck(root, mesh=make_mesh("REAL_SPACE",
shape=(2, 1, 2)))`` in a script that torchrun launches.  Rank 0 alone
writes the CSV and prints.

Across hosts, torchrun's ``--nnodes``, ``--node_rank`` and
``--rdzv_endpoint`` set the same three variables.  Without them, the JAX
package's variables form the group (marlin_tpu/main.py:83-92):
``MARLIN_TPU_COORDINATOR`` (host:port of rank 0), ``MARLIN_TPU_NUM_PROCESSES``
and ``MARLIN_TPU_PROCESS_ID`` give ``init_method = tcp://<coordinator>``,
the world size and the rank.  The port runs one process a card, on
``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to 0), where the JAX package
runs one process a host.  A group that cannot form fails the run; it never
falls back to a serial run.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import device as _device
from . import hit
from .executioner import run_deck


def force_x64(root):
    """``--x64``: a deck whose precision is DEVICE_DEFAULT (set or left
    out) runs in float64 on every device; SINGLE and DOUBLE stay."""
    domain = root.children.get("Domain")
    if domain is not None and domain.get(
            "floating_precision", "DEVICE_DEFAULT") == "DEVICE_DEFAULT":
        domain.set_param("floating_precision", "DOUBLE")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="marlin_tpu_torch")
    parser.add_argument("-i", "--input", help="input deck")
    parser.add_argument("args", nargs="*", help="deck file and/or HIT overrides")
    parser.add_argument("--compute-device", default=None,
                        help=f"torch device (cuda, cpu); default "
                        f"${_device.ENV_VAR} or cuda")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--x64", action="store_true",
                        help="DEVICE_DEFAULT precision is float64 on every device")
    parser.add_argument("--timing", action="store_true",
                        help="print the perf-graph summary (same as "
                        "`[Outputs] perf_graph = true` in the deck)")
    ns = parser.parse_args(argv)

    deck = ns.input
    overrides = []
    for a in ns.args:
        if deck is None and "=" not in a:
            deck = a
        else:
            overrides.append(a)
    if deck is None:
        parser.error("no input deck given")
    dev = _device.from_cli(ns.compute_device)
    launch = launch_env(os.environ)
    launched = launch is not None
    if launched:
        dev = join_group(dev, *launch)

    root = hit.load(deck, overrides + (["Outputs/perf_graph=true"] if ns.timing else []))
    if ns.x64:
        force_x64(root)
    mesh = None
    domain = root.children.get("Domain")
    mode = domain.get("parallel_mode", "NONE") if domain is not None else "NONE"
    if launched and mode != "NONE":
        from .parallel import make_mesh

        mesh = make_mesh(mode)
    stem = os.path.splitext(os.path.basename(deck))[0]
    out_node = root.children.get("Outputs")
    file_base = out_node.get("file_base") if out_node is not None else None
    transient = run_deck(
        root,
        file_base=file_base or stem + "_out",
        # outputs land in the CWD (MOOSE semantics), not next to the deck
        output_dir=ns.output_dir or os.getcwd(),
        device=dev,
        deck_dir=os.path.dirname(os.path.abspath(deck)),
        deck_stem=stem,
        mesh=mesh,
    )
    if transient.rank0:
        print(f"Finished after {transient.step_count} steps, t = {transient.time}")
        for k, v in transient.pp_values.items():
            print(f"  {k} = {v}")
    if launched:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def launch_env(env):
    """(init_method, world size, rank) of the default group a launcher
    asks for, or None for a run of one process: torchrun's ``RANK`` and
    ``WORLD_SIZE`` (its rendezvous in ``MASTER_ADDR``/``MASTER_PORT``,
    read by ``env://``), else the JAX package's ``MARLIN_TPU_COORDINATOR``,
    ``MARLIN_TPU_NUM_PROCESSES`` and ``MARLIN_TPU_PROCESS_ID`` (defaults 1
    and 0, as marlin_tpu/main.py reads them)."""
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    coordinator = env.get("MARLIN_TPU_COORDINATOR")
    if coordinator:
        return (f"tcp://{coordinator}", int(env.get("MARLIN_TPU_NUM_PROCESSES", "1")),
                int(env.get("MARLIN_TPU_PROCESS_ID", "0")))
    return None


def join_group(dev, init_method="env://", world_size=None, rank=None):
    """Join the default process group: NCCL on ``cuda:LOCAL_RANK`` when
    the device is the card, gloo on the CPU.  Returns the rank's device.
    A group that cannot form fails the run."""
    import torch
    import torch.distributed as dist

    kw = dict(init_method=init_method)
    if init_method != "env://":
        kw.update(world_size=world_size, rank=rank)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return dev


if __name__ == "__main__":
    sys.exit(main())
