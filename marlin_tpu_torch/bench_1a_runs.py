"""Benchmark 1a (``decks.BENCH_1A_DECK``) whole on several routes, compared
step by step.

    python -m marlin_tpu_torch.bench_1a_runs [--device cuda|cpu] [--n 200]
        [--substeps 1000] [--runs D64,D32,P32,F32] [--seeds 1,2]
        [--noise 2e-7] [--workers 1] [--transforms twin] [--out FILE.json]

Routes: ``D64`` and ``D32`` are ``fft_backend = DEFAULT`` (torch.fft) in
float64 and float32, ``P32`` is ``fft_backend = PALLAS`` in float32 (the
unordered-FFT kernels, or their twins on the CPU), ``F32`` is PALLAS with
``carry_reciprocal`` and ``fused_spectral``.  Each route runs from the
deck's c(0) and, for every seed in ``--seeds``, from c(0) + noise·(U − ½),
U a ``RandomTensor`` with that seed.  Every run goes through ``run_deck``
to its end (t = 10500, or the Terminator), on ``--workers`` processes at
once (on the CPU; on the card keep 1, so that runs do not share it).

On the CPU, ``--transforms`` swaps the unordered transforms' plain twins
(which the wrappers compute on a CPU tensor) for correctly rounded ones,
to tell the permuted layout from the twins' float32 arithmetic: ``exact``
both directions (torch.fft in complex128, permuted, rounded once to
complex64; the inverse divided by n), ``exact-fwd`` or ``exact-inv`` one
direction, the twins the other; ``twin`` (the default) swaps nothing.

The first run is the reference.  For each run the script prints its steps,
seconds, F(0), final F beside the reference's and the drift of
``c_integral`` from its start (relative); for each other run, the first
step at which its F leaves the reference's by more than 1e-6, 1e-5, …,
1e-1 of it, and the first at which c's minimum or maximum leaves the
reference's by more than the same amounts.  ``--out`` keeps the per-step
rows as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import sys
import tempfile
import time

ROUTES = {
    # route: ([Domain] lines, [TensorSolver] lines)
    "D64": ("floating_precision = DOUBLE", ""),
    "D32": ("floating_precision = SINGLE", ""),
    "P32": ("fft_backend = PALLAS\n  floating_precision = SINGLE", ""),
    "F32": ("fft_backend = PALLAS\n  floating_precision = SINGLE",
            "carry_reciprocal = true\n  fused_spectral = true"),
}
LEVELS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


def deck_text(route: str, n: int, substeps: int, seed=None, noise=0.0) -> str:
    """``decks.BENCH_1A_DECK`` on ``route``, its c(0) perturbed by
    noise·(U − ½) where ``seed`` is given."""
    from marlin_tpu_torch.decks import BENCH_1A_DECK

    domain, solver = ROUTES[route]
    deck = BENCH_1A_DECK.format(n=n, substeps=substeps, domain_extra=domain,
                                solver_extra=solver)
    if seed is None:
        return deck
    head = "  [Initialize]\n    [c]\n"
    noise_block = ("  [Initialize]\n    [noise]\n      type = RandomTensor\n"
                   "      buffer = noise\n      min = 0\n      max = 1\n"
                   f"      seed = {seed}\n    []\n    [c]\n")
    tail = "cos(0.07*x-0.02*y))'"
    assert deck.count(head) == 1 and deck.count(tail) == 1
    return deck.replace(head, noise_block).replace(
        tail, f"cos(0.07*x-0.02*y)) + {noise!r}*(noise-0.5)'\n      inputs = noise")


def exact_twins(which: str):
    """Swap the plain twins of ``which`` ("fwd", "inv" or both) for
    correctly rounded transforms in the kernels' permuted order."""
    import torch

    from marlin_tpu_torch import unordered_fft as uf

    def perm(n):
        order = torch.from_numpy(uf.true_k_order(n))
        return order, torch.argsort(order)

    def fwd(x):
        order, _ = perm(x.shape[-1])
        return torch.fft.fft(x.to(torch.complex128), dim=-1)[:, order].to(torch.complex64)

    def inv(x, real_output=True):
        _, back = perm(x.shape[-1])
        y = torch.fft.ifft(x.to(torch.complex128)[:, back], dim=-1)
        return y.real.to(torch.float32).contiguous() if real_output else y.to(torch.complex64)

    if "fwd" in which:
        uf.fwd_lanes_plain = fwd
        uf.fwd_sublanes_plain = lambda x: uf._sublanes_via_lanes(fwd, x)
    if "inv" in which:
        uf.inv_lanes_plain = inv
        uf.inv_sublanes_plain = lambda x: uf._sublanes_via_lanes(inv, x, False)


TRANSFORMS = {"twin": "", "exact": "fwd inv", "exact-fwd": "fwd", "exact-inv": "inv"}


def one_run(route: str, n: int, substeps: int, seed, noise: float, device: str,
            threads: int, transforms: str = "twin"):
    """One whole run; returns its label, wall seconds and CSV rows."""
    import torch

    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    if device == "cpu":
        torch.set_num_threads(threads)
    if TRANSFORMS[transforms]:
        assert device == "cpu", "--transforms swaps the CPU twins only"
        exact_twins(TRANSFORMS[transforms])
    label = route if seed is None else f"{route} seed {seed}"
    if transforms != "twin" and route in ("P32", "F32"):
        label += f" ({transforms} transforms)"
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        deck = deck_text(route, n, substeps, seed, noise)
        tr = run_deck(hit.parse(deck.replace("  perf_graph = true\n", "")),
                      output_dir=out_dir, device=device)
        wall = time.perf_counter() - t0
    return label, wall, [dict(r) for r in tr.csv.rows]


def f_apart(a, b):
    """F's difference, relative."""
    return abs(a["F"] - b["F"]) / abs(b["F"])


def c_apart(a, b):
    """The larger difference of c's extremes (c is about ½; no spectral
    convention enters them, where F's gradient term sees the Nyquist sign)."""
    return max(abs(a["c_min"] - b["c_min"]), abs(a["c_max"] - b["c_max"]))


def first_parted(rows, ref, apart):
    """For each level, the first step at which ``apart`` exceeds it (None:
    never)."""
    return {level: next((i for i, (a, b) in enumerate(zip(rows, ref))
                         if apart(a, b) > level), None) for level in LEVELS}


def drift(rows):
    c0 = rows[0]["c_integral"]
    return max(abs(r["c_integral"] - c0) for r in rows) / abs(c0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--substeps", type=int, default=1000)
    ap.add_argument("--runs", default="D64,D32,P32,F32")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--noise", type=float, default=2e-7)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--threads", type=int, default=2, help="torch threads a CPU worker")
    ap.add_argument("--transforms", default="twin", choices=list(TRANSFORMS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    seeds = [None] + [int(s) for s in args.seeds.split(",") if s]
    jobs = [(route, args.n, args.substeps, seed, args.noise, args.device, args.threads,
             args.transforms) for route in args.runs.split(",") for seed in seeds]
    if args.workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
            results = list(pool.map(one_run, *zip(*jobs)))
    else:
        results = [one_run(*job) for job in jobs]
    where = args.device
    if args.device.startswith("cuda"):
        import subprocess

        where = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.splitlines()[0]
    ref_label, _, ref = results[0]
    print(f"[1a runs] {args.n}^2, {args.substeps} substeps a step, noise {args.noise!r} "
          f"on the seeded runs; reference {ref_label}; {where}")
    for label, wall, rows in results:
        line = (f"[1a runs] {label}: {len(rows) - 1} steps to t = {rows[-1]['time']}, "
                f"{wall:.3f} s, F(0) {rows[0]['F']:.9f}, F_final {rows[-1]['F']:.9f} "
                f"({(rows[-1]['F'] - ref[-1]['F']) / ref[-1]['F']:+.4e} of {ref_label}'s), "
                f"c_integral drift {drift(rows):.3e}")
        print(line, flush=True)
        if label == ref_label or len(rows) != len(ref):
            continue
        for what, apart in (("F (relative)", f_apart), ("c_min or c_max", c_apart)):
            parted = first_parted(rows, ref, apart)
            print(f"[1a runs] {label}: {what} first parts from {ref_label}'s by more than "
                  + ", ".join(f"{lv:g} at step {i}" + (
                      "" if i is None else f" (t = {ref[i]['time']:.6g})")
                      for lv, i in parted.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"where": where, "runs": {label: {"seconds": wall, "rows": rows}
                                                for label, wall, rows in results}}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
