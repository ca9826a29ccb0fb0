"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many NVIDIA cards as
the cell asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted`` (steps in the window), ``failed`` (compared
numbers over their limits), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers close standard error.  Without a card, with fewer cards
than the cell asks for, or with a JAX module loaded at the end, it prints
no result and exits with 1.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "marlin_tpu")


def forbidden_modules(modules) -> list:
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    set_cache_dirs()

    import torch

    from portbench import harness

    chips = int(harness.workload(harness.benchmark(), ns.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(ns.workload, ns.seed, ns.seconds, bool(ns.trace),
                              device="cuda", started=STARTED)
    record = result.pop("record")
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: JAX modules loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    phases = {k: record[k] for k in ("import_s", "cuda_init_s", "init_s", "first_step_s",
                                     "warm_steps_s", "setup_s", "window_s", "steps",
                                     "chunk") if k in record}
    print("portbench: " + json.dumps(phases), file=sys.stderr)
    roofline = harness.module("metrics", "substep_roofline")
    print(f"portbench: a substep's least time "
          f"{1e3 * roofline.bound_s(record['work'], record['peaks']):.4f} ms, bound by "
          f"{roofline.binds(record['work'], record['peaks'])}", file=sys.stderr)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
