"""The two readings each compared number's limit is set from.

    python3 -m portbench.calibrate --workload <name> --seeds 101,102,...
        [--control-seeds 101,102,103] [--seconds 8] [--out chiprun_out/x.json]

For each seed, one run of the cell in this process (its set-up, a short
window of ``--seconds`` at the cell's own sizes, the comparison): the
program's readings.  For the control seeds, also the control's: the plain
reference stored in bfloat16, the precision below the configuration's
float32, put in the program's place.  Prints, for each number, the
largest reading of the program (the lower reading) and the smallest of
the control (the upper reading), and writes every reading to ``--out``.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys

import torch

from portbench import harness


def summary(program, control):
    keys = list(program[0]) if program else []
    return {k: {"lower": max(r[k] for r in program),
                "upper": min(r[k] for r in control) if control else None}
            for k in keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    seeds = [int(s) for s in ns.seeds.split(",") if s]
    controls = {int(s) for s in ns.control_seeds.split(",") if s}
    program, control, runs = [], [], []
    for seed in sorted(set(seeds) | controls):
        r = harness.run_cell(ns.workload, seed, ns.seconds, False, control=seed in controls)
        readings = {k: c["value"] for k, c in r["checks"].items()}
        row = {"seed": seed, "steps": r["attempted"], "program": readings,
               "control": r.get("control")}
        runs.append(row)
        if seed in seeds:
            program.append(readings)
        if r.get("control"):
            control.append(r["control"])
        print(json.dumps(row), flush=True)
    out = {"workload": ns.workload, "device": torch.cuda.get_device_name(),
           "summary": summary(program, control), "runs": runs}
    print(json.dumps(out["summary"]), flush=True)
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
