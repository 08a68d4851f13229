"""Readings that the limits of `correct` are set from, many seeds in one
process and without a window. Each seed goes through a run's own path
(`run.load`, `run.program_cell` and its set-up with the three checked
steps, `run.checked_facts`, `run.judged`, `check.judge` against the cell's
limits); with `--control`, the reference computed in the precision below
the configuration's (`check.CONTROL`) stands in the program's place and
is judged the same way. `--fault NAME` plants a fault of
`portbench/faults.py` in the program.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 [--control] [--fault half_batch]

Prints one JSON line a seed (the numbers and `correct` of each side), then
one with the largest of each number and whether every seed's program and
no seed's control came out correct.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import numpy as np
import torch


def readings(workload, seeds, control=False, fault=None, device="cuda", overrides=None):
    from portbench import check, run
    from portbench.counts import compute_dtype
    from portbench.faults import FAULTS
    from portbench.reference.precision import Precision

    c = run.load(workload, overrides)
    dev = torch.device(device)
    out = []
    for seed in seeds:
        cell = run.program_cell(c, seed, dev)
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            try:
                cell.setup()
                facts = run.checked_facts(cell)
            finally:
                cell.close()
        del cell
        gc.collect()
        nums, refr = run.judged(c, seed, facts, dev)
        correct, _ = check.judge(nums, c["limits"])
        prog = check.program_side(facts["readings"])
        row = dict(seed=seed, program=nums, correct=correct,
                   program_steps=_per_step(prog, refr, facts["active"]))
        if control:
            q = Precision(check.CONTROL[getattr(torch, compute_dtype(c["config"], dev))])
            ctl = check.reference(c["config"], seed, facts["n_slots"], len(prog["losses"]),
                                  facts["frames"], facts["objects"], dev, q)
            row["control"] = check.compare(ctl, refr, facts["active"])
            row["control_correct"], _ = check.judge(row["control"], c["limits"])
            row["control_steps"] = _per_step(ctl, refr, facts["active"])
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def _per_step(side, refr, active):
    """The loss gap of each checked step, worst slot and median slot."""
    idx = np.flatnonzero(active)
    gap = (np.abs(np.asarray(side["losses"])[:, idx] - refr["losses"][:, idx])
           / np.abs(refr["losses"][:, idx]))
    return dict(worst=gap.max(1).tolist(), median=np.median(gap, 1).tolist())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control,
                    args.fault)
    top = {}
    for row in rows:
        for side in ("program", "control"):
            for k, v in row.get(side, {}).items():
                top.setdefault(side, {})[k] = max(top.get(side, {}).get(k, 0.0), v)
    print(json.dumps({"workload": args.workload, "fault": args.fault, "max": top,
                      "program_correct_every_seed": all(r["correct"] for r in rows),
                      "control_correct_no_seed": not any(r.get("control_correct", False)
                                                         for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
