"""Readings that set a cell's limits, and the verdicts of the control and of
planted faults at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 3
    python3 -m benchmark.control --workload <cell> --seeds 14 --seconds 3 --faults state_unchanged,half_left_out

For each seed, in one process: the cell's entry runs with a short window at
the cell's own size and load, and its cases go through the comparison that
decides ``correct`` (``check.compare_cases``, the cell's limits): as the
program produced them (the lower reading), and with the control in the
program's place, the reference computed with a TF32 channelizer (the upper
reading).  With ``--faults`` the timed path runs with each fault planted in
turn (``faults.py``), and only the program is compared.  Prints one JSON line a
seed, each number beside its limit and each side's verdict.  The
benchmark's own runs never run this; the tests run it at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def verdict(numbers: dict, failed: int) -> bool:
    return failed == 0 and all(v["value"] <= v["limit"] for v in numbers.values())


def readings(cell: str, seeds, seconds: float, device: str = "cuda", files=None, fault: str | None = None):
    """Yields, a seed, {"seed", "program", "program_correct"} and, without a
    fault, {"control", "control_correct"}: each number with its limit."""
    import torch

    from benchmark import harness
    from benchmark.check import compare_cases, control_cases
    from benchmark.faults import planted

    workload, config, traffic = files if files is not None else harness.cell_files(cell)
    limits = workload["check"]["limits"]
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    entry = harness.load_module(harness.HERE / "entries" / f"{workload['entry']}.py", f"benchmark_entry_{workload['entry']}")
    for seed in seeds:
        ctx = harness.Context(cell, workload, config, traffic, int(seed), float(seconds), False, dev, harness.process_start())
        with planted(fault) if fault else contextlib.nullcontext():
            entry.run(ctx)
        prog = compare_cases(config, ctx.cases, limits)
        out = dict(seed=int(seed), attempted=ctx.attempted, failed=ctx.failed, program=prog,
                   program_correct=verdict(prog, ctx.failed) and ctx.attempted > 0)
        if fault:
            out["fault"] = fault
        else:
            ctrl = compare_cases(config, ctx.cases, limits, against=control_cases(config, ctx.cases))
            out.update(control=ctrl, control_correct=verdict(ctrl, ctx.failed))
        yield out


def main(argv=None) -> int:
    from benchmark.faults import KINDS

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="", help=f"comma-separated, of {', '.join(KINDS)}")
    args = ap.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]
    if set(faults) - set(KINDS):
        ap.error(f"unknown fault in {args.faults!r}")
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for fault in faults or [None]:
        for r in readings(args.workload, seeds, args.seconds, fault=fault):
            print(json.dumps(dict(workload=args.workload, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
