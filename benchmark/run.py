"""Run one cell of the benchmark once, and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see ``benchmark/README.md``).  Exits 2 without
a result when the cell's CUDA devices are missing, and 3 when a module of
JAX or of the JAX package was loaded.  ``--device cpu`` runs the plain
versions on the CPU for the tests; its numbers are not the device's.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from benchmark.harness import run_cell

    return run_cell(args)


if __name__ == "__main__":
    sys.exit(main())
