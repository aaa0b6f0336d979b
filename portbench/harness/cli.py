"""The command line of one run: ``run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Prints the result as the last line of
standard output and each compared number beside its limit as the last
lines of standard error. Exits 2, printing no result, without enough CUDA
cards, and 3 where the run loaded JAX or the JAX package."""

from __future__ import annotations

import argparse
import json
import sys

from . import guard, spec


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True, help="a workload of BENCHMARK.json")
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return ap.parse_args(argv)


def compared_lines(numbers: dict) -> list:
    return ["compared %s %s limit %s" % (k, v["value"], v["limit"])
            for k, v in numbers.items()]


def main(argv, t_process: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print("portbench: %s needs %d CUDA card(s), %d available"
              % (cell.name, cell.chips, n), file=sys.stderr)
        return 2
    from .cell import run

    out = run(cell, args.seed, args.seconds, bool(args.trace),
              t_process=t_process)
    bad = guard.forbidden_loaded()
    if bad:
        print("portbench: the run loaded %s" % ", ".join(bad), file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(compared_lines(out["compared"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
