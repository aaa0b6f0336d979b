"""The readings that set the limits of the comparison that decides
``correct``: a cell run on many seeds, each with the check the benchmark's
runs make and, beside it, the bfloat16 control judged against the same
reference, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> ... [--trace 1]

Prints one JSON line a seed (the sound reading ``compared``, the control's
``control``, and with ``--trace 1`` the traced run's per-layer metrics and
breakdown) and a last line with the largest sound and the smallest control
reading of each number. On the cards of this machine only.
"""

import argparse
import json
import sys

from harness import env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--seeds", required=True, type=int, nargs="+")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.prepare()
    import torch

    from harness import spec
    from harness.cell import run

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("control: %s needs %d CUDA card(s)" % (cell.name, cell.chips),
              file=sys.stderr)
        return 2
    sound, ctrl = {}, {}
    for seed in args.seeds:
        out = run(cell, seed, args.seconds, bool(args.trace), control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "metrics": out["metrics"], "device": out["device"],
                          "seconds": out["seconds"],
                          "breakdown": out.get("breakdown"),
                          "compared": out["compared"],
                          "control": out["control"]}), flush=True)
        for k, v in out["compared"].items():
            sound[k] = max(sound.get(k, v["value"]), v["value"])
        for k, v in out["control"].items():
            ctrl[k] = min(ctrl.get(k, v["value"]), v["value"])
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds),
                      "sound_max": sound, "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
