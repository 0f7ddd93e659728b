"""The readings that the cells' limits are set from, several seeds in one
process (set-up is long): for each seed, one run of the cell with its
window, the program's widest served-token gap and the float8 control's.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 10

One JSON line a seed. Not part of a benchmark run."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, spec  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, default=1)
    args = p.parse_args()
    import torch

    device = torch.device("cuda", 0)
    c = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        res = harness.run_cell(c, seed, args.seconds, False, device, t,
                               control=bool(args.control))
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=res["correct"],
                              found=res["found"], metrics=res["metrics"],
                              wall_s=time.time() - t)), flush=True)


if __name__ == "__main__":
    main()
