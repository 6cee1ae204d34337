"""A CPU rehearsal of one cell at a small size, through the program's
plain kernels, to find faults in the harness before a run on the card.

    python3 benchmark/rehearse.py --workload <cell> --seed <n> \
        [--seconds 3] [--trace 0|1] [--nodes 64] [--batch 32]

It prints the result line of benchmark/run.py, with the CPU as its device.
Its numbers are no measurement: the benchmark's command refuses the CPU.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from kbench import driver, registry  # noqa: E402


def main(argv=None) -> int:
    t0 = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(2)
    out = driver.run_cell(
        registry.Benchmark(ROOT), args.workload, args.seed, args.seconds,
        bool(args.trace), "cpu", t0,
        shrink=dict(nodes=args.nodes, batch_size=args.batch),
        log=lambda o: print(json.dumps(o), flush=True))
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
