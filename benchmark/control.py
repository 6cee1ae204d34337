"""The control of the benchmark's correctness check, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--cycles 30] [--kind uniform|feasible]

A control takes the program's place in the cell's closed loop and breaks
one of the configuration's guarantees (kbench/reference.control_binds):
``uniform`` binds every pod to a node drawn uniformly, with neither filter
nor score; ``feasible`` keeps every filter and draws among the feasible
nodes, breaking the scoring alone.  For each seed it prints the numbers
the reference compares and the cell's limits; one of them must read above
its limit.  It runs on the host alone.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from kbench import reference, registry, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cycles", type=int, default=30)
    ap.add_argument("--kind", choices=reference.CONTROLS, default="uniform")
    args = ap.parse_args(argv)
    bench = registry.Benchmark(os.path.dirname(HERE))
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(args.workload)
    fails = True
    for s in args.seeds.split(","):
        world = spec.build_world(config, mix, int(s), bench.plugins)
        nums = reference.control_run(world, int(s), args.cycles,
                                     config["reference_scores"], args.kind)
        over = {k: nums[k] > v for k, v in limits.items()}
        fails = fails and any(over.values())
        print(json.dumps(dict(workload=args.workload, kind=args.kind,
                              seed=int(s),
                              numbers=nums, limits=limits, over=over)),
              flush=True)
    return 0 if fails else 1


if __name__ == "__main__":
    sys.exit(main())
