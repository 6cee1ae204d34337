"""The benchmark of the scheduler's PyTorch/CUDA port on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json (see kbench/driver.py) from the root of a
checkout and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each number the reference compared
with its limit.  The same numbers end standard error.  Exits non-zero
without a result when no CUDA card is there, when the cell needs more cards
than there are, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the kernel library builds into a fixed directory of the checkout, so
# that only the first run of a checkout compiles
os.environ["KUBETPU_KERNEL_CACHE_DIR"] = (
    os.path.join(HERE, ".kernel_cache"))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from kbench import driver, registry  # noqa: E402


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be non-negative", file=sys.stderr)
        return 2
    bench = registry.Benchmark(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print("the cell needs %d cards, %d found"
              % (chips, torch.cuda.device_count()), file=sys.stderr)
        return 3
    out = driver.run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_PROCESS, log=log)
    found = driver.forbidden_modules()
    if found:
        print("loaded after the window: %s" % ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print("check %s %s limit %s" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
