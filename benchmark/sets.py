"""Runs one cell of the benchmark several times, one process after another,
and reports each run and the spread of each metric.

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13 \
        --seconds 30 [--trace 1] [--out sets.json]

A spread is the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.  The
card's name and power limit are printed first.  Each run's result line,
exit code, wall seconds and the end of its standard error go to ``--out``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi: %s" % e


def one(workload, seed, seconds, trace, timeout):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [ln for ln in out.splitlines() if ln.strip()]
    result = None
    if rc == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    return dict(seed=seed, trace=trace, rc=rc, wall_s=time.time() - t0,
                result=result, info=lines[-2][:4000] if len(lines) > 1
                else None, stderr=err[-3000:])


def _save(path, name, runs, summary) -> None:
    """Write the runs so far (after each run, so that a cut call keeps
    them)."""
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(card=name, runs=runs, summary=summary), f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    name = card()
    print(json.dumps(dict(card=name, workload=args.workload)), flush=True)
    runs = []
    for s in args.seeds.split(","):
        r = one(args.workload, int(s), args.seconds, args.trace, args.timeout)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps(dict(
            seed=r["seed"], rc=r["rc"], wall_s=round(r["wall_s"], 2),
            correct=res.get("correct"),
            metrics={k: v["value"] for k, v in
                     res.get("metrics", {}).items()},
            checks=res.get("checks"),
            memory_peak_bytes=res.get("device", {}).get(
                "memory_peak_bytes"))), flush=True)
        if r["rc"] != 0:
            print(r["stderr"][-2000:], flush=True)
        _save(args.out, name, runs, None)
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    summary = {}
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in runs
                if r["result"] and k in r["result"]["metrics"]]
        summary[k] = dict(n=len(vals), median=statistics.median(vals),
                          spread=spread(vals))
    print(json.dumps(dict(summary=summary)), flush=True)
    _save(args.out, name, runs, summary)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
