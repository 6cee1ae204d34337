"""Device-memory capacity planner over a devstats residency-ledger
snapshot.

The twin of tools/devplan.py over the port's ledger
(kubetpu_torch/utils/devstats.py): it projects the per-table byte
formulas a live run registered to an arbitrary (nodes, pods) shape and
answers OFFLINE whether it fits one card's memory, per shard of a mesh
over the pod axis, before a run finds out by OOM.

The ledger snapshot comes from any of:
  * a saved /debug/devicez document ({"ledger": {...}}),
  * a benchmark artifact ({"detail": {<case>: {"device": ...}}} — the
    planner falls back to any embedded "ledger" object it finds),
  * a raw ledger dump ({"entries": {...}}).

The capacity is the card's: ``KUBETPU_HBM_GIB`` (GiB per card), else the
current CUDA card's memory; with neither (a CPU-only host) the input is
unusable.

Usage:
  python -m kubetpu_torch.devplan LEDGER.json --nodes 10000 --pods 100000 \
      [--shards 8] [--json]

Exit status: 0 when the projection fits per shard, 2 when it does not
(so a deploy pipeline can gate on it), 1 on unusable input.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

from .utils.devstats import hbm_bytes, project  # noqa: F401


def find_ledger(doc: Any) -> Optional[Dict[str, Any]]:
    """Locate the first devstats ledger object ({"entries": {...}})
    inside any of the supported document shapes (devicez dump, bench
    detail, raw ledger)."""
    if not isinstance(doc, dict):
        return None
    entries = doc.get("entries")
    if isinstance(entries, dict) and all(
            isinstance(v, dict) and "tables" in v
            for v in entries.values()):
        return doc
    for key in ("ledger", "device", "detail"):
        found = find_ledger(doc.get(key))
        if found is not None:
            return found
    for v in doc.values():
        if isinstance(v, dict):
            found = find_ledger(v)
            if found is not None:
                return found
    return None


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.2f} GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="devplan",
        description="project a devstats residency ledger to arbitrary "
                    "(nodes, pods) and check the per-shard fit in one card's memory")
    ap.add_argument("ledger", help="JSON carrying a devstats ledger "
                                   "(devicez dump, bench artifact, or "
                                   "raw ledger)")
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--pods", type=int, required=True)
    ap.add_argument("--shards", type=int, default=1,
                    help="mesh shards over the pod axis (default 1)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw projection document")
    args = ap.parse_args(argv)

    try:
        with open(args.ledger) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"devplan: unreadable ledger {args.ledger!r}: {e}",
              file=sys.stderr)
        return 1
    ledger = find_ledger(doc)
    if ledger is None or not ledger.get("entries"):
        print("devplan: no devstats ledger entries found in "
              f"{args.ledger!r} (arm KUBETPU_DEVSTATS=1 and capture "
              "/debug/devicez or a bench 'device' block)",
              file=sys.stderr)
        return 1
    if hbm_bytes() is None:
        print("devplan: no card memory to plan against (no CUDA device; "
              "set KUBETPU_HBM_GIB)", file=sys.stderr)
        return 1

    proj = project(ledger, args.nodes, args.pods, shards=args.shards)
    if args.json:
        print(json.dumps(proj, indent=1, sort_keys=True))
    else:
        print(f"projection @ {args.nodes} nodes x {args.pods} pods "
              f"(pod bucket {proj['pod_bucket']}, "
              f"{args.shards} shard(s)):")
        for key, b in sorted(proj["per_group_bytes"].items(),
                             key=lambda kv: -kv[1]):
            print(f"  {key:<40} {_fmt_bytes(b):>12}")
            tables = sorted(
                ((n[len(key) + 1:], tb)
                 for n, tb in proj["per_table_bytes"].items()
                 if n.startswith(key + "/")), key=lambda kv: -kv[1])
            for name, tb in tables[:6]:
                print(f"    {name:<38} {_fmt_bytes(tb):>12}")
        print(f"  {'TOTAL (one card)':<40} "
              f"{_fmt_bytes(proj['total_bytes']):>12}")
        print(f"  {'per shard (pod axis / %d)' % args.shards:<40} "
              f"{_fmt_bytes(proj['per_shard_bytes']):>12}")
        print(f"  memory per card: {_fmt_bytes(proj['hbm_bytes_per_chip'])}"
              f" -> fits one card: {proj['fits_single_chip']}, "
              f"fits per shard: {proj['fits_per_shard']}")
    return 0 if proj["fits_per_shard"] else 2


if __name__ == "__main__":
    sys.exit(main())
