"""CLI of the kernel-artifact builder.

  python -m kubetpu_torch.kubeaot build DIR     nvcc every ops/csrc/ library into DIR
  python -m kubetpu_torch.kubeaot check DIR     can DIR serve this machine and sources?
  ... --json                                    machine-readable report

Exit codes: 0 = built, or DIR matches this machine's environment key and
these sources' digests; 1 = a build failed, or DIR cannot serve here.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.aot import check_store
from . import build_store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeaot")
    ap.add_argument("op", choices=("build", "check"))
    ap.add_argument("dir", help="the artifact directory")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON")
    args = ap.parse_args(argv)
    if args.op == "build":
        from ..ops._build import KernelError
        try:
            rows = build_store(args.dir)
            doc = {"op": "build", "dir": args.dir, "rows": rows,
                   "clean": True}
        except KernelError as e:
            doc = {"op": "build", "dir": args.dir, "error": str(e),
                   "clean": False}
    else:
        failures = check_store(args.dir)
        doc = {"op": "check", "dir": args.dir, "failures": failures,
               "clean": not failures}
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        for r in doc.get("rows", []):
            print("%-12s %-40s %9d B  nvcc %.2f s"
                  % (r["program"], r["artifact"], r["bytes"], r["build_s"]))
        for f in doc.get("failures", []):
            print("aot: " + f)
        if "error" in doc:
            print(doc["error"], file=sys.stderr)
        print("kubeaot %s: %s" % (doc["op"],
                                  "clean" if doc["clean"] else "FAILED"))
    return 0 if doc["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
