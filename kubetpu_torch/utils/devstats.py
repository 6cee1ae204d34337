"""Device-side observability: measured per-program device time, the
residency ledger, and the roofline join.

The counterpart of kubetpu/utils/devstats.py.  Three parts:

1. MEASURED PER-PROGRAM DEVICE TIME.  Every Nth cycle
   (``KUBETPU_DEVSTATS_SAMPLE``, default 8; the first cycle after arming
   is always one) is a deep-timing cycle: each device program it runs is
   timed (``run_auction``, ``schedule_sequential``,
   ``apply_cluster_delta``; ``explain_verdicts`` on every armed failure
   cycle, whose readback is already a sync).  On the card a program is
   timed by a ``torch.cuda.Event(enable_timing=True)`` pair recorded on
   its stream before and after it, and the pair is read only after the
   cycle's own packed readback (``settle``), so timing adds no sync of its
   own; on the CPU, where a call returns when its work is done, by the
   call's wall time.  An event pair times the stream between the two
   marks, host gaps between its launches included (the auction reads a
   flag on the host every round).  ``fence_wait_s`` counts what the
   reading itself waited: ~0 on the card, where the readback has already
   waited, and 0 on the CPU.  While ``utils/trace.capture_device_trace``
   runs, each program also opens a ``torch.profiler.record_function``
   range named after it, and ``ingest_trace`` sums the CUDA kernel time
   launched inside each range of the exported Chrome trace (or records
   why it could not).

2. RESIDENCY LEDGER.  The allocation seams register what lives on the
   device: the DeltaTensorizer's resident cluster per profile
   (``delta-resident``) and the speculative chain's materialized cluster
   (``chain``), per table with per-dim role tags.  ``project()`` scales a
   ledger to any (nodes, pods): node-axis dims linearly, pod-axis dims
   through ``pow2_bucket``, the kv vocab by the hostname-dominated model,
   every other dim held, and answers whether the result fits the card's
   memory (``torch.cuda.get_device_properties(dev).total_memory``, or
   ``KUBETPU_HBM_GIB``).

3. ROOFLINE JOIN.  A program's least time is the larger of its operations
   over the card's peak rate for their type (utils/flops.peak_flops_per_s:
   f32 outside the tensor cores) and its bytes (each operand read once)
   over the memory rate (``KUBETPU_PEAK_GBPS``, default 3,350 GB/s, the
   H100 SXM's data sheet figure); ``roofline_fraction`` is that least
   time over the measured time.  The gang auction's operations come from
   the analytic model (utils/flops.gang_cycle_flops, paired per deep cycle
   at commit: ``flops_source: "analytic"``); the other programs have no
   model (``"unmodeled"``: a bytes-only bound).  The JAX package joins XLA
   cost rows of its own lowerings (COMPILE_MANIFEST.json), which describe
   none of the port's programs, so the port does not read them.

Arming, as utils/slo.py and utils/trace.py: ``KUBETPU_DEVSTATS=1`` or
``arm_devstats()``.  DISARMED (the default) every seam is ONE
module-attribute read and the hot path takes no new lock; armed and
disarmed placements are identical: timing only observes.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import trace as utrace
from .intern import pow2_bucket

DEVSTATS_ENV = "KUBETPU_DEVSTATS"
SAMPLE_ENV = "KUBETPU_DEVSTATS_SAMPLE"
PEAK_GBPS_ENV = "KUBETPU_PEAK_GBPS"
HBM_GIB_ENV = "KUBETPU_HBM_GIB"
DEFAULT_SAMPLE_INTERVAL = 8
# NVIDIA H100 SXM: 3.35 TB/s of HBM bandwidth (NVIDIA's data sheet)
DEFAULT_PEAK_GBPS = 3350.0

# the serving programs devstats times
PROGRAMS = ("run_auction", "schedule_sequential", "apply_cluster_delta",
            "explain_verdicts")

_DTYPE_BYTES = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
                "bfloat16": 2, "float16": 2, "int32": 4, "uint32": 4,
                "float32": 4, "int64": 8, "uint64": 8, "float64": 8}


def peak_membw_bytes_per_s() -> float:
    """The card's peak memory bandwidth (bytes/s): the H100 SXM's 3.35
    TB/s unless KUBETPU_PEAK_GBPS names another part's."""
    return float(os.environ.get(PEAK_GBPS_ENV,
                                str(DEFAULT_PEAK_GBPS))) * 1e9


def hbm_bytes() -> Optional[float]:
    """Device memory per card (bytes): KUBETPU_HBM_GIB, else the current
    CUDA card's total memory; None where neither exists (a CPU-only host:
    the fit verdicts are then not measured)."""
    raw = os.environ.get(HBM_GIB_ENV, "")
    if raw:
        return float(raw) * 2.0 ** 30
    import torch
    if not torch.cuda.is_available():
        return None
    return float(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


def _dtype_name(dtype) -> str:
    """'float32' for torch.float32 and numpy's float32 alike (the JAX
    package's dtype strings)."""
    return str(dtype).replace("torch.", "")


def _leaves(tree) -> list:
    """The array leaves of nested NamedTuples/tuples/lists/dicts in field
    order, None dropped (jax.tree.leaves' order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for f in tree for x in _leaves(f)]
    return [tree]


def _leaf_bytes(leaf) -> Optional[Tuple[list, str, int]]:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return None
    n = 1
    for d in shape:
        n *= int(d)
    name = _dtype_name(dtype)
    return [int(d) for d in shape], name, n * _DTYPE_BYTES.get(name, 4)


def pytree_nbytes(tree) -> int:
    """Total bytes of a tree of arrays (torch or numpy): shape and dtype
    arithmetic only, no transfer, no sync.  Armed only."""
    total = 0
    for leaf in _leaves(tree):
        got = _leaf_bytes(leaf)
        if got is not None:
            total += got[2]
    return total


def table_entries(named_tables: Dict[str, Any]) -> Dict[str, List[dict]]:
    """Per-table leaf entries ({name: [{shape, dtype, bytes}, ...]}) of a
    dict of array trees: the ledger registration payload, computed
    outside any lock.  Armed only."""
    out: Dict[str, List[dict]] = {}
    for name, tree in named_tables.items():
        rows = []
        for leaf in _leaves(tree):
            got = _leaf_bytes(leaf)
            if got is not None:
                shape, dt, nbytes = got
                rows.append({"shape": shape, "dtype": dt, "bytes": nbytes})
        out[name] = rows
    return out


# ---------------------------------------------------------------- roofline


def roofline(seconds: float, flops: Optional[float] = None,
             nbytes: Optional[float] = None) -> Optional[dict]:
    """A program's measured device seconds against its least time: the
    larger of ``flops`` over the peak FLOP/s and ``nbytes`` (each operand
    read once) over the peak bytes/s.  None when there is nothing to
    bound it by.  With both known this is the JAX package's roofline of a
    cost row with those flops and bytes (arithmetic intensity, regime,
    bound, achieved rate and fraction alike)."""
    if seconds <= 0 or not (flops or nbytes):
        return None
    from .flops import peak_flops_per_s
    peak_f = peak_flops_per_s()
    peak_b = peak_membw_bytes_per_s()
    t_ops = (flops or 0.0) / peak_f
    t_bytes = (nbytes or 0.0) / peak_b
    bound_s = max(t_ops, t_bytes)
    out: Dict[str, Any] = {
        "flops_source": "analytic" if flops else "unmodeled",
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_s": round(bound_s, 9),
        "roofline_fraction": round(bound_s / seconds, 6),
    }
    if flops and nbytes:
        ai = flops / nbytes
        out["arithmetic_intensity"] = round(ai, 4)
        out["regime"] = ("compute-bound" if ai * peak_b >= peak_f
                         else "memory-bound")
        out["roofline_bound_tflops"] = round(min(peak_f, ai * peak_b)
                                             / 1e12, 3)
    if flops:
        out["achieved_tflops"] = round(flops / seconds / 1e12, 6)
    return out


# ------------------------------------------------------------- projection


def project(ledger_doc: Dict[str, Any], nodes: int, pods: int,
            shards: int = 1,
            groups: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """Capacity projection: scale a ledger snapshot's per-table shapes to
    (nodes, pods) and answer whether the result fits one card's memory.

    The per-dim model (the JAX package's, held within 10% by the capacity
    gate of tests/test_torch_devstats.py):

      * a dim tagged (or equal to) the entry's node count scales linearly
        to ``nodes``;
      * a pod-axis dim re-buckets to ``pow2_bucket(pods)``;
      * a kv-vocab dim follows ``pow2_bucket(kv0 * nodes / nodes0)`` (every
        node adds a unique hostname label pair);
      * every other dim (resource channels, label keys, zones, ports,
        taints) is held.

    ``shards`` models a mesh over the POD axis: per-shard bytes
    re-project with pods/shards."""

    def scale_entry(entry: dict, n_pods: int) -> Tuple[int, Dict[str, int]]:
        axes = entry.get("axes") or {}
        n0 = axes.get("nodes")
        p0 = axes.get("pods")
        kv0 = axes.get("kv")
        p1 = pow2_bucket(max(int(n_pods), 1))
        kv1 = (pow2_bucket(int(math.ceil(kv0 * nodes / n0)))
               if kv0 and n0 else None)
        per_table: Dict[str, int] = {}
        total = 0
        for name, leaves in (entry.get("tables") or {}).items():
            tb = 0
            for leaf in leaves:
                b = leaf.get("bytes", 0)
                shape = leaf.get("shape") or []
                # the role tags stamped at registration win over value
                # matching, which cannot tell a node count from an equal
                # pod bucket
                dims = leaf.get("dims")
                factor = 1.0
                for j, d in enumerate(shape):
                    if dims is not None and j < len(dims):
                        tag = dims[j]
                    elif n0 and d == n0:
                        tag = "nodes"
                    elif p0 and d == p0:
                        tag = "pods"
                    elif kv0 and d == kv0:
                        tag = "kv"
                    else:
                        tag = None
                    if tag == "nodes" and n0:
                        factor *= nodes / n0
                    elif tag == "pods" and p0:
                        factor *= p1 / p0
                    elif tag == "kv" and kv0 and kv1:
                        factor *= kv1 / kv0
                tb += int(math.ceil(b * factor))
            per_table[name] = tb
            total += tb
        return total, per_table

    per_group: Dict[str, int] = {}
    tables: Dict[str, int] = {}
    total = 0
    shard_total = 0
    for key, entry in sorted((ledger_doc.get("entries") or {}).items()):
        if groups is not None and entry.get("group") not in groups:
            continue
        t, per_table = scale_entry(entry, pods)
        st, _ = scale_entry(entry, max(pods // max(shards, 1), 1))
        per_group[key] = t
        total += t
        shard_total += st
        for name, b in per_table.items():
            tables[f"{key}/{name}"] = b
    cap = hbm_bytes()
    return {
        "nodes": int(nodes), "pods": int(pods),
        "pod_bucket": pow2_bucket(max(int(pods), 1)),
        "shards": int(shards),
        "per_group_bytes": per_group,
        "per_table_bytes": tables,
        "total_bytes": total,
        "per_shard_bytes": shard_total,
        "hbm_bytes_per_chip": int(cap) if cap is not None else None,
        "fits_single_chip": total <= cap if cap is not None else None,
        "fits_per_shard": shard_total <= cap if cap is not None else None,
    }


# ---------------------------------------------------------------- samples


class ProgramSample:
    """One timed dispatch of a program: a CUDA event pair (read at
    ``DevStats.settle``) or, on the CPU, the call's wall seconds.
    ``seconds`` is None until the sample is settled."""

    __slots__ = ("program", "source", "in_bytes", "start", "end", "t0",
                 "seconds")

    def __init__(self, program: str, source: str, in_bytes: Optional[int],
                 cuda: bool):
        import torch
        self.program = program
        self.source = source
        self.in_bytes = in_bytes
        self.seconds: Optional[float] = None
        self.start = self.end = None
        self.t0 = 0.0
        if cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()


# ---------------------------------------------------------------- DevStats


class DevStats:
    """Per-program device-time records and the residency ledger.

    Lock-guarded: the serving thread records, /debug/devicez reads.  All
    derivation (shape walks, byte sums, roofline arithmetic) runs outside
    the lock; only dict updates run under it."""

    def __init__(self, sample_interval: Optional[int] = None):
        si = sample_interval if sample_interval is not None else int(
            os.environ.get(SAMPLE_ENV, str(DEFAULT_SAMPLE_INTERVAL)))
        self.sample_interval = max(int(si), 1)
        self._lock = threading.Lock()
        self._programs: Dict[str, dict] = {}
        self._entries: Dict[str, dict] = {}
        self._pending: List[ProgramSample] = []
        self._cycles = 0
        self._deep = False
        self.fenced_cycles = 0
        self.fence_wait_s = 0.0
        self._trace_ingest: Optional[dict] = None

    # ---- sampling --------------------------------------------------------

    def begin_cycle(self) -> bool:
        """The serving thread's cycle tick: every ``sample_interval``-th
        cycle is a deep-timing cycle (the first after arming or ``clear``
        is one), latched until the next tick so the cycle's seams agree."""
        with self._lock:
            self._cycles += 1
            self._deep = (self._cycles - 1) % self.sample_interval == 0
            if self._deep:
                self.fenced_cycles += 1
            return self._deep

    def deep_active(self) -> bool:
        with self._lock:
            return self._deep

    @contextlib.contextmanager
    def _timed(self, program: str, device, operands, source: str):
        deep = source == "sync" or self.deep_active()
        ann = None
        if utrace.profile_active():
            import torch
            ann = torch.profiler.record_function(program)
            ann.__enter__()
        sample = None
        if deep:
            dev = getattr(device, "type", device)
            sample = ProgramSample(
                program, source,
                pytree_nbytes(operands) if operands is not None else None,
                cuda=dev == "cuda")
        try:
            yield sample
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
        if sample is not None:
            self._end(sample)

    def _end(self, sample: ProgramSample) -> None:
        if sample.end is not None:
            sample.end.record()
            with self._lock:
                self._pending.append(sample)
        else:
            sample.seconds = time.perf_counter() - sample.t0
            self.record_program(sample.program, sample.seconds,
                                source=sample.source,
                                in_bytes=sample.in_bytes, wait_s=0.0)

    def settle(self, block: bool = False) -> int:
        """Read the pending event pairs whose work is done (every pending
        one with ``block``) into program records; returns how many.  The
        scheduler calls it right after a cycle's packed readback, which
        has already waited for the cycle's programs, so reading them waits
        for nothing; whatever a read does wait is fence_wait_s."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep, done = [], 0
        for s in pending:
            if not block and not s.end.query():
                keep.append(s)
                continue
            t = time.perf_counter()
            s.end.synchronize()
            wait = time.perf_counter() - t
            s.seconds = s.start.elapsed_time(s.end) / 1e3
            self.record_program(s.program, s.seconds, source=s.source,
                                in_bytes=s.in_bytes, wait_s=wait)
            done += 1
        if keep:
            with self._lock:
                self._pending[:0] = keep
        return done

    # ---- per-program device time ----------------------------------------

    def record_program(self, program: str, seconds: float,
                       source: str = "fence",
                       in_bytes: Optional[int] = None,
                       wait_s: float = 0.0) -> None:
        """Fold one measured device-time sample in.  source: "fence" (a
        deep cycle's timed dispatch), "sync" (a program whose readback
        syncs anyway: explain_verdicts) or "trace" (a profiler capture);
        wait_s: the host seconds the reading waited (fence_wait_s)."""
        s = max(float(seconds), 0.0)
        with self._lock:
            st = self._programs.get(program)
            if st is None:
                st = self._programs[program] = {
                    "count": 0, "sum_s": 0.0, "min_s": math.inf,
                    "max_s": 0.0, "last_s": 0.0, "sources": {},
                    "in_bytes_sum": 0, "flops_sum": 0.0,
                    "flops_time_s": 0.0, "flops_bytes": 0}
            st["count"] += 1
            st["sum_s"] += s
            st["min_s"] = min(st["min_s"], s)
            st["max_s"] = max(st["max_s"], s)
            st["last_s"] = s
            st["sources"][source] = st["sources"].get(source, 0) + 1
            if in_bytes:
                st["in_bytes_sum"] += int(in_bytes)
            if source != "trace":
                self.fence_wait_s += max(float(wait_s), 0.0)

    def attribute_flops(self, program: str, flops: float, seconds: float,
                        nbytes: Optional[int] = None) -> None:
        """Pair analytically counted FLOPs (and the operand bytes) with
        the measured seconds of the SAME sample: the scheduler knows the
        auction's round count, and so its FLOPs, only at commit."""
        with self._lock:
            st = self._programs.get(program)
            if st is None or not st["count"]:
                return
            st["flops_sum"] += float(flops)
            st["flops_time_s"] += float(seconds)
            st["flops_bytes"] += int(nbytes or 0)

    def program_stats(self, program: str) -> Optional[dict]:
        with self._lock:
            st = self._programs.get(program)
            return dict(st) if st is not None else None

    # ---- residency ledger ------------------------------------------------

    def record_ledger(self, group: str, profile: str,
                      tables: Dict[str, List[dict]],
                      axes: Optional[Dict[str, int]] = None,
                      meta: Optional[Dict[str, Any]] = None) -> None:
        """(Re-)register one allocation seam's resident tables, keyed
        (group, profile): a re-registration REPLACES the previous one (the
        ledger describes what is resident now)."""
        total = sum(leaf.get("bytes", 0)
                    for leaves in tables.values() for leaf in leaves)
        entry = {"group": group, "profile": profile,
                 "tables": tables, "axes": dict(axes or {}),
                 "bytes": total, "meta": dict(meta or {})}
        key = f"{group}/{profile}" if profile else group
        with self._lock:
            prev = self._entries.get(key)
            entry["registrations"] = (prev["registrations"] + 1
                                      if prev else 1)
            self._entries[key] = entry

    def record_bytes(self, group: str, profile: str, name: str,
                     nbytes: int) -> None:
        """Register one opaque resident allocation by NAME within the
        (group, profile) entry; the same name again replaces its bytes."""
        key = f"{group}/{profile}" if profile else group
        leaf = {"shape": [], "dtype": "bytes", "bytes": int(nbytes)}
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = {
                    "group": group, "profile": profile, "tables": {},
                    "axes": {}, "bytes": 0, "meta": {},
                    "registrations": 0}
            prev = entry["tables"].get(name)
            if prev:
                entry["bytes"] -= sum(x.get("bytes", 0) for x in prev)
            entry["tables"][name] = [leaf]
            entry["bytes"] += int(nbytes)
            entry["registrations"] += 1

    def has_group(self, group: str) -> bool:
        with self._lock:
            return any(e["group"] == group
                       for e in self._entries.values())

    def drop_group(self, group: str,
                   profile: Optional[str] = None) -> None:
        """Unregister a group's entries (every profile, or one): a
        discarded chain's cluster is freed memory."""
        with self._lock:
            for k in [k for k, e in self._entries.items()
                      if e["group"] == group
                      and (profile is None or e["profile"] == profile)]:
                del self._entries[k]

    def ledger(self) -> Dict[str, Any]:
        """The ledger snapshot ``project`` scales."""
        with self._lock:
            entries = {k: {**v, "tables": {n: [dict(x) for x in ls]
                                           for n, ls in
                                           v["tables"].items()}}
                       for k, v in self._entries.items()}
        return {"entries": entries,
                "total_bytes": sum(e["bytes"] for e in entries.values())}

    # ---- profiler capture ------------------------------------------------

    def ingest_trace(self, path: str) -> dict:
        """Fold a Chrome trace written by utils/trace.capture_device_trace
        into per-program "trace" samples: the CUDA kernel time launched
        inside each program's record_function range (a kernel belongs to
        the range that holds its launch on the host, joined by the
        profiler's correlation id).  When it cannot, the reason is
        recorded."""
        status: Dict[str, Any] = {"path": path, "records": 0}
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents") or []
        except (OSError, ValueError) as e:
            status["available"] = False
            status["reason"] = f"unreadable trace ({type(e).__name__})"
            return self._set_ingest(status)
        ranges: Dict[Any, List[Tuple[float, float, str]]] = {}
        launches: Dict[Any, Tuple[Any, float]] = {}
        kernels: List[Tuple[Any, float]] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            args = ev.get("args") or {}
            if cat == "user_annotation" and name in PROGRAMS:
                ranges.setdefault(ev.get("tid"), []).append(
                    (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                     name))
            elif cat == "cuda_runtime" and "correlation" in args:
                launches[args["correlation"]] = (ev.get("tid"),
                                                 float(ev["ts"]))
            elif cat == "kernel" and "correlation" in args:
                kernels.append((args["correlation"], float(ev["dur"])))
        status["ranges"] = sum(len(v) for v in ranges.values())
        status["kernels"] = len(kernels)
        if not kernels:
            status["available"] = False
            status["reason"] = "no CUDA kernel events in the capture"
            return self._set_ingest(status)
        if not ranges:
            status["available"] = False
            status["reason"] = "no program range in the capture"
            return self._set_ingest(status)
        status["available"] = True
        per_range: Dict[Tuple[Any, float, str], float] = {}
        for corr, dur in kernels:
            launch = launches.get(corr)
            if launch is None:
                continue
            tid, ts = launch
            for lo, hi, prog in ranges.get(tid, ()):
                if lo <= ts <= hi:
                    key = (tid, lo, prog)
                    per_range[key] = per_range.get(key, 0.0) + dur
                    break
        for (_tid, _lo, prog), us in sorted(per_range.items(),
                                            key=lambda kv: kv[0][1]):
            self.record_program(prog, us / 1e6, source="trace")
            status["records"] += 1
        return self._set_ingest(status)

    def _set_ingest(self, status: dict) -> dict:
        with self._lock:
            self._trace_ingest = status
        return status

    # ---- reads -----------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """The /debug/devicez document: per-program measured device time
        with its roofline join, the residency ledger and the sampling
        accounting.  Pending event pairs are settled first."""
        if self._pending:
            self.settle(block=True)
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
            cycles = self._cycles
            fenced = self.fenced_cycles
            fence_s = self.fence_wait_s
            ingest = dict(self._trace_ingest) if self._trace_ingest else None
        progs_out: Dict[str, Any] = {}
        for name, st in sorted(programs.items()):
            d = {"count": st["count"],
                 "device_time_s": round(st["sum_s"], 6),
                 "mean_s": round(st["sum_s"] / max(st["count"], 1), 6),
                 "min_s": round(st["min_s"], 6) if st["count"] else 0.0,
                 "max_s": round(st["max_s"], 6),
                 "last_s": round(st["last_s"], 6),
                 "sources": dict(st["sources"])}
            if st["flops_time_s"] > 0:
                rl = roofline(st["flops_time_s"], flops=st["flops_sum"],
                              nbytes=st["flops_bytes"] or None)
            else:
                rl = roofline(st["sum_s"],
                              nbytes=st["in_bytes_sum"] or None)
            if rl is not None:
                d["roofline"] = rl
            progs_out[name] = d
        doc = {"armed": True,
               "sample_interval": self.sample_interval,
               "cycles_seen": cycles,
               "fenced_cycles": fenced,
               "fence_wait_s": round(fence_s, 6),
               "programs": progs_out,
               "ledger": self.ledger()}
        if ingest is not None:
            doc["trace"] = ingest
        return doc

    def summary(self) -> Dict[str, Any]:
        """The compact block of the pipeline doc: per program its count,
        device time, mean and roofline fraction; resident bytes in all
        and per ledger group."""
        doc = self.to_dict()
        progs = {}
        for name, d in doc["programs"].items():
            p = {"count": d["count"],
                 "device_time_s": d["device_time_s"],
                 "mean_s": d["mean_s"]}
            rl = d.get("roofline")
            if rl:
                for k in ("achieved_tflops", "roofline_fraction",
                          "regime", "flops_source"):
                    if k in rl:
                        p[k] = rl[k]
            progs[name] = p
        groups: Dict[str, int] = {}
        for e in doc["ledger"]["entries"].values():
            groups[e["group"]] = groups.get(e["group"], 0) + e["bytes"]
        return {"sample_interval": doc["sample_interval"],
                "fenced_cycles": doc["fenced_cycles"],
                "fence_wait_s": doc["fence_wait_s"],
                "programs": progs,
                "ledger_bytes": doc["ledger"]["total_bytes"],
                "ledger_group_bytes": groups}


# ----------------------------------------------------- module arming state
#
# Read WITHOUT a lock on the hot path (rebinding a reference is atomic),
# as utils/slo.py's tracker; arm/disarm serialize via _devstats_lock.

_stats: Optional[DevStats] = None
_devstats_lock = threading.Lock()
_NULL = contextlib.nullcontext()


def devstats() -> Optional[DevStats]:
    """The armed DevStats, or None (disarmed, the default)."""
    return _stats


def arm_devstats(sample_interval: Optional[int] = None) -> DevStats:
    """Idempotently arm device-side observability."""
    global _stats
    with _devstats_lock:
        if _stats is None:
            _stats = DevStats(sample_interval=sample_interval)
        return _stats


def disarm_devstats() -> None:
    global _stats
    with _devstats_lock:
        _stats = None


def maybe_arm_from_env() -> Optional[DevStats]:
    """Scheduler-construction hook: arms iff KUBETPU_DEVSTATS=1."""
    if os.environ.get(DEVSTATS_ENV, "0") not in ("", "0", "false",
                                                 "False"):
        return arm_devstats()
    return None


def timed(program: str, device, operands=None, source: str = "fence"):
    """The timing seam around one program dispatch: ``with timed(...) as
    sample:`` yields a ProgramSample on a deep cycle (every call for
    source "sync"), else None.  operands: the arrays the program reads
    (their bytes bound it).  Disarmed: one attribute read and a shared
    null context."""
    ds = _stats
    if ds is None:
        return _NULL
    return ds._timed(program, device, operands, source)


# --------------------------------------------------- registration helpers

# ClusterTensors tables whose dim 0 is NOT the node axis: the vocab-side
# metadata rows ([T]/[I]) and the flattened term tensors ([E, .])
_NODE_AXIS0_EXCLUDE = ("taint_is_hard", "taint_is_prefer", "image_size",
                       "image_spread", "filter_terms", "score_terms")


def _tag_cluster_dims(entries: Dict[str, List[dict]],
                      axes: Dict[str, int]) -> None:
    """Stamp per-dim role tags ("nodes"/"pods"/"kv"/None) onto a
    registered cluster's leaf entries from the ClusterTensors layout: dim
    0 of a ``pod_*`` table IS the pod axis, dim 0 of any other non-vocab,
    non-term table IS the node axis."""
    n, p, kv = axes.get("nodes"), axes.get("pods"), axes.get("kv")
    for name, leaves in entries.items():
        pod_table = name.startswith("pod_")
        node_dim0 = (not pod_table and name not in _NODE_AXIS0_EXCLUDE)
        for leaf in leaves:
            tags: List[Optional[str]] = []
            for i, d in enumerate(leaf["shape"]):
                if i == 0 and pod_table and d == p:
                    tags.append("pods")
                elif i == 0 and node_dim0 and d == n:
                    tags.append("nodes")
                elif i > 0 and d == kv:
                    tags.append("kv")
                elif i > 0 and d == p:
                    tags.append("pods")
                elif i > 0 and d == n:
                    tags.append("nodes")
                else:
                    tags.append(None)
            leaf["dims"] = tags


def register_cluster(group: str, profile: str, cluster, n_nodes: int,
                     meta: Optional[Dict[str, Any]] = None) -> None:
    """Register a resident ClusterTensors' per-table bytes under (group,
    profile): the DeltaTensorizer's resident or the speculative chain.
    Disarmed: one attribute read; the shape walk runs outside the ledger
    lock."""
    ds = _stats
    if ds is None:
        return
    named = {name: getattr(cluster, name)
             for name in type(cluster)._fields}
    axes = {"nodes": int(n_nodes),
            "pods": int(cluster.pod_valid.shape[0]),
            "kv": int(cluster.kv.shape[1])}
    entries = table_entries(named)
    _tag_cluster_dims(entries, axes)
    ds.record_ledger(group, profile, entries, axes=axes, meta=meta)
