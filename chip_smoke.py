"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                    # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases kernel    # only the kernel-vs-plain check

Phases (any failure exits non-zero; no phase's exception is swallowed):

  reference  a small term-free auction on the card equals the same auction
             on the CPU (the plain path the CPU tests tie to the JAX
             package), every GangResult field, under both backends;
  kernel     the CUDA propose kernel equals its plain PyTorch version
             bitwise (prop/act/best) on seeded worlds at the slice's shapes
             (W=1024 rows, and a W=512 window with sentinel rows of a
             1,024-row bundle, x N=8192 nodes, with all-infeasible rows and
             hostPort conflicts), under both instantiations (the default
             plugin family, and a generic layout with a bias plane), and on
             worlds that take the kernel's size-selected branches (16
             zones; N=20480 above the shared-memory staging threshold;
             ragged N) and its exact-division recompute (operands outside
             the fast division's range); checks the fast division against
             __fdiv_rn on 2**28 operand pairs; prints its time, the plain
             version's time, the bound and the share of the bound, and
             the SM clock and power draw under load;
  slice      SchedulingBasic5000Nodes (scheduler_perf): 5,000 nodes, 5,000
             initial pods (one per node), 1,000 term-free pending pods,
             batch_size 1,000, mode gang, kernel_backend pallas, drained
             through Scheduler.schedule_pending.  Every pod placed, no
             capacity violated.  On identical nodes every pod's round-0
             proposal fits, so the cycle ends after the round-0 (plain)
             round and the kernel does not launch here — as in the JAX
             package, whose Pallas kernel also starts at round 1;
  backlog    a constructed stress case at the JAX bench's default shape,
             1,000 nodes x 4,096 pending pods, with traffic chosen to
             contend (900m pods, nodes carrying 0-3 existing pods; the
             bench's own default is 100m pods, 2 per node): pods crowd
             onto the least-loaded nodes, so many rounds run.  Drained
             under "pallas" and under "lax" on the card: identical
             placements;
  fill       Preemption5000Nodes' init phase (scheduler_perf): 20,000
             low-priority 900m fillers onto 5,000 empty nodes, which they
             fill exactly (four per node), batch_size 1,000, gang.  The
             last batches find one free slot per node and contend.
             Drained under "pallas" and "lax": every pod placed, four per
             node, identical placements;
  profile    the slice, backlog and fill (pallas) drains once more under
             torch.profiler: device busy time, the drain's device idle
             share, top kernels (separate runs, so the profiler's overhead
             stays out of the numbers above).

The main path is the pallas drain of each of slice, backlog and fill: the
kernel launch count is zeroed just before each and read just after it,
and reported per path.  The slice never launches the kernel (above); in
the backlog and fill drains every launch's inputs and outputs are
recorded (the fill's first 16) and, after the drain, the outputs are held
bitwise against the plain version on the same inputs, and the kernel is
timed on the widest recorded launch's real inputs.

The second-to-last lines print the card (nvidia-smi's name and power
limit) and the kernels' JSON line; the last line is the contract's
{"ok": true, "device": {...}}.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

ALL_PHASES = ("reference", "kernel", "slice", "backlog", "fill",
              "profile")
MAIN_PATHS = ("slice", "backlog", "fill")
FILL_NODES = 5000             # Preemption5000Nodes: 5,000 nodes,
FILL_PODS = 4 * FILL_NODES    # 20,000 init pods (four 900m pods fill a node)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_query(fields: str) -> str:
    """nvidia-smi --query-gpu=<fields> for card 0, as it prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + fields, "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return gpu_query("name,power.limit")


# ---------------------------------------------------------------------------
# worlds


def hollow_store(n_nodes, existing_per_node, zones=8, init_labels=10,
                 varied=False):
    """n_nodes hollow nodes with existing_per_node bound pods each, or,
    with varied=True, i % (existing_per_node + 1) pods on node i."""
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    store = ClusterStore()
    for i, n in enumerate(hollow.make_nodes(n_nodes, zones=zones)):
        store.add(n)
        k = i % (existing_per_node + 1) if varied else existing_per_node
        for j in range(k):
            p = hollow.make_pod(f"init-{i}-{j}", mem=250 << 20,
                                labels={"app": f"app-{(i + j) % init_labels}",
                                        "group": "init"})
            p.spec.node_name = n.name
            store.add(p)
    return store


def filler_pods(n):
    """Preemption's init pods (kubetpu/harness/perf.py's filler template,
    reference pod-low-priority.yaml): 900m, 250 Mi, priority -10."""
    from kubetpu_torch.harness import hollow
    return [hollow.make_pod(f"init-{i}", cpu_milli=900, mem=250 << 20,
                            priority=-10, labels={"group": "init"})
            for i in range(n)]


def pending_pods(n, prefix, group_labels=10, cpu_milli=100, mem=250 << 20):
    from kubetpu_torch.harness import hollow
    return [hollow.make_pod(f"{prefix}-{i}", cpu_milli=cpu_milli, mem=mem,
                            labels={"app": f"app-{i % group_labels}",
                                    "group": prefix})
            for i in range(n)]


def drain(store, pods, backend, batch_size, device, record=None,
          record_limit=None):
    """Drain ``pods`` through Scheduler.schedule_pending.  record: a
    list that receives the first ``record_limit`` (default: all) propose
    launches as (inputs, outputs), cloned, for the check against the
    plain version."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     batch_size=batch_size, mode="gang",
                                     kernel_backend=backend)
    sched = Scheduler(store, config=cfg, device=device)
    for p in pods:
        store.add(p)
    placed = {}
    restore = (_record_launches(record, record_limit)
               if record is not None else None)
    try:
        t0 = time.perf_counter()
        while True:
            out = sched.schedule_pending()
            if not out:
                break
            for o in out:
                placed[o.pod.metadata.name] = o.node
        seconds = time.perf_counter() - t0
    finally:
        if restore is not None:
            restore()
    sched.close()
    return sched, placed, seconds


def _record_launches(record, limit):
    """Wrap the CUDA wrapper so each launch's inputs and outputs are
    cloned into ``record`` (clones are enqueued on the launch's stream);
    returns the function that restores it."""
    import torch
    from kubetpu_torch.ops import propose as PK
    orig = PK.propose_cuda

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def recording(bundle, rows, live, req, nz, ports_used):
        if limit is not None and len(record) >= limit:
            return orig(bundle, rows, live, req, nz, ports_used)
        ins = ({k: clone(v) for k, v in bundle.items()}, clone(rows),
               clone(live), clone(req), clone(nz), clone(ports_used))
        out = orig(bundle, rows, live, req, nz, ports_used)
        record.append((ins, tuple(clone(x) for x in out)))
        return out

    PK.propose_cuda = recording

    def restore():
        PK.propose_cuda = orig
    return restore


def check_recorded(record, what) -> dict:
    """The main path's own launches against the plain version, bitwise."""
    import torch
    from kubetpu_torch.ops import propose as PK
    max_err = 0.0
    for i, (ins, (kp, ka, kb)) in enumerate(record):
        pp, pa, pb = PK.propose_plain(*ins)
        if not (torch.equal(kp, pp) and torch.equal(ka, pa)
                and torch.equal(kb, pb)):
            raise AssertionError("%s: launch %d of the drain differs from "
                                 "the plain version (%d rows)"
                                 % (what, i, int((kp != pp).sum())))
        max_err = max(max_err, float((kb - pb).abs().max()))
    shapes = sorted({(ins[1].shape[0], ins[0]["planes"].shape[2],
                      ins[0]["planes"].shape[1], ins[0]["breq"].shape[1],
                      ins[0]["bports"].shape[1], ins[0]["n_zones"])
                     for ins, _ in record})
    # the kernel timed on one recorded launch's real inputs (the one with
    # the most live rows)
    ins = max((ins for ins, _ in record),
              key=lambda x: int(x[2].sum()) * x[0]["planes"].shape[2])[0:6]
    real_ms = kernel_ms(ins)[0]
    real_bound, _ = bound_of(*ins)
    return dict(checked=len(record), max_abs_err=max_err,
                shapes_WNBRPZ=[list(x) for x in shapes],
                real_launch=dict(W=ins[1].shape[0],
                                 N=ins[0]["planes"].shape[2],
                                 live_rows=int(ins[2].sum()), ms=real_ms,
                                 bound_ms=real_bound,
                                 share_of_bound=real_bound / real_ms))


def tensorize(store, pods):
    """Host (numpy) build of one cycle's cluster and batch."""
    from kubetpu_torch.framework.types import NodeInfo, PodInfo
    from kubetpu_torch.models.batch import PodBatchBuilder
    from kubetpu_torch.state.tensors import SnapshotBuilder
    infos = {}
    for n in store.list("Node"):
        ni = NodeInfo()
        ni.set_node(n)
        infos[n.name] = ni
    for p in store.list("Pod"):
        if p.spec.node_name:
            infos[p.spec.node_name].add_pod(p)
    node_infos = list(infos.values())
    pinfos = [PodInfo(p) for p in pods]
    builder = SnapshotBuilder()
    builder.intern_pending(pinfos)
    host = builder.build(node_infos)
    batch = PodBatchBuilder(builder.table).build(pinfos)
    return host, batch


# ---------------------------------------------------------------------------
# phases


def phase_reference() -> dict:
    """Small auction, card vs CPU, identical GangResult (shared gumbel)."""
    import torch
    from kubetpu_torch.models.batch import batch_to_device
    from kubetpu_torch.models.gang import schedule_gang
    from kubetpu_torch.models.programs import ProgramConfig
    from kubetpu_torch.utils import prng
    store = hollow_store(48, 2)
    pods = pending_pods(200, "ref", cpu_milli=900)
    host, hbatch = tensorize(store, pods)
    rng = prng.PRNGKey(7)
    B = hbatch.valid.shape[0]
    N = host.arrays["allocatable"].shape[0]
    gumbel = prng.gumbel(prng.fold_in(rng, torch.arange(B)), (N,))
    out = {}
    for backend in ("lax", "pallas"):
        for window in (0, 64):
            res = {}
            for dev in ("cpu", "cuda"):
                cl = host.to_device(dev)
                b = batch_to_device(hbatch, dev)
                res[dev] = schedule_gang(cl, b, ProgramConfig(), rng.to(dev),
                                         intra_batch_topology=False,
                                         residual_window=window,
                                         kernel_backend=backend,
                                         gumbel=gumbel.to(dev))
            for f in res["cpu"]._fields:
                a, c = getattr(res["cpu"], f), getattr(res["cuda"], f)
                if f == "syncs":
                    ok = a == c
                else:
                    ok = torch.equal(a, c.cpu())
                    if a.dtype.is_floating_point:
                        ok = ok and bool(torch.isfinite(c).all())
                if not ok:
                    raise AssertionError("reference: %s differs card vs CPU "
                                         "(%s, window %d)" % (f, backend,
                                                              window))
            out["%s_w%d_rounds" % (backend, window)] = int(res["cpu"].rounds)
            out["%s_w%d_placed" % (backend, window)] = int(
                (res["cpu"].chosen >= 0).sum())
    return out


def random_bundle(seed, W, N, device, with_bias=False, Z=8, B=None,
                  scores=None, sentinels=0, extreme=False):
    """The propose arguments (bundle, rows, live, req, nz, ports_used) of
    a seeded world at real widths (kubetpu_torch/harness/propose_worlds,
    the builder the port's tests use): a B-row bundle (B = W by default)
    with 16 port ids, and W window rows of it, ascending as the gang loop
    takes them, ``sentinels`` of them past B; extreme: division operands
    outside the kernel's fast division range."""
    from kubetpu_torch.harness import propose_worlds as PW
    B = B or W
    w = PW.world(seed, B, N, with_bias, Z, scores, P=16, extreme=extreme)
    rows = (None if W == B and not sentinels
            else PW.window_rows(seed, B, W, sentinels))
    return PW.propose_args(w, rows, device)


def _sectors(flags, first):
    """32-byte sectors of f32 rows holding at least one element where
    flags [W, N] is True; row w's element 0 lies ``first[w]`` floats
    past a 32-byte boundary."""
    import torch
    W, N = flags.shape
    sec = (first[:, None] + torch.arange(N, device=flags.device)) // 8
    occ = torch.zeros((W, N // 8 + 2), dtype=torch.int32,
                      device=flags.device)
    occ.scatter_add_(1, sec, flags.int())
    return int((occ > 0).sum())


def bound_of(bundle, rows, live, req, nz, ports_used):
    """Least time on the card for one propose step, from this call's
    inputs and what its data needs.  Bytes: each live window row's mask
    row and row-vector entries; its plane values only at the nodes where
    it is feasible (the gumbel plane only where the row's best score
    ties, the DefaultPodTopologySpread plane not at all on a spread-skip
    row), counted in the 32-byte sectors that hold them; the node tables
    and the round's carries once, at the nodes some live row's mask
    admits; rows, live and the three outputs; all over HBM bandwidth.
    Operations: 2 per resource channel and port id at each admitted
    (row, node), ~40 f32 ops of the default family's combine at each
    feasible one, over the f32 rate.  Sentinel and non-live rows read
    no bundle row."""
    import torch
    from kubetpu_torch.ops import propose as PK
    L = bundle["layout"]
    S, B, N = bundle["planes"].shape
    R, P = bundle["breq"].shape[1], bundle["bports"].shape[1]
    W = rows.shape[0]
    sub = PK._rows_of(bundle, rows)
    f = PK._feasible(sub, L, live, req, ports_used)
    total = PK._combine(sub, L, f, nz)
    best = torch.where(f, total, torch.full_like(total, PK.NEG)).amax(1)
    need = {"gumbel": f & (total == best[:, None]),
            "dps_raw": f & ~sub["skip"][:, None]}
    rsafe = rows.long().clamp(0, B - 1)
    p0 = bundle["planes"].data_ptr() // 4
    plane_bytes = 0
    for i, name in enumerate(L.planes):
        first = (p0 + (i * B + rsafe) * N) % 8
        plane_bytes += 32 * _sectors(need.get(name, f), first)
    w_live = int(live.sum())
    admitted = sub["mask"] & live[:, None]
    n_admitted = int(admitted.any(0).sum())
    nbytes = plane_bytes + w_live * (N + R * 4 + 2 * 4 + P * 4 + 1 + 1)
    nbytes += n_admitted * (R * 4 + 4 + R * 4 + 2 * 4 + P * 4)
    nbytes += W * (8 + 1) + W * (4 + 4 + 1)     # rows, live; outputs
    ops = (int(admitted.sum()) * (2 * R + 2 * P)
           + int(f.sum()) * 40)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps, rounds=5):
    """Device milliseconds per call: CUDA events around ``reps``
    back-to-back calls (so the host's enqueue overlaps the device work),
    median over ``rounds`` such windows."""
    import torch
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def kernel_ms(args, reps=20):
    """The kernel alone (a staged launch, no wrapper checks), warm."""
    from kubetpu_torch.ops import propose as PK
    launch, _ = PK.bind_propose(*args)
    for _ in range(3):
        launch()
    return time_ms(launch, reps), launch


def phase_kernel() -> dict:
    import torch
    from kubetpu_torch.harness.propose_worlds import GENERIC_SCORES
    from kubetpu_torch.models.programs import ProgramConfig
    from kubetpu_torch.ops import propose as PK
    # (seed, W, N, bias plane, zones, B, scores, sentinels, extreme): the
    # slice's shapes under the default-family specialisation; a W=512
    # window of a 1,024-row bundle with sentinel rows; the generic layout
    # walk (Most/LeastAllocated, weights 2 and 3, bias); 16 zones
    # (shared-memory zone sums); N above the shared-memory staging
    # threshold (statistics planes read from device memory in both
    # passes), under both layouts; ragged N (row starts off 16 bytes: bulk
    # copies over the aligned interior, scalar ends); division operands
    # outside the fast division's range (recomputed with __fdiv_rn), under
    # both layouts
    worlds = [(11, 1024, 8192, False, 8, 1024, None, 0, False),
              (12, 1024, 8192, True, 8, 1024, None, 0, False),
              (13, 512, 8192, False, 8, 1024, None, 24, False),
              (14, 512, 8192, True, 8, 1024, GENERIC_SCORES, 24, False),
              (15, 1024, 8192, True, 16, 1024, None, 0, False),
              (16, 256, 20480, False, 16, 256, None, 8, False),
              (17, 256, 20480, True, 8, 256, GENERIC_SCORES, 0, False),
              (18, 512, 8189, False, 8, 700, None, 8, False),
              (19, 300, 4999, True, 8, 300, GENERIC_SCORES, 0, False),
              (20, 512, 8192, True, 8, 1024, None, 24, True),
              (24, 512, 8192, False, 8, 512, GENERIC_SCORES, 0, True)]
    staged_max = PK.staged_max_n(PK.layout_for(ProgramConfig(), False),
                                 5, 16, 8)
    max_err = 0.0
    for seed, W, N, bias, Z, B, scores, sent, extreme in worlds:
        args = random_bundle(seed, W, N, "cuda", with_bias=bias, Z=Z, B=B,
                             scores=scores, sentinels=sent, extreme=extreme)
        if args[0]["layout"].default_family != (scores is None):
            raise AssertionError("world %d: wrong instantiation" % seed)
        kp, ka, kb = PK.propose_cuda(*args)
        pp, pa, pb = PK.propose_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(kp, pp) and torch.equal(ka, pa)
                and torch.equal(kb, pb)):
            bad = int((kp != pp).sum())
            raise AssertionError("propose kernel != plain (seed %d, W %d, "
                                 "N %d, bias %s, Z %d): %d rows differ"
                                 % (seed, W, N, bias, Z, bad))
        max_err = max(max_err, float((kb - pb).abs().max()))
        if not bool((~pa).any()) or not bool(pa.any()):
            raise AssertionError("world %d lacks active or inactive rows"
                                 % seed)
    # the kernel's branch-free division against __fdiv_rn, bit for bit
    fast_div_pairs = 1 << 28
    bad = PK.check_fast_div(fast_div_pairs, seed=7)
    if bad:
        raise AssertionError("fast division differs from __fdiv_rn on %d "
                             "of %d pairs" % (bad, fast_div_pairs))
    if not 8192 < staged_max < 20480:
        raise AssertionError("staging threshold %d: the worlds above do "
                             "not take both branches" % staged_max)
    # time at the slice's full width (default family, no bias plane): the
    # kernel alone (staged launch), the whole wrapper (checks, launch),
    # and the plain version; then a W=512 window of a 1,024-row bundle
    # (the windowed path's shape)
    args = random_bundle(21, 1024, 8192, "cuda")
    ms, launch = kernel_ms(args)
    wrapper_ms = time_ms(lambda: PK.propose_cuda(*args), 20)
    plain_ms = time_ms(lambda: PK.propose_plain(*args), 3)
    bound_ms, bound_by = bound_of(*args)
    args_w = random_bundle(22, 512, 8192, "cuda", B=1024)
    ms_w = kernel_ms(args_w)[0]
    bound_w, _ = bound_of(*args_w)
    plain_w = time_ms(lambda: PK.propose_plain(*args_w), 3)
    # the term-free main path's DefaultPodTopologySpread raw is all zero
    # (no controller selectors): time that input too
    b0 = dict(args[0])
    dps = PK.plane_order(ProgramConfig(), False).index("dps_raw")
    b0["planes"] = args[0]["planes"].clone()
    b0["planes"][dps] = 0.0
    ms_dps0 = kernel_ms((b0,) + tuple(args[1:]))[0]
    # above the staging threshold (N=20,480, statistics planes read twice)
    ms_big = kernel_ms(random_bundle(23, 256, 20480, "cuda"))[0]
    # the SM clock and power while the kernel runs: queue ~0.5 s of
    # launches, read nvidia-smi meanwhile, then drain
    for _ in range(max(200, int(500 / ms))):
        launch()
    clocks = gpu_query("clocks.sm,clocks.max.sm,power.draw")
    torch.cuda.synchronize()
    return dict(max_abs_err=max_err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms,
                ms_w512=ms_w, bound_ms_w512=bound_w, plain_ms_w512=plain_w,
                share_of_bound_w512=bound_w / ms_w,
                ms_dps_zero=ms_dps0, ms_n20480_unstaged=ms_big,
                staged_max_n=staged_max, worlds=len(worlds),
                fast_div_pairs_checked=fast_div_pairs,
                under_load=clocks)


def phase_slice() -> dict:
    """SchedulingBasic5000Nodes through Scheduler.schedule_pending."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    store = hollow_store(5000, 1)
    pods = pending_pods(1000, "measured")
    PK.propose.launches = 0          # this path starts: zero the count
    sched, placed, seconds = drain(store, pods, "pallas", 1000, "cuda")
    launches = PK.propose.launches
    n_placed = sum(1 for v in placed.values() if v)
    if n_placed != 1000:
        raise AssertionError("slice: %d/1000 pods placed" % n_placed)
    bad = capacity_violations(store)
    if bad:
        raise AssertionError("slice: capacity violated on %s" % bad[:5])
    # identical nodes: every round-0 proposal fits, so the cycle ends
    # after the plain round 0 and the kernel (rounds >= 1) never runs
    return dict(placed=n_placed, cycles=sched.cycle_count,
                rounds=sched.gang_rounds, syncs=sched.gang_syncs,
                launches=launches, drain_s=seconds, stage_s=sched.stage_s,
                pods_per_s=n_placed / seconds)


def _pallas_vs_lax(what, make_world, batch_size, record_limit=None):
    """Drain one world under "pallas" (counting and recording the
    kernel's launches) and a fresh copy under "lax"; the placements must
    be identical.  Returns per-backend numbers and the store of each."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    out, placements, stores = {}, {}, {}
    for backend in ("pallas", "lax"):
        store, pods = make_world()
        record = [] if backend == "pallas" else None
        PK.propose.launches = 0      # this path starts: zero the count
        sched, placed, seconds = drain(store, pods, backend, batch_size,
                                       "cuda", record, record_limit)
        launches = PK.propose.launches
        if capacity_violations(store):
            raise AssertionError("%s: capacity violated (%s)"
                                 % (what, backend))
        placements[backend], stores[backend] = placed, store
        n_placed = sum(1 for v in placed.values() if v)
        out[backend] = dict(placed=n_placed, cycles=sched.cycle_count,
                            rounds=sched.gang_rounds, syncs=sched.gang_syncs,
                            launches=launches, drain_s=seconds,
                            stage_s=sched.stage_s,
                            pods_per_s=n_placed / seconds)
        if record is not None:
            if launches <= 0:
                raise AssertionError("%s: the propose kernel never launched"
                                     % what)
            out[backend]["recorded"] = check_recorded(record, what)
    if placements["pallas"] != placements["lax"]:
        diff = [k for k in placements["lax"]
                if placements["lax"][k] != placements["pallas"].get(k)]
        raise AssertionError("%s: pallas and lax placements differ for %d "
                             "pods" % (what, len(diff)))
    out["placements_match"] = True
    return out, stores


def backlog_world():
    return (hollow_store(1000, 3, varied=True),
            pending_pods(4096, "backlog", cpu_milli=900))


def fill_world():
    return hollow_store(FILL_NODES, 0), filler_pods(FILL_PODS)


def phase_backlog() -> dict:
    return _pallas_vs_lax("backlog", backlog_world, 4096)[0]


def phase_fill() -> dict:
    """Preemption5000Nodes' init phase: every filler placed, four on every
    node (the template packs the cluster exactly)."""
    out, stores = _pallas_vs_lax("fill", fill_world, 1000, record_limit=16)
    for backend, store in stores.items():
        if out[backend]["placed"] != FILL_PODS:
            raise AssertionError("fill: %d/%d pods placed (%s)"
                                 % (out[backend]["placed"], FILL_PODS,
                                    backend))
        per_node = {}
        for p in store.list("Pod"):
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name,
                                                      0) + 1
        if len(per_node) != FILL_NODES or set(per_node.values()) != {4}:
            raise AssertionError("fill: nodes not packed four each (%s)"
                                 % backend)
    return out


def _profiled_drain(store, pods, backend, batch_size):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched, placed, _ = drain(store, pods, backend, batch_size, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device kernels only: an operator's row also carries the device time
    # of the kernels it launched, so summing every row counts it twice
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                device_idle_share=(1.0 - busy_ms / 1e3 / wall
                                   if busy_ms > 0 else None),
                top=[[e.key[:60], e.count, dev_us(e) / 1e3]
                     for e in rows[:8] if dev_us(e) > 0],
                placed=sum(1 for v in placed.values() if v))


def phase_profile() -> dict:
    return dict(
        slice=_profiled_drain(hollow_store(5000, 1),
                              pending_pods(1000, "measured"), "pallas",
                              1000),
        backlog=_profiled_drain(*backlog_world(), "pallas", 4096),
        fill=_profiled_drain(*fill_world(), "pallas", 1000))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    phases = ap.parse_args().phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kubetpu_torch.ops import _build
    from kubetpu_torch.ops import propose as PK
    import kubetpu_torch.utils.device  # noqa: F401  (TF32 off)

    card = card_line()
    log({"card": card, "torch": torch.__version__,
         "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.load_propose()
    log({"build_s": time.perf_counter() - t0,
         "nvcc_s": _build.build_seconds.get("propose")})
    results = {}
    for ph in phases:
        t = time.perf_counter()
        results[ph] = globals()["phase_" + ph]()
        results[ph]["phase_s"] = time.perf_counter() - t
        log({"phase": ph, "card": card, **results[ph]})
    if {"kernel", *MAIN_PATHS} <= set(phases):
        # the pallas drain of each main path, counted on its own
        by_path = {ph: (results[ph]["launches"] if ph == "slice"
                        else results[ph]["pallas"]["launches"])
                   for ph in MAIN_PATHS}
        launches = sum(by_path.values())
        if launches <= 0:
            raise AssertionError("main path: the propose kernel never "
                                 "launched")
        k = results["kernel"]
        recorded = [results[ph]["pallas"]["recorded"]
                    for ph in ("backlog", "fill")]
        log({"kernels": [{
            "name": "propose", "route": "cuda",
            "source": "kubetpu_torch/ops/csrc/propose.cu",
            "replaces": "kubetpu/ops/pallas_kernels.py:511",
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max([k["max_abs_err"]]
                               + [r["max_abs_err"] for r in recorded]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "matches_plain": True,
            "share_of_bound": k["share_of_bound"],
            "ms_w512": k["ms_w512"], "bound_ms_w512": k["bound_ms_w512"],
            "fill_real_launch": recorded[1]["real_launch"]}]})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
