"""The port's delta tensorization (kubetpu_torch/state/delta.py) on the
CPU: twins of tests/test_delta.py's golden and trigger tests, and a
differential drive of one seeded churn sequence through the JAX package's
DeltaTensorizer and the port's — after every refresh the same DeltaStats,
row maps, ClusterDelta tables and resident tensors, bit for bit."""

import copy
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubetpu_torch.state.delta as tdelta
from kubetpu_torch.api import types as api
from kubetpu_torch.framework.types import PodInfo
from kubetpu_torch.harness import hollow
from kubetpu_torch.state import tensors as tensors_mod
from kubetpu_torch.state.cache import SchedulerCache, Snapshot
from kubetpu_torch.state.delta import DeltaTensorizer
from kubetpu_torch.state.tensors import SnapshotBuilder, _densify_ids
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

NODE_AXIS_AND_VOCAB = [
    "allocatable", "requested", "nonzero_requested", "node_valid",
    "unschedulable", "kv", "keymask", "num", "topo_pair", "taints",
    "ports", "images", "avoid_hot", "zone_hot", "taint_is_hard",
    "taint_is_prefer", "image_size", "image_spread"]
POD_AXIS = ["pod_kv", "pod_key", "pod_ns_hot", "pod_node", "pod_valid",
            "pod_terminating"]


def snapshot_of(cache):
    snap = Snapshot()
    cache.update_snapshot(snap)
    return snap.node_info_list


def new_dt(**kw):
    return DeltaTensorizer(device="cpu", **kw)


def assert_matches_fresh(dt: DeltaTensorizer, node_infos) -> None:
    """The resident tensors equal a fresh build() against a COPY of the
    persistent intern table, bit for bit: the node axis directly, the pod
    axis under the uid-row permutation, unused rows at build defaults,
    term tensors directly but for pod_idx (compared through the uids)."""
    fresh_b = SnapshotBuilder(
        table=copy.deepcopy(dt.builder.table),
        hard_pod_affinity_weight=dt.hard_pod_affinity_weight)
    fresh_host = fresh_b.build(node_infos)
    fresh = fresh_host.to_device("cpu")
    got = dt.cluster
    for f in NODE_AXIS_AND_VOCAB:
        a, b = getattr(got, f).numpy(), getattr(fresh, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert np.array_equal(a, b), (f, np.argwhere(a != b)[:5])
    drow, frow = dt.pod_row, fresh_host.arrays["_pod_rows"]
    assert set(drow) == set(frow)
    gotp = {f: getattr(got, f).numpy() for f in POD_AXIS}
    frep = {f: getattr(fresh, f).numpy() for f in POD_AXIS}
    for uid in drow:
        for f in POD_AXIS:
            assert np.array_equal(gotp[f][drow[uid]], frep[f][frow[uid]]), (
                uid, f)
    used = set(drow.values())
    for r in range(gotp["pod_valid"].shape[0]):
        if r not in used:
            assert not gotp["pod_valid"][r], r
            assert gotp["pod_node"][r] == -1, r
    inv_d = {r: u for u, r in drow.items()}
    inv_f = {r: u for u, r in frow.items()}
    for kind in ("filter_terms", "score_terms"):
        dterm, fterm = getattr(got, kind), getattr(fresh, kind)
        for leaf in ("ns_hot", "topo_key", "weight", "valid"):
            assert torch.equal(getattr(dterm, leaf), getattr(fterm, leaf)), (
                kind, leaf)
        for a, b in zip(tdelta._leaves(dterm.sel), tdelta._leaves(fterm.sel)):
            assert torch.equal(a, b), (kind, "sel")
        dp, fp = dterm.pod_idx.numpy(), fterm.pod_idx.numpy()
        for i in np.nonzero(dterm.valid.numpy())[0]:
            assert inv_d[int(dp[i])] == inv_f[int(fp[i])], (kind, i)


def build_cache(n_nodes=6, pods_per_node=2, zones=3):
    cache = SchedulerCache()
    nodes = hollow.make_nodes(n_nodes, zones=zones)
    pods = []
    for i, n in enumerate(nodes):
        cache.add_node(n)
        for p in hollow.make_pods(pods_per_node, prefix=f"ex-{i}-",
                                  group_labels=3):
            p.spec.node_name = n.name
            cache.add_pod(p)
            pods.append(p)
    return cache, nodes, pods


# ---------------------------------------------------------------------------
# golden equivalence (tests/test_delta.py twins)


def test_initial_resync_then_zero_delta():
    cache, _, _ = build_cache()
    dt = new_dt()
    infos = snapshot_of(cache)
    c1, st1 = dt.refresh(infos)
    assert st1.resync and st1.reason == "initial"
    assert [n for n, _, _ in st1.spans] == ["resync"]
    assert_matches_fresh(dt, infos)
    c2, st2 = dt.refresh(snapshot_of(cache))
    assert c2 is c1
    assert st2.delta_rows == 0 and not st2.resync


@pytest.mark.parametrize("seed", [7, 11])
def test_randomized_churn_stays_golden(seed):
    rng = random.Random(seed)
    cache, nodes, pods = build_cache(n_nodes=8, pods_per_node=2, zones=4)
    live = list(pods)
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    seq = 0
    for _ in range(40):
        op = rng.choice(["commit", "commit", "commit-term", "evict",
                         "update-node", "update-pod"])
        if op in ("commit", "commit-term"):
            seq += 1
            p = hollow.make_pod(f"new-{seq}")
            p.metadata.labels = {"app": f"group-{rng.randrange(3)}"}
            if op == "commit-term":
                hollow.with_anti_affinity(p)
            p.spec.node_name = rng.choice(nodes).name
            cache.add_pod(p)
            live.append(p)
        elif op == "evict" and live:
            cache.remove_pod(live.pop(rng.randrange(len(live))))
        elif op == "update-node":
            old = rng.choice(nodes)
            new = copy.deepcopy(old)
            new.spec.unschedulable = not old.spec.unschedulable
            cache.update_node(old, new)
            nodes[nodes.index(old)] = new
        elif op == "update-pod" and live:
            i = rng.randrange(len(live))
            old = live[i]
            new = copy.copy(old)
            new.metadata = copy.deepcopy(old.metadata)
            new.metadata.labels["app"] = f"group-{rng.randrange(3)}"
            cache.update_pod(old, new)
            live[i] = new
        infos = snapshot_of(cache)
        _, st = dt.refresh(infos)
        assert_matches_fresh(dt, infos)
        if not st.resync:
            assert st.delta_rows > 0
        else:
            assert st.reason == "pod-axis-growth", st.reason


def test_intern_growth_falls_back_to_resync():
    cache, nodes, _ = build_cache()
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    kv_cap = dt.builder.table.kv.cap
    seq = 0
    while dt.builder.table.kv.cap == kv_cap:
        seq += 1
        p = hollow.make_pod(f"grow-{seq}")
        p.metadata.labels = {"uniq": f"v{seq}"}
        p.spec.node_name = nodes[seq % len(nodes)].name
        cache.add_pod(p)
        infos = snapshot_of(cache)
        _, st = dt.refresh(infos)
        assert_matches_fresh(dt, infos)
    assert st.resync and st.reason == "vocab-growth"


def test_term_pod_churn_is_delta_served_with_term_refresh():
    cache, nodes, _ = build_cache()
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    resyncs0 = dt.resync_count
    p = hollow.make_pod("affinity-pod")
    hollow.with_anti_affinity(p)
    p.spec.node_name = nodes[0].name
    cache.add_pod(p)
    infos = snapshot_of(cache)
    _, st = dt.refresh(infos)
    assert not st.resync, st.reason
    assert "delta-terms" in [n for n, _, _ in st.spans]
    assert_matches_fresh(dt, infos)
    cache.remove_pod(p)
    infos = snapshot_of(cache)
    _, st = dt.refresh(infos)
    assert not st.resync, st.reason
    assert "delta-terms" in [n for n, _, _ in st.spans]
    assert_matches_fresh(dt, infos)
    assert dt.resync_count == resyncs0


def test_pending_vocab_growth_resyncs_even_with_zero_node_churn():
    cache, _, _ = build_cache()
    dt = new_dt()
    infos = snapshot_of(cache)
    dt.refresh(infos)
    p = hollow.make_pod("pending-new-key")
    hollow.with_spread(p, "custom.io/rack")
    _, st = dt.refresh(infos, pending=[PodInfo(p)])
    assert st.resync and st.reason == "vocab-growth"
    assert_matches_fresh(dt, infos)
    _, st = dt.refresh(infos, pending=[PodInfo(p)])
    assert not st.resync and st.delta_rows == 0


def test_resync_compacts_dead_vocab():
    cache, nodes, _ = build_cache()
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    base_len = len(dt.builder.table.kv)
    doomed = []
    for i in range(40):
        p = hollow.make_pod(f"churn-{i}")
        p.metadata.labels = {"rollout-hash": f"h{i:04d}"}
        p.spec.node_name = nodes[i % len(nodes)].name
        cache.add_pod(p)
        doomed.append(p)
    infos = snapshot_of(cache)
    dt.refresh(infos)
    grown_len = len(dt.builder.table.kv)
    assert grown_len >= base_len + 40
    for p in doomed:
        cache.remove_pod(p)
    infos = snapshot_of(cache)
    dt.refresh(infos)
    dt.cycles_since_resync = dt.resync_interval
    _, st = dt.refresh(infos)
    assert st.resync and st.reason == "anti-entropy"
    assert len(dt.builder.table.kv) < grown_len - 30
    assert_matches_fresh(dt, infos)


def test_pod_moving_to_lower_indexed_node_keeps_its_row_mapping():
    cache, nodes, pods = build_cache()
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    mover = pods[-1]
    cache.remove_pod(mover)
    moved = copy.copy(mover)
    moved.spec = copy.copy(mover.spec)
    moved.spec.node_name = nodes[0].name
    cache.add_pod(moved)
    infos = snapshot_of(cache)
    _, st = dt.refresh(infos)
    assert not st.resync, st.reason
    assert_matches_fresh(dt, infos)


def test_node_set_change_falls_back_to_resync():
    cache, nodes, _ = build_cache()
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    cache.add_node(hollow.make_node("late-node", zone="zone-0"))
    infos = snapshot_of(cache)
    _, st = dt.refresh(infos)
    assert st.resync and st.reason == "node-set"
    assert_matches_fresh(dt, infos)


def test_pod_axis_growth_reuploads_without_build(monkeypatch):
    cache, nodes, _ = build_cache(n_nodes=4, pods_per_node=2, zones=2)
    dt = new_dt()
    dt.refresh(snapshot_of(cache))
    pp0 = dt.host.arrays["pod_node"].shape[0]
    builds = [0]
    orig = tensors_mod.SnapshotBuilder.build

    def counted(self, *a, **kw):
        builds[0] += 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(tensors_mod.SnapshotBuilder, "build", counted)
    seq = 0
    while dt.host.arrays["pod_node"].shape[0] == pp0:
        seq += 1
        p = hollow.make_pod(f"fill-{seq}")
        p.metadata.labels = {"app": "group-0"}
        p.spec.node_name = nodes[seq % len(nodes)].name
        cache.add_pod(p)
        infos = snapshot_of(cache)
        before = builds[0]
        _, st = dt.refresh(infos)
        assert builds[0] == before, "pod-axis growth re-walked the world"
        assert_matches_fresh(dt, infos)
    assert st.resync and st.reason == "pod-axis-growth"


def test_anti_entropy_resync_interval():
    cache, nodes, _ = build_cache()
    dt = new_dt(resync_interval=3)
    dt.refresh(snapshot_of(cache))
    reasons = []
    for seq in range(5):
        p = hollow.make_pod(f"tick-{seq}")
        p.metadata.labels = {"app": "group-0"}
        p.spec.node_name = nodes[0].name
        cache.add_pod(p)
        _, st = dt.refresh(snapshot_of(cache))
        reasons.append(st.reason)
    assert "anti-entropy" in reasons


def test_shared_scatter_leaves_the_previous_cluster_untouched():
    """donate=False clones before the scatter; donate=True updates the
    resident tensors in place (the previous ClusterTensors sees it)."""
    cache, nodes, _ = build_cache()
    dt = new_dt()
    c0, _ = dt.refresh(snapshot_of(cache))
    req0 = c0.requested.clone()
    p = hollow.make_pod("late")
    p.spec.node_name = nodes[0].name
    cache.add_pod(p)
    c1, st = dt.refresh(snapshot_of(cache), donate=False)
    assert not st.resync and st.delta_rows > 0
    assert torch.equal(c0.requested, req0)
    assert not torch.equal(c1.requested, req0)
    p2 = hollow.make_pod("later")
    p2.spec.node_name = nodes[1].name
    cache.add_pod(p2)
    c2, _ = dt.refresh(snapshot_of(cache), donate=True)
    assert c2.requested.data_ptr() == c1.requested.data_ptr()
    assert_matches_fresh(dt, snapshot_of(cache))


def drain(sched, max_cycles=12):
    out = []
    for _ in range(max_cycles):
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        out.extend(got)
    return out


def test_unchained_drain_builds_once(monkeypatch):
    """A multi-cycle gang drain with chaining OFF runs ONE full build (the
    initial resync) and serves the rest by scatter."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.scheduler import Scheduler

    builds = [0]
    orig = tensors_mod.SnapshotBuilder.build

    def counted(self, *a, **kw):
        builds[0] += 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(tensors_mod.SnapshotBuilder, "build", counted)

    store = ClusterStore()
    for n in hollow.make_nodes(8, zones=4):
        store.add(n)
    cfg = KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=8, mode="gang",
        chain_cycles=False)
    sched = Scheduler(store, config=cfg, device="cpu")
    for p in hollow.make_pods(30, group_labels=4):
        store.add(p)
    out = drain(sched)
    assert len(out) == 30
    assert all(o.node for o in out), [(o.pod.metadata.name, o.err)
                                      for o in out if not o.node]
    assert builds[0] == 1, f"expected ONE initial resync, saw {builds[0]}"
    assert sched.resync_count >= 1
    assert len(sched.delta_rows) >= 1
    assert all(r > 0 for r in sched.delta_rows)
    sched.close()


# ---------------------------------------------------------------------------
# fingerprints


@pytest.mark.parametrize("dtype", ["bool", "float32", "float64", "int32",
                                   "int64"])
def test_device_wrapsum_equals_host(dtype):
    rng = np.random.default_rng(3)
    if dtype == "bool":
        x = rng.random((257, 33)) < 0.4
    elif dtype.startswith("float"):
        x = rng.normal(size=(300, 17)).astype(dtype) * 1e6
        x[0, :4] = [np.inf, -np.inf, -0.0, 0.0]
        x[1, 0] = np.float32(3.4e38)
    else:
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(400, 9)).astype(dtype)
        x[0, :3] = [-1, 0, 2 ** 31 - 1]
    want = tdelta._wrapsum_host(x)
    got = int(tdelta._wrapsum_dev(torch.from_numpy(x)))
    assert got == want


def test_fingerprint_equals_the_jax_package():
    """The port's host and device fingerprints equal the JAX package's
    host fingerprint of the same world, leaf for leaf."""
    pk = twin_packages()
    sides = [Side(P, verify_interval=0) for P in pk]
    for s in sides:
        s.refresh()
    jfp = sides[0].dt.fingerprint_host()
    assert np.array_equal(jfp, sides[1].dt.fingerprint_host())
    assert np.array_equal(jfp, sides[1].dt.fingerprint_device())
    assert sides[1].dt.verify()


# ---------------------------------------------------------------------------
# the differential drive: the JAX package's DeltaTensorizer against the
# port's on one churn sequence


def twin_packages():
    import kubetpu.api.types as japi
    import kubetpu.harness.hollow as jhollow
    import kubetpu.state.cache as jcache
    import kubetpu.state.delta as jdelta
    import kubetpu.framework.types as jtypes
    import kubetpu_torch.state.cache as tcache
    import kubetpu_torch.framework.types as ttypes
    return (SimpleNamespace(name="jax", api=japi, hollow=jhollow,
                            cache=jcache, delta=jdelta, types=jtypes),
            SimpleNamespace(name="port", api=api, hollow=hollow,
                            cache=tcache, delta=tdelta, types=ttypes))


class Side:
    """One package's cache + DeltaTensorizer over the same world, with
    every gather_delta output recorded."""

    def __init__(self, P, n_nodes=8, pods_per_node=2, **dt_kw):
        self.P = P
        self.cache = P.cache.SchedulerCache()
        self.nodes = {}
        self.pods = {}
        for i in range(n_nodes):
            self.add_node(f"node-{i}", zone=f"zone-{i % 3}")
        for i in range(n_nodes):
            # 12 pods on 8 nodes: the pod axis (16 rows) has room to churn
            for j in range(pods_per_node if i < n_nodes // 2 else 1):
                self.add_pod(f"ex-{i}-{j}", f"node-{i}",
                             {"app": f"group-{(i + j) % 3}", "tier": "t0"})
        kw = dict(dt_kw)
        if P.name == "port":
            kw["device"] = "cpu"
        self.dt = P.delta.DeltaTensorizer(**kw)
        self.deltas = []
        orig = P.delta.gather_delta

        def recording(*a, **k):
            d = orig(*a, **k)
            self.deltas.append(d)
            return d
        self._orig_gather = orig
        P.delta.gather_delta = recording

    def close(self):
        self.P.delta.gather_delta = self._orig_gather

    def add_node(self, name, zone=None, labels=None):
        n = self.P.hollow.make_node(name, zone=zone, labels=labels)
        self.cache.add_node(n)
        self.nodes[name] = n

    def add_pod(self, name, node, labels, term=None):
        p = self.P.hollow.make_pod(name, labels=labels)
        p.metadata.uid = "u-" + name
        if term == "anti":
            self.P.hollow.with_anti_affinity(p)
        elif term == "pref":
            self.P.hollow.with_affinity(p, match={"app": "group-1"})
        p.spec.node_name = node
        self.cache.add_pod(p)
        self.pods[name] = p

    def remove_pod(self, name):
        self.cache.remove_pod(self.pods.pop(name))

    def update_node(self, name, fn):
        old = self.nodes[name]
        new = copy.deepcopy(old)
        fn(self.P.api, new)
        self.cache.update_node(old, new)
        self.nodes[name] = new

    def update_pod_labels(self, name, labels):
        old = self.pods[name]
        new = copy.copy(old)
        new.metadata = copy.deepcopy(old.metadata)
        new.metadata.labels.update(labels)
        self.cache.update_pod(old, new)
        self.pods[name] = new

    def refresh(self, pending=(), donate=True):
        snap = self.P.cache.Snapshot()
        self.cache.update_snapshot(snap)
        pis = [self.P.types.PodInfo(p) for p in pending]
        n_deltas = len(self.deltas)
        _, st = self.dt.refresh(snap.node_info_list, pending=pis,
                                donate=donate)
        return st, (self.deltas[-1] if len(self.deltas) > n_deltas
                    else None)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_sides_equal(j: Side, t: Side, jst, tst, jd, td, step):
    assert (jst.delta_rows, jst.resync, jst.reason) == (
        tst.delta_rows, tst.resync, tst.reason), (step, jst, tst)
    assert j.dt.pod_row == t.dt.pod_row, step
    assert j.dt.free_rows == t.dt.free_rows, step
    assert j.dt.next_pod_row == t.dt.next_pod_row, step
    assert j.dt.pod_uid_list() == t.dt.pod_uid_list(), step
    assert j.dt.signature() == t.dt.signature(), step
    assert (jd is None) == (td is None), step
    if jd is not None:
        for f in jd._fields:
            a, b = np.asarray(getattr(jd, f)), getattr(td, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (step, f)
    jc, tc = j.dt.cluster, t.dt.cluster
    for f in jc._fields:
        jl = tdelta._leaves(getattr(jc, f))
        tl = tdelta._leaves(getattr(tc, f))
        assert len(jl) == len(tl), (step, f)
        for a, b in zip(jl, tl):
            a, b = np.asarray(a), _np(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (step, f)
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
                step, f)


def _flip_unschedulable(A, n):
    n.spec.unschedulable = not n.spec.unschedulable


def _relabel(A, n):
    n.metadata.labels["disk"] = "ssd"


def _new_taint(A, n):
    n.spec.taints.append(A.Taint(key="dedicated", value="gpu",
                                 effect="NoSchedule"))


def _existing_label(A, n):
    # two pod labels (already interned) that push the node past its id
    # list's width without growing any vocab
    n.metadata.labels["app"] = "group-0"
    n.metadata.labels["tier"] = "t0"


CHURN_SCRIPT = (
    # (what, expected reason or None for a scatter)
    ("commit", None), ("evict", None), ("update-pod", None),
    ("node-update", None), ("term-commit", None), ("term-evict", None),
    ("taint", None), ("pending-key", "vocab-growth"),
    ("relabel-node", "label-capacity"), ("add-node", "node-set"),
    ("grow-pods", "pod-axis-growth"), ("churn-all", "delta-too-large"),
    ("corrupt", "verify-divergence"), ("tick", "anti-entropy"),
    ("commit", None), ("evict", None))


def _script_step(side: Side, what: str, k: int):
    pending = ()
    if what == "commit":
        side.add_pod(f"c{k}", "node-1", {"app": "group-2"})
    elif what == "evict":
        side.remove_pod(sorted(side.pods)[k % len(side.pods)])
    elif what == "update-pod":
        side.update_pod_labels("ex-2-0", {"app": "group-1"})
    elif what == "node-update":
        side.update_node("node-3", _flip_unschedulable)
    elif what == "term-commit":
        side.add_pod("t0", "node-4", {"app": "group-0"}, term="anti")
        side.add_pod("t1", "node-5", {"app": "group-1"}, term="pref")
    elif what == "term-evict":
        side.remove_pod("t0")
    elif what == "taint":
        side.update_node("node-6", _new_taint)
    elif what == "pending-key":
        p = side.P.hollow.make_pod("pend", labels={"app": "group-0"})
        side.P.hollow.with_spread(p, "custom.io/rack")
        pending = (p,)
    elif what == "relabel-node":
        side.update_node("node-2", _existing_label)
    elif what == "add-node":
        side.add_node("late-node", zone="zone-0")
    elif what == "grow-pods":
        dt = side.dt
        n = (dt.host.arrays["pod_node"].shape[0] - dt.next_pod_row
             + len(dt.free_rows))
        for i in range(n + 1):
            side.add_pod(f"g{i}", f"node-{i % 8}", {"app": "group-1"})
    elif what == "churn-all":
        for i in range(8):
            side.update_node(f"node-{i}", _relabel)
    elif what == "corrupt":
        side.add_pod(f"c{k}", "node-7", {"app": "group-0"})
        c = side.dt.cluster
        if side.P.name == "port":
            c.requested[0, 0] += 1.0
        else:
            side.dt.cluster = c._replace(
                requested=c.requested.at[0, 0].add(1.0))
    elif what == "tick":
        side.add_pod(f"c{k}", "node-0", {"app": "group-0"})
        side.dt.cycles_since_resync = side.dt.resync_interval
    return pending


def test_churn_sequence_equals_the_jax_delta_tensorizer():
    """Every resync trigger and the term refresh, reached in one scripted
    sequence, with the JAX package's DeltaTensorizer and the port's equal
    after every refresh: stats, row maps, delta tables, residents."""
    jp, tp = twin_packages()
    kw = dict(max_delta_frac=0.5, verify_interval=1)
    j, t = Side(jp, **kw), Side(tp, **kw)
    try:
        reasons, terms = [], 0
        jst, jd = j.refresh()
        tst, td = t.refresh()
        assert tst.reason == "initial"
        assert_sides_equal(j, t, jst, tst, jd, td, "initial")
        reasons.append(tst.reason)
        for k, (what, want) in enumerate(CHURN_SCRIPT):
            jst, jd = j.refresh(_script_step(j, what, k))
            tst, td = t.refresh(_script_step(t, what, k))
            assert_sides_equal(j, t, jst, tst, jd, td, what)
            if want is not None:
                assert tst.resync and tst.reason == want, (what, tst)
            else:
                assert not tst.resync and tst.delta_rows > 0, (what, tst)
            terms += "delta-terms" in [n for n, _, _ in tst.spans]
            reasons.append(tst.reason)
        assert set(reasons) >= {
            "initial", "node-set", "vocab-growth", "label-capacity",
            "anti-entropy", "pod-axis-growth", "delta-too-large",
            "verify-divergence"}
        assert terms >= 2
        assert t.dt.divergence_count == 1 and t.dt.verify()
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_churn_equals_the_jax_delta_tensorizer(seed):
    """A seeded random mix of binds, evictions, label and node updates,
    term pods and new taints, both packages refreshed after every step."""
    jp, tp = twin_packages()
    j, t = Side(jp), Side(tp)
    rng = random.Random(seed)
    try:
        j.refresh()
        t.refresh()
        for k in range(30):
            op = rng.choice(["commit", "commit", "term", "evict",
                             "update-pod", "node", "taint"])
            node = f"node-{rng.randrange(8)}"
            app = {"app": f"group-{rng.randrange(4)}"}
            term = rng.choice([None, "anti", "pref"])
            victim = None
            if j.pods:
                victim = sorted(j.pods)[rng.randrange(len(j.pods))]
            for s in (j, t):
                if op in ("commit", "term"):
                    s.add_pod(f"r{k}", node, app,
                              term=term if op == "term" else None)
                elif op == "evict" and victim:
                    s.remove_pod(victim)
                elif op == "update-pod" and victim:
                    s.update_pod_labels(victim, app)
                elif op == "node":
                    s.update_node(node, _flip_unschedulable)
                elif op == "taint":
                    s.update_node(node, _new_taint)
            jst, jd = j.refresh()
            tst, td = t.refresh()
            assert_sides_equal(j, t, jst, tst, jd, td, (k, op))
    finally:
        j.close()
        t.close()


def test_apply_cluster_delta_matches_the_jax_scatter():
    """The port's scatter, shared and donated, equals the JAX program's
    on the same resident and delta tables (pads included)."""
    from kubetpu.models import programs as jprog
    from kubetpu_torch.models import programs as tprog
    jp, tp = twin_packages()
    j, t = Side(jp), Side(tp)
    try:
        j.refresh()
        t.refresh()
        for s in (j, t):
            s.add_pod("x", "node-2", {"app": "group-9"})
            s.update_node("node-5", _flip_unschedulable)
        jc0 = j.dt.cluster
        tc0 = t.dt.cluster
        tclone = tc0._replace(**{f: getattr(tc0, f).clone()
                                 for f in NODE_AXIS_AND_VOCAB + POD_AXIS})
        jst, jd = j.refresh(donate=False)
        tst, td = t.refresh()
        assert not tst.resync and jd is not None
        want = jprog.apply_cluster_delta(jc0, jd, donate=False)
        for donate, base in ((False, tclone), (True, tclone)):
            got = tprog.apply_cluster_delta(base, td, donate=donate)
            for f in NODE_AXIS_AND_VOCAB + POD_AXIS:
                assert np.array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy()), (donate, f)
        assert len(td.node_rows) > int((td.node_rows < 8).sum())  # pads
    finally:
        j.close()
        t.close()


def test_densify_ids_drops_out_of_range_ids():
    ids = torch.tensor([[0, 3, -1], [7, 8, 2]], dtype=torch.int32)
    out = _densify_ids(ids, 8)
    assert out.tolist() == [[1, 0, 0, 1, 0, 0, 0, 0],
                            [0, 0, 1, 0, 0, 0, 0, 1]]
