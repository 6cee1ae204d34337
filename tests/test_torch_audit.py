"""The port's per-pod decision audit on the CPU: explain_verdicts and
explain_filters bitwise against the JAX programs on seeded worlds (with
and without host_ok), twins of tests/test_flightrecorder.py's audit and
DecisionLog tests, and whole drains whose DecisionLogs equal the JAX
scheduler's pod by pod."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.models import programs as jprog
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.harness import preempt_worlds as PW
from kubetpu_torch.models import programs as tprog
from kubetpu_torch.models.batch import take_rows
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.utils.decisions import DecisionLog, PodDecision
from tests.test_torch_profiles import plugin_world
from tests.torch_port_util import (assert_same, build_jax, build_jax_seq,
                                   carry, drive, jax_process, packages,
                                   port_cfg)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """The JAX drives here compile the JAX scheduler's programs afresh
    (torch_port_util.drive re-jits its auction) and keep ~180 MB of them
    per drive in the process: release them after each test, so a test
    worker does not accumulate them."""
    yield
    jax.clear_caches()


def _world(kind, seed):
    """(cluster jnp, batch numpy, cfg) of a seeded world."""
    if kind == "churned":
        return build_jax(seed, 40, 24)[:3]
    if kind == "churned-terms":
        return build_jax(seed, 40, 24, terms=True)[:3]
    if kind == "seq-terms":
        return build_jax_seq(seed, 40, 24)[:3]
    if kind == "plugins":
        return plugin_world(seed, 24, 24)[:3]
    return plugin_world(seed, 24, 24, terms=True)[:3]


WORLDS = ["churned", "churned-terms", "seq-terms", "plugins",
          "plugins-terms"]


def _host_ok(jb, jcl, seed):
    """A random host verdict mask with a few all-rejecting rows."""
    r = np.random.default_rng(seed)
    B, N = jb.valid.shape[0], jcl.allocatable.shape[0]
    ok = r.random((B, N)) < 0.6
    ok[::5] = False
    return ok


@pytest.mark.parametrize("with_host_ok", [False, True])
@pytest.mark.parametrize("kind", WORLDS)
def test_explain_verdicts_matches_jax(kind, with_host_ok):
    jcl, jb, cfg = _world(kind, 3)
    tcl, tb, _ = carry(jcl, jb)
    host = _host_ok(jb, jcl, 3) if with_host_ok else None
    want = jprog.explain_verdicts(
        jcl, jax.tree.map(jnp.asarray, jb), cfg,
        None if host is None else jnp.asarray(host))
    got = tprog.explain_verdicts(
        tcl, tb, port_cfg(cfg),
        None if host is None else torch.from_numpy(host))
    assert_same(want, got, f"{kind} packed")
    F = len(cfg.filters)
    w = np.asarray(want)
    # the audit has feasible pods to score, and with host_ok's rejecting
    # rows infeasible ones to attribute
    assert (w[2 * F + 1] >= 0).any()
    assert w[2 * F].any() or not with_host_ok
    nf_w, blk_w = jprog.explain_filters(
        jcl, jax.tree.map(jnp.asarray, jb), cfg,
        None if host is None else jnp.asarray(host))
    nf_t, blk_t = tprog.explain_filters(
        tcl, tb, port_cfg(cfg),
        None if host is None else torch.from_numpy(host))
    assert_same(nf_w, nf_t, "no_feasible")
    assert_same(blk_w, blk_t, "blocking")


@pytest.mark.parametrize("with_host_ok", [False, True])
@pytest.mark.parametrize("kind", WORLDS)
def test_explain_verdicts_on_gathered_rows(kind, with_host_ok):
    """The scheduler audits only a cycle's failed rows (models/batch.
    take_rows): the program on a gathered sub-batch, rows shuffled, equals
    those columns of the JAX program on the whole batch, bitwise."""
    jcl, jb, cfg = _world(kind, 5)
    tcl, tb, _ = carry(jcl, jb)
    host = _host_ok(jb, jcl, 5) if with_host_ok else None
    want = np.asarray(jprog.explain_verdicts(
        jcl, jax.tree.map(jnp.asarray, jb), cfg,
        None if host is None else jnp.asarray(host)))
    B = jb.valid.shape[0]
    rows = np.random.default_rng(5).permutation(B)[:B // 3 + 1]
    idx = torch.from_numpy(rows).to(torch.int64)
    got = tprog.explain_verdicts(
        tcl, take_rows(tb, idx), port_cfg(cfg),
        None if host is None else torch.from_numpy(host)[idx])
    assert_same(want[:, rows], got, f"{kind} gathered")
    F = len(cfg.filters)
    assert (want[2 * F + 1, rows] >= 0).any()


def test_explain_verdicts_score_rounding_and_clip():
    """best_score: milli-units rounded half to even and clipped to the
    i32 range, as the JAX program packs it — a profile whose weights push
    totals past 2**31 / 1000."""
    jcl, jb, cfg = _world("churned", 4)
    heavy = cfg._replace(scores=tuple((n, w * 3000) for n, w in cfg.scores))
    tcl, tb, _ = carry(jcl, jb)
    want = jprog.explain_verdicts(jcl, jax.tree.map(jnp.asarray, jb), heavy)
    got = tprog.explain_verdicts(tcl, tb, port_cfg(heavy))
    assert_same(want, got, "heavy")
    F = len(cfg.filters)
    assert (np.asarray(want)[2 * F + 2] == 2 ** 31 - 128).any()


# ---------------------------------------------------------------------------
# tests/test_flightrecorder.py twins


def _fr_world(n_nodes=2, n_pods=6, batch=1, infeasible=True):
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes):
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch), device="cpu")
    for p in hollow.make_pods(n_pods):
        store.add(p)
    if infeasible:
        store.add(hollow.make_pod("too-big", cpu_milli=999999))
    return store, sched


def _drain(sched):
    out = []
    for _ in range(32):
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        out.extend(got)
    return out


def test_decision_audit_names_rejecting_plugin():
    store, sched = _fr_world(batch=8)
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if not o.node) == 1
        d = sched.decisions.get("too-big")
        assert d is not None and d.outcome == "unschedulable"
        assert d.blocking == ["NodeResourcesFit"]
        assert d.rejections.get("NodeResourcesFit") == 2
        assert "NodeResourcesFit" in d.why()
        ok = sched.decisions.get("pod-0")
        assert ok is not None and ok.outcome == "scheduled" and ok.node
    finally:
        sched.close()


def test_decision_log_bounded_eviction():
    log = DecisionLog(capacity=3, enabled=True)
    for i in range(5):
        log.record(PodDecision(name=f"p{i}", namespace="default",
                               uid=f"u{i}", outcome="scheduled",
                               node="n1"))
    assert len(log) == 3 and log.evicted() == 2
    assert log.get("p0") is None and log.get("p4") is not None
    log.record(PodDecision(name="p4", namespace="default", uid="u4",
                           outcome="unschedulable"))
    assert len(log) == 3 and log.evicted() == 2
    assert log.get("p4").outcome == "unschedulable"
    doc = log.to_dict()
    assert doc["size"] == 3 and doc["evicted"] == 2


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_contention_loser_reports_best_feasible(mode):
    store = ClusterStore()
    store.add(hollow.make_node("n1", cpu_milli=1000))
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=4, mode=mode),
        device="cpu")
    try:
        for i in range(3):
            store.add(hollow.make_pod(f"c{i}", cpu_milli=400))
        outs = _drain(sched)
        losers = [o.pod.metadata.name for o in outs if not o.node]
        assert len(losers) == 1
        d = sched.decisions.get(losers[0])
        assert d is not None and d.outcome == "unschedulable"
        assert d.best_node == "n1" and d.best_score is not None
        assert "best feasible score" in d.why()
    finally:
        sched.close()


def test_audit_off_records_nothing(monkeypatch):
    """With the audit disabled no decision is recorded and the audit
    program never runs."""
    def boom(*a, **kw):
        raise AssertionError("the audit ran while disabled")
    monkeypatch.setattr(DecisionLog, "record", boom)
    monkeypatch.setattr(tprog, "explain_verdicts", boom)
    store, sched = _fr_world(batch=8)
    sched.decisions.enabled = False
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 6
        assert len(sched.decisions) == 0
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# whole drains: the DecisionLog pod by pod


DECISION_FIELDS = ("name", "namespace", "outcome", "node", "nominated_node",
                   "message", "n_feasible", "best_node", "best_score",
                   "rejections", "blocking", "host_reasons", "cycle")


def _log(sched):
    return {d.name: tuple(getattr(d, f) for f in DECISION_FIELDS)
            for d in sched.decisions.recent(10 ** 6)}


def world_scenario(seed, n_nodes, n_pending, terms):
    def scenario(A, H, store, sched):
        w = PW.world(A, seed, n_nodes, n_pending, terms=terms)
        PW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        for p in w.pending:
            store.add(p)
        store.add(H.make_pod("too-big", cpu_milli=999999))
        yield
    return scenario


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


def _jax_drain(size, terms, mode):
    """The JAX scheduler's drain of world_scenario (run in jax_proc): its
    per-cycle views and DecisionLog."""
    jp, _ = packages()
    want, js = drive(jp, world_scenario(21, *size, terms), mode=mode)
    return want, _log(js)


@pytest.mark.parametrize("mode,terms", [("sequential", False),
                                        ("gang", False), ("gang", True)])
def test_drain_decision_log_equals_jax(mode, terms, jax_proc):
    """A preemption world (evictions, nominations, an impossible pod)
    drained through both schedulers: every pod's recorded decision equal,
    field by field."""
    _, tp = packages()
    # term-bearing preemptors take the per-pod reprieve, slow in the JAX
    # package on the CPU: a smaller world
    size = (16, 8) if terms else (20, 12)
    want, jl = jax_proc.submit(_jax_drain, size, terms, mode).result()
    got, ts = drive(tp, world_scenario(21, *size, terms), mode=mode)
    assert got == want
    tl = _log(ts)
    assert set(jl) == set(tl) and len(tl) > size[1]
    for name in jl:
        assert tl[name] == jl[name], (name, jl[name], tl[name])
    assert tl["too-big"][DECISION_FIELDS.index("blocking")] == [
        "NodeResourcesFit"]
    assert any(v["nominated"] for v in got)
    assert any(v["deleted"] for v in got)
