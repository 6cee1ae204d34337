"""The port's gang auction with intra-batch topology against
kubetpu.models.gang: pod (anti-)affinity, hard and soft spread
constraints and controller spread selectors inside the auction, held
bitwise (tolerance 0) on every GangResult field.

Differential worlds are seeded and small (at most 64 nodes x 32 pods):
kubetpu_torch/harness/seq_worlds.py's worlds with every default family
live, tests/torch_port_util.py's churned worlds with terms, and the
intra-batch worlds of tests/test_gang.py rebuilt in both packages' API
types.  Both sides read identical state (JAX tensors cross as numpy
leaves) and the JAX selectHost plane.  The auction cases pad the four
seeds' worlds to one shape (padding rows are invalid, as the builders'
own bucket padding), so the JAX program compiles once per option set."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu.api.types as japi
import kubetpu.apis.config as jconf
import kubetpu.client.store as jstore
import kubetpu.harness.hollow as jhollow
import kubetpu.scheduler as jsched
import kubetpu_torch.api.types as tapi
import kubetpu_torch.apis.config as tconf
import kubetpu_torch.client.store as tstore
import kubetpu_torch.harness.hollow as thollow
import kubetpu_torch.scheduler as tsched
from kubetpu.models import gang as jgang
from kubetpu.ops import kernels as JK
from kubetpu.ops import selectors as JS
from kubetpu_torch.models import gang as tgang
from kubetpu_torch.ops import kernels as TK
from kubetpu_torch.ops import selectors as TS
from kubetpu_torch.utils import pallas_backend as TPB
from tests.torch_port_util import (assert_same, build_jax, build_jax_from,
                                   build_jax_seq, build_port_from, carry,
                                   churned, jax_gumbel, port_cfg)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

SEEDS = [0, 1, 2, 3]


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Small ops run faster on one intra-op thread on a shared CPU; every
    reduction here is exact, so the bits do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(rng):
    return torch.tensor(np.asarray(rng).astype(np.int64))


def _cmp(a, b, ctx):
    if hasattr(a, "_fields"):
        for f in a._fields:
            _cmp(getattr(a, f), getattr(b, f), f"{ctx}.{f}")
    elif a is None:
        assert b is None, ctx
    else:
        assert_same(a, b, ctx)


def _cmp_result(want, got, ctx=""):
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f"{ctx} {f}")
    # the round loop reads the device once per round
    assert got.syncs == int(got.rounds)


# ---------------------------------------------------------------------------
# worlds padded to one shape


def _pad_leaf(path, x, shape, target):
    """Zero-pad x (numpy) to ``shape``; ids and pod rows pad with -1; a
    per-pod term set's flat [B*T] slot index pads per pod to T'."""
    m = re.match(r"\[1\]\.(\w+?)(?:\.sel)?\.index$", path)
    if m:
        valid = {"rna_sel": "rna_valid", "pna_sel": "pna_valid"}.get(
            m.group(1), m.group(1) + ".valid")
        if valid in target:
            B, T = target[valid]
            t_have = x.shape[0] // B
            x = np.pad(x.reshape(B, t_have), [(0, 0), (0, T - t_have)])
            return x.reshape(-1)
    fill = -1 if path.endswith(("pod_node", "kv_ids", "key_ids")) else 0
    pad = [(0, s - h) for s, h in zip(shape, x.shape)]
    return np.pad(x, pad, constant_values=fill)


def padded_worlds(seeds, n_nodes, n_pods):
    """build_jax_seq's worlds of ``seeds``, every leaf padded to the
    largest shape among them: {seed: (cluster jnp, batch numpy, cfg)}."""
    built = {s: build_jax_seq(s, n_nodes, n_pods)[:3] for s in seeds}
    flat = {s: jax.tree_util.tree_flatten_with_path((w[0], w[1]))
            for s, w in built.items()}
    paths = [jax.tree_util.keystr(k) for k, _ in flat[seeds[0]][0]]
    shapes = [tuple(max(d) for d in zip(*[np.shape(flat[s][0][i][1])
                                          for s in seeds]))
              for i in range(len(paths))]
    # [B, T] shapes of the batch's term validity arrays, by owner name
    target = {}
    for p, sh in zip(paths, shapes):
        m = re.match(r"\[1\]\.(?:(\w+)\.valid|(rna_valid|pna_valid))$", p)
        if m:
            target[m.group(2) or m.group(1) + ".valid"] = sh
    out = {}
    for s in seeds:
        leaves, tdef = flat[s]
        new = [_pad_leaf(p, np.asarray(x), sh, target)
               for p, (_, x), sh in zip(paths, leaves, shapes)]
        cl, b = jax.tree_util.tree_unflatten(tdef, new)
        out[s] = (jax.tree.map(jnp.asarray, cl), b, built[s][2])
    return out


_WORLDS = {}


def world(seed):
    """The auction cases' worlds: 12 nodes x 30 pods (a contended world:
    several rounds, so the windows and deferrals bind)."""
    if not _WORLDS:
        _WORLDS.update(padded_worlds(SEEDS, 12, 30))
    return _WORLDS[seed]


# ---------------------------------------------------------------------------
# module-level pieces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selector_sets_match_reference(seed):
    """concat_selector_sets (existing terms + the batch's anti terms, and
    the reverse, so both Q paddings run) and pad_selector_slots."""
    jcl, jb, _, _ = build_jax(seed, 24, 20, terms=True)
    tcl, tb, jbd = carry(jcl, jb)
    for ja, jb_, ta, tb_ in ((jcl.filter_terms.sel, jbd.raa.sel,
                              tcl.filter_terms.sel, tb.raa.sel),
                             (jbd.spread.sel, jcl.score_terms.sel,
                              tb.spread.sel, tcl.score_terms.sel)):
        _cmp(JS.concat_selector_sets(ja, jb_),
             TS.concat_selector_sets(ta, tb_), "concat")
    s = jbd.pref.sel
    for to in (s.index.shape[0], s.index.shape[0] + 5):
        _cmp(JS.pad_selector_slots(s, to),
             TS.pad_selector_slots(tb.pref.sel, to), f"pad {to}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extend_cluster_matches_reference(seed):
    jcl, jb, _, _ = build_jax(seed, 24, 20, terms=True)
    tcl, tb, jbd = carry(jcl, jb)
    assert np.asarray(jbd.raa.valid).any()
    _cmp(jgang._extend_cluster(jcl, jbd), tgang._extend_cluster(tcl, tb),
         "ext")


# seed, feasible density, strip the soft constraints (the no-constraint
# branch), active topology keys
SOFT_CASES = [(0, 0.7, False, False), (1, 0.4, False, True),
              (2, 0.9, False, False), (3, 0.7, True, False)]


@pytest.mark.parametrize("seed,density,strip,keys", SOFT_CASES)
def test_spread_soft_score_matches_reference(seed, density, strip, keys):
    """The full soft-spread scorer on worlds with zone and hostname soft
    constraints (two on some pods), random feasible masks."""
    jcl, jb, cfg, _ = build_jax_seq(seed, 40, 24)
    tcl, tb, jbd = carry(jcl, jb)
    if strip:
        jbd = jbd._replace(spread_soft=jbd.spread_soft._replace(
            valid=jnp.zeros_like(jbd.spread_soft.valid)))
        tb = tb._replace(spread_soft=tb.spread_soft._replace(
            valid=torch.zeros_like(tb.spread_soft.valid)))
    else:
        keys_used = set(np.asarray(jbd.spread_soft.topo_key)[
            np.asarray(jbd.spread_soft.valid)].tolist())
        assert cfg.hostname_topokey in keys_used and len(keys_used) == 2
    active = (tuple(sorted(set(np.asarray(jbd.spread_soft.topo_key)
                               .reshape(-1).tolist())))
              if keys else None)
    rs = np.random.RandomState(seed)
    B, N = jbd.req.shape[0], jcl.allocatable.shape[0]
    feas = rs.rand(B, N) < density
    aff_j = JK.node_affinity_filter(jcl, jbd)
    aff_t = TK.node_affinity_filter(tcl, tb)
    want = JK.spread_soft_score(jcl, jbd, jnp.asarray(feas), aff_j,
                                cfg.hostname_topokey, active_keys=active)
    got = TK.spread_soft_score(tcl, tb, torch.tensor(feas), aff_t,
                               cfg.hostname_topokey, active_keys=active)
    assert_same(want, got, "spread_soft_score")
    if not strip:
        assert len(np.unique(np.asarray(want)[feas])) > 2


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_interpod_filter_no_matches(seed):
    jcl, jb, cfg, _ = build_jax_seq(seed, 40, 24)
    tcl, tb, jbd = carry(jcl, jb)
    want = JK.interpod_filter(jcl, jbd, return_no_matches=True)
    got = TK.interpod_filter(tcl, tb, return_no_matches=True)
    assert len(want) == len(got) == 3
    for i, (a, b) in enumerate(zip(want, got)):
        assert_same(a, b, f"interpod_filter[{i}]")
    assert np.asarray(jbd.ra.valid).any() and np.asarray(want[2]).any()


# ---------------------------------------------------------------------------
# the auction


@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("use_host", [False, True], ids=["nohost", "host"])
@pytest.mark.parametrize("rw", [0, 4], ids=["full", "w4"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gang_intra_matches_reference(seed, rw, use_host, use_bias):
    """schedule_gang(intra_batch_topology=True) on worlds with every
    default family live, at full width and with a 4-row window (several
    windows, sentinel rows), with and without host_ok and score_bias."""
    jcl, jb, cfg = world(seed)
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    rs = np.random.RandomState(100 + seed)
    host_ok = rs.rand(B, N) < 0.85 if use_host else None
    bias = (rs.rand(B, N) * 7.0).astype(np.float32) if use_bias else None
    rng = jax.random.PRNGKey(seed + 3)
    gum = jax_gumbel(rng, B, N)
    want = jgang.schedule_gang(
        jcl, jb, cfg, rng, intra_batch_topology=True, residual_window=rw,
        host_ok=None if host_ok is None else jnp.asarray(host_ok),
        score_bias=None if bias is None else jnp.asarray(bias))
    got = tgang.schedule_gang(
        tcl, tb, port_cfg(cfg), _key(rng), intra_batch_topology=True,
        residual_window=rw,
        host_ok=None if host_ok is None else torch.tensor(host_ok),
        score_bias=None if bias is None else torch.tensor(bias),
        gumbel=torch.tensor(np.asarray(gum)))
    _cmp_result(want, got, f"seed {seed} rw {rw}")
    assert int(want.rounds) > 1
    assert (np.asarray(want.chosen) >= 0).sum() > 10


def test_gang_worlds_bind_deferral_and_windows():
    """The auction cases' worlds exercise what they claim: windows past
    the first, and deferrals (on some seed the same batch needs more
    rounds with intra-batch topology than without)."""
    extra_rounds = 0
    for seed in SEEDS:
        jcl, jb, cfg = world(seed)
        rng = jax.random.PRNGKey(seed + 3)
        intra = jgang.schedule_gang(jcl, jb, cfg, rng, residual_window=4,
                                    intra_batch_topology=True)
        static = jgang.schedule_gang(jcl, jb, cfg, rng, residual_window=4,
                                     intra_batch_topology=False)
        extra_rounds += int(intra.rounds) > int(static.rounds)
        assert int(intra.rounds) > 2
    assert extra_rounds >= 1


# ---------------------------------------------------------------------------
# tests/test_gang.py's intra-batch worlds in both packages' API types

FIT_FILTERS = ("NodeUnschedulable", "NodeResourcesFit", "NodeName",
               "NodePorts", "NodeAffinity", "TaintToleration")
TOPO_FILTERS = FIT_FILTERS + ("PodTopologySpread", "InterPodAffinity")
LEAST_SCORES = (("NodeResourcesLeastAllocated", 1),)


def _node(A, name, labels=None, unschedulable=False):
    return A.Node(
        metadata=A.ObjectMeta(name=name, labels=labels or {}),
        spec=A.NodeSpec(taints=[], unschedulable=unschedulable),
        status=A.NodeStatus(allocatable={"cpu": "4", "memory": "32Gi",
                                         "pods": "110"}))


def _pod(A, name, labels=None):
    c = A.Container(name="c", image="img:1", resources=A.ResourceRequirements(
        requests={"cpu": "100m", "memory": "200Mi"}))
    return A.Pod(metadata=A.ObjectMeta(name=name, namespace="default",
                                       labels=labels or {}),
                 spec=A.PodSpec(containers=[c]))


def _anti_never_coplaces(A, H):            # test_gang.py:164
    nodes = [_node(A, f"n{i}", {A.LABEL_HOSTNAME: f"n{i}"})
             for i in range(2)]
    pending = [H.with_anti_affinity(_pod(A, f"p{i}", {"app": "x"}),
                                    A.LABEL_HOSTNAME) for i in range(3)]
    return nodes, pending, TOPO_FILTERS


def _hard_spread_skew(A, H):                # :228
    nodes = [_node(A, f"n{i}", {A.LABEL_HOSTNAME: f"n{i}",
                                A.LABEL_ZONE: f"z{i % 2}"})
             for i in range(4)]
    pending = [H.with_spread(_pod(A, f"p{i}", {"app": "s"}), A.LABEL_ZONE,
                             when="DoNotSchedule") for i in range(6)]
    return nodes, pending, TOPO_FILTERS


def _affinity_by_batch_pod(A, H):           # :250 (the bootstrap rule)
    nodes = [_node(A, f"n{i}", {A.LABEL_HOSTNAME: f"n{i}",
                                A.LABEL_ZONE: f"z{i}"}) for i in range(2)]
    pending = [_pod(A, "seed", {"app": "x"}),
               H.with_affinity(_pod(A, "follower", {"app": "y"}),
                               A.LABEL_ZONE, match={"app": "x"})]
    return nodes, pending, TOPO_FILTERS


def _unresolvable_diag(A, H):               # :270
    nodes = [_node(A, "n0", unschedulable=True), _node(A, "n1")]
    return nodes, [_pod(A, "p0")], ("NodeUnschedulable", "NodeResourcesFit")


def _self_affinity(A, H):                   # :281
    nodes = [_node(A, f"n{i}", {A.LABEL_HOSTNAME: f"n{i}",
                                A.LABEL_ZONE: f"z{i % 2}"})
             for i in range(4)]
    pending = [H.with_affinity(_pod(A, f"p{i}", {"app": "gang"}),
                               A.LABEL_ZONE) for i in range(12)]
    return nodes, pending, TOPO_FILTERS


def _check_anti(chosen):
    placed = chosen[chosen >= 0]
    assert len(placed) == 2 and len(set(placed.tolist())) == 2


def _check_skew(chosen):
    assert (chosen >= 0).all()
    zones = np.bincount(chosen % 2, minlength=2)
    assert abs(zones[0] - zones[1]) <= 1


def _check_affinity(chosen):
    assert (chosen >= 0).all() and chosen[0] == chosen[1]


def _check_unres(chosen, g):
    assert chosen[0] == 1 and bool(g.unresolvable[0, 0])


def _check_self(chosen, g):
    assert (chosen >= 0).all() and len({int(c) % 2 for c in chosen}) == 1
    assert int(g.rounds) <= 4


GANG_WORLDS = {
    "anti_never_coplaces": (_anti_never_coplaces, 3, _check_anti),
    "hard_spread_skew": (_hard_spread_skew, 6, _check_skew),
    "affinity_by_batch_pod": (_affinity_by_batch_pod, 2, _check_affinity),
    "unresolvable_diag": (_unresolvable_diag, 1, _check_unres),
    "self_affinity_converges": (_self_affinity, 12, _check_self),
}


@pytest.mark.parametrize("name", sorted(GANG_WORLDS))
def test_reference_gang_worlds(name):
    """Each world built in both packages' API types and tensorized by
    each package's own builders; the port's result equals the JAX one
    bitwise and passes the reference test's own check."""
    make, n, check = GANG_WORLDS[name]
    jn, jp, filters = make(japi, jhollow)
    jcl, jb, cfg = build_jax_from(jn, {}, jp, filters, LEAST_SCORES)
    tn, tp, _ = make(tapi, thollow)
    tcl, tb, tcfg = build_port_from(tn, {}, tp, filters, LEAST_SCORES)
    assert tcfg == port_cfg(cfg)
    rng = jax.random.PRNGKey(0)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    want = jgang.schedule_gang(jcl, jb, cfg, rng)
    got = tgang.schedule_gang(tcl, tb, tcfg, _key(rng),
                              gumbel=torch.tensor(np.asarray(
                                  jax_gumbel(rng, B, N))))
    _cmp_result(want, got, name)
    chosen = got.chosen.numpy()[:n]
    if check in (_check_unres, _check_self):
        check(chosen, got)
    else:
        check(chosen)


# ---------------------------------------------------------------------------
# kernel_backend routing


def test_gang_pallas_request_routes_intra_to_lax():
    """A pallas request on a term-bearing batch runs the lax round, as
    the reference routes it, and equals the JAX result."""
    jcl, jb, cfg = world(0)
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    rng = jax.random.PRNGKey(5)
    assert TPB.unsupported_reason(port_cfg(cfg), True, jb) == \
        "intra-batch-topology"
    assert TPB.unsupported_reason(port_cfg(cfg), False, tb) == \
        "soft-spread-constraints"
    want = jgang.schedule_gang(jcl, jb, cfg, rng, residual_window=4,
                               kernel_backend="pallas")
    got = tgang.schedule_gang(tcl, tb, port_cfg(cfg), _key(rng),
                              residual_window=4, kernel_backend="pallas",
                              gumbel=torch.tensor(np.asarray(
                                  jax_gumbel(rng, B, N))))
    _cmp_result(want, got, "routed")


@pytest.mark.parametrize("seed,rw", [(4, 0), (5, 8)])
def test_term_free_bias_on_pallas_route(seed, rw):
    """A term-free batch with a host score bias stays on the pallas
    route; the bias enters the propose bundle as a plane.  On the CPU the
    plain version runs; the JAX side runs its Pallas kernel in interpret
    mode."""
    jcl, jb, cfg, _ = build_jax(seed, 20, 30)
    tcl, tb, _ = carry(jcl, jb)
    assert TPB.effective_backend(port_cfg(cfg), False, "pallas",
                                 tb) == "pallas"
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    bias = (np.random.RandomState(seed).rand(B, N) * 9.0).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    want = jgang.schedule_gang(jcl, jb, cfg, rng, intra_batch_topology=False,
                               residual_window=rw, score_bias=jnp.asarray(bias),
                               kernel_backend="pallas")
    got = tgang.schedule_gang(tcl, tb, port_cfg(cfg), _key(rng),
                              intra_batch_topology=False, residual_window=rw,
                              score_bias=torch.tensor(bias),
                              kernel_backend="pallas",
                              gumbel=torch.tensor(np.asarray(
                                  jax_gumbel(rng, B, N))))
    _cmp_result(want, got, "bias")
    assert int(want.rounds) > 1


# ---------------------------------------------------------------------------
# the Scheduler in gang mode


def _drain_world(A, store_mod, seed, n_nodes, n_pods):
    nodes, existing, pending = churned(A, seed, n_nodes, n_pods, terms=True)
    store = store_mod.ClusterStore()
    for n in nodes:
        store.add(n)
        for p in existing[n.name]:
            store.add(p)
    return store, pending


def _drain(sched, store, pending, rounds_of):
    for p in pending:
        store.add(p)
    placed, n_feas, rounds = {}, {}, []
    while True:
        out = sched.schedule_pending()
        if not out:
            break
        rounds.append(rounds_of(sched))
        for o in out:
            placed[o.pod.metadata.name] = o.node
            if o.node:
                n_feas[o.pod.metadata.name] = o.n_feasible
    sched.close()
    return placed, n_feas, rounds


@pytest.mark.parametrize("seed,n_nodes,n_pods,batch", [
    (31, 24, 40, 16),     # three cycles
    (32, 10, 32, 16),     # contended: unschedulable pods wait in backoff
])
def test_gang_drain_matches_reference(seed, n_nodes, n_pods, batch):
    """Multi-cycle gang drains of churned worlds with terms under
    kernel_backend "pallas": the port's Scheduler (its own selectHost
    plane) and the JAX scheduler give every pod the same node and
    n_feasible, run the same rounds per cycle, and route every cycle
    the same way."""
    store, pending = _drain_world(japi, jstore, seed, n_nodes, n_pods)
    jcfg = jconf.KubeSchedulerConfiguration(
        profiles=[jconf.KubeSchedulerProfile()], batch_size=batch,
        mode="gang", kernel_backend="pallas", prewarm=False)
    js = jsched.Scheduler(store, config=jcfg, async_binding=False)
    preps, routes = [], []
    orig = js._gang_backend

    def gang_backend(prep):
        # called more than once per cycle: keep each cycle's first
        if not any(p is prep for p in preps):
            preps.append(prep)
            routes.append(orig(prep))
        return orig(prep)
    js._gang_backend = gang_backend
    want = _drain(js, store, pending, lambda s: s.last_gang_rounds)
    store, pending = _drain_world(tapi, tstore, seed, n_nodes, n_pods)
    tcfg = tconf.KubeSchedulerConfiguration(
        profiles=[tconf.KubeSchedulerProfile()], batch_size=batch,
        mode="gang", kernel_backend="pallas")
    ts = tsched.Scheduler(store, config=tcfg, device="cpu")
    got = _drain(ts, store, pending, lambda s: s.gang_rounds[-1])
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert [b for b, _ in ts.gang_backends] == routes
    assert ("lax", "intra-batch-topology") in ts.gang_backends
    assert ts.gang_syncs == ts.gang_rounds
    assert len(want[2]) >= 2
    assert sum(1 for v in want[0].values() if v) > n_pods // 2
    assert tsched.capacity_violations(store) == []
