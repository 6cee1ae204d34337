"""Custom profiles and the framework's extension points: the port against
the JAX package, bitwise.

Worlds come from kubetpu_torch/harness/plugin_worlds.py (NodeLabel labels,
limits, an extended resource, Services, Permit pairs) and
torch_port_util.churned, built in the JAX package's API types; the JAX
package tensorizes them, and its tensors cross to the port as numpy
leaves, so both sides read identical state.  Held bitwise (tolerance 0):
the configurable scorers (ops/kernels.py) against their JAX originals;
prng.split against jax.random.split; schedule_batch's FilterScoreResult
and placements; the sequential replay with the three scorers in both
sampling settings (every SeqResult field); the gang auction under lax and
under pallas (plain K1 on the CPU) with MostAllocated, host_ok and a host
score bias (every GangResult field); the routing reasons; and whole
scheduler drives with host plugins at every point, in both modes, with
injected Reserve, Permit and PreBind failures (every cycle's outcomes,
pods, conditions and queues, the per-pod extension-point calls, and the
forgotten assumes).  The one stated divergence: a RequestedToCapacityRatio
resource the cluster does not know (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu.api.types as japi
import kubetpu.apis.config as jconf
import kubetpu.client.store as jstore
import kubetpu.framework.interface as jfw
import kubetpu.plugins.intree as jintree
import kubetpu_torch.api.types as tapi
import kubetpu_torch.apis.config as tconf
import kubetpu_torch.framework.interface as tfw
import kubetpu_torch.plugins.intree as tintree
from kubetpu.framework.runtime import Framework as JFramework
from kubetpu.framework.types import NodeInfo as JNodeInfo
from kubetpu.framework.types import PodInfo as JPodInfo
from kubetpu.models import gang as jgang
from kubetpu.models import programs as jprog
from kubetpu.models import sequential as jseq
from kubetpu.models.batch import PodBatchBuilder as JBatchBuilder
from kubetpu.ops import kernels as jK
from kubetpu.state.tensors import SnapshotBuilder as JSnapshotBuilder
from kubetpu.utils import pallas_backend as JPB
from kubetpu_torch.framework.runtime import Framework as TFramework
from kubetpu_torch.harness import plugin_worlds as PW
from kubetpu_torch.models import gang as tgang
from kubetpu_torch.models import programs as tprog
from kubetpu_torch.models import sequential as tseq
from kubetpu_torch.ops import kernels as tK
from kubetpu_torch.utils import pallas_backend as TPB
from kubetpu_torch.utils import prng
from tests.torch_port_util import (_infos, assert_same, build_jax, carry,
                                   drive, jax_gumbel, packages, port_cfg)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The replay issues a few hundred small ops per pod; one intra-op
    thread gives the same bits and no thread overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(rng):
    return torch.tensor(np.asarray(rng).astype(np.int64))


def registry(base, fw, seed=0, calls=None, fail_at=None):
    reg = dict(base)
    reg[PW.POINTS] = PW.points_plugin(fw, seed, [] if calls is None
                                      else calls, fail_at)
    return reg


def plugin_world(seed, n_nodes, n_pods, terms=False, scorers=True,
                 pct=100):
    """A plugin world tensorized by the JAX package under its profile:
    (cluster, batch numpy, cfg, table).  The JAX Framework's tensor
    partition and kernel args make the cfg; the port's Framework, built
    from the port's copy of the profile, must give the same ones."""
    nodes, existing, pending, services = PW.world(japi, seed, n_nodes,
                                                  n_pods, terms)
    store = jstore.ClusterStore()
    for s in services:
        store.add(s)
    sb = JSnapshotBuilder()
    pinfos = [JPodInfo(p) for p in pending]
    sb.intern_pending(pinfos)
    host = sb.build(_infos(JNodeInfo, nodes, existing))
    batch = jax.tree.map(np.asarray, JBatchBuilder(sb.table).build(
        pinfos, spread_selectors=[store.default_spread_selector(p)
                                  for p in pending]))
    jf = JFramework(registry(jintree.new_in_tree_registry(), jfw),
                    PW.profile(jconf, scorers))
    tf = TFramework(registry(tintree.new_in_tree_registry(), tfw),
                    PW.profile(tconf, scorers))
    cfg = jprog.ProgramConfig(
        filters=jf.tensor_filters, scores=jf.tensor_scores,
        hostname_topokey=max(sb.table.topokey.get(japi.LABEL_HOSTNAME), 0),
        plugin_args=jf.tensor_plugin_args(sb.table),
        percentage_of_nodes_to_score=pct)
    assert (tf.tensor_filters, tf.tensor_scores,
            tf.tensor_plugin_args(sb.table)) == (
        cfg.filters, cfg.scores, cfg.plugin_args)
    return host.to_device(), batch, cfg, sb.table


# ---------------------------------------------------------------------------
# the configurable scorers


SHAPES = [((0, 0), (100, 100)), ((0, 100), (100, 0)),
          ((0, 10), (100, 0)), ((0, 0), (40, 70), (100, 30)),
          ((10, 5), (35, 90), (60, 20), (90, 100))]


@pytest.mark.parametrize("shape", SHAPES)
def test_broken_linear_and_itrunc_match_reference(shape):
    """Every utilization 0..110 (and -10..-1, fractional halves) through
    each shape, and Go's truncating division on signed operands."""
    p = np.concatenate([np.arange(-10, 111, dtype=np.float32),
                        np.arange(0, 100, dtype=np.float32) + 0.5])
    assert_same(jK.broken_linear(jnp.asarray(p), shape),
                tK.broken_linear(torch.tensor(p), shape), f"{shape}")
    a = np.arange(-1000, 1001, 7, dtype=np.float32)
    for b in (1.0, 3.0, 40.0, 100.0):
        assert_same(jK._itrunc(jnp.asarray(a), b),
                    tK._itrunc(torch.tensor(a), b), f"itrunc {b}")


@pytest.mark.parametrize("shape", SHAPES)
def test_broken_linear_scalar_matches_reference(shape):
    """The scalar broken-linear value (the zero-capacity fallback, taken
    once per combine) equals the JAX package's broken_linear at every
    integer utilization -10..110."""
    p = np.arange(-10, 111, dtype=np.float32)
    want = np.asarray(jK.broken_linear(jnp.asarray(p), shape))
    got = np.array([tK.broken_linear_scalar(int(v), shape) for v in p],
                   dtype=np.float32)
    assert np.array_equal(want, got), shape


@pytest.mark.parametrize("seed,scorers", [(0, True), (1, True), (2, False)])
def test_scorer_kernels_match_reference(seed, scorers):
    """RequestedToCapacityRatio (cpu, memory and the extended resource,
    and the default arguments), NodeResourceLimits and the NodeLabel
    filter and score, on the world's tensors."""
    jcl, jb, cfg, _ = plugin_world(seed, 40, 64, scorers=scorers)
    tcl, tb, jbd = carry(jcl, jb)
    shape, resources = cfg.arg("RequestedToCapacityRatio",
                               tprog.DEFAULT_RTCR_ARGS)
    assert any(kind == 2 and ch >= 4 for kind, ch, _ in resources) \
        or not scorers
    present, absent, prefs = cfg.arg("NodeLabel")
    for name, want, got in [
            ("rtcr", jK.requested_to_capacity_ratio_score(
                jcl, jbd, shape, resources),
             tK.requested_to_capacity_ratio_score(tcl, tb, shape, resources)),
            ("rtcr default", jK.requested_to_capacity_ratio_score(
                jcl, jbd, ((0, 0), (100, 100)), ((0, 0, 1), (1, 0, 1))),
             tK.requested_to_capacity_ratio_score(
                 tcl, tb, ((0, 0), (100, 100)), ((0, 0, 1), (1, 0, 1)))),
            ("limits", jK.resource_limits_score(jcl, jbd),
             tK.resource_limits_score(tcl, tb)),
            ("label filter", jK.node_label_filter(jcl, jbd, present, absent),
             tK.node_label_filter(tcl, tb, present, absent)),
            ("label filter unknown", jK.node_label_filter(
                jcl, jbd, present + (-1,), absent + (-1,)),
             tK.node_label_filter(tcl, tb, present + (-1,), absent + (-1,))),
            ("label score", jK.node_label_score(jcl, jbd, prefs),
             tK.node_label_score(tcl, tb, prefs)),
            ("label score unknown", jK.node_label_score(
                jcl, jbd, prefs + ((-1, True), (-1, False))),
             tK.node_label_score(tcl, tb, prefs + ((-1, True),
                                                   (-1, False))))]:
        assert_same(want, got.contiguous(), name)
    # the world exercises what the test claims
    assert np.asarray(jK.resource_limits_score(jcl, jbd)).any()
    assert not np.asarray(jK.node_label_filter(jcl, jbd, present,
                                               absent)).all()


def test_rtcr_combine_sub_unit_capacities():
    """rtcr_combine over fractional and zero capacities and requests
    above capacity (the _safe_den and fallback branches)."""
    rs = np.random.RandomState(5)
    req = (rs.rand(4, 64) * 3).astype(np.float32)
    cap = np.where(rs.rand(4, 64) < 0.2, 0.0,
                   rs.rand(4, 64) * 2).astype(np.float32)
    for shape in SHAPES:
        parts_j = [(jnp.asarray(req[k]), jnp.asarray(cap[k]), w)
                   for k, w in enumerate((1, 2, 3, 1))]
        parts_t = [(torch.tensor(req[k]), torch.tensor(cap[k]), w)
                   for k, w in enumerate((1, 2, 3, 1))]
        assert_same(jK.rtcr_combine(parts_j, shape),
                    tK.rtcr_combine(parts_t, shape), f"{shape}")


@pytest.mark.parametrize("num", [1, 7, 256])
def test_prng_split_matches_jax(num):
    for seed in (0, 1, 12345, 2 ** 32 - 1):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
        got = prng.split(prng.PRNGKey(seed), num)
        assert np.array_equal(want.astype(np.int64), got.numpy())


# ---------------------------------------------------------------------------
# the one-shot program


@pytest.mark.parametrize("seed,terms,scorers", [(0, False, True),
                                                (1, True, True),
                                                (2, False, False)])
def test_schedule_batch_matches_reference(seed, terms, scorers):
    """filter_and_score + select_host (split keys, categorical) on a
    plugin world with a random host_ok: every FilterScoreResult field and
    the placements."""
    jcl, jb, cfg, _ = plugin_world(seed, 48, 96, terms=terms,
                                   scorers=scorers)
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    host_ok = np.random.RandomState(seed).rand(B, N) < 0.9
    rng = jax.random.PRNGKey(seed + 3)
    want, wchosen = jprog.schedule_batch(jcl, jax.tree.map(jnp.asarray, jb),
                                         cfg, rng, jnp.asarray(host_ok))
    got, gchosen = tprog.schedule_batch(tcl, tb, port_cfg(cfg), _key(rng),
                                        torch.tensor(host_ok))
    for f in ("feasible", "unresolvable", "scores"):
        assert_same(getattr(want, f), getattr(got, f), f)
    assert want.plugin_scores.keys() == got.plugin_scores.keys()
    for k in want.plugin_scores:
        assert_same(want.plugin_scores[k], got.plugin_scores[k], k)
    assert_same(wchosen, gchosen, "chosen")
    # most pods are placed, on more than one node
    chosen = np.asarray(wchosen)[:96]
    assert (chosen >= 0).sum() > 48 and len(set(chosen.tolist())) > 2


# ---------------------------------------------------------------------------
# the sequential replay


@pytest.mark.parametrize("seed,pct,terms", [(0, 100, False),
                                            (1, 0, False),
                                            (2, 40, True)])
def test_replay_with_configurable_scorers(seed, pct, terms):
    """The replay with RequestedToCapacityRatio scored against the step's
    carried usage, NodeResourceLimits and NodeLabel as static rows, the
    NodeLabel filter, a host_ok and a score bias; sampling off, adaptive
    (150 nodes: the search stops at 100) and 40%.  Every SeqResult
    field."""
    jcl, jb, cfg, _ = plugin_world(seed, 150, 48, terms=terms, pct=pct)
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    rs = np.random.RandomState(seed)
    host_ok = rs.rand(B, N) < 0.9
    bias = (rs.rand(B, N) * 5).astype(np.float32)
    rng = jax.random.PRNGKey(seed + 9)
    want = jseq.schedule_sequential(
        jcl, jax.tree.map(jnp.asarray, jb), cfg, rng, start_index=11,
        host_ok=jnp.asarray(host_ok), score_bias=jnp.asarray(bias))
    got = tseq.schedule_sequential(
        tcl, tb, port_cfg(cfg), _key(rng), start_index=11,
        host_ok=torch.tensor(host_ok), score_bias=torch.tensor(bias),
        gumbel=torch.tensor(np.asarray(jax_gumbel(rng, B, N))))
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert (np.asarray(want.chosen) >= 0).sum() > 24


# ---------------------------------------------------------------------------
# the gang auction


@pytest.mark.parametrize("backend", ["lax", "pallas"])
@pytest.mark.parametrize("seed,rw", [(0, 0), (1, 8)])
def test_gang_most_allocated_host_planes(seed, rw, backend):
    """A ClusterAutoscaler-style profile (MostAllocated, no
    LeastAllocated), the NodeLabel filter, a host_ok and a score bias:
    under pallas the plain K1 takes the generic combine with both host
    planes.  Every GangResult field."""
    jcl, jb, cfg, _ = plugin_world(seed, 24, 60, scorers=False)
    assert ("NodeResourcesMostAllocated", 1) in cfg.scores
    assert all(n != "NodeResourcesLeastAllocated" for n, _ in cfg.scores)
    assert TPB.unsupported_reason(cfg, False, jb) is None
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    rs = np.random.RandomState(seed + 1)
    host_ok = rs.rand(B, N) < 0.85
    bias = (rs.randint(0, 30, (B, N))).astype(np.float32)
    rng = jax.random.PRNGKey(seed + 21)
    want = jgang.schedule_gang(jcl, jb, cfg, rng, intra_batch_topology=False,
                               residual_window=rw, kernel_backend=backend,
                               host_ok=jnp.asarray(host_ok),
                               score_bias=jnp.asarray(bias))
    got = tgang.schedule_gang(
        tcl, tb, port_cfg(cfg), _key(rng), intra_batch_topology=False,
        residual_window=rw, kernel_backend=backend,
        host_ok=torch.tensor(host_ok), score_bias=torch.tensor(bias),
        gumbel=torch.tensor(np.asarray(jax_gumbel(rng, B, N))))
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f"{backend} {f}")
    assert int(got.rounds) > 1


def test_gang_pallas_takes_generic_combine(monkeypatch):
    """The pallas rounds of a MostAllocated profile run K1 with the
    generic layout (not the compiled-in default family) and with the
    host planes: the bias plane in the stack, host_ok in the mask."""
    from kubetpu_torch.ops import propose as TPK
    jcl, jb, cfg, _ = plugin_world(3, 24, 60, scorers=False)
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    layouts = []
    plain = TPK.propose_plain

    def spy(bundle, *a):
        layouts.append(bundle["layout"])
        return plain(bundle, *a)
    monkeypatch.setattr(TPK, "propose_plain", spy)
    tgang.schedule_gang(tcl, tb, port_cfg(cfg), torch.tensor([0, 5]),
                        intra_batch_topology=False, kernel_backend="pallas",
                        host_ok=torch.ones((B, N), dtype=torch.bool),
                        score_bias=torch.ones((B, N)))
    assert layouts
    assert all(not L.default_family and "bias" in L.planes
               for L in layouts)


def test_routing_reasons_match_reference():
    """utils/pallas_backend: the configurable scorers route to lax as
    "score:<name>" in both packages; MostAllocated stays on K1; the
    intra-batch route and soft spread constraints as before."""
    jcl, jb, cfg, _ = plugin_world(4, 16, 24, scorers=True)
    _, jb_free, cfg_free, _ = plugin_world(4, 16, 24, scorers=False)
    cases = [(cfg, False, jb), (cfg_free, False, jb_free),
             (cfg_free, True, jb_free)]
    for name in ("RequestedToCapacityRatio", "NodeResourceLimits",
                 "NodeLabel"):
        cases.append((cfg_free._replace(scores=((name, 1),)), False,
                      jb_free))
    _, jb_terms, cfg_terms, _ = build_jax(5, 16, 40, terms=True)
    cases.append((cfg_terms, False, jb_terms))
    got = [TPB.unsupported_reason(c, i, b) for c, i, b in cases]
    assert got == [JPB.unsupported_reason(c, i, b) for c, i, b in cases]
    assert got[:6] == ["score:RequestedToCapacityRatio", None,
                       "intra-batch-topology",
                       "score:RequestedToCapacityRatio",
                       "score:NodeResourceLimits", "score:NodeLabel"]
    assert got[6] == "soft-spread-constraints"


# ---------------------------------------------------------------------------
# RequestedToCapacityRatio's unknown resource (the JAX package's resolution)


def test_rtcr_unknown_resource_matches_reference():
    """A resource the cluster does not know: the port resolves it as the
    JAX package's kernel_args does, to the first extended channel
    (N_FIXED_CHANNELS + max(-1, 0)), and so scores the world's one
    interned extended resource — bitwise the JAX kernel's scores.  (The
    upstream plugin scores it as capacity 0: a deviation of the JAX
    package that the port inherits, ROADMAP queue 3.)"""
    jcl, jb, cfg, table = plugin_world(6, 24, 40)
    assert table.rname.get(PW.EXT) == 0 and table.rname.get("x.io/y") < 0
    args = {"shape": [{"utilization": 0, "score": 0},
                      {"utilization": 100, "score": 10}],
            "resources": [{"name": "x.io/y", "weight": 1}]}
    jargs = jintree.RequestedToCapacityRatio(args).kernel_args(table)
    targs = tintree.RequestedToCapacityRatio(args).kernel_args(table)
    assert targs == jargs and jargs[1] == ((2, 4, 1),)
    tcl, tb, jbd = carry(jcl, jb)
    port = tK.requested_to_capacity_ratio_score(tcl, tb, *targs)
    assert_same(jK.requested_to_capacity_ratio_score(jcl, jbd, *jargs),
                port.contiguous(), "unknown resource")
    # the alias scores the extended resource: not capacity 0 everywhere
    assert not bool((port == 100.0).all())


# ---------------------------------------------------------------------------
# whole drives: host plugins at every point


def _drive_world(pkg, fw, intree, seed, n_nodes, n_pods, terms, mode,
                 backend, scorers, fail_at):
    calls = []
    reg = registry(intree.new_in_tree_registry(), fw, seed, calls, fail_at)
    forgotten = []

    def scenario(A, hollow, store, sched):
        orig = sched.cache.forget_pod

        def spy(pod):
            forgotten.append(pod.metadata.name)
            return orig(pod)
        sched.cache.forget_pod = spy
        nodes, existing, pending, services = PW.world(A, seed, n_nodes,
                                                      n_pods, terms)
        PW.populate(store, nodes, existing, services)
        for p in pending:
            store.add(p)
        yield
    views, sched = drive(pkg, scenario, max_cycles=3, mode=mode,
                         backend=backend, batch=16,
                         profile=PW.profile(pkg.config, scorers),
                         registry=reg, async_binding=True)
    for v in views:
        # binder threads requeue their failures, and confirm binds (which
        # move the queue's request cycle), concurrently with the cycle's
        # own failures: which of the three queues a failed pod lands in,
        # and in what order, is not an outcome; that it is queued is
        v["queued"] = sorted(v.pop("active") + v.pop("backoff")
                             + v.pop("unschedulable"))
    return views, PW.per_pod(calls), sorted(forgotten), sched


DRIVES = [
    # seed, terms, mode, backend, scorers
    (0, False, "gang", "pallas", False),
    (1, True, "gang", "pallas", True),
    (2, False, "sequential", "lax", True),
    (3, True, "sequential", "lax", True),
]


@pytest.mark.parametrize("seed,terms,mode,backend,scorers", DRIVES)
def test_drive_with_extension_points(seed, terms, mode, backend, scorers):
    """24 nodes x 40 pods in batches of 16 through both Schedulers, with
    the Permit pairs and an injected Reserve, Permit and PreBind failure:
    the same cycles, the same per-pod extension-point calls, the same
    forgotten assumes."""
    fail_at = {"p6": "Reserve", "p9": "Permit", "p13": "PreBind"}
    jpkg, tpkg = packages()
    want = _drive_world(jpkg, jfw, jintree, seed, 24, 40, terms, mode,
                        backend, scorers, fail_at)
    got = _drive_world(tpkg, tfw, tintree, seed, 24, 40, terms, mode,
                       backend, scorers, fail_at)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    views, calls, forgotten, sched = got
    # the failures took the paths they were injected at (each failed pod
    # retries in every later cycle): a Reserve failure unreserves before
    # any assume, Permit and PreBind failures forget the assume
    assert set(forgotten) == {"p9", "p13"}
    seq = [p for p, _ in calls["p6"]]
    assert seq.count("Unreserve") == seq.count("Reserve") >= 1
    assert "Permit" not in seq
    for pod in ("p9", "p13"):
        seq = [p for p, _ in calls[pod]]
        assert seq.index("Unreserve") > seq.index("Permit")
    # the pairs waited and bound
    bound = {name: node for name, node, _, _ in views[-1]["pods"]}
    assert all(bound[f"p{i}"] for i in range(2 * PW.PAIRS))
    if mode == "gang":
        route = "lax" if terms else "pallas"
        assert {b for b, _ in sched.gang_backends} == {route}


def test_providers_match_reference():
    """framework/provider.py's providers as a Framework's base set: the
    same plugins at every point as the JAX package's, the volume family
    included, and the ClusterAutoscaler provider's MostAllocated in
    LeastAllocated's place."""
    from kubetpu.framework import provider as jprov
    from kubetpu_torch.framework import provider as tprov
    assert jprov.PROVIDERS.keys() == tprov.PROVIDERS.keys()
    for name in tprov.PROVIDERS:
        fws = [F(reg, base_plugins=prov.PROVIDERS[name]())
               for F, reg, prov in (
                   (JFramework, jintree.new_in_tree_registry(), jprov),
                   (TFramework, tintree.new_in_tree_registry(), tprov))]
        views = [{ep: [p.name() for p in getattr(f, ep + "_plugins")]
                  for ep in ("queue_sort", "pre_filter", "filter",
                             "post_filter", "pre_score", "score", "reserve",
                             "permit", "pre_bind", "bind", "post_bind",
                             "unreserve")} for f in fws]
        assert views[0] == views[1], name
        assert "VolumeZone" in views[1]["filter"]
        assert fws[0].tensor_scores == fws[1].tensor_scores
    scores = dict(TFramework(tintree.new_in_tree_registry(),
                             base_plugins=tprov.cluster_autoscaler_plugins()
                             ).tensor_scores)
    assert scores["NodeResourcesMostAllocated"] == 1
    assert "NodeResourcesLeastAllocated" not in scores


def test_fit_error_message_matches_reference():
    """framework/interface.FitError's message (generic_scheduler.go:82)
    in both packages."""
    msgs = []
    for fw, api in ((jfw, japi), (tfw, tapi)):
        pod = api.Pod(metadata=api.ObjectMeta(name="p"))
        statuses = {"n1": fw.Status.unschedulable("too many pods"),
                    "n2": fw.Status.unschedulable("too many pods",
                                                  "taint"),
                    "n3": fw.Status.unresolvable("taint")}
        msgs.append((str(fw.FitError(pod, 3, statuses)),
                     str(fw.FitError(pod, 0, {}))))
    assert msgs[0] == msgs[1]
    assert msgs[1][0] == ("0/3 nodes are available: 2 taint, "
                          "2 too many pods.")
