"""The port's device mesh (kubetpu_torch/parallel/mesh.py and shardmap.py)
on the CPU, bitwise (tolerance 0) against the JAX package's mesh programs
(kubetpu/parallel/mesh.py on eight virtual CPU devices) and against the
port's own single-device programs:

* the exact reductions over shards against one tensor's max, min and
  argmax, over every split of a row into 1, 2, 4 and 8 tiles, with exact
  score and gumbel ties across tile borders;
* gang_surface against the JAX package's choice;
* the tiled gang auction, the replicated one and the sequential replay
  against the JAX package's on the same seeded inputs, and the
  pre-sharded delta scatter against the single-device scatter over the
  JAX package's sharded resident;
* the serving path: Scheduler(mesh_shape=...) against the JAX scheduler
  with the same mesh and against the port without one.

Every JAX mesh drive runs in a spawned child (torch_port_util.jax_process;
the eight-device XLA_FLAGS of tests/conftest.py reach it through the
environment), with its mesh programs jitted afresh per drive; a JAX
Scheduler drains through torch_port_util.drive.
"""
import concurrent.futures
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from kubetpu_torch.models import gang as tgang
from kubetpu_torch.models.sequential import schedule_sequential
from kubetpu_torch.ops import kernels as K
from kubetpu_torch.parallel import mesh as tmesh
from kubetpu_torch.parallel import shardmap as tsm
from tests import torch_port_util as U
from tests.test_torch_delta import CHURN_SCRIPT, Side, _script_step, \
    twin_packages
from tests.torch_port_util import (assert_same, build_jax, build_jax_seq,
                                   carry, drive, jax_process, packages,
                                   port_cfg)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

NEG = -2.0 ** 62


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


def _init_four_devices():
    """A child whose XLA CPU backend has four devices (the JAX scheduler
    builds its mesh over every device, so a (2, 2) mesh needs four)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    U._child_init()


@pytest.fixture(scope="module")
def jax_proc4():
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=ctx, initializer=_init_four_devices) as ex:
        yield ex


def _rng_np(x):
    return torch.tensor(np.asarray(x).astype(np.int64))


def _fresh_jits():
    """The JAX mesh programs jitted afresh (torch_port_util.drive says why:
    this jax's dispatch can fail once a jit object holds entries of other
    static arguments)."""
    import kubetpu.parallel.shardmap as jsm
    jsm._shardmap_gang = jax.jit(
        jsm._shardmap_gang.__wrapped__,
        static_argnames=("cfg", "mesh_key", "max_rounds",
                         "intra_batch_topology", "residual_window",
                         "surface"))
    jsm._shardmap_sequential = jax.jit(
        jsm._shardmap_sequential.__wrapped__,
        static_argnames=("cfg", "mesh_key"))


def _jax_mesh(shape):
    from kubetpu.parallel import mesh as jmesh
    return jmesh.make_mesh(shape,
                           devices=jax.devices("cpu")[:shape[0] * shape[1]])


def _host_planes(seed, B, N):
    """Seeded host filter verdicts and integer host score totals."""
    r = np.random.RandomState(seed)
    return r.random_sample((B, N)) > 0.2, r.randint(0, 50, (B, N)).astype(
        np.float32)


def _fields(res):
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


# ---------------------------------------------------------------------------
# the exact reductions over shards


def _tie_row_world(kind, W=6, N=64, seed=0):
    """[W, N] totals, feasibility and gumbels: random, exact score ties
    spread over the row, and exact (score, gumbel) ties across tile
    borders (so only the lowest global index decides)."""
    g = torch.Generator().manual_seed(seed)
    total = torch.randint(0, 5, (W, N), generator=g).float()
    feas = torch.rand((W, N), generator=g) > 0.3
    gum = torch.randn((W, N), generator=g)
    if kind in ("score_ties", "gumbel_ties"):
        total = torch.where(torch.arange(N) % 7 == 3, 9.0, total)
        feas[:, 3::7] = True
    if kind == "gumbel_ties":
        # the same best gumbel on every tied column: every tile holds a
        # tie, so the minimum global index decides
        gum[:, 3::7] = 2.5
    feas[W - 1] = False            # a row with no feasible node
    return total, feas, gum


@pytest.mark.parametrize("n_tiles", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["random", "score_ties", "gumbel_ties"])
def test_exact_reductions_over_every_split(kind, n_tiles):
    total, feas, gum = _tie_row_world(kind)
    N = total.shape[1]
    nl = N // n_tiles
    best_w, h_w, arg_w = K.gumbel_tiebreak_argmax(total, feas, gum, 0, NEG)
    tb, th, ta = zip(*[K.gumbel_tiebreak_argmax(
        total[:, k * nl:(k + 1) * nl], feas[:, k * nl:(k + 1) * nl],
        gum[:, k * nl:(k + 1) * nl], k * nl, NEG) for k in range(n_tiles)])
    best, idx = K.crossaxis_first_index_argmax(list(tb), list(th),
                                               list(ta), NEG)
    for k in range(n_tiles):
        assert torch.equal(best[k], best_w)
        live = feas.any(dim=1)
        assert torch.equal(idx[k][live], arg_w[live])
    if kind == "gumbel_ties":
        assert (arg_w[:-1] == 3).all()
    cols = [total[:, k * nl:(k + 1) * nl] for k in range(n_tiles)]
    for red, fold in ((K.exact_pmax, lambda x: x.max(dim=1).values),
                      (K.exact_pmin, lambda x: x.min(dim=1).values),
                      (K.exact_psum, lambda x: x.sum(dim=1))):
        out = red([fold(c) for c in cols])
        assert len(out) == n_tiles
        for o in out:
            assert torch.equal(o, fold(total))


# ---------------------------------------------------------------------------
# the surface choice


def _surface_case(case):
    """(jax cluster, numpy batch, cfg, intra, mesh shape) of one case."""
    terms = case in ("intra", "soft_spread")
    jcl, jb, cfg, _ = build_jax(5, 12, 40, terms=terms)
    intra = case == "intra"
    shape = (2, 4)
    if case == "score":
        cfg = cfg._replace(scores=cfg.scores + (
            ("RequestedToCapacityRatio", 1),))
    if case == "nondividing":
        shape = (3, 1)
    if case == "soft_spread":
        assert jb.spread_soft.valid.any()
    return jcl, jb, cfg, intra, shape


@pytest.mark.parametrize("case", ["term_free", "intra", "soft_spread",
                                  "score", "nondividing"])
def test_gang_surface_equals_the_jax_choice(case):
    from kubetpu.parallel import shardmap as jsm
    jcl, jb, cfg, intra, shape = _surface_case(case)
    N, B = int(jcl.allocatable.shape[0]), int(jb.valid.shape[0])
    mesh = tmesh.make_mesh(shape, "cpu")
    _, tb, _ = carry(jcl, jb)
    want = jsm.gang_surface(cfg, intra, jb, mesh, N, B)
    got = tsm.gang_surface(port_cfg(cfg), intra, tb, mesh, N, B)
    assert got == want
    assert (want == "tiled") == (case == "term_free")


# ---------------------------------------------------------------------------
# the mesh programs against the JAX package's


def _jax_gang(seed, n_nodes, n_pods, shape, rw, planes, intra):
    """(child) The JAX mesh auction on the seeded world, and its
    surface."""
    from kubetpu.parallel import shardmap as jsm
    _fresh_jits()
    jcl, jb, cfg, _ = build_jax(seed, n_nodes, n_pods, terms=intra)
    B, N = int(jb.valid.shape[0]), int(jcl.allocatable.shape[0])
    host_ok, bias = _host_planes(seed, B, N) if planes else (None, None)
    rng = jax.random.PRNGKey(seed + 11)
    res = jsm.schedule_gang_mesh(
        jcl, jb, cfg, rng, _jax_mesh(shape), host_ok=host_ok,
        intra_batch_topology=intra, score_bias=bias, residual_window=rw)
    surface = jsm.gang_surface(cfg, intra, jb, _jax_mesh(shape), N, B)
    return _fields(res), surface


def _port_gang(seed, n_nodes, n_pods, shape, rw, planes, intra):
    jcl, jb, cfg, _ = build_jax(seed, n_nodes, n_pods, terms=intra)
    tcl, tb, _ = carry(jcl, jb)
    B, N = int(jb.valid.shape[0]), int(jcl.allocatable.shape[0])
    host_ok, bias = _host_planes(seed, B, N) if planes else (None, None)
    host_ok = None if host_ok is None else torch.from_numpy(host_ok)
    bias = None if bias is None else torch.from_numpy(bias)
    rng = _rng_np(jax.random.PRNGKey(seed + 11))
    mesh = tmesh.make_mesh(shape, "cpu")
    kw = dict(host_ok=host_ok, intra_batch_topology=intra,
              score_bias=bias, residual_window=rw)
    got = tmesh.sharded_schedule_gang(tcl, tb, port_cfg(cfg), rng, mesh,
                                      **kw)
    single = tgang.schedule_gang(tcl, tb, port_cfg(cfg), rng,
                                 kernel_backend="lax", **kw)
    return got, single


GANG_CASES = [
    # shape, residual_window, host planes, intra-batch topology
    ((1, 4), 0, False, False),
    ((1, 4), 4, True, False),
    ((1, 8), 0, False, False),
    ((1, 8), 4, True, False),
    ((2, 4), 0, False, False),
    ((2, 4), 4, True, False),
    ((4, 2), 0, False, False),
    ((4, 2), 4, True, False),
    ((2, 4), 512, True, True),       # the replicated surface
]


@pytest.mark.parametrize("shape,rw,planes,intra", GANG_CASES)
def test_mesh_gang_equals_the_jax_mesh(shape, rw, planes, intra, jax_proc):
    seed, n_nodes, n_pods = 3, 12, 40
    want, surface = jax_proc.submit(
        _jax_gang, seed, n_nodes, n_pods, shape, rw, planes, intra).result()
    assert surface == ("replicated" if intra else "tiled")
    got, single = _port_gang(seed, n_nodes, n_pods, shape, rw, planes,
                             intra)
    for f in want:
        assert_same(want[f], getattr(got, f), f"mesh {shape} {f}")
        assert_same(getattr(single, f), getattr(got, f), f"port {f}")
    assert got.syncs == int(got.rounds)
    if rw:
        assert int(got.rounds) > 1


def _jax_sequential(seed, shape):
    from kubetpu.parallel import mesh as jmesh
    _fresh_jits()
    jcl, jb, cfg, _ = build_jax_seq(seed, 12, 24)
    rng = jax.random.PRNGKey(seed)
    res = jmesh.sharded_schedule_sequential(jcl, jb, cfg, rng,
                                            _jax_mesh(shape), start_index=3)
    return _fields(res)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_mesh_sequential_equals_the_jax_mesh(shape, jax_proc):
    seed = 4
    want = jax_proc.submit(_jax_sequential, seed, shape).result()
    jcl, jb, cfg, _ = build_jax_seq(seed, 12, 24)
    tcl, tb, _ = carry(jcl, jb)
    rng = _rng_np(jax.random.PRNGKey(seed))
    got = tmesh.sharded_schedule_sequential(
        tcl, tb, port_cfg(cfg), rng, tmesh.make_mesh(shape, "cpu"),
        start_index=3)
    single = schedule_sequential(tcl, tb, port_cfg(cfg), rng, start_index=3)
    for f in want:
        assert_same(want[f], getattr(got, f), f"mesh {shape} {f}")
        assert_same(getattr(single, f), getattr(got, f), f"port {f}")


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_mesh_batch_programs_equal_one_device(shape):
    """sharded_schedule_batch and sharded_filter_and_score (the extender
    path's device half) on sharded inputs: the single-device programs'
    outputs."""
    from kubetpu_torch.models import programs as tprog
    jcl, jb, cfg, _ = build_jax(6, 12, 40)
    tcl, tb, _ = carry(jcl, jb)
    mesh = tmesh.make_mesh(shape, "cpu")
    cl, b = tmesh.shard_cluster(tcl, mesh), tmesh.shard_batch(tb, mesh)
    host_ok = torch.from_numpy(_host_planes(6, tb.valid.shape[0],
                                            tcl.allocatable.shape[0])[0])
    rng = _rng_np(jax.random.PRNGKey(6))
    want = tprog.schedule_batch(tcl, tb, port_cfg(cfg), rng)
    got = tmesh.sharded_schedule_batch(cl, b, port_cfg(cfg), rng, mesh)
    _same_tree(want, got)
    want = tprog.filter_and_score(tcl, tb, port_cfg(cfg), host_ok)
    got = tmesh.sharded_filter_and_score(cl, b, port_cfg(cfg), mesh,
                                         host_ok=host_ok)
    _same_tree(want, got)


def _same_tree(a, b):
    """Bitwise equality of two nests of tuples, dicts and tensors."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert_same(a.numpy(), b, "batch program")


# the churn script without its steps that poke the resident directly
MESH_SCRIPT = tuple((w, r) for w, r in CHURN_SCRIPT if w != "corrupt")


def _gathered_np(cluster):
    from kubetpu_torch.state import delta as tdelta
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for f in cluster._fields
            for x in tdelta._leaves(getattr(cluster, f))]


def _jax_delta_script(shape):
    """(child) The JAX DeltaTensorizer with a mesh through MESH_SCRIPT:
    per refresh its stats and resident (gathered) leaves."""
    jp, _ = twin_packages()
    j = Side(jp, mesh=_jax_mesh(shape), max_delta_frac=0.5)
    out = []
    try:
        for k, (what, _) in enumerate((("initial", None),) + MESH_SCRIPT):
            pending = () if what == "initial" else _script_step(j, what, k)
            st, d = j.refresh(pending)
            out.append(((st.delta_rows, st.resync, st.reason),
                        None if d is None else _fields(d),
                        _gathered_np(j.dt.cluster)))
    finally:
        j.close()
    return out


def _clone(cluster):
    return tmesh._tree_map(lambda x: x.clone(), cluster)


def _scatter_twice(u, mesh, pending):
    """One refresh of the port's unsharded resident ``u``; when it
    scattered a delta, the same delta scattered shard by shard into the
    cluster before it (the refreshed term tensors in place, which no
    delta carries) and gathered.  Returns (stats, delta, gathered or
    None)."""
    before = _clone(u.dt.cluster) if u.dt.cluster is not None else None
    st, d = u.refresh(pending)
    if d is None or st.resync:
        return st, d, None
    after = u.dt.cluster
    before = before._replace(filter_terms=after.filter_terms,
                             score_terms=after.score_terms)
    got = tmesh.sharded_apply_cluster_delta(before, d, mesh)
    assert isinstance(got, tmesh.Sharded)
    return st, d, tmesh.gather(got)


def _same_leaves(a, b, what):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), what


@pytest.mark.parametrize("shape", [(2, 2), (1, 8), (2, 4)])
def test_sharded_delta_scatter_equals_the_jax_mesh(shape, jax_proc):
    """Every delta of the churn script (rows on shard borders,
    one-past-capacity pads, term refreshes, growth) scattered shard by
    shard and gathered: equal to the single-device scatter, and the
    port's resident equal to the JAX package's sharded resident after
    every refresh."""
    want = jax_proc.submit(_jax_delta_script, shape).result()
    _, tp = twin_packages()
    mesh = tmesh.make_mesh(shape, "cpu")
    u = Side(tp, max_delta_frac=0.5)
    shard_deltas = 0
    try:
        for k, (what, _) in enumerate((("initial", None),) + MESH_SCRIPT):
            pu = () if what == "initial" else _script_step(u, what, k)
            ust, ud, got = _scatter_twice(u, mesh, pu)
            wst, wd, wleaves = want[k]
            assert (ust.delta_rows, ust.resync, ust.reason) == wst, what
            if wd is not None:
                for f, a in wd.items():
                    assert np.array_equal(a, getattr(ud, f)), (what, f)
            ref = _gathered_np(u.dt.cluster)
            _same_leaves(wleaves, ref, what)
            if got is not None:
                _same_leaves(ref, _gathered_np(got), what)
                if len(ud.node_rows):
                    shard_deltas += 1
        assert shard_deltas >= 5
    finally:
        u.close()


def test_non_dividing_delta_gathers_and_relays():
    """An axis the mesh does not divide: the scatter runs on the gathered
    cluster and the result is laid out again, equal to the unsharded
    scatter."""
    _, tp = twin_packages()
    mesh = tmesh.make_mesh((3, 1), "cpu")
    u = Side(tp)
    scattered = 0
    try:
        for k, what in enumerate(("initial", "commit", "evict",
                                  "node-update")):
            if what != "initial":
                _script_step(u, what, k)
            _, _, got = _scatter_twice(u, mesh, ())
            if got is not None:
                scattered += 1
                _same_leaves(_gathered_np(u.dt.cluster), _gathered_np(got),
                             what)
        assert scattered == 3
    finally:
        u.close()


# ---------------------------------------------------------------------------
# the serving path


def _mesh_world(A, H, store, sched):
    """tests/test_mesh.py:206-226's world: 16 nodes in four zones, 24 pods,
    every third with a soft zone spread, every fifth with hostname
    anti-affinity."""
    for n in H.make_nodes(16, zones=4):
        store.add(n)
    for i, p in enumerate(H.make_pods(24, group_labels=4)):
        if i % 3 == 0:
            H.with_spread(p, A.LABEL_ZONE, when="ScheduleAnyway")
        if i % 5 == 0:
            H.with_anti_affinity(p, A.LABEL_HOSTNAME)
        store.add(p)
    yield


def _churn_world(A, H, store, sched):
    """A term-free world drained in chained gang cycles, with pods
    arriving, a bound pod deleted and a node updated between cycles."""
    for n in H.make_nodes(16, zones=4):
        store.add(n)
    pods = H.make_pods(48, group_labels=0)
    for p in pods[:20]:
        store.add(p)
    yield
    yield
    for p in pods[20:]:
        store.add(p)
    yield
    bound = sorted((p for p in store.list("Pod") if p.spec.node_name),
                   key=lambda p: p.metadata.name)
    store.delete(bound[0])
    node = sorted(store.list("Node"), key=lambda n: n.metadata.name)[3]
    import copy
    new = copy.deepcopy(node)
    new.metadata.labels["disk"] = "ssd"
    store.update(new)
    yield


WORLDS = {"mesh_world": (_mesh_world, 32), "churn": (_churn_world, 8)}


def _drive(pkg, world, mode, mesh_shape, chain=True):
    scenario, batch = WORLDS[world]
    views, sched = drive(pkg, scenario, max_cycles=12, mode=mode,
                         backend="lax", batch=batch, mesh_shape=mesh_shape,
                         chain_cycles=chain)
    return views, list(getattr(sched, "cluster_sources", []))


def _jax_drive(world, mode, mesh_shape, chain=True):
    _fresh_jits()
    return _drive(packages()[0], world, mode, mesh_shape, chain)[0]


@pytest.mark.parametrize("mode", ["sequential", "gang"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_serving_mesh_equals_the_jax_mesh(shape, mode, jax_proc):
    """tests/test_mesh.py's serving contract through both schedulers: the
    port with mesh_shape equals the JAX scheduler with the same mesh and
    the port without one (the mesh is a performance knob, never a
    semantics knob)."""
    want = jax_proc.submit(_jax_drive, "mesh_world", mode, shape).result()
    tp = packages()[1]
    got, _ = _drive(tp, "mesh_world", mode, shape)
    single, _ = _drive(tp, "mesh_world", mode, None)
    assert any(o[1] for v in want for o in v["outcomes"])
    assert got == want
    assert single == got


@pytest.mark.parametrize("chain", [True, False])
def test_chained_churn_drain_on_a_2x2_mesh(chain, jax_proc4):
    """Chained (or delta-refreshed) gang cycles with events between them
    at (2, 2): the tiled auction over the chained or refreshed resident,
    equal to the JAX scheduler with the same mesh (whose resident is
    sharded) and to the port without one."""
    want = jax_proc4.submit(_jax_drive, "churn", "gang", (2, 2),
                            chain).result()
    tp = packages()[1]
    got, src = _drive(tp, "churn", "gang", (2, 2), chain)
    single, src1 = _drive(tp, "churn", "gang", None, chain)
    assert got == want
    assert single == got and src == src1
    assert ("chain" in src) == chain
    assert chain or "delta" in src
    assert len(got) >= 4


def test_mesh_never_falls_back_to_the_cpu():
    """CUDA asked for (or defaulted to) on a box without a card raises:
    the mesh does not fall back to CPU shards."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    for devices in ("cuda", None):
        with pytest.raises(RuntimeError):
            tmesh.make_mesh((1, 2), devices)
    with pytest.raises(RuntimeError):
        tmesh.make_mesh((1, 2), ["cuda:0", "cuda:1"])
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.scheduler import Scheduler
    with pytest.raises(RuntimeError):
        Scheduler(ClusterStore(), config=KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()], mesh_shape=(2, 2)))


def test_cuda_shards_count_from_the_scheduler_card(monkeypatch):
    """On CUDA, shard k sits on cuda:((index + k) mod device_count), so
    the controller, shard (0, 0), is the scheduler's own card (devices
    only: nothing is allocated)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    m = tmesh.make_mesh((2, 2), "cuda:1")
    assert [str(d) for row in m.devices for d in row] == [
        "cuda:1", "cuda:2", "cuda:3", "cuda:0"]
    assert m.controller == torch.device("cuda", 1) and m.spread
    m = tmesh.make_mesh((1, 2), "cuda")
    assert m.controller == torch.device("cuda", 2)
    assert str(m.devices[0][1]) == "cuda:3"


def test_mesh_layout_round_trips():
    """shard_cluster / shard_batch / replicate and gather are inverses,
    equal and ceil-sized blocks alike, and shards sharing a device share
    their whole leaves."""
    jcl, jb, cfg, _ = build_jax(2, 12, 40)
    tcl, tb, _ = carry(jcl, jb)
    for shape in ((1, 1), (2, 2), (3, 1), (1, 3)):
        mesh = tmesh.make_mesh(shape, "cpu")
        for value, lay in ((tcl, tmesh.shard_cluster), (tb, tmesh.shard_batch),
                           (tcl, tmesh.replicate)):
            sharded = lay(value, mesh)
            assert lay(sharded, mesh) is sharded or lay is tmesh.replicate
            back = tmesh.gather(sharded)
            for a, b in zip(_gathered_np(value), _gathered_np(back)):
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
        s = tmesh.shard_cluster(tcl, mesh)
        assert s.shards[-1][-1].filter_terms.valid is \
            s.shards[0][0].filter_terms.valid
        assert not mesh.spread
    assert tmesh.blocks(10, 4) == [slice(0, 3), slice(3, 6), slice(6, 9),
                                   slice(9, 10)]
