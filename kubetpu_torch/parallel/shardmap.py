"""The mesh's programs: the tiled gang auction, the replicated surfaces and
the pre-sharded delta scatter.

The counterpart of kubetpu/parallel/shardmap.py, whose explicit
``shard_map`` programs place every collective by hand.  Here one process
drives the shards of a parallel/mesh.py ``Mesh`` and each collective is an
explicit function over per-shard pieces (ops/kernels.py exact_psum,
exact_pmax, exact_pmin, crossaxis_first_index_argmax; utils/device.py
shard_copy moves a piece between shards).

Two gang surfaces, chosen per dispatch (``gang_surface``, the JAX
package's rule and order):

* ``tiled`` — term-free batches whose axes divide the mesh (the surface
  of the propose kernel).  The auction is models/gang.py's one loop,
  with the admission, the windows and the epilogue of the single-device
  run on the controller; only its propose step is tiled
  (``_tiled_step``).  The round-invariant precompute (static filters,
  raw score planes, the selectHost gumbel plane drawn whole, the propose
  bundle) runs once on the controller; shard (i, j) then owns the
  [B/mp, N/mn] tile of every plane.  Each round, per tile: feasibility
  against the committed usage of its node block, the per-pod
  normalisation statistics reduced exactly over the "nodes" axis, the
  weighted combine and the tile's tie-broken argmax, resolved across the
  row of tiles to the index torch.argmax over the whole row picks; the
  winners are gathered over the "pods" axis onto the controller.  A
  window's rows are selected by mask over the tiles.  The feasibility
  and combine are ops/propose.py's plain functions, on a tile.
* ``replicated`` — everything else (intra-batch topology, a score the
  tiles lack, soft spread constraints, an axis that does not divide):
  the single-device program (models/gang.py _gang_program, lax round)
  on the gathered inputs, once.  Its outputs are replicated in the JAX
  package, identical by construction; so are these.

The sequential replay is serial over pods by construction and runs
replicated the same way.  ``apply_cluster_delta_mesh`` scatters a
ClusterDelta shard by shard: each shard takes the rows of its own blocks,
shifted into its local row space (cut on the host, as the single-device
scatter cuts its pads).

Every output equals the single-device lax program's bit for bit: the
reductions are max/min or integer-valued f32 sums below 2**24, the
argmax folds (score, gumbel, lowest index), and the products of counts
stay float32 (TF32 off, utils/device.py).  Under a mesh the gang route
is always this lax form: the propose kernel does not run.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..models import gang, programs
from ..models.gang import GangResult
from ..models.sequential import schedule_sequential
from ..ops import kernels as K
from ..ops import propose as PK
from ..state.tensors import ClusterDelta
from ..utils.device import shard_copy
from .mesh import (AXIS_NODES, AXIS_PODS, Mesh, Sharded, gather,
                   shard_cluster)

NEG = PK.NEG

# the tiled auctions' counts, summed (diagnostics; reset by assigning
# zeros): auctions, rounds, and the cross-shard copies made to lay the
# tiles out and inside the rounds
tiled_stats: Dict[str, int] = dict(auctions=0, rounds=0, setup_copies=0,
                                   round_copies=0)


def gang_surface(cfg, intra_batch_topology: bool, batch, mesh: Mesh,
                 n_nodes: int, n_pods: int) -> str:
    """The surface this (cfg, routing, batch, mesh) dispatches on:
    "tiled" for intra_batch_topology off, every score plugin in the
    propose plane family, no soft spread constraint in the batch and both
    axes dividing the mesh; else "replicated".  The soft-spread check of
    a batch on the card costs one read, as schedule_gang's routing of a
    pallas request reads it."""
    if intra_batch_topology:
        return "replicated"
    for name, _ in cfg.scores:
        if name not in PK.SUPPORTED_SCORES:
            return "replicated"
    sv = getattr(getattr(batch, "spread_soft", None), "valid", None)
    if sv is not None and bool(sv.any()):
        return "replicated"
    if n_pods % mesh.shape[AXIS_PODS] or n_nodes % mesh.shape[AXIS_NODES]:
        return "replicated"
    return "tiled"


# --------------------------------------------------------------------------
# gang


def schedule_gang_mesh(cluster, batch, cfg, rng, mesh: Mesh,
                       host_ok=None, intra_batch_topology: bool = True,
                       score_bias=None,
                       residual_window: int = 512) -> GangResult:
    """Gang auction over the mesh.  cluster and batch: whole or Sharded
    (parallel/mesh.py); every output lands whole on the controller.  The
    auction always searches every node (percentage_of_nodes_to_score is
    normalised to 100, as the JAX entry normalises it)."""
    if cfg.percentage_of_nodes_to_score != 100:
        cfg = cfg._replace(percentage_of_nodes_to_score=100)
    dev = mesh.controller
    cluster = gather(cluster, dev)
    batch = gather(batch, dev)
    rng = rng.to(dev)
    host_ok = None if host_ok is None else host_ok.to(dev)
    score_bias = None if score_bias is None else score_bias.to(dev)
    surface = gang_surface(cfg, intra_batch_topology, batch, mesh,
                           int(cluster.allocatable.shape[0]),
                           int(batch.valid.shape[0]))
    step = (functools.partial(_tiled_step, mesh=mesh)
            if surface == "tiled" else None)
    return gang._gang_program(cluster, batch, cfg, rng, host_ok=host_ok,
                              intra_batch_topology=intra_batch_topology,
                              residual_window=residual_window,
                              score_bias=score_bias, kernel_backend="lax",
                              propose_step=step)


def _to_tile(x, mesh: Mesh, i: int, j: int):
    """x, held on the controller, for tile (i, j): a cross-shard copy
    for every tile but the controller's own (0, 0)."""
    if (i, j) == (0, 0):
        return x
    return shard_copy(x, mesh.device(i, j))


def _rows(x, i, n, m):
    """Block i of m of x's dim 0 (length n)."""
    s = n // m
    return x[i * s:(i + 1) * s]


def _tiled_step(bundle, mesh: Mesh):
    """The tiled round (module docstring) as models/gang.py's propose
    step: lays ``bundle`` out as tiles once, then each call proposes for
    the window rows ``rows`` over every tile and returns the rows'
    (prop, act, best), and their whole feasibility when ``first``.  A
    window's rows are selected by mask over the tiles (the other pods
    are not live), as the JAX program selects them."""
    L = bundle["layout"]
    gplane = L.planes.index("gumbel")
    B, N = bundle["mask"].shape
    dev = bundle["mask"].device
    mp, mn = mesh.shape[AXIS_PODS], mesh.shape[AXIS_NODES]
    Bl, Nl = B // mp, N // mn
    grid = [(i, j) for i in range(mp) for j in range(mn)]
    copies0 = shard_copy.copies
    tiles = {}
    for i, j in grid:
        ps = slice(i * Bl, (i + 1) * Bl)
        ns = slice(j * Nl, (j + 1) * Nl)
        t = dict(planes=bundle["planes"][:, ps, ns],
                 mask=bundle["mask"][ps, ns], allocT=bundle["allocT"][:, ns],
                 zid=bundle["zid"][ns], breq=bundle["breq"][ps],
                 bnz=bundle["bnz"][ps], bports=bundle["bports"][ps],
                 ipa_any=bundle["ipa_any"][ps], skip=bundle["skip"][ps])
        t = {k: _to_tile(v, mesh, i, j) for k, v in t.items()}
        t["n_zones"] = bundle["n_zones"]
        tiles[i, j] = t
    tiled_stats["auctions"] += 1
    tiled_stats["setup_copies"] += shard_copy.copies - copies0

    def node_reduce(parts_by_tile, fold):
        """One node-axis collective per row of tiles."""
        out = {}
        for i in range(mp):
            red = fold([parts_by_tile[i, j] for j in range(mn)])
            for j in range(mn):
                out[i, j] = red[j]
        return out

    def pods_gather(per_row):
        """The pods-axis all-gather onto the controller: row i's value
        (replicated over its tiles) from tile (i, 0), in row order."""
        return torch.cat([per_row[0, 0]]
                         + [shard_copy(per_row[i, 0], dev)
                            for i in range(1, mp)])

    def step(rows, live_w, req, nz, ports_used, first):
        copies0 = shard_copy.copies
        rows = rows.long()
        live = gang._set_rows(torch.zeros((B,), dtype=torch.bool,
                                          device=dev),
                              rows.clamp(max=B), live_w)
        f, st = {}, {}
        for i, j in grid:
            t = tiles[i, j]
            t["live"] = _to_tile(_rows(live, i, B, mp), mesh, i, j)
            t["nz"] = _to_tile(_rows(nz, j, N, mn), mesh, i, j)
            f[i, j] = PK._feasible(t, L, t["live"],
                                   _to_tile(_rows(req, j, N, mn), mesh, i, j),
                                   _to_tile(_rows(ports_used, j, N, mn),
                                            mesh, i, j))
            st[i, j] = PK.row_stats(t, L, f[i, j])
        # the normalisation statistics, exact over the node axis
        for key in st[0, 0]:
            fold = (K.exact_pmin if key in PK.ROW_STAT_MIN
                    else K.exact_psum if key in PK.ROW_STAT_SUM
                    else K.exact_pmax)
            red = node_reduce({ij: st[ij][key] for ij in grid}, fold)
            for ij in grid:
                st[ij][key] = red[ij]
        act = node_reduce({ij: f[ij].any(dim=1) for ij in grid},
                          K.exact_pmax)
        tb, th, ta = {}, {}, {}
        for i, j in grid:
            t = tiles[i, j]
            total = PK._combine(t, L, f[i, j], t["nz"], st[i, j])
            tb[i, j], th[i, j], ta[i, j] = K.gumbel_tiebreak_argmax(
                total, f[i, j], t["planes"][gplane], j * Nl, NEG)
        best, gidx = {}, {}
        for i in range(mp):
            b, g = K.crossaxis_first_index_argmax(
                [tb[i, j] for j in range(mn)], [th[i, j] for j in range(mn)],
                [ta[i, j] for j in range(mn)], NEG)
            for j in range(mn):
                best[i, j], gidx[i, j] = b[j], g[j]
        prop = pods_gather({ij: torch.where(act[ij], gidx[ij],
                                            torch.full_like(gidx[ij], N))
                            for ij in grid})
        active = pods_gather(act)
        bestg = pods_gather(best)
        feas = None
        if first:
            feas = torch.cat([torch.cat([_from_tile(f[i, j], dev, i, j)
                                         for j in range(mn)], dim=1)
                              for i in range(mp)])
        tiled_stats["rounds"] += 1
        tiled_stats["round_copies"] += shard_copy.copies - copies0
        # the window's rows of the whole-batch outputs
        rsafe = rows.clamp(0, B - 1)
        act_w = active[rsafe] & live_w
        prop_w = torch.where(act_w, prop[rsafe], torch.full_like(prop[rsafe],
                                                                  N))
        return prop_w, act_w, bestg[rsafe], feas
    return step


def _from_tile(x, dev, i: int, j: int):
    """Tile (i, j)'s x on the controller ``dev``."""
    return x if (i, j) == (0, 0) else shard_copy(x, dev)


# --------------------------------------------------------------------------
# sequential


def schedule_sequential_mesh(cluster, batch, cfg, rng, mesh: Mesh,
                             hard_pod_affinity_weight: float = 1.0,
                             host_ok=None, start_index=0, score_bias=None):
    """Sequential replay over the mesh: the serial scan, replicated — the
    single-device program on the gathered inputs, once, on the
    controller."""
    dev = mesh.controller
    return schedule_sequential(
        gather(cluster, dev), gather(batch, dev), cfg, rng.to(dev),
        hard_pod_affinity_weight=hard_pod_affinity_weight,
        host_ok=None if host_ok is None else host_ok.to(dev),
        start_index=start_index,
        score_bias=None if score_bias is None else score_bias.to(dev))


# --------------------------------------------------------------------------
# delta scatter


def _local_delta(delta: ClusterDelta, nrows: slice, prows: slice):
    """The rows of ``delta`` inside the node block ``nrows`` and the pod
    block ``prows``, shifted into the block's local row space; pads and
    other shards' rows are cut."""
    nr = delta.node_rows.astype(np.int64)
    pr = delta.pod_rows.astype(np.int64)
    nk = (nr >= nrows.start) & (nr < nrows.stop)
    pk = (pr >= prows.start) & (pr < prows.stop)
    upd = dict(node_rows=(nr[nk] - nrows.start).astype(np.int32),
               pod_rows=(pr[pk] - prows.start).astype(np.int32))
    for _, f in programs._NODE_DELTA:
        upd[f] = getattr(delta, f)[nk]
    for _, f in programs._POD_DELTA:
        upd[f] = getattr(delta, f)[pk]
    return delta._replace(**upd)


def apply_cluster_delta_mesh(cluster, delta: ClusterDelta, mesh: Mesh,
                             donate: bool = True) -> Sharded:
    """Pre-sharded resident scatter: each shard scatters the rows of its
    own node and pod blocks (programs.apply_cluster_delta on the shard's
    local delta), so no shard re-materialises the whole tensors.  When an
    axis does not divide the mesh, the cluster is gathered, scattered
    whole and laid out again.  Shards sharing a device share their
    blocks; the shared rows are then written once per shard, with the
    same values."""
    cluster = shard_cluster(cluster, mesh)
    mp, mn = mesh.shape[AXIS_PODS], mesh.shape[AXIS_NODES]
    n_nodes = cluster.sizes.allocatable
    n_pods = cluster.sizes.pod_valid
    if n_nodes % mn or n_pods % mp:
        whole = programs.apply_cluster_delta(gather(cluster), delta,
                                             donate=True)
        return shard_cluster(whole, mesh)
    nl, pl = n_nodes // mn, n_pods // mp
    shards = tuple(
        tuple(programs.apply_cluster_delta(
            cluster.shards[i][j],
            _local_delta(delta, slice(j * nl, (j + 1) * nl),
                         slice(i * pl, (i + 1) * pl)), donate=donate)
              for j in range(mn))
        for i in range(mp))
    return cluster._replace(shards=shards)
