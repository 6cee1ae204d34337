"""The device mesh: a (pods, nodes) grid of shards driven by one process.

The counterpart of kubetpu/parallel/mesh.py.  The reference scales one
scheduling cycle with 16 chunked goroutines over the node list
(pkg/scheduler/internal/parallelize/parallelism.go:26-43).  The JAX
package shards its dense tensors over a ``jax.sharding.Mesh`` with two
axes, "pods" (the pending batch B and the existing-pod axis P) and
"nodes" (the node axis N).  Here a ``Mesh`` is a grid of ``torch.device``
entries, one per shard; a device may appear more than once, so one card
runs every shard of a (2, 2) mesh.  One process holds the whole mesh:
shards hold their blocks as tensors on their devices, and the cross-shard
steps are explicit functions (ops/kernels.py exact_psum / exact_pmax /
exact_pmin, ``gather``) that copy pieces between shards with
utils/device.shard_copy.  There is no process per shard: the scheduler's
host side (cache, queue, binders, store) stays one process, as in the JAX
package.

Layout (``shard_cluster``): shard (i, j) holds node block j of every
node-axis field, pod block i of every existing-pod field and the rest of
the cluster whole.  ``shard_batch`` splits each batch leaf's dim 0 over
the pods axis where it divides and keeps the others whole.  Blocks are
contiguous; an axis that does not divide takes ceil-sized blocks, the
last ones shorter.  ``gather`` is the inverse of both: the whole tensors
on the mesh's controller device (shard (0, 0)'s).

Shard devices follow the scheduler's device (``make_mesh``): on the CPU
every shard is the CPU; on CUDA shard k runs on cuda:((index + k) mod
device_count), counted from the scheduler's card.  There is no fallback: CUDA asked for and absent raises.
The JAX package's ``partitioner="gspmd"`` lowering, ``ambient_mesh`` and
its jit mesh-key registry have no counterpart (torch has no SPMD
partitioner and no traced statics).

The entry points (``sharded_*``) take whole or sharded inputs and route
to parallel/shardmap.py; their outputs equal the single-device programs'
bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models import programs
from ..state.tensors import ClusterTensors
from ..utils.device import resolve_device, shard_copy

AXIS_PODS = "pods"
AXIS_NODES = "nodes"

# ClusterTensors fields whose leading axis is the node axis N.
NODE_AXIS_FIELDS = frozenset({
    "allocatable", "requested", "nonzero_requested", "node_valid",
    "unschedulable", "kv", "keymask", "num", "topo_pair", "taints", "ports",
    "images", "avoid_hot", "zone_hot",
})
# ClusterTensors fields whose leading axis is the existing-pods axis P.
POD_AXIS_FIELDS = frozenset({
    "pod_kv", "pod_key", "pod_ns_hot", "pod_node", "pod_valid",
    "pod_terminating",
})


class Mesh:
    """A (pods, nodes) grid of shard devices.  ``shape`` maps each axis
    name to its size, as a jax Mesh's does; ``controller`` is shard
    (0, 0)'s device, where gathered tensors and the replicated steps
    live."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        mp, mn = len(self.devices), len(self.devices[0])
        if mp < 1 or mn < 1 or any(len(r) != mn for r in self.devices):
            raise ValueError("mesh devices must form a non-empty grid")
        self.shape = {AXIS_PODS: mp, AXIS_NODES: mn}

    @property
    def controller(self) -> torch.device:
        return self.devices[0][0]

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    @property
    def spread(self) -> bool:
        """True when the shards sit on more than one device."""
        return len({d for row in self.devices for d in row}) > 1

    def __repr__(self):
        return "Mesh(%s, %s)" % ((self.shape[AXIS_PODS],
                                  self.shape[AXIS_NODES]),
                                 [str(d) for row in self.devices
                                  for d in row])


def make_mesh(shape: Optional[Tuple[int, int]] = None, devices=None) -> Mesh:
    """Build a (pods, nodes) mesh.  ``devices``: a list of shard devices
    (row-major), or one device (a torch.device or "cpu" / "cuda"; None is
    the port's default, the card) from which the shards follow: on the
    CPU every shard is the CPU, on CUDA shard k is cuda:((index + k) mod
    device_count), so shard (0, 0), the controller, is the device's own
    card.  The default shape puts every shard on the node axis:
    (1, device_count) on CUDA, (1, 1) on the CPU.  Raises when CUDA is
    asked for and absent; never falls back to the CPU."""
    if devices is None or isinstance(devices, (str, torch.device)):
        base = resolve_device(devices)
        count = torch.cuda.device_count() if base.type == "cuda" else 1
        if shape is None:
            shape = (1, count)
        n = shape[0] * shape[1]
        if base.type == "cuda":
            first = (base.index if base.index is not None
                     else torch.cuda.current_device())
            devs = [torch.device("cuda", (first + k) % count)
                    for k in range(n)]
        else:
            devs = [base] * n
    else:
        devs = [torch.device(d) for d in devices]
        for d in devs:
            resolve_device(d)
        if shape is None:
            shape = (1, len(devs))
    mp, mn = int(shape[0]), int(shape[1])
    if mp < 1 or mn < 1 or mp * mn != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devs)} devices")
    return Mesh([devs[i * mn:(i + 1) * mn] for i in range(mp)])


def blocks(n: int, m: int):
    """The m contiguous blocks of an axis of length n, as slices:
    equal when m divides n, else ceil-sized with the last ones shorter."""
    c = -(-n // m) if n else 0
    return [slice(min(k * c, n), min((k + 1) * c, n)) for k in range(m)]


def _tree_map(fn, *trees):
    """fn over the tensor leaves of NamedTuples of the same structure
    (None leaves stay None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*[_tree_map(fn, *[t[k] for t in trees])
                          for k in range(len(t0))])
    return fn(*trees)


class Sharded(NamedTuple):
    """A ClusterTensors or PodBatch laid out over ``mesh``: ``shards[i][j]``
    is shard (i, j)'s value, and ``axes`` the same structure with each
    leaf's split axis (AXIS_PODS, AXIS_NODES, or "" for a whole leaf).
    ``sizes`` holds each split leaf's global dim 0."""
    mesh: Mesh
    shards: Tuple[Tuple[Any, ...], ...]
    axes: Any
    sizes: Any


def _layout(value, axes, mesh: Mesh) -> Sharded:
    mp, mn = mesh.shape[AXIS_PODS], mesh.shape[AXIS_NODES]
    sizes = _tree_map(lambda x: int(x.shape[0]), value)

    def piece(i, j):
        dev = mesh.device(i, j)

        def cut(x, ax):
            if ax == AXIS_NODES:
                x = x[blocks(x.shape[0], mn)[j]]
            elif ax == AXIS_PODS:
                x = x[blocks(x.shape[0], mp)[i]]
            return x.to(dev)
        return _tree_map(cut, value, axes)
    return Sharded(mesh, tuple(tuple(piece(i, j) for j in range(mn))
                               for i in range(mp)), axes, sizes)


def _cluster_axes(cluster: ClusterTensors, shard_existing_pods: bool):
    out = {}
    for f in ClusterTensors._fields:
        if f in NODE_AXIS_FIELDS:
            ax = AXIS_NODES
        elif f in POD_AXIS_FIELDS and shard_existing_pods:
            ax = AXIS_PODS
        else:
            ax = ""
        out[f] = _tree_map(lambda _x, a=ax: a, getattr(cluster, f))
    return ClusterTensors(**out)


def shard_cluster(cluster, mesh: Mesh,
                  shard_existing_pods: bool = True) -> Sharded:
    """Lay a whole ClusterTensors out over the mesh (a Sharded one on
    this mesh passes through): node-axis fields over "nodes", existing-pod
    fields over "pods", the rest whole on every shard."""
    if isinstance(cluster, Sharded) and cluster.mesh is mesh:
        return cluster
    cluster = gather(cluster)
    return _layout(cluster, _cluster_axes(cluster, shard_existing_pods),
                   mesh)


def shard_batch(batch, mesh: Mesh) -> Sharded:
    """Split every PodBatch leaf's dim 0 over the "pods" axis where it
    divides (every batch leaf leads with B or a flattened B*T axis);
    other leaves ride whole.  A Sharded batch on this mesh passes
    through."""
    if isinstance(batch, Sharded) and batch.mesh is mesh:
        return batch
    batch = gather(batch)
    mp = mesh.shape[AXIS_PODS]
    axes = _tree_map(lambda x: (AXIS_PODS if x.ndim >= 1
                                and x.shape[0] % mp == 0 else ""), batch)
    return _layout(batch, axes, mesh)


def replicate(tree, mesh: Mesh) -> Sharded:
    """Every leaf whole on every shard."""
    if isinstance(tree, Sharded):
        tree = gather(tree)
    return _layout(tree, _tree_map(lambda _x: "", tree), mesh)


def gather(x, device=None):
    """The whole value of a Sharded cluster or batch, as fresh tensors on
    ``device`` (default: the mesh's controller): split leaves are
    concatenated from their blocks in shard order, whole leaves taken
    from shard (0, 0).  A value that is not Sharded passes through
    (moved to ``device`` when one is given)."""
    if not isinstance(x, Sharded):
        if device is None or x is None:
            return x
        return _tree_map(lambda t: t.to(device), x)
    mesh = x.mesh
    dev = torch.device(device) if device is not None else mesh.controller
    mp, mn = mesh.shape[AXIS_PODS], mesh.shape[AXIS_NODES]
    trees = [x.shards[i][j] for i in range(mp) for j in range(mn)]

    def join(ax, size, *leaves):
        grid = [leaves[i * mn:(i + 1) * mn] for i in range(mp)]
        if ax == AXIS_NODES:
            parts = [grid[0][j] for j in range(mn)]
        elif ax == AXIS_PODS:
            parts = [grid[i][0] for i in range(mp)]
        else:
            return shard_copy(grid[0][0], dev).clone()
        out = torch.cat([shard_copy(p, dev) for p in parts])
        assert out.shape[0] == size
        return out
    return _tree_map(join, x.axes, x.sizes, *trees)


# ---------------------------------------------------------------------------
# entry points (the JAX package's sharded_*; each lowers through
# parallel/shardmap.py)


def sharded_apply_cluster_delta(cluster, delta, mesh: Mesh,
                                donate: bool = True) -> Sharded:
    """Apply a ClusterDelta to the SHARDED resident cluster, shard-locally
    (shardmap.apply_cluster_delta_mesh): each shard scatters only the rows
    it owns, and the result stays laid out over the mesh."""
    from . import shardmap
    return shardmap.apply_cluster_delta_mesh(cluster, delta, mesh,
                                             donate=donate)


def sharded_schedule_batch(cluster, batch, cfg: programs.ProgramConfig, rng,
                           mesh: Mesh):
    """One-shot batch scheduling over the mesh: the batch program on the
    gathered inputs, once, on the controller (its outputs are replicated
    in the JAX package)."""
    return programs.schedule_batch(gather(cluster), gather(batch), cfg,
                                   rng.to(mesh.controller))


def sharded_filter_and_score(cluster, batch, cfg: programs.ProgramConfig,
                             mesh: Mesh, host_ok=None):
    """filter_and_score over the mesh (the extender path's device half):
    the program on the gathered inputs, once, on the controller."""
    return programs.filter_and_score(
        gather(cluster), gather(batch), cfg,
        None if host_ok is None else host_ok.to(mesh.controller))


def sharded_schedule_gang(cluster, batch, cfg: programs.ProgramConfig, rng,
                          mesh: Mesh, host_ok=None,
                          intra_batch_topology: bool = True,
                          score_bias=None, residual_window: int = 512):
    """Gang auction over the mesh (shardmap.schedule_gang_mesh): the tiled
    auction for term-free batches whose axes divide, else the replicated
    single-device program."""
    from . import shardmap
    return shardmap.schedule_gang_mesh(
        cluster, batch, cfg, rng, mesh, host_ok=host_ok,
        intra_batch_topology=intra_batch_topology, score_bias=score_bias,
        residual_window=residual_window)


def sharded_schedule_sequential(cluster, batch, cfg: programs.ProgramConfig,
                                rng, mesh: Mesh,
                                hard_pod_affinity_weight: float = 1.0,
                                host_ok=None, start_index=0,
                                score_bias=None):
    """Sequential replay over the mesh (shardmap.schedule_sequential_mesh:
    the serial scan, replicated)."""
    from . import shardmap
    return shardmap.schedule_sequential_mesh(
        cluster, batch, cfg, rng, mesh,
        hard_pod_affinity_weight=hard_pod_affinity_weight,
        host_ok=host_ok, start_index=start_index, score_bias=score_bias)
