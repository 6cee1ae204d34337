"""The fused propose step of one auction round: feasibility -> weighted
score combine -> gumbel tie-broken argmax, for W live pods x N nodes.

Replaces the TPU kernel ``kubetpu/ops/pallas_kernels.py:511 propose``
(body ``_make_kernel``, ``pallas_call`` at :555).  Both implementations
take the round-invariant bundle of the whole batch ([S, B, N] planes,
[B, N] mask, [B, .] row vectors) and a ``rows`` vector naming the W
window rows of this step, and share one signature:

* ``propose_plain`` — plain PyTorch over whole [W, N] tensors (it gathers
  the rows); the CPU path, and the yardstick the CUDA kernel is held
  against on the card;
* the CUDA kernel in ``csrc/propose.cu`` (built by ``_build.py``) — one
  thread block per window row, which reads its bundle row by index,
  stages the row's statistics planes in shared memory with bulk
  asynchronous copies, and makes one feasibility pass, one statistics
  pass and one combine-and-select pass over the nodes.

``propose`` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raise).  There is no
fallback from one to the other.

Bit contract (what both versions reproduce, and what the JAX package's
lax round computes): for every row, prop/act/best equal round_step's
propose half.  Every reduction is a max/min, an integer-valued f32 sum
below 2**24, or the lexicographic (score desc, gumbel desc, index asc)
selection, all exact in any order; every elementwise formula keeps the
reference's op order with correctly rounded divisions and no fused
multiply-adds (see ops/kernels.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from . import kernels as K
from ..models.programs import DEFAULT_SCORE_PLUGINS
from ..state.tensors import CH_CPU, CH_MEM

NEG = float(-2 ** 62)
BIG = float(2 ** 62)

# score plugins whose raw matrix is round-invariant under
# intra_batch_topology=False and enters the kernel as a plane
PLANE_OF = {
    "ImageLocality": "raw:ImageLocality",
    "NodeAffinity": "raw:NodeAffinity",
    "NodePreferAvoidPods": "raw:NodePreferAvoidPods",
    "TaintToleration": "raw:TaintToleration",
    "InterPodAffinity": "ipa_raw",
    "DefaultPodTopologySpread": "dps_raw",
}

# score codes shared with csrc/propose.cu (enum ScoreCode)
SCORE_CODES = {
    "NodeResourcesBalancedAllocation": 0,
    "NodeResourcesLeastAllocated": 1,
    "NodeResourcesMostAllocated": 2,
    "ImageLocality": 3,
    "NodePreferAvoidPods": 4,
    "NodeAffinity": 5,
    "TaintToleration": 6,
    "InterPodAffinity": 7,
    "PodTopologySpread": 8,
    "DefaultPodTopologySpread": 9,
}
SUPPORTED_SCORES = frozenset(SCORE_CODES)
MAX_SCORES = 16  # descriptor capacity (csrc/propose.cu PROPOSE_MAX_SCORES)
# models/programs.py DEFAULT_SCORE_PLUGINS as layout_for records it: the
# kernel's FAMILY_DEFAULT specialisation bakes in this order and weights
DEFAULT_FAMILY = tuple((n, float(w)) for n, w in DEFAULT_SCORE_PLUGINS)


def plane_order(cfg, has_bias: bool) -> Tuple[str, ...]:
    """Plane layout of the stacked [S, B, N] input: score raws in
    cfg.scores order, then the optional host score bias, then the
    selectHost gumbel plane (always last)."""
    names = []
    for name, _ in cfg.scores:
        key = PLANE_OF.get(name)
        if key is not None and key not in names:
            names.append(key)
    if has_bias:
        names.append("bias")
    names.append("gumbel")
    return tuple(names)


def node_tables(alloc: torch.Tensor, zone: torch.Tensor
                ) -> Dict[str, object]:
    """The bundle's node tables: allocT [R, N], allocatable channel-major
    so that a warp of the CUDA kernel, whose threads visit consecutive
    nodes, reads consecutive addresses; zid [N] int32, each node's zone
    (-1: none) from the zone one-hot [N, Z], which has at most one 1 per
    node (state/tensors.py); and n_zones, Z (1 when there is no zone key,
    as the JAX package's one all-zero column)."""
    has = (zone > 0).any(dim=1) if zone.shape[1] else torch.zeros(
        (zone.shape[0],), dtype=torch.bool, device=zone.device)
    first = (zone.argmax(dim=1) if zone.shape[1]
             else torch.zeros((zone.shape[0],), dtype=torch.int64,
                              device=zone.device))
    zid = torch.where(has, first, torch.full_like(first, -1))
    return dict(allocT=alloc.T.contiguous(),
                zid=zid.to(torch.int32).contiguous(),
                n_zones=max(int(zone.shape[1]), 1))


def zone_onehot(zid: torch.Tensor, n_zones: int) -> torch.Tensor:
    """[N, Z] f32 one-hot of node_tables' zone ids (zone_hot again)."""
    z = torch.arange(n_zones, dtype=zid.dtype, device=zid.device)
    return (zid[:, None] == z[None, :]).float()


def build_bundle(cluster, batch, cfg, static_ok, ports_ok0, score_pre,
                 score_bias, gumbel) -> Dict[str, object]:
    """The round-invariant inputs of every propose step of one auction,
    over the whole batch: a step names its rows of it by index.  All
    [B, N] planes here are assignment-independent under
    intra_batch_topology=False (the pod axis is frozen during the loop)."""
    B = batch.req.shape[0]
    planes: Dict[str, torch.Tensor] = {}
    ipa_any = torch.zeros((B,), dtype=torch.bool, device=batch.req.device)
    for name, _ in cfg.scores:
        if name == "InterPodAffinity" and "ipa_raw" not in planes:
            raw, any_counts = K.interpod_score_raw(
                cluster, batch, pre=score_pre.get("interpod_score"),
                active_keys=cfg.active_keys)
            planes["ipa_raw"] = raw
            ipa_any = any_counts[:, 0]
        elif name == "DefaultPodTopologySpread" and "dps_raw" not in planes:
            planes["dps_raw"] = K.default_spread_score(
                cluster, batch, match_ns=score_pre.get("default_spread"))
        elif name in PLANE_OF and PLANE_OF[name] not in planes:
            planes[PLANE_OF[name]] = score_pre["raw:" + name]
    if score_bias is not None:
        planes["bias"] = score_bias
    planes["gumbel"] = gumbel
    order = plane_order(cfg, score_bias is not None)
    stack = torch.stack([planes[k].float() for k in order]).contiguous()
    return dict(
        planes=stack,                                   # [S, B, N] f32
        mask=(static_ok & ports_ok0).contiguous(),      # [B, N] bool
        ipa_any=ipa_any.contiguous(),                   # [B] bool
        skip=batch.spread_skip.contiguous(),            # [B] bool
        breq=batch.req.contiguous(),                    # [B, R] f32
        bnz=batch.nonzero_req.contiguous(),             # [B, 2] f32
        bports=batch.ports_hot.contiguous(),            # [B, P] f32
        layout=layout_for(cfg, score_bias is not None),
        **node_tables(cluster.allocatable, cluster.zone_hot),
    )


class Layout(NamedTuple):
    """Static score layout: which scores (in cfg.scores order), their
    weights and plane indices; passed to the CUDA kernel by value."""
    scores: Tuple[Tuple[str, float], ...]
    planes: Tuple[str, ...]
    use_fit: bool
    use_ports: bool

    @property
    def default_family(self) -> bool:
        """The default plugin family, whose combine the CUDA kernel has
        fixed at compile time (every other layout walks the scores)."""
        return self.scores == DEFAULT_FAMILY


def layout_for(cfg, has_bias: bool) -> Layout:
    unsupported = [n for n, _ in cfg.scores if n not in SUPPORTED_SCORES]
    if unsupported:
        raise NotImplementedError(
            "propose: the kernel does not serve the score plugins %s "
            "(utils/pallas_backend routes such profiles to the lax round, "
            "as the JAX package routes them)" % unsupported)
    if len(cfg.scores) > MAX_SCORES:
        raise ValueError("propose: more than %d score plugins" % MAX_SCORES)
    filters = set(cfg.filters)
    return Layout(scores=tuple((n, float(w)) for n, w in cfg.scores),
                  planes=plane_order(cfg, has_bias),
                  use_fit="NodeResourcesFit" in filters,
                  use_ports="NodePorts" in filters)


# ---------------------------------------------------------------------------
# plain PyTorch version


def _feasible(sub, L: Layout, live, req, ports_used):
    """[W, N] feasibility: static mask, live rows, NodeResourcesFit
    against the round's committed usage, no hostPort conflict."""
    f = sub["mask"] & live[:, None]
    if L.use_fit:
        f = f & K.fit_matrix(sub["allocT"].T, req, sub["breq"])
    if L.use_ports:
        f = f & ~((sub["bports"] @ ports_used.T) > 0.5)
    return f


_POD_SIDE = ("mask", "ipa_any", "skip", "breq", "bnz", "bports")


def _rows_of(bundle, rows):
    """The window's pod-side rows of the bundle, gathered (the plain
    version's stand-in for the kernel's reads by index).  Rows clamp to
    [0, B) as the JAX package's gather_bundle clamps them; the caller's
    ``live`` is False for a sentinel row, which proposes the no-op."""
    B = bundle["mask"].shape[0]
    rsafe = rows.long().clamp(0, B - 1)
    sub = dict(bundle)
    sub["planes"] = bundle["planes"][:, rsafe]
    for k in _POD_SIDE:
        sub[k] = bundle[k][rsafe]
    return sub


def _rowmax(f, x, fill):
    return torch.where(f, x, torch.full_like(x, fill)).max(dim=1).values


def propose_plain(bundle, rows, live, req, nz, ports_used):
    """One propose step for the window rows ``rows`` [W] of the bundle,
    over whole [W, N] tensors -> (prop [W] i32 in [0, N] with N = no-op,
    act [W] bool, best [W] f32)."""
    L: Layout = bundle["layout"]
    sub = _rows_of(bundle, rows)
    f = _feasible(sub, L, live, req, ports_used)
    total = _combine(sub, L, f, nz)
    best, _, arg = K.gumbel_tiebreak_argmax(
        total, f, sub["planes"][L.planes.index("gumbel")], 0, NEG)
    act = f.any(dim=1)
    prop = torch.where(act, arg, torch.full_like(arg, f.shape[1]))
    return prop, act, best


def _combine(bundle, L: Layout, f, nz):
    """[W, N] weighted total of the score plugins plus the bias plane,
    for the gathered window rows ``bundle`` with feasibility f."""
    planes = bundle["planes"]
    plane = {name: i for i, name in enumerate(L.planes)}
    W, N = f.shape
    alloc = bundle["allocT"].T
    bnz = bundle["bnz"]
    req_cpu = nz[None, :, 0] + bnz[:, 0][:, None]
    req_mem = nz[None, :, 1] + bnz[:, 1][:, None]
    alloc_cpu = alloc[None, :, CH_CPU].expand(W, N)
    alloc_mem = alloc[None, :, CH_MEM].expand(W, N)
    zone = zone_onehot(bundle["zid"], bundle["n_zones"])
    has_zone = bundle["zid"] >= 0
    zero = torch.zeros((W, N), dtype=torch.float32, device=f.device)
    full = torch.full((W, N), K.MAX_NODE_SCORE, dtype=torch.float32,
                      device=f.device)

    total = zero
    for name, weight in L.scores:
        if name == "NodeResourcesBalancedAllocation":
            s = K.balanced_formula(req_cpu, req_mem, alloc_cpu, alloc_mem)
        elif name == "NodeResourcesLeastAllocated":
            s = K._idiv(K.least_formula(req_cpu, alloc_cpu) * 1.0
                        + K.least_formula(req_mem, alloc_mem) * 1.0, 2.0)
        elif name == "NodeResourcesMostAllocated":
            s = K._idiv(K.most_formula(req_cpu, alloc_cpu) * 1.0
                        + K.most_formula(req_mem, alloc_mem) * 1.0, 2.0)
        elif name in ("ImageLocality", "NodePreferAvoidPods"):
            s = planes[plane[PLANE_OF[name]]]
        elif name == "NodeAffinity":
            raw = planes[plane["raw:NodeAffinity"]]
            max_c = torch.clamp(_rowmax(f, raw, NEG), min=0.0)[:, None]
            scaled = K._idiv(K.MAX_NODE_SCORE * raw,
                             torch.clamp(max_c, min=1.0))
            s = torch.where(max_c > 0, scaled, zero)
        elif name == "TaintToleration":
            raw = planes[plane["raw:TaintToleration"]]
            max_c = torch.clamp(_rowmax(f, raw, NEG), min=0.0)[:, None]
            scaled = K.MAX_NODE_SCORE - K._idiv(K.MAX_NODE_SCORE * raw,
                                                torch.clamp(max_c, min=1.0))
            s = torch.where(max_c > 0, scaled, full)
        elif name == "InterPodAffinity":
            raw = planes[plane["ipa_raw"]]
            max_c = torch.clamp(_rowmax(f, raw, NEG), min=0.0)[:, None]
            min_c = torch.clamp(torch.where(f, raw, torch.full_like(raw, BIG))
                                .min(dim=1).values, max=0.0)[:, None]
            diff = max_c - min_c
            norm = torch.where(diff > 0,
                               K._idiv(K.MAX_NODE_SCORE * (raw - min_c),
                                       torch.clamp(diff, min=1.0)), zero)
            s = torch.where(bundle["ipa_any"][:, None], norm, raw)
        elif name == "PodTopologySpread":
            s = torch.where(f, full, zero)
        elif name == "DefaultPodTopologySpread":
            raw = planes[plane["dps_raw"]]
            max_node = torch.clamp(_rowmax(f, raw, NEG), min=0.0)[:, None]
            f_score = torch.where(max_node > 0,
                                  K.MAX_NODE_SCORE * (max_node - raw)
                                  / torch.clamp(max_node, min=1.0), full)
            cz = torch.where(f, raw, zero) @ zone               # [W, Z]
            max_zone = torch.clamp(cz.max(dim=1).values, min=0.0)[:, None]
            nzc = cz @ zone.T
            zone_score = torch.where(max_zone > 0,
                                     K.MAX_NODE_SCORE * (max_zone - nzc)
                                     / torch.clamp(max_zone, min=1.0), full)
            with_zone = (f_score * K.ONE_MINUS_ZONE_W
                         + K.ZONE_W * zone_score)
            havez = (f & has_zone[None, :]).any(dim=1)
            out = torch.where(havez[:, None] & has_zone[None, :], with_zone,
                              f_score)
            out = torch.floor(out)
            s = torch.where(bundle["skip"][:, None], zero, out)
        else:
            raise NotImplementedError("propose: score %s" % name)
        total = total + torch.where(f, s, zero) * weight
    if "bias" in plane:
        total = total + planes[plane["bias"]]
    return total


# ---------------------------------------------------------------------------
# CUDA kernel wrapper


class _LayoutC(ctypes.Structure):
    """Mirror of struct ProposeLayout in csrc/propose.cu."""
    _fields_ = [("n_scores", ctypes.c_int),
                ("code", ctypes.c_int * MAX_SCORES),
                ("plane", ctypes.c_int * MAX_SCORES),
                ("weight", ctypes.c_float * MAX_SCORES),
                ("use_fit", ctypes.c_int),
                ("use_ports", ctypes.c_int),
                ("bias_plane", ctypes.c_int),
                ("gumbel_plane", ctypes.c_int),
                ("family", ctypes.c_int),
                ("W", ctypes.c_int), ("N", ctypes.c_int),
                ("R", ctypes.c_int), ("P", ctypes.c_int),
                ("Z", ctypes.c_int), ("S", ctypes.c_int),
                ("B", ctypes.c_int)]


def _layout_c(L: Layout, W: int, N: int, R: int, P: int, Z: int,
              B: int) -> _LayoutC:
    c = _LayoutC()
    plane = {name: i for i, name in enumerate(L.planes)}
    c.n_scores = len(L.scores)
    for i, (name, weight) in enumerate(L.scores):
        c.code[i] = SCORE_CODES[name]
        c.plane[i] = plane.get(PLANE_OF.get(name, ""), -1)
        c.weight[i] = weight
    c.use_fit = int(L.use_fit)
    c.use_ports = int(L.use_ports)
    c.bias_plane = plane.get("bias", -1)
    c.gumbel_plane = plane["gumbel"]
    c.family = int(L.default_family)
    c.W, c.N, c.R, c.P, c.Z, c.S, c.B = W, N, R, P, Z, len(L.planes), B
    return c


def staged_max_n(L: Layout, R: int, P: int, Z: int) -> int:
    """The largest N at which the CUDA kernel stages layout L's
    statistics planes in shared memory (above it, it reads them from
    device memory in both passes)."""
    from ._build import load_propose
    c = _layout_c(L, 0, 0, R, P, Z, 0)
    return int(load_propose().propose_staged_max_n(ctypes.addressof(c)))


def check_fast_div(n: int, seed: int = 0) -> int:
    """On the card: the kernel's branch-free division against __fdiv_rn
    on n seeded operand pairs; returns how many differ in any bit (or
    take the fast path outside its range).  0 is the only right answer."""
    from ._build import load_propose
    bad = torch.zeros((1,), dtype=torch.int64, device="cuda")
    rc = load_propose().propose_check_fast_div(
        n, seed, bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("fast division check failed to launch: %d" % rc)
    return int(bad.item())


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError("propose: %s is %s %s, expected %s %s"
                         % (name, x.dtype, tuple(x.shape), dtype, shape))
    if not x.is_contiguous():
        raise ValueError("propose: %s is not contiguous" % name)


def bind_propose(bundle, rows, live, req, nz, ports_used):
    """Check and stage one CUDA launch; returns (launch, (prop, act,
    best)).  ``launch()`` enqueues the kernel on the current stream and
    counts it; the staged tensors stay alive in its closure.  The kernel
    reads the bundle's rows ``rows`` itself, and the round's carries as
    the auction keeps them: no copy is made here."""
    from ._build import KernelError, load_propose
    lib = load_propose()
    L: Layout = bundle["layout"]
    planes = bundle["planes"]
    S, B, N = planes.shape
    W = rows.shape[0]
    R = bundle["breq"].shape[1]
    P = bundle["bports"].shape[1]
    Z = bundle["n_zones"]
    dev = planes.device
    f32, b8 = torch.float32, torch.bool
    args = [("planes", planes, f32, (S, B, N)),
            ("mask", bundle["mask"], b8, (B, N)),
            ("allocT", bundle["allocT"], f32, (R, N)),
            ("zid", bundle["zid"], torch.int32, (N,)),
            ("req", req, f32, (N, R)), ("nz", nz, f32, (N, 2)),
            ("ports_used", ports_used, f32, (N, P)),
            ("breq", bundle["breq"], f32, (B, R)),
            ("bnz", bundle["bnz"], f32, (B, 2)),
            ("bports", bundle["bports"], f32, (B, P)),
            ("rows", rows, torch.int64, (W,)),
            ("live", live, b8, (W,)), ("skip", bundle["skip"], b8, (B,)),
            ("ipa_any", bundle["ipa_any"], b8, (B,))]
    for name, x, dt, shape in args:
        if x.device != dev:
            raise ValueError("propose: %s is on %s, planes on %s"
                             % (name, x.device, dev))
        _check(name, x, dt, shape)
    if B == 0 and W > 0:
        raise ValueError("propose: rows index an empty bundle")
    ptrs = [x for _, x, _, _ in args]
    prop = torch.empty((W,), dtype=torch.int32, device=dev)
    best = torch.empty((W,), dtype=torch.float32, device=dev)
    act = torch.empty((W,), dtype=torch.bool, device=dev)
    layout = _layout_c(L, W, N, R, P, Z, B)
    stream = torch.cuda.current_stream(dev).cuda_stream
    argv = ([ctypes.addressof(layout)] + [x.data_ptr() for x in ptrs]
            + [prop.data_ptr(), best.data_ptr(), act.data_ptr(), stream])

    def launch():
        rc = lib.propose_launch(*argv)
        if rc != 0:
            raise KernelError("propose kernel launch failed: %s"
                              % lib.propose_error_string(rc).decode())
        propose.launches += 1

    launch.keep = (layout, ptrs)
    return launch, (prop, act, best)


def propose_cuda(bundle, rows, live, req, nz, ports_used):
    """Launch the CUDA kernel on the current stream (no sync)."""
    launch, out = bind_propose(bundle, rows, live, req, nz, ports_used)
    launch()
    return out


def propose(bundle, rows, live, req, nz, ports_used):
    """One fused propose step for the window rows ``rows`` [W] (int64,
    a sentinel >= B where ``live`` is False) of the round-invariant
    bundle -> (prop [W] i32, act [W] bool, best [W] f32).  CPU tensors
    run the plain version; CUDA tensors launch the kernel and count the
    launch in ``propose.launches``."""
    dev = bundle["planes"].device
    if dev.type == "cpu":
        return propose_plain(bundle, rows, live, req, nz, ports_used)
    if dev.type == "cuda":
        return propose_cuda(bundle, rows, live, req, nz, ports_used)
    raise ValueError("propose: unsupported device %s" % dev)


propose.launches = 0
