"""The least time one launch of the propose kernel (K1) could take on the
card, from the launch's inputs and what its data needs, and the card's
published peaks.

A frozen copy of the count the port's smoke test made (its ``bound_of``),
with the plain arithmetic it called copied beside it, so that a later
change to the program cannot move the yardstick.  Plain torch; it reads
the launch's inputs (the round-invariant bundle and the round's carries)
and imports nothing of the program.

Bytes: each live window row's mask row and row-vector entries; its plane
values only at the nodes where it is feasible (the gumbel plane only where
the row's best score ties, the DefaultPodTopologySpread plane not at all
on a spread-skip row), counted in the 32-byte sectors that hold them; the
node tables and the round's carries once, at the nodes some live row's
mask admits; rows, live and the three outputs.  Operations: 2 per
resource channel and port id at each admitted (row, node), ~40 f32
operations of the combine at each feasible one.  The bound is the larger
of bytes over HBM bandwidth and operations over the f32 rate.
"""

from __future__ import annotations

from typing import Tuple

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAX_NODE_SCORE = 100.0
NEG = float(-2 ** 62)
BIG = float(2 ** 62)
CH_CPU, CH_MEM, CH_PODS, N_FIXED = 0, 1, 3, 4
BALANCED_EPS = float(torch.tensor(1e-5, dtype=torch.float32))
ZONE_W = float(torch.tensor(2.0 / 3.0, dtype=torch.float32))
ONE_MINUS_ZONE_W = float(torch.tensor(1.0 - 2.0 / 3.0, dtype=torch.float32))
PLANE_OF = {
    "ImageLocality": "raw:ImageLocality",
    "NodeAffinity": "raw:NodeAffinity",
    "NodePreferAvoidPods": "raw:NodePreferAvoidPods",
    "TaintToleration": "raw:TaintToleration",
    "InterPodAffinity": "ipa_raw",
    "DefaultPodTopologySpread": "dps_raw",
}
POD_SIDE = ("mask", "ipa_any", "skip", "breq", "bnz", "bports")


def _idiv(a, b):
    q = torch.floor(a / b)
    r = a - q * b
    return q + (r >= b).float() - (r < 0).float()


def _safe_den(cap):
    return torch.where(cap > 0, cap, torch.ones_like(cap))


def _least(req, cap):
    s = _idiv((cap - req) * MAX_NODE_SCORE, _safe_den(cap))
    return torch.where((cap <= 0) | (req > cap), torch.zeros_like(s), s)


def _most(req, cap):
    s = _idiv(req * MAX_NODE_SCORE, _safe_den(cap))
    return torch.where((cap <= 0) | (req > cap), torch.zeros_like(s), s)


def _balanced(req_cpu, req_mem, alloc_cpu, alloc_mem):
    one = torch.ones((), device=req_cpu.device)
    cf = torch.where(alloc_cpu > 0, req_cpu / _safe_den(alloc_cpu), one)
    mf = torch.where(alloc_mem > 0, req_mem / _safe_den(alloc_mem), one)
    score = torch.floor((1.0 - torch.abs(cf - mf)) * MAX_NODE_SCORE
                        + BALANCED_EPS)
    return torch.where((cf >= 1.0) | (mf >= 1.0), torch.zeros_like(score),
                       score)


def _fit(alloc, used, req):
    free_ok = alloc[None, :, :] >= req[:, None, :] + used[None, :, :]
    ch = torch.arange(alloc.shape[1], device=alloc.device)[None, None, :]
    is_fixed = (ch < N_FIXED) & (ch != CH_PODS)
    is_pods = ch == CH_PODS
    check = is_fixed | (req[:, None, :] > 0)
    res_ok = (free_ok | ~check | is_pods).all(dim=-1)
    nonpods = torch.where(is_pods[0], torch.zeros_like(req), req)
    zero_req = (nonpods == 0).all(dim=-1)
    return free_ok[:, :, CH_PODS] & (zero_req[:, None] | res_ok)


def _rows_of(bundle, rows):
    B = bundle["mask"].shape[0]
    rsafe = rows.long().clamp(0, B - 1)
    sub = dict(bundle)
    sub["planes"] = bundle["planes"][:, rsafe]
    for k in POD_SIDE:
        sub[k] = bundle[k][rsafe]
    return sub


def _feasible(sub, L, live, req, ports_used):
    f = sub["mask"] & live[:, None]
    if L.use_fit:
        f = f & _fit(sub["allocT"].T, req, sub["breq"])
    if L.use_ports:
        f = f & ~((sub["bports"] @ ports_used.T) > 0.5)
    return f


def _rowmax(f, x, fill):
    return torch.where(f, x, torch.full_like(x, fill)).max(dim=1).values


def _zone_onehot(zid, n_zones):
    z = torch.arange(n_zones, dtype=zid.dtype, device=zid.device)
    return (zid[:, None] == z[None, :]).float()


def _combine(sub, L, f, nz):
    planes = sub["planes"]
    plane = {name: i for i, name in enumerate(L.planes)}
    names = {n for n, _ in L.scores}
    st = {}
    for name, key in (("NodeAffinity", "max_na"),
                      ("TaintToleration", "max_tt"),
                      ("InterPodAffinity", "max_ip"),
                      ("DefaultPodTopologySpread", "max_dps")):
        if name in names:
            st[key] = _rowmax(f, planes[plane[PLANE_OF[name]]], NEG)
    if "InterPodAffinity" in names:
        raw = planes[plane["ipa_raw"]]
        st["min_ip"] = torch.where(f, raw, torch.full_like(raw, BIG)) \
            .min(dim=1).values
    zone = _zone_onehot(sub["zid"], sub["n_zones"])
    has_zone = sub["zid"] >= 0
    if "DefaultPodTopologySpread" in names:
        raw = planes[plane["dps_raw"]]
        st["havez"] = (f & has_zone[None, :]).any(dim=1)
        st["czone"] = torch.where(f, raw, torch.zeros_like(raw)) @ zone
    W, N = f.shape
    alloc = sub["allocT"].T
    bnz = sub["bnz"]
    req_cpu = nz[None, :, 0] + bnz[:, 0][:, None]
    req_mem = nz[None, :, 1] + bnz[:, 1][:, None]
    alloc_cpu = alloc[None, :, CH_CPU].expand(W, N)
    alloc_mem = alloc[None, :, CH_MEM].expand(W, N)
    zero = torch.zeros((W, N), dtype=torch.float32, device=f.device)
    full = torch.full((W, N), MAX_NODE_SCORE, dtype=torch.float32,
                      device=f.device)
    total = zero
    for name, weight in L.scores:
        if name == "NodeResourcesBalancedAllocation":
            s = _balanced(req_cpu, req_mem, alloc_cpu, alloc_mem)
        elif name == "NodeResourcesLeastAllocated":
            s = _idiv(_least(req_cpu, alloc_cpu) + _least(req_mem, alloc_mem),
                      2.0)
        elif name == "NodeResourcesMostAllocated":
            s = _idiv(_most(req_cpu, alloc_cpu) + _most(req_mem, alloc_mem),
                      2.0)
        elif name in ("ImageLocality", "NodePreferAvoidPods"):
            s = planes[plane[PLANE_OF[name]]]
        elif name == "NodeAffinity":
            raw = planes[plane["raw:NodeAffinity"]]
            max_c = torch.clamp(st["max_na"], min=0.0)[:, None]
            s = torch.where(max_c > 0, _idiv(MAX_NODE_SCORE * raw,
                                             torch.clamp(max_c, min=1.0)),
                            zero)
        elif name == "TaintToleration":
            raw = planes[plane["raw:TaintToleration"]]
            max_c = torch.clamp(st["max_tt"], min=0.0)[:, None]
            s = torch.where(max_c > 0, MAX_NODE_SCORE - _idiv(
                MAX_NODE_SCORE * raw, torch.clamp(max_c, min=1.0)), full)
        elif name == "InterPodAffinity":
            raw = planes[plane["ipa_raw"]]
            max_c = torch.clamp(st["max_ip"], min=0.0)[:, None]
            min_c = torch.clamp(st["min_ip"], max=0.0)[:, None]
            diff = max_c - min_c
            norm = torch.where(diff > 0, _idiv(MAX_NODE_SCORE * (raw - min_c),
                                               torch.clamp(diff, min=1.0)),
                               zero)
            s = torch.where(sub["ipa_any"][:, None], norm, raw)
        elif name == "PodTopologySpread":
            s = torch.where(f, full, zero)
        elif name == "DefaultPodTopologySpread":
            raw = planes[plane["dps_raw"]]
            max_node = torch.clamp(st["max_dps"], min=0.0)[:, None]
            f_score = torch.where(max_node > 0,
                                  MAX_NODE_SCORE * (max_node - raw)
                                  / torch.clamp(max_node, min=1.0), full)
            cz = st["czone"]
            max_zone = torch.clamp(cz.max(dim=1).values, min=0.0)[:, None]
            zone_score = torch.where(max_zone > 0,
                                     MAX_NODE_SCORE * (max_zone - cz @ zone.T)
                                     / torch.clamp(max_zone, min=1.0), full)
            out = torch.where(st["havez"][:, None] & has_zone[None, :],
                              f_score * ONE_MINUS_ZONE_W + ZONE_W * zone_score,
                              f_score)
            s = torch.where(sub["skip"][:, None], zero, torch.floor(out))
        else:
            raise NotImplementedError("k1_bound: score %s" % name)
        total = total + torch.where(f, s, zero) * weight
    if "bias" in plane:
        total = total + planes[plane["bias"]]
    return total


def _sectors(flags, first) -> int:
    """32-byte sectors of f32 rows holding at least one element where
    flags [W, N] is True; row w's element 0 lies ``first[w]`` floats past
    a 32-byte boundary."""
    W, N = flags.shape
    sec = (first[:, None] + torch.arange(N, device=flags.device)) // 8
    occ = torch.zeros((W, N // 8 + 2), dtype=torch.int32,
                      device=flags.device)
    occ.scatter_add_(1, sec, flags.int())
    return int((occ > 0).sum())


def counts(bundle, rows, live, req, nz, ports_used) -> Tuple[int, int]:
    """(bytes, operations) one launch's data needs."""
    L = bundle["layout"]
    S, B, N = bundle["planes"].shape
    R, P = bundle["breq"].shape[1], bundle["bports"].shape[1]
    W = rows.shape[0]
    sub = _rows_of(bundle, rows)
    f = _feasible(sub, L, live, req, ports_used)
    total = _combine(sub, L, f, nz)
    best = torch.where(f, total, torch.full_like(total, NEG)).amax(1)
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
    nbytes += W * (8 + 1) + W * (4 + 4 + 1)
    ops = int(admitted.sum()) * (2 * R + 2 * P) + int(f.sum()) * 40
    return nbytes, ops


def bound_s(bundle, rows, live, req, nz, ports_used) -> float:
    """The least seconds one launch could take on the card."""
    nbytes, ops = counts(bundle, rows, live, req, nz, ports_used)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
