"""Seeded inputs of the fused propose step (ops/propose.py), made with numpy.

One builder for every check of the propose kernel: the port's CPU tests
(against the JAX package's Pallas kernel and against the plain version),
the card test and chip_smoke.py's kernel phase draw their worlds here,
each at its own size.  A world is a bundle of B pod rows x N nodes with
integer-valued score planes (many exact ties), a gumbel plane, Z zones,
sparse hostPorts and some all-infeasible rows, plus the round's carries;
``propose_args`` turns it into the propose step's arguments for chosen
window rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.programs import ProgramConfig
from ..ops import propose as PK

# a layout other than the default plugin family: Most/LeastAllocated,
# weights 2 and 3 (the kernel's generic instantiation)
GENERIC_SCORES = (("NodeResourcesMostAllocated", 1),
                  ("NodeResourcesLeastAllocated", 2), ("NodeAffinity", 1),
                  ("ImageLocality", 1), ("TaintToleration", 3))
R_CHANNELS = 5    # cpu, memory, ephemeral, pods, one scalar resource


def world(seed, B, N, with_bias=False, Z=8, scores=None, P=8,
          extreme=False) -> dict:
    """Numpy arrays of one seeded world: the bundle's pod side (planes
    [S, B, N] in plane_order, mask, ipa_any, skip, breq, bnz, bports), its
    node tables (alloc [N, R], zone one-hot [N, Z], some nodes zone-less),
    the round's carries (req [N, R], nz [N, 2], ports_used [N, P]), live
    [B] per bundle row, and the score layout.  extreme=True puts division
    operands outside the CUDA kernel's fast division range (2**-40 ..
    2**40), which it recomputes with __fdiv_rn: ~3% of nodes get 2**45
    millicores of allocatable cpu, ~3% of NodeAffinity raws a value near
    2**-50."""
    rs = np.random.RandomState(seed)
    cfg = ProgramConfig(scores=scores) if scores else ProgramConfig()
    layout = PK.layout_for(cfg, with_bias)
    planes = []
    for name in layout.planes:
        if name == "gumbel":
            planes.append(rs.gumbel(size=(B, N)))
        elif name == "raw:NodePreferAvoidPods":
            planes.append(np.where(rs.rand(B, N) < 0.05, 0, 100))
        elif name == "ipa_raw":
            planes.append(rs.randint(-3, 4, (B, N)) * (rs.rand(B, 1) < 0.5))
        elif name == "bias":
            planes.append(rs.randint(-2, 3, (B, N)))
        else:
            planes.append(rs.randint(0, 4, (B, N)))
    f32 = np.float32
    alloc = np.zeros((N, R_CHANNELS), f32)
    alloc[:, 0], alloc[:, 1], alloc[:, 3] = 4000, 32768, 110
    alloc[:, 4] = rs.randint(0, 3, N)
    zone = np.zeros((N, Z), f32)
    zi = rs.randint(0, Z + 1, N)
    zone[np.arange(N)[zi < Z], zi[zi < Z]] = 1.0
    breq = np.zeros((B, R_CHANNELS), f32)
    breq[:, 0] = rs.randint(0, 20, B) * 100
    breq[:, 1] = rs.randint(0, 16, B) * 256
    breq[:, 3] = 1
    breq[:, 4] = rs.randint(0, 2, B)
    mask = rs.rand(B, N) < 0.9
    mask[rs.rand(B) < 0.1] = False          # all-infeasible rows
    req = np.zeros((N, R_CHANNELS), f32)
    req[:, 0] = rs.randint(0, 40, N) * 100
    req[:, 1] = rs.randint(0, 120, N) * 256
    req[:, 3] = rs.randint(0, 111, N)
    planes = np.stack([p.astype(f32) for p in planes])
    if extreme:
        alloc[rs.rand(N) < 0.03, 0] = 2.0 ** 45
        na = planes[layout.planes.index("raw:NodeAffinity")]
        tiny = rs.rand(B, N) < 0.03
        na[tiny] = rs.randint(1, 4, int(tiny.sum())) * 2.0 ** -50
    return dict(
        planes=planes, mask=mask,
        ipa_any=rs.rand(B) < 0.5, skip=rs.rand(B) < 0.1, breq=breq,
        bnz=np.maximum(breq[:, :2], np.array([100, 200], f32)),
        bports=(rs.rand(B, P) < 0.1).astype(f32), alloc=alloc, zone=zone,
        req=req, nz=req[:, :2].copy(),
        ports_used=(rs.rand(N, P) < 0.1).astype(f32),
        live=rs.rand(B) < 0.9, layout=layout)


def window_rows(seed, B, W, sentinels=0, ordered=True) -> torch.Tensor:
    """W window rows (int64) of a B-row bundle: W - sentinels distinct
    rows, ascending as the gang loop takes them from its pool (shuffled
    with ordered=False), then ``sentinels`` sentinel rows >= B."""
    rs = np.random.RandomState(seed)
    real = rs.permutation(B)[:W - sentinels]
    if ordered:
        real = np.sort(real)
    return torch.tensor(np.concatenate([real, B + np.arange(sentinels)]),
                        dtype=torch.int64)


def propose_args(w, rows=None, device="cpu"):
    """The propose step's arguments (bundle, rows, live, req, nz,
    ports_used) for window rows ``rows`` of world ``w`` (all B rows in
    order by default), on ``device``; a window row is live where its
    bundle row is, and a sentinel row is not."""
    B = w["mask"].shape[0]
    rows = torch.arange(B) if rows is None else rows

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    bundle = {k: t(w[k]) for k in ("planes", "mask", "ipa_any", "skip",
                                   "breq", "bnz", "bports")}
    bundle["layout"] = w["layout"]
    bundle.update(PK.node_tables(t(w["alloc"]), t(w["zone"])))
    live = torch.from_numpy(w["live"])[rows.clamp(0, B - 1)] & (rows < B)
    return (bundle, rows.to(device), live.to(device), t(w["req"]),
            t(w["nz"]), t(w["ports_used"]))
