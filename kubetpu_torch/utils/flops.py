"""Analytic FLOP accounting for the device scheduling programs.

The counterpart of kubetpu/utils/flops.py, with the same model: the gang
auction's matmul work per round (the same-pair contractions that
re-evaluate topology filters and scores per round, [S, P] x [P, N] per
active topology key plus [S, N] x [N, N] pair registration, the
existing-term contractions [Et, W] x [Et, N], the per-node count matmul),
with the round width following the windowed-residual schedule (round 1
at B, residual rounds at the window width), so a run can report achieved
FLOP/s against the card's peak.

The model counts the IN-ROUND matmul FLOPs only (2*m*n*k per
contraction); the once-per-cycle precomputation and all elementwise work
are excluded, so a fraction of peak computed from it is a LOWER bound.
It counts the reference's work as the JAX package's model does: on a
term-free batch the port's static topology filters also run one all-zero
[S x N] x [N x N] same-pair product per topology key in the precompute
(the all-keys gemms, ROADMAP queue 2 item 1), which the model does not
count.

Reference anchor: these matmuls replace the O(pods x nodes) hot loops of
pkg/scheduler/framework/plugins/interpodaffinity/scoring.go:128-199 and
podtopologyspread/scoring.go:108-169.
"""

from __future__ import annotations

import os

PEAK_TFLOPS_ENV = "KUBETPU_PEAK_TFLOPS"
# NVIDIA H100 SXM, float32 outside the tensor cores (NVIDIA's data sheet):
# the port contracts in f32 with TF32 pinned off (utils/device.py)
DEFAULT_PEAK_TFLOPS = 67.0


def peak_flops_per_s() -> float:
    """The card's peak for the dtype the port contracts in: f32 with TF32
    off, 67 TFLOP/s on an H100 SXM.  KUBETPU_PEAK_TFLOPS overrides it for
    other parts."""
    return float(os.environ.get(PEAK_TFLOPS_ENV,
                                str(DEFAULT_PEAK_TFLOPS))) * 1e12


def _dim(x, i: int) -> int:
    return int(x.shape[i])


def gang_cycle_flops(cluster, batch, cfg, rounds: int,
                     residual_window: int = 512,
                     intra_batch_topology: bool = True,
                     kernel_backend: str = "lax") -> float:
    """Matmul FLOPs of one gang-auction cycle given its executed round
    count (GangResult.rounds / packed[3B]); the JAX package's function on
    the port's tensors (host or device: only shapes are read).

    kernel_backend="pallas": rounds 1+ run K1 (ops/propose.py), whose
    per-round work collapses to the fit/resource sweep plus the small zone
    contraction — the raw score planes are computed once (inside round 0's
    accounting) instead of recontracted per round."""
    N = _dim(cluster.allocatable, 0)
    B = _dim(batch.valid, 0)
    R = _dim(cluster.allocatable, 1)
    TK = _dim(cluster.topo_pair, 1)
    n_keys = len(cfg.active_topo_keys) if cfg.active_topo_keys else TK
    Tr = _dim(batch.ra.valid, 1)
    Ta = _dim(batch.raa.valid, 1)
    Tp = _dim(batch.pref.valid, 1)
    C = _dim(batch.spread.valid, 1)
    C2 = _dim(batch.spread_soft.valid, 1)
    filters = set(cfg.filters)
    scores = {n for n, _ in cfg.scores}
    # schedule_gang's gating: the topology filters move into the loop (and
    # the pod axis and filter terms extend by the batch) only when a
    # topology FILTER is configured and intra_batch_topology is on
    use_sph = "PodTopologySpread" in filters and intra_batch_topology
    use_ipa = "InterPodAffinity" in filters and intra_batch_topology
    intra = use_sph or use_ipa
    P = _dim(cluster.pod_valid, 0) + (B if intra else 0)
    Et = _dim(cluster.filter_terms.valid, 0) + (B * Ta if intra else 0)
    Es = _dim(cluster.score_terms.valid, 0)

    def round_flops(W: int) -> float:
        f = 0.0
        if use_sph:
            f += n_keys * (2.0 * W * C * P * N + 2.0 * W * C * N * N)
        if use_ipa:
            f += n_keys * 2.0 * W * (Tr + Ta) * P * N
            f += 2.0 * Et * W * N
        if "InterPodAffinity" in scores:
            f += n_keys * 2.0 * W * Tp * P * N + 2.0 * Es * W * N
        if "PodTopologySpread" in scores:
            f += n_keys * (2.0 * W * C2 * P * N + 2.0 * W * C2 * N * N)
        if "DefaultPodTopologySpread" in scores:
            f += 2.0 * W * P * N
        # fit + resource scorers + normalizes: one multiply-add sweep over
        # [W, N, R] as a floor
        f += 2.0 * W * N * R
        return f

    def kernel_round_flops(W: int) -> float:
        # K1's round: the fit and resource-scorer sweep, the zone
        # contraction and the ports conflict dot; the score raws are
        # plane reads
        Z = _dim(cluster.zone_hot, 1) or 1
        Pp = _dim(batch.ports_hot, 1)
        f = 2.0 * W * N * R + 2.0 * W * N * Z
        if "NodePorts" in filters:
            f += 2.0 * W * Pp * N
        return f

    W_resid = min(residual_window or B, B)
    r = max(int(rounds), 0)
    if r == 0:
        return 0.0
    if kernel_backend == "pallas":
        # round 0 stays on the plain path (the feasible0 capture) and
        # carries the once-per-auction raw precompute in its accounting
        return round_flops(B) + (r - 1) * kernel_round_flops(W_resid)
    return round_flops(B) + (r - 1) * round_flops(W_resid)
