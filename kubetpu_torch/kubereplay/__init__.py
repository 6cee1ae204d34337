"""kubereplay: offline bit-exact re-execution of journaled cycle windows.

The counterpart of tools/kubereplay for the port's journal
(utils/journal.py).  It re-executes a journaled window through the port's
own device programs (models/gang.run_auction, which launches the propose
kernel K1 on the pallas route, or models/sequential.schedule_sequential)
and **bit-matches** each replayed packed placement vector against the
recorded one: a divergence is a correctness failure, attributed to the
FIRST divergent cycle with a per-pod decision diff.

Replay rebuilds the scheduler's two device lineages:

  * the RESIDENT lineage: ``resync`` records upload the journaled host
    mirror (``HostClusterArrays.to_device``), ``delta`` records scatter the
    journaled ``ClusterDelta`` (after the wholesale term replacement) with
    ``programs.apply_cluster_delta``, ``noop`` records leave it as is;
  * the CHAIN lineage: a ``chain`` record's cluster is the PREVIOUS
    record's replayed auction materialized at the journaled pad buckets
    (``models/gang.materialize_assigned``, ``extend_score_terms=True``).

A corrupt or truncated record (a crash, the chaos ``journal`` point) or
a seq gap (a dropped write) is skipped with its reason and breaks the
lineage: every later non-anchor record skips with ``broken-lineage``
until the next ``resync`` anchor.  The window degrades, it never aborts.

``counterfactual`` re-runs the window under a modified profile (score
weights, ``kernelBackend``, ``pipelineDepth``) and reports per-cycle
placement divergence and utilization deltas.  Counterfactual placements
propagate through the chain lineage; delta records replay the recorded
churn; host plugin verdicts replay from the recorded masks.
``pipelineDepth`` never enters a device program, so it must report zero
divergence.  Mesh records skip with ``unsupported-mesh``, as the JAX
replayer skips them; extender cycles are never journaled.

Records hold host data only, so a card's journal replays on the CPU
(``device="cpu"``) and a CPU's on the card.  The device defaults to CUDA
and a missing card raises (utils/device.resolve_device).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import programs
from ..models.batch import batch_to_device
from ..state.tensors import _terms_to_device
from ..utils import prng
from ..utils.device import DeviceLike, resolve_device
from ..utils.journal import INPUT_KINDS, read_records


class ReplayError(RuntimeError):
    pass


def _load_payload(rec: Dict[str, Any]):
    payload = rec.get("input_payload")
    if isinstance(payload, (bytes, bytearray)):
        return pickle.loads(payload)
    return payload


def _apply_counterfactual(rec: Dict[str, Any],
                          counterfactual: Optional[Dict[str, Any]]):
    """(cfg, kernel_backend) of this record's dispatch with any
    counterfactual overrides applied.  ``pipeline_depth`` is accepted and
    ignored: the executor's depth never reaches a device program."""
    cfg = rec["cfg"]
    backend = rec["kernel_backend"]
    if not counterfactual:
        return cfg, backend
    weights = counterfactual.get("score_weights")
    if weights:
        unknown = set(weights) - {name for name, _w in cfg.scores}
        if unknown:
            raise ReplayError(
                "counterfactual score plugin(s) not in the recorded "
                "profile: %s (recorded: %s)"
                % (sorted(unknown), [n for n, _ in cfg.scores]))
        cfg = cfg._replace(scores=tuple(
            (name, int(weights.get(name, w))) for name, w in cfg.scores))
    if counterfactual.get("kernel_backend"):
        backend = counterfactual["kernel_backend"]
    return cfg, backend


def _on(x, device) -> Optional[torch.Tensor]:
    return None if x is None else torch.from_numpy(np.asarray(x)).to(device)


def _dispatch(rec: Dict[str, Any], cluster, batch, cfg, kernel_backend,
              device):
    """Re-execute one journaled cycle's device program; returns its result
    (``.packed`` is the oracle surface)."""
    rng = prng.PRNGKey(int(rec["rng_counter"]), device=device)
    host_ok = _on(rec.get("host_ok"), device)
    bias = _on(rec.get("score_bias"), device)
    if rec["mode"] == "gang":
        from ..models.gang import run_auction
        return run_auction(cluster, batch, cfg, rng, host_ok=host_ok,
                           intra_batch_topology=bool(rec["needs_topo"]),
                           score_bias=bias, kernel_backend=kernel_backend)
    from ..models.sequential import schedule_sequential
    return schedule_sequential(
        cluster, batch, cfg, rng,
        hard_pod_affinity_weight=float(rec["hard_pod_affinity_weight"]),
        host_ok=host_ok, start_index=int(rec["start_index"]),
        score_bias=bias)


def _materialize_chain(rec: Dict[str, Any], prev_cluster, prev_batch,
                       prev_res):
    from ..models.gang import materialize_assigned
    pads = _load_payload(rec)
    if not pads or len(pads) != 2:
        raise ReplayError(f"chain record {rec['seq']} carries no pad "
                          "buckets")
    return materialize_assigned(
        prev_cluster, prev_batch, prev_res.chosen, prev_res.requested,
        prev_res.nz, prev_res.ports_used,
        pad_pods_to=int(pads[0]), pad_terms_to=int(pads[1]),
        extend_score_terms=True,
        hard_pod_affinity_weight=float(rec["hard_pod_affinity_weight"]))


def _apply_delta(rec: Dict[str, Any], resident, device):
    """Replay one ``delta`` record onto the resident lineage, as
    DeltaTensorizer._apply does it (the terms replaced wholesale before
    the scatter; the replay never updates in place)."""
    delta, terms = _load_payload(rec)
    if terms is not None:
        resident = resident._replace(
            filter_terms=_terms_to_device(terms[0], device),
            score_terms=_terms_to_device(terms[1], device))
    return programs.apply_cluster_delta(resident, delta, donate=False)


def _placements_of(rec: Dict[str, Any], packed: np.ndarray,
                   node_names: List[str]) -> Dict[str, str]:
    """pod name -> node name ('' unscheduled) from a packed vector (the
    record's own ``placements`` are the COMMIT outcome; the device-level
    oracle is the packed vector)."""
    B = rec["batch"].valid.shape[0]
    chosen = packed[:B]
    out = {}
    for i, (name, _ns, _uid) in enumerate(rec["pods"]):
        c = int(chosen[i])
        out[name] = node_names[c] if 0 <= c < len(node_names) else ""
    return out


def _pod_diff(rec: Dict[str, Any], recorded: np.ndarray,
              replayed: np.ndarray,
              node_names: List[str]) -> List[Dict[str, Any]]:
    """Per-pod decision diff between a recorded and a replayed packed
    vector: the pods that moved, with their feasible-node counts and
    unresolvable flags on each side."""
    B = rec["batch"].valid.shape[0]
    diffs = []
    for i, (name, ns, _uid) in enumerate(rec["pods"]):
        rc, pc = int(recorded[i]), int(replayed[i])
        rn = node_names[rc] if 0 <= rc < len(node_names) else ""
        pn = node_names[pc] if 0 <= pc < len(node_names) else ""
        if (rc, int(recorded[B + i]), int(recorded[2 * B + i])) == \
           (pc, int(replayed[B + i]), int(replayed[2 * B + i])):
            continue
        diffs.append({
            "pod": f"{ns}/{name}",
            "recorded_node": rn, "replayed_node": pn,
            "recorded_n_feasible": int(recorded[B + i]),
            "replayed_n_feasible": int(replayed[B + i]),
            "recorded_unresolvable": bool(recorded[2 * B + i]),
            "replayed_unresolvable": bool(replayed[2 * B + i]),
        })
    return diffs


def _utilization(placements: Dict[str, str]) -> Dict[str, Any]:
    """How many pods landed, across how many nodes, how peaked the
    per-node load is: the counterfactual report's utilization axis."""
    counts: Dict[str, int] = {}
    for node in placements.values():
        if node:
            counts[node] = counts.get(node, 0) + 1
    vals = list(counts.values())
    if not vals:
        return {"placed": 0, "nodes_used": 0, "max_per_node": 0,
                "mean_per_node": 0.0, "spread_std": 0.0}
    arr = np.asarray(vals, np.float64)
    return {"placed": int(arr.sum()),
            "nodes_used": len(vals),
            "max_per_node": int(arr.max()),
            "mean_per_node": round(float(arr.mean()), 3),
            "spread_std": round(float(arr.std()), 3)}


class _Lineage:
    """One profile's replay state: the resident cluster, its node names,
    the previous replayed cycle (seq, cluster, batch, result) and whether
    an anchor is needed."""
    __slots__ = ("resident", "node_names", "prev", "need_anchor")

    def __init__(self):
        self.resident = None
        self.node_names: List[str] = []
        self.prev: Optional[Tuple[int, Any, Any, Any]] = None
        self.need_anchor = True


def replay_journal(directory: str,
                   window: Optional[Tuple[int, int]] = None,
                   counterfactual: Optional[Dict[str, Any]] = None,
                   keep_going: bool = False,
                   max_divergences: int = 16,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """Replay a journal directory (optionally a ``(start, end)`` seq
    window) on ``device`` (default CUDA) and return the report the CLI
    prints, keyed as tools/kubereplay's.

    Bit-match mode (no counterfactual): every replayed packed vector must
    equal the recorded one; the first divergence is reported with its
    per-pod diff and, unless ``keep_going``, stops the replay.

    Counterfactual mode: divergence is the measurement: every cycle
    replays, divergent cycles and moved pods and the utilization deltas
    are reported, and ``bit_match`` is None.

    Lineage warm-up: with a window, the replay starts at the nearest
    ``resync`` anchor at or before its start (records before the window
    are replayed for state only, not reported)."""
    dev = resolve_device(device)
    entries = list(read_records(directory))
    if not entries:
        raise FileNotFoundError(f"no journal records under {directory!r}")

    lo, hi = window if window else (None, None)
    start_at = None
    if lo is not None:
        for seq, rec, skip in entries:
            if seq > lo:
                break
            if rec is not None and rec.get("input") == "resync":
                start_at = seq
        if start_at is None:
            start_at = lo

    report: Dict[str, Any] = {
        "dir": directory,
        "records": len(entries),
        "window": list(window) if window else None,
        "considered": 0, "replayed": 0, "matched": 0,
        "skipped": [], "divergences": [],
        "first_divergence": None,
        "counterfactual": None,
        # the distinct configuration digests of the window: more than one
        # means a rollout landed mid-window
        "config_digests": [],
    }
    cf_requested = bool(counterfactual)
    cf_overrides: Dict[str, Any] = dict(counterfactual or {})
    cf_divergent_cycles = 0
    cf_diverged_pods = 0
    recorded_plc: Dict[str, str] = {}
    replayed_plc: Dict[str, str] = {}
    digests: List[str] = []
    # lineage state is PER PROFILE (the scheduler keeps one resident and
    # one chain slot per profile); a chain record further needs its parent
    # to be the adjacent seq (another profile's cycle between destroys the
    # scheduler's single chain slot)
    lineages: Dict[str, _Lineage] = {}
    last_seq: Optional[int] = None
    stop = False

    def skip(seq: int, reason: str, reported: bool) -> None:
        if reported:
            report["skipped"].append({"seq": seq, "reason": reason})

    def break_all() -> None:
        for ln in lineages.values():
            ln.need_anchor = True
            ln.prev = None

    for seq, rec, why in entries:
        if stop:
            break
        if start_at is not None and seq < start_at:
            continue
        if hi is not None and seq > hi:
            break
        reported = lo is None or seq >= lo
        if reported:
            report["considered"] += 1
        if rec is None:
            # the lost record's profile is unknowable: every lineage is
            # suspect until its next anchor
            skip(seq, f"corrupt record: {why}", reported)
            break_all()
            last_seq = seq
            continue
        kind = rec.get("input")
        line = lineages.setdefault(rec.get("profile") or "", _Lineage())
        if last_seq is not None and seq != last_seq + 1:
            # a gap may hide a cycle of any profile
            break_all()
        last_seq = seq
        if rec.get("mesh"):
            skip(seq, "unsupported-mesh", reported)
            line.need_anchor = True
            line.prev = None
            continue
        if kind not in INPUT_KINDS:
            skip(seq, f"unknown input kind {kind!r}", reported)
            line.need_anchor = True
            line.prev = None
            continue
        try:
            if kind == "resync":
                host = _load_payload(rec)
                line.resident = host.to_device(dev)
                line.node_names = list(rec.get("node_names")
                                       or line.node_names)
                line.need_anchor = False
                cluster = line.resident
            elif line.need_anchor:
                skip(seq, "broken-lineage (no resync anchor since the "
                          "last skip/gap)", reported)
                continue
            elif kind == "delta":
                line.resident = _apply_delta(rec, line.resident, dev)
                cluster = line.resident
            elif kind == "noop":
                cluster = line.resident
            else:   # chain
                if line.prev is None or line.prev[0] != seq - 1:
                    skip(seq, "broken-lineage (chain parent not the "
                              "adjacent replayed cycle of this "
                              "profile)", reported)
                    line.need_anchor = True
                    continue
                cluster = _materialize_chain(rec, line.prev[1],
                                             line.prev[2], line.prev[3])
            cfg, backend = _apply_counterfactual(rec, cf_overrides)
            batch = batch_to_device(rec["batch"], dev)
            res = _dispatch(rec, cluster, batch, cfg, backend, dev)
            packed = res.packed.cpu().numpy()
        except ReplayError as e:
            skip(seq, str(e), reported)
            line.need_anchor = True
            line.prev = None
            continue
        line.prev = (seq, cluster, batch, res)
        node_names = line.node_names
        if not reported:
            continue   # lineage warm-up before the window
        if rec.get("config_digest") and rec["config_digest"] not in digests:
            digests.append(rec["config_digest"])
        report["replayed"] += 1
        recorded = np.asarray(rec["packed"])
        match = (recorded.shape == packed.shape
                 and bool(np.array_equal(recorded, packed)))
        if cf_requested:
            diffs = _pod_diff(rec, recorded, packed, node_names)
            moved = [d for d in diffs
                     if d["recorded_node"] != d["replayed_node"]]
            if moved:
                cf_divergent_cycles += 1
                cf_diverged_pods += len(moved)
            recorded_plc.update(_placements_of(rec, recorded, node_names))
            replayed_plc.update(_placements_of(rec, packed, node_names))
            if match:
                report["matched"] += 1
            continue
        if match:
            report["matched"] += 1
            continue
        div = {
            "seq": seq,
            "cycle": rec.get("cycle"),
            "links": dict(rec.get("links") or {}),
            "verdicts": dict(rec.get("verdicts") or {}),
            "recorded_rounds": int(recorded[-1]) if recorded.size else 0,
            "replayed_rounds": int(packed[-1]) if packed.size else 0,
            "pod_diff": _pod_diff(rec, recorded, packed, node_names),
        }
        report["divergences"].append(div)
        if report["first_divergence"] is None:
            report["first_divergence"] = div
        if not keep_going or len(report["divergences"]) >= max_divergences:
            stop = True

    report["config_digests"] = digests
    report["bit_match"] = (report["first_divergence"] is None
                           and report["replayed"] > 0)
    if cf_requested:
        rec_util = _utilization(recorded_plc)
        rep_util = _utilization(replayed_plc)
        report["counterfactual"] = {
            "overrides": {k: v for k, v in cf_overrides.items() if v},
            "cycles": report["replayed"],
            "divergent_cycles": cf_divergent_cycles,
            "diverged_pods": cf_diverged_pods,
            "utilization": {
                "recorded": rec_util,
                "counterfactual": rep_util,
                "delta": {k: round(rep_util[k] - rec_util[k], 3)
                          for k in rec_util},
            },
        }
        # counterfactual mode measures divergence, it does not gate on it
        report["bit_match"] = None
    return report
