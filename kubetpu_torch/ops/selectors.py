"""Batched label-selector matching as dense tensor ops.

A *selector* is compiled host-side (numpy) into multi-hot vectors over the
interned (key,value) / key vocabularies, and matching S selectors against M
targets (nodes or pods) becomes two batched matrix products plus
elementwise logic — no per-object string work on the hot path
(reference: staging/src/k8s.io/apimachinery/pkg/labels/selector.go).

Semantics per requirement (AND across requirements of one selector):
  In(key, vals)      -> target has any interned (key,v) for v in vals
  NotIn(key, vals)   -> negation of In  (key absent also matches)
  Exists(key)        -> target has the key
  DoesNotExist(key)  -> negation of Exists
  Gt/Lt(key, val)    -> numeric parse of the target's label value compared
                        to val; unparsable/missing never matches
matching apimachinery's Requirement.Matches (selector.go:214-260).

The counts inside the products are small integers, exact in float32 in
any summation order, so the match matrices are bit-identical on the CPU
and the card.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..api import types as api
from ..utils.device import copy_to
from ..utils.intern import InternTable, pow2_bucket


class SelectorSet(NamedTuple):
    """S selector *slots* backed by U <= S unique compiled selectors.

    Pods stamped out by one controller share identical selectors, so the
    compiler dedups: the dense requirement tensors are stored once per
    unique selector and each slot carries only an index.  Leaves are numpy
    arrays on the host and torch tensors once moved to a device
    (selector_to_device).

    vals_hot : [U, Q, L] bool multi-hot over (key,value) vocab (In/NotIn)
    key_hot  : [U, Q, K] bool multi-hot over key vocab (Exists/DoesNotExist)
    negate   : [U, Q] bool    requirement result is inverted
    use_key  : [U, Q] bool    requirement tests key presence, not values
    req_valid: [U, Q] bool    padding mask for requirements
    num_key  : [U, Q] i32     key index for Gt/Lt (0 if unused)
    num_op   : [U, Q] i32     0 = none, 1 = Gt, 2 = Lt
    num_val  : [U, Q] f32     comparison constant for Gt/Lt
    sel_valid: [U] bool       nil/padding selectors (match nothing)
    index    : [S] i32        slot -> unique row
    """
    vals_hot: object
    key_hot: object
    negate: object
    use_key: object
    req_valid: object
    num_key: object
    num_op: object
    num_val: object
    sel_valid: object
    index: object

    @property
    def n_selectors(self) -> int:
        return self.index.shape[0]


def selector_to_device(sel: SelectorSet, device) -> SelectorSet:
    """Copy every leaf to ``device`` (numpy or torch in, torch out)."""
    return SelectorSet(*[copy_to(x, device) for x in sel])


def match_selectors(sel: SelectorSet,
                    kv: torch.Tensor,      # [M, L] bool — target has (key,value)
                    key: torch.Tensor,     # [M, K] bool — target has key
                    num: Optional[torch.Tensor] = None,  # [M, K] f32 (+inf = non-numeric)
                    ) -> torch.Tensor:
    """Match S selector slots against M targets -> [S, M] bool."""
    return match_selectors_unique(sel, kv, key, num)[sel.index.long()]


def match_selectors_unique(sel: SelectorSet, kv: torch.Tensor,
                           key: torch.Tensor,
                           num: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The [U, M] unique-selector match matrix behind match_selectors;
    slot s maps to row sel.index[s]."""
    U, Q, L = sel.vals_hot.shape
    kv_f = kv.float()
    key_f = key.float()
    cnt_v = (sel.vals_hot.float().reshape(U * Q, L) @ kv_f.T).reshape(U, Q, -1)
    cnt_k = (sel.key_hot.float().reshape(U * Q, -1) @ key_f.T).reshape(U, Q, -1)
    present = torch.where(sel.use_key[..., None], cnt_k > 0.5, cnt_v > 0.5)
    ok = present ^ sel.negate[..., None]

    if num is not None:
        # Gt/Lt: gather each requirement's numeric label column
        nval = num.T[sel.num_key.long().clamp(0, num.shape[1] - 1)]  # [U, Q, M]
        is_gt = sel.num_op[..., None] == 1
        cmp = torch.where(is_gt, nval > sel.num_val[..., None],
                          nval < sel.num_val[..., None])
        # absent/non-numeric labels are +inf: isfinite fails them
        cmp = cmp & torch.isfinite(nval)
        ok = torch.where(sel.num_op[..., None] > 0, cmp, ok)

    ok = ok | ~sel.req_valid[..., None]
    return ok.all(dim=1) & sel.sel_valid[:, None]


def pad_selector_slots(s: SelectorSet, to: int) -> SelectorSet:
    """Pad the SLOT axis to ``to`` entries (index 0; callers mask the
    padding with their own validity arrays)."""
    idx = s.index
    n = to - idx.shape[0]
    if n <= 0:
        return s
    return s._replace(index=torch.cat(
        [idx, torch.zeros((n,), dtype=idx.dtype, device=idx.device)]))


def concat_selector_sets(a: SelectorSet, b: SelectorSet) -> SelectorSet:
    """Concatenate two SelectorSets compiled against the same vocab: the
    unique rows are stacked, b's slot indices shift by a's unique count,
    and the requirement axis is zero-padded to the larger Q (padding
    requirements are invalid, so they match everything)."""
    qa, qb = a.req_valid.shape[1], b.req_valid.shape[1]
    q = max(qa, qb)

    def padq(x, have):
        if have == q:
            return x
        pad = [0, 0] * (x.ndim - 2) + [0, q - have]
        return torch.nn.functional.pad(x, pad)

    def cat(name):
        x, y = getattr(a, name), getattr(b, name)
        return torch.cat([padq(x, qa), padq(y, qb)])

    ua = a.sel_valid.shape[0]
    return SelectorSet(
        vals_hot=cat("vals_hot"), key_hot=cat("key_hot"),
        negate=cat("negate"), use_key=cat("use_key"),
        req_valid=cat("req_valid"), num_key=cat("num_key"),
        num_op=cat("num_op"), num_val=cat("num_val"),
        sel_valid=torch.cat([a.sel_valid, b.sel_valid]),
        index=torch.cat([a.index, b.index + ua]))


# ---------------------------------------------------------------------------
# host-side compiler


SelectorLike = Union[api.LabelSelector, api.NodeSelectorTerm, dict, None]

# Synthetic label-key prefix for NodeSelectorTerm.match_fields (the only
# supported field is metadata.name, reference:
# pkg/apis/core/v1/helper/helpers.go GetNodeFieldSelectorMap).
FIELD_PREFIX = "__field__"


class _Req(NamedTuple):
    op: str
    key: str
    values: Sequence[str]


def _reqs_of(sel: SelectorLike) -> Optional[List[_Req]]:
    """Normalize any selector-ish object to a requirement list; None => the
    selector matches nothing (nil selector)."""
    if sel is None:
        return None
    if isinstance(sel, dict):  # plain match-labels map (e.g. spec.nodeSelector)
        return [_Req("In", k, [v]) for k, v in sorted(sel.items())]
    if isinstance(sel, api.LabelSelector):
        return [_Req(r.operator, r.key, list(r.values)) for r in sel.requirements()]
    if isinstance(sel, api.NodeSelectorTerm):
        reqs = [_Req(r.operator, r.key, list(r.values)) for r in sel.match_expressions]
        reqs += [_Req(r.operator, FIELD_PREFIX + r.key, list(r.values))
                 for r in sel.match_fields]
        # A term with no expressions and no fields matches nothing
        # (reference: pkg/apis/core/v1/helper/helpers.go:180 MatchNodeSelectorTerms).
        if not reqs:
            return None
        return reqs
    raise TypeError(f"unsupported selector type {type(sel)}")


class SelectorCompiler:
    """Compiles host selector objects into a SelectorSet of numpy arrays."""

    def __init__(self, table: InternTable):
        self.table = table

    def compile(self, selectors: Sequence[SelectorLike],
                pad_s: Optional[int] = None,
                intern_new: bool = True) -> SelectorSet:
        """intern_new: selectors may introduce vocab entries (normally the
        snapshot builder has already interned all cluster labels; pod
        selectors referencing unknown values simply never match, so lookups
        use get() when intern_new=False).

        Identical requirement lists compile to ONE unique row shared via the
        slot index — both the numpy build work and the device tensors scale
        with the number of distinct selectors, not the batch size."""
        all_req_lists = [_reqs_of(s) for s in selectors]
        S = pad_s if pad_s is not None else pow2_bucket(len(selectors), 1)
        if S < len(selectors):
            raise ValueError("pad_s smaller than selector count")

        uniq: dict = {}
        index = np.zeros((S,), np.int32)
        req_lists: List[Optional[List[_Req]]] = []
        for i in range(S):
            reqs = all_req_lists[i] if i < len(all_req_lists) else None
            k = None if reqs is None else tuple(
                (r.op, r.key, tuple(r.values)) for r in reqs)
            u = uniq.get(k)
            if u is None:
                u = len(req_lists)
                uniq[k] = u
                req_lists.append(reqs)
            index[i] = u

        max_q = max((len(r) for r in req_lists if r), default=1)
        Q = pow2_bucket(max_q, 2)
        U = pow2_bucket(len(req_lists), 1)
        L, K = self.table.kv.cap, self.table.key.cap

        vals_hot = np.zeros((U, Q, L), bool)
        key_hot = np.zeros((U, Q, K), bool)
        negate = np.zeros((U, Q), bool)
        use_key = np.zeros((U, Q), bool)
        req_valid = np.zeros((U, Q), bool)
        num_key = np.zeros((U, Q), np.int32)
        num_op = np.zeros((U, Q), np.int32)
        num_val = np.zeros((U, Q), np.float32)
        sel_valid = np.zeros((U,), bool)

        kv_id = (self.table.kv.intern if intern_new else self.table.kv.get)
        key_id = (self.table.key.intern if intern_new else self.table.key.get)

        for i, reqs in enumerate(req_lists):
            if reqs is None:
                continue  # matches nothing
            sel_valid[i] = True
            for q, r in enumerate(reqs):
                req_valid[i, q] = True
                if r.op in ("In", "NotIn"):
                    for v in r.values:
                        j = kv_id((r.key, v))
                        if j >= 0:
                            vals_hot[i, q, j] = 1.0
                    negate[i, q] = (r.op == "NotIn")
                elif r.op in ("Exists", "DoesNotExist"):
                    j = key_id(r.key)
                    if j >= 0:
                        key_hot[i, q, j] = 1.0
                    use_key[i, q] = True
                    negate[i, q] = (r.op == "DoesNotExist")
                elif r.op in ("Gt", "Lt"):
                    j = key_id(r.key)
                    num_key[i, q] = max(j, 0)
                    num_op[i, q] = 1 if r.op == "Gt" else 2
                    try:
                        num_val[i, q] = float(int(r.values[0]))
                    except (ValueError, IndexError):
                        # unparsable constant never matches: impossible compare
                        num_op[i, q] = 1
                        num_val[i, q] = np.inf
                    if j < 0:
                        # unknown key can never be numeric-matched
                        num_val[i, q] = np.inf if r.op == "Gt" else -np.inf
                else:
                    raise ValueError(f"unknown selector op {r.op}")

        return SelectorSet(vals_hot=vals_hot, key_hot=key_hot, negate=negate,
                           use_key=use_key, req_valid=req_valid, num_key=num_key,
                           num_op=num_op, num_val=num_val, sel_valid=sel_valid,
                           index=index)
