"""The plain reference: what every cycle's binds must satisfy.

Plain NumPy.  It imports nothing of the program and reads nothing the
program made: it keeps its own ledger of the cluster from the world the
benchmark built, the departures it fired and the binds and deletions the
store reported, so it knows the cluster as each cycle saw it at its start
and left it at its end.  For every cycle it works out again, from those
states:

* ``wrong`` (an exact count, limit 0): a bind to a node that does not
  exist; a node the cycle left over its cpu, memory or pod count
  (kube-scheduler's NodeResourcesFit); what a pod feature's own check
  finds (``features/<key>.py``: a spread constraint broken); a pod the
  program deleted that no feature accounts for; and a pod the cycle left
  pending although a node could take it in the cycle's end state.
* ``score_gap`` (points of the weighted node score): the widest gap by
  which a bound pod's node scored below a node that was open to it in the
  round it was placed.

The gang auction places pods in rounds, each against the usage committed
before it, so the order of a cycle's binds is not a serial order.  Both
checks hold for any order:

* The auction ends only when no pending pod has a feasible node against
  the usage committed so far: the cycle's end state.
* A node m that no pod of the cycle went to kept its start usage all
  cycle; if it fitted a pod at the start and every feature kept it open to
  the pod in every round (or in the pod's own round, for a node sharing
  the domain the pod went to), it was feasible when the pod was placed.
  The pod took the best feasible node then, so its score at its node n,
  whose usage lies between n's start usage and its end usage less the
  pod, is at least m's.  The gap compares m's score with the best n could
  have offered: ``max_j score(n's start + j pods)`` for j = 1 .. the pods
  of the template n received (a node that received pods of several
  templates is left out of the gap).

Node scores come from the configuration's ``reference_scores``, each a
file ``scores/<Plugin>.py`` (kube-scheduler v1.19's formulas in exact
integers).  The other default score plugins give every node of these
worlds the same score (no taints, images, affinity, preferred terms or
services), so they cannot move the gap and are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .spec import ClosedLoop, Template, World, rng_of


class Usage(NamedTuple):
    """Per node: requested cpu and memory and the pod count, each with
    the pod being scored; the features' states."""
    cpu: np.ndarray
    mem: np.ndarray
    pods: np.ndarray
    features: dict


def node_score(world: World, plugins: Sequence[Tuple[str, int]],
               usage: Usage) -> np.ndarray:
    """The weighted score of every node at the given usage."""
    total = np.zeros(np.shape(usage.cpu), np.int64)
    for name, weight in plugins:
        total = total + int(weight) * world.plugins.score(name).score(
            world, usage)
    return total


@dataclass
class CycleRecord:
    """One cycle as the reference sees it: the usage at its start and its
    end, the binds it made, the pods the program deleted and the pods it
    left pending."""
    start: Usage
    end: Optional[Usage] = None
    binds: List[Tuple[str, int]] = field(default_factory=list)
    evicted: List[str] = field(default_factory=list)
    unbound: List[str] = field(default_factory=list)
    attempted: int = 0


class Ledger:
    """The cluster as the reference knows it: per node the requested cpu,
    memory and pod count, and the state of every feature the world's
    templates carry."""

    def __init__(self, world: World):
        self.world = world
        n = world.n_nodes
        self.cpu = np.zeros(n, np.int64)
        self.mem = np.zeros(n, np.int64)
        self.pods = np.zeros(n, np.int64)
        self.features = {k: world.plugins.feature(k).Ref(world)
                         for k in world.feature_names}
        self.node_of: Dict[str, int] = {}
        self.template_of: Dict[str, Template] = {}
        self.cycles: List[CycleRecord] = []
        for name, t, node in world.bound:
            self.template_of[name] = world.templates[t]
            self.node_of[name] = node
            self._place(name, node, 1)

    def _place(self, name: str, node: int, sign: int) -> None:
        t = self.template_of[name]
        self.cpu[node] += sign * t.cpu_milli
        self.mem[node] += sign * t.mem_bytes
        self.pods[node] += sign
        for f in self.features.values():
            f.place(t, node, sign)

    def _usage(self) -> Usage:
        return Usage(self.cpu.copy(), self.mem.copy(), self.pods.copy(),
                     {k: f.snapshot() for k, f in self.features.items()})

    def pending(self, name: str, template: str) -> None:
        self.template_of[name] = self.world.templates[template]

    def remove(self, name: str) -> None:
        self._place(name, self.node_of.pop(name), -1)

    def begin_cycle(self) -> CycleRecord:
        rec = CycleRecord(start=self._usage())
        self.cycles.append(rec)
        return rec

    def end_cycle(self, rec: CycleRecord) -> None:
        rec.end = self._usage()

    def bind(self, rec: CycleRecord, name: str, node: int) -> None:
        """A bind the store reported; node -1: not a node of the world."""
        rec.binds.append((name, node))
        if node >= 0:
            self.node_of[name] = node
            self._place(name, node, 1)

    def evict(self, rec: CycleRecord, name: str) -> None:
        """A bound pod the program deleted during the cycle."""
        rec.evicted.append(name)
        self.remove(name)

    def outcome(self, rec: CycleRecord, name: str, bound: bool) -> None:
        rec.attempted += 1
        if not bound:
            rec.unbound.append(name)


def _fits(world: World, u: Usage, t: Template) -> np.ndarray:
    return ((u.cpu + t.cpu_milli <= world.alloc_cpu)
            & (u.mem + t.mem_bytes <= world.alloc_mem)
            & (u.pods + 1 <= world.alloc_pods))


def _with(u: Usage, t: Template, j=1) -> Usage:
    return Usage(u.cpu + j * t.cpu_milli, u.mem + j * t.mem_bytes,
                 u.pods + j, u.features)


def check_cycle(ledger: Ledger, rec: CycleRecord,
                plugins: Sequence[Tuple[str, int]]) -> Tuple[int, float]:
    """(wrong, score_gap) of one cycle; score_gap is -inf when no bound
    pod had an open node to compare with."""
    w = ledger.world
    n = w.n_nodes
    start, end = rec.start, rec.end
    wrong = sum(1 for _, node in rec.binds if node < 0)
    binds = [(ledger.template_of[nm], nd) for nm, nd in rec.binds
             if nd >= 0]
    adds = np.zeros(n, np.int64)
    for _, nd in binds:
        adds[nd] += 1
    touched = adds > 0
    over = ((end.cpu > w.alloc_cpu) | (end.mem > w.alloc_mem)
            | (end.pods > w.alloc_pods))
    wrong += int((touched & over).sum())
    for k, f in ledger.features.items():
        wrong += int(f.wrong(binds, start.features[k], end.features[k]))
    vouched = sum(int(getattr(f, "evictions", lambda *a: 0)(
        rec.evicted, start.features[k], end.features[k]))
        for k, f in ledger.features.items())
    wrong += max(0, len(rec.evicted) - vouched)

    by_template: Dict[str, Template] = {t.name: t for t, _ in binds}
    for nm in rec.unbound:
        t = ledger.template_of[nm]
        by_template[t.name] = t
    gap = float("-inf")
    low = np.iinfo(np.int64).min
    for t in by_template.values():
        # a pod left pending: the auction ends only when no pending pod
        # has a feasible node against the usage committed so far
        end_fit = _fits(w, end, t)
        for k, f in ledger.features.items():
            end_fit &= f.end_fit(t, end.features[k])
        if end_fit.any():
            wrong += sum(1 for nm in rec.unbound
                         if ledger.template_of[nm].name == t.name)

        mine = np.array([nd for tt, nd in binds if tt.name == t.name],
                        np.int64)
        if not len(mine):
            continue
        mine_adds = np.bincount(mine, minlength=n)
        # untouched nodes that fitted at the start and that every feature
        # kept open; a feature's shared domains open the pod's own
        base = ~touched & _fits(w, start, t)
        shared = []
        for k, f in ledger.features.items():
            for dom, oa in f.open_terms(t, start.features[k],
                                        end.features[k]):
                if dom is None:
                    base &= oa
                else:
                    shared.append((dom, oa))
        s_open = node_score(w, plugins, _with(start, t))
        best = np.full(len(mine), low, np.int64)
        if not shared:
            if base.any():
                best[:] = int(s_open[base].max())
        else:
            keys = np.stack([dom[mine] for dom, _ in shared], axis=1)
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            for u, key in enumerate(uniq):
                m = base.copy()
                for (dom, oa), d in zip(shared, key):
                    m &= oa | (dom == d)
                if m.any():
                    best[np.ravel(inv) == u] = int(s_open[m].max())
        ub = np.full(n, low, np.int64)
        for j in range(1, int(mine_adds.max()) + 1):
            s = node_score(w, plugins, _with(start, t, j))
            ub = np.where(mine_adds >= j, np.maximum(ub, s), ub)
        # a node that received pods of other templates too: left out
        only = mine_adds[mine] == adds[mine]
        has = (best > low) & only
        if has.any():
            gap = max(gap, float((best[has] - ub[mine[has]]).max()))
    return wrong, gap


def check(ledger: Ledger, plugins: Sequence[Tuple[str, int]],
          cycles: Optional[Sequence[CycleRecord]] = None) -> dict:
    """The numbers compared over the given cycles (default: every cycle)."""
    wrong, gap, binds = 0, float("-inf"), 0
    for rec in (ledger.cycles if cycles is None else cycles):
        w, g = check_cycle(ledger, rec, plugins)
        wrong += w
        gap = max(gap, g)
        binds += len(rec.binds)
    return dict(wrong=wrong, score_gap=gap, binds=binds)


def verdict(numbers: dict, limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a score gap that has nothing to compare reads -inf."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = numbers[name]
        out[name] = dict(value=v if np.isfinite(v) else None, limit=limit)
        ok = ok and bool(v <= limit)
    return ok, out


CONTROLS = ("uniform", "feasible")


def control_binds(ledger: Ledger, rec: CycleRecord, names: Sequence[str],
                  rng: np.random.Generator, kind: str) -> None:
    """A control in the program's place.  ``uniform``: every pod of the
    cycle to a node drawn uniformly, with neither filter nor score (it
    breaks the fit and spread guarantees and the scoring).  ``feasible``:
    one pod after another to a node drawn uniformly from those that the
    filters (fit and every feature) let it take against the binds so far,
    scores ignored (it breaks the scoring guarantee alone)."""
    w = ledger.world
    if kind == "uniform":
        nodes = rng.integers(w.n_nodes, size=len(names))
        for name, node in zip(names, nodes):
            ledger.outcome(rec, name, True)
            ledger.bind(rec, name, int(node))
        return
    for name in names:
        t = ledger.template_of[name]
        ok = _fits(w, Usage(ledger.cpu, ledger.mem, ledger.pods, {}), t)
        for f in ledger.features.values():
            ok &= f.feasible(t)
        cand = np.flatnonzero(ok)
        ledger.outcome(rec, name, bool(len(cand)))
        if len(cand):
            ledger.bind(rec, name, int(cand[rng.integers(len(cand))]))


def control_run(world: World, seed: int, cycles: int,
                plugins: Sequence[Tuple[str, int]],
                kind: str = "uniform") -> dict:
    """The cell's closed loop for ``cycles`` cycles with a control in the
    program's place (each cycle takes the oldest batch of pending pods, as
    the scheduler's queue pops equal-priority pods), and the numbers the
    reference reads from it."""
    ledger = Ledger(world)
    loop = ClosedLoop(world, seed)
    rng = rng_of(seed, 2)
    pt = world.pending_template
    last = 0
    for _ in range(cycles):
        gone, new = loop.step(last)
        for name in gone:
            ledger.remove(name)
        for name in new:
            ledger.pending(name, pt.name)
        rec = ledger.begin_cycle()
        names = list(loop.pending)[:int(world.config["batch_size"])]
        control_binds(ledger, rec, names, rng, kind)
        ledger.end_cycle(rec)
        placed = [nm for nm, _ in rec.binds]
        for name in placed:
            loop.bound(name, pt.name)
        last = len(placed)
    return check(ledger, plugins)
