"""Pod topology spread: kube-scheduler v1.19's PodTopologySpread filter
(pkg/scheduler/framework/plugins/podtopologyspread/filtering.go).

The template's value is a list of constraints, each
``{"key": <node label key>, "max_skew": <int>, "when": "DoNotSchedule",
"match": {<label>: <value>, ...}}``.  A node may take the pod when, for
every constraint, the pods matching the selector in the node's domain, plus
one if the pod matches its own selector, less the fewest in any domain, is
at most ``max_skew``; a node without the key is not eligible.

The reference's part (``Ref``) counts the matching pods per domain of each
(key, selector).  Within a cycle the counts only grow (no pod departs
during a cycle: this file does not model preemption's victims), so a
domain's count in any round lies between its start and end counts and the
fewest lies at or above the start's fewest.  ``ScheduleAnyway`` changes
scores, which no score file here models: it is refused.
"""

import numpy as np

KEY = "spread"


def constraints(value):
    return [(c["key"], int(c["max_skew"]), c["when"],
             tuple(sorted(c["match"].items()))) for c in value or []]


def to_pod(pod, value, api):
    for key, skew, when, match in constraints(value):
        pod.spec.topology_spread_constraints.append(
            api.TopologySpreadConstraint(
                max_skew=skew, topology_key=key, when_unsatisfiable=when,
                label_selector=api.LabelSelector(match_labels=dict(match))))


class Ref:
    """Matching pods per domain of every (key, selector) the world's
    templates name."""

    def __init__(self, world):
        self.world = world
        self.sels = {}
        for t in world.templates.values():
            for key, _, when, match in constraints(t.feature(KEY)):
                if when != "DoNotSchedule":
                    raise ValueError("spread: only DoNotSchedule is "
                                     "checked (template %s)" % t.name)
                self.sels.setdefault((key, match), len(self.sels))
        self.dom = [world.domains(key) for key, _ in self.sels]
        self.counts = [np.zeros(n, np.int64) for _, n in self.dom]
        self._match = {}
        self._hard_of = {}

    def _matches(self, t):
        if t.name not in self._match:
            self._match[t.name] = [t.matches(m) for _, m in self.sels]
        return self._match[t.name]

    def _hard(self, t):
        """[(selector index, max_skew, self match)] of t's constraints."""
        if t.name not in self._hard_of:
            mine = self._matches(t)
            self._hard_of[t.name] = [
                (self.sels[(key, match)], skew, int(mine[self.sels[(key,
                                                                    match)]]))
                for key, skew, _, match in constraints(t.feature(KEY))]
        return self._hard_of[t.name]

    def place(self, t, node, sign):
        for i, m in enumerate(self._matches(t)):
            d = self.dom[i][0][node]
            if m and d >= 0:
                self.counts[i][d] += sign

    def snapshot(self):
        return [c.copy() for c in self.counts]

    def wrong(self, binds, start, end):
        """Domains that received a constrained, self-matching pod and end
        the cycle more than max_skew above the fewest: the last such pod
        placed there saw its domain at end - 1 and the fewest at most at
        the end's fewest."""
        bad = 0
        seen = {}
        for t, node in binds:
            for i, skew, selfm in self._hard(t):
                d = self.dom[i][0][node]
                if d < 0:
                    bad += 1
                elif selfm:
                    seen.setdefault((i, skew), set()).add(int(d))
        for (i, skew), doms in seen.items():
            cnt = end[i]
            bad += sum(1 for d in doms if cnt[d] - cnt.min() > skew)
        return bad

    def _fit(self, t, counts, low):
        mask = np.ones(self.world.n_nodes, bool)
        for i, skew, selfm in self._hard(t):
            dom = self.dom[i][0]
            mask &= (dom >= 0) & (counts[i][np.maximum(dom, 0)] + selfm
                                  - low[i] <= skew)
        return mask

    def end_fit(self, t, end):
        """Nodes the pod could still go to in the cycle's end state."""
        return self._fit(t, end, [c.min() for c in end])

    def open_terms(self, t, start, end):
        """[(domains or None, nodes open to t in every round)]: a node is
        open while its domain's end count, less the start's fewest, keeps
        the skew.  A pod's own domain was open in its own round, so the
        domains come along where they are shared by several nodes."""
        terms = []
        for i, skew, selfm in self._hard(t):
            dom, n = self.dom[i]
            oa = (dom >= 0) & (end[i][np.maximum(dom, 0)] + selfm
                               - start[i].min() <= skew)
            terms.append((None if n == self.world.n_nodes else dom, oa))
        return terms

    def feasible(self, t):
        """Nodes the filter lets t go to now (the control's placer)."""
        return self.end_fit(t, self.counts)
