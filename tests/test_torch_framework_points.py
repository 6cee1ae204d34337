"""tests/test_framework_points.py through both packages.

One recording plugin registered at every extension point, with per-point
failure injection (reference: framework_test.go's *Plugin test doubles,
test/integration/scheduler/framework_test.go:509-1632), drives the real
serving path of the JAX scheduler and of the port (on the CPU).  Each
test makes the original's assertions on the port, and the two packages
must agree on the outcomes, every pod's node and PodScheduled condition,
and the recorded call sequence.
"""
from tests.torch_port_util import (framework_packages, new_scheduler,
                                   outcome_view)

PACKAGES = framework_packages()
POINTS = ("pre_filter", "filter", "post_filter", "score", "reserve",
          "pre_bind", "bind", "post_bind", "unreserve")


def recording_plugin(fw, calls, name, fail_at, score_map):
    """tests/test_framework_points.RecordingPlugin over the bases of
    interface module ``fw``, recording into ``calls``."""

    class RecordingPlugin(fw.PreFilterPlugin, fw.FilterPlugin,
                          fw.PostFilterPlugin, fw.ScorePlugin,
                          fw.ReservePlugin, fw.UnreservePlugin,
                          fw.PreBindPlugin, fw.BindPlugin,
                          fw.PostBindPlugin):
        def name(self):
            return name

        def _rec(self, point, pod, extra=None):
            calls.append((point, pod.metadata.name, extra))

        def pre_filter(self, state, pod):
            self._rec("PreFilter", pod)
            if fail_at == "PreFilter":
                return fw.Status.unschedulable("injected prefilter failure")
            return fw.Status.success()

        def filter(self, state, pod, node_info):
            self._rec("Filter", pod, node_info.node_name)
            if fail_at == "Filter":
                return fw.Status.unschedulable("injected filter failure")
            if fail_at == f"Filter:{node_info.node_name}":
                return fw.Status.unschedulable("injected per-node failure")
            return fw.Status.success()

        def post_filter(self, state, pod, filtered_node_status_map=None):
            self._rec("PostFilter", pod)
            return None, fw.Status.unschedulable("no preemption")

        def score(self, state, pod, node_name):
            self._rec("Score", pod, node_name)
            return score_map.get(node_name, 0), fw.Status.success()

        def score_extensions(self):
            outer = self

            class Ext:
                def normalize_score(self, state, pod, scores):
                    outer._rec("NormalizeScore", pod)
                    top = max(s for _, s in scores) or 1
                    return ([(n, s * fw.MAX_NODE_SCORE // top)
                             for n, s in scores], fw.Status.success())
            return Ext()

        def reserve(self, state, pod, node_name):
            self._rec("Reserve", pod, node_name)
            if fail_at == "Reserve":
                return fw.Status.error("injected reserve failure")
            return fw.Status.success()

        def unreserve(self, state, pod, node_name):
            self._rec("Unreserve", pod, node_name)

        def pre_bind(self, state, pod, node_name):
            self._rec("PreBind", pod, node_name)
            if fail_at == "PreBind":
                return fw.Status.error("injected prebind failure")
            return fw.Status.success()

        def bind(self, state, pod, node_name):
            self._rec("Bind", pod, node_name)
            if fail_at == "Bind":
                return fw.Status.error("injected bind failure")
            return fw.Status(fw.Code.SKIP)

        def post_bind(self, state, pod, node_name):
            self._rec("PostBind", pod, node_name)

    return RecordingPlugin()


def run(P, n_nodes=2, fail_at=None, score_map=None, name="TestPoints"):
    """The original's build_sched + one pod + one cycle in package P:
    (view, calls, store)."""
    calls = []
    store = P.store.ClusterStore()
    for n in P.hollow.make_nodes(n_nodes):
        store.add(n)
    registry = dict(P.intree.new_in_tree_registry())
    registry[name] = lambda args, handle: recording_plugin(
        P.fw, calls, name, fail_at, score_map or {})
    C = P.conf
    sets = {p: C.PluginSet(enabled=[C.Plugin(name)]) for p in POINTS}
    sets["bind"] = C.PluginSet(enabled=[C.Plugin(name),
                                        C.Plugin("DefaultBinder")],
                               disabled=[C.Plugin("*")])
    sched = new_scheduler(
        P, store, registry=registry, profiles=[C.KubeSchedulerProfile(
            plugins=C.Plugins(**sets))], batch_size=8, mode="gang")
    store.add(P.hollow.make_pod("pod-a"))
    out = sched.schedule_pending(timeout=0.2)
    sched.close()
    return outcome_view(store, out), calls, store


def both(**kw):
    """The scenario on both packages; they must agree.  Returns the
    port's (view, points called for pod-a, store)."""
    (jv, jc, _), (tv, tc, store) = (run(P, **kw) for P in PACKAGES)
    assert tv == jv
    assert tc == jc
    return tv, [p for p, pod, _ in tc if pod == "pod-a"], store


def test_success_path_invokes_points_in_order():
    view, seq, _ = both()
    assert len(view["outcomes"]) == 1 and view["outcomes"][0][1]
    for a, b in [("PreFilter", "Filter"), ("Filter", "Score"),
                 ("Score", "NormalizeScore"), ("NormalizeScore", "Reserve"),
                 ("Reserve", "PreBind"), ("PreBind", "Bind"),
                 ("Bind", "PostBind")]:
        assert seq.index(a) < seq.index(b), seq
    assert "Unreserve" not in seq
    assert "PostFilter" not in seq


def test_score_steers_placement():
    view, seq, _ = both(score_map={"node-0": 1, "node-1": 100})
    assert view["outcomes"][0][1] == "node-1"
    assert "NormalizeScore" in seq


def test_prefilter_failure_skips_everything_else():
    view, seq, _ = both(fail_at="PreFilter")
    assert len(view["outcomes"]) == 1 and not view["outcomes"][0][1]
    assert "injected prefilter failure" in (view["outcomes"][0][2] or "")
    assert seq.count("PreFilter") == 1
    assert "Filter" not in seq and "Reserve" not in seq


def test_filter_failure_fails_pod_and_runs_postfilter():
    view, seq, _ = both(fail_at="Filter")
    assert len(view["outcomes"]) == 1 and not view["outcomes"][0][1]
    assert "Filter" in seq
    assert "PostFilter" in seq
    assert "Reserve" not in seq


def test_per_node_filter_steers_placement():
    view, _, _ = both(fail_at="Filter:node-0")
    assert view["outcomes"][0][1] == "node-1"


def test_reserve_failure_unreserves_and_fails():
    view, seq, _ = both(fail_at="Reserve")
    assert len(view["outcomes"]) == 1 and not view["outcomes"][0][1]
    assert "Reserve" in seq and "Unreserve" in seq
    assert seq.index("Reserve") < seq.index("Unreserve")
    assert "PreBind" not in seq and "Bind" not in seq
    assert "PostFilter" not in seq


def test_prebind_failure_unreserves_and_forgets():
    view, seq, store = both(fail_at="PreBind")
    assert len(view["outcomes"]) == 1 and not view["outcomes"][0][1]
    assert "PreBind" in seq and "Unreserve" in seq
    assert "Bind" not in seq and "PostBind" not in seq
    assert store.get_pod("default", "pod-a").spec.node_name == ""


def test_bind_failure_unreserves():
    view, seq, _ = both(fail_at="Bind")
    assert len(view["outcomes"]) == 1 and not view["outcomes"][0][1]
    assert "Bind" in seq and "Unreserve" in seq
    assert "PostBind" not in seq


def test_bind_skip_falls_through_to_default_binder():
    view, seq, store = both()
    node = view["outcomes"][0][1]
    assert node
    assert store.get_pod("default", "pod-a").spec.node_name == node
    assert "PostBind" in seq
