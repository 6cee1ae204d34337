"""tests/test_plugins_extra.py through both packages: the
RequestedToCapacityRatio, NodeResourceLimits and NodeLabel kernels and the
ServiceAffinity host plugin (reference: requested_to_capacity_ratio_test.go,
resource_limits_test.go, node_label_test.go, service_affinity_test.go).

Each case runs on the JAX package and on the port (CPU): the kernel cases
through tests/harness.run_cluster and its port twin, whose results must be
equal bit for bit; the scheduler cases through both Schedulers, whose
outcomes and pod conditions must agree; and the original's literal
expectations hold on the port.  The original's three HTTP-extender cases
are twinned in tests/test_torch_extender.py.
"""
import jax.numpy as jnp
import numpy as np
import torch

from kubetpu.harness import hollow as jhollow
from kubetpu.ops.kernels import broken_linear as jax_broken_linear
from kubetpu_torch.ops.kernels import broken_linear
from tests.harness import run_cluster
from tests.torch_port_util import (assert_same, framework_packages,
                                   new_scheduler, outcome_view,
                                   port_run_cluster)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

PACKAGES = framework_packages()


def run_both(*args, **kw):
    """run_cluster on both packages; every result field equal.  Returns
    the port's."""
    want = run_cluster(*args, **kw)
    got = port_run_cluster(*args, **kw)
    for f in ("feasible", "unresolvable", "scores", "chosen"):
        assert_same(getattr(want, f), getattr(got, f), f)
    assert want.plugin_scores.keys() == got.plugin_scores.keys()
    for k in want.plugin_scores:
        assert_same(want.plugin_scores[k], got.plugin_scores[k], k)
    return got


def test_requested_to_capacity_ratio_kernel():
    """Bin-packing shape {0: 0, 100: 10}: the fuller node scores
    higher (buildBrokenLinearFunction's integer math)."""
    nodes = [jhollow.make_node("empty", cpu_milli=1000, mem=1000 << 20),
             jhollow.make_node("half", cpu_milli=1000, mem=1000 << 20)]
    existing = {"half": [jhollow.make_pod("e", cpu_milli=500,
                                          mem=500 << 20)]}
    pod = jhollow.make_pod("p", cpu_milli=0, mem=0)
    pod.spec.containers[0].resources.requests = {}
    res = run_both(
        nodes, existing, [pod],
        filters=("NodeResourcesFit",),
        scores=(("RequestedToCapacityRatio", 1),),
        plugin_args=(("RequestedToCapacityRatio",
                      (((0, 0), (100, 10)),
                       ((0, 0, 1), (1, 0, 1)))),))
    s = res.plugin_scores["RequestedToCapacityRatio"][0]
    assert s[0] == 2.0
    assert s[1] == 7.0


def test_resource_limits_kernel():
    nodes = [jhollow.make_node("small", cpu_milli=500),
             jhollow.make_node("big", cpu_milli=8000)]
    pod = jhollow.make_pod("p", cpu_milli=100)
    pod.spec.containers[0].resources.limits = {"cpu": "4000m"}
    res = run_both(nodes, None, [pod], filters=("NodeResourcesFit",),
                   scores=(("NodeResourceLimits", 1),))
    s = res.plugin_scores["NodeResourceLimits"][0]
    assert s[0] == 0.0 and s[1] == 1.0


def test_node_label_filter_and_score():
    """A profile with the NodeLabel filter and score: node a fails the
    absent check, c the present check; b is chosen."""
    def scenario(P):
        C = P.conf
        store = P.store.ClusterStore()
        for n in (P.hollow.make_node("a", labels={"zone-ok": "y",
                                                  "bad": "x"}),
                  P.hollow.make_node("b", labels={"zone-ok": "y"}),
                  P.hollow.make_node("c")):
            store.add(n)
        sched = new_scheduler(P, store, profiles=[C.KubeSchedulerProfile(
            plugins=C.Plugins(
                filter=C.PluginSet(enabled=[C.Plugin("NodeLabel")]),
                score=C.PluginSet(enabled=[C.Plugin("NodeLabel", weight=1)],
                                  disabled=[C.Plugin("*")])),
            plugin_config={"NodeLabel": {
                "presentLabels": ["zone-ok"], "absentLabels": ["bad"],
                "presentLabelsPreference": ["zone-ok"]}})])
        store.add(P.hollow.make_pod("p"))
        out = sched.schedule_pending(timeout=0.0)
        sched.close()
        return outcome_view(store, out)
    jv, tv = (scenario(P) for P in PACKAGES)
    assert tv == jv
    assert tv["outcomes"] == [("p", "b", None)]


def test_service_affinity_host_plugin():
    """ServiceAffinity at PreFilter and Filter: the service's new pod must
    land on the rack of its anchor pod."""
    def scenario(P):
        C, A = P.conf, P.api
        store = P.store.ClusterStore()
        store.add(P.hollow.make_node("r1", labels={"rack": "r1"}))
        store.add(P.hollow.make_node("r2", labels={"rack": "r2"}))
        store.add(A.Service(metadata=A.ObjectMeta(name="svc"),
                            selector={"app": "s"}))
        anchor = P.hollow.make_pod("anchor", labels={"app": "s"})
        anchor.spec.node_name = "r2"
        store.add(anchor)
        sched = new_scheduler(P, store, profiles=[C.KubeSchedulerProfile(
            plugins=C.Plugins(
                pre_filter=C.PluginSet(enabled=[C.Plugin("ServiceAffinity")]),
                filter=C.PluginSet(enabled=[C.Plugin("ServiceAffinity")])),
            plugin_config={"ServiceAffinity": {"affinityLabels": ["rack"]}})])
        store.add(P.hollow.make_pod("member", labels={"app": "s"}))
        out = sched.schedule_pending(timeout=0.0)
        sched.close()
        return outcome_view(store, out)
    jv, tv = (scenario(P) for P in PACKAGES)
    assert tv == jv
    assert tv["outcomes"] == [("member", "r2", None)]


def test_broken_linear_truncates_toward_zero():
    """A falling segment's negative delta truncates toward zero, as Go's
    int64 division does: utilization 45 on {0: 10, 100: 0} is
    10 + trunc(-450 / 100) = 6, not 5."""
    shape = ((0, 10), (100, 0))
    p = [7.0, 33.0, 45.0, 100.0]
    got = broken_linear(torch.tensor(p), shape)
    assert_same(jax_broken_linear(jnp.array(p), shape), got, "broken_linear")
    assert got.tolist() == [10.0, 7.0, 6.0, 0.0]


def test_rtcr_unknown_resource_scores_like_zero_capacity():
    """A resource the cluster does not know has capacity 0
    (rawScoringFunction(maxUtilization)) in both kernels, given the
    kernel's unknown-channel argument directly."""
    nodes = [jhollow.make_node("n", cpu_milli=1000)]
    pod = jhollow.make_pod("p", cpu_milli=100)
    res = run_both(
        nodes, None, [pod], filters=("NodeResourcesFit",),
        scores=(("RequestedToCapacityRatio", 1),),
        plugin_args=(("RequestedToCapacityRatio",
                      (((0, 0), (100, 10)), ((2, -1, 1),))),))
    s = res.plugin_scores["RequestedToCapacityRatio"][0]
    assert s[0] == 10.0
    assert np.asarray(res.feasible).all()
