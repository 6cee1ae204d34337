"""tests/test_permit.py through both packages: co-scheduling via Permit,
timeout rejection, delete-rejects-waiting-pod, and a gang batch admitted
together (reference: test/integration/scheduler/framework_test.go:1442
TestCoSchedulingWithPermitPlugin and the Permit cases at :509-1632).

Each scenario runs on the JAX scheduler and on the port (CPU), both with
binding on the binder pool (async_binding=True, which a Wait needs).  Each
test makes the original's assertions on the port, and the packages must
agree on the outcomes, every pod's node and PodScheduled condition, and
the plugin's record of who waited and who acted.
"""
import time

from tests.torch_port_util import (framework_packages, new_scheduler,
                                   outcome_view)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

PACKAGES = framework_packages()
NAME = "TestPermit"


def coschedule_plugin(fw, handle, allow, timeout=10.0):
    """tests/test_permit.CoSchedPermitPlugin over interface module fw:
    the first pod to enter Permit waits; the second allows or rejects
    the waiter."""

    class CoSchedPermitPlugin(fw.PermitPlugin):
        def __init__(self):
            self.waiting_pod = ""
            self.acting_pod = ""
            self.num_calls = 0

        def name(self):
            return NAME

        def permit(self, state, pod, node_name):
            self.num_calls += 1
            waiting = []
            handle.iterate_over_waiting_pods(waiting.append)
            if not waiting:
                self.waiting_pod = pod.metadata.name
                return fw.Status(fw.Code.WAIT), timeout
            self.acting_pod = pod.metadata.name
            for wp in waiting:
                if allow:
                    wp.allow(NAME)
                else:
                    wp.reject("rejected by peer")
            if allow:
                return fw.Status.success(), 0.0
            return fw.Status.unschedulable("peer rejected"), 0.0

    return CoSchedPermitPlugin()


def permit_scheduler(P, store, allow, timeout=10.0, batch_size=1,
                     mode="sequential"):
    registry = dict(P.intree.new_in_tree_registry())
    instances = []

    def factory(args, handle):
        p = coschedule_plugin(P.fw, handle, allow, timeout)
        instances.append(p)
        return p

    registry[NAME] = factory
    C = P.conf
    sched = new_scheduler(
        P, store, registry=registry, async_binding=True,
        profiles=[C.KubeSchedulerProfile(plugins=C.Plugins(
            permit=C.PluginSet(enabled=[C.Plugin(NAME)])))],
        batch_size=batch_size, mode=mode)
    return sched, instances


def two_node_store(P):
    store = P.store.ClusterStore()
    for n in P.hollow.make_nodes(2):
        store.add(n)
    return store


def bound_names(store):
    return {p.metadata.name for p in store.list("Pod") if p.spec.node_name}


def both(scenario):
    """scenario(P) -> (view, extra) on both packages; they must agree.
    Returns the port's."""
    (jv, jx), (tv, tx) = (scenario(P) for P in PACKAGES)
    assert tv == jv
    assert tx == jx
    return tv, tx


def test_co_scheduling_wait_then_allow():
    """Pod A waits on permit, pod B allows it: both bind."""
    def scenario(P):
        store = two_node_store(P)
        sched, plugins = permit_scheduler(P, store, allow=True)
        store.add(P.hollow.make_pod("pod-a"))
        store.add(P.hollow.make_pod("pod-b"))
        out = sched.schedule_pending(timeout=0.5)
        out += sched.schedule_pending(timeout=0.5)
        sched.wait_for_inflight_binds()
        p = plugins[0]
        extra = (bound_names(store), p.num_calls,
                 {p.waiting_pod, p.acting_pod})
        sched.close()
        return outcome_view(store, out), extra
    view, (bound, calls, pair) = both(scenario)
    assert [bool(o[1]) for o in view["outcomes"]] == [True, True]
    assert bound == {"pod-a", "pod-b"}
    assert calls == 2 and pair == {"pod-a", "pod-b"}


def test_co_scheduling_wait_then_reject():
    """Pod B rejects waiting pod A and fails itself: neither binds, both
    report PodScheduled=False, and A's assume is rolled back."""
    def scenario(P):
        store = two_node_store(P)
        sched, _ = permit_scheduler(P, store, allow=False)
        store.add(P.hollow.make_pod("pod-a"))
        store.add(P.hollow.make_pod("pod-b"))
        out = sched.schedule_pending(timeout=0.5)
        out2 = sched.schedule_pending(timeout=0.5)
        sched.wait_for_inflight_binds()
        extra = (bound_names(store), dict(sched.cache.assumed_pods),
                 [bool(o.node) for o in out2])
        sched.close()
        return outcome_view(store, out + out2), extra
    view, (bound, assumed, second) = both(scenario)
    assert second == [False]
    assert bound == set() and not assumed
    for name, _, conds in view["pods"]:
        assert ("PodScheduled", "False") == conds[0][:2], name


def test_permit_timeout_rejects():
    """An unanswered Wait rejects at its deadline; the pod is forgotten."""
    def scenario(P):
        store = two_node_store(P)
        sched, _ = permit_scheduler(P, store, allow=True, timeout=0.3)
        store.add(P.hollow.make_pod("pod-a"))
        out = sched.schedule_pending(timeout=0.5)
        sched.wait_for_inflight_binds(timeout=5.0)
        extra = (bound_names(store), dict(sched.cache.assumed_pods))
        sched.close()
        return outcome_view(store, out), extra
    view, (bound, assumed) = both(scenario)
    assert len(view["outcomes"]) == 1 and view["outcomes"][0][1]
    assert bound == set() and not assumed
    (_, _, conds), = view["pods"]
    assert conds[0][:2] == ("PodScheduled", "False")
    assert "timeout" in conds[0][3]


def test_delete_rejects_waiting_pod():
    """Deleting a pending pod rejects its WaitingPod (eventhandlers:
    deletePodFromSchedulingQueue + RejectWaitingPod)."""
    def scenario(P):
        store = two_node_store(P)
        sched, _ = permit_scheduler(P, store, allow=True, timeout=30.0)
        pod = P.hollow.make_pod("pod-a")
        store.add(pod)
        out = sched.schedule_pending(timeout=0.5)
        fwk = next(iter(sched.profiles.values()))
        deadline = time.time() + 2.0
        while fwk.get_waiting_pod(pod.uid) is None and time.time() < deadline:
            time.sleep(0.01)
        waited = fwk.get_waiting_pod(pod.uid) is not None
        store.delete(pod)
        sched.wait_for_inflight_binds(timeout=5.0)
        extra = (waited, fwk.get_waiting_pod(pod.uid) is None,
                 bound_names(store), dict(sched.cache.assumed_pods))
        sched.close()
        return outcome_view(store, out), extra
    view, (waited, gone, bound, assumed) = both(scenario)
    assert len(view["outcomes"]) == 1 and view["outcomes"][0][1]
    assert waited and gone
    assert bound == set() and not assumed


def test_gang_batch_admitted_together():
    """Gang mode: the first pod of a batch waits, a later pod of the SAME
    batch allows it, and the whole gang binds."""
    def scenario(P):
        store = two_node_store(P)
        sched, plugins = permit_scheduler(P, store, allow=True,
                                          batch_size=2, mode="gang")
        store.add(P.hollow.make_pod("g-1"))
        store.add(P.hollow.make_pod("g-2"))
        out = sched.schedule_pending(timeout=0.5)
        sched.wait_for_inflight_binds()
        extra = (bound_names(store), plugins[0].num_calls)
        sched.close()
        return outcome_view(store, out), extra
    view, (bound, calls) = both(scenario)
    assert len(view["outcomes"]) == 2 and all(o[1] for o in view["outcomes"])
    assert bound == {"g-1", "g-2"} and calls == 2
