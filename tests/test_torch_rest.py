"""The port's REST API server and reflector client
(kubetpu_torch/client/rest.py and client/codec.py, copies of the JAX
package's): twins of tests/test_rest.py — the codec round trip, CRUD,
binding and status subresources, watch continuity and relist, PVC binds
over the watch, and the port's Scheduler serving a cluster it only sees
through the wire."""
import time

import pytest

from kubetpu_torch.api import types as api
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                 KubeSchedulerProfile)
from kubetpu_torch.client import codec
from kubetpu_torch.client.rest import APIServer, RestClusterStore
from kubetpu_torch.client.store import ClusterStore, Conflict, NotFound
from kubetpu_torch.harness import hollow
from kubetpu_torch.scheduler import Scheduler
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture()
def server():
    store = ClusterStore()
    srv = APIServer(store)
    port = srv.start()
    yield store, f"http://127.0.0.1:{port}"
    srv.stop()


def wait_until(fn, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return False


def test_codec_roundtrip_pod():
    p = hollow.make_pod("p", labels={"app": "x"})
    hollow.with_anti_affinity(p, api.LABEL_HOSTNAME)
    hollow.with_spread(p, api.LABEL_ZONE, when="ScheduleAnyway")
    p.spec.tolerations = [api.Toleration(key="k", value="v",
                                         effect="NoSchedule")]
    doc = codec.to_doc(p)
    back = codec.decode("Pod", doc)
    assert codec.to_doc(back) == doc
    assert back.spec.affinity.pod_anti_affinity \
        .required_during_scheduling_ignored_during_execution[0] \
        .topology_key == api.LABEL_HOSTNAME


def test_rest_crud_and_subresources(server):
    store, url = server
    client = RestClusterStore(url)
    assert client.wait_for_cache_sync()
    client.add(hollow.make_node("n1"))
    assert wait_until(lambda: client.get_node("n1") is not None)
    assert store.get_node("n1") is not None      # reached the real store

    pod = hollow.make_pod("p1")
    client.add(pod)
    assert wait_until(lambda: client.get_pod("default", "p1") is not None)
    with pytest.raises(Conflict):
        client.add(hollow.make_pod("p1"))

    # binding subresource binds on the SERVER, visible through the watch
    client.bind(pod, "n1")
    assert wait_until(lambda: (client.get_pod("default", "p1") or pod)
                      .spec.node_name == "n1")
    assert store.get_pod("default", "p1").spec.node_name == "n1"
    with pytest.raises(Conflict):
        client.bind(pod, "n1")    # re-bind rejected (BindingREST rule)

    # status subresource
    client.update_pod_condition(
        pod, api.PodCondition(type=api.POD_SCHEDULED, status="False",
                              reason="Unschedulable", message="nope"),
        nominated_node_name="n1")
    assert wait_until(lambda: any(
        c.type == api.POD_SCHEDULED
        for c in (client.get_pod("default", "p1") or pod).status.conditions))

    client.delete(pod)
    assert wait_until(lambda: client.get_pod("default", "p1") is None)
    with pytest.raises(NotFound):
        client.delete(hollow.make_pod("ghost"))
    client.close()


def test_watch_replays_preexisting_state(server):
    store, url = server
    store.add(hollow.make_node("pre-node"))
    store.add(hollow.make_pod("pre-pod"))
    client = RestClusterStore(url)
    assert client.wait_for_cache_sync()
    assert client.get_node("pre-node") is not None
    assert client.get_pod("default", "pre-pod") is not None
    client.close()


def test_scheduler_serves_over_rest(server):
    """The aha case: the scheduler's only connection to the cluster is the
    HTTP API — informer-fed cache in, binding/status writes out
    (reference: the real deployment shape, scheduler <-> apiserver)."""
    store, url = server
    for n in hollow.make_nodes(3):
        store.add(n)
    client = RestClusterStore(url)
    assert client.wait_for_cache_sync()
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     batch_size=8, mode="gang",
                                     prewarm=False)
    sched = Scheduler(client, config=cfg, async_binding=False, device="cpu")
    for p in hollow.make_pods(5, group_labels=2):
        store.add(p)          # created by an external client
    # pods flow: server watch -> reflector -> scheduler queue
    assert wait_until(lambda: len(sched.queue.active_q) == 5)
    deadline = time.time() + 60
    scheduled = []
    while time.time() < deadline and len(scheduled) < 5:
        scheduled.extend(o for o in sched.schedule_pending(timeout=0.5)
                         if o.node)
    assert len(scheduled) == 5
    # the SERVER's store is the source of truth for the bindings
    assert wait_until(lambda: sum(
        1 for p in store.list("Pod") if p.spec.node_name) == 5)
    sched.close()
    client.close()


def test_watch_gap_triggers_relist(server):
    """Buffer eviction ("resourceVersion too old"): a watch response whose
    oldest retained seq is beyond the client's position forces a full
    RELIST instead of silently skipping the gap (reflector.go relist)."""
    store, url = server
    client = RestClusterStore(url)
    assert client.wait_for_cache_sync()
    added_behind_gap = hollow.make_node("gap-node")
    orig = client._req
    state = {"poisoned": False}

    def faked(method, path, doc=None, timeout=30.0):
        if path.startswith("/watch") and not state["poisoned"]:
            state["poisoned"] = True
            # the object appears on the server but its event is "evicted"
            store.add(added_behind_gap)
            return {"events": [], "oldest": 10 ** 9, "seq": 0}
        return orig(method, path, doc, timeout)

    client._req = faked
    # the swap races an in-flight long-poll (up to its 10 s timeout), so
    # allow a full poll cycle before the poisoned response can be served
    assert wait_until(lambda: client.get_node("gap-node") is not None,
                      timeout=30.0)
    client.close()


def test_pvc_binding_propagates_over_watch(server):
    """bind_pvc emits a PVC update event (store.py), so a REST mirror sees
    the binding and its PV assume-cache entry clears — two clients can
    never double-allocate a PV (review finding)."""
    store, url = server
    store.add(api.PersistentVolume(metadata=api.ObjectMeta(name="pv1")))
    store.add(api.PersistentVolumeClaim(
        metadata=api.ObjectMeta(name="c1")))
    client = RestClusterStore(url)
    assert client.wait_for_cache_sync()
    client.assume_pv_binding("pv1", "c1")
    assert client.pv_is_bound("pv1")          # assumed locally
    client.bind_pvc("default", "c1", "pv1", "node-x")
    assert wait_until(lambda: (client.get_pvc("default", "c1") or
                               api.PersistentVolumeClaim()).volume_name
                      == "pv1")
    # bound durably (via the mirror), not just assumed
    assert client.pv_is_bound("pv1")
    assert store.get_pvc("default", "c1").volume_name == "pv1"
    client.close()
