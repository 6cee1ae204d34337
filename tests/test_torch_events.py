"""The port's event recorder (kubetpu_torch/utils/events.py) and its
wiring into the Scheduler and preemption, on the CPU: a twin of
tests/test_observability.py's aggregation case, the broadcaster against
the JAX package's on the same event sequences, and drains whose Event
objects (name, reason, involved object, message, count) and metrics
scrape equal the JAX scheduler's after the same drain.  The JAX drains
run in a spawned child (torch_port_util.jax_process)."""
import random
import time

import pytest

from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.rest import APIServer, RestClusterStore
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.harness import preempt_worlds as PW
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.utils.events import EventBroadcaster
from tests.torch_port_util import (drive, jax_process, metrics_scrape,
                                   packages)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

CHILD_TIMEOUT = 600.0


def event_view(store):
    """Every Event of ``store`` in its order: name, type, reason,
    involved kind/namespace/name, message, count."""
    return [(e.metadata.name, e.metadata.namespace, e.type, e.reason,
             e.involved_kind, e.involved_namespace, e.involved_name,
             e.message, e.count)
            for e in store.list("Event")]


# -------------------------------------- tests/test_observability.py twin


def test_event_broadcaster_aggregates_and_sinks():
    """Repeats inside the aggregation window bump count on ONE Event;
    distinct reasons make new objects; the scheduler records Scheduled
    events by default."""
    now = [1000.0]
    store = ClusterStore()
    b = EventBroadcaster(sink=store, clock=lambda: now[0])
    rec = b.new_recorder("test")
    pod = hollow.make_pod("p1")
    rec.event(pod, "Warning", "FailedScheduling", "0/3 nodes")
    rec.event(pod, "Warning", "FailedScheduling", "0/3 nodes again")
    now[0] += 5
    rec.event(pod, "Warning", "FailedScheduling", "still failing")
    evs = store.list("Event")
    assert len(evs) == 1
    assert evs[0].count == 3
    assert evs[0].message == "still failing"
    rec.event(pod, "Normal", "Scheduled", "bound")
    assert len(store.list("Event")) == 2
    # outside the window: a fresh Event object
    now[0] += 700
    rec.event(pod, "Warning", "FailedScheduling", "later")
    assert len([e for e in store.list("Event")
                if e.reason == "FailedScheduling"]) == 2

    # the serving path records by default
    store2 = ClusterStore()
    store2.add(hollow.make_node("n1"))
    sched = Scheduler(store2, device="cpu")
    store2.add(hollow.make_pod("p"))
    out = sched.schedule_pending(timeout=0.0)
    assert out[0].err is None
    evs = store2.list("Event")
    assert [(e.reason, e.involved_name, e.message) for e in evs] == [
        ("Scheduled", "p", "Successfully assigned default/p to n1")]
    sched.close()


def test_falsy_recorder_records_nothing():
    """A falsy recorder turns the Events off, as in the JAX scheduler."""
    store = ClusterStore()
    store.add(hollow.make_node("n1"))
    sched = Scheduler(store, device="cpu", recorder=False)
    assert sched.recorder is None
    store.add(hollow.make_pod("p"))
    store.add(hollow.make_pod("huge", cpu_milli=10 ** 6))
    out = sched.schedule_pending(timeout=0.0)
    assert sorted(bool(o.node) for o in out) == [False, True]
    assert store.list("Event") == []
    sched.close()


# ---------------------------------- the broadcaster against the JAX one


def _feed(events_mod, hollow_mod, store_mod, seed, window, max_entries):
    """A seeded sequence of recordings on package's broadcaster with a
    fake clock: the sink's Events, the watcher's snapshots and the
    structured log lines."""
    r = random.Random(seed)
    now = [1000.0]
    store = store_mod.ClusterStore()
    b = events_mod.EventBroadcaster(sink=store, clock=lambda: now[0],
                                    window=window, max_entries=max_entries)
    seen, lines = [], []
    b.watch(lambda ev: seen.append((ev.metadata.name, ev.reason, ev.count,
                                    ev.message)))
    b.start_structured_logging(lines.append)
    pods = [hollow_mod.make_pod(f"p{i}") for i in range(5)]
    recs = [b.new_recorder("default-scheduler"), b.new_recorder("other")]
    for k in range(200):
        now[0] += r.choice((0.0, 1.0, 7.0, 40.0))
        r.choice(recs).event(r.choice(pods), r.choice(("Normal", "Warning")),
                             r.choice(("Scheduled", "FailedScheduling",
                                       "Preempted")), f"m{k}")
    evs = [(e.metadata.name, e.metadata.namespace, e.involved_name,
            e.type, e.reason, e.message, e.count, e.first_timestamp,
            e.last_timestamp) for e in store.list("Event")]
    return evs, seen, lines


@pytest.mark.parametrize("seed,window,max_entries", [
    (0, 600.0, 4096), (1, 10.0, 4096), (2, 600.0, 3), (3, 45.0, 2)])
def test_broadcaster_matches_jax(seed, window, max_entries):
    """The same recordings through both packages' broadcasters (the
    aggregation window and the LRU bound as given): the same Event
    objects, counts, messages and timestamps, the same watcher snapshots
    and the same log lines."""
    import kubetpu.client.store as jstore
    import kubetpu.harness.hollow as jhollow
    import kubetpu.utils.events as jevents
    import kubetpu_torch.client.store as tstore
    import kubetpu_torch.utils.events as tevents
    want = _feed(jevents, jhollow, jstore, seed, window, max_entries)
    got = _feed(tevents, hollow, tstore, seed, window, max_entries)
    assert got == want
    assert len(got[0]) > 1 and any(e[6] > 1 for e in got[0])


# --------------------------------------------- drains against the JAX one


def events_drive(name, mode, seed=11):
    """A seeded preemption world (16 nodes, 24 preemptors, parked
    nominations) through package ``name``'s scheduler with the first
    four binds failing on the chaos registry's "bind" point (two retries
    each: one pod fails its bind, one binds on a retry): the Events, the
    metrics scrape and the bound pods."""
    jpkg, tpkg = packages()
    pkg = jpkg if name == "jax" else tpkg
    if name == "jax":
        from kubetpu.utils import chaos
        from kubetpu.utils.metrics import SchedulerMetrics
    else:
        from kubetpu_torch.utils import chaos
        from kubetpu_torch.utils.metrics import SchedulerMetrics
    metrics = SchedulerMetrics()

    def scenario(A, H, store, sched):
        w = PW.world(A, seed, 16, 24)
        PW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        for p in w.pending:
            store.add(p)
        yield

    chaos.arm(chaos.parse_spec("seed=5,bind:error:n=4"))
    try:
        views, sched = drive(pkg, scenario, mode=mode, batch=8,
                             metrics=metrics, bind_retries=2,
                             pod_initial_backoff_seconds=0.01,
                             pod_max_backoff_seconds=0.05)
        fired = chaos.active().counts()
    finally:
        chaos.disarm()
    return dict(events=event_view(sched.store), views=views,
                scrape=metrics_scrape(metrics), fired=fired)


def _jax_events_drive(mode):
    import jax
    try:
        return events_drive("jax", mode)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_drain_events_match_jax(mode, jax_proc):
    """The same drain through both schedulers, binding in the cycle: the
    store holds the same Events (Scheduled, FailedScheduling, Preempted
    per victim, BindRetried) in the same order, with the same names,
    messages and counts; and the metrics scrape is the same (preemption
    attempts and victims, per-point duration counts by point and status,
    bind-retry recoveries, injected faults)."""
    fut = jax_proc.submit(_jax_events_drive, mode)
    got = events_drive("port", mode)
    want = fut.result(timeout=CHILD_TIMEOUT)
    assert got["fired"] == want["fired"] == {"bind": 4}
    reasons = {e[3] for e in got["events"]}
    assert reasons == {"Scheduled", "FailedScheduling", "Preempted",
                       "BindRetried"}, reasons
    assert got["events"] == want["events"]
    assert got["views"] == want["views"]
    s = got["scrape"]
    assert s["scheduler_preemption_attempts_total"] > 0
    assert s["scheduler_preemption_victims_count"] > 0
    assert s['scheduler_recoveries_total{kind="bind-retry"}'] == 1
    assert got["scrape"] == want["scrape"]


# --------------------------------------------------------------- REST


def test_rest_scheduler_events_reach_api_server():
    """A REST-backed scheduler's Events reach the API server's store
    (the codec serves the Event kind) and come back through the watch."""
    store = ClusterStore()
    srv = APIServer(store)
    port = srv.start()
    client = RestClusterStore(f"http://127.0.0.1:{port}")
    try:
        assert client.wait_for_cache_sync(5.0)
        store.add(hollow.make_node("n1"))
        sched = Scheduler(client, config=KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()]), device="cpu")
        store.add(hollow.make_pod("p"))
        store.add(hollow.make_pod("huge", cpu_milli=10 ** 6))
        deadline = time.time() + 10.0
        out = []
        while len(out) < 2 and time.time() < deadline:
            out += sched.schedule_pending(timeout=0.2)
        assert sorted((o.pod.metadata.name, o.node) for o in out) == [
            ("huge", ""), ("p", "n1")]
        want = [("Normal", "Scheduled", "p"),
                ("Warning", "FailedScheduling", "huge")]
        assert sorted((e.type, e.reason, e.involved_name)
                      for e in store.list("Event")) == want
        while time.time() < deadline and len(client.list("Event")) < 2:
            time.sleep(0.02)
        assert sorted((e.type, e.reason, e.involved_name)
                      for e in client.list("Event")) == want
        sched.close()
    finally:
        client.close()
        srv.stop()
