"""The port's HTTP extenders (kubetpu_torch/extender.py and the Scheduler's
extender path) on the CPU: twins of tests/test_plugins_extra.py's three
extender cases and tests/test_round3_fixes.py's oversubscription case,
and drains of a seeded world through the JAX package's scheduler and the
port's with the same fake extender (kubetpu_torch/harness/
extender_worlds.py: filter, prioritize, bind and preempt verbs), in both
modes.  The JAX drains run in a spawned child (torch_port_util.
jax_process), which serves its own extender."""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import extender_worlds as EW
from kubetpu_torch.harness import hollow
from kubetpu_torch.scheduler import Scheduler
from tests.torch_port_util import FakeClock, jax_process, spy_deletes
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

CHILD_TIMEOUT = 600.0


# ---------------------------------------- tests/test_plugins_extra.py twins


class _FakeExtender(BaseHTTPRequestHandler):
    store = None

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers["Content-Length"])).decode())
        if self.path.endswith("/filter"):
            names = [n for n in body["NodeNames"] if not n.endswith("-0")]
            out = {"NodeNames": names, "FailedNodes": {}}
        elif self.path.endswith("/prioritize"):
            # strongly prefer the last node
            out = [{"Host": n,
                    "Score": 10 if n == body["NodeNames"][-1] else 0}
                   for n in body["NodeNames"]]
        elif self.path.endswith("/bind"):
            pod = self.store.get_pod(body["PodNamespace"], body["PodName"])
            self.store.bind(pod, body["Node"])
            out = {}
        else:
            out = {"Error": f"unknown verb {self.path}"}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _sched(store, extenders, **kw):
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     extenders=extenders, **kw)
    return Scheduler(store, config=cfg, device="cpu")


def test_http_extender_filter_prioritize_bind():
    store = ClusterStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    _FakeExtender.store = store
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _FakeExtender)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        sched = _sched(store, [{"urlPrefix": f"http://127.0.0.1:{port}",
                                "filterVerb": "filter",
                                "prioritizeVerb": "prioritize",
                                "bindVerb": "bind", "weight": 1}])
        store.add(hollow.make_pod("p"))
        out = sched.schedule_pending(timeout=0.0)
        assert len(out) == 1 and out[0].err is None
        # the extender filtered node-0 out and boosted the last candidate
        assert out[0].node == "node-2"
        assert store.get_pod("default", "p").spec.node_name == "node-2"
        d = sched.decisions.get("p")
        assert d.extenders == {f"http://127.0.0.1:{port}":
                               "filter 3 -> 2 nodes"}
        sched.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_extender_error_fails_pod():
    store = ClusterStore()
    store.add(hollow.make_node("n1"))
    sched = _sched(store, [{"urlPrefix": "http://127.0.0.1:1",  # nothing
                            "filterVerb": "filter"}])         # listens
    store.add(hollow.make_pod("p"))
    out = sched.schedule_pending(timeout=0.0)
    assert out[0].err is not None and "extender" in out[0].err
    assert out[0].err.startswith("extender filter failed: ")
    # the pod is requeued, never bound
    assert len(sched.queue) == 1
    assert store.get_pod("default", "p").spec.node_name == ""
    sched.close()


def test_ignorable_extender_error_tolerated():
    store = ClusterStore()
    store.add(hollow.make_node("n1"))
    sched = _sched(store, [{"urlPrefix": "http://127.0.0.1:1",
                            "filterVerb": "filter", "ignorable": True}])
    store.add(hollow.make_pod("p"))
    out = sched.schedule_pending(timeout=0.0)
    assert out[0].err is None and out[0].node == "n1"
    sched.close()


# ------------------------------------------ tests/test_round3_fixes.py twin


def test_extender_batch_does_not_oversubscribe():
    """The extender path commits pods on the host against a pre-batch
    device mask; the live fit re-check must stop two pods of one batch
    from oversubscribing a node."""
    store = ClusterStore()
    store.add(hollow.make_node("n1", cpu_milli=2000))
    # an extender not interested in these pods: the extender path with
    # no HTTP round trip
    sched = _sched(store, [{"urlPrefix": "http://127.0.0.1:1",
                            "filterVerb": "filter",
                            "managedResources": ["example.com/fpga"]}])
    for name in ("big-a", "big-b"):
        store.add(hollow.make_pod(name, cpu_milli=1500, priority=0))
    qpods = sched.queue.pop_batch(10)
    assert len(qpods) == 2
    sched._settled = set()
    outcomes = sched._schedule_group(sched.profiles["default-scheduler"],
                                     qpods)
    bound = [o for o in outcomes if o.node]
    assert len(bound) == 1, [(o.pod.metadata.name, o.node, o.err)
                             for o in outcomes]
    assert sum(1500 for o in bound) <= 2000
    sched.close()


def test_extender_pops_one_pod_and_skips_the_pipeline():
    """With an extender configured, a cycle pops one pod (the
    reference's scheduleOne), and a pipelined gang configuration runs
    the synchronous path."""
    store = ClusterStore()
    for n in hollow.make_nodes(2):
        store.add(n)
    sched = _sched(store, [{"urlPrefix": "http://127.0.0.1:1",
                            "filterVerb": "filter",
                            "managedResources": ["example.com/fpga"]}],
                   mode="gang", chain_cycles=True, pipeline_cycles=True,
                   batch_size=8)
    for p in hollow.make_pods(3):
        store.add(p)
    for i in range(3):
        out = sched.schedule_pending(timeout=0.0)
        assert len(out) == 1 and out[0].node
        assert sched.cycle_count == i + 1
    assert sched._pipeline.ring.high_water == 0
    sched.close()


# ------------------------------------- drains against the JAX scheduler


def _package(name):
    if name == "jax":
        import kubetpu.api.types as A
        import kubetpu.apis.config as conf
        import kubetpu.client.store as store
        import kubetpu.scheduler as sched
        import kubetpu.utils.metrics as metrics
        return SimpleNamespace(name=name, api=A, conf=conf, store=store,
                               sched=sched, metrics=metrics)
    import kubetpu_torch.api.types as A
    import kubetpu_torch.apis.config as conf
    import kubetpu_torch.client.store as store
    import kubetpu_torch.scheduler as sched
    import kubetpu_torch.utils.metrics as metrics
    return SimpleNamespace(name=name, api=A, conf=conf, store=store,
                           sched=sched, metrics=metrics)


ROUNDS = 4


def extender_drain(name, mode, seed=0):
    """The seeded extender world drained through package ``name``'s
    scheduler ("jax" or "port", the port's on the CPU) with a FakeExtender
    serving every verb: ROUNDS rounds, each advancing the queue's clock
    past every backoff and the unschedulable leftover timeout and then
    scheduling until the active queue is empty.  Returns what the drain
    left, with the extender's URL written as "EXT"."""
    P = _package(name)
    store = P.store.ClusterStore()
    nodes, bound, pending = EW.world(P.api, seed)
    EW.populate(store, nodes, bound)
    deleted = spy_deletes(store)
    metrics = P.metrics.SchedulerMetrics()
    outcomes = []
    with EW.FakeExtender(store) as ext:
        cfg = P.conf.KubeSchedulerConfiguration(
            profiles=[P.conf.KubeSchedulerProfile()], mode=mode,
            batch_size=16, extenders=[ext.config()])
        if name == "jax":
            cfg.prewarm = False
            sched = P.sched.Scheduler(store, config=cfg,
                                      async_binding=False, metrics=metrics)
        else:
            sched = P.sched.Scheduler(store, config=cfg, device="cpu",
                                      metrics=metrics)
        sched.queue._clock = FakeClock()
        try:
            for p in pending:
                store.add(p)
            for _ in range(ROUNDS):
                sched.queue._clock.t += 100.0
                sched.queue.flush_backoff_completed()
                sched.queue.flush_unschedulable_leftover()
                while sched.queue.depths()["active"]:
                    outcomes += [(o.pod.metadata.name, o.node, o.err)
                                 for o in sched.schedule_pending(timeout=0.0)]
                if not len(sched.queue):
                    break
        finally:
            sched.close()
        url = ext.url
        calls = dict(ext.calls)

    def unurl(d):
        return {k.replace(url, "EXT"): v for k, v in d.items()}
    decisions = [(d.name, d.outcome, d.node, d.nominated_node, d.message,
                  d.n_feasible, unurl(d.extenders))
                 for d in sched.decisions.recent(10 ** 6)]
    pods = sorted((p.metadata.name, p.spec.node_name,
                   p.status.nominated_node_name)
                  for p in store.list("Pod"))
    events = [(e.metadata.name, e.type, e.reason, e.involved_kind,
               e.involved_name, e.message, e.count)
              for e in store.list("Event")]
    m = metrics
    return dict(outcomes=outcomes, deleted=list(deleted), pods=pods,
                decisions=decisions, events=events, calls=calls,
                cycles=sched.cycle_count,
                attempts=m.preemption_attempts.value(),
                victims=(m.preemption_victims.count(),
                         m.preemption_victims.sum()))


def _jax_extender_drain(mode):
    """The JAX package's drain (run in the spawned child)."""
    import jax
    try:
        return extender_drain("jax", mode)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_extender_drain_matches_jax(mode, jax_proc):
    """32 nodes with bound fillers, 200 pending pods (a fifth of them
    preemptors), the fake extender serving filter, prioritize, bind and
    preempt: the same outcomes in the same order, the same victims in
    order, the same nominations and placements, the same PodDecisions
    (their extenders maps included), Events and preemption metrics, and
    the same extender round trips."""
    fut = jax_proc.submit(_jax_extender_drain, mode)
    got = extender_drain("port", mode)
    want = fut.result(timeout=CHILD_TIMEOUT)
    # the world exercised every verb: extender-filtered placements,
    # evictions the preempt verb narrowed, and extender binds
    assert got["calls"]["preempt"] > 0 and got["deleted"]
    assert all(EW.node_index(n) % 4 for name, n, _ in got["pods"]
               if n and name[0] in "sq")
    assert got["calls"]["bind"] == sum(1 for _, n, _ in got["outcomes"]
                                       if n)
    assert len(got["outcomes"]) >= 200
    for key in ("outcomes", "deleted", "pods", "decisions", "events",
                "calls", "cycles", "attempts", "victims"):
        assert got[key] == want[key], key
