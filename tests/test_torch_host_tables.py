"""The JAX package's host-level test tables through the port, and node
updates against the JAX scheduler.

tests/test_queue.py, test_cache.py, test_scheduler.py, test_round3_fixes.py
and test_observability.py test the JAX package's queue, cache, Scheduler,
framework and serving surface.  Here each of their test functions runs
again with the names of its module rebound to the port's twins for the
length of the call (monkeypatch, restored afterwards): every module-level
object of ``kubetpu.<path>`` becomes the same-named object of
``kubetpu_torch.<path>``, a helper class built on a ``kubetpu`` base is
rebuilt on the port's base, and the ``kubetpu`` modules a test body
imports resolve to the port's.  The port's Scheduler is built with
``device="cpu"`` (the rebinding passes it; the port's default stays the
card).  The modules are imported whole, not their functions, so pytest
collects their JAX cases once.

Cases not run here, each with its twin:
- test_cache.py::test_fake_cache_hooks:
  tests/test_torch_debugger.py::test_fake_cache_hooks;
- test_observability.py::test_cache_comparer_detects_drift and
  ::test_cache_dumper: tests/test_torch_debugger.py::
  test_comparer_and_dumper_equal_jax (the comparer's drift and the
  dumper's text against the JAX package's);
- test_round3_fixes.py::test_extender_batch_does_not_oversubscribe:
  tests/test_torch_extender.py::test_extender_batch_does_not_oversubscribe.
test_observability.py::test_jax_profiler_capture runs as the port's
torch.profiler capture (utils/trace.capture_device_trace).

test_node_update_requeues_as_jax drives both packages' Schedulers on the
same store contents and events, with the queue on the FakeClock of
tests/torch_port_util.make_scheduler: a node update that changes nothing
the scheduler reads leaves the unschedulable pod parked, and each of the
four changes it reads (unschedulable, labels, taints, allocatable) moves
it to backoff (kubetpu/scheduler.py:432-436, :510-516).

test_host_api_matches_jax holds the host API the port had lacked (the
QueueSort comparison, CycleState.clone, QueuedPodInfo.deep_copy,
SchedulerCache.dump, profile_for and intern_labels) to the JAX package's on the same
inputs.
"""
import ast
import copy
import importlib
import inspect
import sys
import types

import pytest

import tests.test_cache as C
import tests.test_observability as O
import tests.test_queue as Q
import tests.test_round3_fixes as R3
import tests.test_scheduler as S
from tests.torch_port_util import make_scheduler, packages
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (Q, C, S, R3, O)}

# "module::case" -> its twin in the port's tests
TWINS = {
    "test_cache::test_fake_cache_hooks":
        "test_torch_debugger::test_fake_cache_hooks",
    "test_observability::test_cache_comparer_detects_drift":
        "test_torch_debugger::test_comparer_and_dumper_equal_jax",
    "test_observability::test_cache_dumper":
        "test_torch_debugger::test_comparer_and_dumper_equal_jax",
    "test_round3_fixes::test_extender_batch_does_not_oversubscribe":
        "test_torch_extender::test_extender_batch_does_not_oversubscribe",
}
# "module::case" -> why it cannot run through the port (none so far)
CANNOT_RUN = {}


def _cases():
    out = []
    for mname, mod in MODULES.items():
        for name, fn in vars(mod).items():
            if (name.startswith("test_") and inspect.isfunction(fn)
                    and fn.__module__ == mod.__name__):
                out.append(f"{mname}::{name}")
    return out


CASES = [c for c in _cases() if c not in TWINS and c not in CANNOT_RUN]


def _port_module(name: str) -> types.ModuleType:
    return importlib.import_module("kubetpu_torch" + name[len("kubetpu"):])


def _from_jax(name: str) -> bool:
    return name == "kubetpu" or name.startswith("kubetpu.")


def _cpu_scheduler():
    from kubetpu_torch.scheduler import Scheduler

    class CpuScheduler(Scheduler):
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)
    return CpuScheduler


def _twin(obj, mod):
    """The port's counterpart of a module-level object of a JAX test
    module (the object itself when it is not the JAX package's)."""
    if isinstance(obj, types.ModuleType):
        return _port_module(obj.__name__) if _from_jax(obj.__name__) else obj
    owner = getattr(obj, "__module__", None) or ""
    if _from_jax(owner):
        if owner == "kubetpu.scheduler" and obj.__name__ == "Scheduler":
            return _cpu_scheduler()
        return getattr(_port_module(owner), obj.__qualname__)
    if (inspect.isclass(obj) and owner == mod.__name__
            and any(_from_jax(b.__module__) for b in obj.__bases__)):
        body = {k: v for k, v in vars(obj).items()
                if k not in ("__dict__", "__weakref__")}
        return type(obj.__name__,
                    tuple(_twin(b, mod) for b in obj.__bases__), body)
    return obj


def _body_imports(fn):
    """The kubetpu modules a test body imports from."""
    tree = ast.parse(inspect.getsource(fn))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and _from_jax(node.module or ""):
            out.add(node.module)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names if _from_jax(a.name))
    return out


def _through_the_port(monkeypatch, mod, fn):
    for name, obj in list(vars(mod).items()):
        twin = _twin(obj, mod)
        if twin is not obj:
            monkeypatch.setattr(mod, name, twin)
    for name in _body_imports(fn):
        monkeypatch.setitem(sys.modules, name, _port_module(name))


@pytest.mark.parametrize("case", CASES)
def test_jax_host_case_through_the_port(case, monkeypatch, tmp_path):
    mname, name = case.split("::")
    mod = MODULES[mname]
    fn = getattr(mod, name)
    _through_the_port(monkeypatch, mod, fn)
    assert not any(isinstance(v, types.ModuleType) and _from_jax(v.__name__)
                   for v in vars(mod).values())
    params = inspect.signature(fn).parameters
    fn(**({"tmp_path": tmp_path} if "tmp_path" in params else {}))


def test_every_case_runs_or_is_listed():
    cases = set(_cases())
    assert set(TWINS) | set(CANNOT_RUN) <= cases
    assert len(cases) == 51
    for case, twin in TWINS.items():
        tmod, tname = twin.split("::")
        tree = ast.parse(inspect.getsource(importlib.import_module(
            "tests." + tmod)))
        assert tname in {n.name for n in tree.body
                         if isinstance(n, ast.FunctionDef)}, (case, twin)


def _annotate(A, node):
    node.metadata.annotations["node.alpha.kubernetes.io/heartbeat"] = "1"


def _unschedulable(A, node):
    node.spec.unschedulable = True


def _label(A, node):
    # a pair node-3 already carries: the label vocabulary keeps its width,
    # so the JAX scheduler compiles no second program
    node.metadata.labels["team"] = "infra"


def _taint(A, node):
    node.spec.taints.append(A.Taint(key="dedicated", value="infra"))


def _allocatable(A, node):
    node.status.allocatable["cpu"] = "128"


NODE_UPDATES = {"annotation": _annotate, "unschedulable": _unschedulable,
                "label": _label, "taint": _taint,
                "allocatable": _allocatable}


def _node_update_drive(pkg, change):
    store = pkg.store.ClusterStore()
    nodes = pkg.hollow.make_nodes(4)
    nodes[3].metadata.labels["team"] = "infra"
    for n in nodes:
        store.add(n)
    sched = make_scheduler(pkg, store, mode="gang", backend="lax",
                           disable_preemption=True)
    store.add(pkg.hollow.make_pod("big", cpu_milli=64000))
    first = sched.schedule_pending()
    parked = sched.queue.depths()
    node = copy.deepcopy(store.get_node("node-0"))
    NODE_UPDATES[change](pkg.api, node)
    store.update(node)
    moved = sched.queue.depths()
    # past the pod's first backoff (1 s), well inside the 60 s leftover
    # flush, so only a move sends it back to a cycle
    sched.queue._clock.t += 5.0
    sched.queue.flush_backoff_completed()
    nxt = sched.schedule_pending()
    sched.close()
    return dict(first=[(o.pod.metadata.name, o.node, o.err) for o in first],
                parked=parked, moved=moved,
                next=[(o.pod.metadata.name, o.node, o.err) for o in nxt])


@pytest.mark.parametrize("change", list(NODE_UPDATES))
def test_node_update_requeues_as_jax(change):
    jax_view, port_view = (_node_update_drive(pkg, change)
                           for pkg in packages())
    assert port_view == jax_view
    assert jax_view["parked"] == {"active": 0, "backoff": 0,
                                  "unschedulable": 1}
    if change == "annotation":
        assert port_view["moved"] == port_view["parked"]
        assert port_view["next"] == []
    else:
        assert port_view["moved"] == {"active": 0, "backoff": 1,
                                      "unschedulable": 0}
        assert len(port_view["next"]) == 1


# ---------------------------------------------------------------------------
# the host API ported in this slice, each against its JAX twin


def _queue_sort(P):
    Q = P.types.QueuedPodInfo
    pods = [P.hollow.make_pod(f"p{i}", priority=prio)
            for i, prio in enumerate((1, 10, 1, 10, 0))]
    qps = [Q(pod=p, timestamp=float(t)) for p, t in zip(pods, (3, 2, 1, 4, 0))]
    fwk = P.runtime.Framework(P.intree.new_in_tree_registry(),
                              P.conf.KubeSchedulerProfile())
    return [(fwk.queue_sort_less(a, b), P.intree.PrioritySort().less(a, b))
            for a in qps for b in qps]


def _cycle_state_clone(P):
    class Counter:
        def __init__(self, n):
            self.n = n

        def clone(self):
            return Counter(self.n)
    st = P.fw.CycleState()
    kept, shared = Counter(1), [1, 2]
    st.write("counter", kept)
    st.write("list", shared)
    c = st.clone()
    return (c.read("counter") is not kept, c.read("counter").n,
            c.read("list") is shared, sorted(c._data))


def _deep_copy(P):
    qp = P.types.QueuedPodInfo(pod=P.hollow.make_pod("p"), timestamp=5.0,
                               attempts=3, initial_attempt_timestamp=1.0,
                               scheduling_cycle=7, pop_timestamp=4.0,
                               slo_unres_observed=True)
    c = qp.deep_copy()
    return (c is not qp, c.pod is qp.pod, c.timestamp, c.attempts,
            c.initial_attempt_timestamp, c.scheduling_cycle,
            c.pop_timestamp, c.slo_unres_observed)


def _cache_dump(P):
    cache = P.cache.SchedulerCache()
    for n in P.hollow.make_nodes(3):
        cache.add_node(n)
    for i, node in enumerate(("node-0", "node-0", "node-2")):
        p = P.hollow.make_pod(f"p{i}")
        p.spec.node_name = node
        cache.add_pod(p)
    # uids from names: hollow's uid counter is process-wide per package
    assumed = P.hollow.make_pod("assumed")
    assumed.metadata.uid = "u-assumed"
    assumed.spec.node_name = "node-1"
    cache.assume_pod(assumed)
    doc = cache.dump()
    cache.close()
    gens = [doc["nodes"][n]["generation"] for n in sorted(doc["nodes"])]
    # generations come from a process-wide counter: compare their order
    return ({n: v["pods"] for n, v in doc["nodes"].items()},
            doc["assumed_pods"], sorted(range(3), key=gens.__getitem__))


def _profile_for(P):
    cfg = P.conf.KubeSchedulerConfiguration(profiles=[
        P.conf.KubeSchedulerProfile(),
        P.conf.KubeSchedulerProfile(scheduler_name="bin-packer")])
    return ([cfg.profile_for(n).scheduler_name
             for n in ("default-scheduler", "bin-packer")],
            cfg.profile_for("nobody"))


def _intern_labels(P):
    t = P.intern.InternTable()
    return [t.intern_labels(m) for m in ({"a": "1", "b": "2"}, {"b": "2"},
                                         {"a": "3", "c": "1"})]


HOST_API = {"queue_sort_less": _queue_sort,
            "cycle_state_clone": _cycle_state_clone,
            "queued_pod_info_deep_copy": _deep_copy,
            "scheduler_cache_dump": _cache_dump,
            "profile_for": _profile_for,
            "intern_labels": _intern_labels}


def _api(root):
    mods = dict(conf="apis.config", hollow="harness.hollow",
                fw="framework.interface", runtime="framework.runtime",
                types="framework.types", intree="plugins.intree",
                cache="state.cache", intern="utils.intern")
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in mods.items()})


@pytest.mark.parametrize("case", list(HOST_API))
def test_host_api_matches_jax(case):
    jax_out = HOST_API[case](_api("kubetpu"))
    port_out = HOST_API[case](_api("kubetpu_torch"))
    assert port_out == jax_out
