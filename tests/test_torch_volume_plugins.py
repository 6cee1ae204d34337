"""The volume plugin family through the port (kubetpu_torch/plugins/
volumes.py).

tests/test_goldens_volumes.py (kube-scheduler's VolumeZone and
VolumeRestrictions tables, 18 cases) and tests/test_volume_limits.py (the
attach-limit tables and the PostFilter runner, 21 cases) run here
unchanged against the port: each of their classes is subclassed under a
new name, and an autouse fixture points every module-level name the two
modules resolve (the API types, the store, NodeInfo, CycleState, Status,
the plugins and the node and pod makers) at the port's.  The runner cases
build their Framework inside a helper that imports the JAX package, so
their subclass runs the same three cases through port twins of that
helper and of its three test plugins.  The expected verdicts are the
tables' literals.

Beside them, a differential test: on seeded worlds
(kubetpu_torch/harness/volume_worlds.py, built in both packages' API
types), every plugin's PreFilter and Filter Status — code and reasons —
per (pod, node) from the port equals the JAX package's.
"""
import pytest

import kubetpu.api.types as japi
import kubetpu.framework.types as jtypes
import kubetpu.plugins.volumes as jvol
import kubetpu_torch.api.types as tapi
import kubetpu_torch.client.store as tstore
import kubetpu_torch.framework.interface as tfw
import kubetpu_torch.framework.types as ttypes
import kubetpu_torch.plugins.volumes as tvol
import tests.test_goldens_volumes as GV
import tests.test_tensors as TT
import tests.test_volume_limits as VL
from kubetpu.client.store import ClusterStore as JStore
from kubetpu.framework.interface import CycleState as JCycleState
from kubetpu_torch.harness import volume_worlds as VW
from tests.torch_port_util import to_port


def port_mknode(*args, **kw):
    return to_port(TT.mknode(*args, **kw))


def port_mkpod(*args, **kw):
    return to_port(TT.mkpod(*args, **kw))


PORT_NAMES = dict(api=tapi, ClusterStore=tstore.ClusterStore,
                  Code=tfw.Code, CycleState=tfw.CycleState,
                  NodeInfo=ttypes.NodeInfo, volumes=tvol,
                  mknode=port_mknode)


@pytest.fixture(autouse=True)
def through_the_port(monkeypatch):
    for mod in (GV, VL):
        for name, value in PORT_NAMES.items():
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(VL, "mkpod", port_mkpod)
    monkeypatch.setattr(VL, "fw", tfw)
    monkeypatch.setattr(VL, "Status", tfw.Status)


# --- tests/test_goldens_volumes.py

class TestPortVolumeZoneGolden(GV.TestVolumeZoneGolden):
    pass


class TestPortVolumeZoneWithBindingGolden(
        GV.TestVolumeZoneWithBindingGolden):
    pass


class TestPortVolumeRestrictionsGolden(GV.TestVolumeRestrictionsGolden):
    pass


# --- tests/test_volume_limits.py

class TestPortEBSLimits(VL.TestEBSLimits):
    pass


class TestPortCinderLimits(VL.TestCinderLimits):
    pass


class TestPortAzureDiskLimits(VL.TestAzureDiskLimits):
    pass


class TestPortCSILimits(VL.TestCSILimits):
    pass


class _PortInfo(tfw.PostFilterPlugin):
    """VL._InfoPostFilter on the port's interface."""
    calls = []

    def name(self):
        return "Info"

    def post_filter(self, state, pod, filtered):
        self.calls.append("info")
        return None, tfw.Status.unschedulable("info ran")


class _PortNominating(tfw.PostFilterPlugin):
    def name(self):
        return "Nominator"

    def post_filter(self, state, pod, filtered):
        return tfw.PostFilterResult("node-x"), tfw.Status.success()


class _PortError(tfw.PostFilterPlugin):
    def name(self):
        return "Boom"

    def post_filter(self, state, pod, filtered):
        return None, tfw.Status.error("boom")


def _port_fwk_with(post_filters):
    """VL._fwk_with through the port: the same profile (only the given
    PostFilter plugins) on the port's Framework and registry."""
    from kubetpu_torch.apis.config import (KubeSchedulerProfile, Plugin,
                                           Plugins, PluginSet)
    from kubetpu_torch.framework.runtime import Framework
    from kubetpu_torch.plugins.intree import new_in_tree_registry
    insts = list(post_filters)
    registry = dict(new_in_tree_registry())
    for inst in insts:
        registry[inst.name()] = (
            lambda args=None, handle=None, _i=inst: _i)
    prof = KubeSchedulerProfile(plugins=Plugins(
        post_filter=PluginSet(
            enabled=[Plugin(name=i.name()) for i in insts],
            disabled=[Plugin(name="*")])))
    return Framework(registry, prof)


class TestPortPostFilterRunner(VL.TestPostFilterRunner):
    @pytest.fixture(autouse=True)
    def port_runner(self, monkeypatch):
        monkeypatch.setattr(VL, "_fwk_with", _port_fwk_with)
        monkeypatch.setattr(VL, "_InfoPostFilter", _PortInfo)
        monkeypatch.setattr(VL, "_NominatingPostFilter", _PortNominating)
        monkeypatch.setattr(VL, "_ErrorPostFilter", _PortError)


def test_every_volume_table_case_runs_through_the_port():
    """The subclasses above cover every test of the two modules: 39
    cases, none left to the JAX package alone."""
    ported = {cls.__mro__[1] for cls in globals().values()
              if isinstance(cls, type) and cls.__name__.startswith("TestPort")}
    count = 0
    for mod in (GV, VL):
        for name in dir(mod):
            cls = getattr(mod, name)
            if (isinstance(cls, type) and name.startswith("Test")
                    and cls.__module__ == mod.__name__):
                assert cls in ported, name
                count += sum(1 for m in dir(cls) if m.startswith("test_"))
    assert count == 39
    assert GV.volumes is tvol and VL.volumes is tvol


# --- per (pod, node) Status differential on seeded worlds

PLUGINS = ("VolumeBinding", "VolumeRestrictions", "VolumeZone",
           "NodeVolumeLimits", "EBSLimits", "GCEPDLimits",
           "AzureDiskLimits", "CinderLimits")


def _statuses(A, Store, NodeInfo, CycleState, vol, seed):
    w = VW.world(A, seed, n_nodes=8, n_pending=12, max_existing=3)
    store = Store()
    VW.populate(store, w)
    infos = VW.node_infos(NodeInfo, w)
    pods = w.pending + [p for n in w.nodes for p in w.existing[n.name]]
    out = []
    for name in PLUGINS:
        plugin = getattr(vol, name)(store)
        for pod in pods:
            rel = plugin.relevant(pod)
            row = [name, pod.metadata.name, rel]
            if name == "VolumeBinding":
                st = plugin.pre_filter(CycleState(), pod)
                row.append((int(st.code), list(st.reasons)))
            if rel:
                for ni in infos:
                    st = plugin.filter(CycleState(), pod, ni)
                    row.append((ni.node_name, int(st.code), list(st.reasons)))
            out.append(row)
    return out


@pytest.mark.parametrize("seed", range(12))
def test_plugin_statuses_match_reference(seed):
    want = _statuses(japi, JStore, jtypes.NodeInfo, JCycleState, jvol, seed)
    got = _statuses(tapi, tstore.ClusterStore, ttypes.NodeInfo,
                    tfw.CycleState, tvol, seed)
    assert got == want
    # the world exercises both verdicts of several plugins
    failing = {row[0] for row in got for cell in row[3:]
               if len(cell) == 3 and cell[1] != 0}
    assert len(failing) >= 2, failing
