"""kube-scheduler's own unit-test tables through the port.

tests/test_goldens.py, test_goldens_plugins.py, test_goldens_filtering.py
and test_goldens_selectorspread.py hold 199 cases copied from the Go
sources, with literal expected scores and verdicts, run against the JAX
package through tests/harness.run_cluster.  Here every one of their
classes is subclassed under a new name, and an autouse fixture points each
module's run_cluster at tests/torch_port_util.port_run_cluster, which
converts the kubetpu.api objects to the port's types field by field,
tensorizes them with the port's builders and calls the port's
schedule_batch.  The helpers that get their result another way have port
twins here: the spread scorer's filtered-nodes table (filter_and_score
with host_ok), the DefaultPodTopologySpread tables' selector (the port's
ClusterStore), ServiceAffinity's Score/NormalizeScore (the port's host
plugin) and the extended-resource channel of the bin-packing table.  The
modules are imported whole, not their classes, so pytest collects their
JAX cases once.  The expected values are the Go tables' literals: exact,
nothing skipped.
"""
from typing import Dict, List

import numpy as np
import pytest
import torch

import kubetpu_torch.api.types as tapi
import tests.test_goldens as G
import tests.test_goldens_filtering as GF
import tests.test_goldens_plugins as GP
import tests.test_goldens_selectorspread as GS
from tests.torch_port_util import _port_world, port_run_cluster, to_port


def port_spread_scores(nodes, existing, pod, failed_names=()):
    """test_goldens.spread_scores through the port: the failed nodes are
    counted, not candidates (host_ok False)."""
    from kubetpu_torch.models import programs
    from kubetpu_torch.models.batch import PodBatchBuilder, batch_to_device
    sb, host, pinfos = _port_world(nodes, existing, [pod])
    cluster = host.to_device("cpu")
    batch = batch_to_device(PodBatchBuilder(sb.table).build(pinfos), "cpu")
    cfg = programs.ProgramConfig(
        filters=(), scores=(("PodTopologySpread", 1),),
        hostname_topokey=max(sb.table.topokey.get(tapi.LABEL_HOSTNAME), 0))
    host_ok = torch.ones((batch.valid.shape[0],
                          cluster.allocatable.shape[0]), dtype=torch.bool)
    for j, n in enumerate(nodes):
        if n.name in failed_names:
            host_ok[:, j] = False
    res = programs.filter_and_score(cluster, batch, cfg, host_ok=host_ok)
    s = res.plugin_scores["PodTopologySpread"].numpy()[0].astype(int)
    return [int(s[j]) for j, n in enumerate(nodes)
            if n.name not in failed_names]


def port_ds_scores(node_list, existing_pods, pod, objs=()):
    """test_goldens_selectorspread.ds_scores with the selector from the
    port's ClusterStore."""
    from kubetpu_torch.client.store import ClusterStore
    store = ClusterStore()
    for o in objs:
        store.add(to_port(o))
    by_node: Dict[str, List] = {}
    for p in existing_pods:
        by_node.setdefault(p.spec.node_name, []).append(p)
    sel = store.default_spread_selector(to_port(pod))
    res = port_run_cluster(node_list, by_node, [pod], filters=(),
                           scores=(("DefaultPodTopologySpread", 1),),
                           spread_selectors=[sel])
    return [int(s) for s in
            np.asarray(res.plugin_scores["DefaultPodTopologySpread"])[0]]


@pytest.fixture(autouse=True)
def through_the_port(monkeypatch):
    for mod in (G, GP, GF, GS):
        monkeypatch.setattr(mod, "run_cluster", port_run_cluster)
    monkeypatch.setattr(G, "spread_scores", port_spread_scores)
    monkeypatch.setattr(GS, "ds_scores", port_ds_scores)


# --- tests/test_goldens.py

class TestPortBalancedAllocationGolden(G.TestBalancedAllocationGolden):
    pass


class TestPortLeastAllocatedGolden(G.TestLeastAllocatedGolden):
    pass


class TestPortFitGolden(G.TestFitGolden):
    pass


class TestPortTaintTolerationScoreGolden(G.TestTaintTolerationScoreGolden):
    pass


class TestPortInterPodAffinityScoreGolden(
        G.TestInterPodAffinityScoreGolden):
    pass


class TestPortPodTopologySpreadScoreGolden(
        G.TestPodTopologySpreadScoreGolden):
    pass


# --- tests/test_goldens_plugins.py

class TestPortNodePortsGolden(GP.TestNodePortsGolden):
    pass


class TestPortNodeAffinityGolden(GP.TestNodeAffinityGolden):
    pass


class TestPortNodeAffinityPriorityGolden(GP.TestNodeAffinityPriorityGolden):
    pass


class TestPortMostAllocatedGolden(GP.TestMostAllocatedGolden):
    pass


class TestPortImageLocalityGolden(GP.TestImageLocalityGolden):
    pass


class TestPortRequestedToCapacityRatioGolden(
        GP.TestRequestedToCapacityRatioGolden):
    pass


class TestPortResourceBinPackingGolden(GP.TestResourceBinPackingGolden):
    @staticmethod
    def ext_res(table):
        from kubetpu_torch.state.tensors import N_FIXED_CHANNELS
        return ((2, N_FIXED_CHANNELS + table.rname.get("intel.com/foo"), 1),)


class TestPortServiceAffinityScoreGolden(GP.TestServiceAffinityScoreGolden):
    def run(self, pod, placed, labels, services, nodes=None):
        """The table's world in the port's store, scored through the
        port's ServiceAffinity (Score, then NormalizeScore)."""
        from kubetpu_torch.client.store import ClusterStore
        from kubetpu_torch.framework.interface import CycleState
        from kubetpu_torch.plugins.intree import ServiceAffinity
        nodes = nodes or self.ZONES
        store = ClusterStore()
        for name, nl in nodes.items():
            store.add(to_port(GP.mknode(name=name, labels=dict(nl))))
        for i, entry in enumerate(placed):
            node, pl = entry[0], entry[1]
            ns = entry[2] if len(entry) > 2 else "default"
            store.add(tapi.Pod(
                metadata=tapi.ObjectMeta(name=f"e{i}", namespace=ns,
                                         labels=dict(pl)),
                spec=tapi.PodSpec(containers=[], node_name=node)))
        for i, (sel, ns) in enumerate(services):
            store.add(tapi.Service(
                metadata=tapi.ObjectMeta(name=f"s{i}", namespace=ns),
                selector=dict(sel)))
        plugin = ServiceAffinity(
            store=store, args={"antiAffinityLabelsPreference": list(labels)})
        state = CycleState()
        tpod = to_port(pod)
        scores = []
        for name in nodes:
            s, st = plugin.score(state, tpod, name)
            assert st.is_success()
            scores.append((name, s))
        normalized, st = plugin.normalize_score(state, tpod, scores)
        assert st.is_success()
        return dict(normalized)


class TestPortTaintTolerationFilterGolden(GP.TestTaintTolerationFilterGolden):
    pass


class TestPortNodePreferAvoidPodsGolden(GP.TestNodePreferAvoidPodsGolden):
    pass


# --- tests/test_goldens_filtering.py

class TestPortRequiredAffinitySingleNode(GF.TestRequiredAffinitySingleNode):
    pass


class TestPortRequiredAffinityMultipleNodes(
        GF.TestRequiredAffinityMultipleNodes):
    pass


class TestPortSingleConstraintGolden(GF.TestSingleConstraintGolden):
    pass


class TestPortMultipleConstraintsGolden(GF.TestMultipleConstraintsGolden):
    pass


# --- tests/test_goldens_selectorspread.py

class TestPortDefaultPodTopologySpreadGolden(
        GS.TestDefaultPodTopologySpreadGolden):
    pass


class TestPortZoneSelectorSpreadGolden(GS.TestZoneSelectorSpreadGolden):
    pass


def test_every_table_case_runs_through_the_port():
    """The subclasses above cover every test of the four golden modules:
    199 cases, none left to the JAX package alone; and the fixture has
    pointed every module at the port."""
    assert all(mod.run_cluster is port_run_cluster for mod in (G, GP, GF, GS))
    assert G.spread_scores is port_spread_scores
    assert GS.ds_scores is port_ds_scores
    ported = {cls.__mro__[1] for cls in globals().values()
              if isinstance(cls, type) and cls.__name__.startswith("TestPort")}
    count = 0
    for mod in (G, GP, GF, GS):
        for name in dir(mod):
            cls = getattr(mod, name)
            if (isinstance(cls, type) and name.startswith("Test")
                    and cls.__module__ == mod.__name__):
                assert cls in ported, name
                count += sum(1 for m in dir(cls) if m.startswith("test_"))
    assert count == 199
