"""The volume family's [B, N] device mask through the port
(kubetpu_torch/state/volumes.py).

The first four tests of tests/test_volume_mask.py run here against the
port: an autouse fixture points the module-level names they resolve (the
API types, the store, NodeInfo and PodInfo, the plugins, the snapshot
builder, build_volume_overlay and volume_mask, and the node and pod
makers) at the port's, with the cluster on the CPU.  The fifth,
test_pipelined_chain_survives_unsatisfiable_claim, imports the JAX
Scheduler in its body, so its twin is written out here against the
port's pipelined serving loop.

Beside them, on seeded worlds (kubetpu_torch/harness/volume_worlds.py,
built in both packages' API types): the port's overlay equals the JAX
package's array for array, and the port's mask equals the JAX package's
volume_mask bitwise and the port's host plugins' verdicts (every pod x
every node) — tolerance 0.
"""
import numpy as np
import pytest

import kubetpu.api.types as japi
import kubetpu.framework.types as jtypes
import kubetpu.state.volumes as jvs
import kubetpu_torch.api.types as tapi
import kubetpu_torch.client.store as tstore
import kubetpu_torch.framework.interface as tfw
import kubetpu_torch.framework.types as ttypes
import kubetpu_torch.plugins.volumes as tvol
import kubetpu_torch.state.volumes as tvs
import tests.test_volume_mask as VM
from kubetpu.client.store import ClusterStore as JStore
from kubetpu.state.tensors import SnapshotBuilder as JSnapshotBuilder
from kubetpu_torch.harness import volume_worlds as VW
from kubetpu_torch.state.tensors import SnapshotBuilder as TSnapshotBuilder
from tests.test_torch_volume_plugins import port_mknode, port_mkpod
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

ENABLED = set(jvs.DEVICE_COVERED_PLUGINS)


class _OnCPU:
    """Host arrays whose to_device() lands on the CPU, as the JAX tests
    call it without a device."""

    def __init__(self, host):
        self.host = host

    def to_device(self, device="cpu"):
        return self.host.to_device(device)


class CPUSnapshotBuilder(TSnapshotBuilder):
    def build(self, node_infos):
        return _OnCPU(super().build(node_infos))


@pytest.fixture(autouse=True)
def through_the_port(monkeypatch):
    for name, value in dict(
            api=tapi, ClusterStore=tstore.ClusterStore,
            CycleState=tfw.CycleState, NodeInfo=ttypes.NodeInfo,
            PodInfo=ttypes.PodInfo, vplug=tvol,
            SnapshotBuilder=CPUSnapshotBuilder,
            build_volume_overlay=tvs.build_volume_overlay,
            volume_mask=tvs.volume_mask, mknode=port_mknode,
            mkpod=port_mkpod,
            PLUGIN_CLASSES=tuple(getattr(tvol, c.__name__)
                                 for c in VM.PLUGIN_CLASSES)).items():
        monkeypatch.setattr(VM, name, value)


def test_port_volume_mask_matches_host_plugins():
    VM.test_volume_mask_matches_host_plugins()


def test_port_volume_mask_none_without_volumes():
    VM.test_volume_mask_none_without_volumes()


def test_port_volume_mask_multi_pv_zone_intersection():
    VM.test_volume_mask_multi_pv_zone_intersection()


def test_port_unbound_claim_capacity_and_modes_prefilter():
    VM.test_unbound_claim_capacity_and_modes_prefilter()


def test_port_pipelined_chain_survives_unsatisfiable_claim():
    """An unbound claim no PV can satisfy fails before the dispatch, by
    the device mask, not at the commit-time host re-check: a commit
    failure there would discard the pipelined drain's speculative chain
    and re-run the cycle."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler

    store = tstore.ClusterStore()
    for i in range(4):
        store.add(port_mknode(name=f"n{i}"))
    store.add(tapi.StorageClass(metadata=tapi.ObjectMeta(name="fast"),
                                provisioner="kubernetes.io/aws-ebs"))
    store.add(tapi.PersistentVolume(
        metadata=tapi.ObjectMeta(name="pv-small"),
        capacity={"storage": "1Gi"}, storage_class_name="fast"))
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=8, mode="gang",
        chain_cycles=True, pipeline_cycles=True), device="cpu")

    def wave(tag, request):
        store.add(tapi.PersistentVolumeClaim(
            metadata=tapi.ObjectMeta(name=f"{tag}-c"),
            storage_class_name="fast",
            resources=tapi.ResourceRequirements(
                requests={"storage": request})))
        p = port_mkpod(name=tag)
        p.spec.volumes = [tapi.Volume(name="v",
                                      persistent_volume_claim=f"{tag}-c")]
        store.add(p)

    outcomes = []
    wave("ok-0", "512Mi")
    wave("big-0", "10Gi")   # no matchable PV: must fail pre-dispatch
    for _ in range(6):
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        outcomes.extend(got)
    by_name = {o.pod.metadata.name: o.node for o in outcomes}
    assert by_name.get("ok-0"), "satisfiable pod must schedule"
    assert not by_name.get("big-0"), "oversized claim must not schedule"
    assert not sched._last_commit_failed
    sched.close()


def test_twins_run_through_the_port():
    assert VM.volume_mask is tvs.volume_mask
    assert all(c.__module__ == tvol.__name__ for c in VM.PLUGIN_CLASSES)


# --- seeded worlds against the JAX package


def _mask(A, Store, NodeInfo, PodInfo, SB, V, w):
    store = Store()
    VW.populate(store, w)
    infos = VW.node_infos(NodeInfo, w)
    sb = SB()
    sb.intern_pending([PodInfo(p) for p in w.pending])
    host = sb.build(infos)
    overlay = V.build_volume_overlay(store, infos, w.pending, sb.table,
                                     ENABLED)
    if V is jvs:
        return overlay, np.asarray(V.volume_mask(host.to_device(), overlay)), \
            store, infos
    return overlay, V.volume_mask(host.to_device("cpu"), overlay).numpy(), \
        store, infos


def host_verdicts(store, infos, pending):
    """The port's host plugins, every pod x every node."""
    plugins = [getattr(tvol, name)(store) for name in sorted(ENABLED)]
    out = np.ones((len(pending), len(infos)), bool)
    for i, pod in enumerate(pending):
        for p in plugins:
            if not p.relevant(pod):
                continue
            for j, ni in enumerate(infos):
                if not p.filter(tfw.CycleState(), pod, ni).is_success():
                    out[i, j] = False
    return out


def _same_overlay(jo, to):
    for f in jo._fields:
        a, b = getattr(jo, f), getattr(to, f)
        if hasattr(a, "_fields"):          # a SelectorSet
            for g in a._fields:
                np.testing.assert_array_equal(np.asarray(getattr(a, g)),
                                              np.asarray(getattr(b, g)),
                                              err_msg=f"{f}.{g}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


@pytest.mark.parametrize("seed", range(24))
def test_mask_matches_reference_and_host_loop(seed):
    size = dict(n_nodes=8 + 4 * (seed % 3), n_pending=12, max_existing=3)
    jo, jm, _, _ = _mask(japi, JStore, jtypes.NodeInfo, jtypes.PodInfo,
                         JSnapshotBuilder, jvs, VW.world(japi, seed, **size))
    tw = VW.world(tapi, seed, **size)
    to, tm, store, infos = _mask(tapi, tstore.ClusterStore, ttypes.NodeInfo,
                                 ttypes.PodInfo, TSnapshotBuilder, tvs, tw)
    _same_overlay(jo, to)
    assert tm.dtype == bool and tm.shape == jm.shape
    np.testing.assert_array_equal(tm, jm)
    want = host_verdicts(store, infos, tw.pending)
    B, N = want.shape
    np.testing.assert_array_equal(tm[:B, :N], want)
    assert want.any() and not want.all()


def test_backlog_mask_matches_reference():
    """The contended world's mask at a small size: CSINode limits that
    bind on part of the nodes and zone affinity on every PV."""
    from kubetpu.harness import hollow as jhollow
    from kubetpu_torch.harness import hollow as thollow
    jw = VW.backlog(japi, jhollow, n_nodes=48, n_pods=96)
    tw = VW.backlog(tapi, thollow, n_nodes=48, n_pods=96)
    _, jm, _, _ = _mask(japi, JStore, jtypes.NodeInfo, jtypes.PodInfo,
                        JSnapshotBuilder, jvs, jw)
    _, tm, store, infos = _mask(tapi, tstore.ClusterStore, ttypes.NodeInfo,
                                ttypes.PodInfo, TSnapshotBuilder, tvs, tw)
    np.testing.assert_array_equal(tm, jm)
    want = host_verdicts(store, infos, tw.pending)
    np.testing.assert_array_equal(tm[:96, :48], want)
    # each pod is held to its zone (6 of 48 nodes); a node's limit,
    # 4 + i % 3, exceeds its i % 4 existing volumes, so before the drain
    # every node of the zone takes one more (the limit binds once the
    # drain's own pods land)
    assert (want.sum(axis=1) == 6).all()
