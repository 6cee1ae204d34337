"""The port's preemption programs and nominated-pods overlay against
kubetpu's: models/programs.py filter_verdicts, whatif_static_ok,
whatif_wave, nominated_fit_mask, nominated_topology_mask, and
preemption._whatif_reprieve, each held bitwise (tolerance 0) on every
output.

Worlds are kubetpu_torch/harness/preempt_worlds.py's, built in the JAX
package's API types and tensorized by its builders; its tensors cross to
the port as numpy leaves (cluster_from_numpy, batch_from_numpy,
nominated_from_numpy), so both sides read identical state.  Sizes: 40
nodes, B <= 16 pods, C <= 16 candidates, K <= 8 victims.  The inputs
carry what the programs must get right: duplicate nominated node rows (a
scatter-min with repeated indices), nominated rows of the batch itself,
invalid pads, memory requests that are not a whole MiB (fractional f32
sums over victims and nominated pods), a pod with no candidate at all,
and -1 victim pads in the reprieve (a scatter-max that must leave the
pad's column as it is).  The JAX reprieve runs through
tests/torch_port_util.jax_whatif_reprieve_mapped (its vmap cannot run on
XLA:CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu.api.types as japi
from kubetpu.framework.types import NodeInfo as JNodeInfo
from kubetpu.framework.types import PodInfo as JPodInfo
from kubetpu.models import batch as jbatch
from kubetpu.models import programs as jprog
from kubetpu.state.tensors import SnapshotBuilder as JSnapshotBuilder
from kubetpu.state.tensors import resource_to_channels as j_channels
from kubetpu_torch import preemption as tpre
from kubetpu_torch.harness import preempt_worlds as PW
from kubetpu_torch.models import programs as tprog
from kubetpu_torch.models.batch import batch_from_numpy, nominated_from_numpy
from kubetpu_torch.state.tensors import cluster_from_numpy
from tests.torch_port_util import (assert_same, jax_whatif_reprieve_mapped,
                                   port_cfg, to_numpy_tree)

MIB = float(2 ** 20)


class World:
    """A preempt_worlds world tensorized by the JAX package, with its
    tensors carried to the port."""

    def __init__(self, seed, terms=False, n_nodes=40, n_pending=12):
        w = PW.world(japi, seed, n_nodes, n_pending, terms=terms,
                     n_parked=4)
        self.w = w
        infos = []
        for n in w.nodes:
            ni = JNodeInfo(n)
            for p in w.bound:
                if p.spec.node_name == n.name:
                    ni.add_pod(p)
            infos.append(ni)
        self.infos = infos
        self.pinfos = [JPodInfo(p) for p in w.pending]
        self.nom_pinfos = [JPodInfo(p) for p, _ in w.parked]
        sb = JSnapshotBuilder()
        sb.intern_pending(self.pinfos + self.nom_pinfos)
        self.table = sb.table
        self.host = sb.build(infos)
        self.cluster = self.host.to_device()
        self.batch = jax.tree.map(np.asarray, jbatch.PodBatchBuilder(
            sb.table).build(self.pinfos))
        self.cfg = jprog.ProgramConfig(hostname_topokey=max(
            sb.table.topokey.get(japi.LABEL_HOSTNAME), 0))
        self.tcluster = cluster_from_numpy(to_numpy_tree(self.cluster),
                                           "cpu")
        self.tbatch = batch_from_numpy(to_numpy_tree(self.batch), "cpu")
        self.N = len(w.nodes)
        self.R = int(self.cluster.requested.shape[1])

    def channels(self, pod):
        v = j_channels(JPodInfo(pod).resource, self.table, self.R,
                       intern_new=False)
        v[3] = 1.0
        return v


SEEDS = [(1, False), (2, False), (3, True), (4, True)]


def _host_ok(seed, B, N):
    return np.random.RandomState(seed).rand(B, N) < 0.85


@pytest.mark.parametrize("seed,terms", SEEDS)
def test_filter_verdicts(seed, terms):
    W = World(seed, terms)
    B = W.batch.valid.shape[0]
    ho = _host_ok(seed, B, W.cluster.allocatable.shape[0])
    for host_ok in (None, ho):
        jf, ju = jprog.filter_verdicts(
            W.cluster, W.batch, W.cfg,
            None if host_ok is None else jnp.asarray(host_ok))
        tf, tu = tprog.filter_verdicts(
            W.tcluster, W.tbatch, port_cfg(W.cfg),
            None if host_ok is None else torch.from_numpy(host_ok))
        assert_same(jf, tf, "feasible")
        assert_same(ju, tu, "unresolvable")


def _wave_inputs(W, seed):
    """A [B, C, K] wave: random candidate rows per pod (pow2 buckets, -1
    pads, pod 1 without any candidate), a victim table of the world's
    bound pods' real request channels (memory 300M is not a whole MiB),
    nominated reservations with fractional memory."""
    r = np.random.RandomState(seed)
    B = W.batch.valid.shape[0]
    C, K, S = 16, 8, 12
    bound = W.w.bound
    tab_req = np.zeros((S, K, W.R), np.float32)
    tab_valid = np.zeros((S, K), bool)
    for s in range(S):
        n = r.randint(0, K + 1)
        for k in range(n):
            tab_req[s, k] = W.channels(bound[r.randint(len(bound))])
        tab_valid[s, :n] = True
    cand_rows = np.full((B, C), -1, np.int32)
    for b in range(B):
        if b == 1:
            continue
        nc = r.randint(1, C + 1)
        cand_rows[b, :nc] = r.choice(W.N, nc, replace=False)
    cand_valid = cand_rows >= 0
    cand_idx = np.where(cand_valid, r.randint(0, S, (B, C)), 0).astype(
        np.int32)
    nom_add = np.zeros((B, C, W.R), np.float32)
    hit = r.rand(B, C) < 0.3
    nom_add[hit, 0] = r.choice([500.0, 900.0], hit.sum())
    nom_add[hit, 1] = np.float32(100e6 / MIB)
    nom_add[hit, 3] = 1.0
    return (cand_rows, cand_valid, nom_add, tab_req, tab_valid, cand_idx)


@pytest.mark.parametrize("seed,terms", SEEDS)
def test_whatif_static_ok_and_wave(seed, terms):
    W = World(seed, terms)
    cfg_w = W.cfg._replace(filters=tuple(
        f for f in W.cfg.filters
        if f not in ("PodTopologySpread", "InterPodAffinity")))
    j_ok = jprog.whatif_static_ok(W.cluster, W.batch, cfg_w)
    t_ok = tprog.whatif_static_ok(W.tcluster, W.tbatch, port_cfg(cfg_w))
    assert_same(j_ok, t_ok, "static_ok")
    ins = _wave_inputs(W, seed)
    want = jprog.whatif_wave(W.cluster, j_ok, jnp.asarray(W.batch.req),
                             *[jnp.asarray(x) for x in ins])
    got = tprog.whatif_wave(W.tcluster, t_ok, W.tbatch.req,
                            *[torch.from_numpy(x) for x in ins])
    assert_same(want, got, "whatif_wave packed")
    # the wave decided something: some fits, some reprieves, some
    # evictions
    packed = np.asarray(want)
    assert packed[:, :, 0].any() and not packed[1, :, 0].any()
    assert packed[:, :, 1:].any()


def _nominated(W, seed):
    """build_nominated entries: the world's parked pods on their nodes,
    two more on one node (duplicate rows), batch pods 0 and 2 nominated
    to a node (self rows), padded to 16 slots."""
    r = np.random.RandomState(seed)
    row_of = {n.name: j for j, n in enumerate(W.w.nodes)}
    entries = [(JPodInfo(p), row_of[nn], -1) for p, nn in W.w.parked]
    dup = int(r.randint(W.N))
    # two on one node, asking for memory that is no whole MiB: the
    # overlay's f32 sum over nominated pods rounds
    entries += [(JPodInfo(PW._pod(japi, f"dup{i}", {}, "700m", mem, 90, 0)),
                 dup, -1)
                for i, mem in enumerate(("123456789", "987654321"))]
    entries += [(JPodInfo(W.w.pending[0]), dup, 0),
                (JPodInfo(W.w.pending[2]), int(r.randint(W.N)), 2)]
    return jbatch.build_nominated(entries, W.table, pad_m=16)


@pytest.mark.parametrize("seed,terms", SEEDS)
def test_nominated_fit_mask(seed, terms):
    W = World(seed, terms)
    nom = _nominated(W, seed)
    want = jprog.nominated_fit_mask(W.cluster, W.batch,
                                    jax.tree.map(jnp.asarray, nom))
    got = tprog.nominated_fit_mask(W.tcluster, W.tbatch,
                                   nominated_from_numpy(nom._asdict(),
                                                        "cpu"))
    assert_same(want, got, "nominated_fit_mask")
    assert not np.asarray(want).all()


@pytest.mark.parametrize("seed,terms", SEEDS)
def test_nominated_topology_mask(seed, terms):
    W = World(seed, terms)
    # nominated pods carrying required hostname anti-affinity and labels
    # that the batch's terms select; one pad row (-1)
    pods = [p for p, _ in W.w.parked] + W.w.pending[8:11]
    for p in pods[::2]:
        p.spec.affinity = japi.Affinity(pod_anti_affinity=japi.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                japi.PodAffinityTerm(
                    label_selector=japi.LabelSelector(
                        match_labels={"app": "a"}),
                    topology_key=japi.LABEL_HOSTNAME)]))
    nom_pb = jax.tree.map(np.asarray, jbatch.PodBatchBuilder(W.table).build(
        [JPodInfo(p) for p in pods]))
    M = nom_pb.valid.shape[0]
    r = np.random.RandomState(seed)
    rows = np.full((M,), -1, np.int32)
    rows[:len(pods) - 1] = r.randint(0, W.N, len(pods) - 1)
    prio = np.zeros((M,), np.int32)
    prio[:len(pods)] = [p.priority() for p in pods]
    cfg = W.cfg._replace(active_topo_keys=(0, 1))
    want = jprog.nominated_topology_mask(
        W.cluster, nom_pb, jnp.asarray(rows), jnp.asarray(prio), W.batch, cfg)
    got = tprog.nominated_topology_mask(
        W.tcluster, batch_from_numpy(to_numpy_tree(nom_pb), "cpu"),
        torch.from_numpy(rows), torch.from_numpy(prio), W.tbatch,
        port_cfg(cfg))
    assert_same(want, got, "nominated_topology_mask")


def _reprieve_inputs(W, pod, C_real):
    """_select_nodes_for_preemption's host arrays for ``pod`` over the
    first C_real nodes carrying lower-priority pods (reprieve order:
    descending priority), pow2-padded: cand rows [C], rm_valid [C, P],
    rm_req, rm_nz, vic_row [C, K] (-1 pads), vic_req, vic_nz."""
    pod_rows = {}
    row = 0
    for ni in W.infos:
        for pi in ni.pods:
            pod_rows[pi.pod.uid] = row
            row += 1
    prio = pod.priority()
    entries = []
    for j, ni in enumerate(W.infos):
        lower = sorted((pi for pi in ni.pods if pi.pod.priority() < prio),
                       key=lambda pi: -pi.pod.priority())
        if lower:
            entries.append((j, lower))
        if len(entries) == C_real:
            break
    C = 1 << (len(entries) - 1).bit_length()
    K = 1 << (max(len(e[1]) for e in entries) - 1).bit_length()
    P = int(W.cluster.pod_valid.shape[0])
    cand_rows = np.full((C,), entries[0][0], np.int32)
    rm_valid = np.broadcast_to(np.asarray(W.cluster.pod_valid),
                               (C, P)).copy()
    rm_req = np.zeros((C, W.R), np.float32)
    rm_nz = np.zeros((C, 2), np.float32)
    vic_row = np.full((C, K), -1, np.int32)
    vic_req = np.zeros((C, K, W.R), np.float32)
    vic_nz = np.zeros((C, K, 2), np.float32)
    for c, (j, victims) in enumerate(entries):
        cand_rows[c] = j
        for k, pi in enumerate(victims):
            prow = pod_rows[pi.pod.uid]
            rm_valid[c, prow] = False
            vic_row[c, k] = prow
            vic_req[c, k] = W.channels(pi.pod)
            vic_nz[c, k] = (pi.non_zero_cpu, pi.non_zero_mem / MIB)
            rm_req[c] += vic_req[c, k]
            rm_nz[c] += vic_nz[c, k]
    return (cand_rows, rm_valid, rm_req, rm_nz, vic_row, vic_req, vic_nz)


@pytest.mark.parametrize("seed,terms,pick", [(3, True, 0), (4, True, 3),
                                             (5, False, 1)])
def test_whatif_reprieve(seed, terms, pick):
    W = World(seed, terms)
    pods = sorted(W.w.pending, key=lambda p: -p.priority())
    pod = pods[pick]
    b1 = jax.tree.map(np.asarray, jbatch.PodBatchBuilder(W.table).build(
        [JPodInfo(pod)]))
    ins = _reprieve_inputs(W, pod, 13)
    cfg = W.cfg._replace(active_topo_keys=(0, 1))
    f0, rep = jax_whatif_reprieve_mapped(W.cluster, b1, cfg,
                                         *[jnp.asarray(x) for x in ins])
    tf0, trep = tpre._whatif_reprieve(
        W.tcluster, batch_from_numpy(to_numpy_tree(b1), "cpu"),
        port_cfg(cfg), *[torch.from_numpy(x) for x in ins])
    assert_same(f0, tf0, "fits0")
    assert_same(rep, trep, "reprieved")
    # pads (candidates past the real ones, -1 victim slots) decided
    # nothing, and the world made the reprieve decide something
    assert np.asarray(f0).any() and np.asarray(rep).any()
