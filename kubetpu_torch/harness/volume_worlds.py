"""Seeded volume worlds, shared by the port's CPU tests and chip_smoke.py.

``world`` is a small randomized cluster for the volume family (the shape
of the JAX package's tests/test_volume_mask.py ``build_world``, sized by
its arguments): nodes with and without zone labels, Nitro and classic
instance types, EBS limits in allocatable and CSINode limits; an EBS
provisioner class and a WaitForFirstConsumer class; PVs with zone labels
(some a ``__``-separated zone set), zone node affinity, capacities,
access modes and EBS or CSI sources; and pods whose volumes are bound and
unbound claims (capacity and access-mode requirements, classes that
provision and classes that cannot), inline EBS, GCE PD (read-only and
read-write), RBD and ISCSI disks and Cinder volumes.  Existing pods carry
the same volumes, so attach limits and inline conflicts bind.

``backlog`` is the contended volume drain (the smoke's ``vol_backlog``):
the smoke's backlog shape (1,000 nodes x 4,096 pending 900m pods, node i
carrying i % 4 existing pods) where every pod, existing or pending,
mounts one bound CSI volume whose PV has node affinity on one of the 8
zones, and every node has a CSINode limit of 4 + i % 3 volumes.

The API module is a parameter, so the same world is built in the JAX
package's types and in the port's; this module imports nothing but the
port.
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple

CSI_DRIVER = "csi.example.com"
BACKLOG_DRIVER = "ebs.csi.aws.com"
ZONES = ("us-a", "us-b", "us-c")
INSTANCE_TYPE = "beta.kubernetes.io/instance-type"


class World(NamedTuple):
    nodes: List              # api.Node
    objects: List            # CSINodes, classes, PVs, PVCs (store order)
    existing: Dict[str, List]  # node name -> bound pods
    pending: List            # pods to schedule


def _pod(A, name, cpu="100m", mem="200Mi"):
    return A.Pod(
        metadata=A.ObjectMeta(name=name, namespace="default"),
        spec=A.PodSpec(containers=[A.Container(
            name="c", image="img:1", resources=A.ResourceRequirements(
                requests={"cpu": cpu, "memory": mem}))]))


def _claim_volume(A, objects, rng, name, pv_names, bound_frac):
    """One claim (bound to a random PV, or unbound with requirements) and
    the pod volume that mounts it."""
    if rng.random() < bound_frac:
        pvc = A.PersistentVolumeClaim(
            metadata=A.ObjectMeta(name=name, namespace="default"),
            volume_name=rng.choice(pv_names))
    else:
        pvc = A.PersistentVolumeClaim(
            metadata=A.ObjectMeta(name=name, namespace="default"),
            storage_class_name=rng.choice(["fast", "wait", "", "gone"]),
            access_modes=rng.choice([[], ["ReadWriteOnce"],
                                     ["ReadWriteMany"]]),
            resources=A.ResourceRequirements(
                requests=({"storage": rng.choice(["512Mi", "2Gi", "10Gi"])}
                          if rng.random() < 0.7 else {})))
    objects.append(pvc)
    return A.Volume(name=name, persistent_volume_claim=name)


def _volumes(A, objects, rng, name, pv_names, bound_frac):
    vols = []
    for j in range(rng.randint(1, 2)):
        kind = rng.random()
        if kind < 0.1:
            vols.append(A.Volume(
                name=f"e{j}", aws_elastic_block_store=(
                    f"ebs-{name}-{j}" if rng.random() < 0.5
                    else "ebs-shared")))
        elif kind < 0.2:
            # GCE, RBD and ISCSI conflicts are read-only-exempt: both sides
            disk = rng.choice(["disk-a", "disk-b"])
            src = rng.choice([("gce_persistent_disk", disk),
                              ("rbd", ("mon-0", "pool", disk)),
                              ("iscsi", ("10.0.0.1:3260", 0, disk))])
            vols.append(A.Volume(name=f"g{j}", read_only=rng.random() < 0.5,
                                 **dict([src])))
        elif kind < 0.25:
            vols.append(A.Volume(name=f"c{j}", cinder=f"cinder-{name}-{j}"))
        elif kind < 0.3:
            vols.append(A.Volume(name=f"s{j}", empty_dir=True))
        else:
            vols.append(_claim_volume(A, objects, rng, f"{name}-c{j}",
                                      pv_names, bound_frac))
    return vols


def world(A, seed: int, n_nodes: int = 6, n_pending: int = 8,
          n_pvs: int = 10, max_existing: int = 2,
          bound_frac: float = 0.7) -> World:
    """A seeded volume world in API module ``A`` (see the module
    docstring); the last pending pod has no volume."""
    rng = random.Random(seed)
    nodes, objects = [], []
    for i in range(n_nodes):
        labels = {A.LABEL_HOSTNAME: f"n{i}"}
        if rng.random() < 0.7:
            labels[A.LABEL_ZONE] = rng.choice(ZONES)
        if rng.random() < 0.3:
            labels[INSTANCE_TYPE] = rng.choice(["m5.large", "t2.small"])
        alloc = {"cpu": "4", "memory": "32Gi", "pods": "110"}
        if rng.random() < 0.5:
            alloc["attachable-volumes-aws-ebs"] = str(rng.randint(1, 3))
        if rng.random() < 0.3:
            alloc["attachable-volumes-cinder"] = str(rng.randint(1, 2))
        nodes.append(A.Node(metadata=A.ObjectMeta(name=f"n{i}",
                                                  labels=labels),
                            status=A.NodeStatus(allocatable=alloc)))
        if rng.random() < 0.5:
            objects.append(A.CSINode(
                metadata=A.ObjectMeta(name=f"n{i}"),
                driver_allocatable={CSI_DRIVER: rng.randint(1, 2)}))
    objects.append(A.StorageClass(metadata=A.ObjectMeta(name="fast"),
                                  provisioner="kubernetes.io/aws-ebs"))
    objects.append(A.StorageClass(
        metadata=A.ObjectMeta(name="wait"),
        volume_binding_mode="WaitForFirstConsumer"))
    pv_names = []
    for i in range(n_pvs):
        labels = {}
        if rng.random() < 0.4:
            labels[A.LABEL_ZONE] = rng.choice(list(ZONES) + ["us-a__us-b"])
        aff = None
        if rng.random() < 0.4:
            aff = A.NodeSelector(node_selector_terms=[
                A.NodeSelectorTerm(match_expressions=[
                    A.NodeSelectorRequirement(
                        key=A.LABEL_ZONE, operator="In",
                        values=[rng.choice(ZONES)])])])
        objects.append(A.PersistentVolume(
            metadata=A.ObjectMeta(name=f"pv{i}", labels=labels),
            node_affinity=aff,
            capacity=({"storage": rng.choice(["1Gi", "5Gi", "20Gi"])}
                      if rng.random() < 0.7 else {}),
            access_modes=rng.choice([[], ["ReadWriteOnce"],
                                     ["ReadWriteOnce", "ReadWriteMany"]]),
            storage_class_name=rng.choice(["fast", "", "wait"]),
            aws_elastic_block_store=(f"ebs-{i}" if rng.random() < 0.4
                                     else None),
            csi_driver=CSI_DRIVER if rng.random() < 0.3 else None,
            csi_volume_handle=f"h{i}"))
        pv_names.append(f"pv{i}")
    existing = {}
    for n in nodes:
        pods = []
        for k in range(rng.randint(0, max_existing)):
            p = _pod(A, f"ex-{n.name}-{k}")
            p.spec.volumes = _volumes(A, objects, rng, p.metadata.name,
                                      pv_names, bound_frac)
            p.spec.node_name = n.name
            pods.append(p)
        existing[n.name] = pods
    pending = []
    for i in range(n_pending - 1):
        p = _pod(A, f"pend-{i}")
        p.spec.volumes = _volumes(A, objects, rng, p.metadata.name,
                                  pv_names, bound_frac)
        pending.append(p)
    pending.append(_pod(A, "plain"))
    return World(nodes, objects, existing, pending)


def populate(store, w: World, pending: bool = False) -> None:
    """Add the world's nodes, objects and bound pods to ``store`` (a
    ClusterStore of the same package), and its pending pods if asked."""
    for n in w.nodes:
        store.add(n)
    for o in w.objects:
        store.add(o)
    for pods in w.existing.values():
        for p in pods:
            store.add(p)
    if pending:
        for p in w.pending:
            store.add(p)


def node_infos(NodeInfo, w: World) -> List:
    """The world's NodeInfos (NodeInfo: the package's class)."""
    out = []
    for n in w.nodes:
        ni = NodeInfo(n)
        for p in w.existing[n.name]:
            ni.add_pod(p)
        out.append(ni)
    return out


def _csi_pod(A, hollow, name, zone, labels, cpu_milli, objects):
    """A hollow pod mounting one bound CSI volume whose PV has node
    affinity on ``zone``."""
    p = hollow.make_pod(name, cpu_milli=cpu_milli, mem=250 << 20,
                        labels=labels)
    objects.append(A.PersistentVolume(
        metadata=A.ObjectMeta(name=f"pv-{name}"),
        node_affinity=A.NodeSelector(node_selector_terms=[
            A.NodeSelectorTerm(match_expressions=[
                A.NodeSelectorRequirement(key=A.LABEL_ZONE, operator="In",
                                          values=[zone])])]),
        csi_driver=BACKLOG_DRIVER, csi_volume_handle=f"vol-{name}"))
    objects.append(A.PersistentVolumeClaim(
        metadata=A.ObjectMeta(name=f"pvc-{name}", namespace="default"),
        volume_name=f"pv-{name}"))
    p.spec.volumes = [A.Volume(name="data",
                               persistent_volume_claim=f"pvc-{name}")]
    return p


def backlog(A, hollow, n_nodes: int = 1000, n_pods: int = 4096,
            zones: int = 8) -> World:
    """The contended volume drain (see the module docstring); pending
    pod i's volume is pinned to zone i % zones."""
    nodes = hollow.make_nodes(n_nodes, zones=zones)
    objects, existing = [], {}
    for i, n in enumerate(nodes):
        objects.append(A.CSINode(
            metadata=A.ObjectMeta(name=n.name),
            driver_allocatable={BACKLOG_DRIVER: 4 + i % 3}))
        zone = n.metadata.labels[A.LABEL_ZONE]
        pods = []
        for j in range(i % 4):
            p = _csi_pod(A, hollow, f"init-{i}-{j}", zone,
                         {"app": f"app-{(i + j) % 10}", "group": "init"},
                         100, objects)
            p.spec.node_name = n.name
            pods.append(p)
        existing[n.name] = pods
    pending = [_csi_pod(A, hollow, f"vol-backlog-{i}", f"zone-{i % zones}",
                        {"app": f"app-{i % 10}", "group": "vol-backlog"},
                        900, objects)
               for i in range(n_pods)]
    return World(nodes, objects, existing, pending)
