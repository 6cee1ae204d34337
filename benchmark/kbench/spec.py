"""A cell's world and closed-loop traffic as plain data, made from the seed.

Nothing here imports torch or the program: the reference and the program
are both handed what this module makes.  A configuration file fixes the
cluster (nodes, zones, node shape) and the scheduler's settings; a traffic
file fixes the pod templates (requests, priority, labels and features found
by name: kbench/plugins.py), what is bound before the run, the backlog the
loop keeps pending and which bound pods depart.  Every seed gets the same
sizes: the seed only chooses which nodes carry the extra pods and which
pods depart.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .plugins import Plugins

LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"


CORE = ("cpu_milli", "mem_bytes", "priority", "labels")


@dataclass(frozen=True)
class Template:
    """One kind of pod: its requests, priority and labels, and its
    features: every other key of the template, each the name of a file
    ``features/<key>.py`` (kbench/plugins.py), with its value as canonical
    JSON."""
    name: str
    cpu_milli: int
    mem_bytes: int
    priority: int = 0
    labels: Tuple[Tuple[str, str], ...] = ()
    features: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def of(name: str, d: dict, plugins: Optional[Plugins] = None
           ) -> "Template":
        if d["cpu_milli"] <= 0 or d["mem_bytes"] <= 0:
            raise ValueError("template %s: requests must be positive (the "
                             "reference scores requests, not defaults)"
                             % name)
        feats = tuple(sorted((k, json.dumps(v, sort_keys=True))
                             for k, v in d.items() if k not in CORE))
        for k, _ in feats:
            # an unknown key fails here, not halfway through a run
            (plugins or Plugins()).feature(k)
        return Template(
            name=name, cpu_milli=int(d["cpu_milli"]),
            mem_bytes=int(d["mem_bytes"]), priority=int(d.get("priority", 0)),
            labels=tuple(sorted(d.get("labels", {}).items())),
            features=feats)

    def feature(self, key: str):
        """The value of one feature (None: the pod does not carry it)."""
        for k, v in self.features:
            if k == key:
                return json.loads(v)
        return None

    def matches(self, selector) -> bool:
        mine = dict(self.labels)
        return all(mine.get(k) == v for k, v in dict(selector).items())


@dataclass
class World:
    """The cluster before the run: identical nodes spread round-robin over
    the zones, and the pods bound to them."""
    config: dict
    mix: dict
    n_nodes: int
    n_zones: int
    node_zone: np.ndarray            # [N] int64
    alloc_cpu: np.ndarray            # [N] int64 millicores
    alloc_mem: np.ndarray            # [N] int64 bytes
    alloc_pods: np.ndarray           # [N] int64
    templates: Dict[str, Template]
    plugins: Plugins
    bound: List[Tuple[str, str, int]] = field(default_factory=list)
    _domains: Dict[str, Tuple[np.ndarray, int]] = field(default_factory=dict)

    @property
    def pending_template(self) -> Template:
        return self.templates[self.mix["pending"]["template"]]

    @property
    def feature_names(self) -> List[str]:
        """The features any template of the world carries."""
        return sorted({k for t in self.templates.values()
                       for k, _ in t.features})

    def node_name(self, i: int) -> str:
        return "node-%d" % i

    def zone_name(self, z: int) -> str:
        names = self.config.get("zone_names")
        return names[z] if names else "zone-%d" % z

    def node_labels(self, i: int) -> Dict[str, str]:
        """A node's labels: its hostname, zone and region (the
        well-known keys kube-scheduler reads)."""
        return {LABEL_HOSTNAME: self.node_name(i),
                LABEL_ZONE: self.zone_name(int(self.node_zone[i])),
                LABEL_REGION: "region-0"}

    def domains(self, key: str) -> Tuple[np.ndarray, int]:
        """([N] domain index of every node under a label key, -1 where the
        node lacks the label; the number of domains)."""
        if key not in self._domains:
            vals = [self.node_labels(i).get(key)
                    for i in range(self.n_nodes)]
            names = sorted({v for v in vals if v is not None})
            index = {v: d for d, v in enumerate(names)}
            self._domains[key] = (
                np.array([index.get(v, -1) if v is not None else -1
                          for v in vals], np.int64), len(names))
        return self._domains[key]


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use, from any non-negative seed."""
    return np.random.default_rng([int(seed), stream])


def build_world(config: dict, mix: dict, seed: int,
                plugins: Optional[Plugins] = None) -> World:
    plugins = plugins or Plugins()
    n, z = int(config["nodes"]), int(config["zones"])
    node = config["node"]
    templates = {k: Template.of(k, v, plugins)
                 for k, v in mix["templates"].items()}
    w = World(config=config, mix=mix, n_nodes=n, n_zones=z,
              node_zone=np.arange(n, dtype=np.int64) % z,
              alloc_cpu=np.full(n, int(node["cpu_milli"]), np.int64),
              alloc_mem=np.full(n, int(node["mem_bytes"]), np.int64),
              alloc_pods=np.full(n, int(node["pods"]), np.int64),
              templates=templates, plugins=plugins)
    rng = rng_of(seed, 0)
    for g, group in enumerate(mix["bound"]):
        t = group["template"]
        if "per_node" in group:
            nodes = np.repeat(np.arange(n), int(group["per_node"]))
        elif "per_node_mean" in group:
            total = int(round(float(group["per_node_mean"]) * n))
            base, extra = divmod(total, n)
            counts = np.full(n, base, np.int64)
            counts[rng.permutation(n)[:extra]] += 1
            nodes = np.repeat(np.arange(n), counts)
        elif "per_zone" in group:
            k = int(group["per_zone"])
            nodes = np.concatenate([
                np.sort(rng.permutation(np.flatnonzero(w.node_zone == zi))[:k])
                for zi in range(z)])
        else:
            raise ValueError("bound group %d: per_node, per_node_mean or "
                             "per_zone" % g)
        w.bound.extend(("%s-b%d" % (t, i), t, int(nd))
                       for i, nd in enumerate(nodes))
    return w


def scaled(config: dict, mix: dict, nodes: int, batch_size: int
           ) -> Tuple[dict, dict]:
    """A configuration and mix cut to ``nodes`` nodes and ``batch_size``
    pods per cycle, every per-node and per-zone count kept in proportion:
    the CPU rehearsal's worlds.  The benchmark's command never calls it."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    share = nodes / float(config["nodes"])
    config["nodes"], config["batch_size"] = int(nodes), int(batch_size)
    for group in mix["bound"]:
        if "per_zone" in group:
            group["per_zone"] = max(1, int(round(group["per_zone"] * share)))
    if "rounds" in mix["trace"]:
        # a small world's cycles run few rounds: let the traced rounds
        # span more of them
        mix["trace"]["max_cycles"] = 50
    return config, mix


class ClosedLoop:
    """The traffic of a drain cell.  Before every cycle: as many bound pods
    depart as the last cycle bound, drawn uniformly from the bound pods of
    the departing templates (jobs finishing), and new pods of the pending
    template top the backlog up to ``backlog_batches`` batches."""

    def __init__(self, world: World, seed: int):
        mix = world.mix
        self.world = world
        self.rng = rng_of(seed, 1)
        self.template = mix["pending"]["template"]
        self.backlog = (int(mix["pending"]["backlog_batches"])
                        * int(world.config["batch_size"]))
        self.departing = set(mix["departures"]["templates"])
        # pending pods in arrival order (a dict keeps it)
        self.pending: Dict[str, None] = {}
        self.pool: List[str] = []
        self.pos: Dict[str, int] = {}
        self.counter = 0
        for name, t, _ in world.bound:
            if t in self.departing:
                self._pool_add(name)

    def _pool_add(self, name: str) -> None:
        self.pos[name] = len(self.pool)
        self.pool.append(name)

    def _pool_take(self, i: int) -> str:
        name, last = self.pool[i], self.pool[-1]
        self.pool[i] = last
        self.pos[last] = i
        self.pool.pop()
        del self.pos[name]
        return name

    def evicted(self, name: str) -> None:
        """A bound pod was deleted by the program (a preemption's victim):
        it can no longer depart."""
        if name in self.pos:
            self._pool_take(self.pos[name])

    def bound(self, name: str, template: str) -> None:
        """A pod of this loop was bound."""
        self.pending.pop(name, None)
        if template in self.departing:
            self._pool_add(name)

    def step(self, departures: int) -> Tuple[List[str], List[str]]:
        """(names to delete, names of new pending pods of the template)."""
        gone = []
        for _ in range(min(departures, len(self.pool))):
            gone.append(self._pool_take(
                int(self.rng.integers(len(self.pool)))))
        new = []
        while len(self.pending) < self.backlog:
            name = "%s-%d" % (self.template, self.counter)
            self.counter += 1
            self.pending[name] = None
            new.append(name)
        return gone, new
