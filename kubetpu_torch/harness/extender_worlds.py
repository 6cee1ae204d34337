"""A seeded fake HTTP extender, and seeded worlds for the extender path.

The port's CPU tests run the same world and the same extender against the
JAX package's scheduler and the port's; chip_smoke.py runs the extender
beside the port on the card and on the CPU.  The extender is an
in-process ``ThreadingHTTPServer`` on 127.0.0.1 that serves the four
verbs of the reference's extender protocol (pkg/scheduler/core/
extender.go) by fixed, seed-free rules over the node index (the trailing
integer of a node's name):

  ``filter``      drops every node whose index is a multiple of 4;
  ``prioritize``  scores each node crc32("<pod>/<node>") % 11 (0-10, the
                  protocol's MaxExtenderPriority);
  ``bind``        binds the pod through the store it was given;
  ``preempt``     keeps only the even-indexed candidate nodes, each with
                  the victims it was offered.

Every module the world needs (the API types) is a parameter, so this
module imports nothing but the standard library.
"""

from __future__ import annotations

import json
import random
import re
import threading
import zlib
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Tuple

VERBS = ("filter", "prioritize", "bind", "preempt")
_INDEX = re.compile(r"(\d+)$")


def node_index(name: str) -> int:
    """The trailing integer of a node name ("node-17", "n17" -> 17)."""
    return int(_INDEX.search(name).group(1))


def priority(pod_name: str, node_name: str) -> int:
    """The prioritize verb's score of one (pod, node)."""
    return zlib.crc32(f"{pod_name}/{node_name}".encode()) % 11


class FakeExtender:
    """The extender server over ``store`` (a ClusterStore of either
    package).  verbs: the verbs it serves (a subset of VERBS); ``calls``
    counts the requests per verb.  A context manager: the server runs
    between enter and exit."""

    def __init__(self, store, verbs=VERBS):
        self.store = store
        self.verbs = tuple(verbs)
        self.calls: Counter = Counter()
        self._lock = threading.Lock()
        self._httpd = None
        self._thread = None

    # -- the verbs ---------------------------------------------------------

    def _filter(self, body) -> Dict:
        names = [n for n in body["NodeNames"] if node_index(n) % 4 != 0]
        return {"NodeNames": names, "FailedNodes": {}}

    def _prioritize(self, body) -> List[Dict]:
        pod = body["Pod"]["metadata"]["name"]
        return [{"Host": n, "Score": priority(pod, n)}
                for n in body["NodeNames"]]

    def _bind(self, body) -> Dict:
        pod = self.store.get_pod(body["PodNamespace"], body["PodName"])
        if pod is None:
            return {"Error": "pod %s/%s not found" % (body["PodNamespace"],
                                                      body["PodName"])}
        try:
            self.store.bind(pod, body["Node"])
        except Exception as e:  # the store refuses a gone or bound pod
            return {"Error": str(e)}
        return {}

    def _preempt(self, body) -> Dict:
        return {"nodeNameToMetaVictims": {
            n: meta for n, meta in body["nodeNameToMetaVictims"].items()
            if node_index(n) % 2 == 0}}

    # -- the server --------------------------------------------------------

    def _answer(self, verb: str, body):
        with self._lock:
            self.calls[verb] += 1
        if verb not in self.verbs:
            return {"Error": "verb %r not served" % verb}
        return getattr(self, "_" + verb)(body)

    def __enter__(self) -> "FakeExtender":
        ext = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])).decode())
                out = ext._answer(self.path.rsplit("/", 1)[-1], body)
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="fake-extender")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    @property
    def url(self) -> str:
        return "http://127.0.0.1:%d" % self._httpd.server_address[1]

    def config(self, weight: int = 2, **extra) -> Dict:
        """The ``extenders:`` entry naming this server's verbs."""
        cfg = {"urlPrefix": self.url, "weight": weight}
        for verb in self.verbs:
            cfg[verb + "Verb"] = verb
        cfg.update(extra)
        return cfg


# ---------------------------------------------------------------- worlds


def _pod(A, name, cpu_milli, prio, ts, node=""):
    c = A.Container(name="c", image="img:1", resources=A.ResourceRequirements(
        requests={"cpu": f"{cpu_milli}m", "memory": "256Mi"}))
    return A.Pod(metadata=A.ObjectMeta(name=name, namespace="default",
                                       labels={"app": name[:1]},
                                       creation_timestamp=float(ts)),
                 spec=A.PodSpec(containers=[c], priority=prio,
                                node_name=node))


def world(A, seed: int, n_nodes: int = 32,
          n_pending: int = 200) -> Tuple[list, list, list]:
    """(nodes, bound fillers, pending pods) in API module ``A``: nodes
    n0..n{n_nodes-1} of 4 cpu, each holding 1-3 bound 900m fillers at
    priority 0; pending: small 200m pods at priority 0 and, one in five,
    preemptors of 1,500-2,500m at priority 100, in a seeded order.  With
    the fake extender's filter and preempt verbs the preemptors can evict
    only on the nodes whose index is 2 mod 4."""
    r = random.Random(seed)
    nodes = [A.Node(metadata=A.ObjectMeta(
        name=f"n{i}", labels={A.LABEL_HOSTNAME: f"n{i}",
                              A.LABEL_ZONE: "z%d" % (i % 3)}),
        status=A.NodeStatus(allocatable={"cpu": "4", "memory": "16Gi",
                                         "pods": "110"}))
        for i in range(n_nodes)]
    ts = 0
    bound = []
    for i in range(n_nodes):
        for j in range(r.randint(1, 3)):
            ts += 1
            bound.append(_pod(A, f"f{i}_{j}", 900, 0, ts, node=f"n{i}"))
    pending = []
    for i in range(n_pending):
        ts += 1
        if r.random() < 0.2:
            pending.append(_pod(A, f"q{i}", r.choice((1500, 2000, 2500)),
                                100, ts))
        else:
            pending.append(_pod(A, f"s{i}", 200, 0, ts))
    return nodes, bound, pending


def populate(store, nodes, bound) -> None:
    """Add the world's nodes and bound fillers to ``store``."""
    for n in nodes:
        store.add(n)
    for p in bound:
        store.add(p)
