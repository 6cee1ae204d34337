"""REST API serving + reflector client: the framework's L2/L3 over HTTP.

Server side (`APIServer`): the ClusterStore behind an HTTP+JSON resource
API — list/get/create/update/delete per kind, the pods/<name>/binding and
pods/<name>/status subresources the scheduler writes (reference:
defaultbinder/default_binder.go:56 POST binding; scheduler.go:739-755
status patch), and a resource-versioned long-poll WATCH feed (the
etcd3-watch + watch-cache role, apiserver/pkg/storage/cacher/cacher.go:436).

Client side (`RestClusterStore`): a ClusterStore whose WRITES go to the
API server and whose READS come from a local mirror maintained by a watch
loop — the Reflector -> DeltaFIFO -> SharedInformer shape of client-go
(tools/cache/reflector.go): initial LIST, then incremental events applied
in order, with subscriber fan-out identical to the in-process store, so a
Scheduler runs against a REMOTE control plane unchanged.

A copy of kubetpu/client/rest.py without its fault-injection seams (the
chaos registry is not ported: ROADMAP queue 1 item 11; disarmed they are
no-ops).
"""

from __future__ import annotations

import collections
import json
import random
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..api import types as api
from . import codec
from .store import ClusterStore, Conflict, NotFound

WATCH_BUFFER = 16384
# how long the server holds an idle watch poll (the JAX package's is 10
# s); close() joins the watch thread within one poll round trip, so a
# short hold keeps shutdown short
WATCH_HOLD_S = 2.0
# reconnect backoff for the watch loop (reflector.go's wait.Backoff
# shape): exponential from INITIAL, capped, with jitter — a dead or
# flapping API server must cost sleeps, not a spinning core
WATCH_BACKOFF_INITIAL = 0.2
WATCH_BACKOFF_CAP = 5.0


class APIServer:
    """HTTP resource API over a ClusterStore."""

    def __init__(self, store: ClusterStore, host: str = "127.0.0.1",
                 port: int = 0):
        self.store = store
        self.host, self.port = host, port
        self._events = collections.deque(maxlen=WATCH_BUFFER)  # kubelint: guarded-by(_cond)
        self._seq = 0  # kubelint: guarded-by(_cond)
        self._cond = threading.Condition()
        # ThreadingHTTPServer handles writers concurrently, but the store
        # fans events out AFTER releasing its lock — two racing writes
        # could reach the watch buffer in reverse order and make mirrors
        # converge on the older state.  One server-side write mutex makes
        # mutation + event-sequencing atomic per request.
        self._write_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        for kind in codec.KINDS:
            self._subscribe(kind)

    def _subscribe(self, kind: str) -> None:
        def handler(event, old, new):
            with self._cond:
                self._seq += 1
                self._events.append({
                    "seq": self._seq, "kind": kind, "event": event,
                    "old": codec.to_doc(old) if old is not None else None,
                    "new": codec.to_doc(new) if new is not None else None})
                self._cond.notify_all()
        self.store.subscribe(kind, handler)

    # -- serving ------------------------------------------------------------

    def start(self) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, doc) -> None:
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                try:
                    outer._get(self)
                except Exception as e:  # noqa: BLE001 — API boundary
                    self._send(500, {"error": repr(e)})

            def do_POST(self):
                outer._write(self, "POST")

            def do_PUT(self):
                outer._write(self, "PUT")

            def do_DELETE(self):
                outer._write(self, "DELETE")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None

    # -- request handling ---------------------------------------------------

    def _get(self, h) -> None:
        path, _, query = h.path.partition("?")
        params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
        parts = [p for p in path.split("/") if p]
        if parts == ["watch"]:
            since = int(params.get("since", 0))
            timeout = float(params.get("timeout", 25.0))
            with self._cond:
                self._cond.wait_for(
                    lambda: self._seq > since, timeout=timeout)
                evs = [e for e in self._events if e["seq"] > since]
                # oldest retained seq lets clients DETECT buffer eviction
                # (the "resourceVersion too old" signal of a real watch;
                # reflector.go relists on it)
                oldest = self._events[0]["seq"] if self._events else 0
            h._send(200, {"events": evs, "oldest": oldest, "seq": max(
                [e["seq"] for e in evs], default=since)})
            return
        if len(parts) >= 2 and parts[0] == "apis":
            kind = parts[1]
            if kind not in codec.KINDS:
                h._send(404, {"error": f"unknown kind {kind}"})
                return
            if len(parts) == 2:
                # seq is read BEFORE the list: any mutation after the read
                # carries a later seq and will be replayed by the watch
                # (replays are idempotent applies), so the handoff can
                # duplicate but never lose events
                with self._cond:
                    seq0 = self._seq
                h._send(200, {"items": [codec.to_doc(o)
                                        for o in self.store.list(kind)],
                              "seq": seq0})
                return
            key = "/".join(parts[2:])
            obj = self.store.get(kind, key)
            if obj is None:
                h._send(404, {"error": f"{kind} {key} not found"})
                return
            h._send(200, codec.to_doc(obj))
            return
        h._send(404, {"error": "not found"})

    def _write(self, h, method: str) -> None:
        with self._write_lock:
            self._write_locked(h, method)

    def _write_locked(self, h, method: str) -> None:
        try:
            parts = [p for p in h.path.split("/") if p]
            body = h._body() if method != "DELETE" else {}
            # POST /api/v1/namespaces/{ns}/pods/{name}/binding | /status
            # POST .../persistentvolumeclaims/{name}/bind — the PVC-side
            # write of BindPodVolumes (scheduler_binder.go; assume-cache
            # operations stay CLIENT-side like the reference's)
            if (method == "POST" and len(parts) == 7 and parts[0] == "api"
                    and parts[2] == "namespaces"
                    and parts[4] == "persistentvolumeclaims"
                    and parts[6] == "bind"):
                self.store.bind_pvc(parts[3], parts[5],
                                    body.get("pvName", ""),
                                    body.get("nodeName", ""))
                h._send(200, {})
                return
            if (method == "POST" and len(parts) == 7 and parts[0] == "api"
                    and parts[2] == "namespaces" and parts[4] == "pods"):
                ns, name, sub = parts[3], parts[5], parts[6]
                pod = self.store.get_pod(ns, name)
                if pod is None:
                    h._send(404, {"error": f"pod {ns}/{name} not found"})
                    return
                if sub == "binding":
                    self.store.bind(pod, body["node"])
                    h._send(200, {})
                    return
                if sub == "status":
                    cond = codec.from_doc(api.PodCondition,
                                          body.get("condition", {}))
                    self.store.update_pod_condition(
                        pod, cond,
                        nominated_node_name=body.get(
                            "nominatedNodeName", ""))
                    h._send(200, {})
                    return
            if len(parts) >= 2 and parts[0] == "apis":
                kind = parts[1]
                if method == "POST" and len(parts) == 2:
                    self.store.add(codec.decode(kind, body))
                    h._send(201, {})
                    return
                if method == "PUT" and len(parts) >= 3:
                    self.store.update(codec.decode(kind, body))
                    h._send(200, {})
                    return
                if method == "DELETE" and len(parts) >= 3:
                    key = "/".join(parts[2:])
                    obj = self.store.get(kind, key)
                    if obj is None:
                        raise NotFound(f"{kind} {key} not found")
                    self.store.delete(obj)
                    h._send(200, {})
                    return
            h._send(404, {"error": "not found"})
        except Conflict as e:
            h._send(409, {"error": str(e)})
        except NotFound as e:
            h._send(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — API boundary
            h._send(500, {"error": repr(e)})


class RestClusterStore(ClusterStore):
    """ClusterStore view of a remote APIServer: reads serve from a local
    watch-maintained mirror; writes POST to the server and become visible
    when their watch event arrives (the reference's informer consistency
    model — the scheduler's assume/ForgetPod protocol bridges the gap,
    cache.go:338)."""

    def __init__(self, base_url: str):
        super().__init__()
        self.base_url = base_url.rstrip("/")
        self._stop = threading.Event()
        self._synced = threading.Event()
        # reconnect accounting (watch thread only): total backoff sleeps
        # taken and the last computed delay — the dead-server test
        # asserts the attempt count stays bounded and the delay grows.
        # The jitter rng is entropy-seeded PER INSTANCE: a shared fixed
        # seed would make every reflector in a fleet draw identical
        # jitter and reconnect in lockstep — the herd the jitter exists
        # to break up
        self._watch_retries = 0
        self._watch_backoff_s = 0.0
        self._backoff_rng = random.Random()
        self._watch_thread = threading.Thread(target=self._watch_loop,
                                              daemon=True)
        self._watch_thread.start()

    # -- transport ----------------------------------------------------------

    def _req(self, method: str, path: str, doc=None, timeout=30.0):
        data = json.dumps(doc).encode() if doc is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            body = {}
            try:
                body = json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001
                pass
            msg = body.get("error", str(e))
            if e.code == 409:
                raise Conflict(msg) from None
            if e.code == 404:
                raise NotFound(msg) from None
            raise

    # -- reflector ----------------------------------------------------------

    def _apply(self, kind: str, event: str, old_doc, new_doc) -> None:
        """Mirror one watch event into the local store, preserving the
        server's resourceVersions, and fan out to subscribers."""
        old = codec.decode(kind, old_doc) if old_doc else None
        new = codec.decode(kind, new_doc) if new_doc else None
        self._apply_obj(kind, event, old, new)

    def _apply_obj(self, kind: str, event: str, old, new) -> None:
        with self._lock:
            if event == "delete":
                self._objs[kind].pop(self._key(old), None)
            else:
                self._objs[kind][self._key(new)] = new
            subs = list(self._subs[kind])
        for h in subs:
            h(event, old, new)

    def _list_all(self) -> Optional[int]:
        """Initial/recovery LIST of every kind (reflector.go ListAndWatch).
        RECONCILES the mirror against the server snapshot: new objects
        emit adds, surviving objects with newer resourceVersions emit
        updates, and local objects absent from the server emit deletes —
        so a relist after a watch gap repairs every divergence, including
        deletions the gap swallowed.  Returns the seq to watch from (the
        MINIMUM of the per-kind list seqs; the handoff window replays
        idempotently) or None if any list failed (caller retries; a
        partial mirror must never be declared synced)."""
        seqs = []
        snapshots = {}
        for kind in codec.KINDS:
            try:
                doc = self._req("GET", f"/apis/{kind}")
            except Exception:  # noqa: BLE001 — transport/server error
                return None
            seqs.append(int(doc.get("seq", 0)))
            snapshots[kind] = doc.get("items", [])
        for kind, items in snapshots.items():
            server = {}
            for item in items:
                obj = codec.decode(kind, item)
                server[self._key(obj)] = obj
            with self._lock:
                local = dict(self._objs[kind])
            for key, obj in server.items():
                old = local.get(key)
                if old is None:
                    self._apply_obj(kind, "add", None, obj)
                elif (old.metadata.resource_version
                        != obj.metadata.resource_version):
                    self._apply_obj(kind, "update", old, obj)
            for key, old in local.items():
                if key not in server:
                    self._apply_obj(kind, "delete", old, None)
        return min(seqs, default=0)

    def _next_backoff(self, failures: int) -> float:
        """Capped exponential backoff with jitter for the reconnect loop
        (reference: reflector.go's wait.Backoff).  failures is the
        CONSECUTIVE failure count; jitter is a uniform [0.5, 1.0) factor
        so a fleet of reflectors does not reconnect in lockstep."""
        self._watch_retries += 1
        base = min(WATCH_BACKOFF_CAP,
                   WATCH_BACKOFF_INITIAL * (2 ** min(failures - 1, 16)))
        delay = base * (0.5 + 0.5 * self._backoff_rng.random())
        self._watch_backoff_s = delay
        return delay

    def _watch_loop(self) -> None:
        seq = None
        failures = 0
        while not self._stop.is_set():
            if seq is None:
                seq = self._list_all()
                if seq is None:
                    failures += 1
                    if self._stop.wait(self._next_backoff(failures)):
                        return
                    continue
                failures = 0
                self._synced.set()
            try:
                # client bound = server hold + slack, so close()'s join
                # bound below really does cover one poll round trip
                doc = self._req(
                    "GET", f"/watch?since={seq}&timeout={WATCH_HOLD_S}",
                    timeout=WATCH_HOLD_S + 2.0)
            except Exception:  # noqa: BLE001 — retry after transport error
                failures += 1
                if self._stop.wait(self._next_backoff(failures)):
                    return
                continue
            failures = 0
            # buffer eviction check ("resourceVersion too old"): events
            # older than ours were dropped before we read them -> RELIST
            oldest = int(doc.get("oldest", 0))
            if oldest > seq + 1:
                seq = None
                continue
            try:
                for ev in doc.get("events", []):
                    if ev["seq"] <= seq:
                        continue
                    seq = ev["seq"]
                    self._apply(ev["kind"], ev["event"], ev.get("old"),
                                ev.get("new"))
            except Exception:  # noqa: BLE001 — decode/subscriber failure
                # the loop must never die silently: log and RELIST, which
                # reconciles whatever the failed event left inconsistent
                import logging
                logging.getLogger("kubetpu_torch.rest").warning(
                    "watch event application failed; relisting",
                    exc_info=True)
                seq = None

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        """reference: WaitForCacheSync before the scheduler serves."""
        return self._synced.wait(timeout)

    def close(self) -> None:
        """Idempotent: stops and joins the watch loop (its long poll's
        client timeout is WATCH_HOLD_S + 2 s, so the join bound covers one
        poll round trip).  If the thread still outlives the bound, the
        handle is KEPT so a later close() can join it again."""
        self._stop.set()
        t = self._watch_thread
        if t is not None and t.is_alive():
            t.join(timeout=WATCH_HOLD_S + 5.0)
            if t.is_alive():
                return
        self._watch_thread = None

    # -- writes -> API server ----------------------------------------------

    def add(self, obj) -> None:
        self._req("POST", f"/apis/{obj.kind}", codec.to_doc(obj))

    def update(self, obj) -> None:
        self._req("PUT", f"/apis/{obj.kind}/{self._key(obj)}",
                  codec.to_doc(obj))

    def delete(self, obj) -> None:
        self._req("DELETE", f"/apis/{obj.kind}/{self._key(obj)}")

    def bind(self, pod: api.Pod, node_name: str) -> None:
        self._req("POST",
                  f"/api/v1/namespaces/{pod.namespace}/pods/"
                  f"{pod.metadata.name}/binding", {"node": node_name})

    def update_pod_condition(self, pod, condition,
                             nominated_node_name: str = "") -> None:
        self._req("POST",
                  f"/api/v1/namespaces/{pod.namespace}/pods/"
                  f"{pod.metadata.name}/status",
                  {"condition": codec.to_doc(condition),
                   "nominatedNodeName": nominated_node_name})

    def bind_pvc(self, namespace: str, pvc_name: str, pv_name: str,
                 node_name: str) -> None:
        self._req("POST",
                  f"/api/v1/namespaces/{namespace}/persistentvolumeclaims/"
                  f"{pvc_name}/bind",
                  {"pvName": pv_name, "nodeName": node_name})
        # the local PV assume-cache entry clears the same way the
        # in-process store's does (scheduler_binder assume cache)
        with self._lock:
            if pv_name:
                self._assumed_pv.pop(pv_name, None)
