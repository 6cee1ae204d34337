"""Serving: /healthz, /metrics, /configz and the /debug endpoints.

reference: cmd/kube-scheduler/app/server.go:167-199 (health + metrics
servers, configz registration) and component-base/configz; the
counterpart of kubetpu/server.py.  ``/debug/explain?pod=<name>
[&namespace=<ns>]`` answers the per-pod "why (un)scheduled" audit from
the scheduler's DecisionLog (no pod parameter lists the most recent
decisions; ``?outcome=unschedulable`` filters; ``?n=`` bounds the list).

The JAX server's other /debug endpoints serve recorders the port has not
ported (ROADMAP queue 1 item 11: the flight recorder, the SLO tracker,
the cycle journal, device statistics and load telemetry).  Each answers
as the JAX server answers with its recorder disarmed: ``/debug/flightz``
and ``/debug/journal`` 200 with ``armed: false``, ``/debug/slo``,
``/debug/devicez`` and ``/debug/loadz`` 404 with ``armed: false``.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from dataclasses import asdict, is_dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

NOT_PORTED = "not ported to kubetpu_torch (ROADMAP queue 1 item 11)"

# path -> (status, document) of the recorders the port does not have
_DISARMED = {
    "/debug/flightz": (200, {"armed": False,
                             "hint": "the flight recorder is " + NOT_PORTED}),
    "/debug/journal": (200, {"armed": False,
                             "hint": "the cycle journal is " + NOT_PORTED}),
    "/debug/slo": (404, {"armed": False,
                         "error": "the SLO tracker is disarmed",
                         "hint": "the SLO tracker is " + NOT_PORTED}),
    "/debug/devicez": (404, {"armed": False,
                             "error": "device-side observability is "
                                      "disarmed",
                             "hint": "device statistics are " + NOT_PORTED}),
    "/debug/loadz": (404, {"armed": False,
                           "error": "the telemetry ring is disarmed",
                           "hint": "load telemetry is " + NOT_PORTED}),
}


class SchedulerServer:
    def __init__(self, scheduler, host: str = "127.0.0.1", port: int = 10251):
        self.scheduler = scheduler
        self.host, self.port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        sched = self.scheduler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "text/plain; charset=utf-8"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, code: int, doc) -> None:
                self._send(code, json.dumps(doc, default=str, indent=2),
                           "application/json")

            def _explain(self, query) -> None:
                log = getattr(sched, "decisions", None)
                if log is None or not log.enabled:
                    self._send_json(200, {
                        "enabled": False,
                        "hint": "the decision audit is off "
                                "(KUBETPU_AUDIT=0)"})
                    return
                pod = (query.get("pod") or [None])[0]
                if not pod:
                    outcome = (query.get("outcome") or [None])[0]
                    try:
                        n = int((query.get("n") or ["50"])[0])
                    except ValueError:
                        self._send_json(400, {
                            "error": "n must be an integer"})
                        return
                    self._send_json(200, log.to_dict(n, outcome=outcome))
                    return
                ns = (query.get("namespace") or [None])[0]
                decision = log.get(pod, namespace=ns)
                if decision is None:
                    self._send_json(404, {
                        "error": f"no recorded decision for pod {pod!r}",
                        "hint": "the DecisionLog is bounded; the pod may "
                                "not have been attempted yet or its entry "
                                "was evicted"})
                    return
                self._send_json(200, decision.to_dict())

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                path = parsed.path
                query = urllib.parse.parse_qs(parsed.query)
                if path == "/healthz":
                    self._send(200, "ok")
                elif path == "/metrics":
                    # Prometheus text exposition format 0.0.4 either way
                    # (an empty registry is still a valid scrape)
                    body = ("" if sched.metrics is None
                            else sched.metrics.expose_text())
                    self._send(200, body, "text/plain; version=0.0.4")
                elif path == "/configz":
                    cfg = sched.config
                    doc = asdict(cfg) if is_dataclass(cfg) else vars(cfg)
                    self._send_json(200, doc)
                elif path == "/debug/explain":
                    self._explain(query)
                elif path in _DISARMED:
                    self._send_json(*_DISARMED[path])
                else:
                    self._send(404, "not found")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=2.0)
                self._thread = None
