"""Serving: /healthz, /metrics, /configz and the /debug endpoints.

reference: cmd/kube-scheduler/app/server.go:167-199 (health + metrics
servers, configz registration) and component-base/configz; the
counterpart of kubetpu/server.py.  ``/debug/explain?pod=<name>
[&namespace=<ns>]`` answers the per-pod "why (un)scheduled" audit from
the scheduler's DecisionLog (no pod parameter lists the most recent
decisions; ``?outcome=unschedulable`` filters; ``?n=`` bounds the list).
``/debug/flightz`` dumps the flight recorder's ring (utils/trace.py;
``?format=chrome`` returns Perfetto-loadable Chrome trace-event JSON; the
``slo`` block rides it while the SLO tracker is armed); ``/debug/slo``
serves the per-pod latency document (utils/slo.py; ``?stage=`` filters,
``?n=`` bounds the exemplars, bad parameters are 400); ``/debug/loadz``
serves the load-telemetry ring (utils/telemetry.py; ``?n=`` keeps the
newest n windows, bad parameters are 400).  While a recorder is disarmed
its endpoint answers as the JAX server's does: ``/debug/flightz`` 200
and ``/debug/slo``, ``/debug/loadz`` 404, with ``armed: false``.

The JAX server's ``/debug/journal`` and ``/debug/devicez`` serve
recorders the port has not ported (ROADMAP queue 1 item 11); they answer
as the JAX server answers with those disarmed.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from dataclasses import asdict, is_dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .utils import slo as uslo
from .utils import telemetry as utelemetry
from .utils import trace as utrace

NOT_PORTED = "not ported to kubetpu_torch (ROADMAP queue 1 item 11)"

# path -> (status, document) of the recorders the port does not have
_NOT_PORTED = {
    "/debug/journal": (200, {"armed": False,
                             "hint": "the cycle journal is " + NOT_PORTED}),
    "/debug/devicez": (404, {"armed": False,
                             "error": "device-side observability is "
                                      "disarmed",
                             "hint": "device statistics are " + NOT_PORTED}),
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

            def _flightz(self, query) -> None:
                fr = utrace.flight_recorder()
                if fr is None:
                    self._send_json(200, {
                        "armed": False,
                        "hint": "arm with KUBETPU_FLIGHT=1 or kubetpu_torch."
                                "utils.trace.arm_flight_recorder()"})
                    return
                fmt = (query.get("format") or ["json"])[0]
                if fmt in ("chrome", "perfetto"):
                    self._send_json(200, fr.to_chrome_trace())
                else:
                    doc = fr.to_dict()
                    # the per-pod latency digest rides the dump while the
                    # SLO tracker is armed
                    trk = uslo.tracker()
                    if trk is not None:
                        doc["slo"] = {"stages": trk.stage_quantiles(),
                                      "shares": trk.shares()}
                    self._send_json(200, doc)

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

            def _slo(self, query) -> None:
                trk = uslo.tracker()
                if trk is None:
                    self._send_json(404, {
                        "armed": False,
                        "error": "the SLO tracker is disarmed",
                        "hint": "arm with KUBETPU_SLO=1 or "
                                "kubetpu_torch.utils.slo.arm_slo_tracker()"})
                    return
                doc = trk.to_dict()
                stage = (query.get("stage") or [None])[0]
                if stage is not None:
                    if stage not in doc["stages"]:
                        self._send_json(400, {
                            "error": f"unknown stage {stage!r}",
                            "stages": sorted(doc["stages"])})
                        return
                    doc["stages"] = {stage: doc["stages"][stage]}
                raw_n = (query.get("n") or [None])[0]
                if raw_n is not None:
                    try:
                        n = int(raw_n)
                        if n < 0:
                            raise ValueError
                    except ValueError:
                        self._send_json(400, {
                            "error": "n must be a non-negative integer"})
                        return
                    doc["exemplars"] = doc["exemplars"][:n]
                self._send_json(200, doc)

            def _loadz(self, query) -> None:
                tel = utelemetry.ring()
                if tel is None:
                    self._send_json(404, {
                        "armed": False,
                        "error": "the telemetry ring is disarmed",
                        "hint": "arm with KUBETPU_TELEMETRY=1 or "
                                "kubetpu_torch.utils.telemetry.arm_telemetry()"})
                    return
                raw_n = (query.get("n") or [None])[0]
                last = None
                if raw_n is not None:
                    try:
                        last = int(raw_n)
                        if last < 0:
                            raise ValueError
                    except ValueError:
                        self._send_json(400, {
                            "error": "n must be a non-negative integer"})
                        return
                self._send_json(200, tel.to_dict(last=last))

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
                elif path == "/debug/flightz":
                    self._flightz(query)
                elif path == "/debug/explain":
                    self._explain(query)
                elif path == "/debug/slo":
                    self._slo(query)
                elif path == "/debug/loadz":
                    self._loadz(query)
                elif path in _NOT_PORTED:
                    self._send_json(*_NOT_PORTED[path])
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
