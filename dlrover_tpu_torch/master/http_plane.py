"""Live HTTP observability plane: /metrics, /timeline, /healthz, /memory
(port of ``dlrover_tpu/master/http_plane.py``).

Until now the Prometheus text ``JobTimeline.render_metrics`` produces was
only reachable through the master's pickled-dataclass RPC surface plus a
CLI dump — unscrapeable by an actual Prometheus.  This module puts a
stdlib :class:`http.server.ThreadingHTTPServer` next to the RPC server
(``JobMaster --metrics-port``; 0 = off, the default) serving:

- ``GET /metrics``  — byte-identical to the RPC render path (the handler
  calls the servicer's own ``MetricsRequest`` handler), so a scrape and a
  ``tools/job_timeline.py`` dump can never disagree;
- ``GET /timeline`` — the merged Perfetto/Chrome trace JSON
  (``JobTimeline.to_chrome_trace``), loadable straight into
  https://ui.perfetto.dev;
- ``GET /healthz``  — a small JSON liveness/health document: rendezvous
  round, live node count, running/quarantined nodes, measured HBM
  headroom — what a k8s probe or a fleet dashboard needs without parsing
  the exposition;
- ``GET /memory``   — the classified HBM ledger (``MemoryLedger``): the
  fleet aggregate plus every node's newest per-pool snapshot.

The plane is read-only (GET only) and sits behind the ``http.serve``
Faultline seam: an injected error answers 503 exactly like a wedged
master would, so scrape-retry behavior is drillable.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dlrover_tpu_torch.common import faults
from dlrover_tpu_torch.common.log import default_logger as logger


class MetricsHTTPServer:
    """The master's scrape surface over a servicer."""

    def __init__(self, servicer, host: str = "0.0.0.0", port: int = 0,
                 healthz_hbm_floor: float = 0.0):
        self.servicer = servicer
        self.host = host
        self.port = port
        # Healthz flips not-ok when measured HBM headroom drops below
        # this fraction.  0.0 (the default) disables the check so
        # existing healthz semantics are unchanged until opted in.
        self.healthz_hbm_floor = healthz_hbm_floor
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- endpoint payloads (also the testable surface) -----------------------

    def metrics_text(self) -> str:
        # The SAME handler the MetricsRequest RPC dispatches to — byte
        # parity with the RPC render path by construction.
        return self.servicer._get_metrics_text(None)

    def timeline_json(self) -> str:
        if self.servicer.timeline is None:
            return json.dumps({"traceEvents": []})
        return json.dumps(self.servicer.timeline.to_chrome_trace())

    def healthz(self) -> dict:
        rounds = {}
        live = 0
        for name, manager in self.servicer.rdzv_managers.items():
            with manager._lock:
                rounds[name] = manager._rdzv_round
                live = max(live, len(manager._alive_nodes))
        running = 0
        quarantined = []
        if self.servicer.node_manager is not None:
            running = sum(
                1 for s in self.servicer.node_manager.statuses().values()
                if s == "running"
            )
            quarantined = sorted(
                node_id
                for node_id, state
                in self.servicer.node_manager.snapshot().items()
                if state.get("quarantined")
            )
        headroom = -1.0
        ledger = getattr(self.servicer, "memory_ledger", None)
        if ledger is not None:
            headroom = ledger.headroom_frac()
        # Headroom -1 means "no node can price a limit" (the CPU
        # fallback path) — unknown is not pressure.
        hbm_ok = not (
            self.healthz_hbm_floor > 0.0
            and 0.0 <= headroom < self.healthz_hbm_floor
        )
        return {
            "ok": not quarantined and hbm_ok,
            "rdzv_round": rounds.get("elastic-training", 0),
            "rdzv_rounds": rounds,
            "live_nodes": live,
            "running_nodes": running,
            "quarantined": quarantined,
            "hbm_headroom_frac": headroom,
            "hbm_ok": hbm_ok,
        }

    def memory_json(self) -> str:
        ledger = getattr(self.servicer, "memory_ledger", None)
        if ledger is None:
            return json.dumps({"ledger": {}, "nodes": {}})
        return json.dumps({
            "ledger": ledger.ledger(),
            "nodes": {
                str(k): v for k, v in sorted(ledger.per_node().items())
            },
        })

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        faults.fire("http.serve", op="bind", port=self.port)
        plane = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                try:
                    faults.fire("http.serve", op="get", path=self.path)
                    if self.path.startswith("/metrics"):
                        body = plane.metrics_text().encode()
                        ctype = "text/plain; version=0.0.4"
                    elif self.path.startswith("/timeline"):
                        body = plane.timeline_json().encode()
                        ctype = "application/json"
                    elif self.path.startswith("/healthz"):
                        body = json.dumps(plane.healthz()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/memory"):
                        body = plane.memory_json().encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except faults.FaultInjected as e:
                    # The drillable failure mode: a wedged master answers
                    # 503, a scraper retries — the seam makes that path
                    # exercisable without wedging anything.
                    self.send_error(503, explain=str(e))
                    return
                except Exception as e:  # noqa: BLE001 - never kill the server
                    logger.warning("http plane %s failed: %s", self.path, e)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # noqa: D102
                pass  # scrapes at 15s cadence must not spam the log

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "metrics HTTP plane on %s:%d "
            "(/metrics /timeline /healthz /memory)",
            self.host, self.port,
        )
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
