"""The live introspection plane: a stdlib HTTP admin/debug server.

The paper's headline regime — a fully dynamic index under ACID
transactions with hundreds of concurrent readers and writers — cannot be
debugged from logs after the fact; you ask the *running* warren what it
is doing.  :class:`AdminServer` is that window: a
``ThreadingHTTPServer`` (stdlib only, daemon threads, ephemeral port by
default) serving read-only views of every observability surface:

    /healthz               liveness (the process answers)
    /readyz                readiness (the attached warren routes)
    /metrics               Prometheus text exposition (format 0.0.4)
    /metrics.json          full registry snapshot, sanitized JSON
    /traces                completed-trace ring: id, root, duration, error
    /traces/<id>           one trace: span tree + flat span records
    /routing               RoutingTable epoch/ranges + per-group state
    /autopilot/decisions   recent Decision records (?n=50)
    /tiered/runs           static-tier run sets (manifest + per-run info)
    /tiered/cache          block-cache occupancy + hit/miss/admission stats
    /slo                   declared SLOs + multi-window burn rates
    /profile/cpu?seconds=N on-demand wall-clock sampling profile
                           (collapsed stacks, flamegraph-compatible)

Every endpoint reads lock-free or through the same snapshot surfaces the
serving paths use — scraping ``/routing`` mid-rebalance never takes a
write lock, so the admin plane can never block writers (tier-1 asserts
this under a concurrent scrape storm with a split in flight).

Handlers never raise into the socket: failures become a JSON 500 with
the exception type, and ``log_message`` is silenced so the admin plane
does not spam the server's stderr.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .profile import profile_for
from .registry import registry, sanitize
from .trace import tracer

# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

PROFILE_MAX_SECONDS = 30.0


class AdminServer:
    """Admin endpoint over the process-global registry/tracer plus
    whatever subsystems are attached (all optional):

    * ``warren``     — a ShardedWarren (``/routing``, ``/readyz``)
    * ``controller`` — an autopilot Controller (``/autopilot/decisions``)
    * ``tiered``     — a TieredStore (``/tiered/runs``, ``/tiered/cache``);
      without one, a warren's demoted groups still report their run
      directories and ``/tiered/cache`` falls back to the process-default
      block cache
    * ``slo``        — an SLOMonitor (``/slo``)

    ``start()`` binds (port 0 = ephemeral) and serves on daemon threads;
    ``close()`` shuts the listener down.  Usable as a context manager.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 warren=None, controller=None, tiered=None, slo=None):
        self.host = host
        self._requested_port = port
        self.warren = warren
        self.controller = controller
        self.tiered = tiered
        self.slo = slo
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------- #
    def start(self) -> "AdminServer":
        if self._httpd is not None:
            raise RuntimeError("admin server already started")
        admin = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                admin._dispatch(self)

            def log_message(self, fmt, *args):   # silence per-request spam
                pass

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-admin")
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("admin server not started")
        return self._httpd.server_address[1]

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "AdminServer":
        return self.start() if self._httpd is None else self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- dispatch ----------------------------------------------------------- #
    def __dispatch_impl(self, h: BaseHTTPRequestHandler) -> None:
        url = urlparse(h.path)
        path, query = url.path.rstrip("/") or "/", parse_qs(url.query)
        try:
            if path == "/healthz":
                self._json(h, {"ok": True})
            elif path == "/readyz":
                self._readyz(h)
            elif path == "/metrics":
                self._text(h, registry().to_prometheus(),
                           content_type="text/plain; version=0.0.4")
            elif path == "/metrics.json":
                self._json(h, {"metrics": registry().snapshot()})
            elif path == "/traces":
                self._traces(h)
            elif path.startswith("/traces/"):
                self._trace_one(h, path[len("/traces/"):])
            elif path == "/routing":
                self._routing(h)
            elif path == "/autopilot/decisions":
                self._decisions(h, query)
            elif path == "/tiered/runs":
                self._tiered_runs(h)
            elif path == "/tiered/cache":
                self._tiered_cache(h)
            elif path == "/slo":
                self._slo(h)
            elif path == "/profile/cpu":
                self._profile(h, query)
            else:
                self._json(h, {"error": f"no such endpoint {path!r}"},
                           status=404)
        except Exception as e:              # never raise into the socket
            try:
                self._json(h, {"error": f"{type(e).__name__}: {e}"},
                           status=500)
            except Exception:
                pass
    _dispatch = __dispatch_impl   # see the _impl note

    # -- response helpers --------------------------------------------------- #
    @staticmethod
    def __text_impl(h, body: str, status: int = 200,
                    content_type: str = "text/plain; charset=utf-8") -> None:
        data = body.encode("utf-8")
        h.send_response(status)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
    _text = __text_impl   # see the _impl note

    @classmethod
    def _json(cls, h, obj, status: int = 200) -> None:
        cls._text(h, json.dumps(sanitize(obj), sort_keys=True, indent=1),
                  status=status, content_type="application/json")

    # -- endpoints ----------------------------------------------------------- #
    def _readyz(self, h) -> None:
        w = self.warren
        if w is None:
            self._json(h, {"ready": True, "warren": None})
            return
        try:
            table = w.routing
            self._json(h, {"ready": True, "epoch": table.epoch,
                           "groups": len(w.groups)})
        except Exception as e:
            self._json(h, {"ready": False,
                           "error": f"{type(e).__name__}: {e}"}, status=503)

    def _traces(self, h) -> None:
        out = []
        for t in tracer().traces():
            root = t.root
            out.append({
                "trace_id": t.trace_id,
                "root": root.name if root is not None else None,
                "duration_ms": t.duration_ms,
                "error": root.error if root is not None else False,
                "n_spans": len(t.spans),
            })
        self._json(h, {"traces": out})

    def _trace_one(self, h, ident: str) -> None:
        try:
            tid = int(ident)
        except ValueError:
            self._json(h, {"error": f"bad trace id {ident!r}"}, status=400)
            return
        t = tracer().trace_by_id(tid)
        if t is None:
            self._json(h, {"error": f"no trace {tid} in the ring"},
                       status=404)
            return
        self._json(h, {"trace": t.to_record(), "tree": t.tree()})

    def _routing(self, h) -> None:
        if self.warren is None:
            self._json(h, {"error": "no warren attached"}, status=404)
            return
        self._json(h, self.warren.describe_routing())

    def _decisions(self, h, query) -> None:
        if self.controller is None:
            self._json(h, {"error": "no controller attached"}, status=404)
            return
        try:
            n = int(query.get("n", ["50"])[0])
        except ValueError:
            n = 50
        ds = self.controller.decisions[-max(n, 0):]
        self._json(h, {"tick": self.controller.tick_count,
                       "decisions": [d.to_record() for d in ds]})

    def _tiered_runs(self, h) -> None:
        if self.tiered is not None:
            self._json(h, self.tiered.runs_info())
            return
        if self.warren is not None:
            demoted = {str(g): d
                       for g, d in enumerate(self.warren.demoted())
                       if d is not None}
            self._json(h, {"tiered": None, "demoted_groups": demoted})
            return
        self._json(h, {"error": "no tiered store or warren attached"},
                   status=404)

    def _tiered_cache(self, h) -> None:
        cache = getattr(self.tiered, "block_cache", None)
        if cache is None:
            from repro_torch.tiered import default_block_cache
            cache = default_block_cache()
        self._json(h, cache.stats())

    def _slo(self, h) -> None:
        if self.slo is None:
            self._json(h, {"error": "no SLO monitor attached"}, status=404)
            return
        self._json(h, self.slo.report())

    def _profile(self, h, query) -> None:
        try:
            seconds = float(query.get("seconds", ["1.0"])[0])
        except ValueError:
            self._json(h, {"error": "seconds must be a number"},
                       status=400)
            return
        seconds = min(max(seconds, 0.05), PROFILE_MAX_SECONDS)
        self._text(h, profile_for(seconds) + "\n")
