"""Agent HTTP server: /metrics, /healthz, /readyz, /debug/pprof (a copy of
retina_tpu/server.py over the port's exporter).

Reference analog: pkg/server/server.go — a chi mux serving promhttp over
the combined gatherer (:61-63), pprof handlers (:46-56), and health
endpoints wired by the daemon (cmd/standard/daemon.go:217-222) so kubelet
can restart an unhealthy agent.

Python analog: a ThreadingHTTPServer. /debug/pprof/profile runs cProfile
for ``seconds=N`` and returns pstats text; /debug/pprof/heap returns a
tracemalloc snapshot if tracing is on; /debug/vars dumps runtime counters.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import threading
import time
import tracemalloc
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from retina_tpu_torch.exporter import Exporter, get_exporter
from retina_tpu_torch.log import logger
from retina_tpu_torch.utils import buildinfo

_log = logger("server")


class Server:
    """HTTP server manager (reference pkg/server + servermanager)."""

    def __init__(
        self,
        addr: str = "127.0.0.1:10093",
        exporter: Optional[Exporter] = None,
        ready_check: Optional[Callable[[], bool]] = None,
        healthy_check: Optional[Callable[[], bool]] = None,
        gather: Optional[Callable[[], bytes]] = None,
        metrics_cache_ttl_s: float = 0.5,
    ) -> None:
        host, _, port = addr.rpartition(":")
        self._host, self._port = host or "127.0.0.1", int(port)
        self._exporter = exporter or get_exporter()
        self._gather = gather or self._exporter.gather_text
        self._ready = ready_check or (lambda: True)
        self._healthy = healthy_check or (lambda: True)
        self._vars: dict[str, Callable[[], object]] = {}
        # Extension GET routes registered by subsystems (timetravel
        # query API): path -> fn(query_dict) -> (code, body, ctype).
        # Populated before start() or from single daemon-thread wiring;
        # read-only lookups on handler threads thereafter.
        self._routes: dict[
            str, Callable[[dict], tuple[int, bytes, str]]
        ] = {}
        # Extension POST routes (obs debug profile API): same contract
        # as _routes, separate table so a GET on a POST-only path (and
        # vice versa) is a clean 405, not a silent dispatch.
        self._post_routes: dict[
            str, Callable[[dict], tuple[int, bytes, str]]
        ] = {}
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # Rendering tens of thousands of pod-level series is Python-heavy;
        # gauges only change at the metrics module's >=1s publish cadence,
        # so a render cache is lossless. On TTL expiry the scrape serves
        # the STALE body and kicks a background re-render, so scrape
        # latency never includes a render: a scrape sees series at most
        # one scrape interval plus one render older than live. 0 disables
        # (render inline, uncached).
        self._cache_ttl = metrics_cache_ttl_s
        self._cache_lock = threading.Lock()
        self._cache_body: bytes = b""
        self._cache_time = 0.0
        self._render_kick = threading.Event()
        self._render_stop = threading.Event()
        self._render_thread: threading.Thread | None = None
        self._render_flight = threading.Lock()
        self._render_failing = False
        # First moment a STALE body was served with refresh demand
        # outstanding; None once a render lands. Staleness-under-demand
        # is the failure signal — it catches a renderer that HANGS as
        # well as one that raises (an idle gap with no scrapes never
        # starts the clock).
        self._stale_since: float | None = None

    def _render(self) -> bytes:
        body = self._gather()
        with self._cache_lock:
            self._cache_body = body
            self._cache_time = time.monotonic()
            self._render_failing = False
            self._stale_since = None
        return body

    def _render_loop(self) -> None:
        while True:
            self._render_kick.wait()
            if self._render_stop.is_set():
                return
            self._render_kick.clear()
            try:
                self._render()
            except Exception:
                self._render_failing = True
                _log.exception("background metrics render failed")

    # Serve-stale grace: with the renderer persistently failing, a body
    # older than this many TTLs stops being served — a frozen-but-200
    # exposition would hide the failure from every alert.
    STALE_FAIL_TTLS = 10

    def _metrics_body(self) -> bytes:
        if self._cache_ttl <= 0:
            return self._gather()
        with self._cache_lock:
            body = self._cache_body
            age = time.monotonic() - self._cache_time
        if body and age < self._cache_ttl:
            return body
        if body and self._render_thread is not None:
            # Serve stale, refresh off the scrape path — but not
            # forever: a renderer that keeps failing OR hanging must
            # surface as a failed scrape, not as indefinitely frozen
            # values. The clock starts at the first stale-served scrape
            # and resets when a render completes.
            now = time.monotonic()
            with self._cache_lock:
                if self._stale_since is None:
                    self._stale_since = now
                stalled = now - self._stale_since
            if stalled > max(self.STALE_FAIL_TTLS * self._cache_ttl, 10.0):
                raise RuntimeError(
                    f"metrics render stalled {stalled:.0f}s "
                    f"(failing={self._render_failing}); cache "
                    f"{age:.0f}s old"
                )
            self._render_kick.set()
            return body
        # First render (start() pre-warms, so this is tests/direct
        # callers only): single-flight so concurrent scrapers don't all
        # re-render 50k series in parallel.
        with self._render_flight:
            with self._cache_lock:
                fresh = (
                    self._cache_body
                    and time.monotonic() - self._cache_time < self._cache_ttl
                )
                if fresh:
                    return self._cache_body
            return self._render()

    def expose_var(self, name: str, fn: Callable[[], object]) -> None:
        """Register a /debug/vars entry (expvar analog)."""
        self._vars[name] = fn

    def register_route(
        self,
        path: str,
        fn: Callable[[dict], tuple[int, bytes, str]],
    ) -> None:
        """Register an extension GET route (chi-mux ``mux.Handle``
        analog). ``fn`` receives the parsed query dict (parse_qs form:
        name -> list of values) and returns (status, body, ctype); it
        runs on handler threads and must bound its own latency."""
        self._routes[path.rstrip("/") or "/"] = fn

    def register_post_route(
        self,
        path: str,
        fn: Callable[[dict], tuple[int, bytes, str]],
    ) -> None:
        """Register an extension POST route (same contract as
        :meth:`register_route`; ``fn`` receives the parsed query-string
        dict — request bodies are ignored by design, the debug API is
        parameter-only)."""
        self._post_routes[path.rstrip("/") or "/"] = fn

    @property
    def port(self) -> int:
        """Bound port (useful when constructed with port 0 in tests)."""
        assert self._httpd is not None
        return self._httpd.server_address[1]

    def start(self) -> None:
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: object) -> None:
                pass  # route request logs to our logger at debug only

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802
                try:
                    url = urlparse(self.path)
                    route = url.path.rstrip("/") or "/"
                    if route == "/metrics":
                        self._send(
                            200,
                            srv._metrics_body(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif route == "/healthz":
                        ok = srv._healthy()
                        self._send(200 if ok else 503,
                                   b"ok" if ok else b"unhealthy", "text/plain")
                    elif route == "/readyz":
                        ok = srv._ready()
                        self._send(200 if ok else 503,
                                   b"ok" if ok else b"not ready", "text/plain")
                    elif route == "/version":
                        self._send(200, buildinfo.VERSION.encode(), "text/plain")
                    elif route == "/debug/vars":
                        doc = {k: f() for k, f in srv._vars.items()}
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/pprof/profile":
                        q = parse_qs(url.query)
                        seconds = min(float(q.get("seconds", ["1"])[0]), 30.0)
                        prof = cProfile.Profile()
                        prof.enable()
                        time.sleep(seconds)
                        prof.disable()
                        out = io.StringIO()
                        pstats.Stats(prof, stream=out).sort_stats(
                            "cumulative"
                        ).print_stats(50)
                        self._send(200, out.getvalue().encode(), "text/plain")
                    elif route == "/debug/pprof/heap":
                        if not tracemalloc.is_tracing():
                            tracemalloc.start()
                            self._send(202, b"tracing started; re-request",
                                       "text/plain")
                            return
                        snap = tracemalloc.take_snapshot()
                        lines = [str(s) for s in snap.statistics("lineno")[:50]]
                        self._send(200, "\n".join(lines).encode(), "text/plain")
                    elif route in srv._routes:
                        code, body, ctype = srv._routes[route](
                            parse_qs(url.query)
                        )
                        self._send(code, body, ctype)
                    elif route in srv._post_routes:
                        self._send(405, b"use POST", "text/plain")
                    else:
                        self._send(404, b"not found", "text/plain")
                except BrokenPipeError:  # noqa: RT101 — client hung up mid-response
                    pass
                except Exception:
                    _log.exception("handler error path=%s", self.path)
                    try:
                        self._send(500, b"internal error", "text/plain")
                    except Exception:  # noqa: RT101 — 500 write raced the hangup; already logged
                        pass

            def do_POST(self) -> None:  # noqa: N802
                try:
                    # Drain (and discard) any body so keep-alive framing
                    # stays correct; POST routes take query params only.
                    length = int(self.headers.get("Content-Length") or 0)
                    if length > 0:
                        self.rfile.read(min(length, 1 << 20))
                    url = urlparse(self.path)
                    route = url.path.rstrip("/") or "/"
                    if route in srv._post_routes:
                        code, body, ctype = srv._post_routes[route](
                            parse_qs(url.query)
                        )
                        self._send(code, body, ctype)
                    elif route in srv._routes:
                        self._send(405, b"use GET", "text/plain")
                    else:
                        self._send(404, b"not found", "text/plain")
                except BrokenPipeError:  # noqa: RT101 — client hung up mid-response
                    pass
                except Exception:
                    _log.exception("handler error path=%s", self.path)
                    try:
                        self._send(500, b"internal error", "text/plain")
                    except Exception:  # noqa: RT101 — 500 write raced the hangup; already logged
                        pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-server", daemon=True
        )
        self._thread.start()
        if self._cache_ttl > 0:
            self._render_stop.clear()
            self._render_thread = threading.Thread(
                target=self._render_loop, name="metrics-render", daemon=True
            )
            self._render_thread.start()
            try:
                # Pre-warm so the FIRST scrape is already a cache hit
                # (boot-time registries are small; this is cheap).
                self._render()
            except Exception:
                _log.exception("metrics render pre-warm failed")
        _log.info("http server listening on %s:%d", self._host, self.port)

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._render_thread is not None:
            self._render_stop.set()
            self._render_kick.set()
            self._render_thread.join(timeout=10.0)
            self._render_thread = None
