"""Opt-in stdlib-only HTTP endpoint: ``/metrics`` + ``/healthz``.

Reference parity: paddle_tpu/observability/http.py.  A serving process
calls ``serve_metrics(port)``, or sets ``PADDLE_TPU_TORCH_METRICS_PORT``
and lets ``maybe_serve_from_env()`` start it, and a daemon thread
answers:

- ``GET /metrics``: Prometheus text exposition of the process registry;
- ``GET /healthz``: ``{"status": "ok"|"degraded", "uptime_s": ...}``, with
  the named checks that subsystems :func:`register_healthz` (``fn() ->
  (ok, detail)``): 200 while every check passes, 503 naming the failing
  ones while any fails.  A serving fleet registers one (its routable
  replicas).

stdlib ``http.server`` only.  The listener binds once per process
(``maybe_serve_from_env`` is idempotent) and never blocks shutdown
(daemon threads).
"""
import json
import threading
import time

from . import exporters as _exporters
from .metrics import registry as _global_registry

__all__ = ['MetricsHTTPServer', 'serve_metrics', 'maybe_serve_from_env',
           'register_healthz', 'unregister_healthz', 'healthz_report']

# name -> fn() -> (ok, detail): process-wide health checks aggregated
# into /healthz.  A check that RAISES reports as failing (a broken
# health probe is not healthy), never as a 500 — the endpoint must stay
# answerable precisely when things are going wrong.
_health_checks = {}
_health_lock = threading.Lock()


def register_healthz(name, fn):
    """Register (or replace) a named /healthz check.  ``fn`` takes no
    arguments and returns ``(ok: bool, detail)`` where ``detail`` is any
    JSON-serializable context (an age, a threshold, a message).  Checks
    run at request time on the endpoint's thread — keep them fast and
    thread-safe."""
    with _health_lock:
        _health_checks[str(name)] = fn


def unregister_healthz(name):
    """Remove a /healthz check; unknown names are a no-op (shutdown
    paths must be idempotent)."""
    with _health_lock:
        _health_checks.pop(str(name), None)


def healthz_report():
    """(all_ok, {name: {"ok": bool, "detail": ...}}) across every
    registered check — the dict /healthz serves under ``"checks"``."""
    with _health_lock:
        checks = list(_health_checks.items())
    out = {}
    all_ok = True
    for name, fn in checks:
        try:
            ok, detail = fn()
            ok = bool(ok)
        except Exception as e:  # a crashing check is a failing check
            ok, detail = False, 'check raised: %s' % (e,)
        all_ok = all_ok and ok
        out[name] = {'ok': ok, 'detail': detail}
    return all_ok, out


class MetricsHTTPServer(object):
    """Handle for a running /metrics endpoint: ``.port`` is the bound
    port (useful with port=0), ``.close()`` stops the listener."""

    def __init__(self, port, host=None, reg=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        if host is None:
            from ..flags import FLAGS
            host = FLAGS.metrics_host
        reg = reg or _global_registry()
        t_start = time.time()

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split('?', 1)[0]
                if path == '/metrics':
                    body = _exporters.prometheus_text(reg).encode()
                    ctype = 'text/plain; version=0.0.4; charset=utf-8'
                    code = 200
                elif path in ('/healthz', '/health'):
                    ok, checks = healthz_report()
                    doc = {'status': 'ok' if ok else 'degraded',
                           'uptime_s': round(time.time() - t_start, 3)}
                    if checks:
                        doc['checks'] = checks
                    body = (json.dumps(doc) + '\n').encode()
                    ctype = 'application/json'
                    code = 200 if ok else 503
                else:
                    body = b'paddle_tpu_torch: /metrics and /healthz\n'
                    ctype = 'text/plain'
                    code = 404
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name='paddle-tpu-torch-metrics-http', daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)


def serve_metrics(port=None, host=None, reg=None):
    """Start the /metrics + /healthz endpoint on a daemon thread.

    :param port: TCP port; ``None`` reads ``PADDLE_TPU_TORCH_METRICS_PORT``
        (an unset/0 flag then raises — explicit calls must name a port
        or set the env).  ``0`` binds an ephemeral port (tests).
    :param host: bind address; ``None`` reads ``PADDLE_TPU_TORCH_METRICS_HOST``
        (default loopback — the listener is unauthenticated, so binding
        wider must be a deliberate choice).
    :returns: :class:`MetricsHTTPServer` (``.port``, ``.close()``).
    """
    if port is None:
        from ..flags import FLAGS
        port = FLAGS.metrics_port
        if not port:
            raise ValueError(
                "serve_metrics(): no port given and "
                "PADDLE_TPU_TORCH_METRICS_PORT is unset/0")
    return MetricsHTTPServer(port, host=host, reg=reg)


_auto_server = None
_auto_lock = threading.Lock()


def maybe_serve_from_env():
    """Start the endpoint iff ``PADDLE_TPU_TORCH_METRICS_PORT`` is set to a
    nonzero port; idempotent (one listener per process).  Called by the
    serving runtime at startup; safe to call from anywhere.  Returns the
    server handle or None."""
    global _auto_server
    with _auto_lock:
        if _auto_server is not None:
            return _auto_server
        from ..flags import FLAGS
        port = FLAGS.metrics_port
        if not port:
            return None
        try:
            _auto_server = MetricsHTTPServer(port)
        except OSError as e:
            # telemetry must never take serving down: a second process
            # on the same host (EADDRINUSE) or a privileged port just
            # means no endpoint here, not a dead server
            import warnings
            warnings.warn("metrics endpoint did not start on port %s: %s"
                          % (port, e))
            return None
        return _auto_server
