"""Minimal stdlib HTTP front-end over a :class:`~repro_torch.gateway.
gateway.Gateway` (port of ``repro/gateway/http.py``) — enough surface to
curl the tier, not a web framework.

Routes (all GET, all JSON):

* ``/pagerank?epsilon=&delta=&k=``        — batch top-k of the full vector
* ``/topk?k=&epsilon=&delta=&slo_s=&timeout_s=`` — async global top-k,
  driven to completion before responding (the HTTP surface is
  synchronous; the async path is the Python API)
* ``/ppr?source=&k=&epsilon=&delta=``     — personalized PageRank
* ``/healthz``                            — 200 iff the tier is routable
* ``/metrics``                            — :meth:`Gateway.stats` snapshot

Status mapping — every failure is structured, never a hang:

* **429** — replica admission refused; body carries the scheduler's
  ``reason_code`` (``infeasible_slo`` | ``capacity`` | ``shard_loss``).
* **503 + Retry-After** — the gateway shed the request
  (:class:`~repro_torch.gateway.gateway.GatewayOverloadError`: breakers all
  open, backlog past the shed threshold, or draining); ``reason_code``
  names which.
* **504** — the request's ``timeout_s`` deadline (default 30 s) expired
  before the (ε, δ) certificate was earned; ``reason_code="deadline"``.
* **400** bad parameters; **404** unknown path; **500** anything else,
  surfaced with its exception type.

Concurrency: there is **no per-process query lock**. Submits are
serialized by the gateway's own brief host-state lock, and wave driving
is serialized per replica inside the supervised pool — so a stalled or
crashed replica cannot block ``/healthz``, ``/metrics``, or queries
routed to healthy replicas; its own requests fail over or return 504.
Handler threads launch their waves on the gateway's device (the pool
sets it around each wave), not on the thread's current device.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.gateway.gateway import Gateway, GatewayOverloadError

__all__ = ["GatewayHTTPServer", "serve_http"]

# wall-time budget for driving one HTTP request to certification; callers
# override per request with ?timeout_s=.
_DEFAULT_TIMEOUT_S = 30.0


def _result_payload(handle_or_result, source: str) -> dict:
    r = handle_or_result
    return {
        "kind": r.kind,
        "vertices": np.asarray(r.vertices).tolist(),
        "scores": np.asarray(r.scores).tolist(),
        "epsilon_bound": float(r.epsilon_bound),
        "num_walks": int(r.num_walks),
        "waves": int(r.waves),
        "latency_s": float(r.latency_s),
        "degraded": bool(r.degraded),
        "source": source,
    }


class _Handler(BaseHTTPRequestHandler):
    gateway: Gateway = None          # injected by GatewayHTTPServer

    def log_message(self, fmt, *args):   # noqa: D102 — silence stderr spam
        pass

    def _send(self, code: int, payload: dict, headers=()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _param(self, qs, name, cast, default):
        raw = qs.get(name)
        if raw is None:
            if default is None:
                raise ValueError(f"missing required parameter {name!r}")
            return default
        return cast(raw[0])

    def do_GET(self):                # noqa: N802 — http.server contract
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        try:
            self._route(url.path, qs)
        except ValueError as e:
            self._send(400, {"error": str(e)})
        except GatewayOverloadError as e:
            # structured backpressure, not failure: the tier is telling
            # the client when to come back.
            self._send(503, {"error": str(e),
                             "reason_code": e.reason,
                             "retry_after_s": e.retry_after_s},
                       headers=[("Retry-After",
                                 str(max(1, int(round(e.retry_after_s)))))])
        except TimeoutError as e:
            self._send(504, {"error": str(e), "reason_code": "deadline"})
        except Exception as e:      # surfaced, not swallowed: curl sees it
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _route(self, path: str, qs) -> None:
        gw = self.gateway
        if path == "/healthz":       # lock-free: must answer even when a
            ok = gw.healthy()        # replica is stalled mid-wave
            self._send(200 if ok else 503,
                       {"healthy": ok,
                        "replicas": len(gw.pool),
                        "routable": gw.pool.routable(),
                        "lost_shards": sorted(
                            s for r in gw.pool.replicas
                            for s in r.lost_shards)})
            return
        if path == "/metrics":
            self._send(200, gw.stats())
            return
        k = self._param(qs, "k", int, 10)
        epsilon = self._param(qs, "epsilon", float, 0.3)
        delta = self._param(qs, "delta", float, 0.1)
        if path == "/pagerank":
            hits_before = gw.metrics.cache_hits
            res = gw.pagerank(epsilon=epsilon, delta=delta, k=k)
            src = "cache" if gw.metrics.cache_hits > hits_before else "live"
            self._send(200, _result_payload(res, src))
            return
        if path in ("/topk", "/ppr"):
            slo_s = self._param(qs, "slo_s", float, 0.0) or None
            timeout_s = self._param(qs, "timeout_s", float,
                                    _DEFAULT_TIMEOUT_S)
            if path == "/ppr":
                source = self._param(qs, "source", int, None)
                h = gw.ppr(source, k=k, epsilon=epsilon, delta=delta,
                           slo_s=slo_s)
            else:
                h = gw.topk(k=k, epsilon=epsilon, delta=delta, slo_s=slo_s)
            if not h.admitted:
                d = h.decision
                self._send(429, {
                    "error": "rejected at admission",
                    "reason": d.reason,
                    "reason_code": d.reason_code.value,
                })
                return
            self._send(200, _result_payload(h.result(timeout_s=timeout_s),
                                            h.source))
            return
        self._send(404, {"error": f"no route {path!r}",
                         "routes": ["/pagerank", "/topk", "/ppr",
                                    "/healthz", "/metrics"]})


class GatewayHTTPServer:
    """Owns the listening socket + serving thread for one gateway.

    ``port=0`` (the default) binds an ephemeral port — read it back from
    :attr:`port` / :attr:`url`. ``close()`` stops the thread; the gateway
    itself is NOT closed (the caller owns it).
    """

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0):
        self.gateway = gateway
        handler = type("BoundHandler", (_Handler,), {"gateway": gateway})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "GatewayHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
                name="frogwild-gateway-http", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "GatewayHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(gateway: Gateway, host: str = "127.0.0.1",
               port: int = 0) -> GatewayHTTPServer:
    """Starts (and returns) an HTTP front-end bound to ``gateway``."""
    return GatewayHTTPServer(gateway, host, port).start()
