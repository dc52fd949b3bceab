"""Stdlib HTTP front-end for :class:`~mmlspark_tpu_torch.serve.server.Server`.

The port of ``mmlspark_tpu/serve/http.py``: the same routes and the same
mapping of errors to status codes and ``Retry-After``. JSON in, JSON out,
zero new dependencies. Endpoints:

- ``POST /score`` — body ``{"model": "name", "x": [[...], ...],
  "deadline_ms": 50}`` (``x`` one row or a list of rows; ``deadline_ms``
  optional). 200 -> ``{"y": [[...], ...]}`` (plus the request's
  ``trace_id`` for single-row bodies — grep it in the event log /
  exported trace). Error mapping keeps the
  server's admission semantics visible to HTTP clients:
  ``ServerOverloaded`` -> **503** (with ``Retry-After: 0``, the
  HTTP-native "retryable" signal — ``default_retryable`` already treats
  5xx as retryable on the client side), ``RequestExpired`` -> **504**,
  unknown model / malformed body -> **400**.
- ``POST /generate`` — the generative lane: body ``{"model", "prompt":
  [token ids], "max_new_tokens", "temperature", "top_k", "seed",
  "deadline_ms", "trace_id"}`` -> ``{"tokens", "finish_reason",
  "ttft_ms", "itl_mean_ms", "trace_id"}``. Same error mapping as
  ``/score``; a KV-arena-full shed is a 503 with ``Retry-After``, and a
  deadline lapsing MID-decode is a 200 with the partial stream
  (``finish_reason: "deadline"``) — deadline accounting is per token.
- ``GET /healthz`` — liveness AND readiness in one body
  (``{"status", "live", "ready", "state", "stats"}``): a draining server
  is still ``live`` (in-flight work finishes) but not ``ready`` (stop
  sending traffic) — the split the fleet router routes on.
- ``GET /livez`` / ``GET /readyz`` — the k8s-style probe pair: ``/livez``
  is 200 while the process serves its in-flight work (even draining);
  ``/readyz`` turns 503 the moment admission stops, so a load balancer
  rotates the replica out BEFORE it dies.
- ``GET /models`` — registered model names (+ served versions).
- ``GET /metrics`` — Prometheus text exposition of the process registry.
- ``GET /affinity`` — prefix-digest advertisement: per generative model
  the top-K resident KV prefix chains plus the hash parameters they were
  keyed with, so a fleet scraper can score this replica by expected
  prefix-hit depth without moving any KV bytes.

``ThreadingHTTPServer`` gives one thread per connection; they all funnel
into the server's bounded queue, so concurrency is capped by admission
control, not by transport threads. Request logging routes through the
framework logger (debug level), not BaseHTTPRequestHandler's stderr
``log_message``.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.observability import metrics
from mmlspark_tpu_torch.serve.server import (
    RequestExpired, ServeError, Server, ServerClosed, ServerOverloaded,
)
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.http")

MAX_BODY_BYTES = 64 * 1024 * 1024   # one request never buffers more


def _fmt_after(seconds: float) -> str:
    """Retry-After header value: integral seconds render as delta-seconds
    per RFC 7231 ("0", "1"); sub-second asks keep the decimal — our own
    clients (HttpReplica, the retry layer) parse floats."""
    s = float(seconds)
    return str(int(s)) if s.is_integer() else str(s)


def make_handler(server: Server):
    """Handler class bound to one :class:`Server` (stdlib handlers are
    instantiated per request; the closure carries the server)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route, don't print
            logger.debug("http %s", fmt % args)

        def _reply(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                # liveness and readiness, split: a draining server is
                # still LIVE (in-flight work finishes, /healthz answers)
                # but no longer READY for new traffic — routers read
                # "draining" and rotate it out before it stops being alive
                h = server.health()
                status = "ok" if h["ready"] else h["state"]
                self._reply(200, {"status": status, **h,
                                  "stats": server.stats()})
            elif self.path == "/livez":
                h = server.health()
                self._reply(200 if h["live"] else 503, h)
            elif self.path == "/readyz":
                h = server.health()
                self._reply(200 if h["ready"] else 503, h)
            elif self.path == "/models":
                reg = server.registry
                payload = {"models": reg.names()}
                if hasattr(reg, "versions"):
                    payload["versions"] = reg.versions()
                self._reply(200, payload)
            elif self.path == "/affinity":
                # prefix-digest advertisement: the metrics-adjacent JSON
                # the fleet scraper pulls to score replicas by expected
                # prefix-hit depth. Per generative model: the top-K
                # resident chains plus the hashing parameters (kv dtype,
                # block size) the chain keys were seeded with — scorers
                # must hash prompts with the ADVERTISED params, never
                # guess them.
                tail = ".kv.resident_chains"
                digests = {}
                stats = server.stats()
                for k, v in stats.items():
                    if not (k.startswith("generate.") and k.endswith(tail)
                            and isinstance(v, list)):
                        continue
                    model = k[len("generate."):-len(tail)]
                    digests[model] = {
                        "chains": v,
                        "kv_dtype": str(stats.get(
                            f"generate.{model}.kv.kv_dtype") or ""),
                        "block_tokens": stats.get(
                            f"generate.{model}.kv.block_tokens"),
                    }
                self._reply(200, {"digests": digests})
            elif self.path == "/metrics":
                text = metrics.get_registry().prometheus_text()
                body = text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/generate":
                self._post_generate()
                return
            if self.path != "/score":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._reply(413, {"error": "body too large"})
                    return
                req = json.loads(self.rfile.read(n))
                model = req["model"]
                x = np.asarray(req["x"])
                deadline_ms = req.get("deadline_ms")
                # a fleet router threads its trace_id through so one id
                # correlates the whole failover chain across replicas
                rid = str(req.get("trace_id") or "") or None
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            trace_id = ""
            try:
                if x.ndim <= 1:
                    fut = server.submit_async(model, x, deadline_ms,
                                              trace_id=rid)
                    trace_id = getattr(fut, "trace_id", "")
                    y = fut.result()
                else:
                    # multi-row bodies fan out into several tickets; no
                    # single id to return
                    y = server.submit_many(model, x, deadline_ms)
            except ServerOverloaded as e:
                # Retry-After carries the server's own ask (a draining
                # replica says 1s — come back to the pool, not instantly
                # to us; a full queue says serving.retry_after_s)
                after = getattr(e, "retry_after", None)
                if after is None:
                    after = 1.0 if server.draining else 0.0
                self._reply(503, {"error": str(e), "retryable": True,
                                  "retry_after": after},
                            headers={"Retry-After": _fmt_after(after)})
            except ServerClosed as e:
                self._reply(503, {"error": str(e), "retryable": True},
                            headers={"Retry-After": "1"})
            except RequestExpired as e:
                self._reply(504, {"error": str(e)})
            except (KeyError, ValueError) as e:
                self._reply(400, {"error": str(e)})
            except ServeError as e:
                self._reply(500, {"error": str(e)})
            else:
                payload = {"y": np.asarray(y).tolist()}
                if trace_id:
                    payload["trace_id"] = trace_id
                self._reply(200, payload)

        def _post_generate(self):
            """``POST /generate`` — body ``{"model", "prompt": [ids...],
            "max_new_tokens", "temperature", "top_k", "seed", "eos_id",
            "deadline_ms", "trace_id"}``. Same error mapping as
            ``/score`` (shed -> 503 + Retry-After, pre-prefill expiry ->
            504, bad body -> 400). Deadline accounting is PER TOKEN: a
            deadline that lapses mid-decode returns 200 with the partial
            token stream and ``finish_reason: "deadline"`` — the tokens
            already sampled are not worthless."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    self._reply(413, {"error": "body too large"})
                    return
                req = json.loads(self.rfile.read(n))
                model = req["model"]
                prompt = [int(t) for t in req["prompt"]]
                kw = dict(
                    max_new_tokens=req.get("max_new_tokens"),
                    temperature=float(req.get("temperature", 0.0)),
                    top_k=int(req.get("top_k", 0)),
                    seed=int(req.get("seed", 0)),
                    eos_id=req.get("eos_id"),
                    deadline_ms=req.get("deadline_ms"),
                    trace_id=str(req.get("trace_id") or "") or None)
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                # a Server answers with a Future, a Router (the process
                # fleet's front) with the result itself
                out = server.submit_generate(model, prompt, **kw)
                if hasattr(out, "result"):
                    out = out.result()
            except ServerOverloaded as e:
                after = getattr(e, "retry_after", None)
                if after is None:
                    after = 1.0 if getattr(server, "draining", False) \
                        else 0.0
                self._reply(503, {"error": str(e), "retryable": True,
                                  "retry_after": after},
                            headers={"Retry-After": _fmt_after(after)})
            except ServerClosed as e:
                self._reply(503, {"error": str(e), "retryable": True},
                            headers={"Retry-After": "1"})
            except RequestExpired as e:
                self._reply(504, {"error": str(e)})
            except (KeyError, ValueError) as e:
                self._reply(400, {"error": str(e)})
            except ServeError as e:
                self._reply(500, {"error": str(e)})
            else:
                self._reply(200, out)

    return Handler


def serve_http(server: Server, host: str = "127.0.0.1", port: int = 8080,
               poll_s: float = 0.5) -> Tuple[ThreadingHTTPServer, str]:
    """Bind and return ``(httpd, "host:port")`` without blocking; callers
    run ``httpd.serve_forever()`` or drive ``handle_request`` themselves
    (tests). A :class:`Server` resolves ``runtime.device`` first, as every
    entry point does (:meth:`Server.check_device`); a :class:`Router` front
    holds no device (its replicas resolve their own)."""
    check = getattr(server, "check_device", None)
    if check is not None:
        check()
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    httpd.timeout = poll_s
    addr = f"{httpd.server_address[0]}:{httpd.server_address[1]}"
    logger.info("serving on http://%s (models: %s)",
                addr, ", ".join(server.registry.names()) or "none")
    return httpd, addr
