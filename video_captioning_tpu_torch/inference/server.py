"""Captioning server: HTTP front end + dynamic batcher over the predictor.

Counterpart of video_captioning_tpu/inference/server.py, with the same
endpoints and HTTP codes, duck-typed on ``predictor.predict_batch`` and
``predictor.config``. Concurrent requests coalesce into device batches; one
batcher thread runs the predictor, so the kernels launch on that thread's
current CUDA stream.

Design: stdlib-only (``http.server`` threading front end; no framework
dependency). Requests enqueue (features, options, Event); the batcher
thread drains the queue — everything waiting, up to ``max_batch`` — runs
ONE ``predict_batch`` call per distinct option-set, and resolves the
events. Under load, batches fill to ``max_batch``; idle requests wait at
most ``max_wait_ms``.

Endpoints:
  GET  /healthz            -> {"status": "ok", ...}
  GET  /metrics            -> request/batch counters, live queue depth,
                              batch-occupancy histogram, latency
                              p50/p95/p99 (JSON; ?format=prometheus for
                              text exposition)
  POST /caption            -> body {"features": [[...],...], "method":
                              "greedy"|"beam"|"sample", "max_length": N,
                              "beam_size": K} -> {"caption": ..., ...}
  POST /caption_batch      -> {"items": [{"features": ...}, ...]} +
                              shared options -> {"results": [...]}

Shutdown: ``close()`` stops accepting connections, then DRAINS — every
already-accepted request is batched, run, and resolved before the batcher
thread exits (no dropped in-flight work on deploy rollovers).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_GEN_KEYS = ("method", "max_length", "beam_size", "length_penalty",
             "temperature")
_DEFAULTS = {"method": "greedy", "max_length": 20, "beam_size": 5,
             "length_penalty": 1.0, "temperature": 1.0}
_METHODS = ("greedy", "beam", "sample")


class ServerFault(RuntimeError):
    """A server-side failure (device error, predictor bug) — mapped to
    HTTP 500, unlike request-validation ValueErrors (400)."""


class ServerDraining(RuntimeError):
    """Raised for submits that arrive after shutdown began — mapped to
    HTTP 503 so load balancers retry on another replica."""


@dataclass
class _Pending:
    features: np.ndarray
    options: tuple
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None
    submitted_at: float = field(default_factory=time.monotonic)


# Batch-occupancy histogram bucket upper bounds (inclusive).
_OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class DynamicBatcher:
    """Coalesces concurrent caption requests into device batches."""

    def __init__(self, predictor, max_batch: int = 64,
                 max_wait_ms: float = 5.0,
                 latency_window: int = 4096):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.defaults = dict(_DEFAULTS)
        self.queue: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_items": 0,
                      "batch_errors": 0}
        self._started_at = time.monotonic()
        # Observability state (lock-protected: the HTTP threads read while
        # the batcher thread writes).
        self._metrics_lock = threading.Lock()
        self._occupancy = {b: 0 for b in _OCCUPANCY_BUCKETS}
        from collections import deque

        self._latencies = deque(maxlen=latency_window)  # seconds
        self._rejecting = False
        self._stop = threading.Event()   # graceful: exit once drained
        self._abort = threading.Event()  # forced: exit now, fail leftovers
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, features: np.ndarray, options: Dict) -> _Pending:
        if self._rejecting:
            raise ServerDraining("server is shutting down")
        opts = tuple(sorted({**self.defaults, **options}.items()))
        item = _Pending(features=features, options=opts)
        with self._metrics_lock:  # HTTP threads submit concurrently
            self.stats["requests"] += 1
        self.queue.put(item)
        return item

    def close(self, drain: bool = True, timeout: float = 60.0):
        """Stop the batcher. ``drain=True`` (default) first refuses new
        submits, then lets the loop run every already-queued request to
        completion — no accepted request is dropped on shutdown.
        ``drain=False`` aborts immediately; queued requests resolve with a
        shutdown error instead of hanging until the request timeout."""
        self._rejecting = True
        if not drain:
            self._abort.set()
        self._stop.set()
        self._thread.join(timeout=max(5.0, timeout))

    # --------------------------------------------------------- metrics

    def metrics(self) -> Dict[str, object]:
        """Production observability snapshot: counters, live queue depth,
        batch-occupancy histogram, and request-latency quantiles over the
        last ``latency_window`` requests (submit → resolution, i.e. queue
        wait + device time)."""
        with self._metrics_lock:
            lat = sorted(self._latencies)
            occupancy = dict(self._occupancy)
        batches = max(1, self.stats["batches"])

        def pct(p: float) -> Optional[float]:
            if not lat:
                return None
            return round(1000.0 * lat[min(len(lat) - 1,
                                          int(p * len(lat)))], 3)

        return {
            **self.stats,
            "queue_depth": self.queue.qsize(),
            "mean_batch_occupancy": round(
                self.stats["batched_items"] / batches, 3),
            "batch_occupancy_histogram": {
                f"le_{b}": n for b, n in occupancy.items()
            },
            "latency_ms": {"p50": pct(0.50), "p95": pct(0.95),
                           "p99": pct(0.99),
                           "window": len(lat)},
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_s * 1000.0,
            "uptime_s": round(time.monotonic() - self._started_at, 3),
            "draining": self._rejecting,
        }

    # ------------------------------------------------------------------

    def _drain(self, first: _Pending) -> List[_Pending]:
        """Collect everything already waiting (same option-set as
        ``first``), topping up until max_batch or max_wait elapses."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        leftovers: List[_Pending] = []
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self.queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item.options == first.options:
                batch.append(item)
            else:
                leftovers.append(item)
        for item in leftovers:  # differing options: next loop iteration
            self.queue.put(item)
        return batch

    def _loop(self):
        # Keep serving until stopped AND drained: a stop with queued work
        # (graceful shutdown) still runs every accepted request.
        while not self._abort.is_set() and not (
            self._stop.is_set() and self.queue.empty()
        ):
            try:
                first = self.queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = self._drain(first)
            opts = dict(batch[0].options)
            failed = False
            try:
                results = self.predictor.predict_batch(
                    [item.features for item in batch], **opts
                )
                for item, res in zip(batch, results):
                    item.result = res
            except Exception as e:  # surface per-request, keep serving
                logger.exception("batch failed")
                failed = True
                for item in batch:
                    item.error = f"{type(e).__name__}: {e}"
            now = time.monotonic()
            self.stats["batches"] += 1
            self.stats["batched_items"] += len(batch)
            if failed:
                self.stats["batch_errors"] += 1
            with self._metrics_lock:
                for b in _OCCUPANCY_BUCKETS:
                    if len(batch) <= b:
                        self._occupancy[b] += 1
                        break
                for item in batch:
                    self._latencies.append(now - item.submitted_at)
            for item in batch:
                item.done.set()
        # Forced (non-drain) stop: resolve whatever is still queued so
        # awaiting request threads fail fast instead of timing out.
        try:
            while True:
                item = self.queue.get_nowait()
                item.error = "server is shutting down"
                item.done.set()
        except queue.Empty:
            pass


class CaptionServer:
    """HTTP captioning service over a predictor."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 request_timeout_s: float = 120.0):
        self.batcher = DynamicBatcher(predictor, max_batch, max_wait_ms)
        self.request_timeout_s = request_timeout_s
        self.feature_dim = int(predictor.config.model.cnn_feature_dim)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through logging
                logger.debug("http: " + fmt, *args)

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok", **server.batcher.stats})
                elif self.path.split("?")[0] == "/metrics":
                    metrics = server.batcher.metrics()
                    if "format=prometheus" in self.path:
                        body = _prometheus_text(metrics).encode()
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._send(200, metrics)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:
                    self._send(400, {"error": f"bad json: {e}"})
                    return
                try:
                    if self.path == "/caption":
                        self._send(200, server.handle_single(payload))
                    elif self.path == "/caption_batch":
                        self._send(200, server.handle_batch(payload))
                    else:
                        self._send(404, {"error": "not found"})
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except TimeoutError as e:
                    self._send(504, {"error": str(e)})
                except ServerDraining as e:
                    self._send(503, {"error": str(e)})
                except ServerFault as e:
                    self._send(500, {"error": str(e)})
                except Exception as e:  # never drop the connection
                    logger.exception("unhandled request error")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # ------------------------------------------------------------------

    def _parse_features(self, obj) -> np.ndarray:
        try:
            feats = np.asarray(obj, dtype=np.float32)
        except Exception as e:  # ragged lists raise TypeError/ValueError
            raise ValueError(f"features are not a numeric array: {e}")
        if feats.ndim != 2:
            raise ValueError(
                f"features must be a (frames, feature_dim) 2-D array, got "
                f"shape {feats.shape}"
            )
        # Reject dim mismatches HERE: the batcher coalesces concurrent
        # requests, so one bad shape inside predict_batch would fail every
        # batchmate (and misreport a client error as a batch fault).
        expected = self.feature_dim
        if feats.shape[1] != expected:
            raise ValueError(
                f"feature_dim mismatch: model expects {expected}, got "
                f"{feats.shape[1]}"
            )
        if feats.shape[0] == 0:
            raise ValueError("features must contain at least one frame")
        return feats

    def _parse_options(self, payload: dict) -> dict:
        opts = {k: payload[k] for k in _GEN_KEYS if k in payload}
        if "method" in opts and opts["method"] not in _METHODS:
            raise ValueError(f"unknown method: {opts['method']}")
        return opts

    def _await(self, item: _Pending) -> dict:
        if not item.done.wait(self.request_timeout_s):
            raise TimeoutError("caption request timed out")
        if item.error is not None:
            # Inputs were validated at parse time, so a batch-level failure
            # is a server fault (device error, predictor bug) -> HTTP 500.
            raise ServerFault(item.error)
        res = dict(item.result)
        res.pop("attention_weights", None)  # not JSON-serializable
        return res

    def handle_single(self, payload: dict) -> dict:
        if "features" not in payload:
            raise ValueError("missing 'features'")
        feats = self._parse_features(payload["features"])
        opts = self._parse_options(payload)
        return self._await(self.batcher.submit(feats, opts))

    def handle_batch(self, payload: dict) -> dict:
        items = payload.get("items")
        if not isinstance(items, list) or not items:
            raise ValueError("missing 'items' list")
        opts = self._parse_options(payload)
        # Validate EVERY item before submitting any: a malformed entry must
        # 400 without leaving already-submitted batchmates un-awaited.
        parsed = []
        for i, it in enumerate(items):
            if not isinstance(it, dict) or "features" not in it:
                raise ValueError(f"items[{i}] missing 'features'")
            try:
                parsed.append(self._parse_features(it["features"]))
            except ValueError as e:
                raise ValueError(f"items[{i}]: {e}")
        pending = [self.batcher.submit(f, opts) for f in parsed]
        return {"results": [self._await(p) for p in pending]}

    # ------------------------------------------------------------------

    def start(self):
        self._serve_thread.start()
        logger.info(f"caption server listening on :{self.port}")

    def serve_forever(self):
        self.start()
        self._serve_thread.join()

    def metrics(self) -> Dict[str, object]:
        return self.batcher.metrics()

    def close(self, drain: bool = True):
        """Graceful shutdown: stop accepting connections FIRST, then drain
        the batcher so every accepted request resolves before exit."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close(drain=drain)


def _prometheus_text(metrics: Dict[str, object]) -> str:
    """Render the metrics snapshot in Prometheus text exposition format."""
    lines = []

    def emit(name, value, help_text=None, labels=""):
        if value is None:
            return
        if help_text:
            lines.append(f"# HELP vct_{name} {help_text}")
            lines.append(f"# TYPE vct_{name} gauge")
        lines.append(f"vct_{name}{labels} {value}")

    emit("requests_total", metrics["requests"], "Accepted caption requests")
    emit("batches_total", metrics["batches"], "Device batches dispatched")
    emit("batched_items_total", metrics["batched_items"],
         "Requests served through batches")
    emit("batch_errors_total", metrics["batch_errors"],
         "Batches that failed server-side")
    emit("queue_depth", metrics["queue_depth"], "Requests waiting")
    emit("mean_batch_occupancy", metrics["mean_batch_occupancy"],
         "Mean requests per device batch")
    emit("uptime_seconds", metrics["uptime_s"], "Batcher uptime")
    first = True
    for bucket, count in metrics["batch_occupancy_histogram"].items():
        emit("batch_occupancy_bucket", count,
             "Batch size histogram" if first else None,
             labels=f'{{le="{bucket[3:]}"}}')
        first = False
    lat = metrics["latency_ms"]
    for q in ("p50", "p95", "p99"):
        emit(f"latency_ms_{q}", lat[q],
             f"Request latency {q} over the last {lat['window']} requests")
    return "\n".join(lines) + "\n"
