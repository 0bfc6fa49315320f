"""Native (epoll C++) HTTP front for the serving layer.

Counterpart of ``ircl_tpu/serve_native.py``. ``native/src/ircl_http.cpp``
(shared with the JAX package, built by ``utils/native_build.py`` into
``native/libircl_http.so``) runs one epoll event loop that owns accept,
read, HTTP parsing and write with keep-alive; a small pool of Python worker
threads pulls complete requests through ctypes (the GIL is released while a
worker blocks in ``ih_next``) and pushes JSON replies back.

Routing and request semantics are ``serve.py::_handle``'s, so this front
and ``serve.py::serve_http`` answer with the same bodies; ``serve_http``
stays the fallback where the library does not build. Plain doc and sentence
requests go to ``BatchingService.submit*``, whose callbacks answer through
``ih_respond`` from the dispatcher thread, so a worker never waits on the
device.

Carried over unchanged from the JAX package, faults included: ``close``
joins the workers and the batcher with timeouts before ``ih_stop`` frees
the C++ server, so a worker or callback still running past them can call
``ih_respond`` on freed memory (the last-resort reply in ``_worker`` uses
the handle it captured, and ``_respond``'s check races ``close``); the C++
side reads a chunked ``Transfer-Encoding`` body as the next request, and
cuts a request line longer than the worker's 4096-byte meta buffer without
saying so.
"""

from __future__ import annotations

import ctypes
import json
import threading
import time
from typing import Optional

from ircl_tpu_torch.serve import (
    MAX_BODY_BYTES,
    BatchingService,
    RetrievalService,
    _handle,
    parse_request,
)

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load libircl_http.so; None when unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        from ircl_tpu_torch.utils.native_build import build_native

        path = build_native(lib="http")
        if path is None:
            return None
        lib = ctypes.CDLL(path)
    except Exception:
        return None
    lib.ih_start.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong]
    lib.ih_start.restype = ctypes.c_void_p
    lib.ih_port.argtypes = [ctypes.c_void_p]
    lib.ih_port.restype = ctypes.c_int
    lib.ih_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ih_next.restype = ctypes.c_longlong
    lib.ih_respond.argtypes = [
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_longlong,
        ctypes.c_int,
    ]
    lib.ih_respond.restype = ctypes.c_int
    lib.ih_stop.argtypes = [ctypes.c_void_p]
    lib.ih_stop.restype = None
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeHTTPServer:
    """epoll front + Python routing workers, with ``serve_http``'s
    endpoints and replies: GET /healthz, GET /metrics, POST /search,
    POST /verdict. Keep-alive by default; an oversized body gets 413 from
    the C++ side without reaching Python."""

    def __init__(
        self,
        service: RetrievalService,
        host: str = "127.0.0.1",
        port: int = 8080,
        batch_wait_ms: Optional[float] = None,
        workers: int = 2,
        max_body: int = MAX_BODY_BYTES,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native HTTP front unavailable (libircl_http.so did not "
                "build); use serve.serve_http instead"
            )
        self._lib = lib
        self.service = service
        self.batcher = (
            BatchingService(service, max_wait_ms=batch_wait_ms)
            if batch_wait_ms is not None
            else None
        )
        self._handle_ptr = lib.ih_start(host.encode(), port, max_body)
        if not self._handle_ptr:
            if self.batcher is not None:
                self.batcher.close()
            raise OSError(f"ih_start failed to bind {host}:{port}")
        self.port = lib.ih_port(self._handle_ptr)
        self._closing = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    # ---- routing (``serve.py::_Handler``'s) ------------------------------

    def _route(self, method: str, path: str, body: bytes):
        if method == "GET":
            if path == "/healthz":
                return 200, {"ok": True, "docs": self.service.num_docs}
            if path == "/metrics":
                return 200, self.service.metrics.snapshot()
            return 404, {"error": f"unknown path {path}"}
        if method != "POST" or path not in ("/search", "/verdict"):
            return 404, {"error": f"unknown path {path}"}
        try:
            req = json.loads(body or b"{}")
            payload = _handle(
                self.service,
                req,
                batcher=self.batcher,
                expect="claims" if path == "/verdict" else None,
            )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            return 400, {"error": str(e)}
        return 200, payload

    def _respond(
        self, rid: int, status: int, payload: dict, close: bool = False
    ) -> None:
        h = self._handle_ptr
        if h is None:  # server already stopped (close() drains first)
            return
        reply = json.dumps(payload).encode()
        self._lib.ih_respond(h, rid, status, reply, len(reply), int(close))

    def _try_submit_async(self, rid: int, method: str, path: str,
                          body: bytes, close: bool) -> bool:
        """A plain doc or sentence search with a batcher: enqueue without
        blocking this worker (``BatchingService.submit*``); the dispatcher
        thread answers through ``ih_respond`` (thread-safe, non-blocking). A
        blocking ``batcher.search`` here would hold one worker per request
        in flight and cap coalescing at the pool size. Returns False when
        the request is not one of these (the caller routes it in turn)."""
        if self.batcher is None or method != "POST" or path != "/search":
            return False
        try:
            req = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return False  # the sync route replies 400 with the shared message
        if not isinstance(req, dict) or "claims" in req or "claim" in req:
            return False
        try:
            queries, k, k_sents = parse_request(req)
        except (KeyError, ValueError, TypeError):
            return False
        sentences = bool(req.get("sentences")) or k_sents is not None
        if sentences and not self.service.has_sentence_stage:
            return False  # the sync route replies 400 with the shared message
        t0 = time.monotonic()
        metrics = self.service.metrics

        def done(result, error):
            if error is not None:
                metrics.record_error()
                self._respond(rid, 500, {"error": str(error)}, close=close)
                return
            metrics.record_request(len(queries), time.monotonic() - t0)
            self._respond(rid, 200, {"results": result}, close=close)

        try:
            if sentences:
                self.batcher.submit_sentences(queries, k, k_sents, done)
            else:
                self.batcher.submit(queries, k, done)
        except (ValueError, RuntimeError):
            return False  # a validation error: the sync route replies 400
        return True

    def _worker(self) -> None:
        lib = self._lib
        h = self._handle_ptr
        meta = ctypes.create_string_buffer(4096)
        body_ptr = ctypes.POINTER(ctypes.c_char)()
        body_len = ctypes.c_longlong()
        while not self._closing.is_set():
            rid = lib.ih_next(
                h, 200, meta, len(meta),
                ctypes.byref(body_ptr), ctypes.byref(body_len),
            )
            if rid == 0:
                continue  # timeout: look at the closing flag again
            if rid < 0:
                return  # server stopped
            try:
                parts = meta.value.decode().split(" ")
                method, path = parts[0], parts[1] if len(parts) > 1 else ""
                close = len(parts) > 2 and parts[2] == "close"
                body = ctypes.string_at(body_ptr, body_len.value)
                if self._try_submit_async(rid, method, path, body, close):
                    continue  # the dispatcher thread responds
                try:
                    status, payload = self._route(method, path, body)
                except Exception as e:  # routing must never kill a worker
                    self.service.metrics.record_error()
                    status, payload = 500, {"error": f"internal: {e}"}
                self._respond(rid, status, payload, close=close)
            except Exception:
                # last resort: free the request slot so that the connection
                # is not wedged for good
                lib.ih_respond(h, rid, 500, b"{}", 2, 1)

    def close(self) -> None:
        if self._closing.is_set():
            return
        self._closing.set()
        for t in self._threads:
            t.join(timeout=5.0)
        # Drain the batcher first: queued requests still hold C++ request
        # slots, and their callbacks call ih_respond, so the server handle
        # must outlive them.
        if self.batcher is not None:
            self.batcher.close()
        self._lib.ih_stop(self._handle_ptr)
        self._handle_ptr = None


def serve_native_http(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 8080,
    batch_wait_ms: Optional[float] = None,
    workers: int = 2,
) -> NativeHTTPServer:
    """Start the native front. It is bound and serving on return (there is
    no ``.serve_forever()``); call ``.close()`` to stop it."""
    return NativeHTTPServer(
        service, host=host, port=port,
        batch_wait_ms=batch_wait_ms, workers=workers,
    )
