"""Minimal HTTP front end of the inference engine (counterpart:
``mrisr_tpu/serve/http.py``).

Standard library only: a ``ThreadingHTTPServer`` whose POST handler feeds
the micro-batching engine (``serve/engine.py``).  Requests from many
client threads batch together in the engine's queue, so the server has no
batching logic of its own.

Wire format: numpy's ``.npy`` bytes both ways.  POST a float32 ``(H, W,
2)`` array to ``/predict``, receive a float32 ``(H, W, 1)`` ``.npy``::

    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.save(buf, pair)          # pair: (256, 256, 2)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue())
    out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))

Endpoints:
    POST /predict   .npy (H, W, 2) float32 -> .npy (H, W, 1) float32
                    (400 with a JSON error on a bad body)
    GET  /healthz   200 "ok"
    GET  /stats     JSON EngineStats (requests/batches/occupancy/...)

``cli serve --bundle <dir>`` after ``cli export-serving``; the engine runs
on the card unless a device is given.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from mrisr_tpu_torch.device import DeviceLike
from mrisr_tpu_torch.serve.engine import InferenceEngine


def _make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        # quiet: the engine's stats are the observability surface
        def log_message(self, fmt, *args):  # noqa: D401
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                s = engine.stats
                self._send(200, json.dumps({
                    "requests": s.requests,
                    "batches": s.batches,
                    "padded_slots": s.padded_slots,
                    "occupancy": round(s.occupancy, 4),
                    "total_batch_time_s": round(s.total_batch_time_s, 4),
                    "slices_per_sec": round(s.slices_per_sec, 2),
                }).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                out = engine.predict(arr)
            except Exception as e:  # a bad body is the client's 400
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")
                return
            buf = io.BytesIO()
            np.save(buf, np.asarray(out, np.float32))
            self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


class ServingServer:
    """HTTP front end bound to an engine; ``.port`` is the bound port.
    ``close()`` stops the server and closes the engine."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(engine))
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self) -> "ServingServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def close(self):
        if self._thread is not None:
            # shutdown() waits for a running serve_forever loop: only the
            # background one is still running here
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve_bundle(bundle_path: str, host: str = "127.0.0.1", port: int = 8000,
                 batch_size: int = 128, max_delay_ms: float = 2.0,
                 device: DeviceLike = None) -> ServingServer:
    """Bundle dir -> a bound (not yet serving) ServingServer whose engine
    runs on ``device`` (``None``: the card)."""
    from mrisr_tpu_torch.serve.bundle import engine_from_bundle

    engine = engine_from_bundle(bundle_path, batch_size=batch_size,
                                max_delay_ms=max_delay_ms, device=device)
    return ServingServer(engine, host=host, port=port)
