"""Minimal inference server on the card.

Port of the repository's ``serve.py``: stdlib HTTP over the port's
:class:`~wesup_tpu_torch.inference.Predictor`, one process owning the card,
one forward at a time.

Usage:
    python -m wesup_tpu_torch.serve [checkpoint=<.pth>] [port=8700]
                                    [mode=superpixel|pixel] [scales=0.5]
                                    [warmup_hw=522,775] [device=cuda]
                                    [seed=0] [<config>=<value>]

API:
    GET  /healthz            -> {"status": "ok", "device": ...}
    POST /predict            -> binary PNG mask ({0,255})
         body: image file (PNG, uncompressed BMP or baseline JPEG,
         ``data/codec.py``; anything it cannot decode, a progressive or
         cut JPEG included, is answered with 400 and the codec's
         reason); query args: ?scales=0.5,0.4

The codecs are the port's own, so the server runs where OpenCV is not
installed.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import cli
from .config import WESUPConfig, merge_config
from .data import codec
from .inference import Predictor, predict_multiscale
from .models.convert import load_state_dict_file
from .models import wesup


class ServerState:
    """What the handler serves with: the predictor, default scales, and a
    lock so that one forward at a time runs on the card."""

    def __init__(self, predictor: Predictor, scales, device_name: str):
        self.predictor = predictor
        self.scales = tuple(scales)
        self.device = device_name
        self.lock = threading.Lock()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        print("[serve]", fmt % args)

    @property
    def state(self) -> ServerState:
        return self.server.state

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if urlparse(self.path).path == "/healthz":
            self._json(200, {"status": "ok", "device": self.state.device})
        else:
            self._json(404, {"error": "unknown path"})

    def do_POST(self):
        parsed = urlparse(self.path)
        if parsed.path != "/predict":
            self._json(404, {"error": "unknown path"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                img = codec.decode(data, name="request body")
            except ValueError as ex:
                self._json(400, {"error": str(ex)})
                return

            qs = parse_qs(parsed.query)
            scales = self.state.scales
            if "scales" in qs:
                scales = tuple(float(s) for s in qs["scales"][0].split(","))

            t0 = time.time()
            with self.state.lock:
                pred = predict_multiscale(self.state.predictor, img,
                                          scales=scales)
            dt = time.time() - t0

            png = codec.encode_png((pred * 255).astype(np.uint8))
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("X-Inference-Seconds", f"{dt:.3f}")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)
        except Exception as exc:  # noqa: BLE001 - report to the client
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})


def create_server(checkpoint=None, port=8700, mode="superpixel",
                  scales=(0.5,), warmup_hw=None, host="0.0.0.0", device=None,
                  seed=0, **kwargs):
    """Build the model, its predictor and the HTTP server (without serving).

    ``checkpoint`` is a reference-format ``.pth`` (or None for weights drawn
    from ``seed``); ``mode`` is "superpixel" or "pixel" (the pixel head);
    other keyword arguments override ``WESUPConfig`` fields.
    ``device=None`` means the card.  The server's ``state`` attribute holds
    the :class:`ServerState`.
    """
    if not isinstance(scales, (tuple, list)):
        scales = (scales,)
    config = merge_config(WESUPConfig(), **kwargs)
    shape = dict(n_classes=config.n_classes, D=config.sp_feature_dim,
                 fc_width=config.fc_width)
    if checkpoint is not None:
        model = wesup.empty("cpu", **shape)
        model.load_state_dict(load_state_dict_file(checkpoint))
    else:
        model = wesup.WESUP(
            **shape, generator=torch.Generator().manual_seed(int(seed)))
    predictor = Predictor(model, config, mode=mode, device=device)
    dev = predictor.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    state = ServerState(predictor, scales, name)

    if warmup_hw is not None:
        h, w = int(warmup_hw[0]), int(warmup_hw[1])
        print(f"[serve] warming up ({h}x{w}, scales {state.scales}) ...")
        predict_multiscale(predictor, np.zeros((h, w, 3), np.uint8),
                           scales=state.scales)
        print("[serve] warmup done")

    server = ThreadingHTTPServer((host, int(port)), Handler)
    server.state = state
    return server


def main(argv=None):
    """``key=value`` arguments, as the repository's fire-style CLIs take."""
    args, kwargs = cli.parse_argv(argv)
    server = create_server(*args, **kwargs)
    print(f"[serve] listening on :{server.server_port} "
          f"(mode={server.state.predictor.mode}, "
          f"device={server.state.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
