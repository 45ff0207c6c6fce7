"""Minimal inference server on the card.

Port of the repository's ``serve.py``: stdlib HTTP over the port's
:class:`~wesup_tpu_torch.inference.Predictor`, one process owning the card,
one forward at a time.

Usage:
    python -m wesup_tpu_torch.serve [checkpoint=<.pth>] [port=8700]
                                    [scales=0.5] [warmup_hw=522,775]
                                    [device=cuda] [seed=0] [<config>=<value>]

API:
    GET  /healthz            -> {"status": "ok", "device": ...}
    POST /predict            -> binary PNG mask ({0,255})
         body: image file (PNG/JPEG/BMP); query args: ?scales=0.5,0.4
"""

from __future__ import annotations

import ast
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .config import WESUPConfig, merge_config
from .inference import Predictor, predict_multiscale
from .models.convert import load_state_dict_file
from .models.wesup import WESUP


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
        # OpenCV only for the codecs, and only here: the card's machine has
        # none, and the predict path does not need it
        import cv2

        parsed = urlparse(self.path)
        if parsed.path != "/predict":
            self._json(404, {"error": "unknown path"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            if arr is None:
                self._json(400, {"error": "could not decode image"})
                return
            img = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)

            qs = parse_qs(parsed.query)
            scales = self.state.scales
            if "scales" in qs:
                scales = tuple(float(s) for s in qs["scales"][0].split(","))

            t0 = time.time()
            with self.state.lock:
                pred = predict_multiscale(self.state.predictor, img,
                                          scales=scales)
            dt = time.time() - t0

            ok, png = cv2.imencode(".png", (pred * 255).astype(np.uint8))
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("X-Inference-Seconds", f"{dt:.3f}")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png.tobytes())
        except Exception as exc:  # noqa: BLE001 - report to the client
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})


def create_server(checkpoint=None, port=8700, mode="superpixel",
                  scales=(0.5,), warmup_hw=None, host="0.0.0.0", device=None,
                  seed=0, **kwargs):
    """Build the model, its predictor and the HTTP server (without serving).

    ``checkpoint`` is a reference-format ``.pth`` (or None for weights drawn
    from ``seed``); other keyword arguments override ``WESUPConfig``
    fields.  ``device=None`` means the card.  The server's ``state``
    attribute holds the :class:`ServerState`.
    """
    if not isinstance(scales, (tuple, list)):
        scales = (scales,)
    config = merge_config(WESUPConfig(), **kwargs)
    model = WESUP(n_classes=config.n_classes, D=config.sp_feature_dim,
                  fc_width=config.fc_width,
                  generator=torch.Generator().manual_seed(int(seed)))
    if checkpoint is not None:
        model.load_state_dict(load_state_dict_file(checkpoint))
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


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        if "," in text:
            return tuple(_parse_value(p) for p in text.split(",") if p)
        return text


def main(argv=None):
    """``key=value`` arguments, as the repository's fire-style CLIs take."""
    kwargs = {}
    for token in (sys.argv[1:] if argv is None else argv):
        key, _, val = token.lstrip("-").partition("=")
        kwargs[key.replace("-", "_")] = _parse_value(val) if val else True
    server = create_server(**kwargs)
    print(f"[serve] listening on :{server.server_port} "
          f"(device={server.state.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
