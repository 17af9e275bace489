"""Minimal production-style HTTP serving of a trained checkpoint, on the card.

    python -m deepipr_tpu_torch.cli.serve_http --ckpt logs/.../best.ckpt \
        --arch resnet --port 8000 \
        --passport-config passport_configs/resnet18_passport.json

Counterpart of the repository's ``tools/serve_http.py``, with its flags and
its JSON contract. A stdlib ``ThreadingHTTPServer`` on 127.0.0.1 around the
port's ``Predictor``: by default the folded deployment artifact (BN and
the affines in the conv kernels, no passports, signatures or BN statistics
at run time, interop/fold.py), public branch only; ``--no-folded`` serves
the model itself (a V1 model, ``--no-private``, then derives its affines
from the passports in every request: K2 on the card). Requests are padded
to a fixed set of batch sizes, each warmed before the server answers, so
cuDNN's algorithm choice and the kernel build never land on a request; the
host library that normalizes uint8 requests (data/native.py) is built
before that.

  POST /predict   {"images": [[H][W][C]...]} (uint8 0-255 or normalized
                  floats) -> {"classes": [...], "latency_ms": ...}
  GET  /healthz   {"ok": true, ...model info...}

``latency_ms`` is host-clocked around the forward and the copy of its
classes to the host, which waits for the card, and includes the wait for
the inference thread behind concurrent requests.
"""

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deepipr_tpu_torch.data import native
from deepipr_tpu_torch.data.datasets import normalize

BATCH_SIZES = (1, 8, 64, 256)


def build_predictor(args, device="cuda"):
    from deepipr_tpu_torch.cli.common import checkpoint_model, passport_kwargs
    from deepipr_tpu_torch.serve import Predictor

    kw = passport_kwargs(args.passport_config, args.norm_type, "shuffle", 0.1,
                         args.separate_stats)
    private = kw is not None and args.private
    model = checkpoint_model(args.ckpt, args.arch, args.num_classes,
                             args.norm_type, kw, private, args.imgcrop,
                             device)
    shape = (1, args.imgcrop, args.imgcrop, 3)
    return Predictor(model, folded=args.folded, input_shape=shape,
                     device=device)


class _Server(ThreadingHTTPServer):
    """One thread per request parses and answers it; the forwards run on
    one inference thread. Each request thread is new, and a thread's first
    CUDA work pays a setup of its own, far slower than a warm thread's
    call: the inference thread, warmed with the buckets, keeps that off
    every request, and the card runs one forward at a time either way."""

    daemon_threads = True

    def __init__(self, addr, predictor, info, image_shape,
                 batch_sizes=BATCH_SIZES):
        super().__init__(addr, _Handler)
        self.predictor = predictor
        self.info = info
        self.image_shape = tuple(image_shape)
        self.batch_sizes = sorted(batch_sizes)
        self.inference = ThreadPoolExecutor(1, "inference")

    def classes(self, x: np.ndarray, n: int):
        """The predicted classes of the first ``n`` rows of the padded batch
        ``x``, on the host (the copy waits for the card)."""
        return self.inference.submit(
            lambda: self.predictor.predict(x)[:n].cpu()).result()

    def server_close(self):
        super().server_close()
        self.inference.shutdown()


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"ok": True, **self.server.info})
        return self._json(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/predict":
            return self._json(404, {"error": "unknown path"})
        want = self.server.image_shape  # (H, W, C) the model was warmed for
        sizes = self.server.batch_sizes
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            x = np.asarray(req["images"], np.float32)
            if x.ndim == 3:
                x = x[None]
            if x.ndim == 4 and len(x) > sizes[-1]:
                return self._json(413, {"error": f"batch > {sizes[-1]}"})
            if x.ndim != 4 or x.shape[1:] != want:
                return self._json(400, {
                    "error": f"images must be (N,{','.join(map(str, want))})"
                             f" or ({','.join(map(str, want))}), got "
                             f"{list(x.shape)}"})
            # "normalized": true skips normalization explicitly; otherwise
            # uint8-range input (values outside plausible normalized range)
            # is normalized — send the flag for ambiguous (dark) images
            normalized = req.get("normalized")
            if normalized is None:
                normalized = x.max() <= 8.0
        except Exception as e:
            return self._json(400, {"error": f"bad request: {e}"})
        try:
            # the request is valid from here on: a fault is the server's
            if not normalized:
                x = normalize(np.clip(x, 0, 255).astype(np.uint8))
            padded = next(s for s in sizes if s >= len(x))
            xp = np.zeros((padded,) + x.shape[1:], np.float32)
            xp[: len(x)] = x
            t0 = time.perf_counter()
            classes = self.server.classes(xp, len(x))
            latency = time.perf_counter() - t0
        except Exception as e:
            return self._json(500, {"error": f"inference failed: {e}"})
        self._json(200, {"classes": classes.tolist(),
                         "latency_ms": round(latency * 1e3, 2)})


def make_server(args, port=0, device="cuda"):
    """The server on 127.0.0.1:``port`` (0: any free port), its model on
    ``device`` and warmed at every batch size; call ``serve_forever``. The
    host library that normalizes uint8 requests is built first, so that a
    missing compiler fails here and not in a request."""
    native.get_lib()
    predictor = build_predictor(args, device)
    # Request threads share one model. Predictor.logits enters eval mode
    # for each call and restores the mode it found (utils/mode.py): with
    # the model in eval mode from here on, every thread finds and restores
    # eval mode, so concurrent requests cannot interleave a mode switch
    predictor.model.eval()
    info = {"arch": args.arch, "folded": args.folded,
            "num_classes": args.num_classes,
            "image_shape": [args.imgcrop, args.imgcrop, 3]}
    srv = _Server(("127.0.0.1", port), predictor, info,
                  (args.imgcrop, args.imgcrop, 3))
    for s in srv.batch_sizes:
        srv.classes(np.zeros((s, args.imgcrop, args.imgcrop, 3), np.float32),
                    s)
    return srv


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--arch", default="resnet",
                   choices=["alexnet", "resnet", "resnet9", "resnet50"])
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--norm-type", default="bn")
    p.add_argument("--passport-config")
    p.add_argument("--private", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--separate-stats", action="store_true")
    p.add_argument("--imgcrop", type=int, default=32)
    p.add_argument("--folded", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="serve the folded deployment artifact (default)")
    p.add_argument("--port", type=int, default=8000)
    return p


def main(argv=None, device="cuda"):
    """Serve on ``device`` until interrupted."""
    args = build_parser().parse_args(argv)
    srv = make_server(args, port=args.port, device=device)
    print(f"serving {srv.info['arch']} (folded={srv.info['folded']}) on "
          f"http://127.0.0.1:{srv.server_address[1]} — POST /predict, "
          "GET /healthz")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
