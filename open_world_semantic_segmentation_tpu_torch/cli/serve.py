"""Streaming segmentation inference server.

The port's counterpart of the JAX package's ``cli/serve.py``: one forward
at a fixed input size, warmed at startup, behind a threaded HTTP front end,
PNG label maps out.

Endpoints:
  GET  /healthz           -> {"status": "ok", "model": ..., "input": [H, W]}
  GET  /metrics           -> request/error counts, latency stats and the
                             warmed batch sizes (JSON)
  POST /segment           -> body: image bytes (any PIL-readable format);
                             response: PNG label map (uint8 class ids).
                             Query ?scores=dissum returns a float16 npy
                             anomaly-confidence map instead. A malformed
                             image gets a 400.
  POST /stream            -> one persistent connection carrying many
                             frames: the body is a sequence of <u32
                             big-endian length><image bytes> records
                             (length 0 or EOF ends the stream); the
                             response streams back the same framing around
                             PNG label maps (or npy conf maps with
                             ?scores=dissum), in order. Two frames stay in
                             flight: the forward is queued on the device
                             and its results copied back asynchronously,
                             so the decode of frame N+1 overlaps the
                             compute of frame N.

Requests are handled on a thread per connection: PIL decode and PNG encode
of concurrent requests overlap, and a lock serialises only the forward.
The forward enters ``torch.inference_mode`` and autocast itself, since
PyTorch keeps both per thread and three kinds of thread call it (request
threads, the micro-batch collector and the warm-up thread).

With ``--max-batch N`` (default 1 = off) concurrent requests are
micro-batched: a collector thread coalesces up to N decoded images that
arrive within ``--batch-wait-ms`` into one forward, padded to the next
power-of-two batch size. Batch 1 is warmed before the server answers (the
first run of a shape is where cuDNN settles its algorithms and the fused
route builds its kernel); the larger sizes warm in a background thread
and ``/metrics`` lists them as they are done.

``--device-input`` ships the resized image as uint8 and normalises it on
the device (``data/odgt.py device_normalize``). ``--artifact`` serves a
saved export (``cli/export_model.py``). ``--quant`` (int8, int8-hybrid,
int8-3x3; ``ops/quant.py``) serves the int8 PTQ model, its activation
scales calibrated at startup at the served size on the first 16 images
``--calib-glob`` matches (sorted), or on white noise without the flag.
The backbone's fused route is the Python keyword ``fused_blocks`` of
``serve`` and ``Segmenter``, with no CLI flag, as in ``cli/eval_ood.py``.

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.serve \
      --cfg configs/test_ood_street.yaml --port 8501 --height 720 --width 1280
"""

from __future__ import annotations

import collections
import io
import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ._common import (
    build_anomaly_model,
    calibrate_for_quant,
    compute_dtype,
    config_parser,
    init_or_load_variables,
    parse_config,
)
from ..core.device import resolve_device, to_host_async

QUANT_MODES = ("off", "int8", "int8-hybrid", "int8-3x3")


def check_quant(quant: str):
    """``--quant``: the JAX server's and exporter's choices."""
    if quant not in QUANT_MODES:
        raise ValueError(f"--quant {quant!r}: choose from {QUANT_MODES}")


class _Job:
    """One request in the micro-batch queue."""

    __slots__ = ("arr", "done", "pred", "conf", "err")

    def __init__(self, arr):
        self.arr = arr
        self.done = threading.Event()
        self.pred = self.conf = self.err = None


class Segmenter:
    """Fixed-size forward with PIL in / label-PNG out."""

    def __init__(self, cfg, precision_dtype, height: int, width: int,
                 max_batch: int = 1, batch_wait_ms: float = 5.0,
                 quant: str = "off", device_input: bool = False,
                 artifact: str = None, device=None,
                 fused_blocks: bool = False, calib_glob: str = None):
        """``device_input``: ship the resized image as uint8 and normalise
        it on the device. ``artifact``: serve a saved export instead of
        building the model; input size and batch come from its metadata
        (single-scale, method other than "none"). ``quant``: an int8 PTQ
        mode, calibrated at startup on the images ``calib_glob`` matches
        (``cli/_common.py calibrate_for_quant``)."""
        from ..data import native

        check_quant(quant)
        if device_input and artifact:
            raise ValueError(
                "--device-input needs the normalization inside the "
                "program, which a saved artifact does not contain — "
                "re-export with normalization baked in or drop one flag")
        self.device_input = device_input
        self.resize_normalize = native.resize_normalize
        if not device_input:
            native.load()      # built at startup, not by the first request
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "errors": 0, "batches": 0,
                      "latency_ms_sum": 0.0, "latency_ms_max": 0.0}

        if artifact:
            from ..core.export import (artifact_device, load_exported,
                                       read_meta)

            # the metadata header is checked before the payload is read
            meta = read_meta(artifact)
            if meta.get("pyramid"):
                raise ValueError(
                    "serve needs a single-scale artifact (export without "
                    "--pyramid)")
            if meta.get("method") == "none":
                raise ValueError("serve needs an artifact with a conf "
                                 "method (exported with --method none)")
            if meta.get("npm"):
                raise ValueError(
                    "NPM artifacts take (image, prototype) inputs — serve "
                    "only dispatches single-image artifacts")
            self.device = artifact_device(meta, device)
            fwd, meta = load_exported(artifact, self.device)
            has_input_meta = "input" in meta
            ab, ah, aw, _ = meta.get("input", [1, height, width, 3])
            self.size = (ah, aw)
            self.model_name = meta.get("model", "artifact")
            # an artifact has a FIXED batch; every dispatch pads to it
            if has_input_meta and int(max_batch) != ab:
                print(f"NOTE: artifact batch={ab} overrides "
                      f"--max-batch {max_batch} (micro-batching follows "
                      "the artifact; re-export with --batch to change)")
            if has_input_meta and (ah, aw) != (height, width):
                print(f"NOTE: artifact input {ah}x{aw} overrides "
                      f"--height/--width {height}x{width}")
            max_batch = ab
        else:
            from ..data.odgt import device_normalize
            from ..openset.scoring import dissum_conf

            self.device = resolve_device(device)
            self.size = (height, width)
            self.model = build_anomaly_model(cfg, self.device,
                                             fused_blocks=fused_blocks,
                                             use_softmax=True, quant=quant)
            init_or_load_variables(cfg, self.model)
            if quant != "off":
                calibrate_for_quant(cfg, self.model, self.size,
                                    dtype=precision_dtype, use_softmax=True,
                                    calib_glob=calib_glob, quant=quant)
            self.model_name = (f"{cfg.MODEL.arch_encoder}+"
                               f"{cfg.MODEL.arch_decoder}")
            dev = self.device.type

            def fwd(imgs):
                # grad mode and autocast are per thread: set here, for
                # whichever thread runs the forward
                with torch.inference_mode():
                    with torch.autocast(
                            dev, dtype=precision_dtype,
                            enabled=precision_dtype != torch.float32):
                        if device_input:
                            imgs = device_normalize(imgs)
                        scores = self.model(imgs,
                                            seg_size=self.size)["scores"]
                    pred = scores.argmax(-1).to(torch.uint8)
                    # in the scores' dtype, as the JAX server and the eval
                    # take it (CUDA autocast would sum in float32); min
                    # and max per image: padding must not move a real
                    # image's map
                    conf = torch.stack([dissum_conf(s)
                                        for s in scores.unbind(0)])
                return pred, conf.to(torch.float16)

        self._fwd = fwd
        self._in_dtype = torch.uint8 if self.device_input else torch.float32
        self.max_batch = max(1, int(max_batch))
        self.batch_wait = batch_wait_ms / 1e3
        self._batch_sizes = [self.max_batch] if artifact else [1]
        while self._batch_sizes[-1] < self.max_batch:
            self._batch_sizes.append(
                min(self._batch_sizes[-1] * 2, self.max_batch))
        # the first size warms before the server answers; the larger ones
        # in the background (a request for a size not yet warm runs it
        # cold)
        self._warm(self._batch_sizes[0])
        self.warmed = [self._batch_sizes[0]]
        if len(self._batch_sizes) > 1:
            threading.Thread(target=self._warm_batches, name="owss-warm-up",
                             daemon=True).start()

        self._queue = None
        if self.max_batch > 1:
            self._queue = queue.Queue()
            threading.Thread(target=self._collector, name="owss-collector",
                             daemon=True).start()

    def _warm(self, b: int):
        """One forward at batch ``b``, waited for."""
        zeros = np.zeros((*self.size, 3), np.uint8)
        self._dispatch([zeros] * b, count=False)()

    def _warm_batches(self):
        for b in self._batch_sizes[1:]:
            self._warm(b)
            self.warmed.append(b)

    def _dispatch(self, arrs, count: bool = True):
        """Pad, copy to the device and queue one forward; returns the
        function that waits for its results (``core/device.py
        to_host_async``): the copies back go to pinned memory behind the
        forward, so calling it is the caller's only synchronisation."""
        n = len(arrs)
        size = next(b for b in self._batch_sizes if b >= n)
        batch = torch.zeros((size, *self.size, 3), dtype=self._in_dtype,
                            pin_memory=self.device.type == "cuda")
        batch.numpy()[:n] = arrs
        x = batch.to(self.device, non_blocking=True)
        with self._lock:
            pred, conf = self._fwd(x)
            wait = to_host_async([pred, conf])
        if count:
            with self._stats_lock:
                self.stats["batches"] += 1
        return wait

    def _run_batch(self, arrs):
        """One padded forward over a list of HWC arrays, waited for."""
        pred, conf = self._dispatch(arrs)()
        n = len(arrs)
        return pred[:n], conf[:n]

    def _collector(self):
        """Micro-batcher: coalesce jobs arriving within batch_wait into one
        dispatch of up to max_batch images."""
        while True:
            jobs = [self._queue.get()]
            deadline = time.perf_counter() + self.batch_wait
            while len(jobs) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    jobs.append(self._queue.get(timeout=left))
                except queue.Empty:
                    break
            try:
                preds, confs = self._run_batch([j.arr for j in jobs])
                for j, p, c in zip(jobs, preds, confs):
                    j.pred, j.conf = p, c
            except Exception as e:  # pragma: no cover - device failure
                for j in jobs:
                    j.err = e
            for j in jobs:
                j.done.set()

    def _decode(self, image_bytes: bytes):
        from PIL import Image

        img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
        if self.device_input:
            # ship uint8; the normalisation runs on the device
            return np.asarray(img.resize((self.size[1], self.size[0]),
                                         Image.BILINEAR), np.uint8)
        return self.resize_normalize(np.asarray(img),
                                     (self.size[0], self.size[1]))

    def _record(self, tic: float):
        ms = (time.perf_counter() - tic) * 1e3
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["latency_ms_sum"] += ms
            self.stats["latency_ms_max"] = max(
                self.stats["latency_ms_max"], ms)

    def segment(self, image_bytes: bytes):
        tic = time.perf_counter()
        try:
            arr = self._decode(image_bytes)
            # the decode above runs concurrently across request threads;
            # only the forward is serialised
            if self._queue is not None:
                job = _Job(arr)
                self._queue.put(job)
                job.done.wait()
                if job.err is not None:
                    raise job.err
                pred, conf = job.pred, job.conf
            else:
                preds, confs = self._run_batch([arr])
                pred, conf = preds[0], confs[0]
        except Exception:
            with self._stats_lock:
                self.stats["errors"] += 1
            raise
        self._record(tic)
        return pred, conf

    def stream(self, rfile, wfile, scores: bool = False,
               depth: int = 2) -> int:
        """Length-prefixed frame stream over one connection (POST /stream).

        Reads ``<u32 length><image bytes>`` records from ``rfile`` (length
        0 or EOF ends it), writes the same framing around the encoded
        results to ``wfile``, in order. Up to ``depth`` frames stay in
        flight: ``_dispatch`` returns before the device is done, so the
        wait in the drain step is the only synchronisation. Returns the
        number of frames served."""
        from PIL import Image

        pending = collections.deque()  # (tic, wait)
        served = 0

        def drain_one():
            nonlocal served
            tic, wait = pending.popleft()
            pred, conf = wait()
            buf = io.BytesIO()
            if scores:
                np.save(buf, conf[0])
            else:
                Image.fromarray(pred[0], "L").save(buf, format="PNG")
            payload = buf.getvalue()
            wfile.write(struct.pack(">I", len(payload)))
            wfile.write(payload)
            served += 1
            self._record(tic)

        while True:
            hdr = rfile.read(4)
            if len(hdr) < 4:
                break
            (n,) = struct.unpack(">I", hdr)
            if n == 0:
                break
            data = rfile.read(n)
            if len(data) < n:
                break
            tic = time.perf_counter()
            try:
                arr = self._decode(data)
            except Exception:
                with self._stats_lock:
                    self.stats["errors"] += 1
                # a frame that fails to decode breaks the ordered stream:
                # drain what is in flight and end the response (the client
                # sees fewer results than frames)
                break
            pending.append((tic, self._dispatch([arr])))
            if len(pending) >= depth:
                drain_one()
        while pending:
            drain_one()
        return served

    def metrics(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
        n = s.pop("latency_ms_sum"), s["requests"]
        s["latency_ms_avg"] = round(n[0] / n[1], 3) if n[1] else 0.0
        s["latency_ms_max"] = round(s["latency_ms_max"], 3)
        s["warmed_batch_sizes"] = list(self.warmed)
        return s


def make_handler(segmenter: Segmenter):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = self.path.split("?", 1)[0]
            if route == "/healthz":
                body = json.dumps({
                    "status": "ok",
                    "model": segmenter.model_name,
                    "input": list(segmenter.size),
                }).encode()
                self._send(200, body, "application/json")
            elif route == "/metrics":
                self._send(200, json.dumps(segmenter.metrics()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            route = self.path.split("?", 1)[0]
            if route == "/stream":
                # the body is our own framing, not an HTTP entity: read
                # rfile until the 0 length or EOF and stream the response
                # as it is produced (no Content-Length; the connection
                # closes at the end of the stream)
                self.close_connection = True
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Connection", "close")
                self.end_headers()
                segmenter.stream(self.rfile, self.wfile,
                                 scores="scores=dissum" in self.path)
                return
            if route != "/segment":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                pred, conf = segmenter.segment(data)
            except Exception as e:  # malformed image etc.
                self._send(400, str(e).encode(), "text/plain")
                return
            buf = io.BytesIO()
            if "scores=dissum" in self.path:
                np.save(buf, conf)
                self._send(200, buf.getvalue(), "application/octet-stream")
            else:
                from PIL import Image

                Image.fromarray(pred, "L").save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")

    return Handler


def serve(cfg, precision_dtype, host="127.0.0.1", port=8501, height=720,
          width=1280, max_batch=1, batch_wait_ms=5.0, quant="off",
          device_input=False, artifact=None, device=None,
          fused_blocks: bool = False, calib_glob: str = None):
    """Build the ``Segmenter`` and its HTTP server (not yet serving: call
    ``serve_forever``). ``port=0`` takes a free port."""
    segmenter = Segmenter(cfg, precision_dtype, height, width,
                          max_batch=max_batch, batch_wait_ms=batch_wait_ms,
                          quant=quant, device_input=device_input,
                          artifact=artifact, device=device,
                          fused_blocks=fused_blocks, calib_glob=calib_glob)
    server = ThreadingHTTPServer((host, port), make_handler(segmenter))
    server.segmenter = segmenter
    print(f"serving {segmenter.model_name} on "
          f"http://{host}:{server.server_address[1]} "
          f"(input {segmenter.size[0]}x{segmenter.size[1]}, "
          f"{segmenter.device})", flush=True)
    return server


def main(argv=None):
    parser = config_parser(__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--max-batch", type=int, default=1,
                        help="micro-batch concurrent requests into one "
                             "forward (1 = off)")
    parser.add_argument("--batch-wait-ms", type=float, default=5.0,
                        help="max time to wait for a batch to fill")
    parser.add_argument("--quant", choices=QUANT_MODES, default="off",
                        help="opt-in int8 PTQ inference (ops/quant.py)")
    parser.add_argument("--calib-glob", default=None,
                        help="glob of representative images for the int8 "
                             "activation calibration")
    parser.add_argument("--device-input", action="store_true",
                        help="ship uint8 images and normalize on the "
                             "device")
    parser.add_argument("--artifact", default=None,
                        help="serve a saved export (cli/export_model) "
                             "instead of building the model")
    args = parser.parse_args(argv)
    cfg = parse_config(args)
    server = serve(cfg, compute_dtype(args), args.host, args.port,
                   args.height, args.width, max_batch=args.max_batch,
                   batch_wait_ms=args.batch_wait_ms, quant=args.quant,
                   device_input=args.device_input, artifact=args.artifact,
                   device=args.device, calib_glob=args.calib_glob)
    server.serve_forever()


if __name__ == "__main__":
    main()
