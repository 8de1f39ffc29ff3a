"""Minimal production-style inference server, stdlib HTTP — port of
``scripts/serve.py``:

    python -m tpu_pillars_torch.serve --ckpt ckpt.msgpack [--full-size]
        [--port 8433] [--batch-size B --max-wait-ms T] [--device cpu]

Endpoints:
  GET  /healthz            -> {"status": "ok", "device": ..., "sweeps": N}
  POST /predict            -> detections for ONE (pre-accumulated) cloud
       body: raw float32 little-endian (N, F) point buffer
             (F = config.num_input_features; header X-Point-Count: N),
             or JSON {"points": [[x, y, z, i], ...]}
       response: {"boxes": [{"center", "wlh", "yaw", "label", "score"}],
                  "num_boxes": K, "latency_ms": T, "batched": B}
  POST /sweep              -> streaming multi-sweep serving (needs a
       multi-sweep config, --num-sweeps K > 1): the body is one raw sweep
       (N, num_raw_features) on the same binary or JSON wire; headers
       X-Timestamp-Us (float), X-Pose-Rotation "w,x,y,z" and
       X-Pose-Translation "x,y,z" (lidar -> global; identity if omitted),
       X-Stream-Id (default "default"). The server keeps the last K sweeps
       of each stream in a ``data.stream.SweepAccumulator`` (bit for bit
       the offline ``load_sweeps``) and predicts on the accumulated cloud.
       The response adds "sweeps_buffered".

Client errors answer 400, server errors 500, a full request queue 503.

Two serving modes:

  * --batch-size 1 (default): one thread, requests served in arrival
    order through ``Detector.predict``.
  * --batch-size B > 1: dynamic batching. A threading HTTP front end
    enqueues requests; one dispatcher thread, which owns the card,
    coalesces up to B concurrent sweeps (waiting at most --max-wait-ms for
    stragglers once the first arrives) into ONE ``predict_packed_batch``
    call of static batch B, the empty slots padded with clouds of n = 0. A
    lone request takes the single-sweep ``predict``.

``--device`` names the torch device; without it the server runs on the
card and raises when there is none. Every single-sweep bucket
(``--buckets``) and the batch-B call are warmed before the bind, so the
first request pays no first-call cost. For bulk offline throughput, skip
HTTP and call ``Detector.predict_stream`` / ``predict_packed_batch``.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import numpy as np


class _Backlog:
    """A listen backlog for bursts: socketserver's default of 5 drops the
    connections of a larger burst of concurrent clients, which then retry
    after TCP's 1 s retransmission timeout."""

    request_queue_size = 128


class Server(_Backlog, HTTPServer):
    """One thread: requests served in arrival order."""


class ThreadingServer(_Backlog, ThreadingHTTPServer):
    """A thread per request, for the dynamic batcher to coalesce."""


def predict_batch(det, clouds, batch_size: int):
    """Clouds (at most ``batch_size``) -> List[Box3D] each, in one
    ``predict_packed_batch`` call of static batch ``batch_size``: the empty
    slots are clouds of n = 0."""
    from tpu_pillars_torch.detector import packed_to_boxes

    config = det.config
    padded = [det.pad_points(p) for p in clouds]
    # the batch call is warmed once at the full static shape; with
    # --buckets a pad may be bucket-sized — re-pad it to max_points (the
    # f32 sentinel: the only wire this server speaks)
    M = config.max_points

    def full(p):
        if p.shape[0] == M:
            return p
        out = np.full((M, p.shape[1]), 1e6, p.dtype)
        out[: p.shape[0]] = p
        return out

    pts_b = np.stack([full(p) for p, _ in padded])
    n_b = np.asarray([n for _, n in padded], np.int32)
    b = len(clouds)
    if b < batch_size:
        empty = np.full((batch_size - b, *pts_b.shape[1:]), 1e6, pts_b.dtype)
        pts_b = np.concatenate([pts_b, empty])
        n_b = np.concatenate([n_b, np.zeros(batch_size - b, np.int32)])
    packed = det.predict_packed_batch(pts_b, n_b).cpu().numpy()
    return [packed_to_boxes(packed[i], config) for i in range(b)]


class DynamicBatcher:
    """Coalesce concurrent predict requests into static-batch device calls.

    submit() blocks the calling handler thread until its sweep's boxes are
    ready; one dispatcher thread owns the card (batching happens here, not
    by racing device calls from handler threads)."""

    class Overloaded(RuntimeError):
        """Queue full — surfaced as HTTP 503."""

    def __init__(self, det, batch_size: int, max_wait_ms: float,
                 max_queue: int | None = None, result_timeout_s: float = 300.0,
                 warm: bool = False):
        """warm: run :func:`warm_up` in the dispatcher thread before it
        takes requests (a thread's first call on the card creates its own
        library handles); ``ready`` is set once it takes requests, or once
        the warm-up failed (``error`` then holds the exception)."""
        self.det = det
        self.batch = int(batch_size)
        self.wait = max_wait_ms / 1e3
        self.result_timeout = result_timeout_s
        # bounded: a wedged device call must turn into fast 503s, not an
        # unbounded pile of parked handler threads and request payloads
        self.q: "queue.Queue" = queue.Queue(max_queue or 8 * self.batch)
        self.warm = warm
        self.ready = threading.Event()
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpu-pillars-torch-batcher")
        self._thread.start()

    def submit(self, pts):
        ev = threading.Event()
        slot: dict = {}
        try:
            self.q.put_nowait((pts, ev, slot))
        except queue.Full:
            raise self.Overloaded(
                f"request queue full ({self.q.maxsize}); server overloaded "
                f"or device wedged")
        if not ev.wait(timeout=self.result_timeout):
            slot["abandoned"] = True   # the dispatcher drops the result
            raise RuntimeError(
                f"no result within {self.result_timeout:.0f}s "
                f"(device call wedged?)")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["boxes"], slot["batched"]

    def _collect(self):
        items = [self.q.get()]
        deadline = time.perf_counter() + self.wait
        while len(items) < self.batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self):
        try:
            self.det.bind_thread()
            if self.warm:
                warm_up(self.det, self.batch)
        except BaseException as e:
            self.error = e
            raise
        finally:
            self.ready.set()
        while True:
            items = self._collect()
            try:
                if len(items) == 1:
                    results = [self.det.predict(items[0][0])]
                else:
                    results = predict_batch(
                        self.det, [p for p, _, _ in items], self.batch)
                for (_, ev, slot), boxes in zip(items, results):
                    if slot.get("abandoned"):
                        continue       # the handler timed out and left
                    slot["boxes"] = boxes
                    slot["batched"] = len(items)
                    ev.set()
            except Exception as e:  # noqa: BLE001 — surface to every waiter
                for _, ev, slot in items:
                    slot["error"] = str(e)
                    ev.set()


def warm_up(det, batch_size: int) -> None:
    """Run every path the server serves once, in the calling thread: the
    single sweep, each upload bucket, and the batch-``batch_size`` call."""
    F = det.config.num_input_features
    warm = np.zeros((32, F), np.float32)
    det.predict(warm)
    if det.wire_buckets is not None:
        prev = 0
        for b in det.wire_buckets:
            # prev+1 in-range points (the origin is in range) land in
            # bucket b exactly
            det.predict(np.zeros((prev + 1, F), np.float32))
            prev = b
    if batch_size > 1:
        predict_batch(det, [warm] * batch_size, batch_size)


def device_name(det) -> str:
    """The card's name, or "cpu"."""
    import torch

    if det.device.type == "cuda":
        return torch.cuda.get_device_name(det.device)
    return "cpu"


def make_handler(det, config, batcher=None):
    from tpu_pillars_torch.data.stream import SweepAccumulator
    from tpu_pillars_torch.geometry.transforms import Pose

    F = config.num_input_features
    device = device_name(det)
    stats = {"sweeps": 0}
    lock = threading.Lock()
    accumulators: dict = {}      # stream id -> SweepAccumulator
    acc_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        server_version = "tpu-pillars-torch/1.1"

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet the per-request line
            pass

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            self._send(200, {"status": "ok", "device": device,
                             "sweeps": stats["sweeps"]})

        def _read_points(self, width):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("application/json"):
                pts = np.asarray(json.loads(raw)["points"], np.float32)
            else:
                pts = np.frombuffer(raw, "<f4").reshape(-1, width).copy()
                want = self.headers.get("X-Point-Count")
                if want is not None and int(want) != len(pts):
                    raise ValueError(
                        f"X-Point-Count {want} != decoded {len(pts)}")
            if pts.ndim != 2 or pts.shape[1] != width:
                raise ValueError(f"points must be (N, {width}); "
                                 f"got {pts.shape}")
            return pts

        def _serve(self, cloud, **extra):
            t0 = time.perf_counter()
            try:
                if batcher is not None:
                    boxes, batched = batcher.submit(cloud)
                else:
                    boxes, batched = det.predict(cloud), 1
            except DynamicBatcher.Overloaded as e:
                return self._send(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — server error surface
                return self._send(500, {"error": str(e)})
            with lock:
                stats["sweeps"] += 1
            self._send(200, {
                "boxes": [{
                    "center": [float(v) for v in b.center],
                    "wlh": [float(v) for v in b.wlh],
                    "yaw": float(b.yaw),
                    "label": b.label,
                    "score": float(b.score),
                } for b in boxes],
                "num_boxes": len(boxes),
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
                "batched": batched,
                **extra,
            })

        def do_POST(self):
            if self.path == "/sweep":
                return self._do_sweep()
            if self.path != "/predict":
                return self._send(404, {"error": "unknown path"})
            try:
                pts = self._read_points(F)
            except Exception as e:  # noqa: BLE001 — client error surface
                return self._send(400, {"error": str(e)})
            self._serve(pts)

        def _do_sweep(self):
            if config.num_sweeps <= 1:
                return self._send(400, {
                    "error": "/sweep needs a multi-sweep config "
                             "(serve with --num-sweeps K > 1)"})
            try:
                pts = self._read_points(config.num_raw_features)
                t_us = float(self.headers.get("X-Timestamp-Us", 0.0))
                rot = self.headers.get("X-Pose-Rotation")
                tra = self.headers.get("X-Pose-Translation")
                pose = Pose.identity()
                if rot or tra:
                    pose = Pose(
                        np.asarray([float(v) for v in
                                    (rot or "1,0,0,0").split(",")]),
                        np.asarray([float(v) for v in
                                    (tra or "0,0,0").split(",")]))
                stream = self.headers.get("X-Stream-Id", "default")
            except Exception as e:  # noqa: BLE001 — client error surface
                return self._send(400, {"error": str(e)})

            with acc_lock:
                acc = accumulators.setdefault(
                    stream, SweepAccumulator(config.num_sweeps))
                cloud = acc.push(pts, pose, t_us)
                buffered = len(acc)
            self._serve(cloud, sweeps_buffered=buffered)

    return Handler


def parse_buckets(spec: str | None, max_points: int):
    """--buckets: None, 'grid' (a 16384-spaced grid up to max_points) or a
    comma list ending at max_points."""
    if not spec:
        return None
    if spec == "grid":
        step = 16384
        return tuple(range(step, max_points, step)) + (max_points,)
    return tuple(int(x) for x in spec.split(","))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--port", type=int, default=8433)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--full-size", action="store_true")
    p.add_argument("--num-sweeps", type=int, default=0,
                   help="override config.num_sweeps (K > 1 enables the "
                        "/sweep streaming endpoint; the checkpoint must "
                        "match the resulting config)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="dynamic-batching window: >1 coalesces concurrent "
                        "requests into one static batch-B device call")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max straggler wait once the first request of a "
                        "batch arrived")
    p.add_argument("--buckets", type=str, default=None,
                   help="bucketed upload shapes of the single-sweep path "
                        "(smaller uploads for sparse clouds, the same "
                        "boxes): 'grid' or a comma list ending at "
                        "max_points; every bucket is warmed before the "
                        "bind. Batched calls re-pad to the full buffer.")
    args = p.parse_args(argv)

    import dataclasses

    from tpu_pillars_torch.config import PillarsConfig, tiny_config
    from tpu_pillars_torch.detector import Detector

    config = PillarsConfig() if args.full_size else tiny_config()
    if args.num_sweeps > 1:
        config = dataclasses.replace(config, num_sweeps=args.num_sweeps)
    wire_buckets = parse_buckets(args.buckets, config.max_points)
    det = Detector.from_checkpoint(config, args.ckpt, device=args.device,
                                   wire_buckets=wire_buckets)

    # warm every path before the bind, in the thread that serves it: the
    # dispatcher with dynamic batching, this one without
    batcher = None
    if args.batch_size > 1:
        batcher = DynamicBatcher(det, args.batch_size, args.max_wait_ms,
                                 warm=True)
        batcher.ready.wait()
        if batcher.error is not None:
            raise RuntimeError("warm-up failed") from batcher.error
    else:
        warm_up(det, 1)

    server_cls = ThreadingServer if batcher is not None else Server
    server = server_cls((args.host, args.port),
                        make_handler(det, config, batcher))
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(device: {device_name(det)}, batch={args.batch_size})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
