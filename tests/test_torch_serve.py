"""The port's HTTP server (``python -m tpu_pillars_torch.serve``) on the CPU,
as tests/test_serve.py holds ``scripts/serve.py``: subprocess start-up on a
checkpoint written by the JAX ``save_checkpoint`` (tiny config, ``--device
cpu``), ``/healthz``, binary and JSON ``/predict`` against the JAX
``Detector.from_checkpoint(...).predict`` at the port-vs-JAX detector
tolerance, the client-error surface, dynamic batching (coalesced bursts
equal to the batch call they rode, and to the unbatched server within
tests/test_serve.py's tolerance; 503 on a full queue), ``/sweep`` on a
3-sweep server and a bucketed server against the plain one.

Each server starts once per module. The boxes come back as ``float(v)`` of
the f32 values, so they are compared with the port's own boxes cast the
same way, exactly."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import Detector as JaxDetector
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import serve
from tpu_pillars_torch.data.stream import SweepAccumulator
from tpu_pillars_torch.detector import Detector
from tpu_pillars_torch.geometry.transforms import Pose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, TCFG = tiny_config(), tconfig.tiny_config()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the servers run (OMP_NUM_THREADS=1): the
    same reductions in the same order on both sides of the wire."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_checkpoint(path, cfg):
    from tpu_pillars.train import TrainConfig, create_train_state
    from tpu_pillars.train.checkpoint import save_checkpoint

    state = create_train_state(cfg, TrainConfig(batch_size=1, max_gt_boxes=4,
                                                total_steps=10))
    save_checkpoint(path, state, config=cfg)
    return path


def _start(ckpt, *flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_pillars_torch.serve", "--ckpt", ckpt,
         "--port", "0", "--device", "cpu", *flags],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # the server prints its bound address once every path is warm
    line = proc.stdout.readline()
    if "serving on http://" not in line:
        proc.kill()
        pytest.fail(f"server did not start: {line!r} "
                    f"{proc.communicate(timeout=30)[1][-2000:]}")
    return proc, line.split()[2]


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _jax_checkpoint(str(tmp_path_factory.mktemp("serve") / "ck.msgpack"),
                           CFG)


@pytest.fixture(scope="module")
def server(ckpt):
    proc, url = _start(ckpt)
    yield url
    _stop(proc)


@pytest.fixture(scope="module")
def server_batched(ckpt):
    """--batch-size 3 with a generous straggler window, so that a busy
    host still coalesces."""
    proc, url = _start(ckpt, "--batch-size", "3", "--max-wait-ms", "2000")
    yield url
    _stop(proc)


@pytest.fixture(scope="module")
def server_bucketed(ckpt):
    """Bucketed uploads and dynamic batching: solo requests ride the
    smallest fitting bucket, bursts re-pad to the full buffer."""
    proc, url = _start(ckpt, "--batch-size", "3", "--max-wait-ms", "2000",
                       "--buckets", f"512,1024,{CFG.max_points}")
    yield url
    _stop(proc)


@pytest.fixture(scope="module")
def server_multisweep(tmp_path_factory):
    import dataclasses

    cfg = dataclasses.replace(CFG, num_sweeps=3)
    ckpt = _jax_checkpoint(
        str(tmp_path_factory.mktemp("serve_ms") / "ck.msgpack"), cfg)
    proc, url = _start(ckpt, "--num-sweeps", "3")
    yield url, ckpt, dataclasses.replace(TCFG, num_sweeps=3)
    _stop(proc)


def _post(url, data, headers, path="/predict"):
    req = urllib.request.Request(url + path, data=data, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _json_body(pts):
    return (json.dumps({"points": pts.tolist()}).encode(),
            {"Content-Type": "application/json"})


def _as_served(boxes):
    """Boxes as the server writes them: float() of each f32 value."""
    return [{"center": [float(v) for v in b.center],
             "wlh": [float(v) for v in b.wlh], "yaw": float(b.yaw),
             "label": b.label, "score": float(b.score)} for b in boxes]


def _scene(seed, cfg=CFG, **kw):
    rng = np.random.default_rng(seed)
    return make_scene(rng, cfg, num_objects=5, clutter=800, **kw).points


def _burst(url, body, hdr, n=3):
    results = [None] * n

    def fire(i):
        results[i] = _post(url, body, hdr)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None for r in results)
    return results


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["device"] == "cpu"
    assert isinstance(health["sweeps"], int)


def test_predict_binary_and_json_match_jax(server, ckpt):
    pts = _scene(1)
    n = len(pts)
    out_bin = _post(server, pts.tobytes(),
                    {"Content-Type": "application/octet-stream",
                     "X-Point-Count": str(n)})
    out_json = _post(server, *_json_body(pts))
    assert out_bin["num_boxes"] == len(out_bin["boxes"]) > 0
    assert out_bin["batched"] == 1
    assert out_json["boxes"] == out_bin["boxes"]       # either wire

    port = Detector.from_checkpoint(TCFG, ckpt, device="cpu")
    assert out_bin["boxes"] == _as_served(port.predict(pts))
    # the JAX package's detector on the same checkpoint and cloud
    want = JaxDetector.from_checkpoint(CFG, ckpt).predict(pts)
    assert len(want) == out_bin["num_boxes"]
    for a, b in zip(out_bin["boxes"], want):
        assert a["label"] == b.label
        np.testing.assert_allclose(a["score"], b.score, atol=1e-4)
        np.testing.assert_allclose(a["center"], b.center, atol=5e-3)
        np.testing.assert_allclose(a["wlh"], b.wlh, atol=5e-3)
        assert abs((a["yaw"] - b.yaw + np.pi) % (2 * np.pi) - np.pi) < 5e-3
    with urllib.request.urlopen(server + "/healthz", timeout=60) as r:
        assert json.loads(r.read())["sweeps"] >= 2


@pytest.mark.parametrize("body", ["json_width", "binary_count", "no_points"])
def test_client_errors_are_400(server, body):
    if body == "json_width":
        bad = np.zeros((10, CFG.num_input_features + 2), np.float32)
        data, hdr = _json_body(bad)
    elif body == "binary_count":
        data = np.zeros((10, CFG.num_input_features), np.float32).tobytes()
        hdr = {"Content-Type": "application/octet-stream",
               "X-Point-Count": "11"}
    else:
        data, hdr = b'{"pts": []}', {"Content-Type": "application/json"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, data, hdr)
    assert ei.value.code == 400


def _assert_batched_match(results, want, det, pts):
    """Each response of a burst is the batch-3 call's boxes for its cloud,
    exactly (``serve.predict_batch``, the dispatcher's call); and the
    unbatched boxes at tests/test_serve.py's tolerance (a batch-3 conv
    reassociates float sums: last-ulp differences, so a count slack of 1)."""
    assert max(r["batched"] for r in results) >= 2
    for r in results:
        b = r["batched"]
        exact = (det.predict(pts) if b == 1
                 else serve.predict_batch(det, [pts] * b, 3)[0])
        assert r["boxes"] == _as_served(exact)
        assert abs(r["num_boxes"] - want["num_boxes"]) <= 1
        m = min(r["num_boxes"], want["num_boxes"])
        for a, w in zip(r["boxes"][:m], want["boxes"][:m]):
            np.testing.assert_allclose(a["center"], w["center"], rtol=1e-4,
                                       atol=1e-4)
            assert a["label"] == w["label"]


def test_dynamic_batching_coalesces_and_matches(server, server_batched,
                                                ckpt):
    pts = _scene(2)
    body, hdr = _json_body(pts)
    want = _post(server, body, hdr)
    solo = _post(server_batched, body, hdr)        # a lone request
    assert solo["batched"] == 1 and solo["boxes"] == want["boxes"]
    det = Detector.from_checkpoint(TCFG, ckpt, device="cpu")
    _assert_batched_match(_burst(server_batched, body, hdr), want, det, pts)
    assert want["num_boxes"] > 0


class _BlockedDetector:
    """Stands in for the card: ``predict`` waits until released."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def bind_thread(self):
        pass

    def predict(self, pts):
        self.entered.set()
        self.release.wait(timeout=60)
        return []


def test_full_queue_is_503_and_wedged_call_times_out():
    det = _BlockedDetector()
    det.device = torch.device("cpu")
    batcher = serve.DynamicBatcher(det, batch_size=2, max_wait_ms=0,
                                   max_queue=1, result_timeout_s=0.5)
    httpd = serve.ThreadingServer(("127.0.0.1", 0),
                                  serve.make_handler(det, TCFG, batcher))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        pts = np.zeros((4, TCFG.num_input_features), np.float32)
        # the dispatcher takes the first request and blocks in predict;
        # the wait for its result times out (the slot is abandoned)
        with pytest.raises(RuntimeError, match="no result within"):
            batcher.submit(pts)
        assert det.entered.is_set()
        # the next request fills the one-slot queue, the one after is 503
        with pytest.raises(RuntimeError, match="no result within"):
            batcher.submit(pts)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, *_json_body(pts))
        assert ei.value.code == 503
        assert "queue full" in json.loads(ei.value.read())["error"]
    finally:
        det.release.set()
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_sweep_streaming_endpoint(server_multisweep):
    """/sweep accumulates per stream and equals a local port detector fed
    the locally accumulated cloud (identity poses and a moving pose)."""
    url, ckpt, cfg = server_multisweep
    det = Detector.from_checkpoint(cfg, ckpt, device="cpu")
    rng = np.random.default_rng(3)
    for stream, moving in (("a", False), ("b", True)):
        acc = SweepAccumulator(3)
        for k in range(4):
            pts = _scene(10 + k)[:1300, :cfg.num_raw_features]
            t_us = k * 1e5
            pose = Pose.identity()
            hdr = {"Content-Type": "application/octet-stream",
                   "X-Point-Count": str(len(pts)),
                   "X-Timestamp-Us": str(t_us), "X-Stream-Id": stream}
            if moving:
                q = rng.normal(0, 1, 4)
                q = np.asarray([abs(q[0]) + 4.0, *q[1:]])
                pose = Pose(q / np.linalg.norm(q), rng.normal(0, 2, 3))
                hdr["X-Pose-Rotation"] = ",".join(repr(float(v))
                                                  for v in pose.rotation)
                hdr["X-Pose-Translation"] = ",".join(
                    repr(float(v)) for v in pose.translation)
            resp = _post(url, pts.tobytes(), hdr, path="/sweep")
            assert resp["sweeps_buffered"] == min(k + 1, 3)
            cloud = acc.push(pts, pose, t_us)
            assert resp["boxes"] == _as_served(det.predict(cloud))
        assert resp["num_boxes"] > 0
    bad = {"Content-Type": "application/octet-stream",
           "X-Pose-Rotation": "1,0,zero,0"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, np.zeros((2, 4), np.float32).tobytes(), bad, "/sweep")
    assert ei.value.code == 400


def test_sweep_on_single_sweep_config_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, b"", {"Content-Type": "application/octet-stream"},
              path="/sweep")
    assert ei.value.code == 400


def test_bucketed_server_matches_plain(server, server_bucketed, ckpt):
    pts = _scene(4)[:400]                     # -> the 512 bucket
    body, hdr = _json_body(pts)
    want = _post(server, body, hdr)
    solo = _post(server_bucketed, body, hdr)
    assert solo["batched"] == 1 and solo["boxes"] == want["boxes"]
    # bursts re-pad the bucket-sized pads to the full buffer
    det = Detector.from_checkpoint(TCFG, ckpt, device="cpu")
    _assert_batched_match(_burst(server_bucketed, body, hdr), want, det, pts)
    assert want["num_boxes"] > 0
