"""tpu_pillars_torch's deployment artifacts (``export.py``, and the ops of
the ``tpu_pillars`` namespace that their graphs name) on the CPU, at
``tiny_config()`` — the cases of tests/test_export.py on the port.

* ``config_to_dict`` equals the JAX package's, and round-trips.
* The artifact is self-contained: its files, its manifest, the weights
  inside, and a graph that names the kernels' ops (K1, K2, K3; K4 and the
  fixpoint with ``nms_impl="pallas"``) and inlines none of their plain
  versions.
* The loaded artifact equals the live port ``Detector`` bit for bit
  (batch 2, and the Box3D surface at batch 1), also on degenerate clouds
  (no points, every point out of range); the live ``Detector`` matches the
  JAX ``Detector`` at tests/test_torch_detector.py's tolerance.
* A batch it was not exported for is refused; the CLI exports from a
  checkpoint (with the CPU's default NMS, the dense fixpoint, whose loop
  is one op); the NMS fixpoint exports as one op equal to its loop.

One export per module fixture, on the K4 route, whose stage 2 is small
(the dense fixpoint's inlines ~2,000 nodes of IoU: the CLI case pays
that once).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import Detector as JaxDetector
from torch_port_util import assert_packed_close, random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import export
from tpu_pillars_torch.detector import Detector
from tpu_pillars_torch.weights import params_from_flax

CFG, TCFG = tiny_config(), tconfig.tiny_config()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(variables, port state dict, artifact dir, manifest) exported at
    batch sizes 1 and 2 on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    variables = random_variables(CFG, seed=7)
    sd = params_from_flax(variables, TCFG)
    path = str(tmp_path_factory.mktemp("export") / "art")
    manifest = export.export_inference(TCFG, sd, path, batch_sizes=(1, 2),
                                       nms_impl="pallas", device="cpu")
    torch.set_num_threads(n)
    return variables, sd, path, manifest


@pytest.fixture(scope="module")
def loaded(artifact):
    return export.load_inference(artifact[2])


def _scenes(seed, n=2):
    rng = np.random.default_rng(seed)
    return [make_scene(rng, CFG, num_objects=6, points_per_object=100,
                       clutter=900).points for _ in range(n)]


def _batch(det, clouds):
    pads = [det.pad_points(c) for c in clouds]
    return (np.stack([p for p, _ in pads]),
            np.asarray([n for _, n in pads], np.int32))


def test_config_dict_round_trip_matches_jax():
    from tpu_pillars import config as jconfig
    from tpu_pillars.export import config_to_dict as jax_to_dict

    for name in ("tiny_config", "car_only_config", "multisweep_config"):
        port_cfg = getattr(tconfig, name)()
        d = export.config_to_dict(port_cfg)
        assert d == jax_to_dict(getattr(jconfig, name)())
        assert export.config_from_dict(json.loads(json.dumps(d))) == port_cfg
    full = tconfig.PillarsConfig()
    assert export.config_to_dict(full) == jax_to_dict(jconfig.PillarsConfig())
    assert export.config_from_dict(export.config_to_dict(full)) == full


def test_artifact_is_self_contained(artifact):
    variables, _, path, manifest = artifact
    from tpu_pillars_torch.ops.anchors import make_anchors
    from tpu_pillars_torch.weights import config_fingerprint

    files = set(os.listdir(path))
    assert files == {"manifest.json", "model_b1.pt2", "post_b1.pt2",
                     "model_b2.pt2", "post_b2.pt2"}
    with open(os.path.join(path, "manifest.json")) as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(manifest))
    assert manifest["batch_sizes"] == [1, 2]
    assert manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["config_fingerprint"] == \
        config_fingerprint(TCFG).tobytes().hex()
    A = len(make_anchors(TCFG)[1])
    assert manifest["stages"]["2"]["wire_shapes"] == [[2, A], [2, 7, A],
                                                     [2, 2, A]]
    assert manifest["stages"]["2"]["packed_shape"] == \
        [2, TCFG.max_detections, 10]
    # the weights are inside stage 1
    n_param_bytes = 4 * sum(int(np.prod(np.shape(x))) for x in
                            _leaves(variables["params"]))
    assert os.path.getsize(os.path.join(path, "model_b1.pt2")) \
        > 0.5 * n_param_bytes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_graph_names_the_kernel_ops(artifact):
    path = artifact[2]

    def targets(prog):
        out = set()
        for gm in [prog.graph_module] + [
                m for _, m in prog.graph_module.named_modules()]:
            if hasattr(gm, "graph"):
                out |= {str(n.target) for n in gm.graph.nodes
                        if n.op == "call_function"}
        return out

    model = targets(torch.export.load(os.path.join(path, "model_b2.pt2")))
    post = targets(torch.export.load(os.path.join(path, "post_b2.pt2")))
    for op in ("emit_table", "pfn_from_table", "scatter_to_bev"):
        assert f"tpu_pillars.{op}.default" in model
    for op in ("overlap_matrix", "nms_fixpoint"):
        assert f"tpu_pillars.{op}.default" in post
    # neither the kernels' plain versions nor the loop are inlined: the
    # plain emit / scatter are masked stores, the fixpoint a matmul loop
    for t in model | post:
        assert "index_put" not in t and "cummax" not in t, t
    assert not any("matmul" in t or "bmm" in t for t in post)


def test_exported_matches_live_detector_bitwise(artifact, loaded):
    _, sd, _, _ = artifact
    live = Detector(TCFG, sd, device="cpu", nms_impl="pallas")
    pts, ns = _batch(loaded, _scenes(0))
    got = loaded.predict_packed_batch(pts, ns)
    want = live.predict_packed_batch(pts, ns)
    assert got.dtype == want.dtype and got.device.type == "cpu"
    assert torch.equal(got, want)
    assert (got[..., 9] > 0).sum() > 0

    clouds = _scenes(1, n=1)
    boxes_e, boxes_d = loaded.predict(clouds[0]), live.predict(clouds[0])
    assert len(boxes_e) == len(boxes_d) > 0
    for be, bd in zip(boxes_e, boxes_d):
        assert be.label == bd.label and be.score == bd.score
        np.testing.assert_array_equal(be.center, bd.center)
        np.testing.assert_array_equal(be.wlh, bd.wlh)


def test_live_port_matches_jax_detector(artifact, loaded):
    """The live port Detector the artifact reproduces against the JAX
    Detector on the same weights (tests/test_torch_detector.py's
    tolerance), so the artifact does too."""
    variables = artifact[0]
    jdet = JaxDetector(CFG, variables, fused_frontend=True,
                       nms_impl="pallas")
    pts, ns = _batch(loaded, _scenes(2))
    want = np.asarray(jdet.predict_packed_batch(jnp.asarray(pts),
                                                jnp.asarray(ns)))
    got = loaded.predict_packed_batch(pts, ns).numpy()
    assert got.shape == want.shape == (2, CFG.max_detections, 10)
    assert sum(assert_packed_close(got[b], want[b], 1e-4, 5e-3)
               for b in range(2)) > 0


def test_degenerate_inputs(artifact, loaded):
    """No points, and every point outside the detection range: the
    artifact equals the live Detector. An empty cloud pads alike; the far
    points the artifact keeps as given (n = 500, as the JAX artifact), the
    live Detector crops them on the host (n = 0), and both give the same
    boxes."""
    _, sd, _, _ = artifact
    live = Detector(TCFG, sd, device="cpu", nms_impl="pallas")
    rng = np.random.default_rng(3)
    far = rng.uniform(200, 400, (500, 4)).astype(np.float32)
    empty = np.zeros((0, 4), np.float32)
    pe, ne = loaded.pad_points(empty)
    pl, nl = live.pad_points(empty)
    np.testing.assert_array_equal(pe, pl)
    assert ne == nl == 0
    pts, ns = _batch(loaded, [empty, far])
    np.testing.assert_array_equal(ns, [0, 500])
    np.testing.assert_array_equal(pts[1, :500], far)
    got = loaded.predict_packed_batch(pts, ns)
    assert torch.isfinite(got).all()
    assert torch.equal(got, live.predict_packed_batch(pts, ns))
    cropped, n_cropped = _batch(live, [empty, far])
    np.testing.assert_array_equal(n_cropped, [0, 0])
    assert torch.equal(got, live.predict_packed_batch(cropped, n_cropped))
    # the raw far points unpadded by the host crop: the device drops them
    raw = np.full((2, TCFG.max_points, 4), 1e6, np.float32)
    raw[1, :500] = far
    counts = np.asarray([0, 500], np.int32)
    assert torch.equal(loaded.predict_packed_batch(raw, counts),
                       live.predict_packed_batch(raw, counts))


def test_pads_as_the_jax_artifact_over_budget(artifact, loaded, tmp_path):
    """An over-budget cloud whose first rows are out of range: the
    artifact keeps the same count and the same first rows as the JAX
    artifact's ``pad_points`` (the first max_points rows as given, no host
    crop), and both artifacts give the same packed detections, at
    tests/test_torch_detector.py's tolerance."""
    from tpu_pillars.export import export_inference as jax_export
    from tpu_pillars.export import load_inference as jax_load

    rng = np.random.default_rng(11)
    far = rng.uniform(200, 400, (100, 4)).astype(np.float32)
    near = make_scene(rng, CFG, num_objects=6, points_per_object=100,
                      clutter=3600).points
    cloud = np.concatenate([far, near])
    assert len(near) >= CFG.max_points
    path = str(tmp_path / "jax_art")
    jax_export(CFG, artifact[0], path, batch_sizes=(1,), fused_frontend=True,
               nms_impl="pallas")
    jart = jax_load(path)
    with pytest.warns(RuntimeWarning, match="204 dropped"):
        got, n = loaded.pad_points(cloud)
    want, jn = jart.pad_points(cloud)
    assert n == jn == CFG.max_points
    np.testing.assert_array_equal(got[:n], want[:jn])
    np.testing.assert_array_equal(got[:100], far)
    g = loaded.predict_packed_batch(got[None], np.asarray([n]))[0].numpy()
    w = np.asarray(jart.predict_packed_batch(jnp.asarray(want[None]),
                                             jnp.asarray([jn])))[0]
    assert assert_packed_close(g, w, 1e-4, 5e-3) > 0


def test_exported_rejects_wrong_batch(loaded):
    with pytest.raises(ValueError, match="batch 3"):
        loaded.predict_packed_batch(
            np.zeros((3, TCFG.max_points, TCFG.num_input_features),
                     np.float32), np.zeros((3,), np.int32))
    assert loaded.batch_sizes == [1, 2]


def test_cli_exports_from_checkpoint(tmp_path):
    from tpu_pillars_torch.train.checkpoint import save_checkpoint
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    ckpt = str(tmp_path / "ck.msgpack")
    state = create_train_state(TCFG, TrainConfig(batch_size=1,
                                                 max_gt_boxes=4,
                                                 total_steps=10),
                               device="cpu")
    save_checkpoint(ckpt, state, config=TCFG)
    out = str(tmp_path / "art")
    export.main(["--ckpt", ckpt, "--out", out, "--preset", "tiny",
                 "--batch-sizes", "2", "--device", "cpu"])
    exp = export.load_inference(out)
    assert exp.batch_sizes == [2] and exp.config == TCFG
    # the CPU's default NMS, the dense fixpoint: its loop is one op
    post = torch.export.load(os.path.join(out, "post_b2.pt2"))
    assert "tpu_pillars.nms_fixpoint.default" in {
        str(n.target) for _, m in post.graph_module.named_modules()
        if hasattr(m, "graph") for n in m.graph.nodes}
    live = Detector.from_checkpoint(TCFG, ckpt, device="cpu")
    pts, ns = _batch(exp, _scenes(4))
    assert torch.equal(exp.predict_packed_batch(pts, ns),
                       live.predict_packed_batch(pts, ns))
    with pytest.raises(ValueError, match="batch size 1"):
        exp.predict(_scenes(5, n=1)[0])
    # a checkpoint written for another config is refused
    with pytest.raises(ValueError, match="different PillarsConfig"):
        export.main(["--ckpt", ckpt, "--out", str(tmp_path / "x"),
                     "--preset", "car_only", "--device", "cpu"])


def test_nms_fixpoint_exports_as_one_op(tmp_path):
    """The fixpoint's host-side loop inside one op: exported, saved and
    loaded, it equals the loop on random overlap matrices, and the graph
    holds the op alone."""
    from tpu_pillars_torch.ops.nms import nms_fixpoint

    class Fix(torch.nn.Module):
        def forward(self, over, valid):
            return nms_fixpoint(over, valid)

    rng = np.random.default_rng(0)
    K = 48
    tri = np.triu(np.ones((K, K), bool), 1)
    over = torch.from_numpy((rng.random((3, K, K)) < 0.1) & tri)
    valid = torch.from_numpy(rng.random((3, K)) < 0.9)
    prog = torch.export.export(Fix(), (over, valid), strict=False)
    torch.export.save(prog, str(tmp_path / "fix.pt2"))
    loaded = torch.export.load(str(tmp_path / "fix.pt2")).module()
    calls = [str(n.target) for n in prog.graph.nodes
             if n.op == "call_function"]
    assert calls == ["tpu_pillars.nms_fixpoint.default"]
    for b in range(4):
        o = torch.from_numpy((rng.random((3, K, K)) < 0.05 * (b + 1)) & tri)
        v = torch.from_numpy(rng.random((3, K)) < 0.9)
        want = nms_fixpoint(o, v)
        got = loaded(o, v)
        assert torch.equal(got, want) and got is not v
