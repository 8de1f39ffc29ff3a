"""The port's CenterPoint-PP kind on the CPU, at a tiny config with seeded
weights, against the plain reference ``reference_cpu/centerpoint.py``
(float32 PyTorch and numpy, none of the port's ops): the two-layer PFN's
plain path (K1 and K2's two-layer instance in their plain versions), the
RPN with a 0.5 up-stride, the head's dense maps, decode + NMS as boxes and
scores, and ``Detector.predict_raw_batch`` end to end. Also: the pillar id
at 0.2 m on and one ulp either side of every cell boundary against true
f32 division; ``PillarsConfig``'s fingerprint and the artifact's load
unchanged; the published configuration; velocity through the packed rows
and ``Box3D``; the spans and counters; ``DynamicBatcher`` on a CenterPoint
detector."""

import dataclasses
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_center_util import center_cloud, center_state_dict
from tpu_pillars_torch.config import (
    PillarsConfig, centerpoint_pp_config, tiny_center_config,
)
from tpu_pillars_torch.detector import Detector, packed_to_boxes
from tpu_pillars_torch.models.backbone import RPNBackbone, UpBlock
from tpu_pillars_torch.models.centerpoint import CenterPoint, map_channels
from tpu_pillars_torch.ops import center_decode, emit, fused_pfn
from tpu_pillars_torch.ops.voxelize import (
    pillar_ids, pillarize_batch, sort_points_by_pillar,
)
from tpu_pillars_torch.reference_cpu import centerpoint as ref
from tpu_pillars_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CFG = tiny_center_config()
SD = center_state_dict(CFG, 0)


def _clouds(seed=0, sizes=(2500, 1200)):
    rng = np.random.default_rng(seed)
    return [center_cloud(rng, CFG, n) for n in sizes]


def _padded(det, clouds):
    padded = [det.pad_points(c) for c in clouds]
    return (np.stack([p for p, _ in padded]),
            np.asarray([n for _, n in padded], np.int32))


@pytest.fixture(scope="module")
def det():
    return Detector(CFG, SD, device="cpu")


@pytest.fixture(scope="module")
def reference():
    return ref.ReferenceCenterPoint(CFG, SD, "cpu", batch=2)


def _ref_weights():
    return {k: v.float() for k, v in SD.items()}


def test_published_configuration():
    cfg = centerpoint_pp_config()
    cfg.validate()
    assert (cfg.grid_w, cfg.grid_h) == (512, 512)
    assert (cfg.feature_w, cfg.feature_h) == (128, 128)
    assert cfg.num_input_features == 5 and cfg.num_decorated_features == 10
    assert cfg.num_tasks == 6 and cfg.num_classes == 10
    assert cfg.max_detections == 498
    assert [len(t.classes) for t in cfg.tasks] == [1, 2, 2, 1, 2, 2]
    model = CenterPoint(cfg)
    assert model.pfn.w1.shape == (10, 32) and model.pfn.w2.shape == (64, 64)
    assert map_channels(cfg) == 70
    convs = sum(1 for k, v in model.state_dict().items()
                if k.startswith("head.") and v.dim() == 4)
    assert convs == 73


def test_pillars_config_fingerprint_and_artifact_unchanged():
    from tpu_pillars_torch.weights import config_fingerprint

    assert config_fingerprint(PillarsConfig()).tobytes().hex() \
        == "1d0b23da64703599"
    det = Detector.from_checkpoint(
        PillarsConfig(), str(ROOT / "artifacts" /
                             "pointpillars_synth4k.msgpack"), device="cpu")
    assert det.model.pfn.kernel.shape == (9, 64)
    assert not det.is_center


def test_pillar_ids_divide_correctly_at_0_2_m():
    """Points on, and one ulp either side of, every 0.2 m cell boundary:
    the id is floor((x - x_min) / voxel) with a correctly rounded f32
    division (numpy's), in x and in y."""
    cfg = centerpoint_pp_config()
    k = np.arange(cfg.grid_w + 1, dtype=np.float64)
    edge = (cfg.x_min + k * cfg.voxel_x).astype(np.float32)
    xs = np.concatenate([edge, np.nextafter(edge, np.float32(-1e9)),
                         np.nextafter(edge, np.float32(1e9))])
    pts = np.zeros((1, len(xs), 5), np.float32)
    pts[0, :, 0] = xs
    pts[0, :, 1] = xs[::-1]
    got = pillar_ids(torch.from_numpy(pts), torch.tensor([len(xs)]),
                     cfg).numpy()[0]
    col = np.floor((xs - np.float32(cfg.x_min)) / np.float32(cfg.voxel_x))
    row = np.floor((xs[::-1] - np.float32(cfg.y_min))
                   / np.float32(cfg.voxel_y))
    ok = (col >= 0) & (col < cfg.grid_w) & (row >= 0) & (row < cfg.grid_h)
    want = np.where(ok, row * cfg.grid_w + col, cfg.grid_h * cfg.grid_w)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    # a multiply by the reciprocal would misplace some of these points
    recip = np.floor((xs - np.float32(cfg.x_min))
                     * np.float32(1.0 / np.float32(cfg.voxel_x)))
    assert (recip != col).any()


def _front_end(cfg, sd, clouds):
    """The port's plain front end -> (canvas (B, H, W, C), model)."""
    model = CenterPoint(cfg)
    model.load_state_dict(sd)
    det = Detector(cfg, sd, device="cpu")
    pts, ns = _padded(det, clouds)
    return det.canvas(torch.from_numpy(pts), torch.from_numpy(ns).long()), \
        det


def test_two_layer_pfn_plain_path_matches_reference():
    """Sort, K1 and K2's two-layer instance in their plain versions, K3:
    the canvas against the reference's PFN on its own pillarizer."""
    clouds = _clouds(1)
    canvas, det = _front_end(CFG, SD, clouds)
    w = _ref_weights()
    for b, c in enumerate(clouds):
        feats, mask, coords, pmask, _ = ref.pillarize(
            ref.crop_and_budget(c, CFG), CFG)
        x = ref.pfn(w, torch.from_numpy(feats)[None],
                    torch.from_numpy(mask)[None])[0]
        want = torch.zeros(CFG.grid_h, CFG.grid_w, x.shape[-1])
        live = torch.from_numpy(pmask)
        cc = torch.from_numpy(coords).long()
        want[cc[live, 0], cc[live, 1]] = x[live]
        torch.testing.assert_close(canvas[b], want, atol=2e-5, rtol=1e-5)
    assert canvas.abs().sum() > 0


def test_two_layer_pfn_kernel_plain_equals_module():
    """K2's two-layer plain version (folded weights, the emit table)
    against the unfolded ``TwoLayerPFN`` on a decorated ``PillarBatch``."""
    clouds = _clouds(2)
    det = Detector(CFG, SD, device="cpu")
    pts, ns = _padded(det, clouds)
    p, n = torch.from_numpy(pts), torch.from_numpy(ns).long()
    gid, sp = sort_points_by_pillar(p, n, CFG)
    table, meta = emit.emit_table(gid, fused_pfn.center_points(gid, sp, CFG),
                                  CFG.max_points_per_pillar, CFG.max_pillars,
                                  CFG.grid_h * CFG.grid_w)
    feats, pid, cnt = fused_pfn.pfn2_from_table(
        table, meta, *det.model.pfn.folded(CFG), CFG)
    batch = pillarize_batch(p, n, CFG)
    want = det.model.pfn(batch.features, batch.mask)
    torch.testing.assert_close(feats, want, atol=2e-5, rtol=1e-5)
    assert torch.equal(cnt > 0, batch.pillar_mask)
    assert (cnt > 0).sum() > 50
    # the module's own canvas (the unfolded PFN, then K3) is the served one
    torch.testing.assert_close(det.model.canvas_from_batch(batch),
                               det.canvas(p, n), atol=2e-5, rtol=1e-5)


def _published_pfn(sd, features, mask):
    """det3d's ``PillarFeatureNet`` from its decorated features on: zero
    the padded slots, then two ``PFNLayer``s (linear without bias,
    BatchNorm1d eps 1e-3 on running statistics, ReLU, the max over all N
    slots; the first layer's max repeated and concatenated)."""
    def layer(x, w, prefix):
        lin = torch.nn.Linear(w.shape[0], w.shape[1], bias=False)
        lin.weight.data = w.t()
        bn = torch.nn.BatchNorm1d(w.shape[1], eps=1e-3).eval()
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).data = sd[f"{prefix}.{name}"]
        y = lin(x)
        return torch.relu(bn(y.permute(0, 2, 1)).permute(0, 2, 1))

    B, P, N, D = features.shape
    x = (features * mask[..., None]).reshape(B * P, N, D)
    x = layer(x, sd["pfn.w1"], "pfn.bn1")
    x_max = x.amax(dim=1, keepdim=True)
    x = torch.cat([x, x_max.repeat(1, N, 1)], dim=2)
    out = layer(x, sd["pfn.w2"], "pfn.bn2").amax(dim=1)
    return out.reshape(B, P, -1)


@torch.no_grad()
def test_two_layer_pfn_takes_the_padded_slots_as_published():
    """The module and the reference against det3d's layers written out:
    a pillar's padded slots, relu(BN(0)) after layer 1, take part in both
    maxima. Counts 1 to N; the max over the points alone differs."""
    torch.manual_seed(4)
    P, N, D = 64, CFG.max_points_per_pillar, CFG.num_decorated_features
    feats = torch.randn(1, P, N, D)
    counts = torch.arange(P) % (N + 1)
    mask = (torch.arange(N)[None, :] < counts[:, None])[None]
    model = CenterPoint(CFG)
    model.load_state_dict(SD)
    want = _published_pfn(SD, feats, mask)
    want = torch.where(mask.any(-1)[..., None], want, 0.0)
    got = model.pfn(feats, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ref.pfn(_ref_weights(), feats, mask), want,
                               atol=1e-5, rtol=1e-5)
    # the padded slots move the features of the pillars that have them
    short = (counts > 0) & (counts < N)
    only_points = torch.stack([
        _published_pfn(SD, feats[:, p:p + 1, :int(c)],
                       mask[:, p:p + 1, :int(c)])[0, 0]
        for p, c in enumerate(counts.tolist()) if 0 < c < N])
    assert (only_points != want[0, short]).any(dim=-1).float().mean() > 0.25
    torch.testing.assert_close(want[0, counts == N],
                               _published_pfn(SD, feats, mask)[0, counts == N])


def test_rpn_with_half_up_stride_matches_reference():
    torch.manual_seed(0)
    model = CenterPoint(CFG)
    model.load_state_dict(SD)
    x = torch.relu(torch.randn(2, CFG.pfn_out, CFG.grid_h, CFG.grid_w))
    got = model.rpn(x.contiguous(memory_format=torch.channels_last))
    want = ref.rpn(_ref_weights(), x, CFG)
    assert got.shape == (2, 3 * CFG.rpn_up_channels, CFG.feature_h,
                         CFG.feature_w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert model.rpn.ups[0].weight.shape == (CFG.rpn_up_channels,
                                             CFG.rpn_channels[0], 2, 2)


def test_pointpillars_rpn_unchanged_by_up_strides():
    """The default up-strides are PointPillars' 1, 2, 4: the same modules,
    names and shapes, and the same output as explicit ones."""
    torch.manual_seed(1)
    a = RPNBackbone(8, (8, 16, 16), (2, 2, 2), 8)
    b = RPNBackbone(8, (8, 16, 16), (2, 2, 2), 8, up_strides=(1, 2, 4))
    assert all(isinstance(u, UpBlock) for u in a.ups)
    assert [u.stride for u in a.ups] == [1, 2, 4]
    sa = {k: v.shape for k, v in a.state_dict().items()}
    assert sa == {k: v.shape for k, v in b.state_dict().items()}
    for v in a.parameters():
        v.data.normal_()
    b.load_state_dict(a.state_dict())
    x = torch.randn(1, 8, 32, 32)
    assert torch.equal(a(x), b(x))


def test_head_maps_stacked_and_branch_by_branch_match_reference():
    """The served stacked convs (BatchNorms folded, one grouped output
    conv) against the reference's head, branch by branch."""
    torch.manual_seed(2)
    model = CenterPoint(CFG)
    model.load_state_dict(SD)
    feat = torch.randn(2, CFG.feature_h, CFG.feature_w,
                       3 * CFG.rpn_up_channels)
    stacked = model.head_maps(feat, model.head.stacked())
    want = ref.head(_ref_weights(), feat.permute(0, 3, 1, 2), CFG)
    assert stacked.shape == want.shape == (2, map_channels(CFG),
                                           CFG.feature_h, CFG.feature_w)
    torch.testing.assert_close(stacked, want, atol=1e-4, rtol=1e-4)


def _sets(boxes, scores, classes):
    order = np.lexsort((boxes[:, 1], boxes[:, 0], scores, classes))
    return boxes[order], scores[order], classes[order]


def test_decode_and_nms_match_reference():
    """The same dense maps through the port's decode + NMS (the dense IoU
    fixpoint on the CPU) and through the reference's: the same boxes,
    scores and classes, task by task."""
    torch.manual_seed(3)
    maps = torch.randn(2, map_channels(CFG), CFG.feature_h, CFG.feature_w)
    got = center_decode.center_postprocess(maps, CFG)
    want = [ref.postprocess(c, CFG) for c in ref.decode(maps, CFG)]
    assert got.boxes.shape == (2, CFG.max_detections, 7)
    for b in range(2):
        v = got.valid[b].numpy()
        pb = np.concatenate([got.boxes[b].numpy(),
                             got.velocity[b].numpy()], axis=1)[v]
        ps, pc = got.scores[b].numpy()[v], got.class_ids[b].numpy()[v]
        assert len(ps) == len(want[b].scores) > 0
        gb, gs, gc = _sets(pb, ps, pc)
        wb, ws, wc = _sets(want[b].boxes, want[b].scores, want[b].classes)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, atol=1e-6)
        np.testing.assert_allclose(gb, wb, atol=1e-5)
    # every candidate passed the threshold; NMS kept at most nms_post a task
    assert (got.scores[got.valid] > CFG.score_threshold).all()
    per_task = got.valid.reshape(2, CFG.num_tasks, CFG.nms_post).sum(-1)
    assert (per_task <= CFG.nms_post).all()


def test_predict_raw_batch_matches_reference_end_to_end(det, reference):
    clouds = _clouds(4, (3000, 1800))
    pts, ns = _padded(det, clouds)
    got = det.predict_raw_batch(pts, ns)
    want = reference.detect(clouds)
    for b in range(2):
        v = got.valid[b].numpy()
        pb = np.concatenate([got.boxes[b].numpy(),
                             got.velocity[b].numpy()], axis=1)[v]
        gb, gs, gc = _sets(pb, got.scores[b].numpy()[v],
                           got.class_ids[b].numpy()[v])
        wb, ws, wc = _sets(want[b].boxes, want[b].scores, want[b].classes)
        assert len(gs) == len(ws) > 0
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, atol=1e-5)
        np.testing.assert_allclose(gb, wb, atol=1e-4)


def test_packed_rows_and_boxes_carry_velocity(det):
    clouds = _clouds(5, (2000,))
    packed = det.predict_packed(clouds[0]).numpy()
    assert packed.shape == (CFG.max_detections, 12)
    boxes = packed_to_boxes(packed, CFG)
    assert len(boxes) == int(packed[:, 9].sum()) > 0
    row = packed[packed[:, 9] > 0][0]
    np.testing.assert_allclose(boxes[0].velocity, row[10:12])
    assert boxes[0].label in CFG.class_names
    q = np.array([np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)])
    moved = boxes[0].transformed(q, np.zeros(3))
    vx, vy = boxes[0].velocity
    np.testing.assert_allclose(moved.velocity, [-vy, vx], atol=1e-9)
    assert det.predict(clouds[0])[0].velocity is not None


def test_spans_and_counters(det):
    clouds = _clouds(6)
    pts, ns = _padded(det, clouds)
    profiling.reset()
    profiling.enable()
    try:
        det.predict_packed_batch(pts, ns)
    finally:
        profiling.disable()
    s = profiling.summary()
    profiling.reset()
    for name in ("detector.predict", "detector.frontend", "detector.rpn",
                 "detector.center_head", "detector.postprocess",
                 "detector.decode", "detector.nms"):
        assert s["spans"][name]["count"] == 1, name
    assert "detector.rpn_head" not in s["spans"]
    c = s["counters"]
    kept = det.predict_raw_batch(pts, ns).valid.sum().item()
    assert c["center.kept"] == kept
    assert c["center.candidates"] >= kept
    occupied = [ref.pillarize(ref.crop_and_budget(x, CFG), CFG)[4]
                for x in clouds]
    assert c["detector.pillars_dropped"] == sum(
        max(o - CFG.max_pillars, 0) for o in occupied)


def test_pillars_dropped_counts_the_pillars_over_the_budget():
    cfg = tiny_center_config(max_pillars=64)
    sd = center_state_dict(cfg, 1)
    det = Detector(cfg, sd, device="cpu")
    clouds = _clouds(7, (2000,))
    pts, ns = _padded(det, clouds)
    occupied = ref.pillarize(ref.crop_and_budget(clouds[0], cfg), cfg)[4]
    profiling.reset()
    profiling.enable()
    try:
        det.predict_packed_batch(pts, ns)
    finally:
        profiling.disable()
    dropped = profiling.summary()["counters"]["detector.pillars_dropped"]
    profiling.reset()
    assert dropped == occupied - 64 > 0


def test_count_device_adds_cpu_scalars():
    profiling.reset()
    profiling.count_device("x", torch.tensor(3))
    assert profiling.summary()["counters"] == {}
    profiling.enable()
    try:
        profiling.count_device("x", torch.tensor(3))
        profiling.count_device("x", torch.tensor(4))
    finally:
        profiling.disable()
    assert profiling.summary()["counters"]["x"] == 7
    profiling.reset()


def test_dynamic_batcher_serves_a_center_detector(det):
    from tpu_pillars_torch import serve

    clouds = _clouds(8, (1500, 900))
    batcher = serve.DynamicBatcher(det, batch_size=2, max_wait_ms=50)
    got = [batcher.submit(c)[0] for c in clouds]
    for c, boxes in zip(clouds, got):
        want = det.predict(c)
        assert len(boxes) == len(want) > 0
        assert all(a.label == b.label and abs(a.score - b.score) < 1e-6
                   for a, b in zip(boxes, want))


def test_center_detector_refuses_bf16():
    with pytest.raises(TypeError, match="float32"):
        Detector(CFG, SD, device="cpu", dtype=torch.bfloat16)


def test_reference_copies_are_the_same_code():
    """The benchmark's reference is the port's plain reference as it is,
    and imports nothing of the port."""
    a = ROOT / "tpu_pillars_torch" / "reference_cpu" / "centerpoint.py"
    b = ROOT / "pillarbench" / "reference" / "centerpoint.py"
    assert a.read_text() == b.read_text()
    assert "tpu_pillars" not in "".join(
        line for line in a.read_text().splitlines()
        if line.startswith(("import", "from")))


def test_calibrated_weights_scale_every_layer():
    """``reference.calibrate``: every BatchNorm's running statistics become
    its input's moments (moved by a draw), so the normalised activations
    have unit scale and the heatmaps score around the threshold."""
    w = _ref_weights()
    gen = torch.Generator().manual_seed(0)
    clouds = _clouds(9)
    cal = ref.calibrate(w, CFG, clouds, gen)
    changed = [k for k in w if k.endswith("running_var")
               and not torch.equal(w[k], cal[k])]
    assert len(changed) == sum(k.endswith("running_var") for k in w)
    r = ref.ReferenceCenterPoint(CFG, cal, "cpu", batch=2)
    maps = r.maps(clouds)
    scores = torch.sigmoid(maps[:, -1])
    assert 0.01 < float((scores > CFG.score_threshold).float().mean()) < 0.99


def test_pad_points_takes_the_centerpoint_config(det):
    cfg = dataclasses.replace(CFG, max_points=1000)
    d = Detector(cfg, SD, device="cpu")
    padded, n = d.pad_points(_clouds(10, (3000,))[0])
    assert padded.shape == (1000, 5) and n == 1000
    assert d.truncation.truncated_clouds == 1


def test_reference_reads_a_plain_namespace():
    """The reference takes any object with the fields (the benchmark hands
    it the config file's)."""
    fields = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    fields["tasks"] = [SimpleNamespace(classes=t.classes) for t in CFG.tasks]
    ns = SimpleNamespace(**fields)
    clouds = _clouds(11, (1000,))
    a = ref.ReferenceCenterPoint(ns, SD, "cpu").detect(clouds)[0]
    b = ref.ReferenceCenterPoint(CFG, SD, "cpu").detect(clouds)[0]
    np.testing.assert_array_equal(a.boxes, b.boxes)
    assert os.path.basename(ref.__file__) == "centerpoint.py"
