"""tpu_pillars_torch in bf16 vs the JAX package's bf16 paths on the CPU, at
``tiny_config()``, inputs drawn with numpy from seeds.

The reference's own bf16 tolerance (tests/test_bf16.py): median |d| of the
class logits under 0.02 and the 99th percentile of the box |d| under 0.1.
Every bf16 comparison below holds that bound, on the wire, the feature
maps, the heads and the batch moments alike (the two packages round at
the same points, so most values agree exactly).

* Serving: ``Detector(dtype=torch.bfloat16)`` against JAX
  ``Detector(dtype=jnp.bfloat16)`` and against the port's f32 wire, on the
  fused front end and the classic one with the plain bf16
  PillarFeatureNet; the wire stays f32 and ``predict`` gives finite boxes.
* The RPN (running and batch statistics) and both heads against flax
  ``PointPillars(dtype=jnp.bfloat16)``, ``_wire_head(dtype=)`` and
  ``feature_major_head(dtype=)``.
* K3's plain version: f32 rows -> bf16 canvas equals the f32 canvas cast
  to bf16 bit for bit; bf16 rows -> bf16 canvas equals JAX
  ``voxelize.scatter_to_bev`` bit for bit, and its backward the JAX
  ``jax.vjp`` of the training scatter's XLA path; other type pairs raise.
* Training: three steps against ``jax.jit(make_train_step(cfg,
  fused_frontend=True, compute_dtype=jnp.bfloat16))`` at the loss rtol of
  tests/test_fused_train.py (2e-2) with equal num_pos, the master state
  f32; remat "all" and "off" bit-equal; 25 steps on a fixed batch lower the
  loss (tests/test_train.py). ``main --bf16`` writes an f32 full checkpoint
  that the JAX ``restore_checkpoint`` reads.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene as jax_make_scene
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import weights
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.detector import Detector
from tpu_pillars_torch.models.pointpillars import PointPillars
from tpu_pillars_torch.ops import bev
from tpu_pillars_torch.train import loop, state as tstate
from tpu_pillars_torch.train.step import batch_to_device, make_train_step

CFG, TCFG = tiny_config(), tconfig.tiny_config()
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_bf16_close(got, want, what):
    """The reference's bf16 bound: median |d| < 0.02, 99th pct < 0.1."""
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert np.median(d) < 0.02, (what, np.median(d))
    assert np.quantile(d, 0.99) < 0.1, (what, np.quantile(d, 0.99))


# ---- serving ---------------------------------------------------------------

@pytest.mark.parametrize("front", ["fused", "classic_plain_pfn"])
def test_bf16_detector_matches_jax_bf16(front):
    from tpu_pillars.detector import Detector as JaxDetector

    variables = random_variables(CFG, seed=1)
    vj = jax.tree.map(jnp.asarray, variables)
    jax_kw, port_kw = (({"fused_frontend": True}, {}) if front == "fused"
                       else ({"use_pallas_pfn": False},
                             {"use_pallas_pfn": False}))
    jdet = JaxDetector(CFG, vj, dtype=jnp.bfloat16, **jax_kw)
    sd = weights.params_from_flax(variables, TCFG)
    port16 = Detector(TCFG, sd, device="cpu", dtype=BF16, **port_kw)
    port32 = Detector(TCFG, sd, device="cpu", **port_kw)
    assert port16.fused_frontend == (front == "fused")
    scene = jax_make_scene(np.random.default_rng(0), CFG, num_objects=5,
                           clutter=800)
    padded, n = port16.pad_points(scene.points)
    want = jdet._model(vj, jnp.asarray(padded), n)
    pts, cnt = _t(padded[None]), torch.tensor([int(n)])
    canvas = port16.canvas(pts, cnt)
    assert canvas.dtype == BF16
    got = port16.wire(canvas)
    f32 = port32._stage1(pts, cnt)
    for g, w, r, name in zip(got, want, f32, ("cls", "box", "dir")):
        assert g.dtype == r.dtype == torch.float32 and w.dtype == jnp.float32
        _assert_bf16_close(g[0].numpy(), np.asarray(w), f"{name} vs jax")
        _assert_bf16_close(g[0].numpy(), r[0].numpy(), f"{name} vs f32")
    # the two packages round at the same points: most logits agree exactly
    assert (got[0][0].numpy() == np.asarray(want[0])).mean() > 0.9
    boxes = port16.predict(scene.points)
    assert boxes and all(np.isfinite(b.to_array()).all() for b in boxes)


def test_bf16_detector_keeps_its_dtype_on_reload():
    v = random_variables(CFG, seed=2)
    sd = weights.params_from_flax(v, TCFG)
    det = Detector(TCFG, sd, device="cpu", dtype=BF16)
    det.load_state_dict(weights.params_from_flax(random_variables(CFG, 3),
                                                 TCFG))
    pts = np.zeros((1, TCFG.max_points, 4), np.float32)
    assert det.canvas(_t(pts), torch.tensor([0])).dtype == BF16
    assert all(p.dtype == torch.float32 for p in det.model.parameters())
    with pytest.raises(TypeError, match="bfloat16"):
        Detector(TCFG, sd, device="cpu", dtype=torch.float16)


# ---- RPN and heads -------------------------------------------------------

def test_rpn_and_heads_bf16_match_flax():
    from tpu_pillars.detector import _wire_head
    from tpu_pillars.models import PointPillars as JaxPointPillars
    from tpu_pillars.models.head import feature_major_head

    variables = random_variables(CFG, seed=3)
    vj = jax.tree.map(jnp.asarray, variables)
    rng = np.random.default_rng(3)
    canvas = np.maximum(rng.normal(0, 1, (2, CFG.grid_h, CFG.grid_w,
                                          CFG.pfn_channels)), 0)
    canvas *= (rng.random(canvas.shape[:3]) < 0.2)[..., None]
    canvas = canvas.astype(np.float32)
    model = PointPillars(TCFG)
    model.load_state_dict(weights.params_from_flax(variables, TCFG))

    serve = JaxPointPillars(CFG, dtype=jnp.bfloat16)
    want = serve.apply(vj, jnp.asarray(canvas),
                       method=JaxPointPillars.features_from_canvas)
    with torch.no_grad():
        got = model.features_from_canvas(_t(canvas), BF16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32),
                       "running-statistics features")

    train = JaxPointPillars(CFG, dtype=jnp.bfloat16,
                            use_running_average=False)
    want_t, mut = train.apply(vj, jnp.asarray(canvas),
                              method=JaxPointPillars.features_from_canvas,
                              mutable=["batch_stats"])
    got_t, moments = model.train_features_from_canvas(_t(canvas),
                                                      dtype=BF16)
    assert got_t.dtype == BF16
    assert all(m.dtype == v.dtype == torch.float32 for m, v in moments)
    _assert_bf16_close(got_t.detach().float().numpy(),
                       want_t.astype(jnp.float32), "batch-stats features")
    for bn, (mean, var) in zip(model.rpn.batch_norms(), moments):
        bn.update_running(mean.detach(), var.detach())
    stats = weights.flax_from_params(model.state_dict(), TCFG)
    for a, b in zip(jax.tree.leaves(stats["batch_stats"]["rpn"]),
                    jax.tree.leaves(mut["batch_stats"]["rpn"])):
        _assert_bf16_close(a, b, "running statistics")

    # both heads on one bf16 feature map
    feat = want
    tfeat = _t(np.asarray(feat.astype(jnp.float32))).to(BF16)
    wire = _wire_head(CFG, dtype=jnp.bfloat16)(vj["params"]["head"], feat)
    fm = feature_major_head(vj["params"]["head"], feat, CFG.num_classes,
                            CFG.anchors_per_loc, dtype=jnp.bfloat16)
    with torch.no_grad():
        t_wire = model.wire_head(tfeat, BF16)
        t_fm = model.head.feature_major(tfeat, BF16)
    for g, w in zip(list(t_wire) + list(t_fm), list(wire) + list(fm)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert tuple(g.shape) == w.shape
        _assert_bf16_close(g.numpy(), w, "head")


# ---- K3's plain version --------------------------------------------------

def _scatter_inputs(seed):
    from tpu_pillars_torch.ops import fused_pfn

    rng = np.random.default_rng(seed)
    pts = np.full((2, TCFG.max_points, 4), 1e6, np.float32)
    for i, n in enumerate((3000, 700)):
        pts[i, :n, 0] = rng.uniform(CFG.x_min, CFG.x_max, n)
        pts[i, :n, 1] = rng.uniform(CFG.y_min, CFG.y_max, n)
        pts[i, :n, 2] = rng.uniform(CFG.z_min, CFG.z_max, n)
        pts[i, :n, 3] = rng.uniform(0, 1, n)
    _, meta = fused_pfn.emit_centered_table(
        _t(pts), torch.tensor([3000, 700]), TCFG)
    m = meta.reshape(2, 8, CFG.max_pillars)
    feats = rng.normal(0, 1, (2, CFG.max_pillars, CFG.pfn_channels)
                       ).astype(np.float32)
    return feats, m[:, 1].to(torch.int32), m[:, 0] > 0


def test_scatter_bf16_instances_match_their_references():
    from tpu_pillars.ops.voxelize import scatter_to_bev as jax_scatter

    feats, pid, mask = _scatter_inputs(4)
    f32 = bev.scatter_to_bev_plain(_t(feats), pid, mask, TCFG)
    got = bev.scatter_to_bev(_t(feats), pid, mask, TCFG, BF16)
    assert got.dtype == BF16
    assert torch.equal(got.view(torch.int16), f32.to(BF16).view(torch.int16))

    rows16 = _t(feats).to(BF16)
    got16 = bev.scatter_to_bev(rows16, pid, mask, TCFG, BF16)
    coords = torch.stack([pid // CFG.grid_w, pid % CFG.grid_w], -1) \
        * mask[..., None]
    want16 = jax_scatter(jnp.asarray(feats).astype(jnp.bfloat16),
                         jnp.asarray(coords.numpy()),
                         jnp.asarray(mask.numpy()), CFG)
    assert want16.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        got16.view(torch.int16).numpy(),
        np.asarray(want16).view(np.int16))
    assert torch.equal(bev.scatter_to_bev_plain(rows16, pid, mask, TCFG,
                                                BF16).view(torch.int16),
                       got16.view(torch.int16))


def test_scatter_bf16_backward_matches_jax_vjp():
    from tpu_pillars.ops.bev_pallas import scatter_to_bev_train_auto

    feats, pid, mask = _scatter_inputs(5)
    rng = np.random.default_rng(5)
    cot = rng.normal(0, 1, (2, CFG.grid_h, CFG.grid_w, CFG.pfn_channels))
    cot16 = jnp.asarray(cot, jnp.bfloat16)
    _, vjp = jax.vjp(lambda f: scatter_to_bev_train_auto(
        f, jnp.asarray(pid.numpy()), jnp.asarray(mask.numpy()), CFG),
        jnp.asarray(feats).astype(jnp.bfloat16))
    (want,) = vjp(cot16)
    f = _t(feats).to(BF16).requires_grad_(True)
    bev.scatter_to_bev_diff(f, pid, mask, TCFG, BF16).backward(
        _t(np.asarray(cot16.astype(jnp.float32))).to(BF16))
    assert f.grad.dtype == BF16
    np.testing.assert_array_equal(f.grad.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_scatter_refuses_other_dtype_pairs():
    feats, pid, mask = _scatter_inputs(6)
    with pytest.raises(TypeError, match="float16"):
        bev.scatter_to_bev(_t(feats).half(), pid, mask, TCFG, BF16)
    with pytest.raises(TypeError, match="bfloat16 -> torch.float32"):
        bev.scatter_to_bev(_t(feats).to(BF16), pid, mask, TCFG)
    with pytest.raises(TypeError):
        bev.scatter_to_bev_plain(_t(feats).half(), pid, mask, TCFG,
                                 torch.float16)
    with pytest.raises(TypeError):          # K9 takes f32 rows only
        bev.scatter_to_bev_emit(_t(feats).to(BF16), pid, mask, TCFG)


# ---- training ------------------------------------------------------------

def _batch(seed, num_objects=6, points_per_object=60, clutter=400,
           max_gt=16):
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, TCFG, num_objects=num_objects,
                         points_per_object=points_per_object,
                         clutter=clutter) for _ in range(2)]
    return scenes_to_train_batch(scenes, TCFG, max_gt)


def _port_state(variables, max_gt=16):
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=max_gt,
                              total_steps=60, compute_dtype="bfloat16")
    sd = None if variables is None else weights.params_from_flax(variables,
                                                                 TCFG)
    return tstate.create_train_state(TCFG, tcfg, device="cpu",
                                     state_dict=sd)


def test_bf16_train_steps_match_jax():
    from tpu_pillars.train import TrainBatch, TrainConfig, \
        create_train_state, make_train_step as jax_step

    arrays = _batch(12)
    variables = random_variables(CFG, seed=4)
    jst = create_train_state(CFG, TrainConfig(batch_size=2, max_gt_boxes=16,
                                              total_steps=60))
    params = jax.tree.map(jnp.asarray, variables["params"])
    jst = jst.replace(params=params,
                      batch_stats=jax.tree.map(jnp.asarray,
                                               variables["batch_stats"]),
                      opt_state=jst.tx.init(params))
    jstep = jax.jit(jax_step(CFG, fused_frontend=True,
                             compute_dtype=jnp.bfloat16))
    jbatch = TrainBatch(*(jnp.asarray(x) for x in arrays))
    st = _port_state(variables)
    step = make_train_step(TCFG, compute_dtype=BF16)
    for i in range(3):
        jst, jl = jstep(jst, jbatch)
        st, tl = step(st, batch_to_device(arrays, "cpu"))
        assert tl.total.dtype == torch.float32
        np.testing.assert_allclose(float(tl.total), float(jl.total),
                                   rtol=2e-2, err_msg=f"step {i}")
        assert int(tl.num_pos) == int(jl.num_pos) > 0
    # the master state stays f32: parameters, statistics, AdamW moments
    assert all(t.dtype == torch.float32
               for t in st.model.state_dict().values())
    moments = st.optimizer.state_arrays()
    assert all(m.dtype == torch.float32
               for m in moments["mu"] + moments["nu"])
    for leaf in jax.tree.leaves(jst.params):
        assert leaf.dtype == jnp.float32


def _fixed_targets(batch):
    """An assigner that returns ``batch``'s targets, computed once (K5's
    plain version): the steps on a fixed batch then run the model alone."""
    from tpu_pillars_torch.ops.assign import make_windowed_assigner

    targets = make_windowed_assigner(TCFG, 16)(batch.gt_boxes,
                                               batch.gt_classes,
                                               batch.gt_valid)
    return lambda *_: targets


def test_bf16_remat_all_and_off_bit_equal():
    arrays = _batch(11)
    variables = random_variables(CFG, seed=3)
    assign = _fixed_targets(batch_to_device(arrays, "cpu"))
    outs = []
    for remat in ("all", "off"):
        st = _port_state(variables)
        step = make_train_step(TCFG, remat=remat, compute_dtype=BF16,
                               assigner=assign)
        ls = []
        for _ in range(2):
            st, losses = step(st, batch_to_device(arrays, "cpu"))
            ls.append([float(x) for x in losses])
        outs.append((ls, [t.clone() for t in
                          st.model.state_dict().values()]))
    (l0, s0), (l1, s1) = outs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_bf16_train_step_learns():
    """tests/test_train.py's check at its sizes: 25 bf16 steps on a fixed
    batch lower the loss (its targets assigned once)."""
    arrays = _batch(13, num_objects=4, points_per_object=120, clutter=300,
                    max_gt=8)
    st = _port_state(None, max_gt=8)
    batch = batch_to_device(arrays, "cpu")
    step = make_train_step(TCFG, compute_dtype=BF16,
                           assigner=_fixed_targets(batch))
    st, first = step(st, batch)
    assert first.total.dtype == torch.float32
    for _ in range(25):
        st, losses = step(st, batch)
    assert np.isfinite(float(losses.total))
    assert float(losses.total) < float(first.total)
    assert all(p.dtype == torch.float32 for p in st.model.parameters())


def test_main_bf16_trains_and_writes_an_f32_checkpoint(tmp_path):
    """``main --bf16`` (in place of the refusal it had): 2 steps, an f32
    full checkpoint that the JAX ``restore_checkpoint`` reads, an f32
    ``Detector`` serves and an f32 run resumes."""
    from tpu_pillars.train import TrainConfig, create_train_state
    from tpu_pillars.train.checkpoint import restore_checkpoint

    out = str(tmp_path / "run")
    loop.main(["--bf16", "--steps", "2", "--batch", "2", "--device", "cpu",
               "--out", out])
    lines = [json.loads(x) for x in open(os.path.join(out, "train.jsonl"))]
    assert [x["compute_dtype"] for x in lines if x["event"] == "start"] == \
        ["bfloat16"]
    steps = [x for x in lines if x["event"] == "train_step"]
    assert [x["step"] for x in steps] == [2]
    assert np.isfinite(steps[0]["loss"])
    path = os.path.join(out, "ckpt.msgpack")
    tree = weights.load_flax_msgpack(path)
    assert int(tree["step"]) == 2
    leaves = jax.tree.leaves({"params": tree["params"],
                              "batch_stats": tree["batch_stats"],
                              "opt_state": tree["opt_state"]})
    assert all(np.asarray(x).dtype in (np.float32, np.int32, np.int64)
               for x in leaves)
    assert any(np.asarray(x).dtype == np.float32 for x in leaves)
    restored = restore_checkpoint(
        path, create_train_state(CFG, TrainConfig(batch_size=2)), config=CFG)
    assert int(restored.step) == 2
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(tree["params"])):
        assert a.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    det = Detector.from_checkpoint(TCFG, path, device="cpu")
    assert det.dtype == torch.float32
    # an f32 run resumes the bf16 run's checkpoint
    loop.main(["--steps", "3", "--batch", "2", "--device", "cpu",
               "--out", out, "--resume"])
    starts = [x for x in map(json.loads,
                             open(os.path.join(out, "train.jsonl")))
              if x["event"] == "start"]
    assert [(x["resumed_at"], x["compute_dtype"]) for x in starts] == \
        [(0, "bfloat16"), (2, "float32")]
    assert int(weights.load_flax_msgpack(path)["step"]) == 3
