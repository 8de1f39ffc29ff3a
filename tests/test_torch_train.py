"""tpu_pillars_torch's training path vs the JAX package on the CPU, at
``tiny_config()``, inputs drawn with numpy from seeds.

* Losses (``detection_loss_fm``) at rtol 1e-6; the feature-major head at
  atol 1e-5; the train-mode fused PFN (features rtol 1e-4, moments rtol
  1e-4 / 1e-3, as tests/test_fused_train.py pins the fused path against the
  classic one); the K3 scatter's forward and backward bit-equal to
  ``scatter_to_bev_ring_diff`` and its VJP (interpret mode); train-mode
  BatchNorm output and running update against flax's ``nn.BatchNorm``.
* The optimizer: the schedule for total_steps in {1, 3, 10, 10000} and
  clip + AdamW updates against optax at rtol 1e-6.
* remat "all" / "pfn" / "rpn" / off give bit-equal losses, parameters and
  running statistics.
* Three whole steps against ``jax.jit(make_train_step(cfg,
  fused_frontend=True))``: loss rtol 2e-3 per step and equal num_pos (the
  fused-vs-classic tolerance of tests/test_fused_train.py), parameters atol
  5e-4, running statistics rtol 1e-2 / atol 1e-4.
* Gradient accumulation against the JAX step with the same accum_steps.
* The inference checkpoint: flax reads it back (same tree, same bytes as
  ``flax.serialization.to_bytes``), and both packages' ``Detector`` serve it
  with the same boxes at the tolerance of tests/test_torch_detector.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene as jax_make_scene
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import weights
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.models.backbone import BatchNorm
from tpu_pillars_torch.ops import bev, fused_pfn, losses as tlosses
from tpu_pillars_torch.ops.target_assigner import Targets
from tpu_pillars_torch.train import loop, state as tstate
from tpu_pillars_torch.train.step import batch_to_device, make_train_step

CFG, TCFG = tiny_config(), tconfig.tiny_config()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_train_golden_synth4k.npz")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _cloud(rng, ns, cfg=CFG):
    pts = np.full((len(ns), cfg.max_points, 4), 1e6, dtype=np.float32)
    for i, n in enumerate(ns):
        pts[i, :n, 0] = rng.uniform(cfg.x_min - 2, cfg.x_max + 2, n)
        pts[i, :n, 1] = rng.uniform(cfg.y_min - 2, cfg.y_max + 2, n)
        pts[i, :n, 2] = rng.uniform(cfg.z_min, cfg.z_max, n)
        pts[i, :n, 3] = rng.uniform(0, 1, n)
    return pts, np.asarray(ns, np.int32)


# ---- losses, head, PFN, scatter, BatchNorm -------------------------------

def test_losses_match_jax():
    from tpu_pillars.ops.losses import detection_loss_fm as jax_loss
    from tpu_pillars.ops.target_assigner import Targets as JTargets

    rng = np.random.default_rng(0)
    B, K, A = 2, CFG.num_classes, 3000
    cls = rng.normal(0, 3, (B, K, A)).astype(np.float32)
    box = rng.normal(0, 1, (B, 7, A)).astype(np.float32)
    dirl = rng.normal(0, 2, (B, 2, A)).astype(np.float32)
    pos = rng.random((B, A)) < 0.02
    neg = ~pos & (rng.random((B, A)) < 0.9)
    onehot = np.zeros((B, K, A), np.float32)
    onehot[np.arange(B)[:, None], rng.integers(0, K, (B, A)),
           np.arange(A)[None]] = 1.0
    onehot *= pos[:, None]
    reg = (rng.normal(0, 1, (B, 7, A)) * pos[:, None]).astype(np.float32)
    dirt = ((rng.random((B, A)) < 0.5) & pos).astype(np.int32)
    tgt = (onehot, reg, dirt, (pos | neg).astype(np.float32),
           pos.astype(np.float32), pos.sum(1).astype(np.float32))
    want = jax.vmap(lambda c, b, d, t: jax_loss(c, b, d, t, CFG))(
        jnp.asarray(cls), jnp.asarray(box), jnp.asarray(dirl),
        JTargets(*(jnp.asarray(x) for x in tgt)))
    got = tlosses.detection_loss_fm(_t(cls), _t(box), _t(dirl),
                                    Targets(*(_t(x) for x in tgt)), TCFG)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=name)


def test_feature_major_head_matches_jax():
    from tpu_pillars.models.head import feature_major_head
    from tpu_pillars_torch.models.pointpillars import PointPillars

    v = random_variables(CFG, seed=2)
    rng = np.random.default_rng(2)
    feat = rng.normal(0, 1, (2, CFG.feature_h, CFG.feature_w,
                             3 * CFG.rpn_up_channels)).astype(np.float32)
    want = feature_major_head(jax.tree.map(jnp.asarray, v["params"]["head"]),
                              jnp.asarray(feat), CFG.num_classes,
                              CFG.anchors_per_loc)
    model = PointPillars(TCFG)
    model.load_state_dict(weights.params_from_flax(v, TCFG))
    with torch.no_grad():
        got = model.head.feature_major(_t(feat))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def _pfn_inputs(rng):
    D, C = CFG.num_decorated_features, CFG.pfn_channels
    w = (rng.normal(size=(D, C)) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    return w, scale, bias


def test_pfn_train_from_table_matches_jax():
    from tpu_pillars.ops.fused_pfn import (
        emit_centered_table as jax_emit, pfn_train_from_table as jax_pfn,
    )

    rng = np.random.default_rng(4)
    pts, ns = _cloud(rng, [3000, 4096, 1, 0])
    w, scale, bias = _pfn_inputs(rng)
    jt, jm = jax_emit(jnp.asarray(pts), jnp.asarray(ns), CFG, interpret=True)
    jf, jpid, jcnt, jmean, jvar = jax_pfn(jt, jm, jnp.asarray(w),
                                          jnp.asarray(scale),
                                          jnp.asarray(bias), CFG)
    table, meta = fused_pfn.emit_centered_table(_t(pts), _t(ns), TCFG)
    f, pid, cnt, mean, var = fused_pfn.pfn_train_from_table(
        table, meta, _t(w), _t(scale), _t(bias), TCFG)
    P = CFG.max_pillars
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid)[:, :P])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt)[:, :P])
    np.testing.assert_allclose(f.numpy(), np.asarray(jf)[:, :P], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-3,
                               atol=1e-6)


def test_pfn_from_table_diff_matches_plain():
    rng = np.random.default_rng(5)
    pts, ns = _cloud(rng, [3000, 1500])
    w, _, _ = _pfn_inputs(rng)
    b = (rng.normal(size=(CFG.pfn_channels,)) * 0.1).astype(np.float32)
    table, meta = fused_pfn.emit_centered_table(_t(pts), _t(ns), TCFG)
    w_eff, w_dec = fused_pfn.fold_decoration(_t(w), _t(b), TCFG)
    got = fused_pfn.pfn_from_table_diff(table, meta, w_eff, w_dec, TCFG)
    want = fused_pfn.pfn_from_table_plain(table, meta, w_eff, w_dec, TCFG)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_scatter_diff_matches_jax_ring_vjp():
    from tpu_pillars.ops.bev_pallas import scatter_to_bev_ring_diff

    rng = np.random.default_rng(6)
    pts, ns = _cloud(rng, [3000, 700])
    table, meta = fused_pfn.emit_centered_table(_t(pts), _t(ns), TCFG)
    m = meta.reshape(2, 8, CFG.max_pillars)
    pid, mask = m[:, 1].to(torch.int32), m[:, 0] > 0
    feats = rng.normal(0, 1, (2, CFG.max_pillars, CFG.pfn_channels)
                       ).astype(np.float32)
    cot = rng.normal(0, 1, (2, CFG.grid_h, CFG.grid_w, CFG.pfn_channels)
                     ).astype(np.float32)
    out, vjp = jax.vjp(lambda f: scatter_to_bev_ring_diff(
        f, jnp.asarray(pid.numpy()), jnp.asarray(mask.numpy()), CFG),
        jnp.asarray(feats))
    (want_g,) = vjp(jnp.asarray(cot))
    f = _t(feats).requires_grad_(True)
    got = bev.scatter_to_bev_diff(f, pid, mask, TCFG)
    got.backward(_t(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(want_g))
    # and the plain autograd gradient of the plain scatter
    f2 = _t(feats).requires_grad_(True)
    bev.scatter_to_bev_plain(f2, pid, mask, TCFG).backward(_t(cot))
    assert torch.equal(f.grad, f2.grad)


def test_batchnorm_train_matches_flax():
    import flax.linen as nn

    rng = np.random.default_rng(7)
    x = (rng.normal(0.5, 2.0, (2, 10, 12, 16))).astype(np.float32)  # NHWC
    scale = rng.normal(1.0, 0.1, 16).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 16).astype(np.float32)
    rm = rng.normal(0.0, 0.1, 16).astype(np.float32)
    rv = (np.abs(rng.normal(1.0, 0.1, 16)) + 0.1).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                      epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rm),
                                 "var": jnp.asarray(rv)}}
    y, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(16)
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
        port.running_mean.copy_(_t(rm))
        port.running_var.copy_(_t(rv))
    got, mean, var = port.train_forward(_t(x.transpose(0, 3, 1, 2)))
    port.update_running(mean, var)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-7)


# ---- optimizer -----------------------------------------------------------

def _jax_tx(tcfg):
    from tpu_pillars.train.state import TrainConfig, make_optimizer

    return make_optimizer(TrainConfig(**{
        k: getattr(tcfg, k) for k in ("learning_rate", "weight_decay",
                                      "grad_clip_norm", "total_steps",
                                      "warmup_frac")}))


@pytest.mark.parametrize("total_steps", [1, 3, 10, 10000])
def test_schedule_matches_optax(total_steps):
    tcfg = tstate.TrainConfig(learning_rate=1e-3, total_steps=total_steps)
    warmup = max(1, int(round(total_steps * tcfg.warmup_frac)))
    schedule = optax.join_schedules(
        [optax.linear_schedule(1e-3 / 25.0, 1e-3, warmup),
         optax.cosine_decay_schedule(1e-3, max(1, total_steps - warmup),
                                     alpha=1e-4)], boundaries=[warmup])
    counts = sorted({0, 1, 2, warmup - 1, warmup, warmup + 1,
                     total_steps // 2, total_steps - 1, total_steps,
                     total_steps + 5} - {-1})
    for c in counts:
        want = float(schedule(jnp.asarray(c, jnp.int32)))
        np.testing.assert_allclose(tstate.learning_rate(tcfg, c), want,
                                   rtol=1e-6, err_msg=f"count {c}")


@pytest.mark.parametrize("grad_scale", [0.01, 30.0])   # below / above clip
def test_adamw_steps_match_optax(grad_scale):
    rng = np.random.default_rng(8)
    tcfg = tstate.TrainConfig(learning_rate=1e-3, total_steps=3)
    shapes = [(5, 4), (7,), (3, 2, 2)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(0, 1, s) * grad_scale).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = _jax_tx(tcfg)
    jp = {f"p{i}": jnp.asarray(p) for i, p in enumerate(params)}
    opt = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p.copy())) for p in params]
    adamw = tstate.AdamW(tp, tcfg)
    for g in grads:
        upd, opt = tx.update({f"p{i}": jnp.asarray(x) for i, x in
                              enumerate(g)}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        norm = adamw.step([_t(x) for x in g])
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[f"p{i}"]), rtol=1e-6,
                                       atol=1e-9)
    assert (float(norm) > tcfg.grad_clip_norm) == (grad_scale > 1.0)


# ---- whole steps ---------------------------------------------------------

def _scenes_batch(seed, batch, max_gt=16, cfg=TCFG):
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, cfg, num_objects=6, points_per_object=60,
                         clutter=400) for _ in range(batch)]
    return scenes_to_train_batch(scenes, cfg, max_gt)


def _port_state(variables, tcfg):
    return tstate.create_train_state(
        TCFG, tcfg, device="cpu",
        state_dict=weights.params_from_flax(variables, TCFG))


def _port_tree(state):
    v = weights.flax_from_params(state.model.state_dict(), TCFG)
    return v["params"], v["batch_stats"]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_remat_modes_bit_equal():
    arrays = _scenes_batch(11, 2)
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    variables = random_variables(CFG, seed=3)
    outs = []
    for remat in (False, True, "pfn", "rpn"):
        st = _port_state(variables, tcfg)
        step = make_train_step(TCFG, remat=remat)
        ls = []
        for _ in range(2):
            st, losses = step(st, batch_to_device(arrays, "cpu"))
            ls.append([float(x) for x in losses])
        outs.append((ls, _port_tree(st)))
    (l0, (p0, s0)) = outs[0]
    for ls, (p, s) in outs[1:]:
        assert ls == l0
        for a, b in zip(_leaves(p0) + _leaves(s0), _leaves(p) + _leaves(s)):
            np.testing.assert_array_equal(a, b)


def _jax_state(variables, accum=1):
    from tpu_pillars.train import TrainConfig, create_train_state

    tcfg = TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    st = create_train_state(CFG, tcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    return st.replace(params=params, batch_stats=stats,
                      opt_state=st.tx.init(params))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    from tpu_pillars.train import TrainBatch, make_train_step as jax_step

    arrays = _scenes_batch(12, 2)
    variables = random_variables(CFG, seed=4)
    jst = _jax_state(variables)
    jstep = jax.jit(jax_step(CFG, fused_frontend=True, accum_steps=accum))
    jbatch = TrainBatch(*(jnp.asarray(x) for x in arrays))
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    st = _port_state(variables, tcfg)
    step = make_train_step(TCFG, accum_steps=accum)
    n_steps = 3 if accum == 1 else 2
    for i in range(n_steps):
        jst, jl = jstep(jst, jbatch)
        st, tl = step(st, batch_to_device(arrays, "cpu"))
        np.testing.assert_allclose(float(tl.total), float(jl.total),
                                   rtol=2e-3, err_msg=f"step {i}")
        assert int(tl.num_pos) == int(jl.num_pos) > 0
    params, stats = _port_tree(st)
    assert jax.tree.structure(params) == jax.tree.structure(jst.params)
    for a, b in zip(_leaves(params), _leaves(jst.params)):
        np.testing.assert_allclose(a, b, atol=5e-4)
    assert not np.allclose(stats["pfn"]["bn"]["mean"],
                           variables["batch_stats"]["pfn"]["bn"]["mean"])
    for a, b in zip(_leaves(stats), _leaves(jst.batch_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-4)
    assert st.step == st.optimizer.count == n_steps


def test_padded_zero_gt_loss_is_finite():
    pts, npts, gb, gc, gv = _scenes_batch(13, 2)
    gv[:, 2:] = False
    gb[:, 2:] = 0.0
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    st = _port_state(random_variables(CFG, seed=5), tcfg)
    _, losses = make_train_step(TCFG)(st, batch_to_device(
        (pts, npts, gb, gc, gv), "cpu"))
    assert all(np.isfinite(float(x)) for x in losses)
    for p in st.model.parameters():
        assert torch.isfinite(p).all()


def test_train_entry_points_need_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tstate.TrainConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.create_train_state(TCFG, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.main(["--steps", "1", "--out", "unused"])
    assert tstate.create_train_state(TCFG, tcfg, device="cpu").step == 0


def test_loop_main_on_cpu_logs_and_writes_checkpoint(tmp_path):
    """``main`` logs every 10 steps and after the last, as the JAX ``main``
    (``fit``'s default ``log_every``)."""
    out = str(tmp_path / "run")
    loop.main(["--steps", "11", "--batch", "2", "--device", "cpu",
               "--out", out])
    lines = [json.loads(x) for x in open(os.path.join(out, "train.jsonl"))]
    steps = [x for x in lines if x["event"] == "train_step"]
    assert [x["step"] for x in steps] == [10, 11]
    assert all(np.isfinite(x["loss"]) for x in steps)
    tree = weights.load_flax_msgpack(os.path.join(out, "ckpt.msgpack"))
    assert int(tree["step"]) == 11


def test_loop_main_prefetch_trains_on_the_same_batches(tmp_path):
    """The default input pipeline (``--prefetch 2``: batches built and moved
    to the device in a background thread) logs the synchronous run's
    losses and writes its weights, bit for bit."""
    def run(out, extra):
        loop.main(["--steps", "2", "--batch", "2", "--device", "cpu",
                   "--out", out] + extra)
        logged = [(x["step"], x["loss"], x["cls"], x["loc"], x["dir"])
                  for x in map(json.loads,
                               open(os.path.join(out, "train.jsonl")))
                  if x["event"] == "train_step"]
        tree = weights.load_flax_msgpack(os.path.join(out, "ckpt.msgpack"))
        return logged, jax.tree_util.tree_leaves(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]})

    (sync_log, sync_w), (ahead_log, ahead_w) = (
        run(str(tmp_path / "sync"), ["--prefetch", "0"]),
        run(str(tmp_path / "ahead"), []))
    assert sync_log == ahead_log and [s for s, *_ in sync_log] == [2]
    assert len(sync_w) == len(ahead_w) > 0
    assert all(np.array_equal(a, b) for a, b in zip(sync_w, ahead_w))


def test_synthetic_scenes_match_jax():
    a = make_scene(np.random.default_rng(21), TCFG)
    b = jax_make_scene(np.random.default_rng(21), CFG)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.gt_boxes, b.gt_boxes)
    np.testing.assert_array_equal(a.gt_classes, b.gt_classes)


# ---- checkpoint ----------------------------------------------------------

def test_export_round_trip_serves_in_both_packages(tmp_path):
    from tpu_pillars.detector import Detector as JaxDetector
    from tpu_pillars.train.checkpoint import config_fingerprint
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.train.checkpoint import export_inference_checkpoint

    variables = random_variables(CFG, seed=6)
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    st = _port_state(variables, tcfg)
    st.step = 7
    path = str(tmp_path / "ckpt.msgpack")
    export_inference_checkpoint(path, st, TCFG)

    with open(path, "rb") as f:
        data = f.read()
    raw = serialization.msgpack_restore(data)
    assert list(raw) == ["step", "params", "batch_stats", "config_fp"]
    assert int(raw["step"]) == 7
    np.testing.assert_array_equal(raw["config_fp"], config_fingerprint(CFG))
    assert jax.tree.structure(raw["params"]) == \
        jax.tree.structure(variables["params"])
    for a, b in zip(_leaves(raw["params"]) + _leaves(raw["batch_stats"]),
                    _leaves(variables["params"])
                    + _leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(a, b)
    # byte for byte what flax writes for the same tree
    payload = {"step": np.asarray(7, np.int32),
               "params": weights.flax_from_params(st.model.state_dict(),
                                                  TCFG)["params"],
               "batch_stats": weights.flax_from_params(
                   st.model.state_dict(), TCFG)["batch_stats"],
               "config_fp": config_fingerprint(CFG)}
    assert serialization.to_bytes(payload) == data

    jdet = JaxDetector.from_checkpoint(CFG, path)
    tdet = Detector.from_checkpoint(TCFG, path, device="cpu")
    cloud = jax_make_scene(np.random.default_rng(9), CFG, num_objects=6,
                           clutter=1000).points
    want = np.asarray(jdet.predict_packed(cloud))
    got = tdet.predict_packed(cloud).numpy()
    np.testing.assert_array_equal(got[:, 9], want[:, 9])
    n = int(want[:, 9].sum())
    assert n > 0
    np.testing.assert_array_equal(got[:n, 8], want[:n, 8])
    np.testing.assert_allclose(got[:n, 7], want[:n, 7], atol=1e-4)
    np.testing.assert_allclose(got[:n, :6], want[:n, :6], atol=5e-3)


def test_msgpack_writer_forms():
    tree = {"a": np.arange(3, dtype=np.int32), "bb": {"c": np.zeros((2, 2),
                                                                 np.float32)},
            "n": [1, -3, 200, 70000, -200, "x" * 40, b"\x00" * 300],
            "big": np.ones(20000, np.float32)}
    data = weights.flax_msgpack_bytes(tree)
    assert data == serialization.msgpack_serialize(tree, in_place=True)
    back = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(back["big"], tree["big"])


def test_train_golden_file_layout():
    """tests/data/torch_train_golden_synth4k.npz (written by
    scripts/make_torch_train_golden.py, checked on the card by
    chip_smoke.py): every BatchNorm of the full config, three finite steps,
    and JAX targets whose positives match the number of positives."""
    g = np.load(TRAIN_GOLDEN)
    cfg = tconfig.PillarsConfig()
    from tpu_pillars_torch.models.pointpillars import PointPillars

    n_bn = sum(1 for k in PointPillars(cfg).state_dict()
               if k.endswith("running_mean"))
    assert len([k for k in g.files if k.startswith("stats/")]) == 2 * n_bn
    losses = g["losses"]
    assert losses.shape == (3, 5) and np.isfinite(losses).all()
    B = g["gt_boxes"].shape[0]
    pos = np.unpackbits(g["pos_bits"])[:B * cfg.num_anchors]
    weight = np.unpackbits(g["weight_bits"])[:B * cfg.num_anchors]
    n_pos = int(pos.sum())
    assert n_pos == int(losses[0, 4]) > 0
    assert (weight >= pos).all() and weight.sum() > n_pos
    assert g["reg_pos"].shape == (n_pos, 7) and g["dir_pos"].shape == (n_pos,)
    assert np.isfinite(g["reg_pos"]).all()
    assert len(g["offsets"]) == B + 1
