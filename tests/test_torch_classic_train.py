"""Classic training and the dense assigners of tpu_pillars_torch against the
JAX package on the CPU, at ``tiny_config()``:

* ``rotated_iou_bev_colchunked`` against the JAX function (atol 1e-6,
  tests/test_iou.py's chunked-vs-dense tolerance), with leading dims and a
  short last chunk;
* ``make_classwise_assigner`` against the JAX one (vmapped), on the scene
  families of tests/test_torch_assign.py under its ``_compare`` contract,
  at the default ``iou_chunk`` and at one that leaves a short last chunk;
  its targets bit-equal for every chunk; all-invalid GT give equal
  targets exactly, zero-padded GT finite ones;
* the training ``PillarFeatureNet`` (``models.pfn``): features, batch
  moments, the running-statistics update and the gradients of the kernel,
  scale and bias against flax ``apply(mutable=["batch_stats"])`` and
  ``jax.grad``, in f32 (atol 2e-5 features, rtol 1e-4 moments, rtol 1e-4
  / atol 1e-6 gradients over the largest gradient) and bf16 (features and
  gradients within one bf16 ulp of their largest value, moments rtol
  1e-3); a case whose masked max ties in every channel included, and the
  even split of the max's gradient among ties (JAX's rule);
* three classic steps (``make_train_step(fused_frontend=False,
  assigner="dense")``) against ``jax.jit(make_train_step(CFG,
  fused_frontend=False))``: loss rtol 2e-3 a step, ``num_pos`` equal,
  parameters atol 5e-4, running statistics rtol 1e-2 / atol 1e-4 (the
  fused step's tolerances, tests/test_torch_train.py); with
  ``accum_steps`` 2; in bf16 at rtol 2e-2; every remat mode bit-equal
  within the port; the assigner names;
* ``main --no-fused-frontend --device cpu`` trains, and the JAX
  ``restore_checkpoint`` reads its checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_assign import SCENES, _batch2, _compare
from tpu_pillars.config import tiny_config
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import weights
from tpu_pillars_torch.data.synthetic import make_scene, scenes_to_train_batch
from tpu_pillars_torch.models import pfn as tpfn
from tpu_pillars_torch.ops import iou as tiou
from tpu_pillars_torch.ops import target_assigner as tta
from tpu_pillars_torch.train import loop
from tpu_pillars_torch.train import state as tstate
from tpu_pillars_torch.train.step import (
    batch_to_device, make_assigner, make_train_step,
)

CFG, TCFG = tiny_config(), tconfig.tiny_config()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boxes(rng, shape):
    n = int(np.prod(shape))
    b = np.c_[rng.uniform(-6.0, 6.0, (n, 2)), rng.normal(0, 1, (n, 1)),
              rng.uniform(0.5, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi,
                                                          (n, 1))]
    return b.astype(np.float32).reshape(tuple(shape) + (7,))


# ---- the IoU entry point --------------------------------------------------

def test_iou_colchunked_matches_jax():
    from tpu_pillars.ops.iou import rotated_iou_bev_colchunked as jax_col

    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, (5,)), _boxes(rng, (301,))
    want = np.asarray(jax_col(jnp.asarray(b1), jnp.asarray(b2), chunk=64))
    assert (want > 0).sum() > 20
    for chunk in (64, 1000):
        got = tiou.rotated_iou_bev_colchunked(_t(b1), _t(b2), chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # leading dims broadcast: (2, 3, 5) boxes against (3, 301) boxes
    lead1, lead2 = _boxes(rng, (2, 3, 5)), _boxes(rng, (3, 301))
    got = tiou.rotated_iou_bev_colchunked(_t(lead1), _t(lead2)[None],
                                          chunk=100)
    assert tuple(got.shape) == (2, 3, 5, 301)
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(
                got[i, j].numpy(),
                np.asarray(jax_col(jnp.asarray(lead1[i, j]),
                                   jnp.asarray(lead2[j]))),
                rtol=0, atol=1e-6)


# ---- the dense assigner --------------------------------------------------

def _numpy_targets(t):
    return type(t)(*(np.asarray(x) for x in t))


@pytest.fixture(scope="module")
def jax_classwise():
    """The JAX class-blocked dense assigner, vmapped and jitted once for
    the module."""
    from tpu_pillars.ops.target_assigner import make_classwise_assigner

    return jax.jit(jax.vmap(make_classwise_assigner(CFG)))


def _both(jax_classwise, gt, cls, valid, iou_chunk=16384):
    got = tta.make_classwise_assigner(TCFG, iou_chunk=iou_chunk)(
        _t(gt), _t(cls.astype(np.int64)), _t(valid))
    n = gt.shape[0]
    want = jax_classwise(*(jnp.asarray(x) for x in _batch2(gt, cls, valid)))
    return (_numpy_targets(got),
            type(want)(*(np.asarray(x)[:n] for x in want)))


@pytest.mark.parametrize("scene", ["random", "crowded_edges", "duplicates"])
@pytest.mark.parametrize("iou_chunk", [16384, 97])
def test_dense_assigners_match_jax(jax_classwise, scene, iou_chunk):
    make, max_flip = SCENES[scene]
    got, want = _both(jax_classwise, *make(), iou_chunk=iou_chunk)
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype or name == "num_pos", name
    _compare(got, want, max_flip)
    if scene == "random":
        assert float(want.num_pos.sum()) > 0


def test_dense_assigner_targets_do_not_depend_on_the_chunk():
    make, _ = SCENES["crowded_edges"]
    gt, cls, valid = make()
    args = (_t(gt), _t(cls.astype(np.int64)), _t(valid))
    ref = tta.make_classwise_assigner(TCFG)(*args)
    for chunk in (1, 97, 1000):
        got = tta.make_classwise_assigner(TCFG, iou_chunk=chunk)(*args)
        for name, a, b in zip(ref._fields, ref, got):
            torch.testing.assert_close(b, a, rtol=0, atol=0,
                                       msg=f"{chunk} {name}")


def test_dense_assigners_all_invalid_equal_and_padding_finite(
        jax_classwise):
    gt = np.zeros((2, 8, 7), np.float32)
    cls = np.zeros((2, 8), np.int32)
    valid = np.zeros((2, 8), bool)
    got, want = _both(jax_classwise, gt, cls, valid)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert float(got.num_pos.sum()) == 0.0
    make, _ = SCENES["random"]
    gt, cls, valid = make()
    gt[:, 5:] = 0.0                       # zero-size padded slots
    valid[:, 5:] = False
    got = tta.make_classwise_assigner(TCFG)(_t(gt), _t(cls.astype(np.int64)),
                                            _t(valid))
    for name, x in zip(got._fields, got):
        assert torch.isfinite(x.float()).all(), name


def test_make_assigner_names():
    assert "windowed" in make_assigner(TCFG, "windowed").__qualname__
    assert "classwise" in make_assigner(TCFG, "dense").__qualname__
    assert "classwise" in make_assigner(TCFG, "banded").__qualname__
    fixed = lambda *gt: None  # noqa: E731
    assert make_assigner(TCFG, fixed) is fixed
    for name in ("auto", "fastest"):
        with pytest.raises(ValueError, match="assigner"):
            make_assigner(TCFG, name)


# ---- the training PillarFeatureNet --------------------------------------

def _pfn_case(rng, ties):
    """(2, 40, 8, 9) features, mask with empty pillars and partly filled
    ones; ``ties`` repeats each pillar's first slot in its others, so the
    masked max ties in every channel."""
    B, P, N, D = 2, 40, 8, CFG.num_decorated_features
    feats = rng.normal(0, 1, (B, P, N, D)).astype(np.float32)
    n = rng.integers(0, N + 1, (B, P))
    mask = np.arange(N)[None, None, :] < n[..., None]
    if ties:
        feats[:] = feats[:, :, :1]
    feats *= mask[..., None]
    return feats, mask


def _flax_pfn(dtype):
    from tpu_pillars.models.pfn import PillarFeatureNet

    return PillarFeatureNet(channels=CFG.pfn_channels,
                            use_running_average=False, dtype=dtype)


def _pfn_params(rng):
    D, C = CFG.num_decorated_features, CFG.pfn_channels
    return {"kernel": rng.normal(0, 0.5, (D, C)).astype(np.float32),
            "scale": rng.normal(1, 0.1, C).astype(np.float32),
            "bias": rng.normal(0, 0.1, C).astype(np.float32),
            "mean": rng.normal(0, 0.1, C).astype(np.float32),
            "var": (np.abs(rng.normal(1, 0.1, C)) + 0.1).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
def test_train_pfn_matches_flax(dtype, ties):
    rng = np.random.default_rng(7 + ties)
    feats, mask = _pfn_case(rng, ties)
    p = _pfn_params(rng)
    jdt = jnp.dtype(dtype)
    variables = {"params": {"linear": {"kernel": jnp.asarray(p["kernel"])},
                            "bn": {"scale": jnp.asarray(p["scale"]),
                                   "bias": jnp.asarray(p["bias"])}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(p["mean"]),
                                        "var": jnp.asarray(p["var"])}}}
    cot = rng.normal(0, 1, feats.shape[:2] + (CFG.pfn_channels,)
                     ).astype(np.float32)
    module = _flax_pfn(jdt)

    def loss(params):
        out, mut = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(feats), jnp.asarray(mask),
                                mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])

    net = tpfn.PillarFeatureNet(CFG.num_decorated_features, CFG.pfn_channels)
    with torch.no_grad():
        net.kernel.copy_(_t(p["kernel"]))
        net.bn.weight.copy_(_t(p["scale"]))
        net.bn.bias.copy_(_t(p["bias"]))
        net.bn.running_mean.copy_(_t(p["mean"]))
        net.bn.running_var.copy_(_t(p["var"]))
    tdt = getattr(torch, dtype)
    out, mean, var = net.train_forward(_t(feats), _t(mask), tdt)
    (out.float() * _t(cot)).sum().backward()
    net.bn.update_running(mean.detach(), var.detach())

    assert out.dtype == tdt and mean.dtype == var.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5)
        mom_rtol, g_tol = 1e-4, dict(rtol=1e-4, atol=1e-6)
    else:
        # one bf16 ulp of the value's size: the bf16 roundings of the
        # linear layer may differ by one step between the two packages
        np.testing.assert_allclose(out.detach().float().numpy(), want,
                                   rtol=2 ** -7, atol=2 ** -7)
        # the bf16 kernel gradient is rounded to bf16: one ulp of the
        # largest gradient
        mom_rtol, g_tol = 1e-3, dict(rtol=0, atol=2 ** -7)
    stats = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(net.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=mom_rtol,
                               atol=1e-6)
    np.testing.assert_allclose(net.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=mom_rtol,
                               atol=1e-6)
    scale = max(1.0, float(np.abs(np.asarray(grads["linear"]["kernel"])).max()))
    for got_g, want_g in ((net.kernel.grad, grads["linear"]["kernel"]),
                          (net.bn.weight.grad, grads["bn"]["scale"]),
                          (net.bn.bias.grad, grads["bn"]["bias"])):
        np.testing.assert_allclose(got_g.numpy() / scale,
                                   np.asarray(want_g) / scale, **g_tol)


def test_masked_max_splits_the_gradient_among_ties():
    """amax's rule, as JAX's max: equal maxima share the cotangent."""
    y = torch.tensor([[[[1.0], [2.0], [2.0], [0.0]]]], requires_grad=True)
    mask = torch.tensor([[[True, True, True, False]]])
    tpfn._masked_max(y, mask).sum().backward()
    assert y.grad.flatten().tolist() == [0.0, 0.5, 0.5, 0.0]


# ---- whole classic steps ---------------------------------------------------

def _scenes_batch(seed, batch=2, max_gt=16):
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, TCFG, num_objects=6, points_per_object=60,
                         clutter=400) for _ in range(batch)]
    return scenes_to_train_batch(scenes, TCFG, max_gt)


def _jax_state(variables):
    from tpu_pillars.train import TrainConfig, create_train_state

    st = create_train_state(CFG, TrainConfig(batch_size=2, max_gt_boxes=16,
                                             total_steps=10))
    params = jax.tree.map(jnp.asarray, variables["params"])
    return st.replace(params=params,
                      batch_stats=jax.tree.map(jnp.asarray,
                                               variables["batch_stats"]),
                      opt_state=st.tx.init(params))


def _port_state(variables):
    tcfg = tstate.TrainConfig(batch_size=2, max_gt_boxes=16, total_steps=10)
    return tstate.create_train_state(
        TCFG, tcfg, device="cpu",
        state_dict=weights.params_from_flax(variables, TCFG))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("dtype,accum", [("float32", 1), ("float32", 2),
                                         ("bfloat16", 1)])
def test_classic_steps_match_jax(dtype, accum):
    from tpu_pillars.train import TrainBatch, make_train_step as jax_step

    arrays = _scenes_batch(12)
    variables = random_variables(CFG, seed=4)
    jst = _jax_state(variables)
    jstep = jax.jit(jax_step(CFG, fused_frontend=False, accum_steps=accum,
                             compute_dtype=jnp.dtype(dtype)))
    jbatch = TrainBatch(*(jnp.asarray(x) for x in arrays))
    st = _port_state(variables)
    step = make_train_step(TCFG, fused_frontend=False, assigner="dense",
                           accum_steps=accum,
                           compute_dtype=getattr(torch, dtype))
    rtol = 2e-3 if dtype == "float32" else 2e-2
    for i in range(3):
        jst, jl = jstep(jst, jbatch)
        st, tl = step(st, batch_to_device(arrays, "cpu"))
        np.testing.assert_allclose(float(tl.total), float(jl.total),
                                   rtol=rtol, err_msg=f"step {i}")
        assert int(tl.num_pos) == int(jl.num_pos) > 0
    v = weights.flax_from_params(st.model.state_dict(), TCFG)
    if dtype == "float32":
        for a, b in zip(_leaves(v["params"]), _leaves(jst.params)):
            np.testing.assert_allclose(a, b, atol=5e-4)
    assert not np.allclose(v["batch_stats"]["pfn"]["bn"]["mean"],
                           variables["batch_stats"]["pfn"]["bn"]["mean"])
    for a, b in zip(_leaves(v["batch_stats"]), _leaves(jst.batch_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-4)
    assert all(t.dtype == torch.float32
               for t in st.model.state_dict().values())


def test_classic_remat_modes_bit_equal():
    arrays = _scenes_batch(11)
    variables = random_variables(CFG, seed=3)
    # fixed targets: the assigner is not what remat changes
    targets = make_assigner(TCFG, "dense")(
        *batch_to_device(arrays, "cpu")[2:])
    outs = []
    for remat in (False, True, "pfn", "rpn"):
        st = _port_state(variables)
        step = make_train_step(TCFG, remat=remat, fused_frontend=False,
                               assigner=lambda *gt: targets)
        ls = []
        for _ in range(2):
            st, losses = step(st, batch_to_device(arrays, "cpu"))
            ls.append([float(x) for x in losses])
        outs.append((ls, [t.clone() for t in st.model.state_dict().values()]))
    l0, s0 = outs[0]
    for ls, s in outs[1:]:
        assert ls == l0
        for a, b in zip(s0, s):
            assert torch.equal(a, b)


def test_classic_step_with_k5_targets_is_finite_and_learns():
    arrays = _scenes_batch(13)
    gt = batch_to_device(arrays, "cpu")
    st = _port_state(random_variables(CFG, seed=5))
    step = make_train_step(TCFG, fused_frontend=False)
    first = None
    for _ in range(4):
        st, losses = step(st, gt)
        assert all(np.isfinite(float(x)) for x in losses)
        first = first if first is not None else float(losses.total)
    assert float(losses.total) < first
    # padded zero GT give finite losses on the classic path too
    pts, npts, gb, gc, gv = _scenes_batch(14)
    gv[:, 2:] = False
    gb[:, 2:] = 0.0
    _, losses = make_train_step(TCFG, fused_frontend=False,
                                assigner="dense")(
        st, batch_to_device((pts, npts, gb, gc, gv), "cpu"))
    assert all(np.isfinite(float(x)) for x in losses)


def test_main_no_fused_frontend_trains_and_jax_reads_it(tmp_path):
    from tpu_pillars.train import TrainConfig, create_train_state
    from tpu_pillars.train.checkpoint import restore_checkpoint

    out = str(tmp_path / "run")
    loop.main(["--no-fused-frontend", "--steps", "2", "--batch", "2",
               "--device", "cpu", "--out", out, "--prefetch", "0"])
    lines = [json.loads(x) for x in open(os.path.join(out, "train.jsonl"))]
    assert [x["fused_frontend"] for x in lines if x["event"] == "start"] \
        == [False]
    steps = [x for x in lines if x["event"] == "train_step"]
    assert [x["step"] for x in steps] == [2]
    assert np.isfinite(steps[0]["loss"])
    path = os.path.join(out, "ckpt.msgpack")
    restored = restore_checkpoint(
        path, create_train_state(CFG, TrainConfig(batch_size=2)), config=CFG)
    assert int(restored.step) == 2
    tree = weights.load_flax_msgpack(path)
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(tree["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
