"""The classic (un-fused) front end of tpu_pillars_torch vs the JAX package
on the CPU:

* the K6 PFN's plain version against the JAX ``pfn_fused`` kernel
  (interpret mode), at tests/test_pfn_pallas.py's atol 2e-5, with a pillar
  count that no block size divides and empty pillars;
* the plain PillarFeatureNet (``models.pfn.PillarFeatureNet.forward``)
  against the flax ``PillarFeatureNet`` (atol 2e-5);
* ``pillarize_batch_emit`` (K1 on raw points + ``decorate``) against the JAX
  ``pillarize_batch`` and the port's own ``pillarize_batch``, bit for bit;
* the classic ``Detector`` against the JAX ``Detector(fused_frontend=
  False)`` on the same weights, at the tolerance of
  tests/test_detector_e2e.py::test_jitted_pipeline_matches_cpu_reference;
* the classic port on the trained checkpoint at the full config against
  the JAX golden detections, which the JAX classic front end wrote
  (scripts/make_torch_golden.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pillars.config import tiny_config
from tpu_pillars.data.synthetic import make_scene
from tpu_pillars.detector import Detector as JaxDetector
from tpu_pillars.models.pfn import PillarFeatureNet
from tpu_pillars.ops import voxelize as jvox
from tpu_pillars.ops.pfn_pallas import fold_bn as jfold_bn
from tpu_pillars.ops.pfn_pallas import pfn_fused as jpfn_fused
from torch_port_util import (
    assert_packed_close, cloud_batch, dense_cell_batch, random_variables,
)
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import detector as tdet
from tpu_pillars_torch.models import pfn as tpfn
from tpu_pillars_torch.ops import emit as temit
from tpu_pillars_torch.ops import voxelize as tvox
from tpu_pillars_torch.ops.fused_pfn import fold_bn
from tpu_pillars_torch.ops.pfn import pfn_fused, pfn_fused_plain
from tpu_pillars_torch.weights import params_from_flax

CFG = tiny_config()
TCFG = tconfig.tiny_config()
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_synth4k.npz")
ARTIFACT = os.path.join(ROOT, "artifacts", "pointpillars_synth4k.msgpack")


def _pfn_inputs(rng, P=300, N=16, D=9, C=32):
    """tests/test_pfn_pallas.py's inputs: ~70% valid slots, pillars 5 and
    17 empty, and an unfolded linear + BatchNorm."""
    feats = rng.normal(0, 1, (P, N, D)).astype(np.float32)
    mask = rng.uniform(size=(P, N)) < 0.7
    mask[:, 0] = True
    mask[5] = False
    mask[17] = False
    feats = feats * mask[..., None]
    bn = (rng.normal(0, 0.5, (D, C)).astype(np.float32),             # W
          rng.normal(1, 0.2, (C,)).astype(np.float32),               # scale
          rng.normal(0, 0.2, (C,)).astype(np.float32),               # bias
          rng.normal(0, 0.2, (C,)).astype(np.float32),               # mean
          (np.abs(rng.normal(1, 0.2, (C,))) + 0.1).astype(np.float32))
    return feats, mask, bn


@pytest.mark.parametrize("block", [128, 64])
def test_pfn_plain_matches_jax_kernel(rng, block):
    """P = 300 is no multiple of either block: the JAX kernel pads."""
    feats, mask, bn = _pfn_inputs(rng)
    jw, jb = jfold_bn(*(jnp.asarray(x) for x in bn))
    want = np.asarray(jpfn_fused(jnp.asarray(feats), jnp.asarray(mask), jw,
                                 jb, block=block, interpret=True))
    w, b = fold_bn(*(torch.from_numpy(x) for x in bn))
    args = (torch.from_numpy(feats), torch.from_numpy(mask), w, b)
    got = pfn_fused_plain(*args).numpy()
    assert got.shape == (300, 32)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(got[[5, 17]], 0.0)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(pfn_fused(*args).numpy(), got)


def test_pfn_module_matches_flax(rng):
    feats, mask, (w, scale, bias, mean, var) = _pfn_inputs(rng, C=64)
    variables = {"params": {"linear": {"kernel": w},
                            "bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    batched = (feats.reshape(3, 100, 16, 9), mask.reshape(3, 100, 16))
    want = PillarFeatureNet(channels=64, use_running_average=True).apply(
        variables, *(jnp.asarray(x) for x in batched))
    module = tpfn.PillarFeatureNet(9, 64)
    module.load_state_dict({
        "kernel": torch.from_numpy(w), "bn.weight": torch.from_numpy(scale),
        "bn.bias": torch.from_numpy(bias),
        "bn.running_mean": torch.from_numpy(mean),
        "bn.running_var": torch.from_numpy(var)})
    with torch.no_grad():
        got = module(*(torch.from_numpy(x) for x in batched)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    # the folded kernel path computes the same features
    fw, fb = module.folded()
    folded = pfn_fused_plain(torch.from_numpy(feats), torch.from_numpy(mask),
                             fw, fb).numpy()
    np.testing.assert_allclose(folded, got.reshape(300, 64), atol=2e-5)


CASES = {
    "random": lambda rng: cloud_batch(rng, [3000, 4096, 1, 0], CFG),
    "one_cell": lambda rng: dense_cell_batch(rng, CFG),
    "budget": lambda rng: cloud_batch(rng, [4096, 4096], CFG),
    "empty": lambda rng: cloud_batch(rng, [0, 0], CFG),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pillarize_batch_emit_bit_equal(rng, case):
    kw = {"max_pillars": 64} if case == "budget" else {}
    jcfg, tcfg = tiny_config(**kw), tconfig.tiny_config(**kw)
    pts, ns = CASES[case](rng)
    got = temit.pillarize_batch_emit(torch.from_numpy(pts),
                                     torch.from_numpy(ns), tcfg)
    want = jvox.pillarize_batch(jnp.asarray(pts), jnp.asarray(ns), jcfg)
    own = tvox.pillarize_batch(torch.from_numpy(pts), torch.from_numpy(ns),
                               tcfg)
    for name in ("features", "mask", "coords", "pillar_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    if case == "budget":
        assert got.pillar_mask.all()


@pytest.mark.parametrize("use_pallas_pfn", [True, False])
def test_classic_detector_matches_jax(rng, use_pallas_pfn):
    variables = random_variables(CFG, seed=5)
    kw = dict(fused_frontend=False, use_pallas_pfn=use_pallas_pfn)
    jdet = JaxDetector(CFG, variables, nms_impl="pallas", **kw)
    port = tdet.Detector(TCFG, params_from_flax(variables, TCFG),
                         device="cpu", **kw)
    assert not port.fused_frontend
    clouds = [make_scene(rng, CFG, num_objects=6, clutter=1000).points
              for _ in range(2)]
    padded = [port.pad_points(c) for c in clouds]
    pts = np.stack([p for p, _ in padded])
    ns = np.asarray([n for _, n in padded], np.int32)
    want = np.asarray(jdet.predict_packed_batch(jnp.asarray(pts),
                                                jnp.asarray(ns)))
    got = port.predict_packed_batch(pts, ns).numpy()
    assert got.shape == want.shape == (2, CFG.max_detections, 10)
    total = sum(assert_packed_close(got[b], want[b], 1e-4, 5e-3)
                for b in range(2))
    assert total > 0
    # the stage functions compose to the same detections
    forward = tdet.build_forward_fn(port.model, TCFG, **kw)
    det = forward(torch.from_numpy(pts), torch.from_numpy(ns).long())
    np.testing.assert_array_equal(tdet.pack_detections(det).numpy(), got)


def test_fused_switch_needs_power_of_two():
    """As the JAX package: fused only when asked for and when N is a power
    of two; otherwise the classic front end serves."""
    assert tdet.use_fused_frontend(TCFG, True, True)
    assert tdet.use_fused_frontend(TCFG, False, True)
    assert not tdet.use_fused_frontend(TCFG, True, False)
    odd = tconfig.tiny_config(max_points_per_pillar=12)
    assert not tdet.use_fused_frontend(odd, True, True)
    assert not tdet.use_fused_frontend(odd, True, None)
    sd = params_from_flax(random_variables(tiny_config(), seed=5), TCFG)
    assert tdet.Detector(TCFG, sd, device="cpu").fused_frontend
    port = tdet.Detector(odd, sd, device="cpu")     # N does not size a weight
    assert not port.fused_frontend
    pts, ns = cloud_batch(np.random.default_rng(1), [2000], odd)
    canvas = port.canvas(torch.from_numpy(pts), torch.from_numpy(ns))
    assert canvas.shape == (1, odd.grid_h, odd.grid_w, odd.pfn_channels)
    assert torch.isfinite(canvas).all() and canvas.abs().sum() > 0


def test_golden_trained_checkpoint_classic_cpu():
    """The classic port on the trained artifact at the full config
    reproduces the JAX package's detections (which the JAX classic front
    end wrote), at the trained-weights tolerance of
    tests/test_detector_e2e.py."""
    golden = np.load(GOLDEN)
    cfg = tconfig.PillarsConfig()
    port = tdet.Detector.from_checkpoint(cfg, ARTIFACT, device="cpu",
                                         fused_frontend=False)
    offs = golden["offsets"]
    for s in (0, 1):
        got = port.predict_packed(golden["points"][offs[s]:offs[s + 1]])
        n = assert_packed_close(got.numpy(), golden["packed"][s], 1e-3,
                                 1e-2)
        assert n > 0


def test_fused_switch_default_follows_use_pallas_pfn():
    """``fused_frontend=None`` (the default) resolves as the JAX
    ``_use_fused_frontend`` does on its accelerator: fused exactly when
    ``use_pallas_pfn``, so ``use_pallas_pfn=False`` serves the classic
    front end with the plain PillarFeatureNet."""
    assert tdet.use_fused_frontend(TCFG, True, None)
    assert not tdet.use_fused_frontend(TCFG, False, None)
    sd = params_from_flax(random_variables(tiny_config(), seed=5), TCFG)
    plain = tdet.Detector(TCFG, sd, device="cpu", use_pallas_pfn=False)
    assert plain.fused_frontend is False
    forced = tdet.Detector(TCFG, sd, device="cpu", use_pallas_pfn=False,
                           fused_frontend=False)
    pts, ns = cloud_batch(np.random.default_rng(2), [2000, 1500], TCFG)
    pts, ns = torch.from_numpy(pts), torch.from_numpy(ns)
    assert torch.equal(plain.canvas(pts, ns), forced.canvas(pts, ns))
