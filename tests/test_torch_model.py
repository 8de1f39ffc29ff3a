"""tpu_pillars_torch weights and dense model vs the JAX package on the CPU:
the stdlib msgpack reader against flax's (bit for bit, leaf for leaf), the
checkpoint fingerprint against the JAX one (byte for byte), and the RPN plus
serving wire head against ``features_from_canvas`` + ``_wire_head`` at the
JAX package's own tolerance (rtol 1e-5, atol 1e-4,
tests/test_detector_e2e.py::test_wire_head_matches_ssd_head)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tpu_pillars import config as jconfig
from tpu_pillars.detector import _wire_head
from tpu_pillars.models import PointPillars as JaxPointPillars
from tpu_pillars.ops.pfn_pallas import fold_bn as jax_fold_bn
from tpu_pillars.train.checkpoint import config_fingerprint as jax_fp
from torch_port_util import random_variables
from tpu_pillars_torch import config as tconfig
from tpu_pillars_torch import weights
from tpu_pillars_torch.models.pointpillars import PointPillars

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "pointpillars_synth4k.msgpack")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_load_flax_msgpack_matches_flax():
    with open(ARTIFACT, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = weights.load_flax_msgpack(ARTIFACT)
    want_l, got_l = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    assert len(got_l) > 50
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w)
        assert isinstance(g, np.ndarray), path
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("name", ["PillarsConfig", "tiny_config",
                                  "car_only_config", "multisweep_config"])
def test_config_fingerprint_matches_jax(name):
    jcfg, tcfg = getattr(jconfig, name)(), getattr(tconfig, name)()
    np.testing.assert_array_equal(weights.config_fingerprint(tcfg),
                                  jax_fp(jcfg))
    assert repr(tcfg) == repr(jcfg)


def test_checkpoint_fingerprint_guard():
    tree = weights.load_flax_msgpack(ARTIFACT)
    weights.check_fingerprint(tree, tconfig.PillarsConfig(), ARTIFACT)
    with pytest.raises(ValueError, match="different PillarsConfig"):
        weights.check_fingerprint(tree, tconfig.tiny_config(), ARTIFACT)


def _port_model(variables, tcfg):
    model = PointPillars(tcfg)
    model.load_state_dict(weights.params_from_flax(variables, tcfg))
    return model.eval()


def test_folded_pfn_matches_jax():
    cfg, tcfg = jconfig.tiny_config(), tconfig.tiny_config()
    v = random_variables(cfg, seed=3)
    p, bs = v["params"]["pfn"], v["batch_stats"]["pfn"]["bn"]
    jw, jb = jax_fold_bn(p["linear"]["kernel"], p["bn"]["scale"],
                         p["bn"]["bias"], bs["mean"], bs["var"])
    tw, tb = _port_model(v, tcfg).pfn.folded()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("batch", [1, 2])
def test_rpn_and_wire_head_match_jax(rng, batch):
    cfg, tcfg = jconfig.tiny_config(), tconfig.tiny_config()
    v = random_variables(cfg, seed=1)
    canvas = rng.normal(0, 1, (batch, cfg.grid_h, cfg.grid_w,
                               cfg.pfn_channels)).astype(np.float32)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    feat = JaxPointPillars(cfg).apply(
        jv, jnp.asarray(canvas), method=JaxPointPillars.features_from_canvas)
    want = _wire_head(cfg)(jv["params"]["head"], feat)

    model = _port_model(v, tcfg)
    with torch.no_grad():
        tfeat = model.features_from_canvas(torch.from_numpy(canvas))
        got = model.wire_head(tfeat)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(feat), rtol=1e-5,
                               atol=1e-4)
    for g, w, shape in zip(got, want, [(cfg.num_anchors,), (7, cfg.num_anchors),
                                       (2, cfg.num_anchors)]):
        assert tuple(g.shape) == (batch,) + shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_full_fp32_scopes_tf32_off():
    from tpu_pillars_torch.models.pointpillars import full_fp32

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        with full_fp32():
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
