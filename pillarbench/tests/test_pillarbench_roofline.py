"""The yardstick's arithmetic against hand counts and against torch's own
FLOP counter at small shapes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pillarbench.reference.config import RefConfig
from pillarbench.reference.detect import rpn_features
from pillarbench.reference.train import head_fm, pillarize
from pillarbench.roofline import kernels as K
from pillarbench.roofline import model_flops, peaks
from pillarbench.roofline.counts import cloud_counts
from pillarbench.tests.test_pillarbench_reference import fields
from pillarbench import weights as W


def test_rpn_and_head_flops_match_torch_counter():
    f = fields()
    cfg = RefConfig(f)
    w = W.seeded_state(W.state_shapes(cfg), 0, torch.device("cpu"))
    w = {k: v for k, v in w.items()}
    conv = {}
    for i, n in enumerate(cfg.rpn_layers):
        for j in range(n):
            conv[f"conv{i}.{j}"] = w[f"rpn.blocks.{i}.convs.{j}"]
            conv[f"bn{i}.{j}"] = tuple(w[f"rpn.blocks.{i}.bns.{j}.{s}"] for s
                                       in ("weight", "bias", "running_mean",
                                           "running_var"))
        conv[f"up{i}"] = w[f"rpn.ups.{i}.weight"]
        conv[f"upbn{i}"] = tuple(w[f"rpn.ups.{i}.bn.{s}"] for s in
                                 ("weight", "bias", "running_mean",
                                  "running_var"))
    canvas = torch.zeros(1, cfg.pfn_channels, cfg.grid_h, cfg.grid_w)
    with FlopCounterMode(display=False) as fc:
        feat = rpn_features(conv, canvas, cfg)
    assert fc.get_total_flops() == model_flops.rpn_flops(f)
    with FlopCounterMode(display=False) as fc:
        head_fm(w, feat, cfg)
    assert fc.get_total_flops() == model_flops.head_flops(
        f, own_class_only=False)


def test_pfn_flops_and_counts_by_hand():
    f = fields()
    cfg = RefConfig(f)
    # two points in one pillar, one in another, one out of range
    pts = np.array([[0.1, 0.1, 0.0, 1.0], [0.2, 0.2, 0.0, 1.0],
                    [5.1, 5.1, 0.0, 1.0], [99.0, 0.0, 0.0, 1.0]],
                   np.float32)
    assert cloud_counts(pts, cfg) == (3, 2, 3)
    feats, mask, _, pmask = pillarize(pts, cfg)
    assert int(mask.sum()) == 3 and int(pmask.sum()) == 2
    assert model_flops.pfn_flops(f, 3) == 2 * 3 * 9 * cfg.pfn_channels


def test_full_size_model_flops():
    from pillarbench.cells import Cell

    f = Cell("offline.full").config["config"]
    # 4 + 5 + 5 convs at 200^2 x 64, 100^2 x 128, 50^2 x 256 (each
    # 2.949 GFLOP but the three stride-2 ones, 1.475)
    assert model_flops.rpn_flops(f) == pytest.approx(
        3 * 2.949e9 + 2.949e9 + 2 * (1.475e9 + 5 * 2.949e9)
        + 0.655e9 + 1.311e9 + 2.621e9, rel=1e-3)
    assert model_flops.head_flops(f, True) == pytest.approx(5.53e9, rel=1e-3)


def test_kernel_bytes_by_hand():
    f = fields()       # tiny: F 4, P 512, N 16, C 32, 80 x 80 grid
    b = 2
    assert K.k1(f, b, 100) == (100 * 20 + 2 * 512 * 16 * 4 * 4
                               + 2 * 8 * 512 * 4, 0.0)
    nb, ops = K.k2(f, b, 60)
    assert nb == 60 * 16 + 5 * 2 * 512 * 4 + 2 * 512 * 32 * 4 + 2 * 2 * 512 * 4
    assert ops == 60 * 32 * 2 * 4 + 2 * 512 * 32 * 14
    assert K.k3(f, b, 40) == (40 * 32 * 4 + 2 * 512 * 5
                              + 2 * 80 * 80 * 32 * 4, 0.0)
    k = f["pre_nms_top_k"]
    assert K.k4(f, b) == (b * k * 7 * 4 + b * k * k,
                          b * k * (k - 1) / 2 * 8)
    assert K.kernel_of("void emit_rows_kernel<4>(int const*)") == "K1"
    assert K.kernel_of("cudnn::conv") is None
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12) == pytest.approx(1.0)
