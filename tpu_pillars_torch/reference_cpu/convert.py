"""Flax <-> reference-torch weight conversion — copy of
``tpu_pillars/reference_cpu/convert.py``, on numpy trees in the flax
variable layout ``{'params', 'batch_stats'}`` (what
``weights.load_flax_msgpack`` reads and ``weights.flax_from_params``
writes).

:func:`flax_to_torch` gives the state dict of
``reference_cpu.model.TorchPointPillars``; :func:`torch_to_flax` is its
exact inverse, the migration path of ``Detector.from_torch``: weights
trained in the reference's torch layout serve here unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def flax_to_torch(variables: dict, config: PillarsConfig) -> dict:
    """Build a TorchPointPillars state_dict from flax variables
    {'params': ..., 'batch_stats': ...}."""
    p = variables["params"]
    bs = variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    # PFN: flax Dense kernel (D, C) -> torch Linear weight (C, D)
    sd["pfn.linear.weight"] = _t(p["pfn"]["linear"]["kernel"]).t()
    _bn(sd, "pfn.bn", p["pfn"]["bn"], bs["pfn"]["bn"])

    # RPN blocks: flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)
    for i, n_layers in enumerate(config.rpn_layers):
        for j in range(n_layers):
            k = _t(p["rpn"][f"block{i}"][f"conv{j}"]["kernel"])
            sd[f"rpn.blocks.{i}.{j}.0.weight"] = k.permute(3, 2, 0, 1)
            _bn(sd, f"rpn.blocks.{i}.{j}.1",
                p["rpn"][f"block{i}"][f"bn{j}"], bs["rpn"][f"block{i}"][f"bn{j}"])
        # up: flax ConvTranspose kernel (kh, kw, in, out), applied flipped
        # relative to torch ConvTranspose2d (in, out, kh, kw) -> flip spatial
        k = _t(p["rpn"][f"up{i}"]["deconv"]["kernel"])
        sd[f"rpn.ups.{i}.0.weight"] = k.flip(0, 1).permute(2, 3, 0, 1)
        _bn(sd, f"rpn.ups.{i}.1", p["rpn"][f"up{i}"]["bn"], bs["rpn"][f"up{i}"]["bn"])

    # head 1x1 convs (with bias)
    for name in ("cls", "box", "dir"):
        k = _t(p["head"][name]["kernel"])
        sd[f"{name}.weight"] = k.permute(3, 2, 0, 1)
        sd[f"{name}.bias"] = _t(p["head"][name]["bias"])
    return sd


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _bn_from(sd: dict, prefix: str) -> tuple[dict, dict]:
    return ({"scale": _n(sd[f"{prefix}.weight"]),
             "bias": _n(sd[f"{prefix}.bias"])},
            {"mean": _n(sd[f"{prefix}.running_mean"]),
             "var": _n(sd[f"{prefix}.running_var"])})


def torch_to_flax(sd: dict, config: PillarsConfig) -> dict:
    """MIGRATION PATH (exact inverse of :func:`flax_to_torch`): import a
    torch PointPillars state_dict in the reference layout into the flax
    variable tree {'params', 'batch_stats'} consumed by Detector / the
    train step. Weights trained in the reference's torch stack serve (and
    fine-tune) here unchanged — round-trip is bit-identical
    (tests/test_torch_reference_cpu.py).

    Accepts torch tensors or numpy arrays as values. Expected keys are the
    ones flax_to_torch emits (pfn.linear/pfn.bn, rpn.blocks.{i}.{j}.{0,1},
    rpn.ups.{i}.{0,1}, cls/box/dir) — a missing key raises KeyError naming
    it."""
    params: dict = {"pfn": {}, "rpn": {}, "head": {}}
    stats: dict = {"pfn": {}, "rpn": {}}

    # torch Linear weight (C, D) -> flax Dense kernel (D, C)
    params["pfn"]["linear"] = {
        "kernel": _n(sd["pfn.linear.weight"]).transpose(1, 0)}
    params["pfn"]["bn"], stats["pfn"]["bn"] = _bn_from(sd, "pfn.bn")

    for i, n_layers in enumerate(config.rpn_layers):
        blk_p: dict = {}
        blk_s: dict = {}
        for j in range(n_layers):
            # torch Conv2d weight (out, in, kh, kw) -> flax (kh, kw, in, out)
            blk_p[f"conv{j}"] = {"kernel": _n(
                sd[f"rpn.blocks.{i}.{j}.0.weight"]).transpose(2, 3, 1, 0)}
            blk_p[f"bn{j}"], blk_s[f"bn{j}"] = _bn_from(
                sd, f"rpn.blocks.{i}.{j}.1")
        params["rpn"][f"block{i}"] = blk_p
        stats["rpn"][f"block{i}"] = blk_s
        # torch ConvTranspose2d weight (in, out, kh, kw) -> flax
        # ConvTranspose kernel (kh, kw, in, out), spatially flipped (the
        # forward conversion flips before permuting; invert in reverse order)
        k = _n(sd[f"rpn.ups.{i}.0.weight"]).transpose(2, 3, 0, 1)
        params["rpn"][f"up{i}"] = {"deconv": {"kernel": k[::-1, ::-1].copy()}}
        up_bn_p, up_bn_s = _bn_from(sd, f"rpn.ups.{i}.1")
        params["rpn"][f"up{i}"]["bn"] = up_bn_p
        stats["rpn"][f"up{i}"] = {"bn": up_bn_s}

    for name in ("cls", "box", "dir"):
        params["head"][name] = {
            "kernel": _n(sd[f"{name}.weight"]).transpose(2, 3, 1, 0),
            "bias": _n(sd[f"{name}.bias"]),
        }
    return {"params": params, "batch_stats": stats}
