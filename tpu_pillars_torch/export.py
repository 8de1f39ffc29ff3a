"""Deployment artifacts: the detector's two serving stages saved as
``torch.export`` programs — the port's counterpart of
``tpu_pillars/export.py`` (``jax.export``).

Artifact layout (a directory), as the JAX package's:

    manifest.json   the config and its fingerprint (``weights.
                    config_fingerprint``), the batch sizes, the device type,
                    the torch version, each stage's shapes
    model_b{B}.pt2  stage 1 (``detector.build_model_fn``): (B, M, F) f32
                    padded points, (B,) int64 counts -> the wire tensors;
                    the weights are inside
    post_b{B}.pt2   stage 2 (``detector.build_postprocess_fn``, then
                    ``pack_detections``): the wire tensors -> (B, D, 10)
                    packed detections; the anchors are inside

The two-stage split is the live ``Detector``'s. Each kernel wrapper the
stages reach calls an op of the ``tpu_pillars`` namespace
(``_build.kernel_op``): K1 emit, K2 fused PFN, K3 BEV scatter (and its
bf16 instances with ``dtype=torch.bfloat16``), K4 overlap matrix on the
card, K6 on the classic front end, and the NMS fixpoint loop. The graph
names the ops and inlines neither the kernels nor their plain versions.
So unlike the JAX artifact, which is self-contained StableHLO, this one
needs the port's op library at load time: :func:`load_inference` imports
the modules that define the ops (the kernels build on the card at the
first launch, from ``tpu_pillars_torch/csrc``) before ``torch.export.load``.
It does not need the model-building code, the config presets or the
checkpoint.

The round trip is exact: the loaded programs run the same ops on the same
weights, and the tests pin packed outputs bit for bit against the live
``Detector`` on the same device and padded inputs. The padding is the JAX
artifact's (``ExportedDetector.pad_points``: the first ``max_points`` rows
as given, no host crop), so an over-budget cloud keeps the rows the JAX
artifact keeps. An exported program does not record the
backend's global switches, so ``ExportedDetector`` runs stage 1 of an f32
artifact with TF32 off (``models.backbone.precision``), as the live model
runs its RPN and head; the manifest says so (``"tf32": false``). An
artifact runs on the device type it was exported on
(``manifest["device"]``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu_pillars_torch.config import ClassSpec, PillarsConfig
from tpu_pillars_torch.models.backbone import precision

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def config_to_dict(config: PillarsConfig) -> dict:
    return dataclasses.asdict(config)


def config_from_dict(d: dict) -> PillarsConfig:
    d = dict(d)
    d["classes"] = tuple(ClassSpec(**c) for c in d["classes"])
    for k in ("rpn_channels", "rpn_layers", "anchor_yaws"):
        d[k] = tuple(d[k])
    return PillarsConfig(**d)


class _Stage1(torch.nn.Module):
    """Stage 1 as a module, so that the model's weights are the exported
    program's parameters and buffers."""

    def __init__(self, det):
        super().__init__()
        self.model = det.model
        self._fn = det._stage1

    def forward(self, points, num_points):
        return tuple(self._fn(points, num_points))


class _Stage2(torch.nn.Module):
    def __init__(self, det):
        super().__init__()
        self._post = det._post

    def forward(self, own, box_p, dir_p):
        from tpu_pillars_torch.detector import pack_detections

        return pack_detections(self._post(own, box_p, dir_p))


def _save(module, args, path):
    with torch.no_grad():
        prog = torch.export.export(module, args, strict=False)
    # the program keeps the example inputs it was traced on, and the
    # archive would store them (stage 2's wire at batch 8 and the full
    # config: 230 MB): only their shapes are needed, in the manifest
    prog.example_inputs = None
    torch.export.save(prog, path)


def export_inference(config: PillarsConfig, state_dict: dict, path: str,
                     batch_sizes: Sequence[int] = (1,),
                     dtype=torch.float32, use_pallas_pfn: bool = True,
                     fused_frontend: Optional[bool] = None,
                     nms_impl: str = "auto", device=None) -> dict:
    """Export the serving pipeline (weights inside) to ``path``.

    state_dict: ``weights.params_from_flax`` output (the live
    ``Detector``'s). dtype, use_pallas_pfn, fused_frontend and nms_impl as
    for ``Detector``; device: where the programs run (None: the card, as
    ``detector.resolve_device``). One (model, post) pair is exported per
    static batch size. Returns the manifest dict."""
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.weights import config_fingerprint

    det = Detector(config, state_dict, device=device, dtype=dtype,
                   use_pallas_pfn=use_pallas_pfn,
                   fused_frontend=fused_frontend, nms_impl=nms_impl)
    dev = det.device
    stage1, stage2 = _Stage1(det).eval(), _Stage2(det).eval()
    M, F = config.max_points, config.num_input_features
    os.makedirs(path, exist_ok=True)
    stages: Dict[str, dict] = {}
    for B in batch_sizes:
        pts = torch.full((B, M, F), 1e6, dtype=torch.float32, device=dev)
        counts = torch.zeros((B,), dtype=torch.int64, device=dev)
        mf, pf = f"model_b{B}.pt2", f"post_b{B}.pt2"
        with torch.no_grad():
            wire = stage1(pts, counts)
        _save(stage1, (pts, counts), os.path.join(path, mf))
        with torch.no_grad():
            packed = stage2(*wire)
        _save(stage2, tuple(wire), os.path.join(path, pf))
        stages[str(B)] = {
            "model": mf, "post": pf,
            "wire_shapes": [list(w.shape) for w in wire],
            "packed_shape": list(packed.shape),
        }

    manifest = {
        "format_version": _FORMAT_VERSION,
        "config": config_to_dict(config),
        "config_fingerprint": config_fingerprint(config).tobytes().hex(),
        "batch_sizes": [int(b) for b in batch_sizes],
        "device": dev.type,
        "dtype": str(dtype).replace("torch.", ""),
        "tf32": False,
        "torch_version": torch.__version__,
        "stages": stages,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedDetector:
    """Serving shell around a loaded artifact: pad -> stage 1 -> stage 2 ->
    packed detections / Box3D list. No model-building code runs; only the
    exported programs and the ops they name."""

    def __init__(self, path: str):
        from tpu_pillars_torch.detector import resolve_device
        from tpu_pillars_torch.ops import (  # noqa: F401 (define the ops)
            bev, emit, fused_pfn, nms, nms_overlap, pfn,
        )
        from tpu_pillars_torch.utils.truncation import TruncationStats

        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest["format_version"] != _FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.manifest['format_version']} != "
                f"reader format {_FORMAT_VERSION}")
        self.config = config_from_dict(self.manifest["config"])
        self.device = resolve_device(self.manifest["device"])
        self.batch_sizes = sorted(self.manifest["batch_sizes"])
        self.dtype = getattr(torch, self.manifest["dtype"])
        self.truncation = TruncationStats()
        self._calls: Dict[int, tuple] = {}
        with warnings.catch_warnings():
            # the archive's weights come back as read-only buffers, which
            # the programs never write
            warnings.filterwarnings("ignore", "The given buffer is not "
                                    "writable", UserWarning)
            for b_str, entry in self.manifest["stages"].items():
                model = torch.export.load(os.path.join(path, entry["model"]))
                post = torch.export.load(os.path.join(path, entry["post"]))
                self._calls[int(b_str)] = (model.module(), post.module())

    def pad_points(self, points: np.ndarray):
        """Pad as the JAX package's artifact does: the first max_points
        rows AS GIVEN (no host crop; the device drops out-of-range points),
        on the f32 wire, the drop counted in ``self.truncation``. So an
        over-budget cloud keeps the same rows and count as the JAX
        artifact; rows past the count hold the pad value, which the device
        masks. The cloud must have the config's feature columns (extra
        ones are dropped)."""
        from tpu_pillars_torch.detector import pad_points

        return pad_points(points, self.config, self.truncation,
                          host_crop=False)

    def predict_packed_batch(self, points, num_points) -> torch.Tensor:
        """(B, M, F) f32 padded points + (B,) counts (host arrays or
        tensors) -> (B, D, 10) packed detections on ``self.device``; B must
        be one of the exported batch sizes."""
        B = points.shape[0]
        if B not in self._calls:
            raise ValueError(
                f"batch {B} not in exported sizes {self.batch_sizes}")
        model, post = self._calls[B]
        pts = torch.as_tensor(np.asarray(points, np.float32)
                              if not torch.is_tensor(points) else points)
        n = torch.as_tensor(num_points)
        with torch.no_grad():
            with precision(self.dtype):
                wire = model(pts.to(self.device, torch.float32),
                             n.to(self.device, torch.int64))
            return post(*wire)

    def predict(self, points: np.ndarray, token: str = "",
                lidar_to_global=None) -> List:
        from tpu_pillars_torch.detector import packed_to_boxes

        if 1 not in self._calls:
            raise ValueError("artifact was not exported with batch size 1")
        pts, n = self.pad_points(points)
        packed = self.predict_packed_batch(pts[None], np.asarray([n]))
        return packed_to_boxes(packed[0].cpu().numpy(), self.config,
                               token=token, lidar_to_global=lidar_to_global)


def load_inference(path: str) -> ExportedDetector:
    """Load an artifact of :func:`export_inference` (needs the port's op
    modules, which this imports; not the model code)."""
    return ExportedDetector(path)


def _preset(name: str) -> PillarsConfig:
    from tpu_pillars_torch.config import (
        car_only_config, multisweep_config, tiny_config,
    )

    return {
        "full": PillarsConfig,
        "car_only": car_only_config,
        "multisweep": multisweep_config,
        "tiny": tiny_config,
    }[name]()


PRESETS = ("car_only", "full", "multisweep", "tiny")


def main(argv=None) -> None:
    """CLI: checkpoint -> deployment artifact.

    python -m tpu_pillars_torch.export --ckpt ck.msgpack --out art/ \
        [--preset full] [--batch-sizes 1,8] [--device cpu]
    """
    import argparse

    from tpu_pillars_torch.weights import (
        check_fingerprint, load_flax_msgpack, params_from_flax,
    )

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--preset", default="full", choices=PRESETS)
    ap.add_argument("--batch-sizes", default="1")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' exports the "
                         "kernels' plain versions for the CPU")
    args = ap.parse_args(argv)

    config = _preset(args.preset)
    tree = load_flax_msgpack(args.ckpt)
    check_fingerprint(tree, config, args.ckpt)
    state_dict = params_from_flax({"params": tree["params"],
                                   "batch_stats": tree["batch_stats"]},
                                  config)
    sizes = tuple(int(b) for b in args.batch_sizes.split(","))
    manifest = export_inference(config, state_dict, args.out,
                                batch_sizes=sizes, device=args.device)
    print(json.dumps({"out": args.out,
                      "batch_sizes": manifest["batch_sizes"],
                      "device": manifest["device"]}))


if __name__ == "__main__":
    main()
