"""Detector — the port's public inference API: raw point cloud ->
``List[Box3D]``. Port of ``tpu_pillars/detector.py``.

Stage 1 (points -> wire tensors) has two front ends, chosen as the JAX
package chooses them (:func:`use_fused_frontend`):

* fused (the default with ``use_pallas_pfn`` when the points per pillar
  are a power of two): stable sort by pillar id, cell-centring, K1 emit,
  K2 fused PFN, K3 BEV scatter;
* classic (``fused_frontend=False``, or ``use_pallas_pfn=False``): stable
  sort, K1 emit on the raw points, ``decorate``, the PillarFeatureNet on
  the decorated (B*P, N, D) tensor — K6 (``use_pallas_pfn=True``) or the
  plain module — and K3.

Then the RPN and the wire head, in ``dtype`` (float32 by default, or
bfloat16 with the JAX package's cast points: the front end stays f32 up to
K3, which writes the bf16 canvas; the wire stays f32). Stage 2 (wire ->
detections): sigmoid, per-class threshold and top-k, decode, class-aware
rotated NMS (``nms_impl``: the K4 overlap matrix on the card by
default). :func:`build_canvas_fn`, :func:`build_model_fn`,
:func:`build_postprocess_fn` and :func:`build_forward_fn` are the stages as
plain functions over a loaded ``PointPillars``; ``Detector`` runs stage 1
through :func:`build_model_fn` and stage 2 through
:func:`build_postprocess_fn`. Each takes a batch, (B, M, F) points and (B,)
counts, or one sweep, (M, F) points and a scalar count; one sweep runs
as a batch of one and comes back without the batch axis. So each of the
port's functions is both JAX functions of its name:
``build_canvas_fn`` and ``build_canvas_fn_batched``, ``build_model_fn``
and ``build_model_fn_batched``, ``build_forward_fn`` (the JAX package has
no batched twin).
Everything runs on ``device``; the only host transfers are the padded cloud
in and one packed (D, 10) array out. The cloud crosses in ``wire_dtype``:
f32, or one of the JAX package's two 2-byte wires (f16, or int16 fixed
point with per-channel scales), converted to f32 on the card.
:meth:`Detector.predict_stream` pipelines a sequence of sweeps;
:meth:`Detector.from_torch` serves weights in the CPU reference's torch
layout (``reference_cpu``).

A ``CenterPointConfig`` serves CenterPoint-PP through the same entry points
and stages (:func:`build_center_model_fn`,
:func:`build_center_postprocess_fn`): stage 1 is the sort, K1, K2's
two-layer instance and K3, then the RPN and the centre head (spans
``detector.rpn`` and ``detector.center_head``), giving the dense head maps
as its one wire tensor; stage 2 is ``ops.center_decode`` (spans
``detector.decode`` and ``detector.nms``), and its packed rows carry the
velocity after the ten PointPillars columns. It serves in float32.

The device defaults to ``"cuda"``: with no GPU the constructor raises
unless the caller passes ``device="cpu"``, where the kernels' plain
versions run instead.
"""

from __future__ import annotations

import os
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from tpu_pillars_torch.config import CenterPointConfig, PillarsConfig
from tpu_pillars_torch.data import native_io
from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.geometry.transforms import Pose
from tpu_pillars_torch.models.centerpoint import CenterPoint
from tpu_pillars_torch.models.pointpillars import PointPillars
from tpu_pillars_torch.ops.anchors import make_anchors
from tpu_pillars_torch.ops.bev import scatter_to_bev, scatter_to_bev_auto
from tpu_pillars_torch.ops.center_decode import (
    CenterDetections, center_postprocess,
)
from tpu_pillars_torch.ops.emit import emit_table, pillarize_batch_emit
from tpu_pillars_torch.ops.fused_pfn import (
    center_points, pfn2_from_table, pillarize_pfn_fused,
)
from tpu_pillars_torch.ops.pfn import pfn_fused
from tpu_pillars_torch.ops.postprocess import (
    Detections, postprocess_w, resolve_nms_impl,
)
from tpu_pillars_torch.ops.voxelize import sort_points_by_pillar
from tpu_pillars_torch.utils import profiling
from tpu_pillars_torch.utils.profiling import count, span
from tpu_pillars_torch.utils.truncation import TruncationStats


def resolve_device(device=None) -> torch.device:
    """None means the card. Raises when there is none; the CPU must be asked
    for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpu_pillars_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain versions "
                "of its kernels on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


def use_fused_frontend(config: PillarsConfig, use_pallas_pfn: bool,
                       fused_frontend: Optional[bool] = None) -> bool:
    """Resolve the fused-front-end switch as the JAX package does: None
    means ``use_pallas_pfn`` (the JAX default on its accelerator; the port
    always runs on its card), and the fused front end runs only when the
    points per pillar are a power of two (the JAX fused kernel's
    requirement, kept so that both packages take the same path)."""
    n = config.max_points_per_pillar
    if fused_frontend is None:
        fused_frontend = use_pallas_pfn
    return bool(fused_frontend) and (n & (n - 1)) == 0


def build_canvas_fn(model: PointPillars, config: PillarsConfig,
                    use_pallas_pfn: bool = True,
                    fused_frontend: Optional[bool] = None,
                    dtype=torch.float32):
    """Front half of stage 1: f(points (B, M, F), num_points (B,)) -> BEV
    canvas (B, H, W, C) in ``dtype``; f(points (M, F), scalar count) -> (H,
    W, C). Fused front end, or the classic one with K6
    (``use_pallas_pfn``) or the plain PillarFeatureNet; see the module
    docstring. The fused and K6 front ends compute f32 rows and K3 writes
    them into a ``dtype`` canvas; the plain PillarFeatureNet runs in
    ``dtype``. The folded PFN weights are taken once, here."""
    fused = use_fused_frontend(config, use_pallas_pfn, fused_frontend)
    w, b = model.pfn.folded()

    @torch.no_grad()
    def canvas_fn(points, num_points):
        if points.dim() == 2:                 # one sweep: a batch of one
            n = torch.as_tensor(num_points, device=points.device)
            return canvas_fn(points[None], n.reshape(1))[0]
        if fused:
            feats, pid_per, pmask = pillarize_pfn_fused(points, num_points,
                                                        w, b, config)
            return scatter_to_bev(feats, pid_per, pmask, config, dtype)
        batch = pillarize_batch_emit(points, num_points, config)
        if not use_pallas_pfn:
            return model.canvas_from_batch(batch, dtype)
        B, P, N, D = batch.features.shape
        flat = pfn_fused(batch.features.reshape(B * P, N, D),
                         batch.mask.reshape(B * P, N), w, b)
        return scatter_to_bev_auto(flat.reshape(B, P, -1), batch.coords,
                                   batch.pillar_mask, config, dtype)

    return canvas_fn


def build_model_fn(model: PointPillars, config: PillarsConfig,
                   use_pallas_pfn: bool = True,
                   fused_frontend: Optional[bool] = None,
                   dtype=torch.float32):
    """Stage 1: f(points (B, M, F), num_points (B,)) -> wire tensors (own
    (B, A), box_p (B, 7, A), dir_p (B, 2, A)), f32, the RPN and the head
    computed in ``dtype``; one sweep, f(points (M, F), scalar count) ->
    (A,), (7, A), (2, A). Its two halves stay callable apart, as
    ``.canvas`` (points -> canvas) and ``.wire`` (canvas (B, H, W, C) or
    (H, W, C) -> wire tensors), so that a caller can time them."""
    canvas_fn = build_canvas_fn(model, config, use_pallas_pfn=use_pallas_pfn,
                                fused_frontend=fused_frontend, dtype=dtype)

    @torch.no_grad()
    def wire_fn(canvas):
        if canvas.dim() == 3:
            return tuple(t[0] for t in wire_fn(canvas[None]))
        return model.wire_head(model.features_from_canvas(canvas, dtype),
                               dtype)

    def run_model(points, num_points):
        return wire_fn(canvas_fn(points, num_points))

    run_model.canvas = canvas_fn
    run_model.wire = wire_fn
    return run_model


def build_postprocess_fn(config: PillarsConfig, device=None,
                         nms_impl: str = "auto"):
    """Stage 2: f(own, box_p, dir_p) -> Detections, with the anchors made
    once on ``device`` (None: the card, as :func:`resolve_device`); own
    (B, A) gives (B, D, ...) detections, one sweep's own (A,) gives
    Detections without the batch axis.
    nms_impl: "auto" (K4 on the card, the dense IoU on the CPU), resolved
    here, where an unknown name raises; "pallas" or "fixpoint" names one of
    the two (on the card "fixpoint" serves only as the check of K4)."""
    device = resolve_device(device)
    nms_impl = resolve_nms_impl(nms_impl, device)
    anchors, anchor_cls = make_anchors(config)
    anchors_t = torch.from_numpy(np.array(anchors)).to(device)
    anchor_cls_t = torch.from_numpy(
        np.array(anchor_cls, dtype=np.int64)).to(device)

    @torch.no_grad()
    def run_post(own, box_p, dir_p) -> Detections:
        if own.dim() == 1:
            return Detections(*(t[0] for t in run_post(
                own[None], box_p[None], dir_p[None])))
        return postprocess_w(own, box_p, dir_p, anchors_t, anchor_cls_t,
                             config, nms_impl)

    return run_post


def build_forward_fn(model: PointPillars, config: PillarsConfig,
                     use_pallas_pfn: bool = True,
                     fused_frontend: Optional[bool] = None,
                     dtype=torch.float32):
    """f(points (B, M, F), num_points (B,)) -> Detections (B, D, ...), or
    one sweep, f(points (M, F), scalar count) -> Detections (D, ...): stage
    1 (in ``dtype``) then stage 2 on the model's device."""
    stage1 = build_model_fn(model, config, use_pallas_pfn=use_pallas_pfn,
                            fused_frontend=fused_frontend, dtype=dtype)
    device = next(model.parameters()).device
    stage2 = build_postprocess_fn(config, device)

    def forward(points, num_points) -> Detections:
        return stage2(*stage1(points, num_points))

    return forward


def build_center_model_fn(model, config: CenterPointConfig):
    """CenterPoint's stage 1, as :func:`build_model_fn`: f(points (B, M,
    F), num_points (B,)) -> ``(maps,)``, the dense head maps (B, C, H / 4,
    W / 4) f32 (``models.centerpoint.map_layout``), with ``.canvas``
    (points -> (B, H, W, C) canvas: sort, K1, K2's two-layer instance, K3)
    and ``.wire`` (canvas -> ``(maps,)``: the RPN and the centre head, in
    the spans ``detector.rpn`` and ``detector.center_head``). The PFN's
    folded weights and the head's stacked convolutions are taken once,
    here. While tracing is on, the counter ``detector.pillars_dropped``
    counts the occupied pillars over the budget."""
    with torch.no_grad():
        pfn = model.pfn.folded(config)
        stacked = model.head.stacked()
    hw = config.grid_h * config.grid_w

    @torch.no_grad()
    def canvas_fn(points, num_points):
        if points.dim() == 2:
            n = torch.as_tensor(num_points, device=points.device)
            return canvas_fn(points[None], n.reshape(1))[0]
        gid, pts = sort_points_by_pillar(points, num_points, config)
        if profiling.recording():
            starts = (gid < hw) & torch.cat(
                [torch.ones_like(gid[:, :1], dtype=torch.bool),
                 gid[:, 1:] != gid[:, :-1]], dim=1)
            over = starts.sum(dim=1) - config.max_pillars
            profiling.count_device("detector.pillars_dropped",
                                   over.clamp(min=0).sum())
        table, meta = emit_table(gid, center_points(gid, pts, config),
                                 config.max_points_per_pillar,
                                 config.max_pillars, hw)
        feats, pid, cnt = pfn2_from_table(table, meta, *pfn, config)
        return scatter_to_bev(feats, pid, cnt > 0.0, config)

    @torch.no_grad()
    def wire_fn(canvas):
        if canvas.dim() == 3:
            return tuple(t[0] for t in wire_fn(canvas[None]))
        with span("detector.rpn", device=canvas.device):
            feat = model.features_from_canvas(canvas)
        with span("detector.center_head", device=canvas.device):
            return (model.head_maps(feat, stacked),)

    def run_model(points, num_points):
        return wire_fn(canvas_fn(points, num_points))

    run_model.canvas = canvas_fn
    run_model.wire = wire_fn
    return run_model


def build_center_postprocess_fn(config: CenterPointConfig, device=None,
                                nms_impl: str = "auto"):
    """CenterPoint's stage 2: f(maps) -> ``CenterDetections`` (maps (B, C,
    h, w), or one sweep's (C, h, w) without the batch axis); ``nms_impl``
    as for :func:`build_postprocess_fn`."""
    nms_impl = resolve_nms_impl(nms_impl, resolve_device(device))

    @torch.no_grad()
    def run_post(maps):
        if maps.dim() == 3:
            return CenterDetections(*(t[0] for t in run_post(maps[None])))
        return center_postprocess(maps, config, nms_impl)

    return run_post


# the wire dtypes of the host -> device upload, and their numpy types
WIRE_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
               torch.int16: np.int16}


def int16_wire_scales(config: PillarsConfig) -> np.ndarray:
    """Per-channel scales of the int16 fixed-point wire, as the JAX
    package sets them: coordinates at span * 1.25 / 32767 (the 1.25 puts
    the 32767 pad sentinel out of the detection range), intensity at 0.01,
    the multi-sweep dt channel at 1/8192."""
    f = config.num_input_features
    span = max(abs(config.x_min), abs(config.x_max), abs(config.y_min),
               abs(config.y_max), abs(config.z_min), abs(config.z_max))
    scales = np.full((f,), 0.01, np.float32)
    scales[:3] = span * 1.25 / 32767.0
    if config.num_sweeps > 1:
        scales[f - 1] = 1.0 / 8192.0
    return scales


def pad_points(points: np.ndarray, config: PillarsConfig,
               truncation: TruncationStats, host_crop: bool = True,
               wire_np=np.float32, scales: Optional[np.ndarray] = None,
               buckets: Optional[tuple] = None):
    """Pad/crop a cloud to a static (M, F) upload in the wire dtype
    ``wire_np`` (int16 fixed point when ``scales`` is given). F is pinned
    by the config; extra columns are dropped, missing ones are an error.
    host_crop: drop points outside the detection range first. M is
    config.max_points, or the smallest of ``buckets`` that holds the cloud.
    Clouds beyond the budget keep their FIRST max_points (in-range) rows;
    the drop is counted in ``truncation`` and warned.

    One native pass (``data.native_io.crop_pad``) when its library loads,
    else numpy; both give the same bytes. While tracing is on, the counter
    ``detector.pad_native`` or ``detector.pad_numpy`` counts the sweep."""
    cfg = config
    wire_np = np.dtype(wire_np)
    f_expect = cfg.num_input_features
    points = np.asarray(points, dtype=np.float32)
    points = points.reshape(-1, points.shape[-1] if points.size
                            else f_expect)
    if points.shape[1] < f_expect:
        raise ValueError(
            f"points have {points.shape[1]} feature columns; config "
            f"needs {f_expect} (x, y, z, intensity"
            f"{', dt' if cfg.num_sweeps > 1 else ''})")
    if scales is not None:
        # both paths divide in float32
        scales = np.asarray(scales, dtype=np.float32)
    # pad with a finite out-of-range sentinel (f16's max is ~65504); the
    # int16 wire pads with 32767, which dequantizes out of the range
    pad = 1e6 if wire_np.itemsize >= 4 else 3e4
    crop = None
    if host_crop:
        # a strict SUPERSET of the device validity predicate: the
        # grid-derived upper bound plus one voxel of float margin
        crop = np.asarray(
            [cfg.x_min, cfg.x_min + (cfg.grid_w + 1) * cfg.voxel_x,
             cfg.y_min, cfg.y_min + (cfg.grid_h + 1) * cfg.voxel_y,
             cfg.z_min, cfg.z_max], dtype=np.float32)
    if native_io.native_available():
        out, in_range = native_io.crop_pad(points, f_expect, crop,
                                           cfg.max_points, pad, scales)
        count("detector.pad_native")
    else:
        out, in_range = _crop_pad_numpy(points, f_expect, crop,
                                        cfg.max_points, pad, scales)
        count("detector.pad_numpy")
    n = min(in_range, cfg.max_points)
    if buckets is not None:
        out = out[:next(b for b in buckets if b >= n)]
    if scales is None and out.dtype != wire_np:
        out = out.astype(wire_np)
    truncation.record(in_range, n, label="pad_points")
    return out, np.int32(n)


def _crop_pad_numpy(points: np.ndarray, n_take: int,
                    crop: Optional[np.ndarray], max_points: int, pad: float,
                    scales: Optional[np.ndarray]):
    """:func:`native_io.crop_pad` in numpy, for a host where its library
    does not build: the same arguments, bytes and in-range count."""
    if crop is not None and len(points):
        x, y, z = points[:, 0], points[:, 1], points[:, 2]
        keep = ((x >= crop[0]) & (x < crop[1])
                & (y >= crop[2]) & (y < crop[3])
                & (z >= crop[4]) & (z <= crop[5]))
        points = points[keep]
    n = min(len(points), max_points)
    if scales is None:
        out = np.full((max_points, n_take), pad, dtype=np.float32)
        out[:n] = points[:n, :n_take]
    else:
        # int16 fixed point: per-channel quantize
        out = np.full((max_points, n_take), 32767, dtype=np.int16)
        q = np.round(points[:n, :n_take] / scales)
        out[:n] = np.clip(q, -32767, 32767).astype(np.int16)
    return out, len(points)


class Detector:
    """Host-facing wrapper: pads clouds to the static budget, runs the
    two stages, converts to Box3D (optionally into the global frame)."""

    def __init__(self, config: PillarsConfig, state_dict: dict,
                 device=None, host_crop: bool = True,
                 wire_buckets: "Optional[tuple]" = None,
                 fused_frontend: Optional[bool] = None,
                 use_pallas_pfn: bool = True, dtype=torch.float32,
                 nms_impl: str = "auto", wire_dtype=torch.float32):
        """state_dict: ``weights.params_from_flax`` output.

        wire_dtype: the dtype of the host -> device point upload, as the
        JAX ``Detector(wire_dtype=)``: ``torch.float32`` (default),
        ``torch.float16`` or ``torch.int16``. The 2-byte wires halve the
        upload and move boxes (they are not bit-for-boxes with f32):
        float16 quantizes coordinates to ~5 cm at 100 m; int16 is fixed
        point with the per-channel scales of :func:`int16_wire_scales`
        (~3 mm at the full config). ``pad_points`` returns the wire dtype,
        it crosses to the card as it is, and the card converts it to f32
        (one multiply by the scales for int16) before stage 1.

        nms_impl: the NMS of stage 2 (:func:`build_postprocess_fn`): "auto"
        (default; K4 on the card, the dense fixpoint on the CPU); "pallas"
        or "fixpoint" names one of the two.

        dtype: the compute type of stage 1, ``torch.float32`` (default) or
        ``torch.bfloat16`` (the JAX ``Detector(dtype=jnp.bfloat16)``): the
        RPN and the head run in bf16 on bf16 views of the f32 weights, and
        the wire and everything after it stay f32.

        fused_frontend: True for the decoration-free fused front end, False
        for the classic one, None (default) for the fused one exactly when
        ``use_pallas_pfn``; the fused one needs a power-of-two
        ``max_points_per_pillar`` and the classic one runs otherwise
        (:func:`use_fused_frontend`). use_pallas_pfn: on the classic front
        end, the K6 kernel (default) or the plain PillarFeatureNet.

        host_crop: drop points outside the detection range on the host
        before upload (default on); a strict superset of the device validity
        predicate is kept, so boxes are bit-identical.

        wire_buckets: optional ascending static upload sizes (the last must
        be config.max_points); each sweep pads to the smallest bucket that
        fits its (cropped) cloud."""
        config.validate()
        if wire_dtype not in WIRE_DTYPES:
            raise TypeError(f"wire_dtype must be torch.float32, "
                            f"torch.float16 or torch.int16, got {wire_dtype}")
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # a concrete card, so that a thread of its own (the server's
            # dispatcher, predict_stream's producer) can make it current
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.truncation = TruncationStats()
        self.host_crop = host_crop
        self.wire_dtype = wire_dtype
        self._wire_np = np.dtype(WIRE_DTYPES[wire_dtype])
        self._wire_scales = (int16_wire_scales(config)
                             if wire_dtype == torch.int16 else None)
        self._scales_t = (None if self._wire_scales is None else
                          torch.from_numpy(self._wire_scales).to(self.device))
        if wire_buckets is not None:
            wire_buckets = tuple(sorted(int(b) for b in wire_buckets))
            if wire_buckets[-1] != config.max_points:
                raise ValueError(
                    f"wire_buckets must end at config.max_points="
                    f"{config.max_points}; got {wire_buckets}")
        self.wire_buckets = wire_buckets
        if isinstance(config, CenterPointConfig):
            self._init_center(state_dict, dtype, nms_impl)
            return
        model = PointPillars(config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.fused_frontend = use_fused_frontend(config, use_pallas_pfn,
                                                 fused_frontend)
        self.use_pallas_pfn = use_pallas_pfn
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"Detector dtype must be torch.float32 or "
                            f"torch.bfloat16, got {dtype}")
        self.dtype = dtype
        self._stage1 = build_model_fn(self.model, config,
                                      use_pallas_pfn=use_pallas_pfn,
                                      fused_frontend=fused_frontend,
                                      dtype=dtype)
        self._post = build_postprocess_fn(config, self.device, nms_impl)

    def _init_center(self, state_dict: dict, dtype, nms_impl: str) -> None:
        """The CenterPoint kind: its model and stages, float32 only."""
        if dtype != torch.float32:
            raise TypeError("a CenterPoint Detector serves in float32")
        self.dtype = dtype
        model = CenterPoint(self.config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self._stage1 = build_center_model_fn(self.model, self.config)
        self._post = build_center_postprocess_fn(self.config, self.device,
                                                 nms_impl)

    @property
    def is_center(self) -> bool:
        """Whether this detector serves CenterPoint (else PointPillars)."""
        return isinstance(self.config, CenterPointConfig)

    def load_state_dict(self, state_dict: dict) -> None:
        """Serve other weights with the same programs and ``dtype``: copy
        ``state_dict`` into the model and fold the PFN weights again (stage
        1 takes them once, when it is built)."""
        self.model.load_state_dict(state_dict)
        if self.is_center:
            self._stage1 = build_center_model_fn(self.model, self.config)
            return
        self._stage1 = build_model_fn(self.model, self.config,
                                      use_pallas_pfn=self.use_pallas_pfn,
                                      fused_frontend=self.fused_frontend,
                                      dtype=self.dtype)

    @classmethod
    def from_checkpoint(cls, config: PillarsConfig, path: str, **kw
                        ) -> "Detector":
        """Load inference weights from a flax msgpack checkpoint of the JAX
        package (``train.checkpoint`` format). A recorded config fingerprint
        that does not match ``config`` fails fast."""
        from tpu_pillars_torch.weights import (
            check_fingerprint, load_flax_msgpack, params_from_flax,
        )

        tree = load_flax_msgpack(path)
        check_fingerprint(tree, config, path)
        variables = {"params": tree["params"],
                     "batch_stats": tree["batch_stats"]}
        return cls(config, params_from_flax(variables, config), **kw)

    @classmethod
    def from_torch(cls, config: PillarsConfig, state_dict_or_path, **kw
                   ) -> "Detector":
        """Migration: serve weights in the CPU reference's torch layout
        (``reference_cpu.model.TorchPointPillars``): a state dict, the path
        of a ``torch.save`` of one, or the whole module. Goes
        ``reference_cpu.convert.torch_to_flax`` -> ``weights.params_from_
        flax`` -> ``Detector(config, ..., **kw)``, on the card unless
        ``device="cpu"`` is passed."""
        from tpu_pillars_torch.reference_cpu.convert import torch_to_flax
        from tpu_pillars_torch.weights import params_from_flax

        sd = state_dict_or_path
        if isinstance(sd, (str, bytes, os.PathLike)):
            sd = torch.load(sd, map_location="cpu", weights_only=True)
        if isinstance(sd, torch.nn.Module):
            sd = sd.state_dict()
        return cls(config, params_from_flax(torch_to_flax(sd, config),
                                            config), **kw)

    # --- stages (device tensors, static shapes) ---

    def canvas(self, points: torch.Tensor, num_points: torch.Tensor):
        """(B, M, F) f32 points, (B,) counts -> (B, H, W, C) canvas in
        ``self.dtype``."""
        return self._stage1.canvas(points, num_points)

    def wire(self, canvas: torch.Tensor):
        """Canvas -> wire tensors: PointPillars' (own (B, A), box_p (B, 7,
        A), dir_p (B, 2, A)), CenterPoint's (maps (B, C, h, w),)."""
        return self._stage1.wire(canvas)

    def postprocess(self, *wire):
        """Wire tensors -> ``Detections`` (PointPillars) or
        ``CenterDetections`` (CenterPoint)."""
        return self._post(*wire)

    def upload(self, x) -> torch.Tensor:
        """A host array or tensor -> the same dtype on ``self.device``. No
        dtype change on the way: torch converts on the host before a copy,
        so the card would receive the converted bytes."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def dequant(self, points: torch.Tensor) -> torch.Tensor:
        """Uploaded wire points -> f32 on their device: ``.float()``, then
        for the int16 wire one multiply by the per-channel scales (JAX's
        ``points.astype(f32) * scales``)."""
        p = points.float()
        return p if self._scales_t is None else p * self._scales_t

    def bind_thread(self) -> None:
        """Make the detector's card the calling thread's current device
        (the current CUDA device is per thread)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # --- raw (device tensors) ---

    def pad_points(self, points: np.ndarray):
        """:func:`pad_points` with this detector's wire (dtype, int16
        scales, buckets), host crop and ``self.truncation``."""
        with span("detector.pad"):
            return pad_points(points, self.config, self.truncation,
                              host_crop=self.host_crop,
                              wire_np=self._wire_np,
                              scales=self._wire_scales,
                              buckets=self.wire_buckets)

    def predict_raw_batch(self, points_batch, num_points) -> Detections:
        """points_batch (B, M, F) already padded, in the wire dtype;
        num_points (B,)."""
        return self._predict(points_batch, num_points, pack=False)

    def _predict(self, points_batch, num_points, pack: bool):
        """One batch through both stages, as the spans ``detector.predict``
        (a unit) and its four stages (``utils.profiling``); ``pack``: the
        packed (B, D, 10) rows in place of ``Detections``."""
        dev = self.device
        with span("detector.predict", device=dev, unit=True):
            with span("detector.upload", device=dev):
                points = self.dequant(self.upload(points_batch))
                counts = self.upload(num_points).long()
            with span("detector.frontend", device=dev):
                canvas = self.canvas(points, counts)
            if self.is_center:      # its spans detector.rpn, .center_head
                wire = self.wire(canvas)
            else:
                with span("detector.rpn_head", device=dev):
                    wire = self.wire(canvas)
            with span("detector.postprocess", device=dev):
                det = self.postprocess(*wire)
                return pack_detections(det) if pack else det

    def predict_raw(self, points: np.ndarray) -> Detections:
        padded, n = self.pad_points(points)
        det = self.predict_raw_batch(padded[None], np.asarray([n]))
        return type(det)(*(t[0] for t in det))

    def predict_packed_batch(self, points_batch, num_points) -> torch.Tensor:
        """(B, M, F) padded clouds + (B,) counts -> (B, D, 10) device
        tensor [x, y, z, w, l, h, yaw, score, class, valid]; CenterPoint's
        rows add [vx, vy] (:func:`pack_detections`)."""
        return self._predict(points_batch, num_points, pack=True)

    def predict_packed(self, points: np.ndarray) -> torch.Tensor:
        """One sweep -> (D, 10) device tensor (single transfer to fetch)."""
        padded, n = self.pad_points(points)
        return self.predict_packed_batch(padded[None], np.asarray([n]))[0]

    # --- public API: points -> List[Box3D] ---

    def predict(self, points: np.ndarray, token: str = "",
                lidar_to_global: Optional[Pose] = None) -> List[Box3D]:
        packed = download(self.predict_packed(points))
        return packed_to_boxes(packed, self.config, token=token,
                               lidar_to_global=lidar_to_global)

    def predict_stream(self, clouds, depth: int = 3, threaded: bool = True):
        """Pipelined serving: yields List[Box3D] per input cloud, in input
        order, keeping up to ``depth`` sweeps in flight.

        threaded (default): a producer thread (``train.prefetch``) pads,
        uploads and launches while the consumer downloads the results, so
        the host pad of sweep k+1 overlaps the card's work on sweep k. Both
        threads use the card's default stream, so a download waits for
        everything queued before it. threaded=False keeps one thread and a
        deque of ``depth`` launched sweeps. Both give the boxes of
        :meth:`predict`."""
        if threaded:
            from tpu_pillars_torch.train.prefetch import prefetch

            def launched():
                self.bind_thread()
                for points in clouds:
                    yield self.predict_packed(points)

            for out in prefetch(launched(), size=depth):
                yield packed_to_boxes(download(out), self.config)
            return
        pending: "deque" = deque()
        for points in clouds:
            pending.append(self.predict_packed(points))
            if len(pending) > depth:
                yield packed_to_boxes(download(pending.popleft()),
                                      self.config)
        while pending:
            yield packed_to_boxes(download(pending.popleft()), self.config)


def download(packed: torch.Tensor) -> np.ndarray:
    """Packed detections -> a host array, in the span
    ``detector.download`` (the host's time blocked in the copy)."""
    with span("detector.download"):
        return packed.cpu().numpy()


def pack_detections(det) -> torch.Tensor:
    """Detections -> (..., D, 10) f32 [x,y,z,w,l,h,yaw,score,class,valid];
    ``CenterDetections`` -> (..., D, 12), the same and [vx, vy]."""
    cols = [det.boxes, det.scores[..., None],
            det.class_ids.to(torch.float32)[..., None],
            det.valid.to(torch.float32)[..., None]]
    if hasattr(det, "velocity"):
        cols.append(det.velocity)
    return torch.cat(cols, dim=-1)


def packed_to_boxes(packed: np.ndarray, config: PillarsConfig,
                    token: str = "",
                    lidar_to_global: Optional[Pose] = None) -> List[Box3D]:
    """Packed rows (:func:`pack_detections`) of one sweep -> its valid
    detections as ``Box3D`` (with the velocity where the rows carry
    one)."""
    names = config.class_names
    out: List[Box3D] = []
    for row in packed:
        if row[9] == 0.0:
            continue
        box = Box3D.from_array(row[:7], label=names[int(row[8])],
                               score=float(row[7]), token=token)
        if len(row) > 10:
            box.velocity = np.asarray(row[10:12], dtype=np.float64)
        if lidar_to_global is not None:
            box = box.transformed(lidar_to_global.rotation,
                                  lidar_to_global.translation)
        out.append(box)
    return out


def detections_to_boxes(det: Detections, config: PillarsConfig,
                        token: str = "",
                        lidar_to_global: Optional[Pose] = None
                        ) -> List[Box3D]:
    """One sweep's ``Detections`` (tensors on any device) -> List[Box3D],
    optionally in the global frame: :func:`packed_to_boxes` of its packed
    rows."""
    return packed_to_boxes(pack_detections(det).cpu().numpy(), config,
                           token=token, lidar_to_global=lidar_to_global)
