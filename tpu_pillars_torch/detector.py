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

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.geometry.boxes import Box3D
from tpu_pillars_torch.geometry.transforms import Pose
from tpu_pillars_torch.models.pointpillars import PointPillars
from tpu_pillars_torch.ops.anchors import make_anchors
from tpu_pillars_torch.ops.bev import scatter_to_bev, scatter_to_bev_auto
from tpu_pillars_torch.ops.emit import pillarize_batch_emit
from tpu_pillars_torch.ops.fused_pfn import pillarize_pfn_fused
from tpu_pillars_torch.ops.pfn import pfn_fused
from tpu_pillars_torch.ops.postprocess import (
    Detections, postprocess_w, resolve_nms_impl,
)
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
    the drop is counted in ``truncation`` and warned."""
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
    if host_crop and len(points):
        # a strict SUPERSET of the device validity predicate: the
        # grid-derived upper bound plus one voxel of float margin
        x, y, z = points[:, 0], points[:, 1], points[:, 2]
        xh = cfg.x_min + (cfg.grid_w + 1) * cfg.voxel_x
        yh = cfg.y_min + (cfg.grid_h + 1) * cfg.voxel_y
        keep = ((x >= cfg.x_min) & (x < xh)
                & (y >= cfg.y_min) & (y < yh)
                & (z >= cfg.z_min) & (z <= cfg.z_max))
        points = points[keep]
    n = min(len(points), cfg.max_points)
    m = cfg.max_points
    if buckets is not None:
        m = next(b for b in buckets if b >= n)
    if scales is not None:
        # int16 fixed point: per-channel quantize; 32767 is the pad
        # sentinel (it dequantizes out of the detection range)
        out = np.full((m, f_expect), 32767, dtype=np.int16)
        q = np.round(points[:n, :f_expect] / scales)
        out[:n] = np.clip(q, -32767, 32767).astype(np.int16)
    else:
        # pad with a finite out-of-range sentinel (f16's max is ~65504)
        pad = 1e6 if wire_np.itemsize >= 4 else 3e4
        out = np.full((m, f_expect), pad, dtype=wire_np)
        out[:n] = points[:n, :f_expect]
    truncation.record(len(points), n, label="pad_points")
    return out, np.int32(n)


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

    def load_state_dict(self, state_dict: dict) -> None:
        """Serve other weights with the same programs and ``dtype``: copy
        ``state_dict`` into the model and fold the PFN weights again (stage
        1 takes them once, when it is built)."""
        self.model.load_state_dict(state_dict)
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
        """Canvas -> wire tensors (own (B, A), box_p (B, 7, A),
        dir_p (B, 2, A))."""
        return self._stage1.wire(canvas)

    def postprocess(self, own, box_p, dir_p) -> Detections:
        return self._post(own, box_p, dir_p)

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
        return pad_points(points, self.config, self.truncation,
                          host_crop=self.host_crop, wire_np=self._wire_np,
                          scales=self._wire_scales,
                          buckets=self.wire_buckets)

    def predict_raw_batch(self, points_batch, num_points) -> Detections:
        """points_batch (B, M, F) already padded, in the wire dtype;
        num_points (B,)."""
        points = self.dequant(self.upload(points_batch))
        counts = self.upload(num_points).long()
        return self.postprocess(*self._stage1(points, counts))

    def predict_raw(self, points: np.ndarray) -> Detections:
        padded, n = self.pad_points(points)
        det = self.predict_raw_batch(padded[None], np.asarray([n]))
        return Detections(*(t[0] for t in det))

    def predict_packed_batch(self, points_batch, num_points) -> torch.Tensor:
        """(B, M, F) padded clouds + (B,) counts -> (B, D, 10) device
        tensor [x, y, z, w, l, h, yaw, score, class, valid]."""
        return pack_detections(self.predict_raw_batch(points_batch,
                                                      num_points))

    def predict_packed(self, points: np.ndarray) -> torch.Tensor:
        """One sweep -> (D, 10) device tensor (single transfer to fetch)."""
        padded, n = self.pad_points(points)
        return self.predict_packed_batch(padded[None], np.asarray([n]))[0]

    # --- public API: points -> List[Box3D] ---

    def predict(self, points: np.ndarray, token: str = "",
                lidar_to_global: Optional[Pose] = None) -> List[Box3D]:
        packed = self.predict_packed(points).cpu().numpy()
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
                yield packed_to_boxes(out.cpu().numpy(), self.config)
            return
        pending: "deque" = deque()
        for points in clouds:
            pending.append(self.predict_packed(points))
            if len(pending) > depth:
                yield packed_to_boxes(pending.popleft().cpu().numpy(),
                                      self.config)
        while pending:
            yield packed_to_boxes(pending.popleft().cpu().numpy(),
                                  self.config)


def pack_detections(det: Detections) -> torch.Tensor:
    """Detections -> (..., D, 10) f32 [x,y,z,w,l,h,yaw,score,class,valid]."""
    return torch.cat([det.boxes, det.scores[..., None],
                      det.class_ids.to(torch.float32)[..., None],
                      det.valid.to(torch.float32)[..., None]], dim=-1)


def packed_to_boxes(packed: np.ndarray, config: PillarsConfig,
                    token: str = "",
                    lidar_to_global: Optional[Pose] = None) -> List[Box3D]:
    names = config.class_names
    out: List[Box3D] = []
    for row in packed:
        if row[9] == 0.0:
            continue
        box = Box3D.from_array(row[:7], label=names[int(row[8])],
                               score=float(row[7]), token=token)
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
