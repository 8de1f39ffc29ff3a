"""Detector — the port's public inference API: raw point cloud ->
``List[Box3D]``. Port of ``tpu_pillars/detector.py`` (serving path, f32
wire).

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
:func:`build_postprocess_fn`.
Everything runs on ``device``; the only host transfers are the padded cloud
in and one packed (D, 10) array out.

The device defaults to ``"cuda"``: with no GPU the constructor raises
unless the caller passes ``device="cpu"``, where the kernels' plain
versions run instead.
"""

from __future__ import annotations

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
    canvas (B, H, W, C) in ``dtype``. Fused front end, or the classic one
    with K6 (``use_pallas_pfn``) or the plain PillarFeatureNet; see the
    module docstring. The fused and K6 front ends compute f32 rows and K3
    writes them into a ``dtype`` canvas; the plain PillarFeatureNet runs in
    ``dtype``. The folded PFN weights are taken once, here."""
    fused = use_fused_frontend(config, use_pallas_pfn, fused_frontend)
    w, b = model.pfn.folded()

    @torch.no_grad()
    def canvas_fn(points, num_points):
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
    computed in ``dtype``. Its two halves stay callable apart, as
    ``.canvas`` (points -> canvas) and ``.wire`` (canvas -> wire tensors),
    so that a caller can time them."""
    canvas_fn = build_canvas_fn(model, config, use_pallas_pfn=use_pallas_pfn,
                                fused_frontend=fused_frontend, dtype=dtype)

    @torch.no_grad()
    def wire_fn(canvas):
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
    once on ``device`` (None: the card, as :func:`resolve_device`).
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
        return postprocess_w(own, box_p, dir_p, anchors_t, anchor_cls_t,
                             config, nms_impl)

    return run_post


def build_forward_fn(model: PointPillars, config: PillarsConfig,
                     use_pallas_pfn: bool = True,
                     fused_frontend: Optional[bool] = None,
                     dtype=torch.float32):
    """f(points (B, M, F), num_points (B,)) -> Detections: stage 1 (in
    ``dtype``) then stage 2 on the model's device."""
    stage1 = build_model_fn(model, config, use_pallas_pfn=use_pallas_pfn,
                            fused_frontend=fused_frontend, dtype=dtype)
    device = next(model.parameters()).device
    stage2 = build_postprocess_fn(config, device)

    def forward(points, num_points) -> Detections:
        return stage2(*stage1(points, num_points))

    return forward


class Detector:
    """Host-facing wrapper: pads clouds to the static budget, runs the
    two stages, converts to Box3D (optionally into the global frame)."""

    def __init__(self, config: PillarsConfig, state_dict: dict,
                 device=None, host_crop: bool = True,
                 wire_buckets: "Optional[tuple]" = None,
                 fused_frontend: Optional[bool] = None,
                 use_pallas_pfn: bool = True, dtype=torch.float32,
                 nms_impl: str = "auto"):
        """state_dict: ``weights.params_from_flax`` output.

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
        self.config = config
        self.device = resolve_device(device)
        self.truncation = TruncationStats()
        self.host_crop = host_crop
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

    def _to_device(self, x, dtype):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    # --- raw (device tensors) ---

    def pad_points(self, points: np.ndarray):
        """Pad/crop to a static (M, F) f32 upload. F is pinned by the
        config; extra columns are dropped, missing ones are an error.
        Clouds beyond the budget keep their FIRST max_points (in-range) rows;
        the drop is counted in self.truncation and warned."""
        cfg = self.config
        f_expect = cfg.num_input_features
        points = np.asarray(points, dtype=np.float32)
        points = points.reshape(-1, points.shape[-1] if points.size
                                else f_expect)
        if points.shape[1] < f_expect:
            raise ValueError(
                f"points have {points.shape[1]} feature columns; config "
                f"needs {f_expect} (x, y, z, intensity"
                f"{', dt' if cfg.num_sweeps > 1 else ''})")
        if self.host_crop and len(points):
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
        if self.wire_buckets is not None:
            m = next(b for b in self.wire_buckets if b >= n)
        # pad with a finite out-of-range sentinel
        out = np.full((m, f_expect), 1e6, dtype=np.float32)
        out[:n] = points[:n, :f_expect]
        self.truncation.record(len(points), n, label="pad_points")
        return out, np.int32(n)

    def predict_raw_batch(self, points_batch, num_points) -> Detections:
        """points_batch (B, M, F) already padded; num_points (B,)."""
        points = self._to_device(points_batch, torch.float32)
        counts = self._to_device(num_points, torch.int64)
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
