"""The CPU reference detector: the reference repo's operating mode — host
numpy pillarization, a torch-CPU PointPillars forward, numpy decode and
rotated NMS — copied from ``tpu_pillars/reference_cpu``. It has two roles,
as in the JAX package:

1. **The oracle**: the port's ``Detector`` is held against it on the same
   weights (the bit-for-boxes contract, ``tests/test_torch_reference_cpu.py``).
2. **The baseline**: ``chip_smoke.py`` times it on the host and divides the
   card's sweeps/s by its sweeps/s (the north star's "vs CPU reference").

It runs on the CPU by definition and takes no device. No serving path of
the card calls it: it is not a fallback. ``convert.torch_to_flax`` also
carries weights trained in its torch layout into the port
(``Detector.from_torch``). The float64 rotated IoU of ``postprocess`` is
what the evaluation scores with.
"""

from tpu_pillars_torch.reference_cpu.pillarizer import pillarize_np
from tpu_pillars_torch.reference_cpu.postprocess import (
    decode_boxes_np, rotated_iou_bev_np, rotated_nms_np,
)
from tpu_pillars_torch.reference_cpu.pipeline import CPUReferenceDetector

__all__ = [
    "pillarize_np", "decode_boxes_np", "rotated_nms_np", "rotated_iou_bev_np",
    "CPUReferenceDetector",
]
