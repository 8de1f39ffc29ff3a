"""tpu_pillars_torch — the PyTorch/CUDA port of tpu_pillars.

A PointPillars lidar detector served and trained on an NVIDIA H100, and
CenterPoint-PP served beside it (``CenterPointConfig``): raw point cloud ->
``List[Box3D]`` through hand-written CUDA kernels (``csrc/``)
for the front end (sort, pillar emit or binning, PFN, BEV scatter or
gather), the NMS overlap matrix and the target assigner. The JAX package
``tpu_pillars`` stays the reference; this package imports nothing of it.

Entry point: ``Detector`` (``Detector.from_checkpoint`` loads the JAX
package's flax checkpoints). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from tpu_pillars_torch.config import (
    LYFT_CLASSES, CenterPointConfig, ClassSpec, PillarsConfig,
    car_only_config, centerpoint_pp_config, multisweep_config, tiny_config,
)
from tpu_pillars_torch.detector import Detector, packed_to_boxes
from tpu_pillars_torch.geometry.boxes import Box3D

__all__ = ["ClassSpec", "LYFT_CLASSES", "PillarsConfig", "car_only_config",
           "multisweep_config", "tiny_config", "CenterPointConfig",
           "centerpoint_pp_config", "Box3D", "Detector", "packed_to_boxes"]
