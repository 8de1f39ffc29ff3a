"""Small Lyft-format dataset writer — copy of ``tpu_pillars/data/fixture.py``
(same draws from the same generator, so one seed gives both packages the
same files): a few scenes of a few samples in the exact table layout
``data.lyft.LyftDataset`` reads, with synthetic clouds rendered from the
planted GT boxes (``data.synthetic.make_scene``), so a trained detector can
find them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.data.synthetic import make_scene
from tpu_pillars_torch.geometry.quaternion import (
    quat_from_yaw, quat_multiply, quat_rotate,
)
from tpu_pillars_torch.geometry.transforms import (
    Pose, compose, inverse, transform_points,
)


def build_fixture(root: str, config: PillarsConfig,
                  num_scenes: int = 2, samples_per_scene: int = 3,
                  sweeps_per_sample: int = 2, seed: int = 0,
                  num_objects: int = 5, points_per_object: int = 150,
                  clutter: int = 1500) -> str:
    """Writes JSON tables under root/data/ and lidar .bin files under
    root/lidar/. Returns the json dir path.

    Density knobs (num_objects / points_per_object / clutter, forwarded to
    data.synthetic.make_scene) default to the tiny test-fixture scale; the
    1000-sample dress-rehearsal dataset (scripts/rehearsal_dataset.py)
    raises them toward realistic sweep sizes."""
    rng = np.random.default_rng(seed)
    json_dir = os.path.join(root, "data")
    lidar_dir = os.path.join(root, "lidar")
    os.makedirs(json_dir, exist_ok=True)
    os.makedirs(lidar_dir, exist_ok=True)

    tables: Dict[str, List[dict]] = {n: [] for n in (
        "scene", "sample", "sample_data", "sample_annotation",
        "ego_pose", "calibrated_sensor", "category", "instance", "sensor",
    )}

    cats = {}
    for ci, spec in enumerate(config.classes):
        tok = f"cat_{spec.name}"
        cats[ci] = tok
        tables["category"].append({"token": tok, "name": spec.name})

    tables["sensor"].append(
        {"token": "sensor_lidar", "channel": "LIDAR_TOP", "modality": "lidar"})

    # one calibrated sensor: lidar mounted with a small yaw + offset
    cal_q = quat_from_yaw(0.05)
    tables["calibrated_sensor"].append({
        "token": "cal_lidar", "sensor_token": "sensor_lidar",
        "rotation": list(cal_q), "translation": [1.0, 0.2, 1.8],
    })

    ts = 1_500_000_000_000_000  # microseconds
    for si in range(num_scenes):
        scene_tok = f"scene_{si}"
        sample_toks = [f"sample_{si}_{k}" for k in range(samples_per_scene)]
        tables["scene"].append({
            "token": scene_tok, "name": scene_tok,
            "first_sample_token": sample_toks[0],
            "last_sample_token": sample_toks[-1],
            "nbr_samples": samples_per_scene,
        })
        prev_sd_tok = ""
        for k, stok in enumerate(sample_toks):
            tables["sample"].append({
                "token": stok, "scene_token": scene_tok,
                "timestamp": ts,
                "prev": sample_toks[k - 1] if k else "",
                "next": sample_toks[k + 1] if k + 1 < samples_per_scene else "",
            })
            # ego drives forward in global frame
            ego_xy = np.array([120.0 + 8.0 * k + 40 * si, 300.0 + 2.0 * k])
            ego_yaw = 0.15 * k
            scene = make_scene(rng, config, num_objects=num_objects,
                               points_per_object=points_per_object,
                               clutter=clutter)
            cal_pose = Pose(np.asarray(cal_q), np.array([1.0, 0.2, 1.8]))
            key_l2g = compose(
                Pose(np.asarray(quat_from_yaw(ego_yaw)),
                     np.array([ego_xy[0], ego_xy[1], 0.0])), cal_pose)
            # sweeps: keyframe + (sweeps-1) earlier non-key sweeps
            for sw in range(sweeps_per_sample):
                sd_tok = f"sd_{stok}_{sw}"
                ego_tok = f"ego_{sd_tok}"
                sweep_xy = ego_xy - sw * np.array([1.5, 0.1])
                q = quat_from_yaw(ego_yaw)
                tables["ego_pose"].append({
                    "token": ego_tok, "timestamp": ts - sw * 100_000,
                    "rotation": list(q),
                    "translation": [sweep_xy[0], sweep_xy[1], 0.0],
                })
                fname = f"lidar/{sd_tok}.bin"
                # static world: express the scene (authored in the KEYFRAME
                # lidar frame) in THIS sweep's own lidar frame
                sweep_l2g = compose(
                    Pose(np.asarray(q),
                         np.array([sweep_xy[0], sweep_xy[1], 0.0])), cal_pose)
                pts = transform_points(
                    compose(inverse(sweep_l2g), key_l2g), scene.points.copy()
                ).astype(np.float32)
                if sw:
                    pts[:, :3] += rng.normal(0, 0.02, (len(pts), 3)).astype(np.float32)
                ring = rng.integers(0, 64, (len(pts), 1)).astype(np.float32)
                full = np.concatenate([pts, ring], axis=1)  # x,y,z,i,ring
                full.astype(np.float32).tofile(os.path.join(root, fname))
                tables["sample_data"].append({
                    "token": sd_tok, "sample_token": stok,
                    "ego_pose_token": ego_tok,
                    "calibrated_sensor_token": "cal_lidar",
                    "filename": fname, "fileformat": "bin",
                    "is_key_frame": sw == 0,
                    "timestamp": ts - sw * 100_000,
                    "prev": f"sd_{stok}_{sw + 1}" if sw + 1 < sweeps_per_sample else prev_sd_tok,
                    "next": "",
                    "channel": "LIDAR_TOP",
                })
            prev_sd_tok = f"sd_{stok}_0"

            # annotations: keyframe-lidar-frame GT -> global frame records
            l2g = key_l2g
            for bi, (b, c) in enumerate(zip(scene.gt_boxes, scene.gt_classes)):
                center = quat_rotate(l2g.rotation, b[:3]) + l2g.translation
                q_g = quat_multiply(l2g.rotation, quat_from_yaw(float(b[6])))
                inst_tok = f"inst_{stok}_{bi}"
                tables["instance"].append({
                    "token": inst_tok, "category_token": cats[int(c)],
                })
                tables["sample_annotation"].append({
                    "token": f"ann_{stok}_{bi}", "sample_token": stok,
                    "instance_token": inst_tok,
                    "translation": [float(x) for x in center],
                    "size": [float(b[3]), float(b[4]), float(b[5])],
                    "rotation": [float(x) for x in q_g],
                })
            ts += 500_000

    for name, records in tables.items():
        with open(os.path.join(json_dir, f"{name}.json"), "w") as f:
            json.dump(records, f)
    return json_dir
