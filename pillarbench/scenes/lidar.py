"""``lidar``: single sweeps, ground returns whose density falls with range
plus box-shaped objects (the port's smoke test's sweeps). Parameters:
``pool`` sweeps of ``points`` [lo, hi] points, the sizes spread evenly
over the range."""

from __future__ import annotations

import numpy as np

from pillarbench.inputs import spread


def lidar_objects(rng, n_obj: int = 50):
    """Car-sized boxes within 60 m: (centres (n, 2), sizes (n, 3))."""
    ctr = rng.uniform(-60.0, 60.0, (n_obj, 2))
    size = rng.uniform([1.5, 3.5, 1.4], [2.5, 6.0, 2.0], (n_obj, 3))
    return ctr, size


def lidar_sweep(rng, n: int) -> np.ndarray:
    """(n, 4) f32 [x, y, z, intensity]: 3/4 ground returns at log-uniform
    range 2-80 m, 1/4 on 50 drawn objects."""
    n_obj_pts = n // 4
    n_ground = n - n_obj_pts
    r = np.exp(rng.uniform(np.log(2.0), np.log(80.0), n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(-1.7, 0.05, n_ground)], axis=1)
    ctr, size = lidar_objects(rng)
    which = rng.integers(0, len(ctr), n_obj_pts)
    local = rng.uniform(-0.5, 0.5, (n_obj_pts, 3)) * size[which]
    obj = np.stack([ctr[which, 0] + local[:, 0], ctr[which, 1] + local[:, 1],
                    -1.0 + local[:, 2]], axis=1)
    out = np.empty((n, 4), np.float32)
    out[:, :3] = np.concatenate([ground, obj])
    out[:, 3] = rng.uniform(0.0, 1.0, n)
    return out


def make(traffic: dict, cfg: dict, rng) -> list:
    sizes = spread(*traffic["points"], traffic["pool"], rng)
    return [lidar_sweep(rng, int(round(n))) for n in sizes]
