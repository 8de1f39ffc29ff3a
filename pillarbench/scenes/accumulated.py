"""``accumulated``: multi-sweep clouds as a nuScenes-style lidar gives them
to a detector, ``sweeps`` sweeps ``interval_s`` apart (nuScenes' lidar
turns at 20 Hz) moved into the newest sweep's frame, the sweep's age as
a fifth column (dt, s). The ego drives straight at a speed drawn from
``ego_speed`` (m/s); ``objects`` boxes of the configuration's tasks'
classes, at their classes' mean sizes (x U(0.9, 1.1)), stand or drive
(vehicles and riders up to 10 m/s along their heading, people 1.5 m/s,
barriers and cones still), so a moving box smears over the sweeps.

Each sweep has a point count from ``sweep_points`` [lo, hi]: 3/4 ground
returns on the 24 rings that a 32-beam lidar's downward beams draw around
the sensor where it was at that sweep (as many points a ring, so their
density falls with range), 1/4 on the boxes where they were then.
Columns [x, y, z, intensity, dt], newest sweep first. The sweep sizes of
every seed are the same set (spread evenly over the range) in another
order. The generator is numpy alone.

Parameters: ``pool`` clouds, ``sweeps``, ``interval_s``, ``sweep_points``,
``ego_speed``, ``objects``.
"""

from __future__ import annotations

import numpy as np

GROUND_Z = -1.8
# the ground rings of a 32-beam lidar 1.8 m up: the beams below the
# horizon, -30 to -1.5 degrees, hit the ground at these ranges (m)
RINGS = 1.8 / np.tan(np.radians(np.linspace(30.0, 1.5, 24)))
STILL = {"barrier", "traffic_cone"}
WALKING = {"pedestrian"}


def _classes(cfg: dict):
    """(names, sizes (n, 3) as (w, l, h))."""
    names, sizes = [], []
    for task in cfg["tasks"]:
        names += list(task["classes"])
        sizes += [list(s) for s in task["sizes"]]
    return names, np.asarray(sizes, np.float64)


def _objects(rng, cfg: dict, n: int):
    """Boxes now, in the newest frame: (centre (n, 3), size (n, 3) w l h,
    yaw (n,), velocity (n, 2))."""
    names, sizes = _classes(cfg)
    which = rng.integers(0, len(names), n)
    size = sizes[which] * rng.uniform(0.9, 1.1, (n, 1))
    r = rng.uniform(3.0, 48.0, n)
    th = rng.uniform(-np.pi, np.pi, n)
    ctr = np.stack([r * np.cos(th), r * np.sin(th),
                    GROUND_Z + size[:, 2] / 2], axis=1)
    yaw = rng.uniform(-np.pi, np.pi, n)
    top = np.array([0.0 if names[c] in STILL else
                    1.5 if names[c] in WALKING else 10.0 for c in which])
    speed = rng.uniform(0.0, 1.0, n) * top
    vel = np.stack([speed * np.cos(yaw), speed * np.sin(yaw)], axis=1)
    return ctr, size, yaw, vel


def _sweep(rng, n: int, origin, objects, age: float) -> np.ndarray:
    """One sweep of ``n`` points in the newest frame, ``age`` s old."""
    ctr, size, yaw, vel = objects
    n_obj = n // 4
    n_ground = n - n_obj
    ring = rng.integers(0, len(RINGS), n_ground)
    r = RINGS[ring] * (1.0 + rng.normal(0.0, 0.01, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([origin[0] + r * np.cos(th),
                       origin[1] + r * np.sin(th),
                       rng.normal(GROUND_Z, 0.05, n_ground)], axis=1)
    which = rng.integers(0, len(ctr), n_obj)
    local = rng.uniform(-0.5, 0.5, (n_obj, 3)) * size[which][:, [1, 0, 2]]
    c, s = np.cos(yaw[which]), np.sin(yaw[which])
    then = ctr[which, :2] - vel[which] * age
    obj = np.stack([then[:, 0] + c * local[:, 0] - s * local[:, 1],
                    then[:, 1] + s * local[:, 0] + c * local[:, 1],
                    ctr[which, 2] + local[:, 2]], axis=1)
    out = np.empty((n, 5), np.float32)
    out[:, :3] = np.concatenate([ground, obj])
    out[:, 3] = rng.uniform(0.0, 1.0, n)
    out[:, 4] = age
    return out


def accumulated_cloud(rng, cfg: dict, sizes, interval_s: float,
                      ego_speed, objects: int) -> np.ndarray:
    """One cloud of ``len(sizes)`` sweeps, newest first: (n, 5) f32."""
    speed = rng.uniform(*ego_speed)
    heading = rng.uniform(-np.pi, np.pi)
    step = speed * np.array([np.cos(heading), np.sin(heading)])
    objs = _objects(rng, cfg, objects)
    sweeps = []
    for k, n in enumerate(sizes):
        age = k * interval_s
        sweeps.append(_sweep(rng, int(n), -step * age, objs, age))
    return np.concatenate(sweeps)


def make(traffic: dict, cfg: dict, rng) -> list:
    from pillarbench.inputs import spread

    pool, k = traffic["pool"], traffic["sweeps"]
    sizes = np.round(spread(*traffic["sweep_points"], pool * k, rng)
                     ).astype(np.int64).reshape(pool, k)
    return [accumulated_cloud(rng, cfg, s, traffic["interval_s"],
                              traffic["ego_speed"], traffic["objects"])
            for s in sizes]
