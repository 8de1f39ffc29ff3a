"""``offline_center``: offline scoring with CenterPoint-PP, the pipeline of
``loops/offline.py`` (a closed loop at static batch ``batch``, two batches
in flight: pad batch k+1, launch it, download batch k and turn it into
boxes) on accumulated multi-sweep clouds. The metric is ``sweeps_per_s``:
the clouds whose boxes were in hand during the window, over its seconds.

Weights: drawn from ``--seed`` on the card by the configuration's shapes,
their BatchNorms calibrated on 8 clouds of the pool
(``center_weights.seeded_state``), and handed to the program and to the
reference alike. The answers of ``compare`` sampled clouds (and the
largest) are kept each time one is served in the window and judged
against the reference's detections (``judge_center.compare_center``:
``det_gap``); after the window the program's own ``wire`` gives the dense
head maps of those clouds at the cell's batch, judged against the
reference's maps (``map_gap``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from pillarbench import judge_center
from pillarbench.center_weights import ref_config, seeded_state
from pillarbench.inputs import make_pool
from pillarbench.loops.offline import Loop as Offline
from pillarbench.roofline.centerpoint import mean_counts
from pillarbench.session import free, sample

CALIBRATION_CLOUDS = 8


def program_config(fields: dict):
    """The config file's ``config`` -> the port's ``CenterPointConfig``."""
    from tpu_pillars_torch.config import CenterPointConfig, CenterTask

    kw = dict(fields)
    kw["tasks"] = tuple(CenterTask(tuple(t["classes"]),
                                   tuple(tuple(s) for s in t["sizes"]))
                        for t in fields["tasks"])
    kw["common_heads"] = tuple(tuple(h) for h in fields["common_heads"])
    for key in ("pfn_channels", "rpn_channels", "rpn_layers",
                "rpn_up_strides"):
        kw[key] = tuple(kw[key])
    return CenterPointConfig(**kw)


class Loop(Offline):
    def __init__(self, cell, args, device, root, split):
        from tpu_pillars_torch.detector import Detector

        self.cell, self.device, self.seed = cell, device, args.seed
        self.traffic = t = cell.traffic
        self.fields = fields = cell.config["config"]
        self.rcfg = ref_config(fields)
        pcfg = program_config(fields)
        at = time.perf_counter()
        self.pool = make_pool(t, fields, args.seed, cell.home)
        split["pool"] = time.perf_counter() - at
        at = time.perf_counter()
        self.weights = seeded_state(fields, args.seed,
                                    self.pool[:CALIBRATION_CLOUDS], device)
        self.det = Detector(pcfg, self.weights, device=device)
        split["weights"] = time.perf_counter() - at
        self.keep = sample(self.pool, t["compare"], args.seed)
        order = np.random.default_rng([args.seed, 4]).permutation(
            len(self.pool))
        self.order = itertools.cycle([int(i) for i in order])
        self.names = list(self.det.config.class_names)
        self.answers = {i: [] for i in self.keep}
        self.split = split

    def _record(self, idx, boxes):
        index = {n: k for k, n in enumerate(self.names)}
        for i, bs in zip(idx, boxes):
            if i not in self.keep:
                continue
            if not bs:
                arr = np.zeros((0, 9))
            else:
                arr = np.concatenate([
                    np.stack([b.center for b in bs]),
                    np.stack([b.wlh for b in bs]),
                    np.array([[b.yaw] for b in bs]),
                    np.stack([b.velocity for b in bs])], axis=1)
            self.answers[i].append(
                (arr, np.array([b.score for b in bs], np.float64),
                 np.array([index[b.label] for b in bs], np.int64)))

    def input_counts(self) -> dict:
        return mean_counts(self.pool, self.rcfg)

    def _program_maps(self, clouds):
        """The program's dense maps of ``clouds`` (host), batch by batch
        at the cell's batch (the last batch filled with its last cloud)."""
        det, batch = self.det, self.traffic["batch"]
        out = []
        for at in range(0, len(clouds), batch):
            chunk = list(clouds[at:at + batch])
            real = len(chunk)
            chunk += [chunk[-1]] * (batch - real)
            padded = [det.pad_points(c) for c in chunk]
            with torch.no_grad():
                points = det.dequant(det.upload(np.stack(
                    [p for p, _ in padded])))
                counts = det.upload(np.asarray(
                    [n for _, n in padded], np.int32)).long()
                maps, = det.wire(det.canvas(points, counts))
            out.append(maps[:real].cpu().numpy())
        return np.concatenate(out)

    def _reference(self, clouds, allow_tf32: bool = False):
        """(the reference's maps (host), its detections) of ``clouds``."""
        from pillarbench.reference.centerpoint import (
            ReferenceCenterPoint, decode, postprocess,
        )

        ref = ReferenceCenterPoint(self.rcfg, self.weights, self.device,
                                   batch=self.traffic["batch"],
                                   allow_tf32=allow_tf32)
        maps, dets = [], []
        for at in range(0, len(clouds), ref.batch):
            m = ref.maps(clouds[at:at + ref.batch])
            dets += [postprocess(c, self.rcfg) for c in decode(m, self.rcfg)]
            maps.append(m.cpu().numpy())
        return np.concatenate(maps), dets

    def judge(self):
        answers = self.answers
        idx = sorted(answers)
        clouds = [self.pool[i] for i in idx]
        prog_maps = self._program_maps(clouds)
        del self.det
        free()
        at = time.perf_counter()
        ref_maps, want = self._reference(clouds)
        numbers = judge_center.compare_center(
            answers, dict(zip(idx, want)), self.fields)
        numbers["map_gap"] = judge_center.map_gap(prog_maps, ref_maps)
        if numbers["compared"] == 0:
            numbers["det_gap"] = float("inf")
        return numbers, [
            f"reference: {len(idx)} clouds in {time.perf_counter() - at:.1f}"
            f" s; {numbers['compared']} served answers compared; "
            f"detections on one side only: {numbers['borderline']} "
            f"explained by a decision within rounding, a share "
            f"{numbers['unmatched']!r} not; det_gap set by "
            f"{numbers['widest']}; map_gap {numbers['map_gap']!r}"]

    def controls(self, seconds: float) -> dict:
        """The control, on the sampled clouds: the reference in TF32 in
        the program's place, against the reference in float32. The
        program is not run."""
        del self.det
        free()
        idx = sorted(self.keep)
        clouds = [self.pool[i] for i in idx]
        want_maps, want = self._reference(clouds)
        low_maps, low = self._reference(clouds, allow_tf32=True)
        answers = {i: [(np.asarray(d.boxes, np.float64),
                        np.asarray(d.scores, np.float64),
                        np.asarray(d.classes))] for i, d in zip(idx, low)}
        numbers = judge_center.compare_center(answers, dict(zip(idx, want)),
                                              self.fields)
        numbers["map_gap"] = judge_center.map_gap(low_maps, want_maps)
        del numbers["widest"]
        return {"control": numbers}
