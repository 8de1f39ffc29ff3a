"""``offline``: offline scoring, a closed loop at static batch ``batch``
with two batches in flight. The host pads batch k+1
(``Detector.pad_points``) and launches it (``predict_packed_batch``)
before it downloads batch k and turns it into boxes
(``packed_to_boxes``). The metric is ``sweeps_per_s``: the sweeps whose
boxes were in hand during the window, over its seconds.

Weights: the configuration's ``weights.checkpoint``, a flax checkpoint in
the repository, read by the benchmark's own reader and handed to the
program and to the reference alike. The answers of ``compare`` sampled
inputs (and the largest) are kept each time one is served in the window,
and judged against the reference's detections of the same clouds
(``judge.compare_detections``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from pillarbench import judge
from pillarbench.inputs import make_pool
from pillarbench.program import options, program_config
from pillarbench.reference.config import RefConfig
from pillarbench.reference.msgpack import load_flax_tree
from pillarbench.roofline.counts import mean_counts
from pillarbench.session import (
    Window, free, profiled_seconds, sample, sync,
)
from pillarbench.trace import DeviceProfile, Spans, label

WARM_S = 1.0


class Loop:
    def __init__(self, cell, args, device, root, split):
        from tpu_pillars_torch.detector import Detector
        from tpu_pillars_torch.weights import params_from_flax

        self.cell, self.device, self.seed = cell, device, args.seed
        self.traffic = t = cell.traffic
        fields = cell.config["config"]
        self.rcfg = RefConfig(fields)
        at = time.perf_counter()
        tree = load_flax_tree(str(root / cell.config["weights"]
                                  ["checkpoint"]))
        self.tree = {"params": tree["params"],
                     "batch_stats": tree["batch_stats"]}
        pcfg = program_config(fields)
        self.det = Detector(pcfg, params_from_flax(self.tree, pcfg),
                            device=device, **options(cell.config))
        split["weights"] = time.perf_counter() - at
        at = time.perf_counter()
        self.pool = make_pool(t, fields, args.seed, cell.home)
        self.keep = sample(self.pool, t["compare"], args.seed)
        order = np.random.default_rng([args.seed, 4]).permutation(
            len(self.pool))
        self.order = itertools.cycle([int(i) for i in order])
        self.names = [c["name"] for c in fields["classes"]]
        self.answers = {i: [] for i in self.keep}
        split["pool"] = time.perf_counter() - at
        self.split = split

    # ---- the pipeline

    def _next(self):
        return [next(self.order) for _ in range(self.traffic["batch"])]

    def _pad(self, idx):
        padded = [self.det.pad_points(self.pool[i]) for i in idx]
        return (np.stack([p for p, _ in padded]),
                np.asarray([n for _, n in padded], np.int32))

    def _record(self, idx, boxes):
        for i, b in zip(idx, boxes):
            if i in self.keep:
                self.answers[i].append(judge.boxes_to_arrays(b, self.names))

    def run(self, t_end: float, count_from: float = 0.0) -> int:
        """Until ``t_end``: returns the sweeps whose boxes were in hand at a
        time in [count_from, t_end]."""
        from tpu_pillars_torch.detector import packed_to_boxes

        det, cfg, batch = self.det, self.det.config, self.traffic["batch"]
        done = 0
        idx = self._next()
        with label("pad"):
            pts, n = self._pad(idx)
        with label("launch"):
            out = det.predict_packed_batch(pts, n)
        while True:
            nxt = self._next()
            with label("pad"):
                pts, n = self._pad(nxt)
            with label("launch"):
                nxt_out = det.predict_packed_batch(pts, n)
            with label("download"):
                host = out.cpu().numpy()
                boxes = [packed_to_boxes(host[b], cfg) for b in range(batch)]
            now = time.perf_counter()
            if now > t_end:
                break
            if now >= count_from:
                done += batch
                self._record(idx, boxes)
            idx, out = nxt, nxt_out
        nxt_out.cpu()
        return done

    def run_spans(self, t_end: float, spans: Spans) -> int:
        """The same batches, stage by stage, each device stage in a
        synchronised span: pad, upload (with dequant), frontend
        (``Detector.canvas``), rpn_head (``wire``), postprocess, download."""
        from tpu_pillars_torch.detector import (
            pack_detections, packed_to_boxes,
        )

        det, cfg, batch = self.det, self.det.config, self.traffic["batch"]
        done = 0
        while time.perf_counter() < t_end:
            idx = self._next()
            with spans.span("pad"):
                pts, n = self._pad(idx)
            with spans.span("upload", sync=True):
                points = det.dequant(det.upload(pts))
                counts = det.upload(n).long()
            with spans.span("frontend", sync=True):
                canvas = det.canvas(points, counts)
            with spans.span("rpn_head", sync=True):
                wire = det.wire(canvas)
            with spans.span("postprocess", sync=True):
                dets = det.postprocess(*wire)
            with spans.span("download"):
                host = pack_detections(dets).cpu().numpy()
                boxes = [packed_to_boxes(host[b], cfg) for b in range(batch)]
            done += batch
            self._record(idx, boxes)
        return done

    # ---- the run

    def measure(self, seconds: float, trace: bool) -> Window:
        at = time.perf_counter()
        for _ in range(2):
            self.run(time.perf_counter() + WARM_S)
        sync(self.device)
        self.answers = {i: [] for i in self.keep}
        self.det.truncation.reset()
        self.split["warm_up"] = time.perf_counter() - at
        t0 = time.perf_counter()
        if not trace:
            done = self.run(t0 + seconds, count_from=t0)
            return Window(t0, {"sweeps_per_s": done / seconds}, done)
        a = profiled_seconds(seconds)
        prof = DeviceProfile().start()
        profiled = self.run(time.perf_counter() + a)
        prof.stop()
        spans = Spans()
        done = profiled + self.run_spans(
            time.perf_counter() + seconds - a, spans)
        return Window(t0, {}, done, profile=prof, profiled_items=profiled,
                      spans=spans)

    def lines(self) -> list:
        tr = self.det.truncation
        return [f"truncation: {tr.truncated_clouds} of {tr.clouds} clouds "
                f"truncated in the window, {tr.dropped_points} points "
                f"dropped"]

    def input_counts(self) -> dict:
        return mean_counts(self.pool, self.rcfg)

    def judge(self):
        from pillarbench.reference.detect import ReferenceDetector

        answers = self.answers
        del self.det
        free()
        at = time.perf_counter()
        ref = ReferenceDetector(self.rcfg, self.tree, self.device,
                                batch=self.traffic["batch"])
        idx = sorted(answers)
        want = ref.detect([self.pool[i] for i in idx])
        numbers = judge.compare_detections(answers, dict(zip(idx, want)),
                                           self.cell.config["config"])
        if numbers["compared"] == 0:
            numbers["det_gap"] = float("inf")
        return numbers, [
            f"reference: {len(idx)} clouds in {time.perf_counter() - at:.1f}"
            f" s; {numbers['compared']} served answers compared; "
            f"detections on one side only: {numbers['borderline']} "
            f"explained by a decision within rounding, a share "
            f"{numbers['unmatched']!r} not"]

    def controls(self, seconds: float) -> dict:
        """The control, on the sampled clouds: the reference in TF32 in
        the program's place, against the reference in float32. The
        program is not run."""
        from pillarbench.reference.detect import ReferenceDetector

        del self.det
        free()
        idx = sorted(self.keep)
        clouds = [self.pool[i] for i in idx]
        want = ReferenceDetector(self.rcfg, self.tree, self.device).detect(
            clouds)
        low = ReferenceDetector(self.rcfg, self.tree, self.device,
                                allow_tf32=True).detect(clouds)
        answers = {i: [(np.asarray(d.boxes, np.float64),
                        np.asarray(d.scores, np.float64),
                        np.asarray(d.classes))] for i, d in zip(idx, low)}
        return {"control": judge.compare_detections(
            answers, dict(zip(idx, want)), self.cell.config["config"])}

