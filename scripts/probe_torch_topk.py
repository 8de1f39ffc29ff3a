#!/usr/bin/env python3
"""The candidate selection of ``ops.postprocess`` on one NVIDIA card:
``top_k_stable`` (a stable descending sort of every anchor, the first k
kept) against a two-stage selection (the anchors cut into ``rows`` rows,
each row's k best by a stable sort, then the k best of the survivors), at
the serving batch's shapes.

    python3 scripts/probe_torch_topk.py [--iters 20]

Inputs, as ``chip_smoke.py`` phase 3f makes them: the thresholded own-class
scores of the anchor-major eval forward (``train.step.make_eval_forward``
on the committed trained checkpoint, classic front end) on the serving
batch (8 lidar-like sweeps of 100,000 points, seed 0): (8, 720,000)
scores -> the config's 1,024 candidates. Both selections must give the same
values and indices (the lowest-index tie rule of ``lax.top_k``); each is
timed with CUDA events (median of 5 repeats of ``--iters`` calls). The
two-stage selection is ``ops.postprocess.top_k_two_stage``, which the
postprocess does not use: it keeps the sort.
Prints the card (name and power limit) and, last, one JSON line. Needs a
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_torch_topk: needs a CUDA card")
    import chip_smoke as cs
    from tpu_pillars_torch import _build
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.ops.anchors import make_anchors
    from tpu_pillars_torch.ops.postprocess import (
        top_k_stable, top_k_two_stage,
    )
    from tpu_pillars_torch.train.step import make_eval_forward

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    _build.build_all()
    cfg = PillarsConfig()
    dev = torch.device("cuda")
    det = Detector.from_checkpoint(cfg, cs.CKPT, fused_frontend=False,
                                   use_pallas_pfn=False)
    clouds = cs.lidar_batch(np.random.default_rng(cs.SEED), cfg, cs.BATCH,
                            cs.POINTS_PER_SWEEP)
    padded = [det.pad_points(c) for c in clouds]
    points = torch.from_numpy(np.stack([q for q, _ in padded])).to(dev)
    counts = torch.from_numpy(np.asarray([n for _, n in padded])).to(dev)
    _, anchor_cls = make_anchors(cfg)
    anchor_cls = torch.from_numpy(np.array(anchor_cls, np.int64)).to(dev)
    with torch.no_grad():
        out = make_eval_forward(cfg)(det.model, points, counts)
    # the thresholded own-class scores of postprocess._top_candidates
    own = torch.gather(out.cls_logits, 2, anchor_cls[None, :, None]
                       .expand(cs.BATCH, -1, 1))[..., 0]
    thr = torch.tensor([c.score_threshold for c in cfg.classes],
                       device=dev)[anchor_cls]
    scores = torch.sigmoid(own)
    masked = torch.where(scores >= thr, scores, -1.0)
    k = cfg.pre_nms_top_k
    res = {"card": card, "shape": list(masked.shape), "k": k,
           "ties_at_1": int((masked == 1.0).sum())}
    v1, i1 = top_k_stable(masked, k)
    res["stable_ms"] = cs.cuda_ms(lambda: top_k_stable(masked, k),
                                  args.iters)
    for rows in (32, 64, 128):
        v2, i2 = top_k_two_stage(masked, k, rows)
        if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
            sys.exit(f"probe_torch_topk: two-stage rows {rows} differs "
                     f"from top_k_stable")
        res[f"two_stage_rows{rows}_ms"] = cs.cuda_ms(
            lambda: top_k_two_stage(masked, k, rows), args.iters)
    print(f"top-k {tuple(masked.shape)} -> {k}: equal results; "
          + ", ".join(f"{key} {val:.4f}" for key, val in res.items()
                      if key.endswith("_ms")))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
