#!/usr/bin/env python
"""Why the port's own targets differ from the JAX package's on the
training golden batch, on the CPU at the full ``PillarsConfig()``.

    JAX_PLATFORMS=cpu python scripts/probe_torch_train_golden_ties.py

1. Runs the forward pieces of one training step in both packages from the
   trained checkpoint on the golden batch of
   ``tests/data/torch_train_golden_synth4k.npz`` (fused PFN with batch
   statistics, scatter, batch-statistics RPN, feature-major head) and
   prints the largest difference of each.
2. Compares the port's targets with the JAX dense and windowed
   assigners' and, for each anchor where they differ, prints the IoU of
   that anchor with its class's GT in float64 and float32.
3. Draws ``--draws`` scene pairs from generator seed 7200 and prints, for
   each, the smallest gap between a force-matched GT's best and runner-up
   anchor IoU (dense JAX assigner): a gap of ~0 is a tie that rounding
   breaks.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--draws", type=int, default=10)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tpu_pillars.config import PillarsConfig as JaxConfig
    from tpu_pillars.data.synthetic import make_scene, scenes_to_train_batch
    from tpu_pillars.models.head import feature_major_head
    from tpu_pillars.models.pointpillars import PointPillars as JaxModel
    from tpu_pillars.ops.anchors import make_anchors as jax_anchors
    from tpu_pillars.ops.assign_pallas import make_windowed_assigner as jwin
    from tpu_pillars.ops.fused_pfn import (
        emit_centered_table, pfn_train_from_table,
    )
    from tpu_pillars.ops.iou import rotated_iou_bev_colchunked
    from tpu_pillars.ops.target_assigner import (
        group_gt_by_class, make_classwise_assigner,
    )
    from tpu_pillars.ops.voxelize import scatter_to_bev
    from tpu_pillars_torch.config import PillarsConfig
    from tpu_pillars_torch.models.pointpillars import PointPillars
    from tpu_pillars_torch.ops import bev, fused_pfn
    from tpu_pillars_torch.ops.anchors import make_anchors
    from tpu_pillars_torch.ops.assign import make_windowed_assigner
    from tpu_pillars_torch.ops.iou import rotated_iou_bev
    from tpu_pillars_torch.weights import load_flax_msgpack, params_from_flax

    cfg, jcfg = PillarsConfig(), JaxConfig()
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "torch_train_golden_synth4k.npz"))
    offs = g["offsets"]
    B = len(offs) - 1
    pts = np.full((B, cfg.max_points, 4), 1e6, np.float32)
    n = np.zeros(B, np.int32)
    for s in range(B):
        c = g["points"][offs[s]:offs[s + 1]]
        pts[s, :len(c)] = c
        n[s] = len(c)
    tree = load_flax_msgpack(os.path.join(
        ROOT, "artifacts", "pointpillars_synth4k.msgpack"))
    v = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    jv = jax.tree.map(jnp.asarray, v)
    pfn = v["params"]["pfn"]
    P = cfg.max_pillars

    # 1. forward pieces
    jt, jm = emit_centered_table(jnp.asarray(pts), jnp.asarray(n), jcfg)
    jf, jpid, jcnt, _, _ = pfn_train_from_table(
        jt, jm, *(jnp.asarray(x) for x in (pfn["linear"]["kernel"],
                                           pfn["bn"]["scale"],
                                           pfn["bn"]["bias"])), jcfg)
    jf, jpid, jcnt = jf[:, :P], jpid[:, :P], jcnt[:, :P]
    t, m = fused_pfn.emit_centered_table(torch.from_numpy(pts),
                                         torch.from_numpy(n), cfg)
    f, pid, cnt, _, _ = fused_pfn.pfn_train_from_table(
        t, m, *(torch.from_numpy(x) for x in (pfn["linear"]["kernel"],
                                              pfn["bn"]["scale"],
                                              pfn["bn"]["bias"])), cfg)
    print("pillar features: max |d|",
          float(np.abs(f.numpy() - np.asarray(jf)).max()))
    coords = jnp.stack([jpid // jcfg.grid_w, jpid % jcfg.grid_w], -1)
    jcanvas = scatter_to_bev(jf, coords, jcnt > 0, jcfg)
    canvas = bev.scatter_to_bev(f, pid, cnt > 0, cfg)
    print("canvas: max |d|",
          float(np.abs(canvas.numpy() - np.asarray(jcanvas)).max()))
    jfeat, _ = JaxModel(jcfg, use_running_average=False).apply(
        jv, jcanvas, method=JaxModel.features_from_canvas,
        mutable=["batch_stats"])
    model = PointPillars(cfg)
    model.load_state_dict(params_from_flax(v, cfg))
    with torch.no_grad():
        feat, _ = model.train_features_from_canvas(
            torch.from_numpy(np.asarray(jcanvas)))
        heads = model.head.feature_major(torch.from_numpy(np.asarray(jfeat)))
    print("RPN features (same canvas): max |d|",
          float(np.abs(feat.numpy() - np.asarray(jfeat)).max()))
    jheads = feature_major_head(jv["params"]["head"], jfeat,
                                cfg.num_classes, cfg.anchors_per_loc)
    for name, a, b in zip(("cls", "box", "dir"), heads, jheads):
        print(f"head {name}: max |d|",
              float(np.abs(a.numpy() - np.asarray(b)).max()))

    # 2. targets
    gt = [g["gt_boxes"], g["gt_classes"], g["gt_valid"]]
    port = make_windowed_assigner(cfg)(torch.from_numpy(gt[0]),
                                       torch.from_numpy(gt[1]).long(),
                                       torch.from_numpy(gt[2]))
    port_pos = port.reg_weights.numpy() > 0
    anchors, anchor_cls = make_anchors(cfg)
    for name, assign in (
            ("dense", jax.vmap(make_classwise_assigner(jcfg))),
            ("windowed", jwin(jcfg))):
        jt_ = assign(*(jnp.asarray(x) for x in gt))
        diff = np.argwhere(port_pos != (np.asarray(jt_.reg_weights) > 0))
        print(f"JAX {name} assigner: {len(diff)} anchors differ in pos")
        for b, a in diff:
            cls = anchor_cls[a]
            sel = (gt[1][b] == cls) & gt[2][b]
            box = torch.from_numpy(anchors[a:a + 1])
            gts = torch.from_numpy(gt[0][b][sel])
            i64 = rotated_iou_bev(box.double(), gts.double()).flatten()
            i32 = rotated_iou_bev(box, gts).flatten()
            print(f"  sample {b} anchor {a} class {cls}: port pos "
                  f"{bool(port_pos[b, a])}; IoU with the class's GT, "
                  f"float64 {i64.tolist()}, float32 {i32.tolist()}")

    # 3. how often a force-matched GT ties
    anc = np.asarray(jax_anchors(jcfg)[0])
    C, Y = cfg.num_classes, len(cfg.anchor_yaws)
    HW = cfg.feature_h * cfg.feature_w
    by_class = jnp.asarray(anc.reshape(HW, C, Y, 7).transpose(1, 0, 2, 3)
                           .reshape(C, HW * Y, 7))
    m_thr = jnp.asarray([c.matched_iou for c in cfg.classes])

    def per_class(anc_c, g_c, v_c, mt):
        iou = jnp.where(v_c[:, None],
                        rotated_iou_bev_colchunked(g_c, anc_c), -1.0)
        top = jax.lax.top_k(iou, 2)[0]
        forced = v_c & (top[:, 0] > 0) & (top[:, 0] < mt)
        return jnp.where(forced, top[:, 0] - top[:, 1], jnp.inf).min()

    def gap(boxes, cls, valid):
        gt_c, gv_c = group_gt_by_class(boxes, cls, valid, C, 16)
        return jax.vmap(per_class)(by_class, gt_c, gv_c, m_thr).min()

    gaps = jax.jit(jax.vmap(gap))
    rng = np.random.default_rng(7200)
    for draw in range(args.draws):
        scenes = [make_scene(rng, jcfg) for _ in range(B)]
        boxes, cls, valid = scenes_to_train_batch(scenes, jcfg, 64)[2:]
        print(f"draw {draw}: smallest force-matched best vs runner-up gap "
              f"{float(np.min(gaps(boxes, cls, valid))):.3e}")


if __name__ == "__main__":
    main()
