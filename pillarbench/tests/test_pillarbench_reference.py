"""The plain reference against the port's CPU path (the kernels' plain
versions) at the tiny configuration: the same boxes from the same
clouds and weights, and the same first training steps. The reference
itself imports nothing of the port; this test imports both."""

import dataclasses

import numpy as np
import torch

from pillarbench import judge, weights as W
from pillarbench.program import program_config
from pillarbench.reference.config import RefConfig
from pillarbench.reference.detect import ReferenceDetector
from pillarbench.reference.msgpack import load_flax_tree
from pillarbench.reference.train import train_steps
from pillarbench.scenes.lidar import lidar_sweep
from pillarbench.scenes.train import train_batch, train_scene
from pillarbench.tests.tiny import write_checkpoint


def fields(**kw):
    from tpu_pillars_torch.config import tiny_config

    d = dataclasses.asdict(tiny_config(**kw))
    d["classes"] = [dict(c) for c in d["classes"]]
    for k in ("rpn_channels", "rpn_layers", "anchor_yaws"):
        d[k] = list(d[k])
    return d


def test_detections_match_the_port(tmp_path):
    from tpu_pillars_torch.detector import Detector
    from tpu_pillars_torch.weights import params_from_flax

    f = fields()
    rcfg, pcfg = RefConfig(f), program_config(f)
    write_checkpoint(f, tmp_path / "w.msgpack")
    tree = load_flax_tree(str(tmp_path / "w.msgpack"))
    tree = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    rng = np.random.default_rng(3)
    # the last cloud is past the point budget and the pillar budget
    clouds = [lidar_sweep(rng, n) for n in (2000, 5000, 9000)]
    det = Detector(pcfg, params_from_flax(tree, pcfg), device="cpu")
    names = [c["name"] for c in f["classes"]]
    served = {i: [judge.boxes_to_arrays(det.predict(c), names)]
              for i, c in enumerate(clouds)}
    assert det.truncation.truncated_clouds >= 1
    want = ReferenceDetector(rcfg, tree, "cpu").detect(clouds)
    assert sum(len(w[0]) for w in want) > 10
    got = judge.compare_detections(served, dict(enumerate(want)), f)
    assert got["unmatched"] == 0.0 and got["borderline"] == 0
    assert got["det_gap"] < 1e-4


def test_training_steps_match_the_port():
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state
    from tpu_pillars_torch.train.step import batch_to_device, make_train_step

    f = fields()
    rcfg, pcfg = RefConfig(f), program_config(f)
    init = W.seeded_state(W.state_shapes(rcfg), 11, torch.device("cpu"))
    rng = np.random.default_rng(4)
    # 3,000 clutter points over a 40 m square: past the 512-pillar budget
    batches = [train_batch(
        [train_scene(rng, f, 5, 60, 3000) for _ in range(2)], f, 8)
        for _ in range(3)]
    opt = {"learning_rate": 2e-4, "weight_decay": 1e-4,
           "grad_clip_norm": 10.0, "total_steps": 100, "warmup_frac": 0.1}
    state = create_train_state(pcfg, TrainConfig(**opt), device="cpu",
                               state_dict={k: v.clone()
                                           for k, v in init.items()})
    step = make_train_step(pcfg, max_gt_per_class=4)
    losses, grad1 = [], None
    for arrays in batches:
        state, out = step(state, batch_to_device(arrays, "cpu"))
        losses.append(float(out.total))
        if grad1 is None:
            grad1 = {n: (m / 0.1).numpy() for (n, _), m in zip(
                state.model.named_parameters(), state.optimizer.mu)}
    prog = {"losses": losses, "grad1": grad1,
            "params": {n: p.detach().numpy()
                       for n, p in state.model.named_parameters()}}
    ref = train_steps(init, rcfg, batches, opt, 4, "cpu")
    ref = {"losses": ref["losses"],
           "grad1": {k: v.numpy() for k, v in ref["grad1"].items()},
           "params": {k: v.numpy() for k, v in ref["params"].items()}}
    got = judge.compare_training(prog, ref, {k: v.numpy()
                                             for k, v in init.items()})
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3
    assert got["change_gap"] < 1e-2
