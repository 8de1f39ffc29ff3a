"""The ``offline.centerpoint`` cell's parts on the CPU, at a tiny CenterPoint
config: the ``accumulated`` scene kind, the seeded weights against the
port's state dict, the ``offline_center`` loop through whole runs (plain
and traced; its control), the judge's rules, the readers (and their
silence where the program lacks the spans) and the roofline's FLOPs at
the published configuration."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from pillarbench import judge_center
from pillarbench.cells import HERE, Cell
from pillarbench.center_weights import drawn_state, ref_config, state_shapes
from pillarbench.roofline import centerpoint as C
from pillarbench.scenes import accumulated
from pillarbench.tests.tiny import run_tiny

CELL = "offline.centerpoint"
TRAFFIC = {"pool": 5, "sweeps": 3, "sweep_points": [400, 600],
           "objects": 6, "compare": 2, "batch": 2}


def _lists(x):
    if isinstance(x, (tuple, list)):
        return [_lists(i) for i in x]
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    return x


def tiny_fields() -> dict:
    from tpu_pillars_torch.config import tiny_center_config

    return _lists(dataclasses.asdict(tiny_center_config()))


def tiny_cell() -> Cell:
    cell = Cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["config"] = tiny_fields()
    cell.traffic.update(TRAFFIC)
    return cell


def test_config_file_is_the_published_configuration():
    from tpu_pillars_torch.config import centerpoint_pp_config

    from pillarbench.loops.offline_center import program_config

    d = json.loads((HERE / "configs" / "centerpoint_pp.json").read_text())
    cfg = program_config(d["config"])
    assert cfg == centerpoint_pp_config()
    cfg.validate()
    assert d["reduced"] == [] and d["weights"] == {"seeded": True}
    assert len(d["source"]) <= 200


def test_accumulated_scene():
    cell = Cell(CELL)
    t = dict(cell.traffic, pool=4)
    a = accumulated.make(t, cell.config["config"],
                         np.random.default_rng(2 ** 33 + 1))
    b = accumulated.make(t, cell.config["config"],
                         np.random.default_rng(2 ** 33 + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    lo, hi = t["sweep_points"]
    for cloud in a:
        assert cloud.dtype == np.float32 and cloud.shape[1] == 5
        assert t["sweeps"] * lo <= len(cloud) <= t["sweeps"] * hi
        ages = np.unique(cloud[:, 4])
        np.testing.assert_allclose(ages, np.arange(t["sweeps"]) * 0.05,
                                   atol=1e-6)
        assert cloud[0, 4] == 0.0          # newest sweep first
    # the same set of sweep sizes for every seed
    c = accumulated.make(t, cell.config["config"], np.random.default_rng(5))
    sizes = sorted(len(x) for x in a)
    assert abs(sum(sizes) - sum(len(x) for x in c)) < 4 * t["sweeps"]


def test_seeded_weights_fit_the_port():
    from tpu_pillars_torch.config import tiny_center_config
    from tpu_pillars_torch.models.centerpoint import CenterPoint

    fields = tiny_fields()
    want = {k: tuple(v.shape) for k, v in
            CenterPoint(tiny_center_config()).state_dict().items()}
    assert {k: tuple(v) for k, v in state_shapes(fields).items()} == want
    sd = drawn_state(fields, 2 ** 40 + 3, torch.device("cpu"))
    assert all(torch.isfinite(v).all() for v in sd.values())
    assert float(sd["head.tasks.0.hm.b2"][0]) == pytest.approx(-2.19)
    bn_w = [v for k, v in sd.items() if k.endswith("bn1.weight")]
    assert bn_w and not torch.equal(bn_w[0], torch.ones_like(bn_w[0]))


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_runs_are_correct(trace):
    from tpu_pillars_torch.utils import profiling

    profiling.reset()
    result, lines, checks = run_tiny(tiny_cell(), seed=2 ** 31 + 11,
                                     seconds=3.0, trace=trace)
    profiling.reset()
    assert result["correct"], checks
    assert set(checks) == {"det_gap", "map_gap"}
    metrics = result["metrics"]
    if not trace:
        assert set(metrics) == {"sweeps_per_s", "setup_s"}
        assert metrics["sweeps_per_s"]["value"] > 0
        return
    for m in ("pad_ms.cp", "launch_ms.cp", "candidates.cp", "idle_share.cp"):
        assert metrics[m]["value"] >= 0, m
    # device times, gaps and roofline shares: not on the CPU
    for m in ("rpn_dev_ms.cp", "gap_ms.cp", "pfn2_roofline.cp"):
        assert m not in metrics
    assert any(line.startswith("reference:") for line in lines)


def test_control_runs_on_the_cpu():
    from pillarbench.session import run_cell  # noqa: F401 (import order)

    cell = tiny_cell()
    args = type("A", (), {"seed": 2 ** 31 + 3})()
    loop = cell.loop()(cell, args, torch.device("cpu"), HERE.parent, {})
    out = loop.controls(1.0)["control"]
    # no TF32 on the CPU: the control equals the reference
    assert out["det_gap"] == 0.0 and out["map_gap"] == 0.0


def _det(boxes, scores, classes):
    return (np.asarray(boxes, np.float64).reshape(-1, 9),
            np.asarray(scores, np.float64), np.asarray(classes, np.int64))


def _ref(boxes, scores, classes, tasks, n_tasks=6):
    from pillarbench.reference.centerpoint import (
        Candidates, CenterDetections,
    )

    b, s, c = _det(boxes, scores, classes)
    cands = [Candidates(b[np.asarray(tasks) == t], s[np.asarray(tasks) == t],
                        c[np.asarray(tasks) == t], 0.0)
             for t in range(n_tasks)]
    return CenterDetections(b, s, c, np.asarray(tasks), cands,
                            np.zeros(n_tasks))


def test_judge_matches_and_counts_lone_detections():
    fields = Cell(CELL).config["config"]
    box = [1.0, 2.0, 0.0, 2.0, 4.0, 1.5, 0.3, 1.0, -1.0]
    other = [20.0, 2.0, 0.0, 2.0, 4.0, 1.5, 0.3, 0.0, 0.0]
    ref = _ref([box, other], [0.6, 0.4], [0, 1], [0, 1])
    same = judge_center.compare_center({0: [_det([box, other], [0.6, 0.4],
                                                 [0, 1])]}, {0: ref}, fields)
    assert same["det_gap"] == 0.0 and same["unmatched"] == 0.0
    moved = list(box)
    moved[7] += 0.01                      # the velocity counts
    out = judge_center.compare_center({0: [_det([moved, other], [0.6, 0.4],
                                                [0, 1])]}, {0: ref}, fields)
    assert out["det_gap"] == pytest.approx(0.01)
    lone = judge_center.compare_center({0: [_det([box], [0.6], [0])]},
                                       {0: ref}, fields)
    assert lone["det_gap"] == pytest.approx(0.4) and lone["unmatched"] > 0
    # a detection at the score threshold is explained, not counted
    ref_t = _ref([box, other], [0.6, 0.1002], [0, 1], [0, 1])
    near = judge_center.compare_center({0: [_det([box], [0.6], [0])]},
                                       {0: ref_t}, fields)
    assert near["det_gap"] == 0.0 and near["borderline"] == 1


def test_map_gap_is_relative():
    a = np.ones((1, 2, 3, 3))
    b = a * 2.0
    assert judge_center.map_gap(a, b) == pytest.approx(0.5)


def test_readers_are_silent_without_the_program_spans(monkeypatch):
    from tpu_pillars_torch.utils import profiling

    from pillarbench.readers import RunRecord

    monkeypatch.delattr(profiling, "summary")
    cell = Cell(CELL)
    run = RunRecord(cell.config, cell.traffic)
    for m in cell.per_layer:
        assert cell.reader(m["name"])(run) is None, m["name"]


def test_serving_flops_at_the_published_configuration():
    cfg = Cell(CELL).config["config"]
    assert C.rpn_flops(cfg) == pytest.approx(75.2e9, rel=0.01)
    assert C.head_flops(cfg) == pytest.approx(52.1e9, rel=0.01)
    # and the PFN: 2 x 200,000 x (10 x 32 + 64 x 64) = 1.77 GFLOP
    assert C.serving_flops(cfg, 200_000) == pytest.approx(129.0e9, rel=0.01)
    nb, ops = C.k2_two_layer(cfg, 8, 8 * 200_000)
    assert nb > 8 * 60_000 * 64 * 4 and ops > 0
    assert C.kernel_of("void fpfn2_kernel<5, 2>(float const*)") == "K2b"
    assert C.kernel_of("void (anonymous namespace)::fpfn_kernel<4, 2>") \
        is None


def test_mean_counts_of_the_pool():
    cell = Cell(CELL)
    pool = accumulated.make(dict(cell.traffic, pool=2),
                            cell.config["config"], np.random.default_rng(1))
    c = C.mean_counts(pool, ref_config(cell.config["config"]))
    assert 0 < c["kept"] <= c["valid"] and c["pillars"] <= 60_000
    assert c["occupied"] >= c["pillars"]
