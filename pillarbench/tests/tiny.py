"""Cells of ``BENCHMARK.json`` cut to the port's tiny configuration, for
driving whole runs on the CPU (the kernels' plain versions run there)."""

from __future__ import annotations

import argparse
import copy
import dataclasses

import torch

from pillarbench.cells import Cell

TRAFFIC = {
    "lidar": {"points": [1500, 3000], "pool": 6, "compare": 3, "batch": 2},
    "train": {"objects": 4, "points_per_object": 40, "clutter": 600,
              "pool": 4, "batch": 2, "max_gt": 8, "max_gt_per_class": 4,
              "window_step": [1, 1]},
}


def tiny_fields() -> dict:
    from tpu_pillars_torch.config import tiny_config

    d = dataclasses.asdict(tiny_config())
    d["classes"] = [dict(c) for c in d["classes"]]
    for k in ("rpn_channels", "rpn_layers", "anchor_yaws"):
        d[k] = list(d[k])
    return d


def write_checkpoint(fields: dict, path, seed: int = 0) -> None:
    """A seeded tiny inference checkpoint, its class bias set so that
    empty space scores under the threshold."""
    from tpu_pillars_torch.train.checkpoint import (
        export_inference_checkpoint,
    )
    from tpu_pillars_torch.train.state import TrainConfig, create_train_state

    from pillarbench.program import program_config

    cfg = program_config(fields)
    state = create_train_state(cfg, TrainConfig(), seed=seed, device="cpu")
    with torch.no_grad():
        state.model.head.cls.bias.fill_(-1.5)
    export_inference_checkpoint(str(path), state, config=cfg)


def tiny_cell(name: str, tmp_path, **cell_kw) -> Cell:
    """The cell ``name`` (``cell_kw``: ``Cell``'s ``entry`` and ``home``)
    at the tiny configuration, with its traffic cut to match."""
    cell = Cell(name, **cell_kw)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["config"] = tiny_fields()
    cell.traffic.update(TRAFFIC[cell.traffic["scene"]])
    if "checkpoint" in cell.config.get("weights", {}):
        path = tmp_path / "tiny.msgpack"
        write_checkpoint(cell.config["config"], path)
        cell.config["weights"]["checkpoint"] = str(path)
    return cell


def run_tiny(cell: Cell, seed: int = 7, seconds: float = 3.0,
             trace: int = 0):
    """A whole run of ``cell`` on the CPU -> (result, lines, checks)."""
    from pillarbench.run import ROOT
    from pillarbench.session import run_cell
    import time

    args = argparse.Namespace(workload=cell.name, seed=seed,
                              seconds=seconds, trace=trace)
    return run_cell(cell, args, torch.device("cpu"), time.perf_counter(),
                    ROOT)
