"""Every cell of BENCHMARK.json finds its configuration, traffic mix,
loop, scene kind and per-layer readers by name, and the file keeps to the
benchmark's rules on names, units, bounds and keys. A new mix, or a new
loop, is new files: it runs without an edit to any file there is."""

import json
import re
import shutil

import pytest

from pillarbench.cells import HERE, ROOT, Cell, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_its_files(name):
    cell = Cell(name)
    assert callable(cell.loop())
    assert callable(cell.scene().make)
    assert "limits" in cell.traffic and cell.traffic["limits"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    cfg_file = next(c["file"] for c in BENCH["configs"]
                    if c["name"] == cell.entry["config"])
    assert (ROOT / cfg_file).resolve() == (
        HERE / "configs" / f"{cell.entry['config']}.json").resolve()


def test_every_configuration_and_metric_is_used():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert configs == used
    metrics = {m["name"] for m in BENCH["per_layer"]}
    on_disk = {p.name[:-3] for p in (HERE / "metrics").glob("*.py")}
    assert metrics <= on_disk
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[k]]
        assert len(ns) == len(set(ns))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_the_run_configuration(entry):
    d = json.loads((ROOT / entry["file"]).read_text())
    from tpu_pillars_torch.config import PillarsConfig

    from pillarbench.program import options, program_config

    cfg = program_config(d["config"])
    assert isinstance(cfg, PillarsConfig)
    cfg.validate()
    assert d["reduced"] == entry["reduced"]
    assert d["source"] == entry["source"]
    opts = options(d)
    assert str(opts["dtype"]) == "torch." + d["program"]["dtype"]


# a loop that a later cell might add: each batch padded, run and
# downloaded in turn, one batch in flight
SERIAL = '''
import time

import numpy as np

from pillarbench.loops.offline import Loop as Offline


class Loop(Offline):
    def run(self, t_end, count_from=0.0):
        from tpu_pillars_torch.detector import packed_to_boxes

        done = 0
        while True:
            idx = self._next()
            pts, n = self._pad(idx)
            host = self.det.predict_packed_batch(pts, n).cpu().numpy()
            boxes = [packed_to_boxes(h, self.det.config) for h in host]
            now = time.perf_counter()
            if now > t_end:
                return done
            if now >= count_from:
                done += len(idx)
                self._record(idx, boxes)
'''


@pytest.mark.parametrize("loop", ["offline", "serial"])
def test_new_files_run_without_an_edit(tmp_path, loop):
    from pillarbench.tests.tiny import run_tiny, tiny_cell

    home = tmp_path / "home"
    for part in ("configs", "traffic", "loops", "scenes", "metrics"):
        shutil.copytree(HERE / part, home / part)
    mix = json.loads((HERE / "traffic" / "offline.json").read_text())
    mix.update(loop=loop, batch=3, why="a mix a later cell adds")
    (home / "traffic" / "offline_b3.json").write_text(json.dumps(mix))
    if loop == "serial":
        (home / "loops" / "serial.py").write_text(SERIAL)
    entry = {"name": "offline.b3", "config": "full",
             "traffic": "offline_b3", "chips": 1}
    cell = tiny_cell("offline.b3", tmp_path, entry=entry, home=home)
    result, lines, checks = run_tiny(cell)
    assert result["correct"] is True, (checks, lines)
    assert result["attempted"] > 0
