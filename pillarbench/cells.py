"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the loop that the mix names
(``loops/<loop>.py``), the scene kind that the mix names
(``scenes/<scene>.py``), and the readers of the per-layer metrics it
reports (``metrics/<metric>.py``). A later cell is new entries and new
files; nothing here names a cell, a loop or a scene kind."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_part(home: Path, kind: str, name: str):
    """The module ``<home>/<kind>/<name>.py``, loaded from its file."""
    path = Path(home) / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is "
                                f"missing")
    spec = importlib.util.spec_from_file_location(
        f"pillarbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One ``workloads`` entry with everything it names."""

    def __init__(self, name: str, bench: dict = None, entry: dict = None,
                 home: Path = HERE):
        """``entry``: a ``workloads`` entry that ``BENCHMARK.json`` does
        not list (yet), in its place; ``home``: the directory whose
        ``configs``, ``traffic``, ``loops``, ``scenes`` and ``metrics``
        hold the cell's files."""
        bench = bench or load_benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if entry is None and name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(entries)})")
        self.name = name
        self.home = Path(home)
        self.entry = entry or entries[name]
        self.chips = self.entry["chips"]
        self.config = json.loads((self.home / "configs" /
                                  f"{self.entry['config']}.json").read_text())
        self.traffic = json.loads((self.home / "traffic" /
                                   f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name) and m["moves"] in reported]

    def loop(self):
        """The ``Loop`` class of ``loops/<loop>.py``, the mix's loop."""
        return load_part(self.home, "loops", self.traffic["loop"]).Loop

    def scene(self):
        """``scenes/<scene>.py``, the generator of the mix's inputs."""
        return load_part(self.home, "scenes", self.traffic["scene"])

    def reader(self, metric: str):
        """The ``read(run)`` of ``metrics/<metric>.py``."""
        return load_part(self.home, "metrics", metric).read
