"""Finds what ``BENCHMARK.json`` names, by name: a cell's configuration
file and the entry it names (``entries/<entry>.py``), its traffic mix
(``traffic/<mix>.json``) and the mix's generator
(``traffic/<generator>.py``), its limits (``limits/<cell>.json``), and
one reader per metric (``end_to_end/<metric>.py`` or
``layers/<metric>.py``, each with ``read(record)``). Adding a cell, a
configuration, an entry, a mix or a metric is adding files and entries;
no file here changes."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


class Manifest:
    """``BENCHMARK.json`` under ``root`` (by default this checkout's) and
    the files it names there."""

    def __init__(self, root=None):
        self.root = ROOT if root is None else pathlib.Path(root)
        self.bench_dir = self.root / HERE.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def entry(self, name: str):
        """The class ``Entry`` of ``entries/<name>.py``."""
        return _load_module(self.bench_dir / "entries" / f"{name}.py",
                            "bench_entry_" + _ident(name)).Entry

    def mix(self, name: str) -> dict:
        return json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text())

    def generator(self, mix: dict):
        name = mix["generator"]
        return _load_module(self.bench_dir / "traffic" / f"{name}.py",
                            f"bench_traffic_{name}")

    def limits(self, cell: str) -> dict:
        path = self.bench_dir / "limits" / f"{cell}.json"
        return json.loads(path.read_text())["limits"]

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries that ``cell`` reports: end-to-end ones
        untraced, per-layer ones traced."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str, trace: bool):
        folder = "layers" if trace else "end_to_end"
        mod = _load_module(self.bench_dir / folder / f"{metric}.py",
                           "bench_reader_" + _ident(metric))
        return mod.read
