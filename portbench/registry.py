"""Finds what belongs to a cell by name, from files alone.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``configs``: its ``file`` under this folder) and a traffic
mix (``mixes/<traffic>.json``). Its correctness limits sit in
``limits/<cell>.json``; a configuration's ``builder`` names
``builders/<builder>.py``; a per-layer metric is read by
``layer_metrics/<metric>.py``. Adding a configuration, a mix, a cell or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    """The benchmark as files under ``root`` (this folder by default) and
    the ``BENCHMARK.json`` beside it."""

    def __init__(self, root: Path = HERE, spec: Path | None = None):
        self.root = Path(root)
        self.spec_path = spec or self.root.parent / "BENCHMARK.json"
        self.spec = json.loads(Path(self.spec_path).read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in {self.spec_path}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        path = self.root.parent / entry["file"]
        return json.loads(path.read_text())

    def mix(self, traffic: str) -> dict:
        return json.loads((self.root / "mixes" / f"{traffic}.json")
                          .read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.root / "limits" / f"{workload}.json")
                          .read_text())

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.spec["per_layer"]:
            cells = m.get("workloads")
            if (workload in cells) if cells is not None else (
                    m["moves"] in e2e):
                out.append(m)
        return out

    def _module(self, sub: str, name: str):
        path = self.root / sub / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{sub}_{name.replace('.', '_')}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def builder(self, name: str):
        return self._module("builders", name)

    def metric_reader(self, name: str):
        return self._module("layer_metrics", name)
