"""Find a cell's files by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each
cell's traffic and check live in ``workloads/<cell>.json``, each
configuration in the file its entry names, and each generator, traffic
loop and metric reader is a Python file found by its name:
``data/<generator>.py``, ``traffic/<generator>.py``,
``metrics/<metric>.py``.  A new cell, configuration or metric is new
files and new entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent          # perfbench/
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = HERE):
    """The module ``<base>/<kind>/<name>.py``, loaded by its path (a name
    may hold dots and dashes, which an import name may not)."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"perfbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    if mod_name in sys.modules and sys.modules[mod_name].__file__ == str(path):
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    entry: dict            # the BENCHMARK.json workload entry
    workload: dict         # workloads/<name>.json
    config: dict           # the configuration's file
    end_to_end: list       # metric entries this cell reports, --trace 0
    per_layer: list        # metric entries this cell reports, --trace 1
    run_seconds: int
    base: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench_path: Path = REPO / "BENCHMARK.json",
         base: Path = HERE) -> Cell:
    """The cell ``name``: its entry in ``bench_path`` and the files under
    ``base`` that the entry names."""
    bench = load_json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = load_json(bench_path.parent / cfg_entry["file"])
    workload = load_json(base / "workloads" / f"{name}.json")
    if workload.get("config") != entry["config"]:
        raise ValueError(f"{name}: workload file names config "
                         f"{workload.get('config')!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    if workload.get("traffic") != entry["traffic"]:
        raise ValueError(f"{name}: workload file names traffic "
                         f"{workload.get('traffic')!r}, BENCHMARK.json "
                         f"{entry['traffic']!r}")
    if config.get("name") != entry["config"]:
        raise ValueError(f"{cfg_entry['file']} holds config "
                         f"{config.get('name')!r}, not {entry['config']!r}")
    return Cell(name=name, entry=entry, workload=workload, config=config,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                run_seconds=int(bench["run_seconds"]), base=base)
