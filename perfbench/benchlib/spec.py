"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics.  Everything that belongs to one of them sits in
files of its own, found by its name:

* a configuration ``<c>``: ``perfbench/configs/<c>.json`` (the file named
  in ``BENCHMARK.json``) and its plain reference ``perfbench/configs/<c>.ref.py``;
* a traffic mix ``<t>``: ``perfbench/traffic/<t>.json``;
* a cell ``<w>``: ``perfbench/workloads/<w>.json``, which names its
  driver ``perfbench/drivers/<d>.py`` and its backend;
* a per-layer metric ``<m>``: ``perfbench/metrics/<m>.py``, whose
  ``read(obs)`` returns the value or None.

Adding any of them adds files and entries; no file that is there changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list
    reference: ModuleType
    driver: ModuleType


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module; its name is made from the
    path, so files named after a metric or a configuration (dots and dashes
    in them) load side by side."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_name = "perfbench_" + re.sub(r"\W", "_", path.relative_to(
        BENCH).with_suffix("").as_posix())
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def config_path(name: str, bench: dict, root: Path = ROOT) -> Path:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return root / entry["file"]


def reference_path(config: str) -> Path:
    return BENCH / "configs" / f"{config}.ref.py"


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def workload_path(name: str) -> Path:
    return BENCH / "workloads" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def driver_path(name: str) -> Path:
    return BENCH / "drivers" / f"{name}.py"


def metrics_of(cell: str, bench: dict) -> tuple[list, list]:
    """The end-to-end and per-layer metrics a cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads",
                            [cell] if m["moves"] in reported else [])]
    return e2e, per


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    wl = _json(workload_path(name))
    e2e, per = metrics_of(name, bench)
    return Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"], traffic_name=entry["traffic"],
        config=_json(config_path(entry["config"], bench, root)),
        traffic=_json(traffic_path(entry["traffic"])),
        workload=wl, end_to_end=e2e, per_layer=per,
        reference=load_module(reference_path(entry["config"])),
        driver=load_module(driver_path(wl["driver"])))
