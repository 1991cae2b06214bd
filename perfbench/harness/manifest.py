"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`, which names its driver `drivers/<driver>.py`);
its limits are `limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`; each kernel family is `kernels/<family>.json`.
Adding any of these is adding a file and a manifest entry."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, man: dict) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in man['workloads']]}")


def config(name: str, man: dict, root: Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "traffic" / f"{name}.json")


def limits(cell_name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "limits" / f"{cell_name}.json")


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (`idle_share.train.py`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic_cfg: dict, bench: Path = BENCH):
    return load_module(bench / "drivers" / f"{traffic_cfg['driver']}.py",
                       f"perfbench_driver_{traffic_cfg['driver']}")


def metric_reader(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py",
                       "perfbench_metric_" + re.sub(r"\W", "_", name))


def end_to_end(cell_name: str, man: dict) -> list:
    """The cell's end-to-end metrics: those without `workloads`, and those
    that list it."""
    return [m for m in man["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(cell_name: str, man: dict) -> list:
    """The cell's per-layer metrics: those that list it, and those without
    `workloads` whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(cell_name, man)}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in e2e else [])]


def kernel_families(bench: Path = BENCH) -> dict:
    """{family: {"patterns": [compiled regex], "layer": str, "bound": str or None}}
    from every kernels/*.json."""
    out = {}
    for path in sorted((bench / "kernels").glob("*.json")):
        spec = load_json(path)
        out[path.stem] = {"patterns": [re.compile(p) for p in spec["patterns"]],
                          "layer": spec["layer"], "bound": spec.get("bound")}
    return out


def bound_function(ref: str):
    """A frozen bound function named "<module>.<function>" under perfbench/frozen."""
    module, fn = ref.rsplit(".", 1)
    mod = importlib.import_module(f"perfbench.frozen.{module}")
    return getattr(mod, fn)
