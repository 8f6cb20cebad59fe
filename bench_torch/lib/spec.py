"""Finding a cell's pieces by name: BENCHMARK.json, its configuration, its
traffic mix and the readers of its metrics.

  BENCHMARK.json                      the cells, configurations and metrics
  bench_torch/configs/<config>.json   a deployment (the file BENCHMARK.json names)
  bench_torch/traffic/<traffic>.json  a traffic mix's parameters
  bench_torch/feeds/<feed>.py         how a mix hands frames to the program: class Feed
  bench_torch/metrics/<metric>.py     a metric's reader: read(record) -> float | None
  bench_torch/references/<name>.py    a configuration's plain reference
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: dict, cell_: dict, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell_["config"]:
            return load_json(root / c["file"])
    raise SystemExit(f"no configuration named {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: dict, bench: Path = BENCH) -> dict:
    return load_json(bench / "traffic" / f"{cell_['traffic']}.json")


def metrics(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace=False) or per-layer metrics
    (trace=True).  A metric with a "workloads" key belongs to the cells it
    lists; an end-to-end metric without one to every cell; a per-layer
    metric without one to every cell that reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def feed(name: str, bench: Path = BENCH):
    """The Feed class of bench_torch/feeds/<name>.py."""
    return _module(bench / "feeds" / f"{name}.py", "bench_feed_" + name).Feed


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench: Path = BENCH):
    """The read(record) function of bench_torch/metrics/<name>.py."""
    return _module(bench / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_")).read


@functools.cache
def reference(name: str, bench: Path = BENCH):
    """The module bench_torch/references/<name>.py."""
    return _module(bench / "references" / f"{name}.py", "bench_reference_" + name)
