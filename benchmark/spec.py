"""What a run reads, found by name: the cell in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the limits of its correctness check
(`limits/<cell>.json`) and one reader per metric (`metrics/<name>.py`).
A new cell, configuration, mix or metric is a new file and a new entry in
BENCHMARK.json; no code here changes.  Two more kinds of file are found
by name elsewhere: the reference's GAN that a configuration's `gan_arch`
names (`reference/gans/<gan_arch>.py`, absent: stylegan2), and the
roofline registry's entries (`kernels/<entry>.py`: what the port calls a
kernel through, its bytes, its kernels and its metric; `roofline.py`
lists the folder)."""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict          # the method's configuration, as the trainer takes it
    traffic: dict
    limits: dict          # {number compared: limit}
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def n_instances(self):
        return int(self.traffic["n_instances"])


def load_benchmark(root=ROOT):
    return _json(Path(root) / "BENCHMARK.json")


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT, here=HERE):
    """The cell `name` of BENCHMARK.json with everything it names."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there "
                         f"are {sorted(cells)}")
    w = cells[name]
    conf = _json(Path(here) / "configs" / f"{w['config']}.json")
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        config={k: v for k, v in conf.items()
                if k not in ("source", "reduced", "assumed")},
        traffic=_json(Path(here) / "traffic" / f"{w['traffic']}.json"),
        limits=_json(Path(here) / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_reader(metric, here=HERE):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = Path(here) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
