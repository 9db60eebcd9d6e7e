"""The port's training study tools (gan2shape_torch/tools/{full_instance_run,
check_pool_every}.py) on the CPU at 64 px with a 32-px GAN, on cut
schedules, against the JAX package's root tools/: their JSON keys (less the
XLA compile ones), step counts and schedule names, and their output files
only where --out says, the JAX tools' tracked JSONs untouched."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from gan2shape_torch.tools import check_pool_every, full_instance_run

ROOT = Path(__file__).resolve().parents[1]
TRACKED = ("FULL_RUN.json", "POOL_EVERY_CHECK.json", "RUN_REAL.json")
# the face config cut to test size
SMALL = {"image_size": 64, "gan_size": 32, "disc_ftr_num": 3,
         "n_proj_samples": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tracked_bytes():
    return {name: (ROOT / name).read_bytes() for name in TRACKED}


def dict_keys_with(path, key):
    """The key sets of the dict literals in a file that hold `key`."""
    tree = ast.parse(Path(path).read_text())
    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(tree) if isinstance(node, ast.Dict)
            and any(isinstance(k, ast.Constant) and k.value == key
                    for k in node.keys)]


# ---------------- the full-schedule run ----------------

def test_full_instance_run_cut_schedule(tmp_path, monkeypatch):
    """Two instances of a cut schedule: the JAX tool's keys less the XLA
    ones, the step count, the JSON only where --out says."""
    before = tracked_bytes()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out" / "full.json"
    result = full_instance_run.main(
        ["--device", "cpu", "--out", str(out)], prior=1,
        stages=[{"step1": 1, "step2": 1, "step3": 1}], config=SMALL)
    with open(out) as f:
        assert json.load(f) == result
    jax_keys, = dict_keys_with(ROOT / "tools" / "full_instance_run.py",
                               "schedule")
    assert set(result) == jax_keys - {"compile_chunk",
                                      "persistent_cache_entries_at_start"}
    assert result["total_optimization_steps"] == 1 + 3
    assert result["schedule"] == "1 prior + [{1,1,1}]"
    assert result["device"] == "cpu"
    assert set(result["final_losses"]) == {"loss_step1", "loss_step2",
                                           "loss_step3"}
    assert all(np.isfinite(v) for v in result["final_losses"].values())
    assert os.listdir(tmp_path) == ["out"]
    assert tracked_bytes() == before
    # the CLI's default is the JAX tool's schedule
    src = (ROOT / "tools" / "full_instance_run.py").read_text()
    assert '"1000 prior + [{700,700,600}] + 3x[{200,500,400}]"' in src
    assert full_instance_run.schedule_name(
        full_instance_run.FULL_PRIOR, full_instance_run.FULL_STAGES) == \
        "1000 prior + [{700,700,600}] + 3x[{200,500,400}]"


# ---------------- the pool-every study ----------------

def test_check_pool_every_cut_schedule(tmp_path, monkeypatch):
    before = tracked_bytes()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "study.json"
    code, results, runs = check_pool_every.main(
        ["--fast", "--ks", "1", "2", "--floor", "--device", "cpu", "--out",
         str(out)], config=SMALL, prior=1,
        stages=[{"step1": 1, "step2": 1, "step3": 1}])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(results))
    assert code == (0 if results["ok"] else 1)
    jax_keys = dict_keys_with(ROOT / "tools" / "check_pool_every.py",
                              "baseline_K")
    assert set(results) == jax_keys[0] | {"ks", "recommended_default",
                                          "floor"}
    floor = results["floor"]
    assert set(floor) == {"wall_s", "depth_mad_vs_base",
                          "depth_p95_vs_base", "tail_rel_dev"}
    assert np.isfinite(floor["depth_mad_vs_base"])
    assert set(floor["tail_rel_dev"]) == set(check_pool_every.STEPS)
    entry = results["ks"]["2"]
    assert set(entry) == {"depth_mad_vs_base", "depth_p95_vs_base", "step1",
                          "step2", "step3", "pass"}
    assert np.isfinite(entry["depth_mad_vs_base"])
    for K in (1, 2):
        assert runs[K]["depth"].shape == (64, 64)
        assert [len(runs[K]["losses"][s]) for s in check_pool_every.STEPS] \
            == [1, 1, 1]
    assert os.listdir(tmp_path) == ["study.json"]
    assert tracked_bytes() == before
