"""The harness end to end on the CPU at a tiny size: the contract's last
line, the correctness check against the reference (and that it fails on a
broken program), the run refused without a card, files found by name, and
the import guards."""

import ast
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, run, spec
from benchmark.tests.tiny import args, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = set(run.FORBIDDEN)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run(cell, plant=None, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        code, result = run.main(args(**kw), device="cpu", cell=cell,
                                plant=plant)
    return code, result, out.getvalue().strip().splitlines()


def test_cell_runs_end_to_end_and_prints_the_contract_line():
    cell = tiny_cell()
    code, result, lines = _run(cell, seconds=20)
    assert code == 0
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(result))
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True, last
    assert last["failed"] == 0 and last["attempted"] > 0
    # no card peak; face128-seq reports the one-at-a-time instance_s
    assert set(last["metrics"]) == {"seq.instance_s", "setup_s"}
    assert set(last["checks"]) == set(cell.limits)
    assert set(cell.limits) <= set(check.NUMBERS)
    for v in last["checks"].values():
        assert v["value"] <= v["limit"]


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    cell = tiny_cell(cut=200)  # the profiled second stage comes early
    code, result, _ = _run(cell, seconds=20, trace=1)
    assert code == 0 and result["correct"]
    assert {"seq.iter_ms.step2", "seq.iter_ms.step3", "seq.mfu_pct"} <= set(
        result["metrics"])
    dev = result["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged_state(system):
    """A step that returns its state unchanged: no optimizer update."""
    trainer = system.trainer

    def step(loss, optimizer):
        trainer.model.zero_grad(set_to_none=True)
        loss.sum().backward()
    trainer._step = step


def _half_batch(system):
    """Half of step 2's batch left out, the mean taken over the rest."""
    model = system.model
    real = model.step2_sample

    def sample(*a, **kw):
        return tuple(x[:max(x.shape[0] // 2, 1)] for x in real(*a, **kw))
    model.step2_sample = sample


def _half_batch_step3(system):
    """Half of step 3's samples left out, the mean taken over the rest."""
    model = system.model
    real = model.forward_step3
    n = system.n

    def forward(images, latents, collected):
        half = tuple(x.reshape(n, -1, *x.shape[1:])[:, :max(
            x.shape[0] // n // 2, 1)].reshape(-1, *x.shape[1:])
            for x in collected)
        return real(images, latents, half)
    model.forward_step3 = forward


def _other_instances_rows(system):
    """What step 1 hands on carries another instance's rows: the
    instances' order rolled by one."""
    trainer = system.trainer
    real = trainer.run_step1
    n = system.n

    def run_step1(images, n_iters):
        collected, losses = real(images, n_iters)
        return tuple(x.reshape(n, -1, *x.shape[1:]).roll(1, 0).reshape(
            x.shape) for x in collected), losses
    trainer.run_step1 = run_step1


@pytest.mark.parametrize("plant,n_proj,n", [(_unchanged_state, 1, 1),
                                            (_half_batch, 2, 1),
                                            (_half_batch_step3, 2, 1),
                                            (_other_instances_rows, 1, 2)],
                         ids=["state_unchanged", "half_batch",
                              "half_batch_step3", "other_instances_rows"])
def test_a_broken_program_comes_out_incorrect(plant, n_proj, n):
    cell = tiny_cell() if n == 1 else tiny_cell("face128-n8",
                                                  n_instances=n)
    cell.config["n_proj_samples"] = n_proj
    code, result, _ = _run(cell, plant=plant, seconds=1)
    assert code == 0
    assert result["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in result["checks"].values())


@pytest.mark.parametrize("plant,n_proj", [(_unchanged_state, 1),
                                          (_half_batch, 2),
                                          (_half_batch_step3, 2)],
                         ids=["state_unchanged", "half_batch",
                              "half_batch_step3"])
def test_a_broken_program_comes_out_incorrect_at_car512_seq(plant, n_proj):
    """car512-seq's limits and the car configuration (its category and
    prior) at the tiny size."""
    cell = tiny_cell("car512-seq")
    cell.config["n_proj_samples"] = n_proj
    code, result, _ = _run(cell, plant=plant, seconds=1,
                           workload="car512-seq")
    assert code == 0
    assert result["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in result["checks"].values())


def test_car512_seq_comes_out_correct_unbroken():
    """The same tiny car512-seq run with nothing broken is correct: the
    faults above fail for what they break."""
    cell = tiny_cell("car512-seq", cut=200)  # step 3 within the window
    cell.config["n_proj_samples"] = 2
    code, result, _ = _run(cell, seconds=30, workload="car512-seq")
    assert code == 0 and result["correct"] is True, result["checks"]


def test_the_command_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code, result = run.main(args())
    assert code != 0 and result is None
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", *args()],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files
    (and entries of BENCHMARK.json) are found with no edit to the code."""
    here = tmp_path / "benchmark"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((here / "configs" / "face128.json").read_text())
    (here / "configs" / "face64.json").write_text(
        json.dumps({**conf, "image_size": 64}))
    (here / "traffic" / "n2.json").write_text(json.dumps(
        {**json.loads((here / "traffic" / "n8.json").read_text()),
         "n_instances": 2}))
    (here / "limits" / "face64-n2.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1, "grad_gap": 2, "change_gap": 3}}))
    (here / "metrics" / "twice_setup_s.py").write_text(
        "def read(run):\n    return 2 * run.setup_s\n")
    bench["configs"].append({**bench["configs"][0], "name": "face64",
                             "file": "benchmark/configs/face64.json"})
    bench["workloads"].append({"name": "face64-n2", "config": "face64",
                               "traffic": "n2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "twice_setup_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "Set-up", "moves": "setup_s",
                               "workloads": ["face64-n2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("face64-n2", root=tmp_path, here=here)
    assert cell.config["image_size"] == 64 and "source" not in cell.config
    assert cell.n_instances == 2
    assert cell.limits == {"loss_gap": 1, "grad_gap": 2, "change_gap": 3}
    assert [m["name"] for m in cell.per_layer] == ["twice_setup_s"]
    reader = spec.load_reader("twice_setup_s", here=here)

    class R:
        setup_s = 1.5
    assert reader(R) == 3.0
    # the cells already there are untouched by the new one
    assert "twice_setup_s" not in [
        m["name"] for m in spec.load_cell("face128-seq", root=tmp_path,
                                          here=here).per_layer]


def _sources(folder):
    return sorted(p for p in folder.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(BENCH),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_reference_imports_nothing_of_the_program(path):
    roots = set(_imported_roots(path))
    assert "gan2shape_torch" not in roots and "benchmark" not in roots


def test_a_run_loads_no_jax_module():
    code = ("import sys\n"
            "import benchmark.run, benchmark.check, benchmark.system, "
            "benchmark.window, benchmark.trace, benchmark.roofline, "
            "benchmark.calibrate\n"
            "import gan2shape_torch.core.trainer, "
            "gan2shape_torch.parallel.sharding, gan2shape_torch.ops._cuda\n"
            "from benchmark import spec\n"
            "b = spec.load_benchmark()\n"
            "[spec.load_reader(m['name']) for m in b['end_to_end'] "
            "+ b['per_layer']]\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _first_steps(cell, seed, n_iters):
    from benchmark.system import System
    got, images, latents = check.first_steps(System(cell, seed, "cpu"),
                                             n_iters)
    want = check.reference_readings(cell.config, seed, images, latents,
                                    n_iters, "cpu", got)
    return got, want


def test_the_reference_agrees_with_the_sequential_port_at_a_tiny_size():
    """One instance: on the CPU the program and the reference run the same
    plain operations, so every number reads (all but) nought."""
    got, want = _first_steps(tiny_cell(), 5, 2)
    worst = check.gaps(got, want)
    assert max(worst.values()) <= 1e-6, worst


def test_the_reference_agrees_with_the_instance_parallel_port():
    """Two instances at once: the stacked nets' grouped convolutions round
    otherwise than one instance's, so the first iteration's losses and
    each step's first gradient are held tight, and what Adam's updates
    make of that rounding (a flipped sign of the smallest gradient
    entries) looser."""
    got, want = _first_steps(tiny_cell("face128-n8", n_instances=2), 5, 2)
    for s in check.STEPS:
        np.testing.assert_allclose(got["loss"][s][0], want["loss"][s][0],
                                   rtol=1e-5)
    worst = check.gaps(got, want)
    assert max(worst[f"{s}_grad"] for s in check.STEPS) <= 1e-3, worst
    assert max(worst.values()) <= 0.1, worst


def _the_control_fails(name):
    """The reference with TF32 on (the precision below the configured
    exact f32) against the reference at exact f32, on the program's first
    steps of cell `name` at its own size, seed 301 of the calibration: at
    least one number past the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.system import System
    cell = spec.load_cell(name)
    system = System(cell, 301, "cuda")
    program, images, latents = check.first_steps(
        system, 3, torch.cuda.synchronize)
    del system
    f32 = check.reference_readings(cell.config, 301, images, latents, 3,
                                   "cuda", program)
    tf32 = check.reference_readings(cell.config, 301, images, latents, 3,
                                    "cuda", program, tf32=True)
    worst = check.gaps(tf32, f32)
    assert any(worst[k] > v for k, v in cell.limits.items()), worst


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    """face128-seq (12 GiB on the card)."""
    _the_control_fails("face128-seq")


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_car512_seq():
    """car512-seq: the 512-px GAN one image at a time (10 GiB)."""
    _the_control_fails("car512-seq")


def test_stacked_instances_count_flops_once_each():
    """The FLOPs of one iteration of each step at N=2 are twice those at
    N=1: the stacked nets' grouped convolutions are counted whole, and
    their weight gradients once per group (`roofline.flop_counter`)."""
    from benchmark import roofline
    from benchmark.system import STEPS, System
    counts = {}
    for n, name in ((1, "face128-seq"), (2, "face128-n8")):
        system = System(tiny_cell(name, n_instances=n), 3, "cpu")
        system.prep(*system.inputs(0))
        counts[n] = roofline.count_flops(system, STEPS, lambda: None)
    for step in STEPS:
        assert counts[2][step][0] == pytest.approx(2 * counts[1][step][0],
                                                   rel=1e-5), step
