"""One run of one cell of the benchmark.

    python3 -m benchmark.run --workload face128-seq --seed 7 --seconds 40 --trace 0

Set-up (`setup_s`, from the process's start): the cell's files, the
kernel libraries (built once into the checkout's build/kernels/), the
trainer on the card with the benchmark's seeded weights, and the
correctness check's first steps, which warm every step at the cell's
shapes (`check.py`).  A traced run also counts each step's FLOPs and
starts the profiler once.  Then the window (`window.py`), then the
reference, then one JSON line on stdout: `--trace 0` reports the cell's
end-to-end metrics, `--trace 1` its per-layer metrics and the trace's
breakdown.  The numbers compared for `correct` close standard error and
the result line (`checks`)."""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gan2shape_tpu", "tools")
CHECKOUT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment():
    """Keep every cache of the run inside the checkout or the run's own
    TMPDIR, and keep libraries from loading JAX."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(CHECKOUT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Run:
    """What the metric readers read (`metrics/<name>.py`: `read(run)`)."""

    def __init__(self, cell, window, counts, setup_s, peak_bytes,
                 trace=None, flops=None, peak_flops=None):
        self.cell = cell
        self.window = window
        self.counts = counts          # {step: iterations of the schedule}
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = trace            # trace.parse() of the profiled stage
        self.flops = flops            # {step: (per iteration, per block)}
        self.peak_flops = peak_flops  # FLOP/s of the run's precision
        self.n_instances = cell.n_instances


def _finite(v):
    """v as a JSON number, or None where it is missing or not finite."""
    return float(v) if v is not None and math.isfinite(v) else None


def _host_state():
    """What the host gave the process so far: its CPU seconds and context
    switches."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": r.ru_utime + r.ru_stime, "voluntary": r.ru_nvcsw,
            "involuntary": r.ru_nivcsw}


def _host_delta(before, after, wall):
    """The host over the window: CPU seconds a wall second (how much of the
    window the process ran on a core), context switches, the cores the
    process may use and torch's threads."""
    import torch
    return {"cpu_per_wall": (after["cpu_s"] - before["cpu_s"])
            / max(wall, 1e-9),
            "voluntary_switches": after["voluntary"] - before["voluntary"],
            "involuntary_switches": (after["involuntary"]
                                     - before["involuntary"]),
            "cores": len(os.sched_getaffinity(0)),
            "threads": torch.get_num_threads()}


def jax_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None, device=None, cell=None, plant=None):
    """Run one cell; returns (exit code, result dict or None).  `device`,
    `cell` (a spec.Cell) and `plant` (a callable given the System before
    the check, to break it) are for the CPU tests; the command line
    always runs on CUDA."""
    args = parse_args(argv)
    _environment()
    import torch

    from benchmark import check, roofline, spec, trace as tracing, window
    from benchmark.system import STEPS, System

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    def synchronize():
        if on_card:
            torch.cuda.synchronize(device)

    marks = {"imports": time.perf_counter() - START}
    cell = cell or spec.load_cell(args.workload)
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    if on_card:
        from gan2shape_torch.ops import _cuda
        _cuda.build()
    marks["kernels"] = time.perf_counter() - START
    system = System(cell, args.seed, device)
    marks["system"] = time.perf_counter() - START
    if plant is not None:
        plant(system)

    # the correctness check's first steps: also the warm-up of each step
    n_check = int(cell.traffic["check_iters"])
    failed_setup = []
    try:
        program, *check_inputs = check.first_steps(system, n_check,
                                                   synchronize)
    except Exception as exc:  # the check reads the program as it fails
        failed_setup.append(repr(exc))
        program = None
    marks["check_steps"] = time.perf_counter() - START

    flops = None
    if args.trace:
        flops = roofline.count_flops(system, STEPS, synchronize)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if on_card else [])):
            torch.zeros(1, device=device).add_(1)
            synchronize()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    peak = roofline.peak_flops(cell.config.get("act_dtype", "float32"))
    synchronize()
    setup_s = time.perf_counter() - START

    host_before = _host_state()
    win = window.run(system, cell.traffic, args.seconds, synchronize,
                     trace=bool(args.trace))
    host = _host_delta(host_before, _host_state(), win.wall)
    peak_bytes = (torch.cuda.max_memory_allocated(device) if on_card
                  else 0)

    problems = list(failed_setup) + list(win.errors)
    if abs(sum(win.terms.values()) - win.wall) > 0.01 * win.wall:
        problems.append(f"the terms sum to {sum(win.terms.values())} s of "
                        f"a {win.wall} s window")
    short = [s for s in STEPS if win.iterations(s) < 5]
    if short and not win.errors:
        problems.append(f"fewer than 5 iterations in the window of "
                        f"{', '.join(short)}")

    trace = None
    if win.profiled is not None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="g2s_trace_")
        os.close(fd)
        try:
            win.profiled.export_chrome_trace(path)
            trace = tracing.load(path)
        finally:
            os.unlink(path)
        win.profiled = None

    # the program's state goes before the reference runs
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if program is not None:
        want = check.reference_readings(cell.config, args.seed,
                                        *check_inputs, n_check, device,
                                        program)
        readings = check.gaps(program, want)
    else:
        readings = {}
    reference_s = time.perf_counter() - t_ref
    correct, rows = check.judge(readings, cell.limits)
    correct = correct and win.failed == 0 and not problems

    run = Run(cell, win, window.full_counts(cell.traffic), setup_s,
              peak_bytes, trace, flops, peak)
    metrics = {}
    chosen = cell.per_layer if args.trace else cell.end_to_end
    for m in chosen:
        value = spec.load_reader(m["name"])(run)
        if _finite(value) is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace is not None:
        lo, hi = tracing.stage(trace)
        acts = tracing.within(trace["activities"], lo, hi)
        dev["busy_s"] = tracing.busy_us(acts) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = tracing.breakdown(trace)
    result["checks"] = {k: {"value": _finite(v), "limit": lim}
                        for k, v, lim in rows}

    found = jax_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3, None
    for p in problems:
        print(f"problem: {p}", file=sys.stderr)
    print(f"terms {json.dumps(win.terms)} window {win.wall} s, instances "
          f"{win.instances}, iterations "
          f"{ {s: win.iterations(s) for s in STEPS} }", file=sys.stderr)
    print("blocks (step, iterations, ms an iteration) "
          + json.dumps([[b["step"], b["n"], round(1e3 * b["seconds"] / b["n"], 2)]
                        for b in win.blocks]), file=sys.stderr)
    print(f"seconds: set-up {json.dumps(marks)}, reference "
          f"{reference_s}", file=sys.stderr)
    print(f"host over the window {json.dumps(host)}", file=sys.stderr)
    if trace is not None:
        calls = {}
        for entry, least in win.kernel_calls:
            calls.setdefault(entry, [0, 0.0])
            calls[entry][0] += 1
            calls[entry][1] += least
        print(f"kernel calls (entry: calls, least s) {json.dumps(calls)}; "
              f"launch times found for {len(trace['launched'])} of "
              f"{len(trace['activities'])} device activities",
              file=sys.stderr)
    print("readings not compared " + json.dumps(
        {k: _finite(v) for k, v in readings.items()
         if k not in cell.limits}), file=sys.stderr)
    for k, v, lim in rows:
        print(f"{k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0, result


if __name__ == "__main__":
    code, _ = main()
    sys.exit(code)
