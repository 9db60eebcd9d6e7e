"""Timing of the port's rasterizer winner passes on pseudo-sample-scale
inputs, the counterpart of the JAX package's tools/bench_raster.py.

The inputs are those of the JAX tool: B views of one depth map (Gaussian
filtered noise, sigma 6 px, mapped to 1 + 0.08 tanh(4 x)) under poses
uniform in +-0.25 (translations x 0.2), warped and projected by the port's
`Renderer`, fresh for every repetition.  Each line times the port function
whose kernels are the counterpart of the JAX line's Pallas kernel:

  mega                 `raster_mega` (placement + candidate tests; B3)
  mega_v2              `winner_keys`, the same kernels as packed keys (B1)
  bufwinner            the buffers built by the plain version, then the
                       candidate-test kernel alone (B2)
  grid_e2e             `rasterize_depth(mode="grid")`, the training path
  invwarp, scatter     the two torch winner passes

On the GPU a repetition is timed by CUDA events around the call; on the CPU
by the host clock.  The least of --reps repetitions is printed.  Then the
agreement of `raster_mega` with `dense_winner` (the plain buffers path) on
one more draw, which must be exactly 1.

    python -m gan2shape_torch.tools.bench_raster [--size 128] [--batch 16]
    python -m gan2shape_torch.tools.bench_raster --device cpu --size 32 \
        --batch 2

Exits non-zero when the agreement is below 1.
"""

import argparse
import sys
import time

import numpy as np
import torch

from gan2shape_torch.device import describe, resolve_device, synchronize
from gan2shape_torch.ops.rasterize import (
    _winner_pass, _winner_pass_invwarp, build_winner_buffers_plain,
    dense_winner, raster_mega, raster_tests, rasterize_depth, winner_keys,
)
from gan2shape_torch.rendering.renderer import (
    Renderer, get_transform_matrices,
)

WINDOW = 3
CONFIG = {"rot_center_depth": 1.0, "fov": 10}


def gaussian_filter(x, sigma, truncate=4.0):
    """scipy.ndimage.gaussian_filter of a 2-D float32 array in its default
    'reflect' mode: two separable passes in f64, each rounded to f32."""
    radius = int(truncate * sigma + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (t / sigma) ** 2)
    kernel /= kernel.sum()
    out = np.asarray(x, np.float32)
    for axis in range(2):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (radius, radius)
        padded = np.pad(out, pad, mode="symmetric").astype(np.float64)
        n = out.shape[axis]
        acc = np.zeros(out.shape, np.float64)
        for i, k in enumerate(kernel):
            acc += k * np.take(padded, np.arange(i, i + n), axis=axis)
        out = acc.astype(np.float32)
    return out


def pseudo_sample_scene(rng, size, batch):
    """(depth (B, S, S), views (B, 6)) in numpy: one smooth depth map in
    [0.92, 1.08] repeated, and B poses."""
    base = gaussian_filter(rng.standard_normal((size, size))
                           .astype(np.float32), 6.0)
    depth0 = 1.0 + 0.08 * np.tanh(4 * base)
    depth = np.broadcast_to(depth0, (batch, size, size)).astype(np.float32)
    views = rng.uniform(-0.25, 0.25, (batch, 6)).astype(np.float32)
    views[:, 3:] *= 0.2
    return depth, views


def screen_vertices(renderer, depth, views):
    """The warped grid of `depth` under `views`, projected: (vx, vy, vz),
    each (B, S, S) on the renderer's device."""
    b, h, w = depth.shape
    dev = renderer.device
    rot, trans = get_transform_matrices(torch.as_tensor(views, device=dev))
    pts = renderer.get_warped_3d_grid(torch.as_tensor(depth, device=dev),
                                      rot, trans).reshape(b, -1, 3)
    xs, ys, zs = renderer._project_screen(pts)
    return tuple(v.reshape(b, h, w).contiguous() for v in (xs, ys, zs))


class Bench:
    """The winner passes of one renderer on fresh inputs from one
    generator."""

    def __init__(self, size=128, batch=16, device=None, seed=0):
        self.device = resolve_device(device)
        self.size, self.batch = size, batch
        self.renderer = Renderer(CONFIG, size, 0.9, 1.1, device=self.device)
        self.near = self.renderer.min_depth - self.renderer.margin
        self.far = self.renderer.max_depth + self.renderer.margin
        self.rng = np.random.default_rng(seed)

    def inputs(self):
        return screen_vertices(self.renderer, *pseudo_sample_scene(
            self.rng, self.size, self.batch))

    def passes(self):
        """{name: fn(vx, vy, vz)} in the JAX tool's order."""
        s, b, win, near, far = (self.size, self.batch, WINDOW, self.near,
                                self.far)
        faces = self.renderer.faces

        def flat(v):
            return v.reshape(b, -1)

        return {
            "mega": lambda vx, vy, vz: raster_mega(vx, vy, vz, win, near,
                                                   far),
            "mega_v2": lambda vx, vy, vz: winner_keys(vx, vy, vz, win, near,
                                                      far),
            "bufwinner": lambda vx, vy, vz: raster_tests(
                build_winner_buffers_plain(vx, vy, vz, win, near, far), s, s,
                win, near, far),
            "grid_e2e": lambda vx, vy, vz: rasterize_depth(
                flat(vx), flat(vy), flat(vz), faces, s, s, window=win,
                near=near, far=far, mode="grid"),
            "invwarp": lambda vx, vy, vz: _winner_pass_invwarp(
                flat(vx), flat(vy), flat(vz), s, s, search=1),
            "scatter": lambda vx, vy, vz: _winner_pass(
                flat(vx), flat(vy), flat(vz), faces, s, s, 5),
        }

    def elapsed_ms(self, fn):
        """Milliseconds of fn() by CUDA events (host clock on the CPU),
        its inputs already made and synchronised."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def time_pass(self, fn, reps):
        """Least ms of `reps` calls, each on fresh inputs, after one warm-up
        call (which builds the kernels)."""
        fn(*self.inputs())
        best = float("inf")
        for _ in range(reps):
            ins = self.inputs()
            synchronize(self.device)
            best = min(best, self.elapsed_ms(lambda: fn(*ins)))
        return best

    def agreement(self):
        """Share of pixels where `raster_mega`'s (cell, parity) equal the
        plain buffers path's on one fresh draw."""
        ins = self.inputs()
        args = (WINDOW, self.near, self.far)
        cv, pv, _ = raster_mega(*ins, *args)
        cx, px, _ = dense_winner(*ins, *args)
        return float(((cv == cx) & (pv == px)).float().mean())


def run(size=128, batch=16, reps=5, device=None, seed=0):
    """Prints a line per pass and the agreement; returns {"device", "size",
    "batch", "window", "ms": {name: ms}, "agreement"}."""
    bench = Bench(size, batch, device, seed)
    label = describe(bench.device)
    print(f"device={label} size={size} batch={batch} window={WINDOW}",
          flush=True)
    times = {}
    for name, fn in bench.passes().items():
        times[name] = ms = bench.time_pass(fn, reps)
        print(f"{name:28s} {ms:10.4f} ms  ({ms / batch:8.4f} ms/item)",
              flush=True)
    agree = bench.agreement()
    print(f"raster_mega winner agreement vs dense_winner: {agree:.5f}",
          flush=True)
    return {"device": label, "size": size, "batch": batch, "window": WINDOW,
            "ms": times, "agreement": agree}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    result = run(args.size, args.batch, args.reps, args.device)
    return 0 if result["agreement"] == 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
