"""Numerical check of the port's rasterizer winner passes on one device, the
counterpart of the JAX package's tools/check_raster_tpu.py:

  * `raster_mega`, the counterpart of `_raster_mega_pallas` (on a GPU the
    placement and candidate-test kernels of csrc/raster.cu), against the
    buffers path `dense_winner` on identical vertices;
  * 'grid' depth against the exact 'scatter' z-buffer, at windows 5 and 3;
  * 'invwarp' depth against 'scatter' on three training-scale views.

    python -m gan2shape_torch.tools.check_raster          # on the GPU
    python -m gan2shape_torch.tools.check_raster --device cpu --sizes 64 \
        --batch 2                                         # small, on the CPU

Prints one JSON object and exits non-zero if any check fails.  Writes no
file.
"""

import argparse
import json
import sys

import numpy as np
import torch

from gan2shape_torch.device import resolve_device
from gan2shape_torch.ops.rasterize import dense_winner, raster_mega
from gan2shape_torch.rendering.renderer import (
    Renderer, get_transform_matrices,
)

# kernel against the buffers path: the same function, so the same winners
# up to f32 ties
MIN_WINNER_AGREE = 0.99
# grid against the exact z-buffer over training poses: total agreement dips
# where large rotations lose coverage (masked downstream); where grid claims
# coverage the depth must match
MIN_DEPTH_AGREE = 0.96
MIN_COVERED_AGREE = 0.998
DEPTH_ATOL = 2e-3
CFG = {"rot_center_depth": 1.0, "fov": 10}
# invwarp against scatter on training-scale views, each with its least
# agreement: at 64 px the JAX package's own test limits; at 128 px its
# search of 2 cells covers half the warp in pixels, and the JAX invwarp
# itself agrees 1.0, 0.9964 and 0.9691 on this check's inputs
# (tests/test_torch_zbuffer.py::test_invwarp_128px_on_check_inputs_matches_jax
# holds JAX to these limits and the port to JAX)
INVWARP_VIEWS = ([0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                 [0.12, -0.2, 0.05, 0.02, -0.02, 0.03],
                 [-0.25, 0.3, -0.1, -0.05, 0.04, -0.06])
INVWARP_MIN = {64: (1.0, 0.995, 0.985), 128: (1.0, 0.99, 0.96)}


def _training_depth(rng, s):
    """Training-regime depth: an ellipsoid-prior shape plus a smooth
    residue, clipped to the depth range."""
    from scipy.ndimage import gaussian_filter
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    r2 = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) / (0.45 * s) ** 2
    ell = np.where(r2 < 1, 1.02 - 0.11 * np.sqrt(np.clip(1 - r2, 0, 1)),
                   1.02)
    noise = gaussian_filter(rng.uniform(-1, 1, (s, s)).astype(np.float32),
                            3.0)
    return np.clip(ell + 0.03 * noise, 0.9, 1.1).astype(np.float32)


def _training_views(rng, b):
    """Poses of the reference sampler's scale (std 0.2 per component)
    through the model's view scaling (60 degrees, 0.1 translation)."""
    v = (0.2 * rng.standard_normal((b, 6))).astype(np.float32)
    return np.concatenate([v[:, :3] * np.pi / 180 * 60, v[:, 3:5] * 0.1,
                           v[:, 5:] * 0.1], 1).astype(np.float32)


def _frac(mask):
    return float(mask.float().mean())


def scenes(sizes, batch, seed):
    """Yield (s, depth (S, S), views (batch, 6)) in numpy for each size, in
    the order `run_checks` draws them from one generator."""
    rng = np.random.default_rng(seed)
    for s in sizes:
        yield s, _training_depth(rng, s), _training_views(rng, batch)


def run_checks(sizes=(64, 128), batch=4, seed=0, device=None):
    """Every check at each image size; `device` is CUDA unless the CPU is
    asked for.  Returns {"ok", "device", "checks": [...]}; the
    `raster_mega` checks also carry the largest absolute difference of the
    (cell, parity, covered) triple from the buffers path."""
    device = resolve_device(device)
    checks = []

    def record(name, agree, least, covered=None, **extra):
        c = {"check": name, "agreement": agree, "min": least, **extra}
        ok = agree >= least
        if covered is not None:  # agreement where grid claims coverage
            c.update(covered_agreement=covered, covered_min=MIN_COVERED_AGREE)
            ok = ok and covered >= MIN_COVERED_AGREE
        c["pass"] = ok
        checks.append(c)

    for s, depth_np, views_np in scenes(sizes, batch, seed):
        r5 = Renderer(dict(CFG, raster_window=5), s, 0.9, 1.1, device=device)
        # the training default, window 3: the same exact winner ranking with
        # a smaller coverage reach
        r3 = Renderer(CFG, s, 0.9, 1.1, device=device)
        depth = torch.as_tensor(
            np.broadcast_to(depth_np, (batch, s, s)).copy(), device=device)
        rot, trans = get_transform_matrices(
            torch.as_tensor(views_np, device=device))
        pts = r5.get_warped_3d_grid(depth, rot, trans).reshape(batch, -1, 3)
        vx, vy, vz = (v.reshape(batch, s, s).contiguous()
                      for v in r5._project_screen(pts))
        near = r5.min_depth - r5.margin
        far = r5.max_depth + r5.margin

        got = raster_mega(vx, vy, vz, 5, near, far)
        want = dense_winner(vx, vy, vz, 5, near, far)
        same = (got[0] == want[0]) & (got[1] == want[1]) & (got[2] == want[2])
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        record(f"raster_mega_vs_buffers_s{s}", _frac(same), MIN_WINNER_AGREE,
               max_abs_err=err)

        d_exact = r5.warp_canon_depth(depth, rot, trans, raster_mode="scatter")
        for rr, tag in ((r5, ""), (r3, "_w3")):
            d_grid = rr.warp_canon_depth(depth, rot, trans, raster_mode="grid")
            close = torch.isclose(d_grid, d_exact, atol=DEPTH_ATOL)
            covered = ~torch.isclose(d_grid, d_grid.new_tensor(far))
            record(f"grid_depth_vs_scatter_s{s}{tag}", _frac(close),
                   MIN_DEPTH_AGREE, covered=_frac(close[covered]))

        rot, trans = get_transform_matrices(
            torch.tensor(INVWARP_VIEWS, device=device))
        d0 = depth[:1].expand(len(INVWARP_VIEWS), s, s)
        d_sc = r5.warp_canon_depth(d0, rot, trans, raster_mode="scatter")
        d_inv = r5.warp_canon_depth(d0, rot, trans, raster_mode="invwarp")
        close = torch.isclose(d_inv, d_sc, atol=DEPTH_ATOL)
        limits = INVWARP_MIN[64 if s <= 64 else 128]
        for i, least in enumerate(limits):
            record(f"invwarp_vs_scatter_s{s}_view{i}", _frac(close[i]), least)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"ok": all(c["pass"] for c in checks), "device": name,
            "checks": checks}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[64, 128])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    results = run_checks(tuple(args.sizes), args.batch, args.seed,
                         args.device)
    print(json.dumps(results, indent=1))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
