"""Per-call time of the port's rasterizer winner kernels in a dependent
chain, the counterpart of the JAX package's tools/chain_raster.py.

N calls run back to back, each on the previous call's vertices moved by
1e-6 x its winner cells, with no host synchronisation inside the chain, so
the calls cannot overlap or be skipped.  Two chain lengths (N / 10, at least
2, and N) each run twice on inputs shifted by a different epsilon; the
per-call time is the slope between the shorter run of each length.  On the
GPU a chain is timed by CUDA events, on the CPU by the host clock.  The
inputs are bench_raster's pseudo-sample scene.

    python -m gan2shape_torch.tools.chain_raster \
        [--impl mega|mega_v2|bufwinner] [--n 20] [--size 128] [--batch 16] \
        [--device cpu]

  mega       `raster_mega` (B3's counterpart)
  mega_v2    `winner_keys`, decoded to cells (B1's)
  bufwinner  the plain version's buffers, then the candidate-test kernel
             (B2's)
"""

import argparse
import sys

from gan2shape_torch.device import describe, synchronize
from gan2shape_torch.ops.rasterize import (
    _winner_cells, build_winner_buffers_plain, raster_mega, raster_tests,
    winner_keys,
)
from gan2shape_torch.tools.bench_raster import WINDOW, Bench

IMPLS = ("mega", "mega_v2", "bufwinner")


def winner_cells(impl, size, near, far):
    """fn(vx, vy, vz) -> the (B, S, S) f32 winner cells of `impl`."""
    args = (WINDOW, near, far)
    if impl == "mega":
        return lambda vx, vy, vz: raster_mega(vx, vy, vz, *args)[0]
    if impl == "mega_v2":
        return lambda vx, vy, vz: _winner_cells(
            winner_keys(vx, vy, vz, *args))[0]
    if impl == "bufwinner":
        return lambda vx, vy, vz: _winner_cells(raster_tests(
            build_winner_buffers_plain(vx, vy, vz, *args), size, size,
            *args))[0]
    raise ValueError(f"impl {impl!r} is not one of {IMPLS}")


def per_call(impl="mega", n=20, size=128, batch=16, device=None, seed=0):
    """{"impl", "ms_per_call", "ms_per_item", "n_small", "t_small_ms",
    "n_big", "t_big_ms", "device"} of chains of `impl`."""
    bench = Bench(size, batch, device, seed)
    call = winner_cells(impl, size, bench.near, bench.far)
    vx, vy, vz = bench.inputs()

    def chain(v, length):
        picks = []
        for _ in range(length):
            cell = call(v, vy, vz)
            v = v + 1e-6 * cell
            picks.append(cell[0, 0])
        return picks

    def run(length, eps):
        v = vx + eps
        synchronize(bench.device)
        return bench.elapsed_ms(lambda: chain(v, length))

    n_small, n_big = max(2, n // 10), n
    for length in (n_small, n_big):  # warm-up: builds the kernels
        chain(vx, length)
    t_small = min(run(n_small, 1e-5), run(n_small, 2e-5))
    t_big = min(run(n_big, 3e-5), run(n_big, 4e-5))
    ms = (t_big - t_small) / (n_big - n_small)
    return {"impl": impl, "ms_per_call": ms, "ms_per_item": ms / batch,
            "n_small": n_small, "t_small_ms": t_small, "n_big": n_big,
            "t_big_ms": t_big, "device": describe(bench.device)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--impl", default="mega", choices=IMPLS)
    parser.add_argument("--n", type=int, default=20)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    r = per_call(args.impl, args.n, args.size, args.batch, args.device)
    print(f"{r['impl']}: {r['ms_per_call']:.4f} ms/call "
          f"({r['ms_per_item']:.5f} ms/item, batch {args.batch}, size "
          f"{args.size}; t[{r['n_small']}]={r['t_small_ms']:.3f}ms "
          f"t[{r['n_big']}]={r['t_big_ms']:.3f}ms; {r['device']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
