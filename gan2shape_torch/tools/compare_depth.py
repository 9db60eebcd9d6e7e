"""Depth-MAD between two sets of depth maps, the counterpart of the JAX
package's tools/compare_depth.py: mean absolute difference statistics over
the pixels where both maps are finite (and a mask, if given, is set).

    python -m gan2shape_torch.tools.compare_depth ours.npy theirs.npy \
        [--mask masks.npy]

Accepts .npy arrays shaped (N, H, W) or (H, W); NaNs in either input are
background and excluded.  Prints one JSON object.
"""

import argparse
import json
import sys

import numpy as np


def depth_mad(a, b, mask=None):
    """{mad, median_ad, p95_ad, per_image_mad, n_images, valid_fraction} of
    |a - b| in f64 over the valid pixels; an image without a valid pixel
    has a per-image MAD of NaN."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[None]
    if b.ndim == 2:
        b = b[None]
    if a.shape != b.shape:
        raise ValueError(f"depth maps differ in shape: {a.shape} and "
                         f"{b.shape}")
    valid = np.isfinite(a) & np.isfinite(b)
    if mask is not None:
        valid &= np.asarray(mask) > 0.5
    diff = np.abs(a - b)
    per_image = [float(diff[i][valid[i]].mean()) if valid[i].any()
                 else float("nan") for i in range(len(a))]
    flat = diff[valid]
    return {
        "mad": float(flat.mean()),
        "median_ad": float(np.median(flat)),
        "p95_ad": float(np.percentile(flat, 95)),
        "per_image_mad": per_image,
        "n_images": len(a),
        "valid_fraction": float(valid.mean()),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="depth-MAD parity")
    parser.add_argument("ours")
    parser.add_argument("theirs")
    parser.add_argument("--mask", default=None)
    args = parser.parse_args(argv)
    mask = np.load(args.mask) if args.mask else None
    print(json.dumps(depth_mad(np.load(args.ours), np.load(args.theirs),
                               mask), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
