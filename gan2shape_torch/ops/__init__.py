from gan2shape_torch.ops.upfirdn2d import upfirdn2d, setup_filter
from gan2shape_torch.ops.fused_act import (
    bias_act, fused_leaky_relu, inverse_fused_leaky_relu,
)
from gan2shape_torch.ops.grid_sample import grid_sample, grid_sample_im_mask
from gan2shape_torch.ops.resize import resize, crop
from gan2shape_torch.ops.rasterize import rasterize_depth

__all__ = [
    "upfirdn2d", "setup_filter",
    "bias_act", "fused_leaky_relu", "inverse_fused_leaky_relu",
    "grid_sample", "grid_sample_im_mask", "resize", "crop", "rasterize_depth",
]
