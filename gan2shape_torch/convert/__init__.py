from gan2shape_torch.convert.jax2torch import load_into
from gan2shape_torch.convert.reference import build_frozen_assets

__all__ = ["load_into", "build_frozen_assets"]
