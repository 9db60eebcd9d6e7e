from gan2shape_torch.convert.jax2torch import load_into

__all__ = ["load_into"]
