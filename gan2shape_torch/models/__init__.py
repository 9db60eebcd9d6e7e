from gan2shape_torch.models.stylegan2 import Generator, Discriminator
from gan2shape_torch.models.networks import (
    ViewpointNet, LightingNet, DepthNet, AlbedoNet, OffsetEncoder,
)
from gan2shape_torch.models.lpips import LPIPS

__all__ = [
    "Generator", "Discriminator",
    "ViewpointNet", "LightingNet", "DepthNet", "AlbedoNet", "OffsetEncoder",
    "LPIPS",
]
