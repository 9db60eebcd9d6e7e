from gan2shape_torch.core.model import GAN2Shape, ViewLightSampler
from gan2shape_torch.core.trainer import Trainer

__all__ = ["GAN2Shape", "ViewLightSampler", "Trainer"]
