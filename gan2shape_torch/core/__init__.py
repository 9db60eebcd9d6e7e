from gan2shape_torch.core.model import GAN2Shape, ViewLightSampler
from gan2shape_torch.core.trainer import (
    GeneralizingTrainer, GeneralizingTrainer2, Trainer,
)

__all__ = ["GAN2Shape", "ViewLightSampler", "Trainer", "GeneralizingTrainer",
           "GeneralizingTrainer2"]
