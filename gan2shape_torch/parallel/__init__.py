from gan2shape_torch.parallel.sharding import (
    InstanceParallelTrainer, StackedNets,
)

__all__ = ["InstanceParallelTrainer", "StackedNets"]
