from gan2shape_torch.rendering.renderer import (
    Renderer, get_rotation_matrix, get_transform_matrices,
)

__all__ = ["Renderer", "get_rotation_matrix", "get_transform_matrices"]
