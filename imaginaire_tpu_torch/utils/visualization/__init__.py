"""Image output helpers (port of part of
``imaginaire_tpu/utils/visualization/``)."""

from imaginaire_tpu_torch.utils.visualization.common import (
    save_image_grid,
    save_tensor_strip,
    tensor2im,
)

__all__ = ["save_image_grid", "save_tensor_strip", "tensor2im"]
