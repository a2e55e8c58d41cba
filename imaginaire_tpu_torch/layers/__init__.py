"""The port's layer library (NCHW)."""

from imaginaire_tpu_torch.layers.conv import Conv2dBlock, LinearBlock
from imaginaire_tpu_torch.layers.residual import Res2dBlock

__all__ = ["Conv2dBlock", "LinearBlock", "Res2dBlock"]
