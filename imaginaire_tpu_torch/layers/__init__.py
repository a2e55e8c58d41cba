"""The port's layer library (NCHW)."""

from imaginaire_tpu_torch.layers.conv import Conv2dBlock, HyperConv2dBlock, LinearBlock
from imaginaire_tpu_torch.layers.residual import HyperRes2dBlock, Res2dBlock, UpRes2dBlock

__all__ = ["Conv2dBlock", "HyperConv2dBlock", "HyperRes2dBlock", "LinearBlock",
           "Res2dBlock", "UpRes2dBlock"]
