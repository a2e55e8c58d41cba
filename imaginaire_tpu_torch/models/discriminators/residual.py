"""Global residual discriminator (port of
``imaginaire_tpu/models/discriminators/residual.py``).

A first conv, then per layer a residual block that doubles the width (up
to ``max_num_filters``) and a 2x average pool, then the aggregation (a
4x4 valid conv, ``conv``, or a global average, ``pool``) and a linear
classifier to one logit. Returns (logits (B, 1), the aggregated
features, the input images), as the JAX module does. NCHW. The
classifier is flax's ``Dense``, whose kernel the JAX package draws with
flax's own LeCun normal rather than the trainer's init (``Dense``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.layers import Conv2dBlock, Res2dBlock
from imaginaire_tpu_torch.layers.state import cast_param
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy

AGGREGATIONS = ("conv", "pool")


class Dense(nn.Linear):
    """flax's ``Dense``: drawn by its own default, LeCun normal (a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in),
    with a zero bias, whatever the trainer's init."""

    @torch.no_grad()
    def draw_own_init(self, generator):
        w = self.weight
        std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        z = torch.randn(w.shape, generator=generator, device=w.device)
        while True:  # redraw the tails
            bad = z.abs() > 2.0
            if not bad.any():
                break
            z[bad] = torch.randn(int(bad.sum()), generator=generator, device=w.device)
        w.copy_(z * std)
        self.bias.zero_()


class ResDiscriminator(nn.Module):
    def __init__(self, in_channels=3, num_filters=64, max_num_filters=512,
                 first_kernel_size=1, num_layers=4, padding_mode="zeros",
                 activation_norm_type="", weight_norm_type="", aggregation="conv",
                 order="pre_act", remat="none"):
        super().__init__()
        if aggregation not in AGGREGATIONS:
            raise ValueError(f"The aggregation mode {aggregation!r} is not recognized")
        common = dict(padding_mode=padding_mode, activation_norm_type=activation_norm_type,
                      weight_norm_type=weight_norm_type, nonlinearity="leakyrelu")
        self.num_layers, self.aggregation = num_layers, aggregation
        self.remat = resolve_policy(remat, where="dis.remat")
        nf = num_filters
        self.conv_first = Conv2dBlock(in_channels, nf, kernel_size=first_kernel_size,
                                      stride=1, padding=(first_kernel_size - 1) // 2,
                                      **common)
        for i in range(num_layers):
            nf_prev, nf = nf, min(nf * 2, max_num_filters)
            self.add_module(f"res_{i}", Res2dBlock(nf_prev, nf, order=order, **common))
        if aggregation == "conv":
            self.agg = Conv2dBlock(nf, nf, kernel_size=4, stride=1, padding=0,
                                   nonlinearity="leakyrelu")
        self.classifier = Dense(nf, 1)

    def forward(self, images):
        x = self.conv_first(images)
        for i in range(self.num_layers):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
            x = F.avg_pool2d(x, 2, 2)
        if self.aggregation == "pool":
            x = x.mean(dim=(2, 3), keepdim=True)
        else:
            x = self.agg(x)
        if x.shape[2:] != (1, 1):
            raise ValueError(f"the classifier takes the aggregated 1x1 map; got "
                             f"{tuple(x.shape[2:])} (the input size does not fit "
                             f"{self.num_layers} layers and the {self.aggregation!r} "
                             "aggregation)")
        features = x
        fc = self.classifier
        outputs = F.linear(x.reshape(x.shape[0], -1), cast_param(fc, fc.weight).to(x.dtype),
                           cast_param(fc, fc.bias).to(x.dtype))
        return outputs, features, images
