"""No-op discriminator of the default config (port of
``imaginaire_tpu/models/discriminators/dummy.py``): no parameters, and
every call returns an empty dict."""

from __future__ import annotations

from torch import nn


class Discriminator(nn.Module):
    def __init__(self, dis_cfg=None, data_cfg=None):
        super().__init__()

    def forward(self, data, net_G_output, **kwargs):
        return {}
