"""No-op generator of the default config (port of
``imaginaire_tpu/models/generators/dummy.py``): no parameters, and every
call returns an empty dict."""

from __future__ import annotations

from torch import nn


class Generator(nn.Module):
    def __init__(self, gen_cfg=None, data_cfg=None):
        super().__init__()

    def forward(self, data, **kwargs):
        return {}

    def inference(self, data, **kwargs):
        return {}
