"""COCO-FUNIT generator (port of ``imaginaire_tpu/models/generators/coco_funit.py``).

FUNIT whose decoder is conditioned on a content-conditioned style: the
style code, beside a learned universal style bias ``usb`` (1,
``usb_dims``), goes through ``mlp_style``; the content code's spatial
mean goes through ``mlp_content``; their product goes through ``mlp`` to
the AdaIN conditioning vector. ``usb`` is drawn as the JAX package draws
it, by flax's ``normal(1.0)``, whatever the trainer's init
(``draw_own_init``). NCHW; submodule names follow the JAX parameter
tree.
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers.state import cast_param
from imaginaire_tpu_torch.models.generators.funit import FUNITTranslator
from imaginaire_tpu_torch.models.generators.funit import Generator as FUNITGenerator
from imaginaire_tpu_torch.models.generators.munit import MLP


class COCOFUNITTranslator(FUNITTranslator):
    def __init__(self, gen_cfg):
        super().__init__(gen_cfg)
        g = as_attrdict(gen_cfg)
        num_filters_mlp = cfg_get(g, "num_filters_mlp", 256)
        usb_dims = cfg_get(g, "usb_dims", 1024)
        self.usb = nn.Parameter(torch.empty(1, usb_dims))
        self.mlp_content = MLP(self.content_encoder.out_channels, output_dim=self.style_dims,
                               latent_dim=num_filters_mlp, num_layers=2)
        self.mlp_style = MLP(self.style_dims + usb_dims, output_dim=self.style_dims,
                             latent_dim=num_filters_mlp, num_layers=2)

    @torch.no_grad()
    def draw_own_init(self, generator):
        """flax's ``normal(1.0)``: a standard normal ``usb``."""
        self.usb.copy_(torch.randn(self.usb.shape, generator=generator,
                                   device=self.usb.device))

    def decode(self, content, style):
        content_style = self.mlp_content(content.mean(dim=(2, 3)))
        b = style.shape[0]
        usb = cast_param(self, self.usb).to(style.dtype).expand(b, -1)
        style_in = self.mlp_style(torch.cat([style.reshape(b, -1), usb], dim=1))
        return self.decoder(content, self.mlp(style_in * content_style))


class Generator(FUNITGenerator):
    translator_cls = COCOFUNITTranslator
