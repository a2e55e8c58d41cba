"""Improved-MUNIT generator (port of ``imaginaire_tpu/models/generators/munit.py``).

Each domain's autoencoder is UNIT's ``ContentEncoder``, a
``StyleEncoder`` that pools the image to a small style code, an ``MLP``
that maps the code to the AdaIN conditioning vector, and an
``AdaINDecoder`` whose every residual block and upsampling conv
normalizes with AdaIN (instance statistics, gamma and beta projected
from that vector). Translation mixes one domain's content with a style
drawn from the prior. AdaIN's gamma and beta broadcast over space, so no
kernel of the port runs here.

The style draws (``random_style``) are arguments: ``noise`` = (z_a, z_b)
for ``forward`` and z for ``inference``, else they are drawn from
``generator``, in the style code's type. The JAX package draws them from
its ``noise`` rng. NCHW; submodule names follow the JAX parameter tree,
and each sub-network is called in the JAX forward's order.
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, LinearBlock, Res2dBlock
from imaginaire_tpu_torch.models.generators.unit import (
    _refuse_noise,
    content_encoder_from_config,
)
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.misc import upsample_2x


class StyleEncoder(nn.Module):
    """conv7, two stride-2 conv4s that double the width, then
    ``num_downsamples - 2`` more at that width, a global average pool and
    a linear layer to ``style_channels``."""

    def __init__(self, num_downsamples=4, in_channels=3, num_filters=64,
                 style_channels=8, padding_mode="reflect", activation_norm_type="",
                 weight_norm_type="", nonlinearity="relu"):
        super().__init__()
        common = dict(padding_mode=padding_mode, activation_norm_type=activation_norm_type,
                      weight_norm_type=weight_norm_type, nonlinearity=nonlinearity)
        self.num_downsamples = num_downsamples
        nf = num_filters
        self.conv_in = Conv2dBlock(in_channels, nf, 7, stride=1, padding=3, **common)
        for i in range(2):
            self.add_module(f"down_{i}", Conv2dBlock(nf, nf * 2, 4, stride=2, padding=1,
                                                     **common))
            nf *= 2
        for i in range(2, num_downsamples):
            self.add_module(f"down_{i}", Conv2dBlock(nf, nf, 4, stride=2, padding=1,
                                                     **common))
        self.fc_out = LinearBlock(nf, style_channels, order="C")

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(max(self.num_downsamples, 2)):
            x = getattr(self, f"down_{i}")(x)
        return self.fc_out(x.mean(dim=(2, 3)))


class MLP(nn.Module):
    """Style code -> AdaIN conditioning vector: ``num_layers`` linear
    layers, each followed by the nonlinearity (the last one too)."""

    def __init__(self, in_features, output_dim=256, latent_dim=256, num_layers=2,
                 nonlinearity="relu"):
        super().__init__()
        self.num_layers = num_layers
        self.fc_in = LinearBlock(in_features, latent_dim, nonlinearity=nonlinearity)
        for i in range(num_layers - 2):
            self.add_module(f"fc_{i}", LinearBlock(latent_dim, latent_dim,
                                                   nonlinearity=nonlinearity))
        self.fc_out = LinearBlock(latent_dim, output_dim, nonlinearity=nonlinearity)

    def forward(self, x):
        x = self.fc_in(x.reshape(x.shape[0], -1))
        for i in range(self.num_layers - 2):
            x = getattr(self, f"fc_{i}")(x)
        return self.fc_out(x)


class AdaINDecoder(nn.Module):
    """UNIT's decoder with AdaIN norms conditioned on ``style`` (the
    MLP's output, ``style_channels`` wide) in the residual blocks and the
    upsampling convs; the output conv7 has no norm."""

    def __init__(self, in_channels, num_upsamples=2, num_res_blocks=4,
                 num_image_channels=3, style_channels=256, padding_mode="reflect",
                 activation_norm_type="instance", weight_norm_type="",
                 nonlinearity="relu", output_nonlinearity="", pre_act=False,
                 apply_noise=False, remat="none"):
        super().__init__()
        _refuse_noise(apply_noise)
        adain = {"cond_dims": style_channels,
                 "activation_norm_type": activation_norm_type or "instance"}
        common = dict(padding_mode=padding_mode, weight_norm_type=weight_norm_type,
                      nonlinearity=nonlinearity, activation_norm_type="adaptive",
                      activation_norm_params=adain)
        self.num_upsamples, self.num_res_blocks = num_upsamples, num_res_blocks
        self.remat = resolve_policy(remat, where="gen.remat")
        order = "pre_act" if pre_act else "CNACNA"
        nf = in_channels
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", Res2dBlock(nf, nf, order=order, **common))
        for i in range(num_upsamples):
            self.add_module(f"up_{i}", Conv2dBlock(nf, nf // 2, 5, stride=1, padding=2,
                                                   **common))
            nf //= 2
        self.conv_out = Conv2dBlock(nf, num_image_channels, 7, stride=1, padding=3,
                                    padding_mode=padding_mode,
                                    nonlinearity=output_nonlinearity)

    def forward(self, x, style):
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x, style)
        for i in range(self.num_upsamples):
            x = getattr(self, f"up_{i}")(upsample_2x(x), style)
        return self.conv_out(x)


class AutoEncoder(nn.Module):
    def __init__(self, gen_cfg):
        super().__init__()
        g = as_attrdict(gen_cfg)
        self.style_channels = cfg_get(g, "latent_dim", 8)
        num_filters_mlp = cfg_get(g, "num_filters_mlp", 256)
        self.style_encoder = StyleEncoder(
            num_downsamples=cfg_get(g, "num_downsamples_style", 4),
            in_channels=cfg_get(g, "num_image_channels", 3),
            num_filters=cfg_get(g, "num_filters", 64),
            style_channels=self.style_channels,
            activation_norm_type=cfg_get(g, "style_norm_type", ""),
            weight_norm_type=cfg_get(g, "weight_norm_type", ""))
        self.content_encoder = content_encoder_from_config(g)
        self.decoder = AdaINDecoder(
            self.content_encoder.out_channels,
            num_upsamples=cfg_get(g, "num_downsamples_content", 2),
            num_res_blocks=cfg_get(g, "num_res_blocks", 4),
            num_image_channels=cfg_get(g, "num_image_channels", 3),
            style_channels=num_filters_mlp,
            activation_norm_type=cfg_get(g, "decoder_norm_type", "instance"),
            weight_norm_type=cfg_get(g, "weight_norm_type", ""),
            output_nonlinearity=cfg_get(g, "output_nonlinearity", ""),
            pre_act=cfg_get(g, "pre_act", False),
            apply_noise=cfg_get(g, "apply_noise", False),
            remat=cfg_get(g, "remat", "none"))
        self.mlp = MLP(self.style_channels, output_dim=num_filters_mlp,
                       latent_dim=num_filters_mlp,
                       num_layers=cfg_get(g, "num_mlp_blocks", 2))

    def encode(self, images):
        return self.content_encoder(images), self.style_encoder(images)

    def decode(self, content, style):
        return self.decoder(content, self.mlp(style))

    def forward(self, images):
        return self.decode(*self.encode(images))


def draw_style(shape, like, generator=None):
    """Standard normal style codes of ``shape``, in ``like``'s type and
    on its device."""
    z = torch.randn(shape, generator=generator, device=like.device)
    return z.to(like.dtype)


class Generator(nn.Module):
    """``autoencoder_a`` and ``autoencoder_b``. ``forward`` returns the
    contents and styles, the translations ``images_ab`` / ``images_ba``
    under the prior's styles (``random_style``; else each domain's own
    style), and, when asked, the within-domain reconstructions, the
    translations' re-encodings (``latent_recon``) and the cycle."""

    def __init__(self, gen_cfg, data_cfg=None):
        super().__init__()
        self.autoencoder_a = AutoEncoder(gen_cfg)
        self.autoencoder_b = AutoEncoder(gen_cfg)

    def forward(self, data, random_style=True, image_recon=True, latent_recon=True,
                cycle_recon=True, within_latent_recon=False, noise=None,
                generator=None):
        ae_a, ae_b = self.autoencoder_a, self.autoencoder_b
        out = {}
        content_a, style_a = ae_a.encode(data["images_a"])
        content_b, style_b = ae_b.encode(data["images_b"])
        if image_recon:
            out["images_aa"] = ae_a.decode(content_a, style_a)
            out["images_bb"] = ae_b.decode(content_b, style_b)
        if random_style:
            if noise is None:
                noise = (draw_style(style_a.shape, style_a, generator),
                         draw_style(style_b.shape, style_b, generator))
            style_a_rand = noise[0].to(style_a.dtype)
            style_b_rand = noise[1].to(style_b.dtype)
        else:
            style_a_rand, style_b_rand = style_a, style_b
        images_ba = ae_a.decode(content_b, style_a_rand)
        images_ab = ae_b.decode(content_a, style_b_rand)
        if latent_recon or cycle_recon:
            content_ba, style_ba = ae_a.encode(images_ba)
            content_ab, style_ab = ae_b.encode(images_ab)
            out.update(content_ba=content_ba, style_ba=style_ba,
                       content_ab=content_ab, style_ab=style_ab)
        if image_recon and within_latent_recon:
            content_aa, style_aa = ae_a.encode(out["images_aa"])
            content_bb, style_bb = ae_b.encode(out["images_bb"])
            out.update(content_aa=content_aa, style_aa=style_aa,
                       content_bb=content_bb, style_bb=style_bb)
        if cycle_recon:
            out["images_aba"] = ae_a.decode(out["content_ab"], style_a)
            out["images_bab"] = ae_b.decode(out["content_ba"], style_b)
        out.update(content_a=content_a, content_b=content_b, style_a=style_a,
                   style_b=style_b, style_a_rand=style_a_rand, style_b_rand=style_b_rand,
                   images_ba=images_ba, images_ab=images_ab)
        return out

    def inference(self, data, a2b=True, random_style=True, noise=None, generator=None,
                  **kwargs):
        """A's images in B's domain (``a2b``), else B's in A's, under a
        style drawn from the prior (``random_style``: ``noise``, else from
        ``generator``) or the other domain's own images' style."""
        if a2b:
            src, enc, dec = "images_a", self.autoencoder_a, self.autoencoder_b
        else:
            src, enc, dec = "images_b", self.autoencoder_b, self.autoencoder_a
        content = enc.content_encoder(data[src])
        if random_style:
            shape = (content.shape[0], dec.style_channels)
            style = (draw_style(shape, content, generator) if noise is None
                     else noise.to(content.dtype))
        else:
            style = dec.style_encoder(data["images_b" if a2b else "images_a"])
        return dec.decode(content, style)
