"""Improved-UNIT generator (port of ``imaginaire_tpu/models/generators/unit.py``).

Two domain autoencoders of one architecture: a ``ContentEncoder`` (conv7,
a stride-2 ladder, a residual trunk) and a ``Decoder`` (a residual trunk,
a nearest-upsample ladder of conv5s, conv7). Translation decodes domain
A's content with domain B's decoder and the reverse; the cycle
re-encodes the translations. Plain instance norms: no kernel of the port
runs here. NCHW; submodule names follow the JAX parameter tree, and each
sub-network is called in the JAX forward's order, so every spectral-norm
``u`` advances as it does there.
"""

from __future__ import annotations

from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, Res2dBlock
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.misc import upsample_2x


def _refuse_noise(apply_noise):
    if apply_noise:
        raise NotImplementedError("gen.apply_noise (the noise-injection layer) is not "
                                  "in the port yet (ROADMAP.md)")


class ContentEncoder(nn.Module):
    """conv7, ``num_downsamples`` stride-2 conv4s (the width doubling up
    to ``max_num_filters``), ``num_res_blocks`` residual blocks."""

    def __init__(self, num_downsamples=2, num_res_blocks=4, in_channels=3,
                 num_filters=64, max_num_filters=256, padding_mode="reflect",
                 activation_norm_type="instance", weight_norm_type="",
                 nonlinearity="relu", pre_act=False, remat="none"):
        super().__init__()
        common = dict(padding_mode=padding_mode, activation_norm_type=activation_norm_type,
                      weight_norm_type=weight_norm_type, nonlinearity=nonlinearity)
        self.num_downsamples, self.num_res_blocks = num_downsamples, num_res_blocks
        self.remat = resolve_policy(remat, where="gen.remat")
        nf = num_filters
        self.conv_in = Conv2dBlock(in_channels, nf, 7, stride=1, padding=3, **common)
        for i in range(num_downsamples):
            nf_prev, nf = nf, min(nf * 2, max_num_filters)
            self.add_module(f"down_{i}", Conv2dBlock(nf_prev, nf, 4, stride=2, padding=1,
                                                     **common))
        order = "pre_act" if pre_act else "CNACNA"
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", Res2dBlock(nf, nf, order=order, **common))
        self.out_channels = nf

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(self.num_downsamples):
            x = getattr(self, f"down_{i}")(x)
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        return x


class Decoder(nn.Module):
    """``num_res_blocks`` residual blocks, ``num_upsamples`` nearest 2x
    upsamples each followed by a conv5 that halves the width, and conv7
    to the image (``output_nonlinearity``, none by default; no norm)."""

    def __init__(self, in_channels, num_upsamples=2, num_res_blocks=4,
                 num_image_channels=3, padding_mode="reflect",
                 activation_norm_type="instance", weight_norm_type="",
                 nonlinearity="relu", output_nonlinearity="", pre_act=False,
                 apply_noise=False, remat="none"):
        super().__init__()
        _refuse_noise(apply_noise)
        common = dict(padding_mode=padding_mode, activation_norm_type=activation_norm_type,
                      weight_norm_type=weight_norm_type, nonlinearity=nonlinearity)
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

    def forward(self, x):
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        for i in range(self.num_upsamples):
            x = getattr(self, f"up_{i}")(upsample_2x(x))
        return self.conv_out(x)


def content_encoder_from_config(g):
    return ContentEncoder(
        num_downsamples=cfg_get(g, "num_downsamples_content", 2),
        num_res_blocks=cfg_get(g, "num_res_blocks", 4),
        in_channels=cfg_get(g, "num_image_channels", 3),
        num_filters=cfg_get(g, "num_filters", 64),
        max_num_filters=cfg_get(g, "max_num_filters", 256),
        activation_norm_type=cfg_get(g, "content_norm_type", "instance"),
        weight_norm_type=cfg_get(g, "weight_norm_type", ""),
        pre_act=cfg_get(g, "pre_act", False),
        remat=cfg_get(g, "remat", "none"))


class AutoEncoder(nn.Module):
    def __init__(self, gen_cfg):
        super().__init__()
        g = as_attrdict(gen_cfg)
        self.content_encoder = content_encoder_from_config(g)
        self.decoder = Decoder(
            self.content_encoder.out_channels,
            num_upsamples=cfg_get(g, "num_downsamples_content", 2),
            num_res_blocks=cfg_get(g, "num_res_blocks", 4),
            num_image_channels=cfg_get(g, "num_image_channels", 3),
            activation_norm_type=cfg_get(g, "decoder_norm_type", "instance"),
            weight_norm_type=cfg_get(g, "weight_norm_type", ""),
            output_nonlinearity=cfg_get(g, "output_nonlinearity", ""),
            pre_act=cfg_get(g, "pre_act", False),
            apply_noise=cfg_get(g, "apply_noise", False),
            remat=cfg_get(g, "remat", "none"))

    def forward(self, images):
        return self.decoder(self.content_encoder(images))


class Generator(nn.Module):
    """``autoencoder_a`` and ``autoencoder_b``. ``forward`` returns the
    contents, the translations ``images_ab`` / ``images_ba`` and, when
    asked, the within-domain reconstructions and the cycle."""

    def __init__(self, gen_cfg, data_cfg=None):
        super().__init__()
        self.autoencoder_a = AutoEncoder(gen_cfg)
        self.autoencoder_b = AutoEncoder(gen_cfg)

    def forward(self, data, image_recon=True, cycle_recon=True):
        ae_a, ae_b = self.autoencoder_a, self.autoencoder_b
        out = {}
        content_a = ae_a.content_encoder(data["images_a"])
        content_b = ae_b.content_encoder(data["images_b"])
        if image_recon:
            out["images_aa"] = ae_a.decoder(content_a)
            out["images_bb"] = ae_b.decoder(content_b)
        images_ba = ae_a.decoder(content_b)
        images_ab = ae_b.decoder(content_a)
        if cycle_recon:
            content_ba = ae_a.content_encoder(images_ba)
            content_ab = ae_b.content_encoder(images_ab)
            out.update(content_ba=content_ba, content_ab=content_ab,
                       images_aba=ae_a.decoder(content_ab),
                       images_bab=ae_b.decoder(content_ba))
        out.update(content_a=content_a, content_b=content_b,
                   images_ba=images_ba, images_ab=images_ab)
        return out

    def inference(self, data, a2b=True, **kwargs):
        """A's images in B's domain (``a2b``), else B's in A's."""
        if a2b:
            return self.autoencoder_b.decoder(
                self.autoencoder_a.content_encoder(data["images_a"]))
        return self.autoencoder_a.decoder(
            self.autoencoder_b.content_encoder(data["images_b"]))
