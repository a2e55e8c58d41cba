"""Improved-FUNIT generator (port of ``imaginaire_tpu/models/generators/funit.py``).

One translator: ``FUNITContentEncoder`` (a conv7, a stride-2 ladder that
doubles the width at every step without a cap, and a residual trunk),
MUNIT's ``StyleEncoder`` (no norm), an ``MLP`` of ``num_mlp_blocks - 1``
layers from the style code to the AdaIN conditioning vector, and
``FUNITDecoder``: two AdaIN residual blocks, then a ladder of AdaIN
up-residual blocks (kernel 5, reflect padding, the hidden width equal to
the output's, the nonlinearity on the shortcut too) and a conv7 with
tanh. ``forward`` decodes the content image's content code under the
style image's style code (``images_trans``) and under its own
(``images_recon``). AdaIN's gamma and beta broadcast over space, so no
kernel of the port runs here. NCHW; submodule names follow the JAX
parameter tree, and each sub-network is called in the JAX forward's
order.
"""

from __future__ import annotations

from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import Conv2dBlock, Res2dBlock, UpRes2dBlock
from imaginaire_tpu_torch.models.generators.munit import MLP, StyleEncoder
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.misc import resize_bilinear


class FUNITContentEncoder(nn.Module):
    """conv7, ``num_downsamples`` stride-2 conv4s that each double the
    width, then ``num_res_blocks`` CNACNA residual blocks; instance norms
    and ReLU throughout."""

    def __init__(self, num_downsamples=2, num_res_blocks=2, in_channels=3,
                 num_filters=64, padding_mode="reflect", activation_norm_type="instance",
                 weight_norm_type="", nonlinearity="relu", remat="none"):
        super().__init__()
        common = dict(padding_mode=padding_mode, activation_norm_type=activation_norm_type,
                      weight_norm_type=weight_norm_type, nonlinearity=nonlinearity)
        self.num_downsamples, self.num_res_blocks = num_downsamples, num_res_blocks
        self.remat = resolve_policy(remat, where="gen.remat")
        nf = num_filters
        self.conv_in = Conv2dBlock(in_channels, nf, 7, stride=1, padding=3, **common)
        for i in range(num_downsamples):
            self.add_module(f"down_{i}", Conv2dBlock(nf, nf * 2, 4, stride=2, padding=1,
                                                     **common))
            nf *= 2
        for i in range(num_res_blocks):
            self.add_module(f"res_{i}", Res2dBlock(nf, nf, order="CNACNA", **common))
        self.out_channels = nf

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(self.num_downsamples):
            x = getattr(self, f"down_{i}")(x)
        for i in range(self.num_res_blocks):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x)
        return x


class FUNITDecoder(nn.Module):
    """Two AdaIN residual blocks at the content code's width, then
    ``num_upsamples`` AdaIN up-residual blocks that halve it, then a
    conv7 to the image with tanh. Every AdaIN is conditioned on
    ``style`` (``style_channels`` wide)."""

    def __init__(self, in_channels, num_upsamples=2, num_image_channels=3,
                 style_channels=256, padding_mode="reflect", weight_norm_type="",
                 nonlinearity="relu", remat="none"):
        super().__init__()
        adain = dict(activation_norm_type="adaptive",
                     activation_norm_params={"cond_dims": style_channels},
                     weight_norm_type=weight_norm_type, padding_mode=padding_mode,
                     nonlinearity=nonlinearity)
        self.num_upsamples = num_upsamples
        self.remat = resolve_policy(remat, where="gen.remat")
        nf = in_channels
        for i in range(2):
            self.add_module(f"res_{i}", Res2dBlock(nf, nf, kernel_size=3, padding=1,
                                                   **adain))
        for i in range(num_upsamples):
            self.add_module(f"up_{i}", UpRes2dBlock(
                nf, nf // 2, kernel_size=5, padding=2,
                hidden_channels_equal_out_channels=True, skip_nonlinearity=True, **adain))
            nf //= 2
        self.conv_out = Conv2dBlock(nf, num_image_channels, 7, stride=1, padding=3,
                                    padding_mode="reflect", nonlinearity="tanh")

    def forward(self, x, style):
        for i in range(2):
            x = call_block(getattr(self, f"res_{i}"), self.remat, x, style)
        for i in range(self.num_upsamples):
            x = call_block(getattr(self, f"up_{i}"), self.remat, x, style)
        return self.conv_out(x)


class FUNITTranslator(nn.Module):
    """The content and style encoders, the decoder and the style MLP."""

    def __init__(self, gen_cfg):
        super().__init__()
        g = as_attrdict(gen_cfg)
        nf = cfg_get(g, "num_filters", 64)
        self.style_dims = cfg_get(g, "style_dims", 64)
        num_filters_mlp = cfg_get(g, "num_filters_mlp", 256)
        wn = cfg_get(g, "weight_norm_type", "")
        n_down_content = cfg_get(g, "num_downsamples_content", 2)
        image_channels = cfg_get(g, "num_image_channels", 3)
        remat = cfg_get(g, "remat", "none")
        self.style_encoder = StyleEncoder(
            num_downsamples=cfg_get(g, "num_downsamples_style", 4),
            in_channels=image_channels, num_filters=nf, style_channels=self.style_dims,
            activation_norm_type="", weight_norm_type=wn)
        self.content_encoder = FUNITContentEncoder(
            num_downsamples=n_down_content, num_res_blocks=cfg_get(g, "num_res_blocks", 2),
            in_channels=image_channels, num_filters=nf, weight_norm_type=wn, remat=remat)
        self.decoder = FUNITDecoder(
            self.content_encoder.out_channels, num_upsamples=n_down_content,
            num_image_channels=image_channels, style_channels=num_filters_mlp,
            weight_norm_type=wn, remat=remat)
        self.mlp = MLP(self.style_dims, output_dim=num_filters_mlp,
                       latent_dim=num_filters_mlp,
                       num_layers=cfg_get(g, "num_mlp_blocks", 3) - 1)

    def encode(self, images):
        return self.content_encoder(images), self.style_encoder(images)

    def decode(self, content, style):
        return self.decoder(content, self.mlp(style))

    def forward(self, images):
        return self.decode(*self.encode(images))


class Generator(nn.Module):
    """``generator``: the translator. ``forward`` returns
    ``images_trans`` and ``images_recon``; ``inference`` the content
    image under the style image's code."""

    translator_cls = FUNITTranslator

    def __init__(self, gen_cfg, data_cfg=None):
        super().__init__()
        self.generator = self.translator_cls(gen_cfg)

    def forward(self, data):
        g = self.generator
        content_a = g.content_encoder(data["images_content"])
        style_a = g.style_encoder(data["images_content"])
        style_b = g.style_encoder(data["images_style"])
        return {"images_trans": g.decode(content_a, style_b),
                "images_recon": g.decode(content_a, style_a)}

    def inference(self, data, keep_original_size=False, **kwargs):
        """The translation; with ``keep_original_size`` resized to the
        batch's ``original_h_w`` when it carries one (antialiased
        bilinear, as ``jax.image.resize``); neither few-shot dataset
        emits it."""
        g = self.generator
        out = g.decode(g.content_encoder(data["images_content"]),
                       g.style_encoder(data["images_style"]))
        if keep_original_size and "original_h_w" in data:
            h, w = (int(v) for v in data["original_h_w"][0][:2])
            out = resize_bilinear(out, (h, w))
        return out
