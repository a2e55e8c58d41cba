"""Label/image embedding pyramid for the vid2vid family (port of
``imaginaire_tpu/models/generators/embedders.py``).

Embeds an input map and returns features at every scale, finest first;
the vid2vid generator feeds scale i to its SPADE layers at resolution
i. Archs: 'encoder' (the downsample trail), 'encoderdecoder' (the
decoder outputs) and 'unet' (decoder with skip concatenations).

fs-vid2vid's weight generator predicts per-sample kernels for the first
``num_hyper_layers`` layers (-1: all of them) of the decoder (of the
encoder when there is no decoder): ``embedder(x, weights=[(w, b), ...])``
with w (B, kh, kw, cin, cout). Those layers own no conv, as in the JAX
package, where a ``HyperConv2dBlock`` creates its ``conv`` only when it
is called without weights.
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import HyperConv2dBlock
from imaginaire_tpu_torch.utils.misc import upsample_2x


class LabelEmbedder(nn.Module):
    def __init__(self, emb_cfg, num_input_channels, num_hyper_layers=0):
        super().__init__()
        cfg = as_attrdict(emb_cfg or {})
        num_filters = cfg_get(cfg, "num_filters", 32)
        max_num_filters = cfg_get(cfg, "max_num_filters", 1024)
        arch = cfg_get(cfg, "arch", "encoderdecoder")
        self.num_downsamples = nd = cfg_get(cfg, "num_downsamples", 5)
        kernel_size = cfg_get(cfg, "kernel_size", 3)
        wn = cfg_get(cfg, "weight_norm_type", "spectral")
        an = cfg_get(cfg, "activation_norm_type", "none")
        self.unet = "unet" in arch
        self.has_decoder = "decoder" in arch or self.unet
        self.num_hyper = nd if num_hyper_layers == -1 else num_hyper_layers

        def block(cin, cout, stride=1, an_type=an, hyper=False):
            return HyperConv2dBlock(cin, cout, kernel_size=kernel_size,
                                    stride=stride, padding=kernel_size // 2,
                                    weight_norm_type=wn,
                                    activation_norm_type=an_type,
                                    nonlinearity="leakyrelu", own_conv=not hyper)

        ch = [min(max_num_filters, num_filters * (2 ** i)) for i in range(nd + 1)]
        self.conv_first = block(num_input_channels, num_filters, an_type="none")
        enc = [num_filters]  # channels of the encoder outputs, in order
        for i in range(nd):
            self.add_module(f"down_{i}", block(
                enc[-1], ch[i + 1], stride=2,
                hyper=i < self.num_hyper and not self.has_decoder))
            enc.append(ch[i + 1])
        self.out_channels = enc
        if not self.has_decoder:
            return
        cur = enc[-1]
        for i in reversed(range(nd)):
            cin = cur + enc[i + 1] if self.unet and i != nd - 1 else cur
            self.add_module(f"up_{i}", block(cin, ch[i], hyper=i < self.num_hyper))
            cur = ch[i]
        self.out_channels = ch[:nd] + [enc[-1]]

    def _weights(self, weights, i, hyper):
        return weights[i] if hyper and weights is not None else None

    def forward(self, x, weights=None):
        """x: (B, C, H, W) -> [per-scale features], finest first;
        ``weights[i]``: layer i's per-sample (w, b)."""
        if x is None:
            return None
        nd = self.num_downsamples
        output = [self.conv_first(x)]
        for i in range(nd):
            hyper = i < self.num_hyper and not self.has_decoder
            output.append(getattr(self, f"down_{i}")(
                output[-1], conv_weights=self._weights(weights, i, hyper)))
        if not self.has_decoder:
            return output
        if not self.unet:
            output = [output[-1]]
        for i in reversed(range(nd)):
            input_i = output[-1]
            if self.unet and i != nd - 1:
                input_i = torch.cat([input_i, output[i + 1]], dim=1)
            output.append(getattr(self, f"up_{i}")(
                upsample_2x(input_i),
                conv_weights=self._weights(weights, i, i < self.num_hyper)))
        if self.unet:
            output = output[nd:]
        return output[::-1]
