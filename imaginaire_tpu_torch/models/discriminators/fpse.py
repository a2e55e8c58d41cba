"""Feature-Pyramid Semantics-Embedding discriminator (port of
``imaginaire_tpu/models/discriminators/fpse.py``).

A bottom-up stride-2 encoder, a top-down FPN with lateral 1x1 convs,
and at three pyramid scales a patch logit plus a label-embedding
dot-product score. The top-down upsampling is ``jax.image.resize``
"bilinear" (half-pixel centres): the port's ``resize_bilinear``, not
``F.interpolate``'s default. The shared ``output`` and ``seg`` heads are
called once a scale, so in a training forward of the network whose step
it is their spectral-norm ``u`` advances three times, as the flax
module's variable does. NCHW.
"""

from __future__ import annotations

import math

import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.layers import Conv2dBlock
from imaginaire_tpu_torch.optim.remat import call_block, resolve_policy
from imaginaire_tpu_torch.utils.misc import resize_bilinear


def _upsample2x_bilinear(x):
    h, w = x.shape[-2:]
    return resize_bilinear(x, (2 * h, 2 * w))


class FPSEDiscriminator(nn.Module):
    def __init__(self, num_labels, image_channels=3, num_filters=128,
                 kernel_size=3, weight_norm_type="spectral",
                 activation_norm_type="none", remat="none"):
        super().__init__()
        nf, ks = num_filters, kernel_size
        pad = int(math.ceil((ks - 1.0) / 2))
        self.remat = resolve_policy(remat, where="dis.remat")

        def block(cin, cout, k, stride, padding):
            return Conv2dBlock(cin, cout, kernel_size=k, stride=stride,
                               padding=padding,
                               weight_norm_type=weight_norm_type,
                               activation_norm_type=activation_norm_type,
                               nonlinearity="leakyrelu", order="CNA")

        chans = [image_channels, nf, 2 * nf, 4 * nf, 8 * nf, 8 * nf]
        for i in range(5):
            self.add_module(f"enc{i + 1}", block(chans[i], chans[i + 1], ks, 2, pad))
        for i in (5, 4, 3, 2):
            self.add_module(f"lat{i}", block(chans[i], 4 * nf, 1, 1, 0))
        for i in (2, 3, 4):
            self.add_module(f"final{i}", block(4 * nf, 2 * nf, ks, 1, pad))
        self.output = Conv2dBlock(2 * nf, 1, kernel_size=1)
        self.seg = Conv2dBlock(2 * nf, 2 * nf, kernel_size=1)
        self.embedding = Conv2dBlock(num_labels, 2 * nf, kernel_size=1)

    def _block(self, name, x):
        return call_block(getattr(self, name), self.remat, x)

    def forward(self, images, segmaps):
        feat11 = self._block("enc1", images)
        feat12 = self._block("enc2", feat11)
        feat13 = self._block("enc3", feat12)
        feat14 = self._block("enc4", feat13)
        feat15 = self._block("enc5", feat14)
        feat25 = self._block("lat5", feat15)
        feat24 = _upsample2x_bilinear(feat25) + self._block("lat4", feat14)
        feat23 = _upsample2x_bilinear(feat24) + self._block("lat3", feat13)
        feat22 = _upsample2x_bilinear(feat23) + self._block("lat2", feat12)
        feat32 = self._block("final2", feat22)
        feat33 = self._block("final3", feat23)
        feat34 = self._block("final4", feat24)
        pred2, pred3, pred4 = (self.output(f) for f in (feat32, feat33, feat34))
        seg2, seg3, seg4 = (self.seg(f) for f in (feat32, feat33, feat34))
        segembs = F.avg_pool2d(self.embedding(segmaps), 2)
        segembs2 = F.avg_pool2d(segembs, 2)
        segembs3 = F.avg_pool2d(segembs2, 2)
        segembs4 = F.avg_pool2d(segembs3, 2)
        pred2 = pred2 + (segembs2 * seg2).sum(dim=1, keepdim=True)
        pred3 = pred3 + (segembs3 * seg3).sum(dim=1, keepdim=True)
        pred4 = pred4 + (segembs4 * seg4).sum(dim=1, keepdim=True)
        return pred2, pred3, pred4
