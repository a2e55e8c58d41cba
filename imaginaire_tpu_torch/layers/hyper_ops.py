"""Per-sample ("hyper") convolution: the weights are runtime inputs (port
of ``imaginaire_tpu/layers/hyper_ops.py``).

fs-vid2vid's weight generator predicts one conv kernel a sample. The
JAX package vmaps a conv over (sample, kernel) pairs, which XLA lowers
to a convolution whose feature groups carry the batch; here that is one
grouped ``F.conv2d`` with ``groups=B`` over the batch folded into
channels. Kernels arrive in the JAX layout, (B, kh, kw, cin, cout)
(HWIO a sample), and are permuted to OIHW. Padding ``"SAME"`` follows
XLA: the total ``max((ceil(n / s) - 1) * s + k - n, 0)`` is split with
the odd pixel after, so a stride-2 conv of an even size pads (0, 1).
"""

from __future__ import annotations

import torch.nn.functional as F


def _same_pads(n, k, s, d):
    k_eff = (k - 1) * d + 1
    total = max((-(-n // s) - 1) * s + k_eff - n, 0)
    return total // 2, total - total // 2


def per_sample_conv2d(x, w, b=None, stride=1, padding="SAME", dilation=1):
    """x: (B, Cin, H, W); w: (B, kh, kw, Cin, Cout); b: (B, Cout) or None.
    Returns (B, Cout, H', W'), sample i convolved with kernel i."""
    if padding != "SAME":
        raise ValueError(f"per_sample_conv2d padding {padding!r}: only 'SAME' "
                         "is used by the JAX package")
    bsz, cin, h, wd = x.shape
    _, kh, kw, wcin, cout = w.shape
    if wcin != cin or w.shape[0] != bsz:
        raise ValueError(f"kernels {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)}")
    pt, pb = _same_pads(h, kh, stride, dilation)
    pl, pr = _same_pads(wd, kw, stride, dilation)
    kernel = w.to(x.dtype).permute(0, 4, 3, 1, 2).reshape(bsz * cout, cin, kh, kw)
    xg = F.pad(x.reshape(1, bsz * cin, h, wd), (pl, pr, pt, pb))
    out = F.conv2d(xg, kernel, None, stride, 0, dilation, groups=bsz)
    out = out.reshape(bsz, cout, out.shape[-2], out.shape[-1])
    if b is not None:
        out = out + b[:, :, None, None]
    return out


def grouped_modulated_conv2d(x, w, stride=1, padding="SAME", dilation=1):
    """Weight-demodulated conv with per-sample kernels (B, kh, kw, Cin,
    Cout): the same grouped conv, the kernels cast to x's type."""
    return per_sample_conv2d(x, w.to(x.dtype), stride=stride, padding=padding,
                             dilation=dilation)
