"""Residual block (port of ``Res2dBlock`` in
``imaginaire_tpu/layers/residual.py``).

Two conv blocks on the main branch plus a learned 1x1 shortcut when the
channel counts differ. ``order`` covers both main-branch convs
('CNACNA', 'NACNAC' or the 'pre_act' alias); the shortcut runs the first
half of the order without the nonlinearity, keeping the (conditional)
norm when ``skip_activation_norm``. The JAX block's stride, dilation,
padding-mode, noise and shortcut-forcing options wait for the families
that use them.
"""

from __future__ import annotations

from torch import nn

from imaginaire_tpu_torch.layers.conv import Conv2dBlock


def _split_order(order):
    if order == "pre_act":
        order = "NACNAC"
    if len(order) not in (4, 5, 6):
        raise ValueError(f"residual order must have 4-6 chars, got {order!r}")
    half = (len(order) + 1) // 2
    return order[:half], order[half:]


class Res2dBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size=3, padding=None,
                 bias=True, weight_norm_type="", weight_norm_params=None,
                 activation_norm_type="", activation_norm_params=None,
                 skip_activation_norm=True, nonlinearity="leakyrelu",
                 order="CNACNA"):
        super().__init__()
        order0, order1 = _split_order(order)
        hidden = min(in_channels, out_channels)
        if isinstance(bias, (tuple, list)):
            bias_0, bias_1, bias_s = bias
        else:
            bias_0 = bias_1 = bias_s = bias
        common = dict(
            kernel_size=kernel_size, padding=padding,
            weight_norm_type=weight_norm_type,
            weight_norm_params=weight_norm_params,
            activation_norm_type=activation_norm_type,
            activation_norm_params=activation_norm_params,
            nonlinearity=nonlinearity)
        self.conv_0 = Conv2dBlock(in_channels, hidden, order=order0,
                                  bias=bias_0, **common)
        self.conv_1 = Conv2dBlock(hidden, out_channels, order=order1,
                                  bias=bias_1, **common)
        self.conv_s = None
        if in_channels != out_channels:
            common.update(kernel_size=1, padding=0, nonlinearity="")
            if not skip_activation_norm:
                common["activation_norm_type"] = ""
            self.conv_s = Conv2dBlock(in_channels, out_channels, order=order0,
                                      bias=bias_s, **common)

    def forward(self, x, *cond_inputs):
        dx = self.conv_1(self.conv_0(x, *cond_inputs), *cond_inputs)
        xs = x if self.conv_s is None else self.conv_s(x, *cond_inputs)
        return xs + dx
