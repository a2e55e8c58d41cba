"""MLP multi-class classifier discriminator (port of
``imaginaire_tpu/models/discriminators/mlp_multiclass.py``).

The flattened input goes through ``fc_in`` and ``num_layers`` more
``LinearBlock``s (dense, norm, nonlinearity: ``batch`` and leaky ReLU by
default), each followed by dropout at 0.1, then 1.5x a layer up to 0.5,
and ``fc_out`` gives ``num_labels`` scores. Dropout acts in training
mode only, as flax's with ``deterministic=not training``. No repository
config uses this discriminator.
"""

from __future__ import annotations

from torch import nn

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers import LinearBlock


class Discriminator(nn.Module):
    def __init__(self, dis_cfg, data_cfg=None):
        """``dis_cfg.in_features``: the flattened input's size, which flax
        infers at its first call."""
        super().__init__()
        dis_cfg = as_attrdict(dis_cfg)
        in_features = cfg_get(dis_cfg, "in_features", None)
        if in_features is None:
            raise ValueError("mlp_multiclass needs the flattened input's size "
                             "(dis.in_features)")
        num_filters = cfg_get(dis_cfg, "num_filters", 512)
        norm = cfg_get(dis_cfg, "activation_norm_type", "batch")
        nonlinearity = cfg_get(dis_cfg, "nonlinearity", "leakyrelu")
        self.num_layers = cfg_get(dis_cfg, "num_layers", 5)
        self.fc_in = LinearBlock(in_features, num_filters, activation_norm_type=norm,
                                 nonlinearity=nonlinearity, order="CNA")
        ratios = [0.1]
        for n in range(self.num_layers):
            self.add_module(f"fc_{n}", LinearBlock(
                num_filters, num_filters, activation_norm_type=norm,
                nonlinearity=nonlinearity, order="CNA"))
            ratios.append(min(ratios[-1] * 1.5, 0.5))
        self.dropouts = nn.ModuleList(nn.Dropout(p) for p in ratios)
        self.fc_out = LinearBlock(num_filters, dis_cfg.num_labels)

    def forward(self, data):
        x = data["data"].reshape(data["data"].shape[0], -1)
        x = self.dropouts[0](self.fc_in(x))
        for n in range(self.num_layers):
            x = self.dropouts[n + 1](getattr(self, f"fc_{n}")(x))
        return {"results": self.fc_out(x)}
