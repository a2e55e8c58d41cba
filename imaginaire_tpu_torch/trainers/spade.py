"""SPADE trainer, serving half (port of the inference parts of
``imaginaire_tpu/trainers/spade.py`` and ``trainers/base.py``).

It builds ``net_G`` from the config on an explicit device, draws fresh
weights from a seed, and hands out the inference weights (the averaged
copy when ``trainer.model_average``). The training methods, the
discriminator and the losses come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.data import (
    get_crop_or_resize_h_w,
    get_paired_input_label_channel_number,
)
from imaginaire_tpu_torch.utils.init_weight import init_weights
from imaginaire_tpu_torch.utils.misc import resolve_device
from imaginaire_tpu_torch.utils.model_average import collapse_spectral_norm


class Trainer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg = as_attrdict(cfg)
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.net_G = resolve(cfg.gen.type, "Generator")(cfg.gen, cfg.data)
        self.net_G.eval().requires_grad_(False)
        tcfg = cfg_get(cfg, "trainer", None) or {}
        self.model_average = cfg_get(tcfg, "model_average", False)
        self.model_average_remove_sn = cfg_get(tcfg, "model_average_remove_sn", True)
        init = cfg_get(tcfg, "init", None) or {}
        self.init_type = cfg_get(init, "type", "xavier")
        self.init_gain = cfg_get(init, "gain", 0.02)
        mp = cfg_get(tcfg, "mixed_precision", None) or {}
        self.compute_dtype = (getattr(torch, cfg_get(mp, "compute_dtype", "bfloat16"))
                              if cfg_get(mp, "enabled", False) else torch.float32)
        try:
            crop_h, crop_w = get_crop_or_resize_h_w(cfg.data.train.augmentations)
            self.base = {256: 16, 512: 32, 1024: 64}.get(min(crop_h, crop_w), 32)
        except (AttributeError, KeyError, ValueError):
            self.base = 32  # size-less config
        self.state = None
        self.ema_G = None

    def init_state(self, seed=0):
        """Fresh weights from ``seed``: every kernel drawn on the device
        from one ``torch.Generator``; the averaged copy starts as the
        sigma-collapsed weights, as the JAX trainer's ``ema_init`` does."""
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        init_weights(self.net_G, generator, self.init_type, self.init_gain)
        if self.model_average:
            self.ema_G = (collapse_spectral_norm(self.net_G)
                          if self.model_average_remove_sn else
                          {n: p.detach().clone()
                           for n, p in self.net_G.named_parameters()})
        self.state = {"seed": int(seed)}
        return self.state

    def inference_params(self):
        """{name: tensor} for ``torch.func.functional_call(net_G, ...)``:
        the averaged parameters when model averaging is on, else the
        live ones, plus the buffers (``u``, running statistics)."""
        if self.state is None:
            raise RuntimeError("init_state() before inference_params()")
        params = dict(self.net_G.named_parameters())
        if self.model_average:
            params.update(self.ema_G)
        params.update(self.net_G.named_buffers())
        return params

    def _expand_labels(self, data):
        """One-hot for integer label maps: (B, H, W) ints -> (B, C, H, W)
        in the compute dtype, with ``label_float`` (non-mask label types
        such as edge maps, NCHW) concatenated after the one-hot channels.
        Float label tensors pass through."""
        label = data.get("label")
        if label is None or label.is_floating_point():
            return data
        n = get_paired_input_label_channel_number(self.cfg.data)
        extra = data.get("label_float")
        if extra is not None:
            n = n - extra.shape[1]
        onehot = F.one_hot(label.long(), n).permute(0, 3, 1, 2)
        onehot = onehot.to(self.compute_dtype)
        if extra is not None:
            onehot = torch.cat([onehot, extra.to(onehot.dtype)], dim=1)
        out = dict(data, label=onehot)
        out.pop("label_float", None)
        return out

    def _resize_data(self, data):
        """Round H/W of NHWC host arrays down to the generator's base
        multiple."""
        base = self.base
        out = dict(data)
        for key in ("label", "images", "label_float"):
            if key in out:
                arr = np.asarray(out[key])
                h, w = arr.shape[1:3]
                h2, w2 = (h // base) * base, (w // base) * base
                if (h2, w2) != (h, w):
                    out[key] = arr[:, :h2, :w2]
        return out
