"""Trainer base, serving half (port of the inference parts of
``imaginaire_tpu/trainers/base.py``).

It builds ``net_G`` from the config on an explicit device, draws fresh
weights from a seed, and hands out the inference weights (the averaged
copy when ``trainer.model_average``). The family trainers add their data
hooks; the training methods, the discriminators and the losses come with
the training slices (ROADMAP.md).
"""

from __future__ import annotations

import torch

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.init_weight import init_weights
from imaginaire_tpu_torch.utils.misc import resolve_device
from imaginaire_tpu_torch.utils.model_average import collapse_spectral_norm


class BaseTrainer:
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
