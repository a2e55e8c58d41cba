"""Spectral-norm collapse for the averaged generator (port of
``collapse_spectral_norm`` in ``imaginaire_tpu/utils/model_average.py``).

With ``trainer.model_average_remove_sn`` the averaged copy stores every
spectrally-normalized kernel already divided by its sigma, estimated by
one power-iteration step from the stored ``u``.
"""

from __future__ import annotations

import torch

from imaginaire_tpu_torch.layers.weight_norm import power_iteration


@torch.no_grad()
def collapse_spectral_norm(module):
    """{parameter name: tensor} of ``module``'s parameters, with each
    kernel that has a ``u`` beside it divided by its sigma (fresh
    tensors: the result never aliases the module's parameters)."""
    out = {name: p.detach().clone() for name, p in module.named_parameters()}
    for prefix, sub in module.named_modules():
        if "u" in sub._buffers and "weight" in sub._parameters:
            name = f"{prefix}.weight" if prefix else "weight"
            w = out[name]
            sigma, _ = power_iteration(w.reshape(w.shape[0], -1), sub.u)
            out[name] = w / sigma.to(w.dtype)
    return out
