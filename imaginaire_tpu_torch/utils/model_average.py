"""Exponential moving average of the generator's parameters (port of
``imaginaire_tpu/utils/model_average.py:35-80``).

The averaged copy is a {parameter name: tensor} dict beside the module.
With ``remove_sn`` (``trainer.model_average_remove_sn``) it stores every
spectrally-normalized kernel already divided by its sigma, estimated by
one power-iteration step from the stored ``u``, so the averaged weights
need no power iteration at inference.
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


def ema_init(module, remove_sn=True):
    """The averaged copy at the start of training: the parameters
    (sigma-collapsed with ``remove_sn``), never aliasing them."""
    if remove_sn:
        return collapse_spectral_norm(module)
    return {n: p.detach().clone() for n, p in module.named_parameters()}


@torch.no_grad()
def ema_update(avg, module, num_updates, beta=0.9999, start_iteration=1000,
               remove_sn=True):
    """One EMA step in place on ``avg``: a plain copy (beta 0) while
    ``num_updates`` (counted after this update) is at most
    ``start_iteration``, then ``avg * beta + p * (1 - beta)``; the source
    is the module's parameters with its current ``u`` (sigma-collapsed
    with ``remove_sn``)."""
    src = ema_init(module, remove_sn)
    # beta and 1 - beta in fp32, as the JAX update forms them
    b = torch.tensor(0.0 if num_updates <= start_iteration else beta,
                     dtype=torch.float32)
    keep, take = float(b), float(1.0 - b)
    for name, a in avg.items():
        a.mul_(keep).add_(src[name] * take)
    return avg
