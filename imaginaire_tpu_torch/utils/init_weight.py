"""Weight-init factory (port of ``imaginaire_tpu/utils/init_weight.py``).

The JAX package draws each conv/dense kernel at creation from
``cfg.trainer.init`` (default xavier-normal, gain 0.02). Here modules are
built with empty kernels and ``init_weights`` draws them afterwards, on
the module's own device, from one ``torch.Generator``: fresh weights have
the JAX package's distribution (the bits differ). Fans follow the JAX
package's (= torch's) convention: fan_in = in * prod(kernel),
fan_out = out * prod(kernel). Biases, norm affines, running statistics
and spectral-norm vectors are set by the constructors, as in JAX.
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def init_kernel_(weight, generator, init_type="xavier", gain=0.02):
    """Draw ``weight`` (torch layout (out, in, *kernel)) in place."""
    fan_in, fan_out = _fans(tuple(weight.shape))
    if init_type in ("none", "", None):
        # torch's own default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in))
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return weight.uniform_(-bound, bound, generator=generator)
    if init_type == "normal":
        return weight.normal_(0.0, gain, generator=generator)
    if init_type == "xavier":
        return weight.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)),
                              generator=generator)
    if init_type == "xavier_uniform":
        a = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return weight.uniform_(-a, a, generator=generator)
    if init_type == "kaiming":
        return weight.normal_(0.0, gain * math.sqrt(2.0 / fan_in),
                              generator=generator)
    if init_type == "orthogonal":
        return torch.nn.init.orthogonal_(weight, gain=gain, generator=generator)
    raise ValueError(f"unknown init type {init_type!r}")


def init_weights(module, generator, init_type="xavier", gain=0.02):
    """Draw every kernel of ``module`` (each submodule's ``weight`` that
    is a conv or dense kernel, i.e. rank >= 2) in registration order."""
    for sub in module.modules():
        weight = getattr(sub, "_parameters", {}).get("weight")
        if weight is not None and weight.dim() >= 2:
            init_kernel_(weight, generator, init_type, gain)
    return module
