"""Weight bridge: load the JAX package's variables into a port module.

``load_flax_variables(module, variables)`` takes the JAX trainer's
variable trees (``{"params": ..., "spectral": ..., "batch_stats": ...}``,
leaves as numpy or array-like) and copies every leaf into the module's
parameter or buffer of the same path:

- the port names submodules as the JAX package does, so a path
  ``a/b/leaf`` maps to ``module.a.b.leaf``; a flax auto-named segment
  (``BatchNorm_0``) that the port folds into its parent is skipped;
- ``kernel`` becomes ``weight``: conv kernels HWIO -> OIHW (the inverse
  of ``_conv`` in ``scripts/convert_weights.py``); transposed-conv
  kernels, chosen by the owner module's type (``nn.ConvTranspose2d``),
  (kh, kw, in, out) -> (in, out, kh, kw) rotated 180 degrees (the
  inverse of ``_convtranspose``); dense kernels (in, out) -> (out, in);
- ``scale``, ``bias``, ``u``, ``mean`` and ``var`` keep their names.

It raises on a leaf with no counterpart, on a shape mismatch, and on any
parameter or buffer of the module that no leaf filled. The same mapping
carries the JAX discriminator's ``params``/``spectral`` trees and the
VGG19 ``params`` of the perceptual loss (into ``PerceptualLoss.module``).

``load_adam_state(opt, module, mu, nu, count)`` carries optax Adam's
moments (trees shaped like the module's ``params``) and step count into
the port's ``Adam`` over ``module.parameters()``, so that both packages
start a step from the same state; ``to_port_layout`` maps any such tree
(gradients too) onto the port's names and layouts.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_AUTO_NAME = re.compile(r"^[A-Z]\w*_\d+$")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _target(module, path):
    """(owner module, dotted name, attribute name) for a flax leaf path."""
    owner, names = module, []
    for seg in path[:-1]:
        child = owner._modules.get(seg)
        if child is not None:
            owner = child
            names.append(seg)
        elif not _AUTO_NAME.match(seg):
            raise KeyError(f"flax leaf {'/'.join(path)}: the port module has "
                           f"no submodule {'.'.join(names + [seg])!r}")
    attr = "weight" if path[-1] == "kernel" else path[-1]
    if attr not in owner._parameters and attr not in owner._buffers:
        raise KeyError(f"flax leaf {'/'.join(path)}: the port module has no "
                       f"parameter or buffer {'.'.join(names + [attr])!r}")
    return owner, ".".join(names + [attr]), attr


def _to_torch_layout(path, value, owner):
    value = np.array(value, dtype=np.float32, copy=True)
    if path[-1] == "kernel":
        if value.ndim == 4 and isinstance(owner, torch.nn.ConvTranspose2d):
            # flax ConvTranspose (transpose_kernel=False) (kh, kw, in, out)
            # -> torch (in, out, kh, kw), rotated 180 degrees
            value = value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif value.ndim == 2:
            value = value.T  # (in, out) -> (out, in)
        else:
            raise ValueError(f"kernel {'/'.join(path)} has rank {value.ndim}")
    return np.ascontiguousarray(value)


@torch.no_grad()
def load_flax_variables(module, variables):
    """Copy ``variables`` (flax collections) into ``module``; returns it."""
    filled = set()
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            owner, name, attr = _target(module, path)
            if name in filled:
                raise KeyError(f"two flax leaves map to {name!r} "
                               f"(second: {collection}/{'/'.join(path)})")
            dest = getattr(owner, attr)
            src = torch.from_numpy(_to_torch_layout(path, value, owner))
            if tuple(src.shape) != tuple(dest.shape):
                raise ValueError(
                    f"{collection}/{'/'.join(path)}: shape {tuple(src.shape)} "
                    f"(torch layout) does not fit {name} {tuple(dest.shape)}")
            dest.copy_(src.to(device=dest.device, dtype=dest.dtype))
            filled.add(name)
    left = [name for name, _ in module.named_parameters()
            if name not in filled]
    left += [name for name, _ in module.named_buffers() if name not in filled]
    if left:
        raise KeyError(f"the flax variables left {len(left)} port tensors "
                       f"unset, e.g. {left[:5]}")
    return module


def to_port_layout(module, tree):
    """{port parameter/buffer name: numpy array in torch layout} for a
    flax tree shaped like one of ``module``'s collections (its params,
    their gradients, or Adam moments)."""
    out = {}
    for path, value in _flatten(tree):
        owner, name, _ = _target(module, path)
        out[name] = _to_torch_layout(path, value, owner)
    return out


@torch.no_grad()
def load_adam_state(opt, module, mu, nu, count):
    """Copy optax Adam's ``mu``/``nu`` trees and ``count`` into ``opt``
    (the port's ``Adam`` over ``module.parameters()``); returns opt."""
    index = {name: i for i, (name, _) in enumerate(module.named_parameters())}
    for tree, dest in ((mu, opt.mu), (nu, opt.nu)):
        filled = to_port_layout(module, tree)
        for name, value in filled.items():
            slot = dest[index[name]]
            if tuple(value.shape) != tuple(slot.shape):
                raise ValueError(f"adam state of {name}: shape "
                                 f"{tuple(value.shape)} does not fit "
                                 f"{tuple(slot.shape)}")
            slot.copy_(torch.from_numpy(value).to(device=slot.device,
                                                  dtype=slot.dtype))
        if len(filled) != len(index):
            raise KeyError(f"the adam state left {len(index) - len(filled)} "
                           f"port parameters unset")
    opt.count = int(np.asarray(count))
    return opt
