"""Spectral normalization (port of
``imaginaire_tpu/layers/weight_norm.py:27-90``).

The power-iteration vector ``u`` is a buffer of the owning module. Each
forward takes one step from the stored ``u`` and divides the kernel by
the resulting sigma. The owner writes the new ``u`` back only in a
training forward of the network whose step it is (``update=True``; see
``layers/state.py``), as the JAX layer does when its ``spectral``
collection is mutable; otherwise ``u`` is read and kept. Calls within
one forward see the updates of the calls before them, as the JAX
module's variable does. ``torch.nn.utils.spectral_norm`` and
``F.normalize`` are not used: their eps placement and update timing
differ from the JAX package's, whose arithmetic this copies:
``v = W^T u / (|W^T u| + eps)``, ``u' = W v / (|W v| + eps)``,
``sigma = u'^T W v`` with ``W`` the (out, rest) view of the kernel, in
fp32 whatever the kernel's type (the ``sn_power_iteration`` island).
"""

from __future__ import annotations

import torch


def _l2_normalize(v, eps=1e-12):
    return v / (torch.linalg.vector_norm(v) + eps)


def init_u(out_features, device=None):
    """The JAX package's deterministic ``u`` initialisation."""
    return _l2_normalize(torch.sin(
        torch.arange(out_features, dtype=torch.float32, device=device) + 1.0))


def power_iteration(w_mat, u, eps=1e-12):
    """One power-iteration step. w_mat: (out, rest), u: (out,).
    Returns (sigma, new_u) in fp32; no gradient flows through u or v."""
    with torch.no_grad():
        w_ng = w_mat.detach().float()
        v = _l2_normalize(w_ng.T @ u.float(), eps)
        u = _l2_normalize(w_ng @ v, eps)
    sigma = u @ (w_mat.float() @ v)
    return sigma, u


def spectral_normalize(weight, u, eps=1e-12, update=False):
    """``weight / sigma`` for a torch-layout kernel (out, ...), divided in
    the kernel's own type. The (out, rest) view orders ``rest``
    differently from the JAX package's HWIO view; sigma does not depend
    on that order. With ``update`` the new ``u`` is written into ``u``."""
    sigma, new_u = power_iteration(weight.reshape(weight.shape[0], -1), u,
                                   eps=eps)
    if update:
        with torch.no_grad():
            u.copy_(new_u)
    return weight * (1.0 / sigma).to(weight.dtype)
