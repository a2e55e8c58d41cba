"""Training-time state of the layers.

Two things the JAX trainer decides per step, carried here for the
port's layers:

- the parameters' compute dtype. The JAX step casts each network's
  ``params`` to the compute dtype before the apply and nothing else
  (``_cast_net_vars``): the spectral-norm ``u`` and the BatchNorm running
  statistics stay fp32. Under ``param_compute_dtype(net, dtype)`` every
  layer of ``net`` rounds its parameters to ``dtype`` (``cast_param``)
  before it uses them; the cast is differentiable, so the gradients land
  on the fp32 masters. The setting lives on the modules, so a
  checkpointed block that recomputes its forward in the backward pass
  (on the autograd engine's own thread on CUDA) still sees it;
- which network advances its state. The JAX step applies the stepping
  network with its ``spectral`` and ``batch_stats`` collections mutable
  and the other network without: each layer that owns such state
  (``update_state`` attribute) writes its new ``u`` or running
  statistics only while its flag is on (``state_updates``).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def param_compute_dtype(module, dtype):
    """Round the parameters of every layer of ``module`` to ``dtype``
    inside the block (None: parameters are used as they are)."""
    mods = list(module.modules())
    before = [m.__dict__.get("param_dtype") for m in mods]
    for m in mods:
        m.param_dtype = dtype
    try:
        yield
    finally:
        for m, dt in zip(mods, before):
            m.param_dtype = dt


def cast_param(module, p):
    """``p``, a parameter of ``module``, rounded to the module's
    parameter compute dtype."""
    dtype = getattr(module, "param_dtype", None)
    if p is None or dtype is None or p.dtype == dtype:
        return p
    return p.to(dtype)


def stateful_modules(module):
    """The submodules of ``module`` (itself included) that own training
    state: spectral-norm layers and BatchNorms."""
    return [m for m in module.modules() if hasattr(m, "update_state")]


def state_buffers(module):
    """The state tensors (``u``, running ``mean``/``var``) of ``module``."""
    return [b for m in stateful_modules(module) for b in m._buffers.values()
            if b is not None]


@contextlib.contextmanager
def state_updates(module, enabled):
    """Let ``module``'s layers advance their state (``enabled``) or keep
    it (reading only) inside the block; the flags are restored after."""
    mods = stateful_modules(module)
    before = [m.update_state for m in mods]
    for m in mods:
        m.update_state = bool(enabled)
    try:
        yield
    finally:
        for m, flag in zip(mods, before):
            m.update_state = flag
