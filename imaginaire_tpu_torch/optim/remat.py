"""Named rematerialization policies (port of ``imaginaire_tpu/optim/remat.py``).

A config names a policy for a network's blocks (``gen.remat``,
``dis.remat``):

  ``none``          no remat: every block activation stays live for the
                    backward pass.
  ``blocks``        ``torch.utils.checkpoint`` (non-reentrant) around
                    each block: it keeps only the block's inputs and
                    recomputes the block's forward in the backward pass.
  ``save_nothing``  the same as ``blocks`` (the JAX package names both).

``dots_saveable`` (keep the convolutions' outputs, recompute the rest)
has no PyTorch counterpart here and raises.

A checkpointed block runs its forward twice, so a layer that writes
state in its forward (the spectral-norm ``u``, BatchNorm running
statistics) would write twice and its recompute would read the value
the first run wrote. ``call_block`` therefore keeps the state the first
run read, and the recompute reads that copy and writes nothing, as a
rematted flax block's recompute discards its mutable updates.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from imaginaire_tpu_torch.layers.state import (
    state_buffers,
    state_updates,
    stateful_modules,
)

POLICIES = {"none": False, "blocks": True, "save_nothing": True}


def resolve_policy(name, where="remat"):
    """Whether the policy ``name`` checkpoints its blocks; raises on a
    policy the port does not have."""
    key = "none" if name is None else str(name)
    if key == "dots_saveable":
        raise NotImplementedError(
            f"{where}='dots_saveable' (keep the convolutions' outputs) is not "
            f"in the port (ROADMAP.md); use 'blocks'")
    if key not in POLICIES:
        raise ValueError(f"{where}={name!r} is not a known remat policy; use "
                         + ", ".join(repr(k) for k in POLICIES))
    return POLICIES[key]


def call_block(block, enabled, *args, **kwargs):
    """``block(*args, **kwargs)``, checkpointed when ``enabled`` and a
    gradient is being recorded."""
    if not (enabled and torch.is_grad_enabled()):
        return block(*args, **kwargs)
    writes = any(m.update_state for m in stateful_modules(block)) and block.training
    read = [b.clone() for b in state_buffers(block)] if writes else None
    runs = []

    def run(*inputs, **kw):
        runs.append(None)
        if len(runs) == 1 or not writes:
            return block(*inputs, **kw)
        # the recompute: the state the first run read, nothing written
        buffers = state_buffers(block)
        kept = [b.clone() for b in buffers]
        with torch.no_grad():
            for b, v in zip(buffers, read):
                b.copy_(v)
        try:
            with state_updates(block, False):
                return block(*inputs, **kw)
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, kept):
                    b.copy_(v)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)

