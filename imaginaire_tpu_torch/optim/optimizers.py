"""Optimizers and lr policies (port of the Adam and RMSprop part of
``imaginaire_tpu/optim/optimizers.py:90-198``).

``Adam`` is optax's ``adam`` (``scale_by_adam`` then the scheduled
learning rate), step for step:

    count += 1
    mu = (1 - b1) g + b1 mu
    nu = (1 - b2) g^2 + b2 nu
    p += -lr(count - 1) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

with the bias corrections in fp32, as optax computes them, and the
schedule read at the number of updates made before this one.

``RMSprop`` is optax's ``rmsprop`` at its defaults (decay 0.9, the
moment starting at 0, ``eps`` inside the square root, no bias
correction, no momentum), after ``add_decayed_weights`` when the config
sets ``weight_decay``:

    g += weight_decay p
    nu = (1 - decay) g^2 + decay nu
    p += -lr(count) * g / sqrt(nu + eps);  count += 1

(torch's own ``RMSprop`` defaults to a decay of 0.99.) Both keep ``mu``
and ``nu`` lists, one tensor a parameter (RMSprop's ``mu`` is empty),
and the update ``count``, which the checkpoints hold. The other
optimizer types of the JAX package raise.
"""

from __future__ import annotations

import torch

from imaginaire_tpu_torch.config import cfg_get


def get_scheduler(cfg_opt, iters_per_epoch=1):
    """lr multiplier of the update count: ``constant`` is 1; ``step``
    multiplies by ``gamma`` every ``step_size`` epochs (or updates, with
    ``iteration_mode``), epochs counted as ``iters_per_epoch`` updates."""
    policy = cfg_get(cfg_opt, "lr_policy", None) or {}
    ptype = cfg_get(policy, "type", "constant")
    if ptype == "constant":
        return lambda step: 1.0
    if ptype == "step":
        iteration_mode = cfg_get(policy, "iteration_mode", False)
        step_size, gamma = policy["step_size"], policy["gamma"]

        def sched(step):
            unit = step if iteration_mode else step // max(iters_per_epoch, 1)
            return gamma ** (unit // step_size)

        return sched
    raise NotImplementedError(f"lr policy {ptype!r} is not in the port yet "
                              f"(ROADMAP.md)")


class Adam:
    """optax ``adam`` over a list of fp32 parameters; reads each
    parameter's ``.grad``. State: ``mu``, ``nu`` (one tensor a
    parameter) and ``count``."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, schedule=None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.schedule = schedule or (lambda step: 1.0)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _bias_correction(self, decay):
        base = torch.tensor(decay, dtype=torch.float32)
        return float(1.0 - base ** self.count)

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        lr = float(torch.tensor(self.lr * self.schedule(self.count),
                                dtype=torch.float32))
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(self.mu, self._bias_correction(b1))
        denom = torch._foreach_div(self.nu, self._bias_correction(b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_mul_(mu_hat, -lr)
        torch._foreach_add_(self.params, mu_hat)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_tensors(self):
        """Every state tensor (for a copy taken before a step)."""
        return self.mu + self.nu


class RMSprop(Adam):
    """optax ``rmsprop`` (no momentum, not centered) over a list of fp32
    parameters, with ``add_decayed_weights`` first when ``weight_decay``;
    reads each parameter's ``.grad``. State: ``nu`` and ``count``."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, weight_decay=0.0,
                 schedule=None):
        self.params = list(params)
        self.lr, self.decay, self.eps = lr, decay, eps
        self.weight_decay = weight_decay
        self.schedule = schedule or (lambda step: 1.0)
        self.mu = []
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        lr = float(torch.tensor(self.lr * self.schedule(self.count),
                                dtype=torch.float32))
        self.count += 1
        torch._foreach_mul_(self.nu, self.decay)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.decay)
        scale = torch._foreach_add(self.nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_mul_(scale, -lr)
        torch._foreach_add_(self.params, scale)


OPTIMIZERS = ("adam", "rmsprop")


def get_optimizer_for_params(cfg_opt, params, iters_per_epoch=1):
    """The optimizer a config's ``gen_opt``/``dis_opt`` section names."""
    opt_type = cfg_get(cfg_opt, "type", "adam")
    if opt_type not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {opt_type!r} is not in the port "
                                  f"yet (ROADMAP.md); it has {OPTIMIZERS}")
    if opt_type == "rmsprop":
        return RMSprop(params, lr=cfg_get(cfg_opt, "lr", 1e-4),
                       eps=cfg_get(cfg_opt, "eps", 1e-8),
                       weight_decay=cfg_get(cfg_opt, "weight_decay", 0) or 0.0,
                       schedule=get_scheduler(cfg_opt, iters_per_epoch))
    return Adam(params, lr=cfg_get(cfg_opt, "lr", 1e-4),
                b1=cfg_get(cfg_opt, "adam_beta1", 0.9),
                b2=cfg_get(cfg_opt, "adam_beta2", 0.999),
                eps=cfg_get(cfg_opt, "eps", 1e-8),
                schedule=get_scheduler(cfg_opt, iters_per_epoch))
