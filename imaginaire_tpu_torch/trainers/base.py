"""Trainer base (port of ``imaginaire_tpu/trainers/base.py``): the
serving half and the D+G training step.

Serving: it builds ``net_G`` from the config on an explicit device,
draws fresh weights from a seed, and hands out the inference weights
(the averaged copy when ``trainer.model_average``).

Training (``train=True``): it also builds ``net_D``, the losses
(``_init_loss`` of the family trainer), one Adam a network with its lr
policy, and the averaged copy's update, and runs the JAX trainer's two
steps eagerly:

- ``dis_update(data)``: G's output under ``torch.no_grad()``, then D's
  loss, backward and Adam. Only D's spectral-norm ``u`` and BatchNorm
  running statistics advance.
- ``gen_update(data)``: G and D forward, G's loss, backward, Adam, and
  the EMA of G. Only G's state advances; D's forward takes a fresh
  power step but stores nothing.

The compute policy is the JAX trainer's (``_cast_net_vars``): in each
step both networks' parameters are rounded to the compute dtype (the
cast is differentiable, so the grads land on the fp32 masters) and the
data's floating tensors are cast to it; the norm statistics, the
spectral-norm power iteration and the loss sum (``_total``) stay fp32.
``torch.autocast`` is not used: it picks types op by op, which is not
the JAX policy. The compute dtype is ``trainer.mixed_precision`` when
enabled, else the legacy ``trainer.compute_dtype``, else fp32.

A non-finite total loss or gradient norm leaves the parameters, the
optimizer state and the network's state as they were
(``diagnostics.on_nonfinite``: ``halt`` raises ``NonFiniteLossError``,
``skip`` goes on); the JAX package's ``rollback`` is not ported.
"""

from __future__ import annotations

import contextlib
import time

import torch

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers.state import (
    param_compute_dtype,
    state_buffers,
    state_updates,
)
from imaginaire_tpu_torch.optim.optimizers import get_optimizer_for_params
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.init_weight import init_weights
from imaginaire_tpu_torch.utils.misc import resolve_device
from imaginaire_tpu_torch.utils.model_average import ema_init, ema_update

NONFINITE_POLICIES = ("halt", "skip")


class NonFiniteLossError(RuntimeError):
    """Raised by ``diagnostics.on_nonfinite: halt`` on a non-finite step."""


def compute_dtype_of(cfg):
    """The step's compute dtype: ``trainer.mixed_precision.compute_dtype``
    when ``mixed_precision.enabled``, else ``trainer.compute_dtype``,
    else fp32 (``imaginaire_tpu/trainers/base.py:101-107``)."""
    tcfg = cfg_get(cfg, "trainer", None) or {}
    mp = cfg_get(tcfg, "mixed_precision", None) or {}
    if cfg_get(mp, "enabled", False):
        name = cfg_get(mp, "compute_dtype", "bfloat16")
    else:
        name = cfg_get(tcfg, "compute_dtype", "float32")
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def _global_norm(tensors):
    """fp32 L2 norm of a list of tensors (the leaves are upcast first)."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class BaseTrainer:
    def __init__(self, cfg, device=None, train=False, iters_per_epoch=1):
        self.cfg = cfg = as_attrdict(cfg)
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.net_G = resolve(cfg.gen.type, "Generator")(cfg.gen, cfg.data)
        self.net_G.eval().requires_grad_(False)
        tcfg = cfg_get(cfg, "trainer", None) or {}
        self.model_average = cfg_get(tcfg, "model_average", False)
        self.model_average_remove_sn = cfg_get(tcfg, "model_average_remove_sn", True)
        self.model_average_beta = cfg_get(tcfg, "model_average_beta", 0.9999)
        self.model_average_start = cfg_get(tcfg, "model_average_start_iteration", 1000)
        init = cfg_get(tcfg, "init", None) or {}
        self.init_type = cfg_get(init, "type", "xavier")
        self.init_gain = cfg_get(init, "gain", 0.02)
        self.compute_dtype = compute_dtype_of(cfg)
        self.speed_benchmark = cfg_get(tcfg, "speed_benchmark", False)
        self.state = None
        self.ema_G = None
        self.net_D = None
        self.train = bool(train)
        self.timings = {"gen_step": [], "dis_step": []}
        if self.train:
            self._init_training(cfg, iters_per_epoch)

    # ---------------------------------------------------------- training

    def _init_training(self, cfg, iters_per_epoch):
        if cfg_get(cfg, "dis", None) is not None:
            with torch.device(self.device):
                self.net_D = resolve(cfg.dis.type, "Discriminator")(cfg.dis, cfg.data)
            self.net_D.eval().requires_grad_(False)
        self.weights = {}
        self._init_loss(cfg)
        self.opt_G = get_optimizer_for_params(
            cfg.gen_opt, self.net_G.parameters(), iters_per_epoch)
        self.opt_D = (get_optimizer_for_params(
            cfg.dis_opt, self.net_D.parameters(), iters_per_epoch)
            if self.net_D is not None else None)
        self.clip_grad_norm_G = cfg_get(cfg_get(cfg, "gen_opt", {}), "clip_grad_norm", None)
        self.clip_grad_norm_D = cfg_get(cfg_get(cfg, "dis_opt", {}), "clip_grad_norm", None)
        dcfg = cfg_get(cfg, "diagnostics", None) or {}
        self.guard = bool(cfg_get(dcfg, "enabled", True))
        self.on_nonfinite = str(cfg_get(dcfg, "on_nonfinite", "halt")).lower()
        if self.on_nonfinite not in NONFINITE_POLICIES:
            raise NotImplementedError(
                f"diagnostics.on_nonfinite={self.on_nonfinite!r} is not in the "
                f"port yet (ROADMAP.md); it has {NONFINITE_POLICIES}")
        self.nonfinite_events = 0
        self.num_ema_updates = 0
        self.gen_rng = torch.Generator(device=self.device)
        self.dis_rng = torch.Generator(device=self.device)

    def _init_loss(self, cfg):
        raise NotImplementedError(
            f"training of {type(self).__module__} is not in the port yet "
            f"(ROADMAP.md)")

    def init_loss_params(self, generator):
        """Weights of the loss networks (VGG19): frozen."""

    def init_state(self, seed=0):
        """Fresh weights from ``seed``: every kernel drawn on the device
        from one ``torch.Generator`` (G, then D, then the loss networks);
        the averaged copy starts as the sigma-collapsed weights, as the
        JAX trainer's ``ema_init`` does."""
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        init_weights(self.net_G, generator, self.init_type, self.init_gain)
        if self.net_D is not None:
            init_weights(self.net_D, generator, self.init_type, self.init_gain)
        if self.train:
            self.init_loss_params(generator)
            self.gen_rng.manual_seed(int(seed) + 1)
            self.dis_rng.manual_seed(int(seed) + 2)
        if self.model_average:
            self.ema_G = ema_init(self.net_G, self.model_average_remove_sn)
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

    def _get_outputs(self, net_D_output, real=True):
        """D's outputs for a target (differences of the real and fake
        outputs with ``trainer.gan_relativistic``)."""
        relativistic = cfg_get(cfg_get(self.cfg, "trainer", {}),
                               "gan_relativistic", False)

        def diff(a, b):
            return [diff(x, y) if isinstance(x, list) else x - y
                    for x, y in zip(a, b)]

        first, second = (("real_outputs", "fake_outputs") if real
                         else ("fake_outputs", "real_outputs"))
        if relativistic:
            return diff(net_D_output[first], net_D_output[second])
        return net_D_output[first]

    def _to_compute_dtype(self, data):
        """The data's fp32 tensors cast to the compute dtype."""
        if self.compute_dtype == torch.float32:
            return dict(data)
        return {k: (v.to(self.compute_dtype)
                    if torch.is_tensor(v) and v.dtype == torch.float32 else v)
                for k, v in data.items()}

    def _total(self, losses):
        """Weighted sum of the registered losses, in fp32."""
        total = torch.zeros((), device=self.device)
        for name, w in self.weights.items():
            if name in losses:
                total = total + losses[name].float() * w
        return total

    def gen_forward(self, data, noise):
        """(losses, G's output) of the G step."""
        raise NotImplementedError

    def dis_forward(self, data, noise):
        """Losses of the D step."""
        raise NotImplementedError

    def _draw_noise(self, data, generator):
        """The G noise of a step (the style code's eps), from ``generator``."""
        return None

    def _step(self, net, opt, forward, clip, key):
        """One update of ``net`` (G or D) by ``opt``. Returns the losses
        (fp32 scalars, ``total`` included)."""
        t0 = time.perf_counter() if self.speed_benchmark else None
        other = self.net_D if net is self.net_G else self.net_G
        params = list(net.parameters())
        kept_state = ([b.clone() for b in state_buffers(net)]
                      if self.guard else None)
        self.net_G.train()
        if self.net_D is not None:
            self.net_D.train()
        net.requires_grad_(True)
        opt.zero_grad()
        dtype = None if self.compute_dtype == torch.float32 else self.compute_dtype
        try:
            with contextlib.ExitStack() as policy:
                for n in (net, other):
                    if n is not None:
                        policy.enter_context(param_compute_dtype(n, dtype))
                        policy.enter_context(state_updates(n, n is net))
                losses = {k: v.float() for k, v in forward().items()}
                losses["total"] = total = self._total(losses)
                total.backward()
        finally:
            net.requires_grad_(False)
            self.net_G.eval()
            if self.net_D is not None:
                self.net_D.eval()
        grads = [p.grad for p in params if p.grad is not None]
        if clip:
            torch.nn.utils.clip_grad_norm_(params, clip)
        if self.guard:
            losses["grad_norm"] = grad_norm = _global_norm(grads)
            ok = bool(torch.isfinite(total) & torch.isfinite(grad_norm))
        else:
            ok = True
        if ok:
            opt.step()
        else:
            with torch.no_grad():
                for b, v in zip(state_buffers(net), kept_state):
                    b.copy_(v)
            self.nonfinite_events += 1
            if self.on_nonfinite == "halt":
                raise NonFiniteLossError(
                    f"non-finite {key} update after {opt.count} updates: total "
                    f"{float(total.detach())}, grad norm "
                    f"{float(losses['grad_norm'])}; set "
                    "diagnostics.on_nonfinite: skip to keep running")
        if net is self.net_G and self.model_average:
            self.num_ema_updates += 1
            ema_update(self.ema_G, self.net_G, self.num_ema_updates,
                       beta=self.model_average_beta,
                       start_iteration=self.model_average_start,
                       remove_sn=self.model_average_remove_sn)
        if self.speed_benchmark:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[key].append(time.perf_counter() - t0)
        return {k: v.detach() for k, v in losses.items()}

    def _prepare(self, data):
        return self._to_compute_dtype(data)

    def gen_update(self, data, noise=None):
        """The G step on ``data`` ({"label", "images"}: NCHW tensors on
        the trainer's device); ``noise`` (the style code's eps, else
        drawn from ``gen_rng``) may be injected."""
        if self.state is None:
            raise RuntimeError("init_state() before gen_update()")
        data = self._prepare(data)
        if noise is None:
            noise = self._draw_noise(data, self.gen_rng)
        losses = self._step(self.net_G, self.opt_G,
                            lambda: self.gen_forward(data, noise)[0],
                            self.clip_grad_norm_G, "gen_step")
        return losses

    def dis_update(self, data, noise=None):
        """The D step on ``data``; ``noise`` as for ``gen_update``."""
        if self.state is None:
            raise RuntimeError("init_state() before dis_update()")
        if self.net_D is None:
            return None
        data = self._prepare(data)
        if noise is None:
            noise = self._draw_noise(data, self.dis_rng)
        return self._step(self.net_D, self.opt_D,
                          lambda: self.dis_forward(data, noise),
                          self.clip_grad_norm_D, "dis_step")
