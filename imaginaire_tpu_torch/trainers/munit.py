"""MUNIT trainer (port of ``imaginaire_tpu/trainers/munit.py``).

The loss terms: the two-domain GAN (with ``trainer.gan_recon`` the
within-domain reconstructions count as fakes too), the image, style,
content and cycle L1 reconstructions, the style codes' KL to the prior,
the perceptual loss on instance-normalized VGG19 features, and in the D
step the gradient penalty (``gp``) and the consistency regularization
(``consistency_reg``). A term is active when its ``loss_weight`` is
positive; ``D_real_acc`` and ``D_fake_acc`` are unweighted diagnostics.

The noise of a step (``_draw_noise``, or injected) is a dict: ``style``,
the prior's style codes (z_a, z_b), and with ``consistency_reg`` the
``shifts`` of the four shifted batches (images_a, images_b, images_ab,
images_ba), each an (oy, ox) pair of ``random_shift`` offsets.

The JAX D step applies G with its state mutable and drops the update,
and applies D a second time from the step's starting variables for the
gradient penalty and the consistency regularization: here G's state
advances within the step and is restored after it
(``_scratch_state_nets``), and those extra D forwards read D's buffers
as they were when the step began and write none.

The serving engine does not serve these families (``serves_requests``):
their inference takes both domains' images and a style, not a label.
"""

from __future__ import annotations

import os

import torch

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.layers.state import state_updates
from imaginaire_tpu_torch.losses import PerceptualLoss, dis_accuracy, gan_loss
from imaginaire_tpu_torch.losses.gan import GAN_MODES
from imaginaire_tpu_torch.losses.kl import gaussian_kl_loss
from imaginaire_tpu_torch.trainers.base import BaseTrainer
from imaginaire_tpu_torch.utils.misc import (
    gradient_penalty,
    random_shift,
    random_shift_offsets,
)

SHIFTED = ("images_a", "images_b", "images_ab", "images_ba")


def _l1(a, b):
    return (a - b).abs().mean()


def _leaves(tree):
    """The tensors of a nested list in depth-first order."""
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def at_start(module, prefix, start, *args, **kwargs):
    """``module`` (the part of a network at ``prefix``) applied to
    ``args`` from the buffers ``start`` ({name: tensor} of the whole
    network, e.g. as a step began), writing none."""
    params = {k: v for k, v in module.named_parameters()}
    params.update({k[len(prefix):]: v for k, v in start.items() if k.startswith(prefix)})
    with state_updates(module, False):
        return torch.func.functional_call(module, params, args, kwargs)


class _Inference(torch.nn.Module):
    """``g.inference`` as a module's forward, for ``functional_call``."""

    def __init__(self, g):
        super().__init__()
        self.g = g

    def forward(self, data, **kwargs):
        return self.g.inference(data, **kwargs)


class Trainer(BaseTrainer):
    serves_requests = False
    serves_requests_reason = ("the unpaired families translate a domain's images "
                              "under a style; the engine serves label-to-image "
                              "requests")

    def _init_loss(self, cfg):
        tcfg = cfg.trainer
        self.gan_mode = cfg_get(tcfg, "gan_mode", "hinge")
        if self.gan_mode not in GAN_MODES:
            raise ValueError(f"Unexpected gan_mode {self.gan_mode!r}")
        self.gan_recon = cfg_get(tcfg, "gan_recon", False)
        for name, w in as_attrdict(cfg_get(tcfg, "loss_weight", {}) or {}).items():
            if w and float(w) > 0:
                self.weights[name] = float(w)
        self.perceptual = None
        if "perceptual" in self.weights:
            self.perceptual = PerceptualLoss(
                network=cfg_get(tcfg, "perceptual_mode", "vgg19"),
                layers=list(cfg_get(tcfg, "perceptual_layers", None) or ["relu_4_1"]),
                instance_normalized=True,
                weights_path=cfg_get(tcfg, "perceptual_weights_path", None),
                allow_random_init=cfg_get(tcfg, "perceptual_allow_random_init", False),
                device=self.device)

    def init_loss_params(self, generator):
        if self.perceptual is not None:
            self.perceptual.init_params(generator)

    def _scratch_state_nets(self, net):
        return (self.net_G,) if net is self.net_D else ()

    # ------------------------------------------------------------- noise

    def _draw_noise(self, data, generator):
        images = data["images_a"]
        latent = self.net_G.autoencoder_a.style_channels
        out = {"style": tuple(torch.randn((images.shape[0], latent), generator=generator,
                                          device=images.device).to(images.dtype)
                              for _ in range(2))}
        if "consistency_reg" in self.weights:
            # a translation has its source domain's size
            shapes = [data[k].shape for k in ("images_a", "images_b", "images_a",
                                              "images_b")]
            out["shifts"] = [random_shift_offsets(shape, generator, device=images.device)
                             for shape in shapes]
        return out

    # ---------------------------------------------------------- forwards

    def _apply_G(self, data, noise, **flags):
        return self.net_G(data, noise=noise["style"], **flags)

    def gen_forward(self, data, noise):
        """(losses, G's output) of the G step."""
        w = self.weights
        cycle, image_recon = "cycle_recon" in w, "image_recon" in w
        out = self._apply_G(data, noise, random_style=True, image_recon=image_recon,
                            latent_recon=True, cycle_recon=cycle)
        d_out = self.net_D(data, out, real=False, gan_recon=self.gan_recon)
        losses = {}

        def g_gan(key):
            return gan_loss(d_out[key], True, self.gan_mode, dis_update=False)

        if self.gan_recon:
            losses["gan"] = (0.5 * (g_gan("out_ba") + g_gan("out_aa"))
                             + 0.5 * (g_gan("out_ab") + g_gan("out_bb")))
        else:
            losses["gan"] = g_gan("out_ba") + g_gan("out_ab")
        if self.perceptual is not None:
            losses["perceptual"] = (self.perceptual(out["images_ab"], data["images_a"])
                                    + self.perceptual(out["images_ba"], data["images_b"]))
        if image_recon:
            losses["image_recon"] = (_l1(out["images_aa"], data["images_a"])
                                     + _l1(out["images_bb"], data["images_b"]))
        losses["style_recon"] = (_l1(out["style_ba"], out["style_a_rand"])
                                 + _l1(out["style_ab"], out["style_b_rand"]))
        losses["content_recon"] = (_l1(out["content_ab"], out["content_a"].detach())
                                   + _l1(out["content_ba"], out["content_b"].detach()))
        losses["kl"] = gaussian_kl_loss(out["style_a"]) + gaussian_kl_loss(out["style_b"])
        if cycle:
            losses["cycle_recon"] = (_l1(out["images_aba"], data["images_a"])
                                     + _l1(out["images_bab"], data["images_b"]))
        return losses, out

    def _fakes(self, data, noise, **flags):
        """G's translated images of the D step, without a gradient."""
        with torch.no_grad():
            out = self._apply_G(data, noise, **flags)
        return {k: v for k, v in out.items() if k.startswith("images_")}

    def _dis_gan_losses(self, d_out):
        def d_gan(key, t_real):
            return gan_loss(d_out[key], t_real, self.gan_mode, dis_update=True)

        losses = {"gan": (d_gan("out_a", True) + d_gan("out_ba", False)
                          + d_gan("out_b", True) + d_gan("out_ab", False))}
        losses["D_real_acc"], losses["D_fake_acc"] = dis_accuracy(
            [d_out["out_a"], d_out["out_b"]], [d_out["out_ba"], d_out["out_ab"]],
            self.gan_mode)
        return losses

    def dis_forward(self, data, noise):
        """The D step's losses."""
        out = self._fakes(data, noise, random_style=True, image_recon=self.gan_recon,
                          latent_recon=False, cycle_recon=False)
        extra = "gp" in self.weights or "consistency_reg" in self.weights
        start = ({k: b.clone() for k, b in self.net_D.named_buffers()} if extra else None)
        d_out = self.net_D(data, out, real=True, gan_recon=self.gan_recon)
        losses = self._dis_gan_losses(d_out)
        if not extra:
            return losses

        if "gp" in self.weights:
            losses["gp"] = sum(
                gradient_penalty(lambda x, n=name: at_start(
                    getattr(self.net_D, n), f"{n}.", start, x)[0], out[key])
                for name, key in (("dis_a", "images_ba"), ("dis_b", "images_ab")))
        if "consistency_reg" in self.weights:
            src = dict(data, **out)
            aug = {k: random_shift(torch.flip(src[k], dims=(3,)), shift)
                   for k, shift in zip(SHIFTED, noise["shifts"])}
            d_aug = at_start(self.net_D, "", start, aug, aug, real=True)
            reg = torch.zeros((), device=self.device)
            for name in ("fea_ba", "fea_ab", "fea_a", "fea_b"):
                for xa, xb in zip(_leaves(d_aug[name]), _leaves(d_out[name])):
                    reg = reg + ((xa - xb) ** 2).mean()
            losses["consistency_reg"] = reg
        return losses

    # ----------------------------------------------------------- inference

    def _call_inference(self, params, data, **kwargs):
        """``net_G.inference`` under ``params`` (None: G's own)."""
        if params is None:
            return self.net_G.inference(data, **kwargs)
        wrapper = _Inference(self.net_G)
        return torch.func.functional_call(
            wrapper, {f"g.{k}": v for k, v in params.items()}, (data,), kwargs)

    def inference_forward(self, params, data, generator, inference_args):
        """``net_G.inference`` with the config's ``inference_args``
        (``a2b``, ``random_style``), the style drawn from ``generator``."""
        return self._call_inference(params, data, generator=generator, **inference_args)

    def _apply_G_with(self, params, data, **flags):
        return torch.func.functional_call(self.net_G, params, (data,), flags)

    @torch.no_grad()
    def _get_visualizations(self, data):
        """Both domains' images, their reconstructions, the translations
        under each domain's own style and under a style drawn from a
        generator seeded 0, and the cycle, as NHWC numpy (the inference
        weights)."""
        params = self.inference_params()

        def seeded():
            return torch.Generator(device=self.device).manual_seed(0)

        out = self._apply_G_with(params, data, generator=seeded(), random_style=False,
                                 image_recon=True, latent_recon=False, cycle_recon=True)
        rand = self._apply_G_with(params, data, generator=seeded(), random_style=True,
                                  image_recon=False, latent_recon=False,
                                  cycle_recon=False)
        vis = [data["images_a"], data["images_b"], out["images_aa"], out["images_bb"],
               out["images_ab"], rand["images_ab"], out["images_ba"], rand["images_ba"],
               out["images_aba"], out["images_bab"]]
        return [v.float().permute(0, 2, 3, 1).cpu().numpy() for v in vis]

    # ----------------------------------------------------------------- FID

    def _compute_fid(self):
        """FID_a (B's images translated into A, against A's) and FID_b (A's
        into B, against B's), each with a style drawn from a generator
        seeded 0 a batch, under the inference weights, into their meters;
        returns their mean. The real statistics are cached in the logdir's
        ``real_stats_{a,b}.npz``."""
        if self.val_data_loader is None:
            return None
        from imaginaire_tpu_torch.evaluation.fid import compute_fid

        try:
            extractor = self._fid_extractor()
        except FileNotFoundError as e:
            print(f"FID skipped: {e}")
            return None
        logdir = cfg_get(self.cfg, "logdir", ".")
        params = self.inference_params()
        val_loader = self._eval_loader(self.val_data_loader)
        fids = {}
        for domain, a2b, real_key in (("a", False, "images_a"), ("b", True, "images_b")):
            @torch.no_grad()
            def gen_fn(data, a2b=a2b):
                generator = torch.Generator(device=self.device).manual_seed(0)
                return self._call_inference(params, data, a2b=a2b, random_style=True,
                                            generator=generator)

            path = os.path.join(logdir, f"real_stats_{domain}.npz")
            fids[domain] = compute_fid(path, val_loader, extractor, gen_fn,
                                       key_real=real_key)
            self._meter(f"FID_{domain}").write(float(fids[domain]))
        return 0.5 * (fids["a"] + fids["b"])
