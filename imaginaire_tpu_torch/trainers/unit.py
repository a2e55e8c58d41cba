"""UNIT trainer (port of ``imaginaire_tpu/trainers/unit.py``).

MUNIT's two-domain scaffolding without a style: the GAN, the
within-domain image reconstruction, the cycle and the perceptual loss
(a term is active when its ``loss_weight`` is positive). The generator
takes no noise and none of MUNIT's style flags.
"""

from __future__ import annotations

import torch

from imaginaire_tpu_torch.losses import gan_loss
from imaginaire_tpu_torch.trainers.munit import Trainer as MUNITTrainer
from imaginaire_tpu_torch.trainers.munit import _l1


class Trainer(MUNITTrainer):
    def _draw_noise(self, data, generator):
        return None

    def _apply_G(self, data, noise, **flags):
        for key in ("random_style", "latent_recon", "within_latent_recon"):
            flags.pop(key, None)
        return self.net_G(data, **flags)

    def gen_forward(self, data, noise):
        """(losses, G's output) of the G step."""
        cycle = "cycle_recon" in self.weights
        out = self._apply_G(data, noise, image_recon=True, cycle_recon=cycle)
        d_out = self.net_D(data, out, real=False)
        losses = {"gan": (gan_loss(d_out["out_ba"], True, self.gan_mode, dis_update=False)
                          + gan_loss(d_out["out_ab"], True, self.gan_mode,
                                     dis_update=False))}
        if self.perceptual is not None:
            losses["perceptual"] = (self.perceptual(out["images_ab"], data["images_a"])
                                    + self.perceptual(out["images_ba"], data["images_b"]))
        losses["image_recon"] = (_l1(out["images_aa"], data["images_a"])
                                 + _l1(out["images_bb"], data["images_b"]))
        if cycle:
            losses["cycle_recon"] = (_l1(out["images_aba"], data["images_a"])
                                     + _l1(out["images_bab"], data["images_b"]))
        return losses, out

    def dis_forward(self, data, noise):
        """The D step's losses: the GAN and D's accuracies."""
        out = self._fakes(data, noise, image_recon=False, cycle_recon=False)
        return self._dis_gan_losses(self.net_D(data, out, real=True))

    @torch.no_grad()
    def _get_visualizations(self, data):
        """Both domains' images, their reconstructions, the translations
        and the cycle, as NHWC numpy (the inference weights)."""
        out = self._apply_G_with(self.inference_params(), data, image_recon=True,
                                 cycle_recon=True)
        vis = [data["images_a"], data["images_b"], out["images_aa"], out["images_bb"],
               out["images_ab"], out["images_ba"], out["images_aba"], out["images_bab"]]
        return [v.float().permute(0, 2, 3, 1).cpu().numpy() for v in vis]
