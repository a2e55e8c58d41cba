"""FUNIT trainer (port of ``imaginaire_tpu/trainers/funit.py``), for FUNIT
and COCO-FUNIT alike (the COCO variant swaps only the generator).

The G step's terms: ``gan``, the mean of the G hinge losses on the
translation (under the style labels) and on the reconstruction (under
the content labels); ``image_recon``, the L1 of the reconstruction to
the content image; ``feature_matching``, the L1 between D's pooled
features of the translation and of the real style image. The D step's:
``gan`` on the real style image against the translation, the unweighted
``D_real_acc`` / ``D_fake_acc``, and with a positive weight ``gp``, the
gradient penalty of D's model on the translation from the step's
starting ``u``. A term is active when its ``loss_weight`` is positive.
G takes no noise. As in MUNIT's trainer (whose inference plumbing this
one shares), G's state advances within the D step and is restored after
it.

FID is the mean over the validation set's style classes of the FID of
each class's translations (each sweep pinned to the class with
``set_sample_class_idx``) against the class's style images, whose
statistics are cached in the logdir's ``real_stats_style<class>.npz``:
of the live G, and with ``trainer.model_average`` FID_ema of the
averaged copy. The JAX trainer reports one number, of its inference
weights (the averaged copy when it averages) (ROADMAP.md, section C).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.losses import dis_accuracy, gan_loss
from imaginaire_tpu_torch.losses.gan import GAN_MODES
from imaginaire_tpu_torch.trainers.munit import Trainer as MUNITTrainer
from imaginaire_tpu_torch.trainers.munit import _l1, at_start
from imaginaire_tpu_torch.utils.misc import gradient_penalty


class Trainer(MUNITTrainer):
    def _init_loss(self, cfg):
        tcfg = cfg.trainer
        self.gan_mode = cfg_get(tcfg, "gan_mode", "hinge")
        if self.gan_mode not in GAN_MODES:
            raise ValueError(f"Unexpected gan_mode {self.gan_mode!r}")
        for name, w in as_attrdict(cfg_get(tcfg, "loss_weight", {}) or {}).items():
            if w and float(w) > 0:
                self.weights[name] = float(w)
        self.perceptual = None

    def _draw_noise(self, data, generator):
        return None

    def _apply_G(self, data, noise, **flags):
        return self.net_G(data)

    def gen_forward(self, data, noise):
        """(losses, G's output) of the G step."""
        out = self.net_G(data)
        d_out = self.net_D(data, out, recon=True)

        def g_gan(key):
            return gan_loss(d_out[key], True, self.gan_mode, dis_update=False)

        losses = {"gan": 0.5 * (g_gan("fake_out_trans") + g_gan("fake_out_recon")),
                  "image_recon": _l1(out["images_recon"], data["images_content"]),
                  "feature_matching": _l1(d_out["fake_features_trans"],
                                          d_out["real_features_style"])}
        return losses, out

    def dis_forward(self, data, noise):
        """The D step's losses."""
        out = self._fakes(data, noise)
        start = ({k: b.clone() for k, b in self.net_D.named_buffers()}
                 if "gp" in self.weights else None)
        d_out = self.net_D(data, out, recon=False)
        losses = {"gan": (gan_loss(d_out["real_out_style"], True, self.gan_mode,
                                   dis_update=True)
                          + gan_loss(d_out["fake_out_trans"], False, self.gan_mode,
                                     dis_update=True))}
        losses["D_real_acc"], losses["D_fake_acc"] = dis_accuracy(
            d_out["real_out_style"], d_out["fake_out_trans"], self.gan_mode)
        if "gp" in self.weights:
            losses["gp"] = gradient_penalty(
                lambda x: at_start(self.net_D.model, "model.", start, x,
                                   data["labels_style"])[0],
                out["images_trans"])
        return losses

    @torch.no_grad()
    def _get_visualizations(self, data):
        """The content and style images, the reconstruction and the
        translation, as NHWC numpy (the inference weights)."""
        out = self._apply_G_with(self.inference_params(), data)
        vis = [data["images_content"], data["images_style"], out["images_recon"],
               out["images_trans"]]
        return [v.float().permute(0, 2, 3, 1).cpu().numpy() for v in vis]

    def _class_mean_fid(self, dataset, extractor, params):
        """The mean over the style classes of each class's FID under
        ``params`` (None: G's own)."""
        from imaginaire_tpu_torch.evaluation.fid import compute_fid

        @torch.no_grad()
        def gen_fn(data):
            return self._call_inference(params, data)

        logdir = cfg_get(self.cfg, "logdir", ".")
        val_loader = self._eval_loader(self.val_data_loader)
        fids = []
        try:
            for class_idx in range(dataset.num_style_classes):
                dataset.set_sample_class_idx(class_idx)
                path = os.path.join(logdir, f"real_stats_style{class_idx}.npz")
                fids.append(compute_fid(path, val_loader, extractor, gen_fn,
                                        key_real="images_style"))
        finally:
            dataset.set_sample_class_idx(None)
        return float(np.mean(fids))

    def _compute_fid(self):
        """The mean per-class FID of the live G; with model averaging,
        FID_ema of the averaged copy into its meter."""
        dataset = getattr(self.val_data_loader, "dataset", None)
        if dataset is None or not hasattr(dataset, "num_style_classes"):
            return None
        try:
            extractor = self._fid_extractor()
        except FileNotFoundError as e:
            print(f"FID skipped: {e}")
            return None
        fid = self._class_mean_fid(dataset, extractor, None)
        if self.model_average:
            self.fid_ema = self._class_mean_fid(dataset, extractor, self.inference_params())
            self._meter("FID_ema").write(self.fid_ema)
        return fid
