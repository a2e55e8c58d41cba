"""SPADE trainer (port of ``imaginaire_tpu/trainers/spade.py``).

On top of the base trainer (``trainers/base.py``: device, seeded
weights, averaged inference weights, the D+G step) it expands integer
label maps on the device, rounds host arrays to the generator's base
multiple, and defines the SPADE losses: the GAN loss in the config's
mode, VGG19 perceptual, feature matching and the style encoder's
Gaussian KL, at the config's weights. The G noise (the style encoder's VAE eps) of a step is drawn
from the trainer's ``gen_rng`` / ``dis_rng`` generators, or injected.
For the loop it folds 5-D batches into label channels
(``_start_of_iteration``) and draws the image snapshots
(``_get_visualizations``, whose EMA column re-estimates the averaged
copy's BatchNorm statistics first).

Evaluation (``_compute_fid``, ``_extra_metric_activations``): the eval
forward (``training=False``, the style code from the real image with the
eps of a generator seeded 0) over the validation loader. FID runs on the
live G and its live statistics; FID_ema re-estimates the averaged copy's
statistics first and runs on ``inference_params()``; KID and PRDC take
``inference_params()`` as they stand (no re-estimation), as in the JAX
trainer.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.losses import (
    PerceptualLoss,
    dis_accuracy,
    feature_matching_loss,
    gan_loss,
    gaussian_kl_loss,
)
from imaginaire_tpu_torch.trainers.base import BaseTrainer
from imaginaire_tpu_torch.utils.data import (
    get_crop_or_resize_h_w,
    get_paired_input_label_channel_number,
)


class Trainer(BaseTrainer):
    def __init__(self, cfg, device=None, train=False, iters_per_epoch=1,
                 train_data_loader=None, val_data_loader=None):
        super().__init__(cfg, device=device, train=train,
                         iters_per_epoch=iters_per_epoch,
                         train_data_loader=train_data_loader,
                         val_data_loader=val_data_loader)
        try:
            crop_h, crop_w = get_crop_or_resize_h_w(self.cfg.data.train.augmentations)
            self.base = {256: 16, 512: 32, 1024: 64}.get(min(crop_h, crop_w), 32)
        except (AttributeError, KeyError, ValueError):
            self.base = 32  # size-less config

    def _init_loss(self, cfg):
        tcfg = cfg.trainer
        self.gan_mode = cfg_get(tcfg, "gan_mode", "hinge")
        self.weights["GAN"] = tcfg.loss_weight.gan
        self.weights["FeatureMatching"] = tcfg.loss_weight.feature_matching
        if cfg_get(tcfg.loss_weight, "kl", None) is not None:
            self.weights["GaussianKL"] = tcfg.loss_weight.kl
        self.perceptual = None
        if cfg_get(tcfg, "perceptual_loss", None) is not None:
            p = tcfg.perceptual_loss
            self.perceptual = PerceptualLoss(
                network=p.mode, layers=list(p.layers),
                weights=list(cfg_get(p, "weights", None) or []) or None,
                weights_path=cfg_get(p, "weights_path", None),
                allow_random_init=cfg_get(p, "allow_random_init", False),
                device=self.device)
            self.weights["Perceptual"] = tcfg.loss_weight.perceptual

    def init_loss_params(self, generator):
        if self.perceptual is not None:
            self.perceptual.init_params(generator)

    def _draw_noise(self, data, generator):
        if not self.net_G.use_style_encoder:
            return None
        label = data["label"]
        return torch.randn((label.shape[0], self.net_G.style_dims),
                           generator=generator, device=label.device)

    def _prepare(self, data):
        return self._expand_labels(self._to_compute_dtype(data))

    def gen_forward(self, data, noise):
        """(losses, G's output): GAN (G form), FeatureMatching,
        GaussianKL and Perceptual."""
        net_G_output = self.net_G(data, noise=noise)
        net_D_output = self.net_D(data, net_G_output)
        losses = {}
        losses["GAN"] = gan_loss(self._get_outputs(net_D_output, real=False),
                                 True, self.gan_mode, dis_update=False)
        losses["FeatureMatching"] = feature_matching_loss(
            net_D_output["fake_features"], net_D_output["real_features"])
        if net_G_output.get("mu") is not None:
            losses["GaussianKL"] = gaussian_kl_loss(net_G_output["mu"],
                                                    net_G_output["logvar"])
        else:
            losses["GaussianKL"] = torch.zeros((), device=self.device)
        if self.perceptual is not None:
            losses["Perceptual"] = self.perceptual(net_G_output["fake_images"],
                                                   data["images"])
        return losses, net_G_output

    def dis_forward(self, data, noise):
        """GAN/fake, GAN/true and their sum GAN (D form), and D's
        real/fake accuracy (unweighted: it never enters the total)."""
        with torch.no_grad():
            fake = self.net_G(data, noise=noise)["fake_images"]
        net_D_output = self.net_D(data, {"fake_images": fake})
        fake_loss = gan_loss(self._get_outputs(net_D_output, real=False),
                             False, self.gan_mode, dis_update=True)
        true_loss = gan_loss(self._get_outputs(net_D_output, real=True),
                             True, self.gan_mode, dis_update=True)
        losses = {"GAN/fake": fake_loss, "GAN/true": true_loss,
                  "GAN": fake_loss + true_loss}
        losses["D_real_acc"], losses["D_fake_acc"] = dis_accuracy(
            net_D_output["real_outputs"], net_D_output["fake_outputs"],
            self.gan_mode)
        return losses

    def _expand_labels(self, data):
        """One-hot for integer label maps: (B, H, W) ints -> (B, C, H, W)
        in the compute dtype, with ``label_float`` (non-mask label types
        such as edge maps, NCHW) concatenated after the one-hot channels.
        Float label tensors pass through."""
        label = data.get("label")
        if label is None or label.is_floating_point():
            return data
        n = get_paired_input_label_channel_number(self.cfg.data)
        extra = data.get("label_float")
        if extra is not None:
            n = n - extra.shape[1]
        onehot = F.one_hot(label.long(), n).permute(0, 3, 1, 2)
        onehot = onehot.to(self.compute_dtype)
        if extra is not None:
            onehot = torch.cat([onehot, extra.to(onehot.dtype)], dim=1)
        out = dict(data, label=onehot)
        out.pop("label_float", None)
        return out

    def _start_of_iteration(self, data, current_iteration):
        """Fold 5-D (N, T, H, W, C) batches into label channels (the
        previous frames' images after the labels; the last frame's image
        is the target), then round H and W to the generator's base."""
        label = np.asarray(data["label"])
        if label.ndim == 5:
            images = np.asarray(data["images"])
            prev = images[:, :-1]
            n, tm1, h, w, c = prev.shape
            label_image = prev.transpose(0, 2, 3, 1, 4).reshape(n, h, w, tm1 * c)
            label_flat = label.transpose(0, 2, 3, 1, 4).reshape(
                n, h, w, label.shape[1] * label.shape[-1])
            data = dict(data, label=np.concatenate([label_flat, label_image], axis=-1),
                        images=images[:, -1])
        return self._resize_data(data)

    def _inference_data(self, data):
        """The batch as G's eval forward takes it: int label maps one-hot
        expanded, floating tensors in fp32."""
        out = self._expand_labels(data)
        return {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
                for k, v in out.items()}

    @torch.no_grad()
    def _get_visualizations(self, data):
        """(image, label channel 0, fake[, fake of the averaged weights])
        as NHWC numpy, each forward with a style code drawn from a
        generator seeded 0."""
        data = self._inference_data(data)

        def fake(params):
            generator = torch.Generator(device=self.device).manual_seed(0)
            return self._generate(data, params, generator, random_style=True)[:, :3]

        vis = [data["images"][:, :3], data["label"][:, :1], fake(None)]
        if self.model_average:
            self.recalculate_model_average_batch_norm_statistics()
            vis.append(fake(self.inference_params()))
        return [v.float().permute(0, 2, 3, 1).cpu().numpy() for v in vis]

    def _resize_data(self, data):
        """Round H/W of NHWC host arrays down to the generator's base
        multiple."""
        base = self.base
        out = dict(data)
        for key in ("label", "images", "label_float"):
            if key in out:
                arr = np.asarray(out[key])
                h, w = arr.shape[1:3]
                h2, w2 = (h // base) * base, (w // base) * base
                if (h2, w2) != (h, w):
                    out[key] = arr[:, :h2, :w2]
        return out

    # ------------------------------------------------------------------ FID

    def _eval_noise(self, data):
        """The style code's eps of an eval forward: from a generator
        seeded 0 (the JAX trainer's fixed key), the same for every batch."""
        return self._draw_noise(data, torch.Generator(device=self.device).manual_seed(0))

    def _make_eval_gen_fn(self, params):
        """Prepared batch -> G's fake images under ``params`` (None: the
        live network), the eval forward."""
        @torch.no_grad()
        def gen_fn(data):
            return self._generate(data, params, None, random_style=False,
                                  noise=self._eval_noise(data))
        return gen_fn

    def _extra_metric_activations(self, extractor):
        """(real, fake) activations of the validation set for KID and
        PRDC, the fakes from ``inference_params()``; the real ones cached
        across a checkpoint sweep."""
        from imaginaire_tpu_torch.evaluation.common import get_activations

        gen_fn = self._make_eval_gen_fn(self.inference_params())
        val_loader = self._eval_loader(self.val_data_loader)
        act_fake = get_activations(val_loader, "images", "fake_images", extractor,
                                   generator_fn=gen_fn)
        data_name = cfg_get(cfg_get(self.cfg, "data", {}), "name", "data")
        act_real = self._cached_real_activations(
            f"real_acts_{data_name}.npz",
            lambda: get_activations(val_loader, "images", "fake_images", extractor))
        return act_real, act_fake

    def _compute_fid(self):
        """FID of the live G, and FID_ema (into its meter) of the averaged
        copy after its statistics are re-estimated; the real statistics
        cached in the logdir's ``real_stats_<data name>.npz``."""
        if self.val_data_loader is None:
            return None
        from imaginaire_tpu_torch.evaluation.fid import compute_fid

        try:
            extractor = self._fid_extractor()
        except FileNotFoundError as e:
            print(f"FID skipped: {e}")
            return None
        logdir = cfg_get(self.cfg, "logdir", ".")
        data_name = cfg_get(cfg_get(self.cfg, "data", {}), "name", "data")
        fid_path = os.path.join(logdir, f"real_stats_{data_name}.npz")
        val_loader = self._eval_loader(self.val_data_loader)
        fid = compute_fid(fid_path, val_loader, extractor, self._make_eval_gen_fn(None))
        if self.model_average:
            self.recalculate_model_average_batch_norm_statistics()
            fid_ema = compute_fid(fid_path, val_loader, extractor,
                                  self._make_eval_gen_fn(self.inference_params()))
            self.fid_ema = fid_ema
            self._meter("FID_ema").write(float(fid_ema))
        return fid
