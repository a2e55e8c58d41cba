"""Training losses of the port (NCHW)."""

from imaginaire_tpu_torch.losses.feature_matching import feature_matching_loss
from imaginaire_tpu_torch.losses.gan import dis_accuracy, gan_loss
from imaginaire_tpu_torch.losses.kl import gaussian_kl_loss
from imaginaire_tpu_torch.losses.perceptual import PerceptualLoss

__all__ = ["PerceptualLoss", "dis_accuracy", "feature_matching_loss",
           "gan_loss", "gaussian_kl_loss"]
