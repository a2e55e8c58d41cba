"""UNIT discriminator (port of ``imaginaire_tpu/models/discriminators/unit.py``):
MUNIT's two-domain discriminator, its patch variant selected by
``patch_dis`` and sharing one patch discriminator's weights across the
pyramid's scales."""

from __future__ import annotations

from imaginaire_tpu_torch.models.discriminators.munit import (
    Discriminator as MUNITDiscriminator,
)


class Discriminator(MUNITDiscriminator):
    patch_key = "patch_dis"
    weight_shared = True
