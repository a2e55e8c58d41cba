"""Evaluation metrics (port of ``imaginaire_tpu/evaluation/``): FID, KID
and PRDC over Inception-v3 activations. The JAX package's continuous
evaluation plane and its reference-feature store (``plane.py``,
``feature_store.py``) are not in the port (ROADMAP.md A.8)."""

from imaginaire_tpu_torch.evaluation.common import (
    get_activations,
    get_video_activations,
    preprocess_for_inception,
)
from imaginaire_tpu_torch.evaluation.fid import (
    FEATURE_GRAPH_VERSION,
    activation_stats,
    calculate_frechet_distance,
    compute_fid,
    load_or_compute_stats,
)
from imaginaire_tpu_torch.evaluation.inception import InceptionV3, load_params, make_extractor
from imaginaire_tpu_torch.evaluation.kid import kid_from_activations, polynomial_mmd
from imaginaire_tpu_torch.evaluation.prdc import prdc_from_activations

__all__ = [
    "get_activations", "get_video_activations", "preprocess_for_inception",
    "FEATURE_GRAPH_VERSION", "activation_stats", "calculate_frechet_distance",
    "compute_fid", "load_or_compute_stats",
    "InceptionV3", "load_params", "make_extractor",
    "kid_from_activations", "polynomial_mmd", "prdc_from_activations",
]
