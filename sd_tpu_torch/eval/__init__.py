"""Sample-quality and steering metrics (`sd_tpu/eval`'s exports)."""

from sd_tpu_torch.eval.classifier import (
    TinyImageClassifier,
    classifier_fn,
    steering_score,
    train_image_classifier,
)
from sd_tpu_torch.eval.fid import (
    clip_feature_fn,
    extract_features,
    fid,
    fid_from_features,
    frechet_distance,
    gaussian_stats,
)
