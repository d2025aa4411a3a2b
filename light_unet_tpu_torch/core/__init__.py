"""Inference and training engines (the names ``light_unet_tpu.core``
re-exports)."""

from light_unet_tpu_torch.core.inferencer import Inferencer, extract_bboxes  # noqa: F401
from light_unet_tpu_torch.core.trainer import Trainer, is_better_metric  # noqa: F401
