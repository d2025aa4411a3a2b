from light_unet_tpu_torch.ops.augment import make_augment_fn  # noqa: F401
from light_unet_tpu_torch.ops.body_mask import generate_body_mask  # noqa: F401
from light_unet_tpu_torch.ops.ccl import keep_largest_component, label_components  # noqa: F401
from light_unet_tpu_torch.ops.gaussian import gaussian_importance_map  # noqa: F401
from light_unet_tpu_torch.ops.intensity import clip_and_normalize  # noqa: F401
from light_unet_tpu_torch.ops.morphology import binary_closing, binary_dilation, binary_erosion  # noqa: F401
from light_unet_tpu_torch.ops.sliding_window import (  # noqa: F401
    SlidingWindowInferencer,
    compute_positions,
    sliding_window_inference_3d,
)
