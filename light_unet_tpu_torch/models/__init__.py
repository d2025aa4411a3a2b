"""The models, their losses and metrics (the names ``light_unet_tpu.models``
re-exports, and the port's other models, ``SwinUNETR`` and ``MedNeXt``, for
inference).
``init_params`` has no counterpart: a torch module holds its parameters
from construction (``unet3d.init_weights`` draws them from a generator), so
the port has no separate initializing forward."""

from light_unet_tpu_torch.models.unet3d import (  # noqa: F401
    Lightweight3DUNet,
    build_model,
    count_parameters,
)
from light_unet_tpu_torch.models.swin_unetr import SwinUNETR  # noqa: F401
from light_unet_tpu_torch.models.mednext import MedNeXt  # noqa: F401
from light_unet_tpu_torch.models.losses import (  # noqa: F401
    bce_loss,
    combined_loss,
    dice_loss,
    focal_tversky_loss,
    get_loss_function,
)
from light_unet_tpu_torch.models.metrics import (  # noqa: F401
    calculate_dsc,
    calculate_lesion_metrics,
    calculate_metrics,
    get_connected_components,
    match_components,
)

# The reference keeps its dataset classes importable from the models package
# for older call sites; the JAX package and the port keep the shim.
from light_unet_tpu_torch.datasets import (  # noqa: F401, E402
    CaseDataset,
    MixedPatchDataset,
    PatchDataset,
    filter_cases_by_domain,
)
