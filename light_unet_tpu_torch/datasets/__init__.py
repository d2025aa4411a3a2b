"""Case index, volume cache, samplers and loaders (the names
``light_unet_tpu.datasets`` re-exports)."""

from light_unet_tpu_torch.datasets.case_dataset import CaseDataset, CaseSample  # noqa: F401
from light_unet_tpu_torch.datasets.index import (  # noqa: F401
    build_case_index,
    filter_cases_by_domain,
    find_case_files,
    read_split_file,
)
from light_unet_tpu_torch.datasets.loader import PrefetchLoader, get_data_loader  # noqa: F401
from light_unet_tpu_torch.datasets.patch_sampler import MixedPatchSampler, PatchSampler  # noqa: F401
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache  # noqa: F401

# the reference's names for the samplers
PatchDataset = PatchSampler
MixedPatchDataset = MixedPatchSampler
