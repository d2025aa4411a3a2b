"""PyTorch port on the card: each CUDA kernel against its plain version at
small shapes.  Skips without a GPU.  A GPU machine need not have JAX, which
``tests/conftest.py`` imports, so run it there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.ops import block_kernel, norm_kernel
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (3, 6, 6, 6, 128), (2, 5, 7, 9, 3)])
def test_norm_kernel_matches_plain(gen, shape, dtype, bar):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    s = 0.5 + 0.05 * torch.randn(shape[-1], generator=gen, device="cuda")
    b = 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
    n = norm_kernel.launches
    got = norm_kernel.fused_instance_norm_leaky_relu(x, s, b)
    assert norm_kernel.launches == n + 1
    want = norm_kernel.reference_instance_norm_leaky_relu(x, s, b)
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_fused_model_matches_plain_model(gen, dtype, bar):
    model = init_weights(build_model(ModelConfig(), dtype, inference=True),
                         torch.Generator().manual_seed(0)).cuda().eval()
    x = torch.rand((2, 16, 16, 24, 1), generator=gen, device="cuda")
    n = block_kernel.launches
    with torch.no_grad():
        got = make_fused_apply(model)(x)
        want = model(x)
    assert block_kernel.launches == n + 8
    assert (got - want).abs().max().item() <= bar
