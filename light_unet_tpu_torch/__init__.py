"""PyTorch + CUDA port of ``light_unet_tpu`` for NVIDIA Hopper GPUs.

The package mirrors ``light_unet_tpu``'s layout so each module has a named
counterpart, and its package ``__init__``s re-export the names the JAX
package's re-export.  It imports torch, numpy and scipy only: nothing of JAX
and nothing of the JAX package.  The serving path (``core.inferencer``) runs
on the GPU by default; the two TPU kernels of the residual block are
hand-written CUDA under ``csrc/`` (built on first use by ``ops/_build.py``).
"""

__version__ = "0.1.0"

from light_unet_tpu_torch.config import Config, ConfigManager  # noqa: F401, E402
