"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs and weights come from seeded numpy generators and go to both
packages as numpy arrays.  Importing this module turns TF32 off in torch, so
float32 convolutions on a card compare with JAX at ``highest`` precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def random_params(module, x_shape, seed: int, **init_kw):
    """Seeded numpy parameters for a flax ``module`` (shapes by
    ``jax.eval_shape``, so nothing is compiled): conv kernels uniform in
    +-1/sqrt(fan_in), norm scales near 1, biases near 0."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32), **init_kw))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        bound = float(np.prod(s.shape[:-1])) ** -0.5
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jit_apply(model):
    """``model.apply(params, x, train=False)`` compiled once (faster than eager on CPU)."""
    return jax.jit(lambda p, x: model.apply(p, x, train=False))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module (import this fixture into
    it): its ops are small, so one thread loses nothing alone, and parallel
    test workers no longer oversubscribe the cores; float reductions then
    do not depend on the machine's core count either."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
