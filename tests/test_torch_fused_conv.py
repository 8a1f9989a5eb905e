"""Port parity for the fused Cayley-conv apply (kernel K3's module): the
plain version against the K3 Pallas kernel in interpret mode at
test_fused_conv.py's shapes and with batch padding, and the port's
CayleyConv layer against flax.  The CUDA kernel is held against the plain
version in test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.layers import CayleyConv as JaxCayleyConv
from fiode_tpu.ops.cayley import cayley_conv_kernel
from fiode_tpu.ops.fused_cayley_conv import fused_freq_apply as jax_fused
from fiode_tpu_torch.models.layers import CayleyConv
from fiode_tpu_torch.ops.fused_cayley_conv import fused_freq_apply
from fiode_tpu_torch.utils.tracing import counters

TOL = 1e-5


def _case(co, ci, k, n, B, seed=0):
    rng = np.random.default_rng(seed)
    W = jnp.asarray(rng.normal(0, 0.1, (co, ci, k, k)).astype(np.float32))
    x = rng.normal(0, 1, (B, ci, n, n)).astype(np.float32)
    Q = np.asarray(cayley_conv_kernel(W, jnp.float32(1.1), n))
    return x, Q


@pytest.mark.parametrize(
    "co,ci,k,n,B",
    [(5, 3, 3, 8, 8), (4, 6, 2, 8, 16), (8, 4, 3, 16, 4), (5, 3, 3, 8, 7)],
)
def test_plain_matches_pallas_kernel_interpret(co, ci, k, n, B):
    # B=7 with block_b=4: the Pallas kernel pads the batch to 8
    x, Q = _case(co, ci, k, n, B)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(Q), 4, True))
    before = counters().get("k3.launches", 0)
    got = fused_freq_apply(torch.from_numpy(x),
                           torch.from_numpy(np.ascontiguousarray(Q.real)),
                           torch.from_numpy(np.ascontiguousarray(Q.imag)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert counters().get("k3.launches", 0) == before  # CPU: no kernel launch


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 4)])
def test_cayley_conv_layer_matches_flax(stride, k):
    rng = np.random.default_rng(stride)
    x = rng.uniform(size=(3, 4, 8, 8)).astype(np.float32)
    jl = JaxCayleyConv(6, k, stride=stride)
    params = jl.init(jax.random.PRNGKey(stride), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["bias"] = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    tl = CayleyConv(4, 6, k, stride=stride)
    tl.load_state_dict({key: torch.from_numpy(np.array(v))
                        for key, v in params.items()})
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)

