"""Port parity: Cayley transforms, the per-frequency conv matrices, the
frequency apply (dft and fft), groupsort2 and space_to_depth against the JAX
package on the same numpy inputs (CPU, float32)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.models.layers import space_to_depth as jax_s2d
from fiode_tpu_torch.models.layers import space_to_depth
from fiode_tpu_torch.ops import cayley as tc

# the JAX ops package re-exports a function named cayley over the module
jc = importlib.import_module("fiode_tpu.ops.cayley")

TOL = 1e-5
TOL_CONV_Q = 1e-4


def _mat(shape, seed, complex_=False, scale=0.3):
    rng = np.random.default_rng(seed)
    w = scale * rng.normal(size=shape)
    if complex_:
        w = w + 1j * scale * rng.normal(size=shape)
        return w.astype(np.complex64)
    return w.astype(np.float32)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("shape", [(6, 6), (9, 4), (4, 9), (3, 7, 5), (3, 5, 7)])
def test_cayley_matches_jax(shape, complex_):
    W = _mat(shape, seed=len(shape) * 10 + shape[-1], complex_=complex_)
    want = np.asarray(jc.cayley(jnp.asarray(W)))
    got = tc.cayley(torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cayley_linear_kernel_matches_jax():
    W = _mat((32, 20), seed=5)
    alpha = np.float32(3.5)
    want = np.asarray(jc.cayley_linear_kernel(jnp.asarray(W), alpha))
    got = tc.cayley_linear_kernel(torch.from_numpy(W), torch.tensor(alpha))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


# (ci, co, k, n) of the flagship's four CayleyConv layers
FLAGSHIP_CONVS = [(3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16),
                  (256, 64, 2, 8)]


@pytest.mark.parametrize("ci,co,k,n", FLAGSHIP_CONVS)
def test_cayley_conv_kernel_matches_jax(ci, co, k, n):
    W = _mat((co, ci, k, k), seed=ci + co, scale=0.1)
    alpha = np.float32(np.linalg.norm(W))
    want = np.asarray(jc.cayley_conv_kernel(jnp.asarray(W), alpha, n))
    got = tc.cayley_conv_kernel(torch.from_numpy(W), torch.tensor(alpha), n)
    assert got.shape == (n * (n // 2 + 1), co, ci)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_CONV_Q)


def test_dft_matrices_equal_jax():
    for n in (8, 16, 32):
        for a, b in zip(tc._dft2_mats(n), jc._dft2_mats(n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["dft", "fft"])
@pytest.mark.parametrize("co,ci,k,n,B", [(5, 3, 3, 8, 4), (4, 6, 2, 8, 3),
                                         (8, 4, 3, 16, 2)])
def test_apply_freq_matrices_matches_jax(impl, co, ci, k, n, B):
    rng = np.random.default_rng(co * ci)
    W = rng.normal(0, 0.1, (co, ci, k, k)).astype(np.float32)
    x = rng.normal(0, 1, (B, ci, n, n)).astype(np.float32)
    Q = np.array(jc.cayley_conv_kernel(jnp.asarray(W), np.float32(1.1), n))
    want = np.asarray(jc.apply_freq_matrices(jnp.asarray(x), jnp.asarray(Q),
                                             impl=impl))
    got = tc.apply_freq_matrices(torch.from_numpy(x), torch.from_numpy(Q),
                                 impl=impl).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_apply_freq_matrices_rejects_unknown_impl():
    with pytest.raises(ValueError):
        tc.apply_freq_matrices(torch.zeros(1, 2, 4, 4),
                               torch.zeros(12, 2, 2, dtype=torch.complex64),
                               impl="dft3")


@pytest.mark.parametrize("shape,dim", [((4, 6, 5, 5), 1), ((7, 12), -1),
                                       ((3, 4, 8), 2)])
def test_groupsort2_matches_jax(shape, dim):
    x = _mat(shape, seed=7)
    want = np.asarray(jc.groupsort2(jnp.asarray(x), dim))
    got = tc.groupsort2(torch.from_numpy(x), dim).numpy()
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_matches_jax():
    x = _mat((2, 3, 8, 8), seed=8)
    want = np.asarray(jax_s2d(jnp.asarray(x), 2))
    got = space_to_depth(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    # channel index c*4 + bi*2 + bj
    np.testing.assert_array_equal(got[:, 1 * 4 + 1 * 2 + 0], x[:, 1, 1::2, 0::2])
