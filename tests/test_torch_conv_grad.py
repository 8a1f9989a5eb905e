"""The backward of the orthogonal-conv apply (kernel K3's module): the VJP in
x of the plain dense-DFT apply equals the apply of Q^H, the identity the
CUDA backward launches K3 on, at the flagship's four conv shapes with Cayley
Q; and the port's VJP equals the JAX package's (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu.ops.cayley import apply_freq_matrices as jax_apply
from fiode_tpu_torch.ops.cayley import apply_freq_matrices, cayley_conv_kernel

# float32 round-off of two dense-DFT applies of unit-scale inputs
TOL = 1e-5
B = 2
# (ci, co, k, n) of the flagship's four CayleyConv applies
SHAPES = [(3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16), (256, 64, 2, 8)]


def _case(ci, co, k, n, seed=0):
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(co, ci, k, k))).astype(np.float32)
    Q = cayley_conv_kernel(torch.from_numpy(W), torch.tensor(1.1), n)
    x = rng.normal(size=(B, ci, n, n)).astype(np.float32)
    g = rng.normal(size=(B, co, n, n)).astype(np.float32)
    return Q, x, g


def _q_herm(Q):
    """What the CUDA backward hands K3: (Qr^T, -Qi^T) per frequency."""
    return torch.complex(Q.real.transpose(1, 2), -Q.imag.transpose(1, 2))


@pytest.mark.parametrize("ci,co,k,n", SHAPES)
def test_vjp_in_x_is_the_apply_of_q_herm(ci, co, k, n):
    Q, x, g = _case(ci, co, k, n)
    xt = torch.from_numpy(x).requires_grad_()
    y = apply_freq_matrices(xt, Q, impl="dft")
    (vjp,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    with torch.no_grad():
        herm = apply_freq_matrices(torch.from_numpy(g), _q_herm(Q), impl="dft")
    assert herm.shape == (B, ci, n, n)
    np.testing.assert_allclose(herm.numpy(), vjp.numpy(), atol=TOL)


@pytest.mark.parametrize("ci,co,k,n", SHAPES[:2])
def test_vjp_matches_jax(ci, co, k, n):
    Q, x, g = _case(ci, co, k, n, seed=1)
    Qj = jnp.asarray(Q.resolve_conj().numpy())
    _, vjp = jax.vjp(lambda x_, Q_: jax_apply(x_, Q_, impl="dft"),
                     jnp.asarray(x), Qj)
    want_x, want_q = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    qr = Q.real.clone().requires_grad_()
    qi = Q.imag.clone().requires_grad_()
    y = apply_freq_matrices(xt, torch.complex(qr, qi), impl="dft")
    dx, dqr, dqi = torch.autograd.grad(y, (xt, qr, qi), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_x), atol=TOL)
    # JAX's cotangent of a complex input is the conjugate of d/dRe + i d/dIm
    want_q = np.conj(np.asarray(want_q))
    scale = np.abs(want_q).max()
    np.testing.assert_allclose(dqr.numpy(), want_q.real, atol=TOL * scale)
    np.testing.assert_allclose(dqi.numpy(), want_q.imag, atol=TOL * scale)
