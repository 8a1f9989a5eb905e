"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed.  The kernel tests need a CUDA device and skip
without one; on a GPU machine run them with

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest.py sets up JAX).
"""
import numpy as np
import pytest
import torch

from fiode_tpu_torch.ops.cayley import apply_freq_matrices, cayley_conv_kernel
from fiode_tpu_torch.ops.fused_cayley_conv import fused_freq_apply
from fiode_tpu_torch.ops.fused_rhs import (
    RhsParams,
    fused_rhs,
    fused_rhs_vjp,
    pack_rhs_params,
    rhs_reference,
    rhs_vjp_reference,
    staged_warps,
)
from fiode_tpu_torch.ops.simplex_qp import cone_project_mu

A1, S1, A2 = 100.0, 0.02, 20.0
K1_TOL = 2e-4
K2_TOL = 1e-4
K3_TOL = 1e-4
# rows whose float64 pre-activations lie this close to a ReLU kink, or whose
# projection lanes this close to the active-set boundary, get a zero
# cotangent in the K2 checks: there the gradient jumps, and two correct
# float32 evaluations (the kernel's and cuBLAS's sum orders) may take
# different sides
KINK_MARGIN, ACTIVE_MARGIN = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rhs_inputs(B, n, mlp, seed, device):
    g = torch.Generator().manual_seed(seed)
    h = torch.rand(B, n, generator=g)
    h = h / h.sum(-1, keepdim=True)
    xc = 0.5 * torch.randn(B, mlp, generator=g)
    w = [0.3 * torch.randn(*s, generator=g)
         for s in ((mlp, n), (mlp, mlp), (n, mlp), (mlp,), (n,))]
    return h.to(device), xc.to(device), pack_rhs_params(*(t.to(device) for t in w))


def _conv_inputs(ci, co, k, n, B, seed, device):
    g = torch.Generator().manual_seed(seed)
    W = 0.1 * torch.randn(co, ci, k, k, generator=g)
    Q = cayley_conv_kernel(W, torch.tensor(1.1), n)
    x = torch.randn(B, ci, n, n, generator=g)
    return (x.to(device), Q.real.contiguous().to(device),
            Q.imag.contiguous().to(device))


@pytest.mark.parametrize("scale_nominal", [False, True])
@pytest.mark.parametrize("B,n,mlp", [(4096, 10, 128), (37, 10, 128),
                                     (100, 3, 16), (65, 32, 160),
                                     (300, 64, 128), (300, 100, 128)])
def test_fused_rhs_kernel_matches_plain(cuda, B, n, mlp, scale_nominal):
    h, xc, p = _rhs_inputs(B, n, mlp, B + n, cuda)
    before = fused_rhs.launches
    got = fused_rhs(h, xc, p, A1, S1, A2, scale_nominal, 30)
    assert fused_rhs.launches == before + 1
    want = rhs_reference(h, xc, p, A1, S1, A2, scale_nominal, 30)
    torch.testing.assert_close(got, want, atol=K1_TOL, rtol=0)
    # no atomics: repeated launches are bit-identical
    again = fused_rhs(h, xc, p, A1, S1, A2, scale_nominal, 30)
    assert torch.equal(got, again)


def _kink_free_cotangent(h, xc, p, seed, scale_nominal=False):
    """A unit-normal cotangent (B, n), zero on rows near a kink."""
    d = [t.double() for t in (h, xc, *p)]
    h64, xc64, q = d[0], d[1], RhsParams(*d[2:])
    pre1 = h64 @ q.W1.T + xc64
    pre2 = torch.relu(pre1) @ q.W2.T + q.b2
    f = torch.relu(pre2) @ q.W3.T + q.b3
    lower = -A1 * (torch.exp(S1 * h64) - 1.0)
    if scale_nominal:
        f = (A2 * (1.0 - h64) - lower) * torch.sigmoid(f) + lower
    margin = (f - cone_project_mu(lower, f, 60)) - lower
    near = ((pre1.abs() < KINK_MARGIN).any(-1)
            | (pre2.abs() < KINK_MARGIN).any(-1)
            | (margin.abs() < ACTIVE_MARGIN).any(-1))
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(seed))
    g = g.to(h.device) * (~near)[:, None]
    return g, int(near.sum())


def _assert_k2_matches_plain(got, want):
    dh, dxc, dp = got
    rh, rxc, rp = want
    torch.testing.assert_close(dh, rh, atol=K2_TOL, rtol=0)
    torch.testing.assert_close(dxc, rxc, atol=K2_TOL, rtol=0)
    if dp is not None:
        for a, b in zip(dp, rp):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=K2_TOL * float(b.abs().max()))


def _assert_k2_matches_plain_and_repeats(h, xc, g, p, scale_nominal):
    want = rhs_vjp_reference(h, xc, g, p, A1, S1, A2, scale_nominal, 30)
    for weight_grads in (True, False):
        before = fused_rhs_vjp.launches
        got = fused_rhs_vjp(h, xc, g, p, A1, S1, A2, scale_nominal, 30,
                            weight_grads)
        assert fused_rhs_vjp.launches == before + 1
        assert (got[2] is None) != weight_grads
        _assert_k2_matches_plain(got, want)
        # no atomics: repeated launches are bit-identical
        again = fused_rhs_vjp(h, xc, g, p, A1, S1, A2, scale_nominal, 30,
                              weight_grads)
        for a, b in zip(got[:2] + tuple(got[2] or ()),
                        again[:2] + tuple(again[2] or ())):
            assert torch.equal(a, b)


@pytest.mark.parametrize("scale_nominal", [False, True])
@pytest.mark.parametrize("B,n,mlp", [(4096 + 17, 10, 128), (37, 10, 128),
                                     (100, 3, 16), (65, 32, 96),
                                     (300, 64, 128), (300, 100, 128)])
def test_fused_rhs_vjp_kernel_matches_plain(cuda, B, n, mlp, scale_nominal):
    h, xc, p = _rhs_inputs(B, n, mlp, B + n + 1, cuda)
    g, _ = _kink_free_cotangent(h, xc, p, B, scale_nominal)
    _assert_k2_matches_plain_and_repeats(h, xc, g, p, scale_nominal)


def test_fused_rhs_vjp_keeps_large_partials_in_device_memory(cuda):
    # n = 32, mlp = 160: the weight-gradient partials (144 KB) cannot sit
    # beside the packed weights (141 KB) in shared memory; each block adds
    # its tiles' products to its workspace slot in device memory, as at every
    # shape, in a fixed order; four warps' staging buffers fit, eight do not
    assert staged_warps(32, 160) == 4
    h, xc, p = _rhs_inputs(4096 + 65, 32, 160, 0, cuda)
    g, _ = _kink_free_cotangent(h, xc, p, 1)
    _assert_k2_matches_plain_and_repeats(h, xc, g, p, False)


def test_fused_rhs_refuses_weights_beyond_shared_memory(cuda):
    # n = 32, mlp = 224: the packed weights alone need 259072 bytes, more
    # than the 227 KB a block can have (nothing inside n <= 128, mlp <= 128,
    # the JAX kernel's domain, is refused: see the test below)
    h, xc, p = _rhs_inputs(65, 32, 224, 0, cuda)
    g = torch.randn(65, 32, device=cuda)
    before = (fused_rhs.launches, fused_rhs_vjp.launches)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_rhs(h, xc, p, A1, S1, A2, False, 30)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_rhs_vjp(h, xc, g, p, A1, S1, A2, False, 30, False)
    assert (fused_rhs.launches, fused_rhs_vjp.launches) == before


@pytest.mark.parametrize("scale_nominal", [False, True])
def test_fused_rhs_takes_the_widest_state_of_the_jax_kernel(cuda, scale_nominal):
    # n = 128, mlp = 128 fills the Pallas kernel's 128 lanes: 197632 bytes of
    # packed weights; with weight gradients K2 runs two warps a block
    assert staged_warps(128, 128) == 2
    h, xc, p = _rhs_inputs(150, 128, 128, 3, cuda)
    got = fused_rhs(h, xc, p, A1, S1, A2, scale_nominal, 30)
    want = rhs_reference(h, xc, p, A1, S1, A2, scale_nominal, 30)
    torch.testing.assert_close(got, want, atol=K1_TOL, rtol=0)
    g, _ = _kink_free_cotangent(h, xc, p, 4, scale_nominal)
    _assert_k2_matches_plain_and_repeats(h, xc, g, p, scale_nominal)


@pytest.mark.parametrize("scale_nominal", [False, True])
def test_fused_rhs_backward_launches_k2(cuda, scale_nominal):
    h, xc, p = _rhs_inputs(300, 10, 128, 7, cuda)
    g, _ = _kink_free_cotangent(h, xc, p, 8, scale_nominal)
    leaves = [t.clone().requires_grad_() for t in (h, xc, *p)]
    out = fused_rhs(leaves[0], leaves[1], RhsParams(*leaves[2:]), A1, S1, A2,
                    scale_nominal, 30)
    before = fused_rhs_vjp.launches
    grads = torch.autograd.grad(out, leaves, g)
    assert fused_rhs_vjp.launches == before + 1
    rh, rxc, rp = rhs_vjp_reference(h, xc, g, p, A1, S1, A2, scale_nominal,
                                    30)
    _assert_k2_matches_plain((grads[0], grads[1], grads[2:]), (rh, rxc, rp))


def test_fused_rhs_kernel_rejects_bad_layout(cuda):
    h, xc, p = _rhs_inputs(8, 10, 32, 0, cuda)
    with pytest.raises(ValueError, match="xc"):
        fused_rhs(h, xc.t().contiguous().t(), p, A1, S1, A2)
    with pytest.raises(ValueError, match="h"):
        fused_rhs(h.double(), xc, p, A1, S1, A2)


@pytest.mark.parametrize("ci,co,k,n,B", [
    # the flagship's four applies, then the transposed shapes its backward
    # gives K3 (here as forward layers), the MNIST KWLarge's applies, and
    # ragged and odd shapes of both transform paths
    (3, 32, 3, 32, 64), (128, 32, 2, 16, 64), (32, 64, 3, 16, 64),
    (256, 64, 2, 8, 64), (32, 3, 3, 32, 64), (32, 128, 2, 16, 64),
    (64, 32, 3, 16, 64), (64, 256, 2, 8, 64), (1, 32, 3, 28, 37),
    (128, 32, 2, 14, 37), (32, 64, 3, 14, 37), (256, 64, 2, 7, 37),
    (5, 3, 3, 8, 7), (6, 4, 2, 8, 1), (4, 8, 3, 16, 13), (3, 5, 3, 5, 9),
])
def test_fused_freq_apply_kernel_matches_plain(cuda, ci, co, k, n, B):
    x, Qr, Qi = _conv_inputs(ci, co, k, n, B, ci * co, cuda)
    before = fused_freq_apply.launches
    got = fused_freq_apply(x, Qr, Qi)
    assert fused_freq_apply.launches == before + 1
    want = apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")
    torch.testing.assert_close(got, want, atol=K3_TOL, rtol=0)
    again = fused_freq_apply(x, Qr, Qi)
    assert torch.equal(got, again)


@pytest.mark.parametrize("ci,co,k,n", [
    (3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16), (256, 64, 2, 8),
    (1, 32, 3, 28), (256, 64, 2, 7)])
def test_fused_freq_apply_backward_is_k3_on_q_herm(cuda, ci, co, k, n):
    # the backward applies the transposed shapes co -> ci, including
    # 32 -> 3 and 64 -> 256, which no forward layer gives K3
    x, Qr, Qi = _conv_inputs(ci, co, k, n, 64, ci + co, cuda)
    g = torch.randn(64, co, n, n, generator=torch.Generator().manual_seed(1))
    g = g.to(cuda)
    x.requires_grad_()
    y = fused_freq_apply(x, Qr, Qi)
    before = fused_freq_apply.launches
    (dx,) = torch.autograd.grad(y, x, g)
    assert fused_freq_apply.launches == before + 1
    xp = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(
        apply_freq_matrices(xp, torch.complex(Qr, Qi), impl="dft"), xp, g)
    torch.testing.assert_close(dx, want, atol=K3_TOL, rtol=0)


def test_fused_freq_apply_backward_in_q_is_the_plain_vjp(cuda):
    x, Qr, Qi = _conv_inputs(4, 8, 3, 8, 5, 2, cuda)
    g = torch.randn(5, 8, 8, 8, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (x, Qr, Qi)]
    got = torch.autograd.grad(fused_freq_apply(*leaves), leaves, g)
    ref = [t.clone().requires_grad_() for t in (x, Qr, Qi)]
    want = torch.autograd.grad(
        apply_freq_matrices(ref[0], torch.complex(ref[1], ref[2]),
                            impl="dft"), ref, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=K3_TOL * float(b.abs().max()),
                                   rtol=0)


def test_wrappers_reject_other_devices():
    h = torch.zeros(2, 10, device="meta")
    xc = torch.zeros(2, 32, device="meta")
    p = pack_rhs_params(*(torch.zeros(*s, device="meta")
                          for s in ((32, 10), (32, 32), (10, 32), (32,), (10,))))
    with pytest.raises(ValueError, match="device"):
        fused_rhs(h, xc, p, A1, S1, A2)
    with pytest.raises(ValueError, match="device"):
        fused_rhs_vjp(h, xc, h, p, A1, S1, A2)
    x = torch.zeros(1, 3, 8, 8, device="meta")
    Q = torch.zeros(40, 5, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_freq_apply(x, Q, Q)


def test_cpu_wrappers_take_the_plain_versions():
    h, xc, p = _rhs_inputs(5, 10, 32, 1, "cpu")
    before = fused_rhs.launches
    np.testing.assert_array_equal(
        fused_rhs(h, xc, p, A1, S1, A2, True).numpy(),
        rhs_reference(h, xc, p, A1, S1, A2, True).numpy())
    assert fused_rhs.launches == before
    x, Qr, Qi = _conv_inputs(3, 5, 3, 8, 2, 0, "cpu")
    before = fused_freq_apply.launches
    np.testing.assert_array_equal(
        fused_freq_apply(x, Qr, Qi).numpy(),
        apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft").numpy())
    assert fused_freq_apply.launches == before
