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
from fiode_tpu_torch.ops.fused_rhs import fused_rhs, pack_rhs_params, rhs_reference

A1, S1, A2 = 100.0, 0.02, 20.0
K1_TOL = 2e-4
K3_TOL = 1e-4


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
                                     (100, 3, 16), (65, 32, 160)])
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


def test_fused_rhs_kernel_has_no_backward(cuda):
    h, xc, p = _rhs_inputs(8, 10, 32, 0, cuda)
    h.requires_grad_()
    with pytest.raises(NotImplementedError, match="K2"):
        fused_rhs(h, xc, p, A1, S1, A2, False, 30).sum().backward()


def test_fused_rhs_kernel_rejects_bad_layout(cuda):
    h, xc, p = _rhs_inputs(8, 10, 32, 0, cuda)
    with pytest.raises(ValueError, match="xc"):
        fused_rhs(h, xc.t().contiguous().t(), p, A1, S1, A2)
    with pytest.raises(ValueError, match="h"):
        fused_rhs(h.double(), xc, p, A1, S1, A2)


@pytest.mark.parametrize("ci,co,k,n,B", [
    (3, 32, 3, 32, 64), (128, 32, 2, 16, 64), (32, 64, 3, 16, 64),
    (256, 64, 2, 8, 64), (5, 3, 3, 8, 7), (6, 4, 2, 8, 1), (4, 8, 3, 16, 13),
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


def test_fused_freq_apply_kernel_has_no_backward(cuda):
    x, Qr, Qi = _conv_inputs(3, 5, 3, 8, 2, 0, cuda)
    x.requires_grad_()
    with pytest.raises(NotImplementedError):
        fused_freq_apply(x, Qr, Qi).sum().backward()


def test_wrappers_reject_other_devices():
    h = torch.zeros(2, 10, device="meta")
    xc = torch.zeros(2, 32, device="meta")
    p = pack_rhs_params(*(torch.zeros(*s, device="meta")
                          for s in ((32, 10), (32, 32), (10, 32), (32,), (10,))))
    with pytest.raises(ValueError, match="device"):
        fused_rhs(h, xc, p, A1, S1, A2)
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
