"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed.  The kernel tests need a CUDA device and skip
without one; on a GPU machine run them with

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest.py sets up JAX).
"""
import contextlib

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


@pytest.mark.parametrize("n", [33, 48, 64, 100, 170])
@pytest.mark.parametrize("adjoint", [False, True])
def test_fused_freq_apply_kernel_takes_n_beyond_32(cuda, n, adjoint):
    # direct passes: several planes a block (33, 48), one (64, 100: the
    # opt-in shared memory past 48 KB from n = 78), and through device
    # memory (170); forward and transposed (Q^H through swapped strides)
    ci, co, B = 16, 8, 64 if n <= 64 else 3
    x, Qr, Qi = _conv_inputs(ci, co, 3, n, B, n, cuda)
    Q = torch.complex(Qr, Qi)
    if adjoint:
        from fiode_tpu_torch.ops.fused_cayley_conv import _launch
        g = torch.randn(B, co, n, n, generator=torch.Generator().manual_seed(n))
        x = g.to(cuda)
        got = _launch(x, Qr, Qi, adjoint=True)
        want = apply_freq_matrices(x, Q.conj().transpose(1, 2).resolve_conj(),
                                   impl="dft")
    else:
        before = fused_freq_apply.launches
        got = fused_freq_apply(x, Qr, Qi)
        assert fused_freq_apply.launches == before + 1
        want = apply_freq_matrices(x, Q, impl="dft")
    torch.testing.assert_close(got, want, atol=K3_TOL, rtol=0)


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


CERT_TOL = 1e-4  # per-image worst values of a certification block


def _tiny_classifier(seed):
    from fiode_tpu_torch.models.backbones import TinyMLPBackbone
    from fiode_tpu_torch.models.dynamics import SimplexDynamics
    from fiode_tpu_torch.models.ivp import NeuralODEClassifier
    g = torch.Generator().manual_seed(seed)
    return NeuralODEClassifier(
        TinyMLPBackbone(64, out_dim=10, hidden=32, mu=(0.5,), std=(0.25,),
                        generator=g),
        SimplexDynamics(n_hidden=10, mlp_size=128, x_dim=10, dropout=0.0,
                        generator=g),
        max_steps=64,
    ).eval()


def test_fused_rhs_at_a_certification_blocks_rows(cuda):
    """K1 on (16 images x 8192 cells) rows, each image's xc repeated for its
    cells and the states lattice points, as the Lipschitz sweep calls it."""
    from fiode_tpu_torch.verify.grid import enumerate_decision_boundary
    images, chunk, n, mlp = 16, 8192, 10, 128
    _, xc, p = _rhs_inputs(images, n, mlp, 5, cuda)
    grid = torch.from_numpy(enumerate_decision_boundary(n, 12)[:chunk]).to(cuda)
    assert len(grid) == chunk
    h = grid.repeat(images, 1)
    xc_rows = xc[:, None, :].expand(images, chunk, mlp).reshape(-1, mlp).contiguous()
    before = fused_rhs.launches
    got = fused_rhs(h, xc_rows, p, A1, S1, A2, False, 30)
    assert fused_rhs.launches == before + 1
    want = rhs_reference(h, xc_rows, p, A1, S1, A2, False, 30)
    torch.testing.assert_close(got, want, atol=K1_TOL, rtol=0)


@pytest.mark.parametrize("method", ["crown", "lipschitz"])
def test_certifier_on_cuda_equals_certifier_on_cpu(cuda, method):
    """The same sweep (n = 10, mlp = 128, T = 8: 1,839 cells in blocks of
    16 x 64, the last one padded) on the card, through K1 for the Lipschitz
    rows, and on the CPU."""
    from fiode_tpu_torch.verify.certify import Certifier
    import copy
    cpu_model = _tiny_classifier(3)
    x = torch.rand(6, 1, 8, 8, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        y = cpu_model.predict(x).argmax(-1)
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    kw = dict(T=8, eps_input=0.1, chunk=64)
    want = Certifier(cpu_model, **kw).certify(x, y, method=method,
                                              early_exit=False)
    before = fused_rhs.launches
    got = Certifier(gpu_model, **kw).certify(x.to(cuda), y.to(cuda),
                                             method=method, early_exit=False)
    launched = fused_rhs.launches - before
    assert got.clean.all() and want.clean.all()
    np.testing.assert_allclose(got.worst, want.worst, atol=CERT_TOL)
    if method == "lipschitz":
        np.testing.assert_allclose(got.worst_larger_T, want.worst_larger_T,
                                   atol=CERT_TOL)
        assert launched > 2 * 16  # two blocks of 16 chunks, and the clean solve
    assert got.cells_checked == want.cells_checked == 6 * 1839


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


def _train_state(model, opt):
    import copy
    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def test_k2_weight_gradients_under_adam_are_bit_stable(cuda):
    """The ode objective's path: K1 forward, K2 with weight gradients in the
    backward, two Adam steps; repeated from the same state, the weights are
    bit-identical (K2 sums its slots in a fixed order, no atomics)."""
    from fiode_tpu_torch.models.dynamics import SimplexDynamics
    from fiode_tpu_torch.models.ivp import NeuralODEClassifier
    g = torch.Generator().manual_seed(0)
    model = NeuralODEClassifier(None, SimplexDynamics(
        n_hidden=10, mlp_size=128, x_dim=10, scale_nominal=True,
        generator=g)).to(cuda)
    x = torch.randn(256, 10, generator=g).to(cuda)
    y = torch.randint(0, 10, (256,), generator=g).to(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    state = _train_state(model, opt)
    runs = []
    for _ in range(2):
        model.load_state_dict(state[0])
        opt.load_state_dict(state[1])
        before = fused_rhs_vjp.launches
        for _ in range(2):
            p = model.solve(x).ys[-1]
            loss = -torch.log(torch.take_along_dim(p, y[:, None], 1)).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        assert fused_rhs_vjp.launches - before > 0
        assert model.dynamics.mlp_to_mlp.weight.grad.abs().max() > 0
        runs.append([t.detach().clone() for t in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_lyapunov_step_through_kernels_matches_plain(cuda):
    """One Lyapunov train step of cifar_train.yaml's model (KWLarge, mlp 128)
    at B = 16, S = 32: K3 and K3 on Q^H against the plain dense DFT, from
    the same weights, optimizer state and draws.  Each gradient within 1e-3
    of its tensor's largest entry; each updated weight within 5% of the
    learning rate where its gradient is at least a tenth of the tensor's
    largest (a fresh Adam's first update lr g / (|g| + 1e-8) turns the
    round-off of a gradient near zero into a visible share of lr), and
    within 2 lr everywhere."""
    from pathlib import Path
    from unittest import mock

    from fiode_tpu_torch.experiment import build_trainer
    from fiode_tpu_torch.models import layers
    from fiode_tpu_torch.utils.config import compose

    def plain_apply(x, Qr, Qi):
        return apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft")

    cfg = compose("cifar_train.yaml",
                  ["++batch_size=16", "++module.h_sample_size=32",
                   "++synthetic_size=64", "++data_root=/nonexistent"],
                  config_dir=str(Path(__file__).resolve().parents[1]
                                 / "configs" / "classification"))
    tr = build_trainer(cfg, run_dir=str(Path(__file__).resolve().parents[1]
                                        / "build" / "test_lyapunov_step"),
                       device=cuda)
    tr.reset_optimizer(False)
    x, y = tr._train_x[:16], tr._train_y[:16]
    mixer = tr._epoch_mixer(12)  # both samplers own slots
    state = _train_state(tr.model, tr.opt) + (tr.gen.get_state(),)
    out = []
    for plain in (False, True):
        tr.model.load_state_dict(state[0])
        tr.opt.load_state_dict(state[1])
        tr.gen.set_state(state[2])
        before = fused_freq_apply.launches
        ctx = (mock.patch.object(layers, "fused_freq_apply", plain_apply)
               if plain else contextlib.nullcontext())
        with ctx:
            tr._train_step(x, y, 0, mixer, 0.0, True)
        assert fused_freq_apply.launches - before == (0 if plain else 7)
        out.append(({n: p.grad.clone() for n, p in tr.model.named_parameters()},
                    {n: p.detach().clone() for n, p in tr.model.named_parameters()}))
    (gk, pk), (gp, pp) = out
    lr = 5e-3
    for n in gp:
        scale = gp[n].abs().max().item()
        assert (gk[n] - gp[n]).abs().max().item() <= 1e-3 * max(scale, 1e-30), n
        sized = gp[n].abs() >= 0.1 * scale
        assert (pk[n] - pp[n])[sized].abs().max().item() <= 0.05 * lr, n
        assert (pk[n] - pp[n]).abs().max().item() <= 2 * lr, n


@pytest.mark.parametrize("weights", [False, True])
def test_adjoint_through_kernels_matches_the_plain_adjoint(cuda, weights):
    """solve(use_adjoint=True) with ReLU dynamics: the augmented RHS runs K1
    then K2 (with weight gradients only when the dynamics need them), once
    each per backward evaluation; its gradients equal those of the plain
    adjoint (rhs_reference and rhs_vjp_reference) within 5e-3 of the
    largest.  At t_max 0.1, the attack protocol's horizon: over t_max 1 the
    squashed dynamics contract so strongly that the backward solve cannot
    reconstruct y, and two correct float32 adjoints part."""
    from unittest import mock

    from fiode_tpu_torch.models import ivp

    def plain_vjp(h, xc, g, p, *consts, weight_grads=True):
        dh, dxc, dp = rhs_vjp_reference(h, xc, g, p, *consts)
        return dh, dxc, dp if weight_grads else None

    model = _tiny_classifier(5).to(cuda)
    model.dynamics.scale_nominal = True
    model.t_max = 0.1
    model.requires_grad_(weights)
    x = torch.rand(300, 1, 8, 8, generator=torch.Generator().manual_seed(6))
    x = x.to(cuda)
    y = torch.arange(300, device=cuda) % 10
    grads = []
    for plain in (False, True):
        ctx = (mock.patch.multiple(ivp, fused_rhs=rhs_reference,
                                   fused_rhs_vjp=plain_vjp)
               if plain else contextlib.nullcontext())
        model.zero_grad()
        xg = x.clone().requires_grad_()
        stats = {}
        before = (fused_rhs.launches, fused_rhs_vjp.launches)
        with ctx:
            sol = model.solve(xg, use_adjoint=True, adjoint_stats=stats)
            loss = -torch.log(torch.take_along_dim(sol.ys[-1], y[:, None], 1))
            loss.mean().backward()
        torch.cuda.synchronize()
        k1 = fused_rhs.launches - before[0]
        k2 = fused_rhs_vjp.launches - before[1]
        nb = stats["backward_nfe"]
        if plain:
            assert (k1, k2) == (0, 0)
        else:
            assert (k1, k2) == (sol.nfe + nb, nb) and nb > 0
        grads.append([xg.grad] + [p.grad for p in model.dynamics.parameters()
                                  if weights])
    for a, b in zip(*grads):
        assert a is not None and b is not None
        assert (a - b).abs().max() <= 5e-3 * b.abs().max()
