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
from fiode_tpu_torch.utils.tracing import counters


def _k1_k2():
    """K1's and K2's launches so far."""
    c = counters()
    return c.get("k1.launches", 0), c.get("k2.launches", 0)


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
    before = counters().get("k1.launches", 0)
    got = fused_rhs(h, xc, p, A1, S1, A2, scale_nominal, 30)
    assert counters().get("k1.launches", 0) == before + 1
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
        before = counters().get("k2.launches", 0)
        got = fused_rhs_vjp(h, xc, g, p, A1, S1, A2, scale_nominal, 30,
                            weight_grads)
        assert counters().get("k2.launches", 0) == before + 1
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
    before = _k1_k2()
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_rhs(h, xc, p, A1, S1, A2, False, 30)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_rhs_vjp(h, xc, g, p, A1, S1, A2, False, 30, False)
    assert _k1_k2() == before


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
    before = counters().get("k2.launches", 0)
    grads = torch.autograd.grad(out, leaves, g)
    assert counters().get("k2.launches", 0) == before + 1
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
    before = counters().get("k3.launches", 0)
    got = fused_freq_apply(x, Qr, Qi)
    assert counters().get("k3.launches", 0) == before + 1
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
        before = counters().get("k3.launches", 0)
        got = fused_freq_apply(x, Qr, Qi)
        assert counters().get("k3.launches", 0) == before + 1
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
    before = counters().get("k3.launches", 0)
    (dx,) = torch.autograd.grad(y, x, g)
    assert counters().get("k3.launches", 0) == before + 1
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
    before = counters().get("k1.launches", 0)
    got = fused_rhs(h, xc_rows, p, A1, S1, A2, False, 30)
    assert counters().get("k1.launches", 0) == before + 1
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
    before = counters().get("k1.launches", 0)
    got = Certifier(gpu_model, **kw).certify(x.to(cuda), y.to(cuda),
                                             method=method, early_exit=False)
    launched = counters().get("k1.launches", 0) - before
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
    before = counters().get("k1.launches", 0)
    np.testing.assert_array_equal(
        fused_rhs(h, xc, p, A1, S1, A2, True).numpy(),
        rhs_reference(h, xc, p, A1, S1, A2, True).numpy())
    assert counters().get("k1.launches", 0) == before
    x, Qr, Qi = _conv_inputs(3, 5, 3, 8, 2, 0, "cpu")
    before = counters().get("k3.launches", 0)
    np.testing.assert_array_equal(
        fused_freq_apply(x, Qr, Qi).numpy(),
        apply_freq_matrices(x, torch.complex(Qr, Qi), impl="dft").numpy())
    assert counters().get("k3.launches", 0) == before


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
        before = counters().get("k2.launches", 0)
        for _ in range(2):
            p = model.solve(x).ys[-1]
            loss = -torch.log(torch.take_along_dim(p, y[:, None], 1)).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        assert counters().get("k2.launches", 0) - before > 0
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
        before = counters().get("k3.launches", 0)
        ctx = (mock.patch.object(layers, "fused_freq_apply", plain_apply)
               if plain else contextlib.nullcontext())
        with ctx:
            tr._train_step(x, y, 0, mixer, 0.0, True)
        assert counters().get("k3.launches", 0) - before == (0 if plain else 7)
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
        before = _k1_k2()
        with ctx:
            sol = model.solve(xg, use_adjoint=True, adjoint_stats=stats)
            loss = -torch.log(torch.take_along_dim(sol.ys[-1], y[:, None], 1))
            loss.mean().backward()
        torch.cuda.synchronize()
        k1 = counters().get("k1.launches", 0) - before[0]
        k2 = counters().get("k2.launches", 0) - before[1]
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


# -- K4: CROWN's bounds of the ReLU dynamics ----------------------------------

K4_TOL = 1e-5  # max gap of lb and ub over the plain bounds' largest magnitude
# rows with a neuron whose float64 bounds lie this close (relative to u - l)
# to a jump of the relaxation are left out of the K4 checks: the lower slope
# 1[u >= -l] jumps at u = -l, and alpha-CROWN's slope at l = 0 and u = 0;
# there two correct float32 evaluations (the kernel's and cuBLAS's sum
# orders) may take different slopes, both sound
TIE_MARGIN = 1e-5


def _crown_inputs(N, n, m1, m2, out, seed, device):
    g = torch.Generator().manual_seed(seed)
    Ws = [0.5 * torch.randn(m1, n, generator=g),
          0.5 * torch.randn(m2, m1, generator=g) / m1 ** 0.5,
          0.5 * torch.randn(out, m2, generator=g) / m2 ** 0.5]
    bs = [0.1 * torch.randn(m, generator=g) for m in (m1, m2, out)]
    eta = torch.rand(N, n, generator=g)
    eta = eta / eta.sum(-1, keepdim=True)
    x_bias = torch.randn(N, m1, generator=g)
    eps_rows = 0.01 + 0.05 * torch.rand(N, n, generator=g)
    alphas = [1.4 * torch.rand(N, m, generator=g) - 0.2 for m in (m1, m2)]
    to = lambda t: t.to(device)  # noqa: E731
    return ([to(W) for W in Ws], [to(b) for b in bs], to(eta), to(x_bias),
            to(eps_rows), [to(a) for a in alphas])


def _near_jumps(Ws, bs, eta, eps, x_bias, alphas):
    """(N,) rows with a neuron of layer 1 or 2 near a jump of its
    relaxation, from the plain chain in float64."""
    from fiode_tpu_torch.verify.crown import _backward_from, relu_relaxation
    d = lambda t: t.double()  # noqa: E731
    Ws, bs = [d(W) for W in Ws], [d(b) for b in bs]
    eta, x_bias = d(eta), d(x_bias)
    eps = eps if not torch.is_tensor(eps) else d(eps)
    near = torch.zeros(eta.shape[0], dtype=torch.bool, device=eta.device)
    relax = []
    for j in (1, 2):
        l, u = _backward_from(j, Ws, bs, relax, eta, eps, x_bias)
        w = TIE_MARGIN * (u - l)
        jumps = (u + l).abs() < w
        if alphas is not None:
            jumps = jumps | (l.abs() < w) | (u.abs() < w)
        near |= ((l < w) & (u > -w) & jumps).any(-1)
        r = list(relu_relaxation(l, u))
        if alphas is not None:
            r[2] = torch.where((l < 0) & (u > 0),
                               d(alphas[j - 1]).clamp(0.0, 1.0), r[2])
        relax.append(tuple(r))
    return near


def _assert_k4_matches_plain(got, want, near):
    scale = max(float(w.abs().max()) for w in want)
    keep = ~near
    for g, w in zip(got, want):
        gap = float((g - w)[keep].abs().max()) / scale
        assert gap <= K4_TOL, gap
    assert int(near.sum()) <= max(4, near.numel() // 200)


@pytest.mark.parametrize("with_alphas", [False, True])
@pytest.mark.parametrize("eps_kind", ["scalar", "per_row"])
@pytest.mark.parametrize("N", [131072, 1000])
def test_fused_crown_matches_plain(cuda, N, eps_kind, with_alphas):
    """K4 against its plain version at a certify chunk's rows (16 images x
    8,192 cells) and at a ragged count, TF32 off."""
    from fiode_tpu_torch.verify.crown import (crown_bounds_reference,
                                              crown_mlp_bounds)
    Ws, bs, eta, x_bias, eps_rows, alphas = _crown_inputs(
        N, 10, 128, 128, 10, N + 7, cuda)
    eps = 1.0 / 40 if eps_kind == "scalar" else eps_rows
    alphas = alphas if with_alphas else None
    with torch.no_grad():
        before = counters().get("k4.launches", 0)
        got = crown_mlp_bounds(Ws, bs, eta, eps, x_bias, alphas)
        assert counters().get("k4.launches", 0) == before + 1
        want = crown_bounds_reference(Ws, bs, eta, eps, x_bias, alphas)
        again = crown_mlp_bounds(Ws, bs, eta, eps, x_bias, alphas)
    _assert_k4_matches_plain(got, want,
                             _near_jumps(Ws, bs, eta, eps, x_bias, alphas))
    # no atomics: repeated launches are bit-identical
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (3, 20, 12, 3),
                                   (3, 160, 16, 3)])
def test_fused_crown_takes_narrow_and_padded_widths(cuda, shape):
    """Narrow and padded widths, and a layer 1 wider than one pass of
    layer 3 (10 columns a lane: passes of 8 and 2)."""
    from fiode_tpu_torch.verify.crown import (crown_bounds_reference,
                                              crown_mlp_bounds)
    Ws, bs, eta, x_bias, eps_rows, alphas = _crown_inputs(1000, *shape, 11,
                                                          cuda)
    for eps, al in ((0.05, None), (eps_rows, alphas)):
        with torch.no_grad():
            before = counters().get("k4.launches", 0)
            got = crown_mlp_bounds(Ws, bs, eta, eps, x_bias, al)
            assert counters().get("k4.launches", 0) == before + 1
            want = crown_bounds_reference(Ws, bs, eta, eps, x_bias, al)
        _assert_k4_matches_plain(got, want,
                                 _near_jumps(Ws, bs, eta, eps, x_bias, al))


@pytest.mark.parametrize("live", [0, 64, 65, 128])
def test_fused_crown_passes_follow_the_live_list(cuda, live):
    """Rows whose layer-1 neurons are all off (no pass of layer 3), 64 on
    (a pass of 4 columns a lane), 65 (5) and all on (8), beside rows of the
    usual draws, with per-row eps and alpha-CROWN's slopes."""
    from fiode_tpu_torch.verify.crown import (crown_bounds_reference,
                                              crown_mlp_bounds)
    Ws, bs, eta, x_bias, eps_rows, alphas = _crown_inputs(
        4096, 10, 128, 128, 10, 40 + live, cuda)
    on = torch.zeros(128, dtype=torch.bool)
    g = torch.Generator().manual_seed(live)
    on[torch.randperm(128, generator=g)[:live]] = True
    x_bias[:2048] = torch.where(on, 50.0, -50.0).to(cuda)
    for eps, al in ((1.0 / 40, None), (eps_rows, alphas)):
        with torch.no_grad():
            got = crown_mlp_bounds(Ws, bs, eta, eps, x_bias, al)
            want = crown_bounds_reference(Ws, bs, eta, eps, x_bias, al)
        _assert_k4_matches_plain(got, want,
                                 _near_jumps(Ws, bs, eta, eps, x_bias, al))


def test_fused_crown_reads_one_shared_bias_row(cuda):
    """A (m1,) x_bias is read with row stride 0, as the plain path
    broadcasts it."""
    from fiode_tpu_torch.verify.crown import (crown_bounds_reference,
                                              crown_mlp_bounds)
    Ws, bs, eta, x_bias, _, _ = _crown_inputs(4096, 10, 128, 128, 10, 3, cuda)
    with torch.no_grad():
        got = crown_mlp_bounds(Ws, bs, eta, 1.0 / 40, x_bias[0])
        want = crown_bounds_reference(Ws, bs, eta, 1.0 / 40, x_bias[0])
    _assert_k4_matches_plain(got, want, _near_jumps(
        Ws, bs, eta, 1.0 / 40, x_bias[0].expand_as(x_bias), None))


def test_crown_takes_the_plain_chain_off_k4s_route(cuda):
    """A CPU tensor, a two-layer stack (the Segway controller) and a call
    that needs gradients never launch K4; the gradient one still carries
    its graph."""
    from fiode_tpu_torch.verify.crown import crown_mlp_bounds
    Ws, bs, eta, x_bias, _, alphas = _crown_inputs(256, 10, 128, 128, 10, 5,
                                                   cuda)
    before = counters().get("k4.launches", 0)
    cpu = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    with torch.no_grad():
        crown_mlp_bounds(cpu(Ws), cpu(bs), eta.cpu(), 0.025, x_bias.cpu())
        crown_mlp_bounds(Ws[:2], bs[:2], eta, 0.025, x_bias)
    leaves = [a.clone().requires_grad_() for a in alphas]
    lb, ub = crown_mlp_bounds(Ws, bs, eta, 0.025, x_bias, leaves)
    (ub - lb).sum().backward()
    assert all(a.grad is not None for a in leaves)
    assert counters().get("k4.launches", 0) == before


def test_fused_crown_refuses_shapes_beyond_its_domain(cuda):
    from fiode_tpu_torch.verify.crown import crown_mlp_bounds
    before = counters().get("k4.launches", 0)
    for shape in ((12, 128, 128, 12), (3, 256, 256, 3)):
        Ws, bs, eta, x_bias, _, _ = _crown_inputs(64, *shape, 1, cuda)
        with torch.no_grad(), pytest.raises(ValueError, match="fused_crown"):
            crown_mlp_bounds(Ws, bs, eta, 0.025, x_bias)
    assert counters().get("k4.launches", 0) == before


def test_crown_block_launches_k4_once_per_chunk(cuda):
    """The certifier's block of K chunks launches K4 K times, and the
    alpha-CROWN block launches it for every score and the final bounds."""
    from fiode_tpu_torch.verify.certify import Certifier
    model = _tiny_classifier(7).to(cuda)
    x = torch.rand(3, 1, 8, 8, generator=torch.Generator().manual_seed(8))
    x = x.to(cuda)
    with torch.no_grad():
        y = model.predict(x).argmax(-1)
    for alpha_iters, per_chunk in ((0, 1), (2, 4)):
        cert = Certifier(model, T=8, eps_input=0.1, chunk=64,
                         alpha_iters=alpha_iters)
        before = counters().get("k4.launches", 0)
        res = cert.certify(x, y, method="crown", early_exit=False)
        chunks = -(-1839 // 64)
        assert res.clean.all()
        assert counters().get("k4.launches", 0) - before == per_chunk * (
            -(-chunks // 16) * 16)


# -- K5: the interval QP of a CROWN chunk --------------------------------------
# The inputs (random boxes and the adversarial rows) and the tolerance (the
# bisection's terminal bracket plus the round-off of its row sums taken in
# two orders) are the CPU plan's: tests/test_torch_fused_qp_plan.py.


def _k5_inputs(N, n, seed, device):
    from test_torch_fused_qp_plan import boxes
    return [t.to(device) for t in boxes(N, n, seed)]


@pytest.mark.parametrize("N,n", [(131072, 10), (1000, 10), (777, 3),
                                 (513, 16)])
def test_fused_qp_matches_plain(cuda, N, n):
    """K5 against the plain chain at a certify chunk's rows (16 images x
    8,192 cells) and at ragged counts and other widths: random boxes on and
    around the simplex, every coordinate clamped (sum of the barriers 0),
    ties in nominal - lower, h at 0 and at 1, and the zero rows that pad a
    block's last chunk.  The clamped and tied rows, whose sums have one
    sign in any order, agree bit for bit."""
    from test_torch_fused_qp_plan import A1, A2, S1, qp_tolerance
    from fiode_tpu_torch.verify.ibp_qp import (ibp_cbf_qp_band,
                                               ibp_cbf_qp_band_reference)
    args = _k5_inputs(N, n, N + n, cuda)
    with torch.no_grad():
        before = counters().get("k5.launches", 0)
        got = ibp_cbf_qp_band(*args, A1, S1, A2)
        assert counters().get("k5.launches", 0) == before + 1
        want = ibp_cbf_qp_band_reference(*args, A1, S1, A2)
        again = ibp_cbf_qp_band(*args, A1, S1, A2)
        tol = qp_tolerance(*args, 30)
    q = max(N // 16, 1)
    exact = slice(N - 5 * q, N - 3 * q)
    for g, w, t in zip(got, want, tol):
        over = (g - w).abs() - t
        assert bool((over <= 0).all()), float(over.max())
        assert torch.equal(g[exact], w[exact])
    # no atomics: repeated launches are bit-identical
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_qp_keeps_nans_where_the_plain_chain_has_them(cuda):
    """A NaN in a raw bound makes every projection whose row holds it NaN,
    as torch.maximum, amin and amax propagate it; an infinite bound gives
    the plain chain's values."""
    from test_torch_fused_qp_plan import A1, A2, S1
    from fiode_tpu_torch.verify.ibp_qp import (ibp_cbf_qp_band,
                                               ibp_cbf_qp_band_reference)
    h_lb, h_ub, lb, ub = _k5_inputs(64, 10, 3, cuda)
    lb[0, 3] = float("nan")
    ub[1, 0] = float("nan")
    ub[2, 5] = float("inf")
    lb[3, 7] = float("-inf")
    with torch.no_grad():
        got = ibp_cbf_qp_band(h_lb, h_ub, lb, ub, A1, S1, A2)
        want = ibp_cbf_qp_band_reference(h_lb, h_ub, lb, ub, A1, S1, A2)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert int(torch.isnan(w).sum()) >= 10
        keep = ~torch.isnan(w)
        assert torch.equal(torch.isinf(g[keep]), torch.isinf(w[keep]))


def test_qp_takes_the_plain_chain_off_k5s_route(cuda):
    """The two-sided branch, the closed-form methods and a call that needs
    gradients never launch K5 and give the plain chain's bounds; the
    gradient one still carries its graph."""
    from test_torch_fused_qp_plan import A1, A2, S1
    from fiode_tpu_torch.verify.ibp_qp import (ibp_cbf_qp, ibp_cbf_qp_band,
                                               ibp_cbf_qp_band_reference)
    h_lb, h_ub, lb, ub = _k5_inputs(4096, 10, 4, cuda)
    before = counters().get("k5.launches", 0)
    with torch.no_grad():
        for kw in ({"with_upper": True}, {"method": "exact"},
                   {"method": "sort"}):
            got = ibp_cbf_qp_band(h_lb, h_ub, lb, ub, A1, S1, A2, **kw)
            want = ibp_cbf_qp_band_reference(h_lb, h_ub, lb, ub, A1, S1, A2,
                                             **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    centre = 0.5 * (h_lb + h_ub)
    eps = torch.full_like(centre, 1.0 / 40).requires_grad_()
    f_lb, f_ub = ibp_cbf_qp(centre, eps, lb, ub, A1, S1, A2)
    (g,) = torch.autograd.grad((f_ub - f_lb).sum(), eps)
    assert bool(torch.isfinite(g).all())
    assert counters().get("k5.launches", 0) == before


def test_crown_block_launches_k5_once_per_chunk(cuda):
    """The certifier's block of K chunks launches K5 K times, and the
    alpha-CROWN block launches it for every score and the final bounds (its
    gradient steps differentiate through the plain chain)."""
    from fiode_tpu_torch.verify.certify import Certifier
    model = _tiny_classifier(7).to(cuda)
    x = torch.rand(3, 1, 8, 8, generator=torch.Generator().manual_seed(8))
    x = x.to(cuda)
    with torch.no_grad():
        y = model.predict(x).argmax(-1)
    for alpha_iters, per_chunk in ((0, 1), (2, 4)):
        cert = Certifier(model, T=8, eps_input=0.1, chunk=64,
                         alpha_iters=alpha_iters)
        before = counters().get("k5.launches", 0)
        res = cert.certify(x, y, method="crown", early_exit=False)
        chunks = -(-1839 // 64)
        assert res.clean.all()
        assert counters().get("k5.launches", 0) - before == per_chunk * (
            -(-chunks // 16) * 16)
