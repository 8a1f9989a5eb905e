"""Kernel K4's plan on the CPU, and the rule that routes CROWN to it.

K4 (``csrc/fused_crown.cu``) runs only on the card.  What it does per row
is mirrored here in float64 numpy, stage by stage, and held to
``crown_mlp_bounds`` (whose CPU route is the plain chain) in float64:

  * layer 1's relaxation and its two stages, and the lists of neurons each
    of layer 2's products runs over (not off: S and s; unstable: D and d),
    made as the kernel makes them, a ballot over a row's 16 lanes per
    column;
  * layer 2's factored products over those lists, their concretisation as
    the products' epilogue, and the relaxation;
  * layer 3's bias terms summed over each lane's columns and then over the
    lanes, its two scaled products of W3 and |W3| with W2 over layer 2's
    lists, and the per-lane split against layer 1's slopes, its last
    product with W1 and the concretisation after the lanes' sum.

Change the kernel and this mirror together.  The route rule
(``fused_crown.route``) is held for each caller of ``crown_mlp_bounds`` on
the facts that caller presents, recorded on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from fiode_tpu_torch.ops import fused_crown
from fiode_tpu_torch.verify.crown import crown_mlp_bounds

LANES = fused_crown.LANES
PLAN_TOL = 1e-12  # float64 sums in two orders, over the bounds' magnitude


def _mlp(seed, n, m1, m2, out, rows):
    rng = np.random.default_rng(seed)
    Ws = [0.5 * rng.normal(size=(m1, n)),
          0.5 * rng.normal(size=(m2, m1)) / np.sqrt(m1),
          0.5 * rng.normal(size=(out, m2)) / np.sqrt(m2)]
    bs = [0.1 * rng.normal(size=(m,)) for m in (m1, m2, out)]
    x_bias = rng.normal(size=(rows, m1))
    eta = rng.uniform(size=(rows, n))
    eta /= eta.sum(-1, keepdims=True)
    eps_rows = rng.uniform(0.01, 0.08, size=(rows, n))
    alphas = [rng.uniform(-0.2, 1.2, size=(rows, m)) for m in (m1, m2)]
    return Ws, bs, x_bias, eta, eps_rows, alphas


def _relax(l, u, alpha=None):
    """K4's relax(): (a_up, b_up, a_lo) of relu on [l, u]."""
    unstable = (l < 0) & (u > 0)
    on = (l >= 0).astype(l.dtype)
    denom = np.where(unstable, u - l, 1.0)
    a_up = np.where(unstable, u / denom, on)
    b_up = np.where(unstable, (-u * l) / denom, 0.0)
    lo = (u >= -l).astype(l.dtype) if alpha is None else np.clip(alpha, 0, 1)
    return a_up, b_up, np.where(unstable, lo, on)


def _lists(member):
    """The kernel's append(): per row, the neurons i = t + 16 c with
    member[row, i], column by column, lanes in order within a column."""
    rows, mp = member.shape
    out = []
    for r in range(rows):
        lst = []
        for c in range(mp // LANES):
            bits = member[r, c * LANES:(c + 1) * LANES]
            lst.extend(c * LANES + t for t in range(LANES) if bits[t])
        out.append(lst)
    return out


def _pad(a, shape):
    z = np.zeros(shape)
    z[tuple(slice(0, s) for s in a.shape)] = a
    return z


def _concretise(L, c, sign, eta, eps):
    """L (rows, k, outs) and c (rows, outs) over the box: L eta + c +- r."""
    dot = np.einsum("rko,rk->ro", L, eta)
    rad = np.einsum("rko,rk->ro", np.abs(L), eps)
    return (dot + c) + sign * rad


def k4_plan(Ws, bs, eta, eps, x_bias, alphas=None):
    """K4's stages in float64: (lb, ub), each (rows, out)."""
    (W1, W2, W3), (b1, b2, b3) = Ws, bs
    rows, n = eta.shape
    m1, m2, out = W1.shape[0], W2.shape[0], W3.shape[0]
    m1p, m2p = (LANES * math.ceil(m / LANES) for m in (m1, m2))
    W1p, W2p, W3p = _pad(W1, (m1p, n)), _pad(W2, (m2p, m1p)), _pad(W3, (out, m2p))
    b1p, b2p = _pad(b1, (m1p,)), _pad(b2, (m2p,))
    xb = _pad(np.broadcast_to(x_bias, (rows, m1)), (rows, m1p))
    eps_r = np.broadcast_to(eps, (rows, n))
    a1 = a2 = None
    if alphas is not None:
        a1 = _pad(np.broadcast_to(alphas[0], (rows, m1)), (rows, m1p))
        a2 = _pad(np.broadcast_to(alphas[1], (rows, m2)), (rows, m2p))
    in1, in2 = np.arange(m1p) < m1, np.arange(m2p) < m2

    # layer 1: the stages and the lists
    z = (eta @ W1p.T + b1p) + xb
    rad = eps_r @ np.abs(W1p).T
    a_up, b_up, a_lo = _relax(z - rad, z + rad, a1)
    b1_row = b1p + xb
    u_vec, l_vec = a_up * b1_row + b_up, a_lo * b1_row
    asum, adiff = a_up + a_lo, a_up - a_lo
    spl, smn = u_vec + l_vec, u_vec - l_vec
    live1 = _lists(in1 & ((asum != 0) | (spl != 0)))
    unst1 = _lists(in1 & ((adiff != 0) | (smn != 0)))

    # layer 2: S, s over the live list, D, d over the unstable one
    S, D = np.zeros((rows, n, m2p)), np.zeros((rows, n, m2p))
    s, d = np.zeros((rows, m2p)), np.zeros((rows, m2p))
    for r in range(rows):
        for i in live1[r]:
            S[r] += np.outer(asum[r, i] * W1p[i], W2p[:, i])
            s[r] += spl[r, i] * W2p[:, i]
        for i in unst1[r]:
            D[r] += np.outer(adiff[r, i] * W1p[i], np.abs(W2p[:, i]))
            d[r] += smn[r, i] * np.abs(W2p[:, i])
    ub2 = _concretise(0.5 * (S + D), b2p + 0.5 * (s + d), 1.0, eta, eps_r)
    lb2 = _concretise(0.5 * (S - D), b2p + 0.5 * (s - d), -1.0, eta, eps_r)
    a_up2, b_up2, a_lo2 = _relax(lb2, ub2, a2)
    asum2, adiff2 = a_up2 + a_lo2, a_up2 - a_lo2
    live2 = _lists(in2 & (asum2 != 0))
    unst2 = _lists(in2 & (adiff2 != 0))

    # layer 3's bias terms: each lane over its columns o2 = t + 16 c, then
    # the lanes' sum
    wp, wn = np.maximum(W3p, 0), np.minimum(W3p, 0)
    pu = wp * b_up2[:, None] + (wp * a_up2[:, None] + wn * a_lo2[:, None]) * b2p
    pl = wn * b_up2[:, None] + (wp * a_lo2[:, None] + wn * a_up2[:, None]) * b2p
    lane = lambda v: v.reshape(*v.shape[:-1], -1, LANES).sum(-2)  # noqa: E731
    c3u, c3l = lane(pu).sum(-1), lane(pl).sum(-1)

    # layer 3: the two scaled products over layer 2's lists
    A, B = np.zeros((rows, out, m1p)), np.zeros((rows, out, m1p))
    for r in range(rows):
        for i in live2[r]:
            A[r] += np.outer(asum2[r, i] * W3p[:, i], W2p[i])
        for i in unst2[r]:
            B[r] += np.outer(adiff2[r, i] * np.abs(W3p[:, i]), W2p[i])
    vu, vl = 0.5 * (A + B), 0.5 * (A - B)
    up, un = np.maximum(vu, 0), np.minimum(vu, 0)
    lp, ln = np.maximum(vl, 0), np.minimum(vl, 0)
    au, al = a_up[:, None, :], a_lo[:, None, :]
    Lu, Ll = up * au + un * al, lp * al + ln * au
    cu = lane(up * b_up[:, None] + Lu * b1_row[:, None]).sum(-1)
    cl = lane(ln * b_up[:, None] + Ll * b1_row[:, None]).sum(-1)
    # each lane's part of the last product, then the lanes' sum
    fu = np.einsum("rojt,jtk->rok", Lu.reshape(rows, out, -1, LANES),
                   W1p.reshape(-1, LANES, n))
    fl = np.einsum("rojt,jtk->rok", Ll.reshape(rows, out, -1, LANES),
                   W1p.reshape(-1, LANES, n))
    ub = _concretise(fu.transpose(0, 2, 1), (b3 + c3u) + cu, 1.0, eta, eps_r)
    lb = _concretise(fl.transpose(0, 2, 1), (b3 + c3l) + cl, -1.0, eta, eps_r)
    return lb, ub


SHAPES = {"flagship": (10, 128, 128, 10), "small": (3, 16, 16, 3),
          "padded": (3, 20, 12, 3)}


@pytest.mark.parametrize("with_alphas", [False, True])
@pytest.mark.parametrize("eps_kind", ["scalar", "per_row"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_matches_crown_mlp_bounds(shape, eps_kind, with_alphas):
    n, m1, m2, out = SHAPES[shape]
    Ws, bs, x_bias, eta, eps_rows, alphas = _mlp(1, n, m1, m2, out, 48)
    eps = 1.0 / 40 if eps_kind == "scalar" else eps_rows
    alphas = alphas if with_alphas else None
    got = k4_plan(Ws, bs, eta, eps, x_bias, alphas)
    t = torch.from_numpy
    want = crown_mlp_bounds([t(W) for W in Ws], [t(b) for b in bs], t(eta),
                            eps if eps_kind == "scalar" else t(eps),
                            t(x_bias),
                            None if alphas is None else [t(a) for a in alphas])
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=PLAN_TOL * scale)


def test_plan_takes_one_shared_bias_row():
    n, m1, m2, out = SHAPES["flagship"]
    Ws, bs, x_bias, eta, _, _ = _mlp(2, n, m1, m2, out, 24)
    got = k4_plan(Ws, bs, eta, 1.0 / 40, x_bias[0])
    t = torch.from_numpy
    want = crown_mlp_bounds([t(W) for W in Ws], [t(b) for b in bs], t(eta),
                            1.0 / 40, t(x_bias[0]))
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=PLAN_TOL * scale)


def test_lists_run_in_increasing_order_and_skip_only_zeros():
    """A product over a row's list adds, in the dense loop's order, every
    neuron that adds anything to it."""
    rng = np.random.default_rng(3)
    member = rng.uniform(size=(5, 128)) < 0.4
    for r, lst in enumerate(_lists(member)):
        assert lst == sorted(lst)
        assert lst == np.flatnonzero(member[r]).tolist()


# -- the domain --------------------------------------------------------------


def test_every_certify_configuration_lies_in_the_domain():
    from fiode_tpu_torch.utils.config import compose
    for name in ("cifar_certify.yaml", "mnist_certify.yaml"):
        cfg = compose(name, config_dir="configs/certify")
        n, m = cfg["dataset"]["N_CLASSES"], cfg["module"]["dynamics"]["mlp_size"]
        fused_crown.check_domain(n, m, m, n)
        assert fused_crown.shared_memory_bytes(n, m, m, n) <= fused_crown.SMEM_LIMIT
        assert fused_crown.accumulators(n, m, m, n) <= fused_crown.MAX_ACCUMULATORS


@pytest.mark.parametrize("shape,why", [((12, 128, 128, 12), "registers"),
                                       ((10, 144, 144, 10), "registers"),
                                       ((3, 256, 256, 3), "shared memory")])
def test_shapes_outside_the_domain_are_refused(shape, why):
    with pytest.raises(ValueError, match=why):
        fused_crown.check_domain(*shape)


def test_shared_memory_grows_with_the_widths():
    """The layout's size: per row the stages, lists and etas; the weights
    once (W2 at the odd stride m1 + 1)."""
    base = fused_crown.shared_memory_bytes(10, 128, 128, 10)
    assert base == 186664
    assert fused_crown.shared_memory_bytes(10, 112, 128, 10) < base
    assert fused_crown.shared_memory_bytes(3, 16, 16, 3) < 32768


# -- the route ---------------------------------------------------------------


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


@pytest.fixture
def facts(monkeypatch):
    """Every call of ``crown_mlp_bounds`` records what ``route`` decides on
    the card: its facts with the device taken as CUDA."""
    seen = []
    takes = fused_crown.takes

    def spy(*args):
        seen.append(fused_crown.route("cuda", *fused_crown.facts(*args)[1:]))
        return takes(*args)

    monkeypatch.setattr(fused_crown, "takes", spy)
    return seen


def _images(seed, k):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(k, 1, 8, 8, generator=g)


def test_route_certifier_crown_block_takes_k4(facts):
    from fiode_tpu_torch.verify.certify import Certifier
    model = _tiny_classifier(0)
    cert = Certifier(model, T=4, eps_input=0.1, chunk=16)
    x = _images(0, 2)
    y = model.output_fn(model.solve(x).ys[-1]).argmax(-1)
    cert.certify(x, y, method="crown")
    assert facts and all(facts)


def test_route_alpha_crown_scores_take_k4_and_gradient_steps_do_not(facts):
    from fiode_tpu_torch.verify.certify import Certifier
    model = _tiny_classifier(1)
    cert = Certifier(model, T=4, eps_input=0.1, chunk=16, alpha_iters=2)
    x = _images(1, 1)
    y = model.output_fn(model.solve(x).ys[-1]).argmax(-1)
    cert.certify(x, y, method="crown")
    # per chunk: the start's score, then each of 2 iterations a gradient
    # step (plain) and its score, then the final bounds
    assert facts[:6] == [True, False, True, False, True, True]
    assert facts.count(False) == 2 * facts.count(True) // 4


def test_route_refinement_boxes_take_k4_but_their_gradient(facts):
    from fiode_tpu_torch.verify import refine
    from fiode_tpu_torch.verify.certify import Certifier
    model = _tiny_classifier(2)
    cert = Certifier(model, T=4, eps_input=0.1, chunk=16)
    x = _images(2, 1)
    cells = torch.from_numpy(cert.grid[:8])
    sweep_fn, step_fn = refine._kernels(cert, alpha_iters=1)
    with torch.no_grad():  # as refine_uncertified runs them
        img = refine._images(cert, x, [0])(0, 0)
        sweep_fn(cells, img)
        assert facts == [True]  # the base sweep, scalar eps
        facts.clear()
        step_fn(cells, torch.full_like(cells, cert.eps), img)
    # the split's gradient (plain), then alpha_val: start, 1 step (plain),
    # its score, the final per-row-eps bounds
    assert facts == [False, True, False, True, True]


def test_route_bench_certify_and_the_dry_run_take_k4(facts):
    from fiode_tpu_torch import bench_certify
    from fiode_tpu_torch.entry import _crown_chunk
    inp = bench_certify.inputs(0, "cpu", n_images=2, chunk=32)
    bench_certify.sweep(inp["Ws"], inp["bs"], inp["x_biases"],
                        inp["labels"], inp["eta"], n_inner=1)
    with torch.no_grad():
        _crown_chunk(inp["Ws"], inp["bs"], inp["eta"], inp["x_biases"][0])
    assert facts == [True, True]


def test_route_segway_controller_stays_plain(facts):
    from fiode_tpu_torch.control.certify_segway import vdot_cell_bounds
    from fiode_tpu_torch.control.systems import Segway
    g = torch.Generator().manual_seed(5)
    Ws = [torch.randn(32, 3, generator=g), torch.randn(1, 32, generator=g)]
    bs = [torch.randn(32, generator=g), torch.randn(1, generator=g)]
    cells = 0.1 * torch.randn(16, 3, generator=g)
    with torch.no_grad():
        vdot_cell_bounds(Segway(), Ws, bs, torch.eye(3), cells, 0.01)
    assert facts == [False]


@pytest.mark.parametrize("device,dtype,layers,n,m2,grad,want", [
    ("cuda", torch.float32, 3, 10, 128, False, True),
    ("cpu", torch.float32, 3, 10, 128, False, False),
    ("cuda", torch.float64, 3, 10, 128, False, False),
    ("cuda", torch.float32, 2, 3, 1, False, False),
    ("cuda", torch.float32, 4, 10, 128, False, False),
    ("cuda", torch.float32, 3, 10, 8, False, False),
    ("cuda", torch.float32, 3, 10, 128, True, False),
])
def test_route_rule(device, dtype, layers, n, m2, grad, want):
    assert fused_crown.route(device, dtype, layers, n, m2, grad) is want


def test_cpu_tensors_take_the_plain_chain(monkeypatch):
    """On the CPU ``crown_mlp_bounds`` never reaches the kernel's wrapper."""
    def boom(*a, **k):
        raise AssertionError("K4 on a CPU tensor")
    monkeypatch.setattr(fused_crown, "fused_crown_bounds", boom)
    n, m1, m2, out = SHAPES["small"]
    Ws, bs, x_bias, eta, _, _ = _mlp(6, n, m1, m2, out, 8)
    t = lambda a: torch.from_numpy(a).float()  # noqa: E731
    lb, ub = crown_mlp_bounds([t(W) for W in Ws], [t(b) for b in bs], t(eta),
                              0.05, t(x_bias))
    assert bool((lb <= ub).all())
