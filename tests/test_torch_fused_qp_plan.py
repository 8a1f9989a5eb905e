"""Kernel K5's plan on the CPU, the rule that routes the interval QP to it,
and its wrapper's refusals.

K5 (``csrc/fused_qp.cu``) runs only on the card.  What it does per cell is
mirrored here in float32 PyTorch, step by step, and held to
``ibp_cbf_qp_band`` (whose CPU route is the plain chain):

  * the barrier of h_lb and of h_ub, once each (2 n values a cell);
  * each of the 2 n projections' rows chosen from the cell's 4 n values
    by ``build_row``'s rule (lower bound of f_i: the others' nominal at ub
    and barrier at h_lb, i's at lb and h_ub; the upper bound the other way
    round);
  * the bracket, the halvings with the row sum taken over j in increasing
    order, and the diagonal.

The two differ only in the order of the row sums, so they are held to the
bisection's terminal bracket plus the round-off of those sums.  Change the
kernel and this mirror together.  The route rule (``fused_qp.route``) is
held for each caller of ``ibp_cbf_qp_band`` on the facts that caller
presents, recorded on the CPU.
"""
import pytest
import torch

from fiode_tpu_torch.ops import fused_qp
from fiode_tpu_torch.ops.simplex_qp import simplex_cone_project
from fiode_tpu_torch.verify.ibp_qp import (ibp_cbf_qp, ibp_cbf_qp_band,
                                           ibp_cbf_qp_band_reference,
                                           ibp_cbf_qp_individual)

A1, S1, A2 = 100.0, 0.02, 20.0
U32 = 2.0 ** -24  # float32 unit round-off


def _barrier(h):
    return -A1 * (torch.exp(S1 * h) - 1.0)


def _rows(h_lb, h_ub, lb, ub):
    """(N, 2 n, n) nominals and barriers of every projection of a cell, as
    the kernel's ``build_row`` picks them from the staged values."""
    N, n = h_lb.shape
    staged = torch.stack([_barrier(h_lb), _barrier(h_ub), lb, ub])  # (4, N, n)
    k = torch.arange(2 * n)[:, None]
    j = torch.arange(n)[None, :]
    up = k >= n
    self_ = j == torch.where(up, k - n, k)
    nom_w = torch.where(self_ != up, 2, 3)   # (2n, n): which staged input
    low_w = torch.where(self_ != up, 1, 0)
    pick = lambda w: staged[w, :, j.expand(2 * n, n)].permute(2, 0, 1)  # noqa: E731
    return pick(nom_w), pick(low_w)


def _plan(h_lb, h_ub, lb, ub, iters):
    """The kernel's steps on (N, n) float32 inputs: (f_lb, f_ub)."""
    n = h_lb.shape[1]
    nom, low = _rows(h_lb, h_ub, lb, ub)
    lo, hi = nom.amin(-1), (nom - low).amax(-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = torch.zeros_like(mid)
        for j in range(n):  # the kernel's order
            s = s + torch.maximum(nom[..., j] - mid, low[..., j])
        lo = torch.where(s > 0, mid, lo)
        hi = torch.where(s < 0, mid, hi)
    mu = 0.5 * (lo + hi)
    v = torch.maximum(nom - mu[..., None], low)
    diag = v[:, torch.arange(2 * n), torch.arange(2 * n) % n]  # (N, 2n)
    return diag[:, :n], diag[:, n:]


def qp_tolerance(h_lb, h_ub, lb, ub, iters):
    """(N, n) each side: what two correct float32 bisections of one row may
    part by.  Each ends within its terminal bracket of the point where its
    own computed sum crosses zero: (hi - lo) / 2^iters, or two float32
    spacings of the bracket's magnitude m where halving stalls.  Two sums
    of the n terms max(nominal_j - mu, lower_j) in other orders part by at
    most 2 (n - 1) u sum_j |term_j| (u the unit round-off), and move that
    point by no more: the sum falls by at least 1 per unit of mu where it
    crosses zero.  The terms there are the projected row.  The last
    subtraction rounds once more."""
    n = h_lb.shape[1]
    nom, low = _rows(h_lb, h_ub, lb, ub)
    lo, hi = nom.amin(-1), (nom - low).amax(-1)
    m = torch.maximum(lo.abs(), hi.abs())
    v = simplex_cone_project(low.reshape(-1, n), nom.reshape(-1, n),
                             iters).reshape(nom.shape)
    bracket = torch.maximum((hi - lo) * 2.0 ** -iters, 4 * U32 * m)
    diag = nom[:, torch.arange(2 * n), torch.arange(2 * n) % n].abs()
    tol = (2 * bracket + 2 * (n - 1) * U32 * v.abs().sum(-1)
           + 2 * U32 * (diag + m))
    return tol[:, :n], tol[:, n:]


def boxes(N, n, seed):
    """Random cells on and around the simplex (eps 1/40, some h below 0)
    with raw bounds of either sign, plus the adversarial rows: every
    coordinate clamped (h = 0 everywhere, so every barrier is 0 and the
    sum of the lower bounds is 0), ties in nominal - lower, h at 0 and at
    1, and the zero rows that pad a block's last chunk."""
    g = torch.Generator().manual_seed(seed)
    eta = torch.rand(N, n, generator=g)
    eta = eta / eta.sum(-1, keepdim=True)
    eta[: N // 8, : n // 2] = 0.0          # on the simplex's faces
    eps = 1.0 / 40
    h_lb, h_ub = eta - eps, eta + eps
    c = 5.0 * torch.randn(N, n, generator=g)
    w = 3.0 * torch.rand(N, n, generator=g)
    lb, ub = c - w, c + w
    q = max(N // 16, 1)
    r = N - 5 * q
    # every coordinate clamped: h = 0, so every barrier and their sum is 0
    h_lb[r:r + q] = h_ub[r:r + q] = 0.0
    # ties: equal nominal - lower across the row
    r += q
    h_lb[r:r + q] = h_ub[r:r + q] = 1.0 / n
    lb[r:r + q] = ub[r:r + q] = 0.25
    # h at 0 and at 1 (a vertex of the simplex)
    r += q
    h_lb[r:r + q], h_ub[r:r + q] = 0.0, 0.0
    h_ub[r:r + q, 0] = 1.0
    r += q
    h_lb[r:r + q] = 1.0
    h_ub[r:r + q] = 1.0
    # padding: zero etas (h = +-eps) and zero rows
    r += q
    h_lb[r:r + q // 2], h_ub[r:r + q // 2] = -eps, eps
    h_lb[r + q // 2:r + q] = h_ub[r + q // 2:r + q] = 0.0
    lb[r + q // 2:r + q] = ub[r + q // 2:r + q] = 0.0
    return h_lb, h_ub, lb, ub


@pytest.mark.parametrize("n,iters,seed", [(10, 30, 0), (10, 30, 1),
                                          (3, 30, 2), (10, 12, 3),
                                          (32, 30, 4)])
def test_plan_matches_the_plain_chain(n, iters, seed):
    h_lb, h_ub, lb, ub = boxes(512, n, seed)
    want = ibp_cbf_qp_band_reference(h_lb, h_ub, lb, ub, A1, S1, A2,
                                     qp_iters=iters)
    got = _plan(h_lb, h_ub, lb, ub, iters)
    for g, w, t in zip(got, want, qp_tolerance(h_lb, h_ub, lb, ub, iters)):
        assert bool(((g - w).abs() <= t).all()), float(((g - w).abs() - t).max())


def test_plan_rows_are_the_plain_chains_corners():
    """The rows the kernel builds are the plain chain's box corners, bit for
    bit (same barrier operations, same selections)."""
    n = 10
    h_lb, h_ub, lb, ub = boxes(64, n, 5)
    nom, low = _rows(h_lb, h_ub, lb, ub)
    eye = torch.eye(n, dtype=torch.bool)[None]
    h_for_lb = torch.where(eye, h_ub[:, None], h_lb[:, None])
    h_for_ub = torch.where(eye, h_lb[:, None], h_ub[:, None])
    assert torch.equal(low[:, :n], _barrier(h_for_lb))
    assert torch.equal(low[:, n:], _barrier(h_for_ub))
    assert torch.equal(nom[:, :n], torch.where(eye, lb[:, None], ub[:, None]))
    assert torch.equal(nom[:, n:], torch.where(eye, ub[:, None], lb[:, None]))


def test_plan_is_the_plain_chain_bit_for_bit_where_signs_agree():
    """Where every sum's sign is the same in any order, the plan and the
    plain chain agree bit for bit: the clamped rows (terms >= 0, zero only
    if all are) and the tied rows (n equal terms); elsewhere the tolerance
    stays under 1e-3 of the bounds."""
    h_lb, h_ub, lb, ub = boxes(512, 10, 6)
    want = ibp_cbf_qp_band_reference(h_lb, h_ub, lb, ub, A1, S1, A2)
    got = _plan(h_lb, h_ub, lb, ub, 30)
    exact = slice(512 - 5 * 32, 512 - 3 * 32)   # clamped, then tied
    for g, w in zip(got, want):
        assert torch.equal(g[exact], w[exact])
    for t, w in zip(qp_tolerance(h_lb, h_ub, lb, ub, 30), want):
        assert float(t.max()) < 1e-3 * max(float(w.abs().max()), 1.0)


def test_cpu_band_is_the_plain_chain_bit_for_bit(monkeypatch):
    """On the CPU ``ibp_cbf_qp_band`` never reaches K5's wrapper and returns
    the plain chain's bounds exactly."""
    def boom(*a, **k):
        raise AssertionError("K5 on a CPU tensor")
    monkeypatch.setattr(fused_qp, "fused_cone_qp_bounds", boom)
    h_lb, h_ub, lb, ub = boxes(256, 10, 7)
    for kw in ({}, {"with_upper": True}, {"method": "exact"},
               {"method": "sort"}, {"qp_iters": 12}):
        got = ibp_cbf_qp_band(h_lb, h_ub, lb, ub, A1, S1, A2, **kw)
        want = ibp_cbf_qp_band_reference(h_lb, h_ub, lb, ub, A1, S1, A2, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_gradient_calls_keep_their_graph():
    """A call whose box requires grad takes the plain chain and carries the
    projections' VJPs, on either device."""
    h_lb, h_ub, lb, ub = boxes(32, 10, 8)
    eps = torch.full_like(h_lb, 1.0 / 40).requires_grad_()
    centre = 0.5 * (h_lb + h_ub)
    assert not fused_qp.route("cuda", *fused_qp.facts(
        centre - eps, centre + eps, lb, ub, A1, S1)[1:])
    f_lb, f_ub = ibp_cbf_qp(centre, eps, lb, ub, A1, S1, A2)
    (g,) = torch.autograd.grad((f_ub - f_lb).sum(), eps)
    assert g.shape == eps.shape and bool(torch.isfinite(g).all())


# -- the route ---------------------------------------------------------------


_BASE = boxes(64, 10, 9)


def _case(**change):
    """One call's facts as the card would see them, with ``change`` applied
    to a chunk's (N, n) float32 contiguous inputs."""
    args = dict(zip(("h_lb", "h_ub", "lb", "ub"), _BASE), alpha_1=A1,
                sigma_1=S1, with_upper=False, method="bisect")
    args.update(change)
    return fused_qp.route("cuda", *fused_qp.facts(**args)[1:])


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"h_lb": _BASE[0].double(), "h_ub": _BASE[1].double(),
      "lb": _BASE[2].double(), "ub": _BASE[3].double()}, False),
    ({"lb": _BASE[2].double()}, False),
    ({"with_upper": True}, False),
    ({"method": "exact"}, False),
    ({"method": "sort"}, False),
    ({"lb": _BASE[2].t().contiguous().t()}, False),      # strided (64, 10)
    ({"ub": _BASE[3][:, :5]}, False),                      # another shape
    ({"h_lb": _BASE[0][None], "h_ub": _BASE[1][None], "lb": _BASE[2][None],
      "ub": _BASE[3][None]}, False),                       # not 2-D
    ({"alpha_1": torch.tensor(A1)}, False),               # not a number
    ({"ub": _BASE[3].clone().requires_grad_()}, False),   # grad to carry
], ids=["chunk", "float64", "mixed-dtype", "with-upper", "exact", "sort",
        "strided", "mis-shaped", "3-d", "tensor-constant", "grad"])
def test_route_rule(change, want):
    assert _case(**change) is want


def test_route_refuses_cpu_tensors_and_wide_states():
    h_lb, h_ub, lb, ub = boxes(8, 10, 10)
    assert not fused_qp.takes(h_lb, h_ub, lb, ub, A1, S1)
    wide = boxes(8, fused_qp.MAX_N + 1, 11)
    assert not fused_qp.route("cuda", *fused_qp.facts(*wide, A1, S1)[1:])
    narrow = boxes(8, fused_qp.MAX_N, 11)
    assert fused_qp.route("cuda", *fused_qp.facts(*narrow, A1, S1)[1:])


def test_route_takes_a_grad_free_call_in_grad_mode():
    """Grad mode alone does not send a call to the plain chain, nor an input
    that requires grad under no_grad: only the two together."""
    h_lb, h_ub, lb, ub = boxes(8, 10, 12)
    with torch.enable_grad():
        assert fused_qp.route("cuda", *fused_qp.facts(
            h_lb, h_ub, lb, ub, A1, S1)[1:])
    with torch.no_grad():
        assert fused_qp.route("cuda", *fused_qp.facts(
            h_lb, h_ub, lb, ub.clone().requires_grad_(), A1, S1)[1:])


@pytest.mark.parametrize("bad,match", [
    (lambda b: (b[0].double(), b[1], b[2], b[3]), "float32"),
    (lambda b: (b[0], b[1], b[2].t().contiguous().t(), b[3]), "float32"),
    (lambda b: (b[0], b[1], b[2], b[3][:, :4]), "one shape"),
    (lambda b: tuple(t[None] for t in b), r"\(N, n\)"),
    (lambda b: boxes(4, fused_qp.MAX_N + 1, 0), f"n <= {fused_qp.MAX_N}"),
    (lambda b: b, "device"),
], ids=["float64", "strided", "mis-shaped", "3-d", "wide", "cpu"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, match):
    args = bad(boxes(16, 10, 13))
    with pytest.raises(ValueError, match=match):
        fused_qp.fused_cone_qp_bounds(*args, A1, S1, 30)


def test_wrapper_raises_on_tensor_constants_grad_and_negative_iterations():
    b = boxes(16, 10, 14)
    with pytest.raises(ValueError, match="numbers"):
        fused_qp.fused_cone_qp_bounds(*b, torch.tensor(A1), S1, 30)
    with pytest.raises(ValueError, match="grad"):
        fused_qp.fused_cone_qp_bounds(b[0].clone().requires_grad_(), *b[1:],
                                      A1, S1, 30)
    with pytest.raises(ValueError, match="qp_iters"):
        fused_qp.fused_cone_qp_bounds(*b, A1, S1, -1)


@pytest.fixture
def facts(monkeypatch):
    """Every call of ``ibp_cbf_qp_band`` records what ``route`` decides on
    the card: its facts with the device taken as CUDA."""
    seen = []
    takes = fused_qp.takes

    def spy(*args):
        seen.append(fused_qp.route("cuda", *fused_qp.facts(*args)[1:]))
        return takes(*args)

    monkeypatch.setattr(fused_qp, "takes", spy)
    return seen


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


def _images(seed, k):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(k, 1, 8, 8, generator=g)


def test_route_certifier_crown_block_takes_k5(facts):
    from fiode_tpu_torch.verify.certify import Certifier
    model = _tiny_classifier(0)
    cert = Certifier(model, T=4, eps_input=0.1, chunk=16)
    x = _images(0, 2)
    y = model.output_fn(model.solve(x).ys[-1]).argmax(-1)
    cert.certify(x, y, method="crown")
    assert facts and all(facts)


def test_route_alpha_crown_scores_take_k5_and_gradient_steps_do_not(facts):
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


def test_route_refinement_sweeps_take_k5_but_their_gradient(facts):
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
    # the split's gradient (plain), then alpha_val, whose gradient step
    # differentiates the width surrogate and not the QP: the start's score,
    # the step's score, the final per-row-eps bounds
    assert facts == [False, True, True, True]


def test_route_a_certifier_crown_block_and_the_dry_run_take_k5(facts):
    from fiode_tpu_torch.entry import _crown_chunk
    from fiode_tpu_torch.verify.certify import Certifier, label_perms
    model = _tiny_classifier(3)
    cert = Certifier(model, T=4, eps_input=0.1, chunk=16)
    x, labels = _images(3, 2), torch.tensor([0, 1])
    eta = torch.from_numpy(cert.grid[:16])
    with torch.no_grad():  # one block of one chunk, as certify runs it
        x_biases = model.features(x) @ cert.U.T + cert.bU
        cert.crown_block(x_biases, labels, label_perms(labels, cert.n),
                         eta[None], torch.ones(1, 16, dtype=torch.bool),
                         torch.full((2,), float("-inf")))
        _crown_chunk(cert.Ws, cert.bs, eta, x_biases[0])
    assert facts == [True, True]


def test_route_two_sided_qp_stays_plain(facts):
    h_lb, h_ub, lb, ub = boxes(16, 10, 15)
    centre = 0.5 * (h_lb + h_ub)
    with torch.no_grad():
        ibp_cbf_qp_individual(centre, 1.0 / 40, lb, ub, A1, S1, A2)
        ibp_cbf_qp(centre, 1.0 / 40, lb, ub, A1, S1, A2, method="exact")
    assert facts == [False, False]
