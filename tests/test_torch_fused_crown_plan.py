"""Kernel K4's plan on the CPU, and the rule that routes CROWN to it.

K4 (``csrc/fused_crown.cu``) runs only on the card.  What it does per row
is mirrored here in float64 numpy, stage by stage, and held to
``crown_mlp_bounds`` (whose CPU route is the plain chain) in float64:

  * layer 1's relaxation and its stage, and the lists of neurons each of
    layer 2's products runs over (not off: S and s; unstable: D and d),
    made as the kernel makes them, a ballot over a row's 16 lanes per
    column;
  * layer 2's factored products over those lists, their concretisation as
    the products' epilogue, and the relaxation;
  * layer 3's bias terms summed over each lane's columns and then over the
    lanes by the kernel's halving steps;
  * layer 3 over layer 1's list of neurons not off, in passes: a warp's
    two rows take as many passes as the longer list needs, 16 entries a
    column and at most ``fused_crown.PASS`` columns a lane a pass (one pass
    up to m1 = 128); in each
    the two scaled products of W3 and |W3| with W2 over layer 2's lists,
    the per-lane split against layer 1's slopes, its bias terms and the
    product with W1, summed over the lanes into the row's slots; the
    concretisation from the slots.

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
PASS = fused_crown.PASS
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


def row_sums(parts):
    """The kernel's row_sums() over parts (..., 16 lanes, V): four halving
    steps over the lanes t and t ^ s (s = 8, 4, 2, 1).  Of each pair of
    values the lane whose bit s is clear keeps the first and its partner
    the second, and each adds the other's copy; an odd last value is added
    whole.  Returns (sums, ids, own), each (..., 16 lanes, R): lane t's
    q-th sum is that of value ids[t, q], written by the lane with own."""
    lanes, V = parts.shape[-2:]
    t = np.arange(lanes)
    v = parts
    ids = np.broadcast_to(np.arange(V), (lanes, V))
    own = np.ones((lanes, V), bool)
    for s in (8, 4, 2, 1):
        hi = (t & s) != 0
        partner = v[..., t ^ s, :]
        m = v.shape[-1]
        nv, nid, nown = [], [], []
        for q in range(m // 2):
            keep = np.where(hi, v[..., 2 * q + 1], v[..., 2 * q])
            got = np.where(hi, partner[..., 2 * q + 1], partner[..., 2 * q])
            nv.append(keep + got)
            nid.append(np.where(hi, ids[:, 2 * q + 1], ids[:, 2 * q]))
            nown.append(np.where(hi, own[:, 2 * q + 1], own[:, 2 * q]))
        if m % 2:
            nv.append(v[..., m - 1] + partner[..., m - 1])
            nid.append(ids[:, m - 1])
            nown.append(own[:, m - 1] & ~hi)
        v, ids, own = (np.stack(nv, -1), np.stack(nid, -1),
                       np.stack(nown, -1))
    return v, ids, own


def _gather(parts):
    """(..., V): each value's sum over the lanes, as its writing lane holds
    it after ``row_sums``."""
    sums, ids, own = row_sums(parts)
    out = np.zeros(parts.shape[:-2] + parts.shape[-1:])
    for t, q in zip(*np.nonzero(own)):
        out[..., ids[t, q]] = sums[..., t, q]
    return out


def passes(n1):
    """Per row, the layer-3 passes its warp takes, as (first column, columns
    a lane): those of the longer list of the row and its partner (rows 2 w
    and 2 w + 1; an odd last row alone), 16 entries a column, at most PASS
    columns a lane a pass, the last as wide as what is left."""
    n1 = np.asarray(n1)
    longer = np.maximum(n1, np.append(n1, 0)[np.arange(len(n1)) ^ 1])
    out = []
    for m in longer:
        cols = -(-int(m) // LANES)
        out.append([(g, min(PASS, cols - g)) for g in range(0, cols, PASS)])
    return out


def k4_plan(Ws, bs, eta, eps, x_bias, alphas=None, stats=None):
    """K4's stages in float64: (lb, ub), each (rows, out).  ``stats``, a
    dict, receives each row's count of layer-1 columns layer 3 ran over
    (``n1``) and its warp's passes (``passes``)."""
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

    # layer 1: the stage (a_up, a_lo, b_up, b1 + x_bias) and the lists; what
    # layer 2 takes of it is made from it at use
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
    # the lanes' halving sums
    wp, wn = np.maximum(W3p, 0), np.minimum(W3p, 0)
    pu = wp * b_up2[:, None] + (wp * a_up2[:, None] + wn * a_lo2[:, None]) * b2p
    pl = wn * b_up2[:, None] + (wp * a_lo2[:, None] + wn * a_up2[:, None]) * b2p
    lane = lambda v: v.reshape(*v.shape[:-1], -1, LANES).sum(-2)  # noqa: E731
    c3 = _gather(np.concatenate([lane(pu), lane(pl)], 1).transpose(0, 2, 1))

    # layer 3 over layer 1's list, in passes; the slots hold each side's
    # form over eta (n) and its constant, summed over lanes and passes
    n1 = [len(lst) for lst in live1]
    plan = passes(n1)
    slots = np.zeros((rows, 2 * out, n + 1))
    for r in range(rows):
        for g, pc in plan[r]:
            # lane t's columns: the list's entries 16 (g + c) + t
            pos = (LANES * (g + np.arange(pc))[None, :]
                   + np.arange(LANES)[:, None])
            valid = pos < n1[r]
            col = np.array(live1[r] + [0])[np.minimum(pos, n1[r])]
            A, B = np.zeros((out, LANES, pc)), np.zeros((out, LANES, pc))
            for i in live2[r]:
                A += asum2[r, i] * W3p[:, i][:, None, None] * W2p[i][col]
            for i in unst2[r]:
                B += (adiff2[r, i] * np.abs(W3p[:, i])[:, None, None]
                      * W2p[i][col])
            q = [np.where(valid, v[r][col], 0.0)
                 for v in (a_up, a_lo, b_up, b1_row)]
            vu, vl = 0.5 * (A + B), 0.5 * (A - B)
            up, un = np.maximum(vu, 0), np.minimum(vu, 0)
            lp, ln = np.maximum(vl, 0), np.minimum(vl, 0)
            Lu, Ll = up * q[0] + un * q[1], lp * q[1] + ln * q[0]
            cp = np.concatenate([(up * q[2] + Lu * q[3]).sum(-1),
                                 (ln * q[2] + Ll * q[3]).sum(-1)]).T
            slots[r, :, n] += _gather(cp)
            for k in range(n):
                w = W1p[col, k]
                f = np.concatenate([(Lu * w).sum(-1), (Ll * w).sum(-1)]).T
                slots[r, :, k] += _gather(f)
    if stats is not None:
        stats["n1"], stats["passes"] = np.array(n1), [len(p) for p in plan]
    fu, fl = slots[:, :out, :n], slots[:, out:, :n]
    ub = _concretise(fu.transpose(0, 2, 1),
                     (b3 + c3[:, :out]) + slots[:, :out, n], 1.0, eta, eps_r)
    lb = _concretise(fl.transpose(0, 2, 1),
                     (b3 + c3[:, out:]) + slots[:, out:, n], -1.0, eta, eps_r)
    return lb, ub


SHAPES = {"flagship": (10, 128, 128, 10), "small": (3, 16, 16, 3),
          "padded": (3, 20, 12, 3), "wide": (3, 160, 16, 3)}


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


def _forced(seed, live, shape="flagship", rows=8):
    """Draws whose rows 0 and 1 have exactly ``live`` layer-1 neurons on
    (stable, by a bias far above the box) and the rest off (far below it);
    the other rows are the usual draws."""
    n, m1, m2, out = SHAPES[shape]
    Ws, bs, x_bias, eta, eps_rows, alphas = _mlp(seed, n, m1, m2, out, rows)
    on = np.zeros(m1, bool)
    on[np.random.default_rng(seed).permutation(m1)[:live]] = True
    x_bias[:2] = np.where(on, 50.0, -50.0)
    return Ws, bs, x_bias, eta, eps_rows, alphas


@pytest.mark.parametrize("variant", ["scalar", "per_row", "alpha",
                                     "per_row_alpha"])
@pytest.mark.parametrize("shape,live,widths", [
    ("flagship", 0, []), ("flagship", 64, [4]), ("flagship", 65, [5]),
    ("flagship", 128, [8]), ("wide", 160, [8, 2]), ("wide", 129, [8, 1])])
def test_plan_passes_follow_the_live_list(shape, live, widths, variant):
    """A warp whose rows have no live layer-1 neuron takes no pass of
    layer 3; up to m1 = 128 one pass as wide as the longer list needs (64
    live neurons: 4 columns a lane, 65: 5, all: 8); past 8 columns a lane a
    second one; the bounds are crown_mlp_bounds' in every variant."""
    Ws, bs, x_bias, eta, eps_rows, alphas = _forced(7 + live, live, shape)
    eps = eps_rows if variant.startswith("per_row") else 1.0 / 40
    alphas = alphas if variant.endswith("alpha") else None
    stats = {}
    got = k4_plan(Ws, bs, eta, eps, x_bias, alphas, stats)
    assert stats["n1"][:2].tolist() == [live, live]
    assert stats["passes"][:2] == [len(widths)] * 2
    assert [pc for _, pc in passes(stats["n1"])[0]] == widths
    t = torch.from_numpy
    want = crown_mlp_bounds([t(W) for W in Ws], [t(b) for b in bs], t(eta),
                            eps if not isinstance(eps, np.ndarray) else t(eps),
                            t(x_bias),
                            None if alphas is None else [t(a) for a in alphas])
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=PLAN_TOL * scale)


def test_plan_shares_of_layer3_columns_match_the_plain_relaxation():
    """The counts of layer-1 columns that chip_smoke.py reports from the
    plain chain's layer-1 bounds (``fused_crown.layer3_columns``) are the
    plan's on the same draws; at the flagship every warp takes one pass."""
    from fiode_tpu_torch.verify.crown import _backward_from
    n, m1, m2, out = SHAPES["flagship"]
    Ws, bs, x_bias, eta, eps_rows, _ = _mlp(11, n, m1, m2, out, 64)
    t = torch.from_numpy
    for eps in (1.0 / 40, eps_rows):
        stats = {}
        k4_plan(Ws, bs, eta, eps, x_bias, None, stats)
        box = eps if np.isscalar(eps) else t(eps)
        l1, u1 = _backward_from(1, [t(W) for W in Ws], [t(b) for b in bs],
                                [], t(eta), box, t(x_bias))
        counts = fused_crown.layer3_columns(l1, u1).numpy()
        np.testing.assert_array_equal(counts, stats["n1"])
        share = counts.mean() / m1
        wider = np.mean(counts > 64)  # rows whose list takes over 4 columns
        assert 0.2 < share < 0.9 and 0.0 <= wider <= 1.0
        assert stats["passes"] == [1] * len(counts)


def test_row_sums_are_the_butterfly_bit_for_bit():
    """The kernel's halving sums over 16 lanes give, in float32, each
    value's butterfly sum exactly, in about one exchange a value."""
    rng = np.random.default_rng(4)
    for V in (20, 7, 2, 32):
        parts = rng.normal(size=(3, LANES, V)).astype(np.float32)
        fly = parts.copy()
        for s in (8, 4, 2, 1):
            fly = fly + fly[:, np.arange(LANES) ^ s]
        sums, ids, own = row_sums(parts)
        assert sums.dtype == np.float32
        for t in range(LANES):
            for q in range(ids.shape[1]):
                np.testing.assert_array_equal(sums[:, t, q],
                                              fly[:, t, ids[t, q]])
        # each value written by exactly one lane
        written = np.zeros(V, int)
        for t, q in zip(*np.nonzero(own)):
            written[ids[t, q]] += 1
        assert written.tolist() == [1] * V


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
    """The layout's size: per row the stages, slots, lists and etas; the
    weights once (W2 at the odd stride m1 + 1); 16 rows a block."""
    base = fused_crown.shared_memory_bytes(10, 128, 128, 10)
    assert base == 161832
    assert fused_crown.rows(10, 128, 128, 10) == 16
    assert fused_crown.shared_memory_bytes(10, 112, 128, 10) < base
    assert fused_crown.shared_memory_bytes(3, 16, 16, 3) < 32768


def _seed_accepts(n, m1, m2, out):
    """The domain K4 had with layer 3 over all of m1 (two float4 stages a
    layer-1 neuron, no slots): its shared memory and sums."""
    cols = lambda m: -(-m // LANES)  # noqa: E731
    m1p, m2p = LANES * cols(m1), LANES * cols(m2)
    s1 = -(-n // 4) * 4
    s1 += 4 * (s1 // 4 % 2 == 0)
    s3 = -(-out // 4) * 4
    per_row = (4 * max(m1p, m2p) + 4 * m1p + 2 * m2p + (m1p + m2p) + 4
               + 2 * n + 2 * out)
    floats = (16 * per_row + 2 * m2p * s3 + m1p * s1 + m2p * (m1p + 1)
              + m1p + m2p + out)
    acc = max((2 * n + 2) * cols(m2), 2 * out * cols(m1))
    return 4 * floats <= fused_crown.SMEM_LIMIT and acc <= 176


@pytest.mark.parametrize("n", range(1, 17))
def test_the_domain_keeps_every_shape_it_took(n):
    """Every (n, m1, m2, out) with m1, m2 in 16-128 and out <= 16 that K4
    took before it ran layer 3 over the live list is still taken, with its
    block and sums inside the limits."""
    widths = [16, 20, 33, 48, 64, 80, 96, 100, 112, 127, 128]
    for m1 in widths:
        for m2 in widths:
            for out in range(1, 17):
                if not _seed_accepts(n, m1, m2, out):
                    continue
                fused_crown.check_domain(n, m1, m2, out)
                assert (fused_crown.shared_memory_bytes(n, m1, m2, out)
                        <= fused_crown.SMEM_LIMIT)
                assert (fused_crown.accumulators(n, m1, m2, out)
                        <= fused_crown.MAX_ACCUMULATORS)


def test_a_shape_refused_for_shared_memory_is_refused_before_any_build(
        monkeypatch):
    from fiode_tpu_torch.ops import _build
    assert not _seed_accepts(3, 256, 256, 3)

    def boom(*a, **k):
        raise AssertionError("built a shape outside the domain")
    monkeypatch.setattr(fused_crown, "load_library", boom)
    monkeypatch.setattr(_build, "load_library", boom)
    with pytest.raises(ValueError, match="shared memory"):
        fused_crown.build(3, 256, 256, 3)


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


def test_route_a_certifier_crown_block_and_the_dry_run_take_k4(facts):
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
