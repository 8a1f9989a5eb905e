"""What the CUDA kernels K1 and K2 (``csrc/fused_rhs.cu``) do with the packed
weights, mirrored in numpy and held against the JAX package.

The kernels cannot run without a GPU, so this file follows their index
arithmetic step by step: the packed shared-memory image (``pack_weights``:
padding, row strides, the XOR swizzle), the two ways a lane reads a B
fragment from it, the order of K inside an 8-column step (k-slot t stands
for column 2t, slot t + 4 for column 2t + 1, which is what lets one
product's accumulator be the next one's A operand), the 3xTF32 split, the
staging buffers of the weight-gradient products, and the bisection summed
quad-wise.  Change the kernel and this file together.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiode_tpu_torch.ops.fused_rhs import (
    SMEM_LIMIT,
    pack_layout,
    pack_rhs_params,
    pack_weights,
    shared_memory_bytes,
    staged_warps,
)
from fiode_tpu_torch.ops.simplex_qp import cone_project_mu

jf = importlib.import_module("fiode_tpu.ops.fused_rhs")

A1, S1, A2 = 100.0, 0.02, 20.0
# tests/test_torch_fused_rhs.py's tolerance: torch's and XLA's exp may differ
# by an ulp of 1 (2**-23), which A1 = 100 scales to 1.2e-5 on a lower-active
# output; the 3xTF32 products add ~2**-21 relative on sums of size ~1
TOL_RHS = 2 * A1 * 2.0**-23
# tests/test_torch_fused_rhs_grad.py's tolerance (the JAX package's own for K2)
TOL_GRAD = 1e-4
GROUP = 2   # k-steps the tensor cores sum before the rounded fp32 add
CHUNK = 8   # tiles of z2 / d pre1 made and consumed at a time


def _weights(n, m, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (0.3 * rng.normal(size=(m, n)),
                           0.3 * rng.normal(size=(m, m)),
                           0.3 * rng.normal(size=(n, m)),
                           0.1 * rng.normal(size=m), 0.1 * rng.normal(size=n))))


def _rows(B, n, m, seed):
    rng = np.random.default_rng(seed + 100)
    h = rng.uniform(size=(B, n))
    h = h / h.sum(-1, keepdims=True)
    return (h.astype(np.float32),
            (0.5 * rng.normal(size=(B, m))).astype(np.float32),
            rng.normal(size=(B, n)).astype(np.float32))


def _pack(w):
    return pack_weights(*(torch.from_numpy(a) for a in w)).numpy()


def _swz(row):
    return ((row & 3) ^ ((row >> 2) & 1)) << 3


# -- (a) the packed image ---------------------------------------------------

@pytest.mark.parametrize("m", [16, 96, 128])
@pytest.mark.parametrize("n", [3, 10, 32, 100])
def test_packed_image_unpacks_to_the_weights(n, m):
    w = _weights(n, m, n + m)
    lay = pack_layout(n, m)
    buf = _pack(w)
    assert buf.dtype == np.float32 and buf.shape == (lay.floats,)
    assert (lay.mt, lay.nt) == (-(-m // 8), -(-n // 8))
    assert lay.s1 % 32 == 0 and lay.s2 % 32 == 0 and lay.floats % 4 == 0
    seen = np.zeros(lay.floats, bool)
    for W, off, rows, stride in ((w[0], 0, lay.mp, lay.s1),
                                 (w[1], lay.off_w2, lay.mp, lay.s2),
                                 (w[2], lay.off_w3, lay.np, lay.s2)):
        r = np.arange(rows)[:, None]
        c = np.arange(stride)[None, :]
        at = off + r * stride + (c ^ _swz(r))  # where element (r, c) lies
        assert np.unique(at).size == rows * stride  # a bijection per matrix
        full = np.zeros((rows, stride), np.float32)
        full[:W.shape[0], :W.shape[1]] = W
        np.testing.assert_array_equal(buf[at], full)  # exact, padding zero
        seen[at.ravel()] = True
    np.testing.assert_array_equal(buf[lay.off_b2:lay.off_b2 + m], w[3])
    np.testing.assert_array_equal(buf[lay.off_b3:lay.off_b3 + n], w[4])
    assert not buf[lay.off_b2 + m:lay.off_b3].any()
    assert not buf[lay.off_b3 + n:].any()
    seen[lay.off_b2:] = True
    assert seen.all()


def test_pack_rhs_params_stays_a_five_tuple():
    w = [torch.from_numpy(a) for a in _weights(10, 24, 0)]
    p = pack_rhs_params(*w)
    assert len(p) == 5 and p.packed is None  # packed on a CUDA device only
    assert [tuple(t.shape) for t in p] == [(24, 10), (24, 24), (10, 24),
                                           (24,), (10,)]
    p.packed = pack_weights(*p)
    assert len(p) == 5 and len(tuple(p)) == 5
    assert type(p)(*p).packed is None  # a copy derives its own


# -- the fragment reads -----------------------------------------------------

def _tf32(x):
    """x rounded to TF32 as the kernel does it: add half an ulp of the 10-bit
    mantissa to the bits and clear the low 13 (nearest, ties away)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """x = big + small; the tensor cores ignore small's low 13 bits."""
    big = _tf32(x)
    small = (np.asarray(x, np.float32) - big).view(np.uint32)
    return big, (small & np.uint32(0xFFFFE000)).view(np.float32)


def _mma3(a, b):
    """One 3xTF32 product of an (R, 8) A tile in slot order by an (8, 8) B
    tile (slot, column): small terms first, small by small dropped."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _slot_columns(s):
    """Columns of k-step s in slot order: slot t is column 2t, slot t + 4
    column 2t + 1."""
    t = np.arange(4)
    return np.concatenate([8 * s + 2 * t, 8 * s + 2 * t + 1])


def _b_tile(buf, off, stride, j, s, transposed):
    """The (slot, column g) B tile of result tile j, k-step s, each entry
    fetched where the kernel's lane (g, t) fetches it."""
    tile = np.empty((8, 8), np.float32)
    for g in range(8):
        for t in range(4):
            if not transposed:  # W[8 j + g][8 s + 2 t], [.. + 1]: one float2
                at = (off + 8 * j * stride + 32 * (s >> 2) + g * stride
                      + ((8 * (s & 3) + 2 * t) ^ _swz(g)))
                assert at % 2 == 0  # 8-byte aligned
                tile[t, g], tile[t + 4, g] = buf[at], buf[at + 1]
            else:  # W[8 s + 2 t][8 j + g] and W[8 s + 2 t + 1][8 j + g]
                base = off + 8 * s * stride + 32 * (j >> 2)
                tile[t, g] = buf[base + 2 * t * stride
                                 + ((8 * (j & 3) + g) ^ _swz(2 * t))]
                tile[t + 4, g] = buf[base + (2 * t + 1) * stride
                                     + ((8 * (j & 3) + g) ^ _swz(2 * t + 1))]
    return tile


def _product(acc, a, buf, off, stride, k0, transposed):
    """acc (R, 8 J) += a (R, 8 KS) by the weight at off, k-steps k0 .. of it,
    as the kernel's ``product`` orders the sums."""
    ks, tiles = a.shape[1] // 8, acc.shape[1] // 8
    for s0 in range(0, ks, GROUP):
        for j in range(tiles):
            part = np.zeros((a.shape[0], 8), np.float32)
            for s in range(s0, min(s0 + GROUP, ks)):
                part += _mma3(a[:, _slot_columns(s)],
                              _b_tile(buf, off, stride, j, k0 + s, transposed))
            acc[:, 8 * j:8 * j + 8] += part
    return acc


def _pad(a, width):
    out = np.zeros((a.shape[0], width), np.float32)
    out[:, :a.shape[1]] = a
    return out


def _mirror_forward(h, xc, buf, lay):
    """z1, z2 and f~ (padded widths) as K1 computes them."""
    z1 = _product(_pad(xc, lay.mp), _pad(h, lay.np), buf, 0, lay.s1, 0, False)
    z1 = np.maximum(z1, 0)
    ft = np.tile(buf[lay.off_b3:lay.off_b3 + lay.np], (h.shape[0], 1))
    z2 = np.zeros_like(z1)
    for c0 in range(0, lay.mt, CHUNK):
        c1 = min(c0 + CHUNK, lay.mt)
        z = np.tile(buf[lay.off_b2 + 8 * c0:lay.off_b2 + 8 * c1],
                    (h.shape[0], 1))
        # tiles c0 .. c1 of z2: the weight's rows 8 c0 .. are its result tiles
        _product(z, z1, buf, lay.off_w2 + 8 * c0 * lay.s2, lay.s2, 0, False)
        z = np.maximum(z, 0)
        z2[:, 8 * c0:8 * c1] = z
        _product(ft, z, buf, lay.off_w3, lay.s2, c0, False)
    return z1, z2, ft


def _quad_mu(lower, nom, n, iters=30):
    """The bisection as a quad of lanes runs it: lane t sums its columns
    8 j + 2 t, 8 j + 2 t + 1 in order, two butterfly adds join the quad."""
    f32 = np.float32
    B, width = nom.shape
    valid = np.arange(width) < n
    nomv = np.where(valid, nom, -np.inf).astype(f32)
    lowv = np.where(valid, lower, 0).astype(f32)
    lo = np.where(valid, nom, np.inf).min(-1).astype(f32)
    hi = np.where(valid, nom - lower, -np.inf).max(-1).astype(f32)
    cols = [[8 * j + 2 * t + e for j in range(width // 8) for e in (0, 1)]
            for t in range(4)]
    with np.errstate(invalid="ignore"):
        for _ in range(iters):
            mid = f32(0.5) * (lo + hi)
            part = []
            for t in range(4):
                s = np.zeros(B, f32)
                for c in cols[t]:
                    s = s + np.maximum(nomv[:, c] - mid, lowv[:, c])
                part.append(s)
            s = (part[0] + part[1]) + (part[2] + part[3])
            lo = np.where(s > 0, mid, lo)
            hi = np.where(s < 0, mid, hi)
    return f32(0.5) * (lo + hi)


def _exp(x):
    """float32 exp, correctly rounded (numpy's own float32 exp may be an ulp
    off, which alpha_1 = 100 scales to 1.2e-5 of the barrier)."""
    return np.exp(np.asarray(x, np.float32).astype(np.float64)).astype(np.float32)


def _barrier(hp):
    return np.float32(-A1) * (_exp(np.float32(S1) * hp) - np.float32(1))


def _mirror_k1(h, xc, buf, lay, n, scale_nominal):
    _, _, ft = _mirror_forward(h, xc, buf, lay)
    hp = _pad(h, lay.np)
    lower = _barrier(hp)
    nom = ft
    if scale_nominal:
        up = np.float32(A2) * (1 - hp)
        nom = (up - lower) * (1 / (1 + _exp(-ft))) + lower
    mu = _quad_mu(lower, nom, n)
    return np.maximum(nom - mu[:, None], lower)[:, :n], (lower, nom, mu, ft)


def _jax_padded(h, xc, w):
    p = jf.pack_rhs_params(*(jnp.asarray(a) for a in w))
    pad = lambda v: jnp.zeros((v.shape[0], jf.LANE)).at[:, :v.shape[1]].set(v)  # noqa: E731
    return pad(h), pad(xc), p


# -- (b) the forward's three products ----------------------------------------

@pytest.mark.parametrize("s", range(3))
def test_slot_order_is_a_bijection_of_each_step(s):
    assert sorted(_slot_columns(s)) == list(range(8 * s, 8 * s + 8))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n,m", [(10, 16), (32, 96), (100, 128)])
def test_fragment_reads_fetch_the_weights(n, m, transposed):
    # every B tile, read the kernel's way, is the weights' own block
    w = _weights(n, m, 1)
    lay = pack_layout(n, m)
    buf = _pack(w)
    for W, off, stride in ((w[0], 0, lay.s1), (w[1], lay.off_w2, lay.s2),
                           (w[2], lay.off_w3, lay.s2)):
        full = _pad(np.pad(W, ((0, -W.shape[0] % 8), (0, 0))),
                    -(-W.shape[1] // 8) * 8)
        Wk = full.T if not transposed else full  # (K, columns of the result)
        for j in range(Wk.shape[1] // 8):
            for s in range(Wk.shape[0] // 8):
                np.testing.assert_array_equal(
                    _b_tile(buf, off, stride, j, s, transposed),
                    Wk[_slot_columns(s), 8 * j:8 * j + 8])


@pytest.mark.parametrize("scale_nominal", [False, True])
@pytest.mark.parametrize("n,m", [(10, 16), (3, 24), (20, 40)])
def test_mirrored_forward_matches_jax(n, m, scale_nominal):
    w = _weights(n, m, 2)
    h, xc, _ = _rows(19, n, m, 2)
    lay = pack_layout(n, m)
    got, _ = _mirror_k1(h, xc, _pack(w), lay, n, scale_nominal)
    h_pad, xc_pad, p = _jax_padded(h, xc, w)
    want = np.asarray(jf.rhs_reference(h_pad, xc_pad, p, n, A1, S1, A2,
                                       scale_nominal, 30))[:, :n]
    np.testing.assert_allclose(got, want, atol=TOL_RHS)
    fwd = jf._make_pallas_forward(n, A1, S1, A2, scale_nominal, 30, block=8,
                                  interpret=True)
    pallas = np.asarray(jax.jit(fwd)(h_pad, xc_pad, p))[:h.shape[0], :n]
    np.testing.assert_allclose(got, pallas, atol=TOL_RHS)


def test_three_tf32_products_keep_fp32_accuracy():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8, 8)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(_mma3(a, b) - exact).max() < 4e-6
    one = _tf32(a) @ _tf32(b)  # a single TF32 product is ~1000 times worse
    assert np.abs(one - exact).max() > 1e-4


# -- (c) the backward's products ----------------------------------------------

def _odd8(x):
    return x + 8 if (x // 8) % 2 == 0 else x + 16


def _rows_product(A, sa, Bm, sb, rows, it_tiles, kt_tiles, ri, rk):
    """sum_r A[r][i] Bm[r][k] from two staging buffers (flat, strides sa and
    sb), fetched as the kernel's ``rows_product`` fetches its fragments."""
    out = np.zeros((16 * it_tiles, 8 * kt_tiles), np.float32)
    g, t = np.arange(8), np.arange(4)
    for it in range(it_tiles):
        for jt in range(kt_tiles):
            acc = np.zeros((16, 8), np.float32)
            for w in range(rows // 16):
                part = np.zeros((16, 8), np.float32)
                for u in range(2):
                    r0 = 16 * w + 8 * u
                    a = np.empty((16, 8), np.float32)  # (i, slot r)
                    for half in (0, 1):
                        for dt in (0, 1):
                            at = ((r0 + t[None, :] + 4 * dt) * sa + 16 * it
                                  + g[:, None] + 8 * half)
                            a[8 * half:8 * half + 8, 4 * dt:4 * dt + 4] = A[at]
                    b = np.empty((8, 8), np.float32)   # (slot r, k)
                    for dt in (0, 1):
                        at = ((r0 + t[:, None] + 4 * dt) * sb + 8 * jt
                              + g[None, :])
                        b[4 * dt:4 * dt + 4] = Bm[at]
                    part += _mma3(a, b)
                acc += part
            out[16 * it:16 * it + 16, 8 * jt:8 * jt + 8] = acc
    return out[:ri, :rk]


def _staged(v, stride):
    buf = np.zeros(v.shape[0] * stride, np.float32)
    buf.reshape(v.shape[0], stride)[:, :v.shape[1]] = v
    return buf


@pytest.mark.parametrize("n,m", [(10, 16), (20, 40)])
def test_mirrored_backward_matches_pallas_backward(n, m):
    B = 32  # two warps' rows; the Pallas block is 16
    w = _weights(n, m, 3)
    h, xc, g = _rows(B, n, m, 3)
    lay = pack_layout(n, m)
    buf = _pack(w)
    z1, z2, _ = _mirror_forward(h, xc, buf, lay)
    _, (lower, nom, mu, _) = _mirror_k1(h, xc, buf, lay, n, False)
    valid = np.arange(lay.np) < n
    gp, hp = _pad(g, lay.np), _pad(h, lay.np)
    active = (nom - mu[:, None]) < lower
    free = valid & ~active
    corr = (np.where(free, gp, 0).sum(-1) / np.maximum(free.sum(-1), 1))[:, None]
    d_ft = np.where(free, gp - corr, 0).astype(np.float32)
    d_low = np.where(valid & active, gp - corr, 0).astype(np.float32)
    dh_barrier = d_low * (np.float32(-A1 * S1) * _exp(np.float32(S1) * hp))
    dh = np.zeros_like(dh_barrier)  # d pre1 W1; the barrier part joins last

    # the three products with the weights read the backward's way
    d_pre2 = _product(np.zeros_like(z2), d_ft, buf, lay.off_w3, lay.s2, 0, True)
    d_pre2 = np.where(z2 > 0, d_pre2, 0).astype(np.float32)
    d_pre1 = np.zeros_like(z1)
    for c0 in range(0, lay.mt, CHUNK):
        c1 = min(c0 + CHUNK, lay.mt)
        d = np.zeros((B, 8 * (c1 - c0)), np.float32)
        # result tiles c0 .. c1 are the weight's columns 8 c0 ..: shift them
        for j in range(c0, c1):
            for s0 in range(0, lay.mt, GROUP):
                part = np.zeros((B, 8), np.float32)
                for s in range(s0, min(s0 + GROUP, lay.mt)):
                    part += _mma3(d_pre2[:, _slot_columns(s)],
                                  _b_tile(buf, lay.off_w2, lay.s2, j, s, True))
                d[:, 8 * (j - c0):8 * (j - c0) + 8] += part
        d = np.where(z1[:, 8 * c0:8 * c1] > 0, d, 0).astype(np.float32)
        d_pre1[:, 8 * c0:8 * c1] = d
        _product(dh, d, buf, 0, lay.s1, c0, True)
    dh = dh + dh_barrier

    # the three weight-gradient products through the staging buffers
    sm, sn = _odd8(lay.mp), _odd8(lay.np)
    it_m, it_n = (lay.mt + 1) // 2, (lay.nt + 1) // 2
    dW3 = _rows_product(_staged(d_ft, sn), sn, _staged(z2, sm), sm, B, it_n,
                        lay.mt, n, m)
    dW2 = _rows_product(_staged(d_pre2, sm), sm, _staged(z1, sm), sm, B, it_m,
                        lay.mt, m, m)
    dW1 = _rows_product(_staged(d_pre1, sm), sm, _staged(hp, sn), sn, B, it_m,
                        lay.nt, m, n)
    got = [dh[:, :n], d_pre1[:, :m], dW1, dW2, dW3, d_pre2.sum(0)[:m],
           d_ft.sum(0)[:n]]

    h_pad, xc_pad, p = _jax_padded(h, xc, w)
    g_pad = jnp.zeros((B, jf.LANE)).at[:, :n].set(g)
    bwd = jf._make_pallas_backward(n, A1, S1, 30, block=16, interpret=True)
    want = jax.jit(bwd)(h_pad, xc_pad, g_pad, p)
    shapes = [(B, n), (B, m), (m, n), (m, m), (n, m), (1, m), (1, n)]
    names = ("dh", "dxc", "dW1", "dW2", "dW3", "db2", "db3")
    for name, a, b, (r, c) in zip(names, got, want, shapes):
        np.testing.assert_allclose(a.reshape(r, c), np.asarray(b)[:r, :c],
                                   atol=TOL_GRAD, err_msg=name)


@pytest.mark.parametrize("width", [16, 24, 40, 104, 128, 136, 168])
def test_staging_stride_spreads_the_transposed_reads_over_the_banks(width):
    # k-slot t down the rows, lane group g along the columns: 32 banks
    s = _odd8(width)
    banks = {(t * s + g) % 32 for t in range(4) for g in range(8)}
    assert len(banks) == 32 and s >= width + 8 and (s // 8) % 2 == 1


@pytest.mark.parametrize("transposed", [False, True])
def test_swizzle_frees_both_fragment_reads_of_bank_conflicts(transposed):
    for j in range(4):
        for s in range(4):
            if not transposed:  # 8-byte loads: each half-warp on its own
                for half in (0, 1):
                    banks = [(((8 * s + 2 * t) ^ _swz(g)) + e) % 32
                             for g in range(4 * half, 4 * half + 4)
                             for t in range(4) for e in (0, 1)]
                    assert len(set(banks)) == 32
            else:
                for odd in (0, 1):
                    banks = [((8 * j + g) ^ _swz(2 * t + odd)) % 32
                             for g in range(8) for t in range(4)]
                    assert len(set(banks)) == 32


# -- (d) the bisection on the quads --------------------------------------------

@pytest.mark.parametrize("n", [3, 10, 20, 100])
def test_quad_bisection_matches_cone_project_mu(n):
    rng = np.random.default_rng(n)
    B, width = 64, -(-n // 8) * 8
    h = rng.uniform(size=(B, n))
    h = (h / h.sum(-1, keepdims=True)).astype(np.float32)
    lower = _barrier(h)
    nom = rng.normal(size=(B, n)).astype(np.float32)
    got = _quad_mu(_pad(lower, width), _pad(nom, width), n)
    want = cone_project_mu(torch.from_numpy(lower), torch.from_numpy(nom),
                           30).numpy()[:, 0]
    # after 30 halvings the bracket is below one ulp of its ends; the two
    # orders of the row sum may part at the last steps
    ulp = np.spacing(np.maximum(np.abs(nom).max(-1),
                                np.abs(nom - lower).max(-1)).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all()


# -- shapes -------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(3, 16), (10, 128), (32, 160), (64, 128),
                                 (100, 128), (128, 128)])
def test_shapes_of_the_jax_kernel_fit_a_block(n, m):
    # n <= 128, mlp <= 128 is all the Pallas kernel takes (it pads to
    # LANE = 128); K1, and K2 with at least one staging warp, fit in all of it
    assert shared_memory_bytes(n, m) <= SMEM_LIMIT
    warps = staged_warps(n, m)
    assert warps >= 1 and shared_memory_bytes(n, m, warps) <= SMEM_LIMIT
    assert warps == 8 or shared_memory_bytes(n, m, 2 * warps) > SMEM_LIMIT


def test_largest_shapes_and_the_first_refused():
    assert jf.LANE == 128
    assert shared_memory_bytes(128, 128) == 197632
    assert shared_memory_bytes(128, 128, 2) == SMEM_LIMIT == 232448
    assert staged_warps(128, 128) == 2 and staged_warps(10, 128) == 8
    # beyond the JAX kernel's domain: n = 32, mlp = 224 is refused
    assert shared_memory_bytes(32, 224) == 259072 > SMEM_LIMIT
    assert staged_warps(32, 224) == 0
