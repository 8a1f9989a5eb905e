"""Kernel K3's pass structure, mirrored in numpy and held against the K3
Pallas kernel in interpret mode (the JAX reference) on the CPU.

The CUDA kernel (``fiode_tpu_torch/csrc/fused_cayley_conv.cu``) cannot run
here, so this file repeats its arithmetic pass by pass with the wrapper's
own twiddle table: radix-2 passes for n = 8, 16, 32 (two real rows as one
complex FFT, the real DC and Nyquist columns as one more, the Hermitian
packing on the way back), the direct passes for any other n, the
frequency-major X (F, B ci) and Y (F, B co), and the mix reading Q through
the strides and sign the wrapper passes (Q itself, or Q^H for the conv
backward; in plain float32 here, where the kernel multiplies in 3xTF32 on
the tensor cores, which only the card can check).  An index or twiddle
error in that design shows up here before any run on the card.  Shapes: the flagship's four conv applies and the
MNIST KWLarge's (``configs/certify/mnist_certify.yaml``: 1 -> 32 @ 28,
128 -> 32 @ 14, 32 -> 64 @ 14, 256 -> 64 @ 7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fiode_tpu.ops.cayley import cayley_conv_kernel
from fiode_tpu.ops.fused_cayley_conv import fused_freq_apply as jax_fused
from fiode_tpu_torch.ops.fused_cayley_conv import is_radix, twiddle_table

# K3's gate against the dense-DFT version
TOL = 1e-4
# (ci, co, k, n): the flagship's conv applies (after space_to_depth for the
# strided ones), then the MNIST KWLarge's
FLAGSHIP = [(3, 32, 3, 32), (128, 32, 2, 16), (32, 64, 3, 16), (256, 64, 2, 8)]
MNIST = [(1, 32, 3, 28), (128, 32, 2, 14), (32, 64, 3, 14), (256, 64, 2, 7)]
# spatial sizes past the radix path's 32: direct passes with several planes
# a block (33, 48) and one plane a block (64)
WIDE = [(4, 6, 3, 33), (8, 8, 3, 48), (16, 16, 3, 64)]


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _fft(re, im, st, sign):
    """The kernel's in-register radix-2 FFT along the last axis."""
    N = re.shape[-1]
    bits = N.bit_length() - 1
    perm = [_bitrev(i, bits) for i in range(N)]
    re, im = re[..., perm].copy(), im[..., perm].copy()
    for s in range(bits):
        h = 1 << s
        for j in range(h):
            c, sn = st[0, h - 1 + j], sign * st[1, h - 1 + j]
            k = np.arange(j, N, 2 * h)
            tr = c * re[..., k + h] - sn * im[..., k + h]
            ti = c * im[..., k + h] + sn * re[..., k + h]
            re[..., k + h] = re[..., k] - tr
            im[..., k + h] = im[..., k] - ti
            re[..., k] += tr
            im[..., k] += ti
    return re, im


def _rdft_radix(x, st):
    """x (planes, N, N) -> X (F, planes) real and imaginary parts."""
    P, N, _ = x.shape
    H, NF = N // 2, N // 2 + 1
    # rows r and r + H as one complex FFT, then split
    re, im = _fft(x[:, :H], x[:, H:], st, -1)
    m = (N - np.arange(NF)) % N
    tr = np.empty((P, N, NF), np.float32)
    ti = np.empty((P, N, NF), np.float32)
    tr[:, :H] = 0.5 * (re[..., :NF] + re[..., m])
    ti[:, :H] = 0.5 * (im[..., :NF] - im[..., m])
    tr[:, H:] = 0.5 * (im[..., :NF] + im[..., m])
    ti[:, H:] = 0.5 * (re[..., m] - re[..., :NF])
    # columns (over the row axis); the real columns 0 and H share one FFT
    cr = np.moveaxis(tr, 1, -1).copy()  # (P, NF, N)
    ci = np.moveaxis(ti, 1, -1).copy()
    ci[:, 0] = cr[:, H]
    re, im = _fft(cr[:, :H], ci[:, :H], st, -1)  # (P, H, N): gi, f
    Xr = np.empty((N, NF, P), np.float32)
    Xi = np.empty((N, NF, P), np.float32)
    Xr[:, 1:H] = np.transpose(re[:, 1:], (2, 1, 0))
    Xi[:, 1:H] = np.transpose(im[:, 1:], (2, 1, 0))
    mf = (N - np.arange(N)) % N
    zr, zi = re[:, 0], im[:, 0]  # (P, N)
    Xr[:, 0] = (0.5 * (zr + zr[:, mf])).T
    Xi[:, 0] = (0.5 * (zi - zi[:, mf])).T
    Xr[:, H] = (0.5 * (zi + zi[:, mf])).T
    Xi[:, H] = (0.5 * (zr[:, mf] - zr)).T
    return Xr.reshape(N * NF, P), Xi.reshape(N * NF, P)


def _irdft_radix(Yr, Yi, st):
    """Y (F, planes) -> out (planes, N, N)."""
    F, P = Yr.shape
    N = next(n for n in (8, 16, 32) if n * (n // 2 + 1) == F)
    H, NF = N // 2, N // 2 + 1
    yr = Yr.reshape(N, NF, P).transpose(2, 1, 0)  # (P, g, f)
    yi = Yi.reshape(N, NF, P).transpose(2, 1, 0)
    # columns gi >= 1: inverse FFT over f
    re, im = _fft(yr[:, :H].copy(), yi[:, :H].copy(), st, 1)
    # gi = 0: Herm(u) + i Herm(v), u = Y[., 0], v = Y[., H]
    mf = (N - np.arange(N)) % N
    ur, ui, vr, vi = yr[:, 0], yi[:, 0], yr[:, H], yi[:, H]
    hur, hui = 0.5 * (ur + ur[:, mf]), 0.5 * (ui - ui[:, mf])
    hvr, hvi = 0.5 * (vr + vr[:, mf]), 0.5 * (vi - vi[:, mf])
    r0, r1 = _fft(hur - hvi, hui + hvr, st, 1)
    Sr = np.empty((P, N, NF), np.float32)
    Si = np.empty((P, N, NF), np.float32)
    Sr[:, :, 1:H] = np.moveaxis(re[:, 1:], 1, -1)
    Si[:, :, 1:H] = np.moveaxis(im[:, 1:], 1, -1)
    Sr[:, :, 0], Sr[:, :, H] = r0, r1
    Si[:, :, 0] = Si[:, :, H] = 0.0
    # rows r and r + H: Z = H1 + i H2 over the Hermitian extension
    a_r, a_i, b_r, b_i = Sr[:, :H], Si[:, :H], Sr[:, H:], Si[:, H:]
    zr = np.empty((P, H, N), np.float32)
    zi = np.empty((P, H, N), np.float32)
    zr[..., :NF] = a_r - b_i
    zi[..., :NF] = a_i + b_r
    k = np.arange(1, H)
    zr[..., N - k] = a_r[..., k] + b_i[..., k]
    zi[..., N - k] = b_r[..., k] - a_i[..., k]
    re, im = _fft(zr, zi, st, 1)
    scale = np.float32(1.0 / (N * N))
    return np.concatenate([re, im], axis=1) * scale


def _rdft_direct(x, tw):
    P, n, _ = x.shape
    nf = n // 2 + 1
    cs, sn = tw
    k = np.outer(np.arange(nf), np.arange(n)) % n  # (g, j)
    tr = np.einsum("pij,gj->pig", x, cs[k])
    ti = -np.einsum("pij,gj->pig", x, sn[k])
    k = np.outer(np.arange(n), np.arange(n)) % n  # (f, i)
    c, s = cs[k], sn[k]
    Xr = np.einsum("fi,pig->fgp", c, tr) + np.einsum("fi,pig->fgp", s, ti)
    Xi = np.einsum("fi,pig->fgp", c, ti) - np.einsum("fi,pig->fgp", s, tr)
    return Xr.reshape(n * nf, P), Xi.reshape(n * nf, P)


def _irdft_direct(Yr, Yi, tw, n):
    F, P = Yr.shape
    nf = n // 2 + 1
    cs, sn = tw
    yr = Yr.reshape(n, nf, P)
    yi = Yi.reshape(n, nf, P)
    k = np.outer(np.arange(n), np.arange(n)) % n  # (a, f)
    c, s = cs[k], sn[k]
    sr = np.einsum("af,fgp->pag", c, yr) - np.einsum("af,fgp->pag", s, yi)
    si = np.einsum("af,fgp->pag", c, yi) + np.einsum("af,fgp->pag", s, yr)
    w = np.ones(nf, np.float32)
    w[1:(n + 1) // 2] = 2.0
    k = np.outer(np.arange(nf), np.arange(n)) % n  # (g, j)
    out = (np.einsum("pag,gj->paj", sr * w, cs[k])
           - np.einsum("pag,gj->paj", si * w, sn[k]))
    return out / np.float32(n * n)


def k3_mirror(x, Qr, Qi, adjoint=False):
    """K3's three launches in numpy: x (B, cin, n, n), Q (F, a, b) float32;
    Q applied, or Q^H when ``adjoint``, read as the wrapper passes it."""
    B, cin, n, _ = x.shape
    F, a, b = Qr.shape
    K, cout = (a, b) if adjoint else (b, a)
    tw = twiddle_table(n)
    planes = x.reshape(B * cin, n, n)
    if is_radix(n):
        Xr, Xi = _rdft_radix(planes, tw)
    else:
        Xr, Xi = _rdft_direct(planes, tw)
    # the mix: element (q, o, c) of M at q sq + o so + c sc, imaginary * sign
    so, sc = (1, b) if adjoint else (b, 1)
    sign = -1.0 if adjoint else 1.0
    q, o, c = np.ix_(np.arange(F), np.arange(cout), np.arange(K))
    at = q * (a * b) + o * so + c * sc
    Mr, Mi = Qr.reshape(-1)[at], sign * Qi.reshape(-1)[at]
    Xr, Xi = Xr.reshape(F, B, K), Xi.reshape(F, B, K)
    Yr = np.einsum("fbc,foc->fbo", Xr, Mr) - np.einsum("fbc,foc->fbo", Xi, Mi)
    Yi = np.einsum("fbc,foc->fbo", Xr, Mi) + np.einsum("fbc,foc->fbo", Xi, Mr)
    Yr, Yi = Yr.reshape(F, B * cout), Yi.reshape(F, B * cout)
    if is_radix(n):
        out = _irdft_radix(Yr, Yi, tw)
    else:
        out = _irdft_direct(Yr, Yi, tw, n)
    return out.reshape(B, cout, n, n)


def _case(ci, co, k, n, B, seed):
    rng = np.random.default_rng(seed)
    W = jnp.asarray(rng.normal(0, 0.1, (co, ci, k, k)).astype(np.float32))
    Q = np.asarray(cayley_conv_kernel(W, jnp.float32(1.1), n))
    x = rng.normal(0, 1, (B, ci, n, n)).astype(np.float32)
    return x, Q


@pytest.mark.parametrize("ci,co,k,n", FLAGSHIP + MNIST + WIDE)
def test_k3_passes_match_pallas_interpret(ci, co, k, n):
    x, Q = _case(ci, co, k, n, 2, ci + n)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(Q), 2, True))
    got = k3_mirror(x, np.ascontiguousarray(Q.real),
                    np.ascontiguousarray(Q.imag))
    assert got.shape == want.shape == (2, co, n, n)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("ci,co,k,n", FLAGSHIP + MNIST[:1] + MNIST[3:])
def test_k3_adjoint_passes_match_the_pallas_vjp(ci, co, k, n):
    # the conv backward: Q^H read through swapped strides and a sign; the
    # transposed shapes (co -> ci, e.g. 32 -> 3 and 64 -> 256) no forward
    # layer gives K3.  The reference is jax.vjp of the Pallas kernel
    # (interpret mode) in x.
    x, Q = _case(ci, co, k, n, 2, ci * n)
    g = np.random.default_rng(n).normal(size=(2, co, n, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: jax_fused(x_, jnp.asarray(Q), 2, True),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = k3_mirror(g, np.ascontiguousarray(Q.real),
                    np.ascontiguousarray(Q.imag), adjoint=True)
    assert got.shape == want.shape == (2, ci, n, n)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)


@pytest.mark.parametrize("n", [8, 16, 32, 7, 14, 28, 33, 64])
def test_twiddle_table_is_what_the_passes_read(n):
    tw = twiddle_table(n).astype(np.float64)
    if is_radix(n):
        assert tw.shape == (2, n - 1)
        for h in 2 ** np.arange(n.bit_length() - 1):
            j = np.arange(h)
            w = tw[0, h - 1 + j] + 1j * tw[1, h - 1 + j]
            np.testing.assert_allclose(w, np.exp(1j * np.pi * j / h),
                                       atol=1e-7)
    else:
        assert tw.shape == (2, n)
        np.testing.assert_allclose(
            tw[0] + 1j * tw[1], np.exp(2j * np.pi * np.arange(n) / n),
            atol=1e-7)
