// Fused Fourier-domain orthogonal convolution (kernel K3).
//
// Replaces the Pallas kernel
// fiode_tpu/ops/fused_cayley_conv.py::_fused_forward.  Semantics of
// apply_freq_matrices(x, Q, impl="dft"): for each image,
//   X_f = rDFT2(x)                 (ci, F), F = n * (n/2 + 1), index f*nf + g
//   Y_f = Q_f X_f                  (co, F), complex, Q (F, co, ci)
//   y   = Re(irDFT2(Y_f))          (co, n, n), Hermitian weights folded in
//
// What bounds it on the H100: per image the layer reads ci n^2 and writes
// co n^2 floats, and the mix does 8 F co ci flops (four real FMAs per
// complex MAC); at the flagship's shapes at B = 32768 the larger of the two
// sums to 7.4 ms over the four layers.  What the TPU form added on top
// (dense O(n^2) DFT matrices per frequency, the mix as a per-image loop) is
// what this design removes.  Three launches, each with one job, the
// intermediates frequency-major in device memory:
//   1. rdft:  a block takes a tile of P (image, channel) planes (16-byte
//      loads of x into shared memory).  Rows, then columns, are transformed
//      in registers, one thread per pair of rows and then per column:
//      radix-2 passes for n = 8, 16, 32 (two real rows as one complex FFT;
//      the real DC and Nyquist columns as one more), a direct O(n) pass for
//      any other n.  X is written as (F, B ci) real and imaginary planes,
//      F B ci 8 bytes, i.e. (M = images) x (K = ci) row-major per
//      frequency; the tile's (F, P) block goes through shared memory so
//      that the stores are 16-byte and contiguous.
//   2. mix:   a batched complex GEMM over frequencies with the images as M:
//      Y_f (B x co) = X_f (B x ci) Q_f^T (ci x co).  A block owns (f, a tile
//      of 64-256 images, a tile of out-channels); X and Q tiles of 16
//      channels (8 when ci <= 8) are staged through shared memory by
//      cp.async (16-byte copies where ci allows), double-buffered over K.
//      Its 8 warps multiply on the tensor cores with mma.sync in 3xTF32:
//      each fp32 operand is split into a TF32 value and a TF32 remainder and
//      three products are summed in fp32, which keeps fp32 accuracy (plain
//      TF32 would not hold 1e-4 against the dense-DFT version).  Each Q_f
//      element is read once per image tile.  Q is read through strides and
//      a sign on its imaginary part, so Q^H (the conv backward) is a stride
//      swap, not a copy.  Y: F B co 8 bytes.
//   3. irdft: stages the tile's Y (F, P) in shared memory with 16-byte
//      loads, runs the inverse column then row passes (radix or direct, as
//      in 1) and writes out (B, co, n, n) with 16-byte stores.
// Shared memory per block: the radix passes 68 KB (n = 32), 36 KB (16) and
// 21 KB (8); the mix 24-83 KB; the direct passes at most 48 KB.
// Every output is summed by one thread (one mma accumulator lane) in a
// fixed order (no atomics), so results are bit-reproducible from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 32;              // largest spatial size handled
constexpr int kDirectSmemFloats = 12288;  // 48 KB per block, direct passes
constexpr int kDirectMaxPlanes = 64;

// ---------------------------------------------------------------------------
// radix-2 transforms in registers

template <int N>
__host__ __device__ constexpr int log2i() {
  int k = 0;
  while ((1 << k) < N) ++k;
  return k;
}

template <int N>
__host__ __device__ constexpr int bitrev(int i) {
  int r = 0;
  for (int k = 0; k < log2i<N>(); ++k) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// In-place radix-2 FFT of (re, im), natural order in and out:
// X[k] = sum_j x[j] e^{SIGN 2 pi i j k / N} (unnormalised).  st holds the
// stage twiddles: entry h - 1 + j (j < h) of stage h = 1, 2, ..., N/2 is
// cos(pi j / h), and at offset N - 1 sin(pi j / h).
template <int N, int SIGN>
__device__ __forceinline__ void fft(float (&re)[N], float (&im)[N],
                                    const float* st) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = bitrev<N>(i);
    if (i < j) {
      const float tr = re[i], ti = im[i];
      re[i] = re[j];
      im[i] = im[j];
      re[j] = tr;
      im[j] = ti;
    }
  }
#pragma unroll
  for (int s = 0; s < log2i<N>(); ++s) {
    const int h = 1 << s;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float c = st[h - 1 + j];
      const float sn = SIGN * st[N - 1 + h - 1 + j];
#pragma unroll
      for (int k = j; k < N; k += 2 * h) {
        const float tr = c * re[k + h] - sn * im[k + h];
        const float ti = c * im[k + h] + sn * re[k + h];
        re[k + h] = re[k] - tr;
        im[k + h] = im[k] - ti;
        re[k] += tr;
        im[k] += ti;
      }
    }
  }
}

// Layout of a radix block: P planes, one thread per row pair and per column
// (P N / 2 = kThreads); the input (or output) tile with rows padded to
// N + 1 floats, the row-pass result T (P, N, nf) complex with an odd plane
// stride, sharing one buffer after the stage twiddles.
template <int N>
struct Radix {
  static constexpr int NF = N / 2 + 1;
  static constexpr int H = N / 2;
  static constexpr int P = 2 * kThreads / N;
  static constexpr int SR = N + 1;           // tile row stride
  static constexpr int TP = (N * NF) | 1;    // T plane stride
  static constexpr int TILE = P * N * SR;
  static constexpr int T2 = 2 * P * TP;
  static constexpr int BUF = TILE > T2 ? TILE : T2;
  static constexpr size_t kSmem = sizeof(float) * (2 * N + BUF);
};

// Move a tile's frequency-major rows, F rows of its np planes, between
// device memory (F, planes) and shared memory (F, P), real and imaginary
// parts: 16-byte accesses when the tile is full and the rows are 16-byte
// aligned, else one float at a time (planes past np read as zero).
template <int F, int P>
__device__ __forceinline__ void load_rows(const float* __restrict__ gr,
                                          const float* __restrict__ gi,
                                          float* sr, float* si, size_t p0,
                                          int np, int planes) {
  if (np == P && planes % 4 == 0) {
    constexpr int C = P / 4;
    for (int i = threadIdx.x; i < 2 * F * C; i += kThreads) {
      const int part = i / (F * C), r = i % (F * C);
      const size_t at = (size_t)(r / C) * planes + p0 + 4 * (r % C);
      const float* g = (part ? gi : gr) + at;
      *reinterpret_cast<float4*>((part ? si : sr) + 4 * r) =
          __ldg(reinterpret_cast<const float4*>(g));
    }
  } else {
    for (int i = threadIdx.x; i < 2 * F * P; i += kThreads) {
      const int part = i / (F * P), r = i % (F * P), p = r % P;
      const size_t at = (size_t)(r / P) * planes + p0 + p;
      (part ? si : sr)[r] = p < np ? __ldg((part ? gi : gr) + at) : 0.f;
    }
  }
}

template <int F, int P>
__device__ __forceinline__ void store_rows(const float* sr, const float* si,
                                           float* __restrict__ gr,
                                           float* __restrict__ gi, size_t p0,
                                           int np, int planes) {
  if (np == P && planes % 4 == 0) {
    constexpr int C = P / 4;
    for (int i = threadIdx.x; i < 2 * F * C; i += kThreads) {
      const int part = i / (F * C), r = i % (F * C);
      const size_t at = (size_t)(r / C) * planes + p0 + 4 * (r % C);
      *reinterpret_cast<float4*>((part ? gi : gr) + at) =
          *reinterpret_cast<const float4*>((part ? si : sr) + 4 * r);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * F * P; i += kThreads) {
      const int part = i / (F * P), r = i % (F * P), p = r % P;
      if (p < np) {
        (part ? gi : gr)[(size_t)(r / P) * planes + p0 + p] =
            (part ? si : sr)[r];
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
rdft_radix_kernel(const float* __restrict__ x,    // (planes, N, N)
                  const float* __restrict__ stg,  // (2, N - 1)
                  float* __restrict__ xr,         // (F, planes)
                  float* __restrict__ xi, int planes) {
  using R = Radix<N>;
  constexpr int NF = R::NF, H = R::H, P = R::P, SR = R::SR, TP = R::TP;
  extern __shared__ float smem[];
  float* st = smem;
  float* buf = st + 2 * N;
  const int tid = threadIdx.x;
  const size_t p0 = (size_t)blockIdx.x * P;
  const int np = planes - (int)p0 < P ? planes - (int)p0 : P;
  for (int i = tid; i < 2 * (N - 1); i += kThreads) st[i] = stg[i];
  // the tile's planes are contiguous in x: 16-byte loads, rows padded
  const float4* src = reinterpret_cast<const float4*>(x + p0 * N * N);
  for (int i = tid; i < np * N * N / 4; i += kThreads) {
    const float4 v = __ldg(src + i);
    float* d = buf + (4 * i / N) * SR + (4 * i) % N;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  {  // rows r and r + H of plane p as one complex FFT
    const int p = tid / H, r = tid % H;
    float re[N], im[N];
    const float* a = buf + (p * N + r) * SR;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      re[j] = a[j];
      im[j] = a[H * SR + j];
    }
    __syncthreads();  // T overwrites the tile
    fft<N, -1>(re, im, st);
    // A[k] = (Z[k] + conj Z[N-k]) / 2,  B[k] = (Z[k] - conj Z[N-k]) / 2i
    float* tr = buf + p * TP + r * NF;
    float* ti = tr + P * TP;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const int m = (N - k) % N;
      tr[k] = 0.5f * (re[k] + re[m]);
      ti[k] = 0.5f * (im[k] - im[m]);
      tr[H * NF + k] = 0.5f * (im[k] + im[m]);
      ti[H * NF + k] = 0.5f * (re[m] - re[k]);
    }
  }
  __syncthreads();

  {  // column g of plane p; the real columns 0 and H share one FFT
    const int p = tid % P, gi = tid / P;
    float re[N], im[N];
    const float* tr = buf + p * TP;
    const float* ti = tr + P * TP;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      re[i] = tr[i * NF + gi];
      im[i] = gi == 0 ? tr[i * NF + H] : ti[i * NF + gi];
    }
    __syncthreads();  // the X tile overwrites T
    fft<N, -1>(re, im, st);
    // the tile's X (F, P) in shared memory, then stored row by row
    float* oR = buf + p;
    float* oI = buf + NF * N * P + p;
    if (gi == 0) {
#pragma unroll
      for (int f = 0; f < N; ++f) {
        const int m = (N - f) % N;
        oR[(f * NF) * P] = 0.5f * (re[f] + re[m]);
        oI[(f * NF) * P] = 0.5f * (im[f] - im[m]);
        oR[(f * NF + H) * P] = 0.5f * (im[f] + im[m]);
        oI[(f * NF + H) * P] = 0.5f * (re[m] - re[f]);
      }
    } else {
#pragma unroll
      for (int f = 0; f < N; ++f) {
        oR[(f * NF + gi) * P] = re[f];
        oI[(f * NF + gi) * P] = im[f];
      }
    }
  }
  __syncthreads();
  store_rows<N * NF, P>(buf, buf + NF * N * P, xr, xi, p0, np, planes);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
irdft_radix_kernel(const float* __restrict__ yr,   // (F, planes)
                   const float* __restrict__ yi,
                   const float* __restrict__ stg,  // (2, N - 1)
                   float* __restrict__ out,        // (planes, N, N)
                   int planes) {
  using R = Radix<N>;
  constexpr int NF = R::NF, H = R::H, P = R::P, SR = R::SR, TP = R::TP;
  extern __shared__ float smem[];
  float* st = smem;
  float* buf = st + 2 * N;
  const int tid = threadIdx.x;
  const size_t p0 = (size_t)blockIdx.x * P;
  const int np = planes - (int)p0 < P ? planes - (int)p0 : P;
  for (int i = tid; i < 2 * (N - 1); i += kThreads) st[i] = stg[i];
  load_rows<N * NF, P>(yr, yi, buf, buf + NF * N * P, p0, np, planes);
  __syncthreads();

  {  // columns: S[a][g] = sum_f e^{+2 pi i a f / N} Y[f][g]
    const int p = tid % P, gi = tid / P;
    const float* yR = buf + p;  // this tile's Y (F, P)
    const float* yI = buf + NF * N * P + p;
    float re[N], im[N];
    if (gi == 0) {
      // only Re S[.][0] and Re S[.][H] are needed: the inverse FFT of
      // z = Herm(u) + i Herm(v), u = Y[.][0], v = Y[.][H],
      // Herm(u)[f] = (u[f] + conj u[N-f]) / 2, gives them as (re, im)
#pragma unroll
      for (int f = 0; f <= H; ++f) {
        const int m = (N - f) % N;
        const float ur = yR[(f * NF) * P], ui = yI[(f * NF) * P];
        const float umr = yR[(m * NF) * P], umi = yI[(m * NF) * P];
        const float vr = yR[(f * NF + H) * P], vi = yI[(f * NF + H) * P];
        const float vmr = yR[(m * NF + H) * P], vmi = yI[(m * NF + H) * P];
        const float hur = 0.5f * (ur + umr), hui = 0.5f * (ui - umi);
        const float hvr = 0.5f * (vr + vmr), hvi = 0.5f * (vi - vmi);
        re[f] = hur - hvi;
        im[f] = hui + hvr;
        re[m] = hur + hvi;
        im[m] = hvr - hui;
      }
    } else {
#pragma unroll
      for (int f = 0; f < N; ++f) {
        re[f] = yR[(f * NF + gi) * P];
        im[f] = yI[(f * NF + gi) * P];
      }
    }
    __syncthreads();  // S overwrites the staged Y
    fft<N, 1>(re, im, st);
    float* sr = buf + p * TP;
    float* si = sr + P * TP;
    if (gi == 0) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        sr[a * NF] = re[a];
        si[a * NF] = 0.f;
        sr[a * NF + H] = im[a];
        si[a * NF + H] = 0.f;
      }
    } else {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        sr[a * NF + gi] = re[a];
        si[a * NF + gi] = im[a];
      }
    }
  }
  __syncthreads();

  {  // rows a = r and r + H of plane p as one complex inverse FFT of
     // Z = H1 + i H2, H the Hermitian extension of the row's S
    const int p = tid / H, r = tid % H;
    const float* s1r = buf + p * TP + r * NF;
    const float* s1i = s1r + P * TP;
    const float* s2r = s1r + H * NF;
    const float* s2i = s1i + H * NF;
    float re[N], im[N];
#pragma unroll
    for (int k = 0; k <= H; ++k) {
      const float ar = s1r[k], ai = s1i[k], br = s2r[k], bi = s2i[k];
      re[k] = ar - bi;
      im[k] = ai + br;
      if (k > 0 && k < H) {
        re[N - k] = ar + bi;
        im[N - k] = br - ai;
      }
    }
    __syncthreads();  // the output tile overwrites S
    fft<N, 1>(re, im, st);
    constexpr float scale = 1.f / (N * N);
    float* o = buf + (p * N + r) * SR;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      o[j] = re[j] * scale;
      o[H * SR + j] = im[j] * scale;
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + p0 * N * N);
  for (int i = tid; i < np * N * N / 4; i += kThreads) {
    const float* s = buf + (4 * i / N) * SR + (4 * i) % N;
    dst[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
}

// ---------------------------------------------------------------------------
// direct O(n) passes for any n (no radix path): same layouts; tw (2, n) is
// cos and sin of 2 pi k / n.  P planes per block, chosen by the host.

__global__ void __launch_bounds__(kThreads)
rdft_direct_kernel(const float* __restrict__ x, const float* __restrict__ tw,
                   float* __restrict__ xr, float* __restrict__ xi, int planes,
                   int n, int P) {
  extern __shared__ float smem[];
  const int nf = n / 2 + 1, F = n * nf;
  float* cs = smem;
  float* sn = cs + n;
  float* tile = sn + n;           // (P, n, n)
  float* tr = tile + P * n * n;   // (P, n, nf) row-pass result
  float* ti = tr + P * n * nf;
  const int tid = threadIdx.x;
  const size_t p0 = (size_t)blockIdx.x * P;
  const int np = planes - (int)p0 < P ? planes - (int)p0 : P;
  for (int k = tid; k < n; k += kThreads) {
    cs[k] = tw[k];
    sn[k] = tw[n + k];
  }
  for (int i = tid; i < np * n * n; i += kThreads) {
    tile[i] = __ldg(x + p0 * n * n + i);
  }
  __syncthreads();
  // rows: T[p][i][g] = sum_j x[p][i][j] e^{-2 pi i g j / n}
  for (int idx = tid; idx < np * n * nf; idx += kThreads) {
    const int g = idx % nf, row = idx / nf;  // row = p * n + i
    const float* v = tile + row * n;
    float ar = 0.f, ai = 0.f;
    for (int j = 0, k = 0; j < n; ++j) {
      ar = fmaf(v[j], cs[k], ar);
      ai = fmaf(-v[j], sn[k], ai);
      k += g;
      if (k >= n) k -= n;
    }
    tr[idx] = ar;
    ti[idx] = ai;
  }
  __syncthreads();
  // columns: X[f][g] = sum_i e^{-2 pi i f i / n} T[i][g]; p fastest, so the
  // stores of a warp are contiguous in X (F, planes)
  for (int idx = tid; idx < P * F; idx += kThreads) {
    const int p = idx % P, q = idx / P;
    if (p >= np) continue;
    const int f = q / nf, g = q % nf;
    const int base = p * n * nf + g;
    float ar = 0.f, ai = 0.f;
    for (int i = 0, k = 0; i < n; ++i) {
      const float vr = tr[base + i * nf], vi = ti[base + i * nf];
      ar += cs[k] * vr + sn[k] * vi;
      ai += cs[k] * vi - sn[k] * vr;
      k += f;
      if (k >= n) k -= n;
    }
    xr[(size_t)q * planes + p0 + p] = ar;
    xi[(size_t)q * planes + p0 + p] = ai;
  }
}

__global__ void __launch_bounds__(kThreads)
irdft_direct_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                    const float* __restrict__ tw, float* __restrict__ out,
                    int planes, int n, int P) {
  extern __shared__ float smem[];
  const int nf = n / 2 + 1, F = n * nf;
  float* cs = smem;
  float* sn = cs + n;
  float* ysr = sn + n;            // (P, F) this tile's Y
  float* ysi = ysr + P * F;
  float* sr = ysi + P * F;        // (P, n, nf) column-pass result
  float* si = sr + P * n * nf;
  const int tid = threadIdx.x;
  const size_t p0 = (size_t)blockIdx.x * P;
  const int np = planes - (int)p0 < P ? planes - (int)p0 : P;
  for (int k = tid; k < n; k += kThreads) {
    cs[k] = tw[k];
    sn[k] = tw[n + k];
  }
  for (int idx = tid; idx < P * F; idx += kThreads) {
    const int p = idx % P, q = idx / P;
    const bool ok = p < np;
    ysr[p * F + q] = ok ? __ldg(yr + (size_t)q * planes + p0 + p) : 0.f;
    ysi[p * F + q] = ok ? __ldg(yi + (size_t)q * planes + p0 + p) : 0.f;
  }
  __syncthreads();
  // columns: S[p][a][g] = sum_f e^{+2 pi i a f / n} Y[p][f][g]
  for (int idx = tid; idx < np * n * nf; idx += kThreads) {
    const int g = idx % nf, a = (idx / nf) % n, p = idx / (n * nf);
    const float* vr = ysr + p * F + g;
    const float* vi = ysi + p * F + g;
    float ar = 0.f, ai = 0.f;
    for (int f = 0, k = 0; f < n; ++f) {
      ar += cs[k] * vr[f * nf] - sn[k] * vi[f * nf];
      ai += cs[k] * vi[f * nf] + sn[k] * vr[f * nf];
      k += a;
      if (k >= n) k -= n;
    }
    sr[idx] = ar;
    si[idx] = ai;
  }
  __syncthreads();
  // rows, real part, Hermitian weights: y[p][a][j] =
  //   sum_g w_g Re(e^{+2 pi i g j / n} S[p][a][g]) / n^2
  const float scale = 1.f / (float)(n * n);
  const int half = (n + 1) / 2;
  for (int idx = tid; idx < np * n * n; idx += kThreads) {
    const int j = idx % n, row = idx / n;  // row = p * n + a
    const float* rr = sr + row * nf;
    const float* ri = si + row * nf;
    float acc = 0.f;
    for (int g = 0, k = 0; g < nf; ++g) {
      const float w = (g > 0 && g < half) ? 2.f : 1.f;
      acc += w * (cs[k] * rr[g] - sn[k] * ri[g]);
      k += j;
      if (k >= n) k -= n;
    }
    out[p0 * n * n + idx] = acc * scale;
  }
}

// ---------------------------------------------------------------------------
// the per-frequency mix: a batched complex GEMM, images as M

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

template <int BM, int BN, int BK>
constexpr size_t mix_smem_bytes() {
  return sizeof(float) * 2 * (2 * BM + 2 * BN) * (BK + 4);
}

// tf32 (round to nearest) of x, as the bits of a float with the low 13
// mantissa bits clear
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32: x - big is exact in fp32, and small keeps
// its leading 11 bits, so a product of two splits loses ~2^-22 relative
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three TF32 products (3xTF32): the small terms first, the
// small-by-small one dropped; fp32 accuracy from the tensor cores
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ab)[4],
                                     const unsigned (&as)[4],
                                     const unsigned (&bb)[2],
                                     const unsigned (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// Y[q][b][o] = sum_c X[q][b][c] M[q][o][c], complex, where element
// (q, o, c) of M is (qr + i qsign qi)[q sq + o so + c sc]: Q itself
// (sq = co ci, so = ci, sc = 1, qsign = 1) or Q^H (so = 1, sc = co,
// qsign = -1) of the same tensor.  A block computes a BM x BN tile of one
// frequency over K in stages of BK channels; each of its 8 warps a WM x WN
// part of it with mma.sync m16n8k8 in 3xTF32, four real products per
// complex one (Yr += Xr Wr - Xi Wi, Yi += Xr Wi + Xi Wr).  Both operands are
// staged K-contiguous ([row][k], rows padded to BK + 4 floats, which makes
// the fragment reads conflict-free); they arrive by 16-byte cp.async where
// K and the strides allow it (vec_x, vec_q), else by 4-byte ones.
template <int BM, int BN, int WM, int WN, int BK>
__global__ void __launch_bounds__(kThreads, 2)
mix_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ qr, const float* __restrict__ qi,
           float* __restrict__ yr, float* __restrict__ yi, int B, int K,
           int Nc, long long sq, long long so, long long sc, float qsign,
           int vec_x, int vec_q) {
  constexpr int WARPS_N = BN / WN, MI = WM / 16, NI = WN / 8;
  static_assert((BM / WM) * WARPS_N * 32 == kThreads, "8 warps a block");
  static_assert(BK % 8 == 0 && WM % 16 == 0 && WN % 8 == 0, "mma tiles");
  constexpr int kBK = BK, kSK = BK + 4;
  constexpr int XS = BM * kSK, WS = BN * kSK;  // one operand, one stage
  extern __shared__ __align__(16) float smem[];
  float* sxr = smem;             // (2, BM, kSK)
  float* sxi = sxr + 2 * XS;
  float* swr = sxi + 2 * XS;     // (2, BN, kSK)
  float* swi = swr + 2 * WS;

  const int q = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const float* xqr = xr + (size_t)q * B * K;
  const float* xqi = xi + (size_t)q * B * K;
  const float* wqr = qr + (size_t)q * sq;
  const float* wqi = qi + (size_t)q * sq;

  auto load = [&](int stage, int k0) {
    float* dxr = sxr + stage * XS;
    float* dxi = sxi + stage * XS;
    float* dwr = swr + stage * WS;
    float* dwi = swi + stage * WS;
    if (vec_x) {  // K % 4 == 0: a 16-byte chunk is all in or all out
      for (int e = tid; e < BM * kBK / 4; e += kThreads) {
        const int row = e / (kBK / 4), c = 4 * (e % (kBK / 4));
        const bool ok = m0 + row < B && k0 + c < K;
        const size_t off = ok ? (size_t)(m0 + row) * K + k0 + c : 0;
        cp_async16(dxr + row * kSK + c, xqr + off, ok);
        cp_async16(dxi + row * kSK + c, xqi + off, ok);
      }
    } else {
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int row = e / kBK, c = e % kBK;
        const bool ok = m0 + row < B && k0 + c < K;
        const size_t off = ok ? (size_t)(m0 + row) * K + k0 + c : 0;
        cp_async4(dxr + row * kSK + c, xqr + off, ok);
        cp_async4(dxi + row * kSK + c, xqi + off, ok);
      }
    }
    if (vec_q) {  // sc == 1, so and K multiples of 4
      for (int e = tid; e < BN * kBK / 4; e += kThreads) {
        const int nn = e / (kBK / 4), c = 4 * (e % (kBK / 4));
        const bool ok = n0 + nn < Nc && k0 + c < K;
        const size_t off = ok ? (size_t)(n0 + nn) * so + k0 + c : 0;
        cp_async16(dwr + nn * kSK + c, wqr + off, ok);
        cp_async16(dwi + nn * kSK + c, wqi + off, ok);
      }
    } else {  // lanes along o: contiguous in Q^H's layout
      for (int e = tid; e < BN * kBK; e += kThreads) {
        const int nn = e % BN, c = e / BN;
        const bool ok = n0 + nn < Nc && k0 + c < K;
        const size_t off =
            ok ? (size_t)(n0 + nn) * so + (size_t)(k0 + c) * sc : 0;
        cp_async4(dwr + nn * kSK + c, wqr + off, ok);
        cp_async4(dwi + nn * kSK + c, wqi + off, ok);
      }
    }
    cp_async_commit();
  };

  // mma fragment coordinates: g = lane / 4 picks rows (A, C) or the
  // column (B), t = lane % 4 the k (A, B) or the column pair (C)
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  float cr[MI][NI][4], ci[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cr[i][j][e] = ci[i][j][e] = 0.f;
    }
  }
  const int nk = (K + kBK - 1) / kBK;
  load(0, 0);
  for (int st = 0; st < nk; ++st) {
    const int cur = st & 1;
    if (st + 1 < nk) {
      load(cur ^ 1, (st + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cxr = sxr + cur * XS + (wm + g) * kSK + t;
    const float* cxi = sxi + cur * XS + (wm + g) * kSK + t;
    const float* cwr = swr + cur * WS + (wn + g) * kSK + t;
    const float* cwi = swi + cur * WS + (wn + g) * kSK + t;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      // A fragments (rows g, g + 8; k t, t + 4) of Xr and Xi
      unsigned arb[MI][4], ars[MI][4], aib[MI][4], ais[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = i * 16 * kSK + k8;
        const int at[4] = {r, r + 8 * kSK, r + 4, r + 8 * kSK + 4};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split(cxr[at[e]], arb[i][e], ars[i][e]);
          split(cxi[at[e]], aib[i][e], ais[i][e]);
        }
      }
      // B fragments (k t, t + 4; column g) of Wr, qsign Wi and -qsign Wi
      unsigned brb[NI][2], brs[NI][2], bib[NI][2], bis[NI][2];
      unsigned bnb[NI][2], bns[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int r = j * 8 * kSK + k8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          split(cwr[r + 4 * e], brb[j][e], brs[j][e]);
          split(qsign * cwi[r + 4 * e], bib[j][e], bis[j][e]);
          bnb[j][e] = bib[j][e] ^ 0x80000000u;  // negation is exact
          bns[j][e] = bis[j][e] ^ 0x80000000u;
        }
      }
      // each step's products are summed by the tensor cores into a fresh
      // partial (their fp32 adds truncate), which is then added to the
      // running sum with a rounded fp32 add: the truncation's bias stays
      // at the size of one step's sum instead of growing with K
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(pr, arb[i], ars[i], brb[j], brs[j]);
          mma3(pr, aib[i], ais[i], bnb[j], bns[j]);
          mma3(pi, arb[i], ars[i], bib[j], bis[j]);
          mma3(pi, aib[i], ais[i], brb[j], brs[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cr[i][j][e] += pr[e];
            ci[i][j][e] += pi[e];
          }
        }
      }
    }
    __syncthreads();  // the next stage's loads overwrite this buffer
  }

  // C fragments: rows g and g + 8, columns 2t and 2t + 1
  float* yqr = yr + (size_t)q * B * Nc;
  float* yqi = yi + (size_t)q * B * Nc;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // c[2h], c[2h + 1]: one row, two columns
        const int b = m0 + wm + i * 16 + g + 8 * h;
        const int o = n0 + wn + j * 8 + 2 * t;
        if (b >= B) continue;
        const size_t at = (size_t)b * Nc + o;
        if (Nc % 2 == 0 && o + 1 < Nc) {  // 8-byte aligned pair
          *reinterpret_cast<float2*>(yqr + at) =
              make_float2(cr[i][j][2 * h], cr[i][j][2 * h + 1]);
          *reinterpret_cast<float2*>(yqi + at) =
              make_float2(ci[i][j][2 * h], ci[i][j][2 * h + 1]);
        } else {
          for (int e = 0; e < 2 && o + e < Nc; ++e) {
            yqr[at + e] = cr[i][j][2 * h + e];
            yqi[at + e] = ci[i][j][2 * h + e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

template <int N>
cudaError_t launch_rdft_radix(const float* x, const float* st, float* xr,
                              float* xi, int planes, cudaStream_t s) {
  using R = Radix<N>;
  cudaError_t err = cudaFuncSetAttribute(
      rdft_radix_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(R::kSmem));
  if (err != cudaSuccess) return err;
  const int grid = (planes + R::P - 1) / R::P;
  rdft_radix_kernel<N><<<grid, kThreads, R::kSmem, s>>>(x, st, xr, xi, planes);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_irdft_radix(const float* yr, const float* yi,
                               const float* st, float* out, int planes,
                               cudaStream_t s) {
  using R = Radix<N>;
  cudaError_t err = cudaFuncSetAttribute(
      irdft_radix_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(R::kSmem));
  if (err != cudaSuccess) return err;
  const int grid = (planes + R::P - 1) / R::P;
  irdft_radix_kernel<N><<<grid, kThreads, R::kSmem, s>>>(yr, yi, st, out,
                                                         planes);
  return cudaGetLastError();
}

// planes per block of a direct pass within kDirectSmemFloats
int direct_planes(int n, int per_plane) {
  int P = (kDirectSmemFloats - 2 * n) / per_plane;
  if (P > kDirectMaxPlanes) P = kDirectMaxPlanes;
  return P < 1 ? 1 : P;
}

cudaError_t launch_rdft(int n, int radix, const float* x, const float* tw,
                        float* xr, float* xi, int planes, cudaStream_t s) {
  if (radix) {
    switch (n) {
      case 8: return launch_rdft_radix<8>(x, tw, xr, xi, planes, s);
      case 16: return launch_rdft_radix<16>(x, tw, xr, xi, planes, s);
      case 32: return launch_rdft_radix<32>(x, tw, xr, xi, planes, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const int nf = n / 2 + 1;
  const int P = direct_planes(n, n * n + 2 * n * nf);
  const size_t smem = sizeof(float) * (2 * n + P * (n * n + 2 * n * nf));
  const int grid = (planes + P - 1) / P;
  rdft_direct_kernel<<<grid, kThreads, smem, s>>>(x, tw, xr, xi, planes, n, P);
  return cudaGetLastError();
}

cudaError_t launch_irdft(int n, int radix, const float* yr, const float* yi,
                         const float* tw, float* out, int planes,
                         cudaStream_t s) {
  if (radix) {
    switch (n) {
      case 8: return launch_irdft_radix<8>(yr, yi, tw, out, planes, s);
      case 16: return launch_irdft_radix<16>(yr, yi, tw, out, planes, s);
      case 32: return launch_irdft_radix<32>(yr, yi, tw, out, planes, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const int nf = n / 2 + 1;
  const int P = direct_planes(n, 4 * n * nf);
  const size_t smem = sizeof(float) * (2 * n + P * 4 * n * nf);
  const int grid = (planes + P - 1) / P;
  irdft_direct_kernel<<<grid, kThreads, smem, s>>>(yr, yi, tw, out, planes, n,
                                                   P);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN, int BK>
cudaError_t launch_mix_tile(const float* xr, const float* xi, const float* qr,
                            const float* qi, float* yr, float* yi, int F,
                            int B, int K, int Nc, long long sq, long long so,
                            long long sc, float qsign, cudaStream_t s) {
  constexpr size_t smem = mix_smem_bytes<BM, BN, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      mix_kernel<BM, BN, WM, WN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 16-byte copies need K, the row strides and the bases in 4-float units
  const int vec_x = K % 4 == 0;
  const int vec_q = sc == 1 && so % 4 == 0 && sq % 4 == 0 && K % 4 == 0;
  const dim3 grid((B + BM - 1) / BM, (Nc + BN - 1) / BN, F);
  mix_kernel<BM, BN, WM, WN, BK><<<grid, kThreads, smem, s>>>(
      xr, xi, qr, qi, yr, yi, B, K, Nc, sq, so, sc, qsign, vec_x, vec_q);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_mix_bk(const float* xr, const float* xi, const float* qr,
                          const float* qi, float* yr, float* yi, int F, int B,
                          int K, int Nc, long long sq, long long so,
                          long long sc, float qsign, cudaStream_t s) {
  if (Nc <= 8) {
    return launch_mix_tile<256, 8, 32, 8, BK>(xr, xi, qr, qi, yr, yi, F, B, K,
                                              Nc, sq, so, sc, qsign, s);
  }
  if (Nc <= 32) {
    return launch_mix_tile<128, 32, 32, 16, BK>(xr, xi, qr, qi, yr, yi, F, B,
                                                K, Nc, sq, so, sc, qsign, s);
  }
  return launch_mix_tile<64, 64, 32, 16, BK>(xr, xi, qr, qi, yr, yi, F, B, K,
                                             Nc, sq, so, sc, qsign, s);
}

// the tile shape follows the channels, so that ci = 3 (the first layer),
// co = 3 (its transpose) and co = 32 waste no more than a partial tile
cudaError_t launch_mix(const float* xr, const float* xi, const float* qr,
                       const float* qi, float* yr, float* yi, int F, int B,
                       int K, int Nc, long long sq, long long so,
                       long long sc, float qsign, cudaStream_t s) {
  if (K <= 8) {
    return launch_mix_bk<8>(xr, xi, qr, qi, yr, yi, F, B, K, Nc, sq, so, sc,
                            qsign, s);
  }
  return launch_mix_bk<16>(xr, xi, qr, qi, yr, yi, F, B, K, Nc, sq, so, sc,
                           qsign, s);
}

}  // namespace

extern "C" {

const char* fused_cayley_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers to float32 arrays: x (B, ci, n, n)
// contiguous and 16-byte aligned; the applied matrices M (F, co, ci) read
// as element (q, o, c) = qr[q sq + o so + c sc] + i qsign qi[...];
// radix = 1 takes the radix-2 passes (n = 8, 16 or 32), 0 the direct ones;
// tw the wrapper's twiddle table, (2, n - 1) stage twiddles for the radix
// passes and (2, n) cos, sin of 2 pi k / n for the direct ones; scratch
// xf (2, F, B ci) and yf (2, F, B co); out (B, co, n, n).  Returns a
// cudaError_t (0 on success).
int fused_freq_apply_forward(const float* x, const float* qr, const float* qi,
                             long long sq, long long so, long long sc,
                             float qsign, int radix, const float* tw,
                             float* xf, float* yf, float* out, int B, int ci,
                             int co, int n, void* stream) {
  if (B < 0 || ci < 1 || co < 1 || n < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int F = n * (n / 2 + 1);
  const int pin = B * ci, pout = B * co;
  float* xr = xf;
  float* xi = xf + (size_t)F * pin;
  float* yr = yf;
  float* yi = yf + (size_t)F * pout;
  cudaError_t err = launch_rdft(n, radix, x, tw, xr, xi, pin, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_mix(xr, xi, qr, qi, yr, yi, F, B, ci, co, sq, so, sc, qsign, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_irdft(n, radix, yr, yi, tw, out, pout, s));
}

}  // extern "C"
