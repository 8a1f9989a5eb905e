// Fused Fourier-domain orthogonal convolution (kernel K3), forward only.
//
// Replaces the Pallas kernel
// fiode_tpu/ops/fused_cayley_conv.py::_fused_forward.  Semantics of
// apply_freq_matrices(x, Q, impl="dft"): for each image,
//   X_f = rDFT2(x)                 (ci, F), F = n * (n/2 + 1), index f*nf + g
//   Y_f = Q_f X_f                  (co, F), complex, Q (F, co, ci)
//   y   = Re(irDFT2(Y_f))          (co, n, n)
//
// What bounds it on the H100: the dense-DFT formulation the TPU used costs
// O(n^2) MACs per frequency and per channel; here both transforms are
// factorised into two 1-D passes (rows, then columns) with twiddles from a
// small cos/sin table, O(n) MACs per frequency.  What remains is the
// per-frequency mix, F*co*ci complex MACs per image against an operand Q of
// up to 5 MB at the flagship, read from L2, and the Y_f round trip through
// device memory between the two launches:
//   1. rdft_mix:  a block takes up to 8 images (as many as shared memory
//      holds), forward-transforms a chunk of their input channels in shared
//      memory, and accumulates the mix into Y (F, co) per image in shared
//      memory over the channel chunks; each read of Q serves every image of
//      the block.  Y is written to device memory.
//   2. irdft:     one block per image: the inverse column pass reads each Y
//      element once and keeps the n output rows in registers, then the
//      inverse row pass (real part) writes the output.
// Each output is summed by one thread in a fixed order (no atomics), so
// results are bit-reproducible from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsMix = 1024;  // rdft_mix: up to 64 registers a thread
constexpr int kThreadsInv = 512;   // irdft: n accumulator pairs a thread
constexpr int kMaxImg = 8;             // images sharing one read of Q
constexpr int kMaxN = 32;              // largest spatial size handled
constexpr size_t kSmemLimit = 232448;  // per-block dynamic shared memory

__global__ void __launch_bounds__(kThreadsMix)
rdft_mix_kernel(const float* __restrict__ x,    // (B, ci, n, n)
                const float* __restrict__ qr,   // (F, ci, co) Q^T, real
                const float* __restrict__ qi,   // (F, ci, co) Q^T, imag
                const float* __restrict__ tw,   // (2, n) cos, sin of 2 pi k/n
                float* __restrict__ yr,         // (B, F, co)
                float* __restrict__ yi,         // (B, F, co)
                int B, int ci, int co, int n, int nimg, int cc) {
  extern __shared__ float smem[];
  const int nf = n / 2 + 1, F = n * nf;
  float* cs = smem;                   // (n)
  float* sn = cs + n;                 // (n)
  float* accr = sn + n;               // (nimg, F, co)
  float* acci = accr + nimg * F * co;
  float* tr = acci + nimg * F * co;   // (nimg, cc, n, nf) row-pass result
  float* ti = tr + nimg * cc * F;
  float* xr = ti + nimg * cc * F;     // (nimg, cc, F) forward rDFT
  float* xi = xr + nimg * cc * F;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * nimg;
  const int nb = B - b0 < nimg ? B - b0 : nimg;

  for (int k = tid; k < n; k += kThreadsMix) {
    cs[k] = tw[k];
    sn[k] = tw[n + k];
  }
  for (int i = tid; i < nb * F * co; i += kThreadsMix) accr[i] = acci[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < ci; c0 += cc) {
    const int nc = ci - c0 < cc ? ci - c0 : cc;
    const int per_img = nc * F;
    // rows: T[m][c][i][g] = sum_j x[m][c][i][j] e^{-2 pi i g j / n}
    for (int idx = tid; idx < nb * per_img; idx += kThreadsMix) {
      const int g = idx % nf, i = (idx / nf) % n;
      const int c = (idx / F) % nc, m = idx / per_img;
      const float* row = x + (((size_t)(b0 + m) * ci + c0 + c) * n + i) * n;
      float ar = 0.f, ai = 0.f;
      for (int j = 0, k = 0; j < n; ++j) {
        const float v = __ldg(row + j);
        ar = fmaf(v, cs[k], ar);
        ai = fmaf(-v, sn[k], ai);
        k += g;
        if (k >= n) k -= n;
      }
      tr[idx] = ar;
      ti[idx] = ai;
    }
    __syncthreads();
    // columns: X[m][c][f][g] = sum_i e^{-2 pi i f i / n} T[m][c][i][g]
    for (int idx = tid; idx < nb * per_img; idx += kThreadsMix) {
      const int g = idx % nf, f = (idx / nf) % n;
      const int base = idx - (idx % F) + g;  // T[m][c][0][g]
      float ar = 0.f, ai = 0.f;
      for (int i = 0, k = 0; i < n; ++i) {
        const float vr = tr[base + i * nf], vi = ti[base + i * nf];
        ar += cs[k] * vr + sn[k] * vi;
        ai += cs[k] * vi - sn[k] * vr;
        k += f;
        if (k >= n) k -= n;
      }
      xr[idx] = ar;
      xi[idx] = ai;
    }
    __syncthreads();
    // mix: Y[m][q][o] += sum_c Q[q][o][c] X[m][c][q]; each read of Q
    // serves every image of the block; lanes over o
    for (int idx = tid; idx < F * co; idx += kThreadsMix) {
      const int o = idx % co, q = idx / co;
      const float* pr = qr + ((size_t)q * ci + c0) * co + o;
      const float* pi = qi + ((size_t)q * ci + c0) * co + o;
      float ar[kMaxImg], ai[kMaxImg];
#pragma unroll
      for (int m = 0; m < kMaxImg; ++m) {
        if (m < nb) {
          ar[m] = accr[m * F * co + idx];
          ai[m] = acci[m * F * co + idx];
        }
      }
      for (int c = 0; c < nc; ++c) {
        const float a = __ldg(pr + (size_t)c * co);
        const float bq = __ldg(pi + (size_t)c * co);
#pragma unroll
        for (int m = 0; m < kMaxImg; ++m) {
          if (m < nb) {
            const float vr = xr[m * per_img + c * F + q];
            const float vi = xi[m * per_img + c * F + q];
            ar[m] += a * vr - bq * vi;
            ai[m] += a * vi + bq * vr;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxImg; ++m) {
        if (m < nb) {
          accr[m * F * co + idx] = ar[m];
          acci[m * F * co + idx] = ai[m];
        }
      }
    }
    __syncthreads();
  }
  const size_t off = (size_t)b0 * F * co;
  for (int i = tid; i < nb * F * co; i += kThreadsMix) {
    yr[off + i] = accr[i];
    yi[off + i] = acci[i];
  }
}

__global__ void __launch_bounds__(kThreadsInv)
irdft_kernel(const float* __restrict__ yr,   // (B, F, co)
             const float* __restrict__ yi,   // (B, F, co)
             const float* __restrict__ tw,   // (2, n)
             float* __restrict__ out,        // (B, co, n, n)
             int co, int n) {
  extern __shared__ float smem[];
  const int nf = n / 2 + 1, F = n * nf;
  float* cs = smem;
  float* sn = cs + n;
  float* sr = sn + n;        // (n, nf, co) column-pass result
  float* si = sr + F * co;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int k = tid; k < n; k += kThreadsInv) {
    cs[k] = tw[k];
    sn[k] = tw[n + k];
  }
  __syncthreads();

  const float* yrb = yr + b * F * co;
  const float* yib = yi + b * F * co;
  // columns: S[a][g][o] = sum_f e^{+2 pi i a f / n} Y[f][g][o]; one thread
  // per (g, o) reads each Y element once and keeps all n rows a in registers
  for (int p = tid; p < nf * co; p += kThreadsInv) {
    const int o = p % co, g = p / co;
    float ar[kMaxN], ai[kMaxN];
#pragma unroll
    for (int a = 0; a < kMaxN; ++a) ar[a] = ai[a] = 0.f;
    for (int f = 0; f < n; ++f) {
      const size_t at = (size_t)(f * nf + g) * co + o;
      const float vr = __ldg(yrb + at), vi = __ldg(yib + at);
      int k = 0;  // (a * f) mod n
#pragma unroll
      for (int a = 0; a < kMaxN; ++a) {
        if (a < n) {
          ar[a] += cs[k] * vr - sn[k] * vi;
          ai[a] += cs[k] * vi + sn[k] * vr;
          k += f;
          if (k >= n) k -= n;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kMaxN; ++a) {
      if (a < n) {
        sr[(a * nf + g) * co + o] = ar[a];
        si[(a * nf + g) * co + o] = ai[a];
      }
    }
  }
  __syncthreads();
  // rows, real part, Hermitian weights: y[o][a][j] =
  //   sum_g w_g Re(e^{+2 pi i g j / n} S[a][g][o]) / n^2
  const float scale = 1.f / (float)(n * n);
  const int half = (n + 1) / 2;
  float* ob = out + b * co * n * n;
  for (int idx = tid; idx < co * n * n; idx += kThreadsInv) {
    const int j = idx % n, a = (idx / n) % n, o = idx / (n * n);
    float acc = 0.f;
    for (int g = 0, k = 0; g < nf; ++g) {
      const int at = (a * nf + g) * co + o;
      const float w = (g > 0 && g < half) ? 2.f : 1.f;
      acc += w * (cs[k] * sr[at] - sn[k] * si[at]);
      k += j;
      if (k >= n) k -= n;
    }
    ob[idx] = acc * scale;
  }
}

}  // namespace

extern "C" {

const char* fused_cayley_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers to contiguous float32 arrays:
// x (B, ci, n, n); qr, qi (F, ci, co) = Q transposed per frequency;
// tw (2, n) = cos, sin of 2 pi k / n; yr, yi (B, F, co) scratch;
// out (B, co, n, n).  Returns a cudaError_t (0 on success).
int fused_freq_apply_forward(const float* x, const float* qr, const float* qi,
                             const float* tw, float* yr, float* yi, float* out,
                             int B, int ci, int co, int n, void* stream) {
  if (B < 0 || ci < 1 || co < 1 || n < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t F = (size_t)n * (n / 2 + 1);
  // launch 1: nimg images per block, channels in chunks of cc; take the
  // most images that still leave room for a chunk of min(ci, 8) channels
  const size_t min_cc = ci < 8 ? ci : 8;
  size_t nimg = kMaxImg, base1 = 0, per_channel = 0;
  for (; nimg >= 1; nimg /= 2) {
    base1 = sizeof(float) * (2 * n + nimg * 2 * F * co);
    per_channel = sizeof(float) * nimg * 4 * F;
    if (base1 + min_cc * per_channel <= kSmemLimit) break;
  }
  if (nimg < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t cc = (kSmemLimit - base1) / per_channel;
  if (cc > (size_t)ci) cc = ci;
  const size_t smem1 = base1 + cc * per_channel;
  const size_t smem2 = sizeof(float) * (2 * n + 2 * F * co);
  if (smem2 > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      rdft_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid1 = static_cast<int>((B + nimg - 1) / nimg);
  rdft_mix_kernel<<<grid1, kThreadsMix, smem1, s>>>(
      x, qr, qi, tw, yr, yi, B, ci, co, n, static_cast<int>(nimg),
      static_cast<int>(cc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(irdft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  irdft_kernel<<<B, kThreadsInv, smem2, s>>>(yr, yi, tw, out, co, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
