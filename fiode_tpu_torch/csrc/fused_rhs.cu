// Fused ODE right-hand side (kernel K1), forward only.
//
// Replaces the Pallas kernel fiode_tpu/ops/fused_rhs.py::_make_pallas_forward.
// One RHS evaluation of the simplex dynamics per batch row:
//   z1 = relu(h W1^T + xc);  z2 = relu(z1 W2^T + b2);  f = z2 W3^T + b3
//   lower = -alpha_1 (exp(sigma_1 h) - 1)
//   [scale_nominal] f = (alpha_2 (1 - h) - lower) sigmoid(f) + lower
//   mu by a fixed-iteration bisection;  out = max(f - mu, lower)
//
// What bounds it on the H100: at the flagship (n = 10, mlp = 128) a row
// needs ~36 kFLOP against 200 bytes of h/xc/out, so the weights, not the
// rows, are the traffic that matters: W2 alone is 64 KB.  The design keeps
// all weights in shared memory for the life of a block and walks batch
// tiles of 32 rows with a grid-stride loop, so each block reads the weights
// from L2 once.  The three products are shared-memory bound (one broadcast
// load per FMA); the 30-step bisection is a serial chain per row and runs
// on one thread per row over the 10 real lanes (the TPU's 128-lane padding
// is gone).  Every output is summed by one thread in a fixed order, so
// results are bit-reproducible from run to run.  No fast-math: expf and an
// exact 1 / (1 + expf(-x)).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 32;      // batch rows per tile
constexpr int kThreads = 128;  // threads per block
constexpr int kMaxN = 32;      // largest simplex dimension handled

__global__ void __launch_bounds__(kThreads)
fused_rhs_kernel(const float* __restrict__ h, const float* __restrict__ xc,
                 const float* __restrict__ W1, const float* __restrict__ W2,
                 const float* __restrict__ W3, const float* __restrict__ b2,
                 const float* __restrict__ b3, float* __restrict__ out,
                 int B, int n, int m, float alpha_1, float sigma_1,
                 float alpha_2, int scale_nominal, int qp_iters) {
  extern __shared__ float smem[];
  const int ms = m + 1;              // padded stride of (rows, m) tiles
  float* w1t = smem;                 // (n, m)      W1 transposed
  float* w2t = w1t + n * m;          // (m, m)      W2 transposed
  float* w3s = w2t + m * m;          // (n, ms)     W3 rows
  float* b2s = w3s + n * ms;         // (m)
  float* b3s = b2s + m;              // (n)
  float* hs = b3s + n;               // (kRows, n)
  float* z1 = hs + kRows * n;        // (kRows, ms)
  float* z2 = z1 + kRows * ms;       // (kRows, ms)
  float* ft = z2 + kRows * ms;       // (kRows, n)
  const int tid = threadIdx.x;

  for (int i = tid; i < m * n; i += kThreads) {  // W1[j][k], i = j*n + k
    w1t[(i % n) * m + i / n] = W1[i];
  }
  for (int i = tid; i < m * m; i += kThreads) {  // W2[j][k], i = j*m + k
    w2t[(i % m) * m + i / m] = W2[i];
  }
  for (int i = tid; i < n * m; i += kThreads) {  // W3[c][k], i = c*m + k
    w3s[(i / m) * ms + i % m] = W3[i];
  }
  for (int i = tid; i < m; i += kThreads) b2s[i] = b2[i];
  for (int i = tid; i < n; i += kThreads) b3s[i] = b3[i];
  __syncthreads();

  const int n_tiles = (B + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    for (int i = tid; i < kRows * n; i += kThreads) {
      const int row = row0 + i / n;
      hs[i] = row < B ? h[(size_t)row0 * n + i] : 0.f;
    }
    __syncthreads();

    // z1 = relu(h W1^T + xc): thread j owns column j for all rows
    for (int j = tid; j < m; j += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < n; ++k) {
        const float w = w1t[k * m + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r * n + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        const float x = row < B ? xc[(size_t)row * m + j] : 0.f;
        z1[r * ms + j] = fmaxf(acc[r] + x, 0.f);
      }
    }
    __syncthreads();

    // z2 = relu(z1 W2^T + b2)
    for (int j = tid; j < m; j += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int k = 0; k < m; ++k) {
        const float w = w2t[k * m + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(z1[r * ms + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) z2[r * ms + j] = fmaxf(acc[r] + b2s[j], 0.f);
    }
    __syncthreads();

    // f = z2 W3^T + b3: one thread per (row, c) output
    for (int i = tid; i < kRows * n; i += kThreads) {
      const int r = i / n, c = i % n;
      float acc = 0.f;
      for (int k = 0; k < m; ++k) acc = fmaf(z2[r * ms + k], w3s[c * ms + k], acc);
      ft[i] = acc + b3s[c];
    }
    __syncthreads();

    // barrier, optional squash, and the bisection: one thread per row
    if (tid < kRows && row0 + tid < B) {
      const int row = row0 + tid;
      float lower[kMaxN], nom[kMaxN];
      float lo = INFINITY, hi = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxN; ++k) {
        if (k < n) {
          const float hk = hs[tid * n + k];
          const float lw = -alpha_1 * (expf(sigma_1 * hk) - 1.f);
          float f = ft[tid * n + k];
          if (scale_nominal) {
            const float up = alpha_2 * (1.f - hk);
            f = (up - lw) * (1.f / (1.f + expf(-f))) + lw;
          }
          lower[k] = lw;
          nom[k] = f;
          lo = fminf(lo, f);
          hi = fmaxf(hi, f - lw);
        }
      }
      for (int it = 0; it < qp_iters; ++it) {
        const float mid = 0.5f * (lo + hi);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxN; ++k) {
          if (k < n) s += fmaxf(nom[k] - mid, lower[k]);
        }
        if (s > 0.f) lo = mid;
        if (s < 0.f) hi = mid;
      }
      const float mu = 0.5f * (lo + hi);
#pragma unroll
      for (int k = 0; k < kMaxN; ++k) {
        if (k < n) out[(size_t)row * n + k] = fmaxf(nom[k] - mu, lower[k]);
      }
    }
    __syncthreads();  // hs and ft are rewritten by the next tile
  }
}

size_t smem_bytes(int n, int m) {
  const size_t ms = m + 1;
  return sizeof(float) * ((size_t)n * m + (size_t)m * m + n * ms + m + n +
                          (size_t)kRows * n * 2 + kRows * ms * 2);
}

}  // namespace

extern "C" {

const char* fused_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers to contiguous float32 arrays:
// h (B, n), xc (B, m), W1 (m, n), W2 (m, m), W3 (n, m), b2 (m), b3 (n),
// out (B, n).  Returns a cudaError_t (0 on success).
int fused_rhs_forward(const float* h, const float* xc, const float* W1,
                      const float* W2, const float* W3, const float* b2,
                      const float* b3, float* out, int B, int n, int m,
                      float alpha_1, float sigma_1, float alpha_2,
                      int scale_nominal, int qp_iters, void* stream) {
  if (B < 0 || n < 1 || n > kMaxN || m < 1 || qp_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      fused_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (B + kRows - 1) / kRows;
  const int grid = n_tiles < 2 * sms ? n_tiles : 2 * sms;
  fused_rhs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      h, xc, W1, W2, W3, b2, b3, out, B, n, m, alpha_1, sigma_1, alpha_2,
      scale_nominal, qp_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
