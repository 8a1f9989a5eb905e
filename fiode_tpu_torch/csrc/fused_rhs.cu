// Fused ODE right-hand side: forward (kernel K1) and backward (kernel K2).
//
// K1 replaces the Pallas kernel
// fiode_tpu/ops/fused_rhs.py::_make_pallas_forward.  One RHS evaluation of
// the simplex dynamics per batch row:
//   z1 = relu(h W1^T + xc);  z2 = relu(z1 W2^T + b2);  f = z2 W3^T + b3
//   lower = -alpha_1 (exp(sigma_1 h) - 1)
//   [scale_nominal] f = (alpha_2 (1 - h) - lower) sigmoid(f) + lower
//   mu by a fixed-iteration bisection;  out = max(f - mu, lower)
//
// K2 replaces fiode_tpu/ops/fused_rhs.py::_make_pallas_backward (the VJP,
// which the TPU kernel had for scale_nominal off; here also for the squash).
// Per row it recomputes the forward with K1's own device code (same fmaf
// order, same bisection), so mu and therefore the active set are
// bit-identical to the forward's, then applies
//   d f     = free (g - mean_free g),  d lower = active (g - mean_free g)
//   [scale_nominal, f = (u - lower) s + lower, s = sigmoid(f~),
//    u = alpha_2 (1 - h)]
//           d f~ = d f (u - lower) s (1 - s),  d lower += d f (1 - s),
//           d u = d f s;   otherwise d f~ = d f, d u = 0
//   d pre2  = (d f~ W3) [z2 > 0];      d pre1 = (d pre2 W2) [z1 > 0]
//   dh      = d lower (-alpha_1 sigma_1 exp(sigma_1 h)) - alpha_2 d u
//             + d pre1 W1
//   dxc     = d pre1
// and, when asked, the weight gradients summed over the batch:
//   dW1 = d pre1^T h, dW2 = d pre2^T z1, dW3 = d f~^T z2, db2, db3.
//
// What bounds them on the H100: at the flagship (n = 10, mlp = 128) a row
// needs ~36 kFLOP forward (~110 kFLOP backward with weight gradients)
// against ~200 bytes of h/xc/g/out, so the weights, not the rows, are the
// traffic that matters: W2 alone is 64 KB.  Both kernels keep all weights in
// shared memory for the life of a block and walk batch tiles of 32 rows with
// a grid-stride loop, so each block reads the weights from L2 once.  The
// products are shared-memory bound (one broadcast load per FMA); the 30-step
// bisection is a serial chain per row and runs on one thread per row over the
// n real lanes (the TPU's 128-lane padding is gone).  The transposed weights
// use a padded stride (m + 1) so that both the forward (lanes over output
// columns) and the backward (lanes over input columns) read them without
// bank conflicts.
//
// Determinism: every output is summed by one thread in a fixed order.  The
// TPU kernel accumulated weight gradients with += across its sequential grid;
// here blocks run concurrently, so each block sums its own tiles into a
// partial (fixed tile and row order) in its own workspace slot in device
// memory (132 slots of 76 KB at the flagship, which fit in L2), and a second
// launch adds the slots in slot order.  Each tile's rows are summed first
// and the slot's value, read before that sum, is added to it.  Shared memory
// then holds only the weights and the tile scratch, at every shape that fits
// at all.  No atomics, so results are bit-reproducible from run to run on
// one card.  No fast-math: expf and an exact 1 / (1 + expf(-x)).
//
// The squash is a template parameter of K2, so the certified dynamics'
// path (squash off) compiles as if it did not exist.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 32;      // batch rows per tile
constexpr int kThreads = 128;  // threads per block
constexpr int kMaxN = 32;      // largest simplex dimension handled
constexpr int kReduceThreads = 256;
constexpr size_t kSmemLimit = 232448;  // per-block dynamic shared memory

// Shared-memory layout of the weights, ms = m + 1:
//   w1t (n, ms)  w1t[k*ms + j] = W1[j][k]
//   w2t (m, ms)  w2t[k*ms + j] = W2[j][k]
//   w3s (n, ms)  w3s[c*ms + k] = W3[c][k]
//   b2s (m), b3s (n)
struct Weights {
  float* w1t;
  float* w2t;
  float* w3s;
  float* b2s;
  float* b3s;
};

// One batch tile of forward intermediates: hs (kRows, n), z1 and z2
// (kRows, ms), ft (kRows, n) = the unprojected f.
struct Tile {
  float* hs;
  float* z1;
  float* z2;
  float* ft;
};

__host__ __device__ size_t weights_floats(int n, int m) {
  const size_t ms = m + 1;
  return (size_t)n * ms + (size_t)m * ms + (size_t)n * ms + m + n;
}

__host__ __device__ size_t tile_floats(int n, int m) {
  const size_t ms = m + 1;
  return (size_t)kRows * n * 2 + (size_t)kRows * ms * 2;
}

__device__ float* carve(float* p, int n, int m, Weights& w, Tile& t) {
  const int ms = m + 1;
  w.w1t = p;
  w.w2t = w.w1t + n * ms;
  w.w3s = w.w2t + m * ms;
  w.b2s = w.w3s + n * ms;
  w.b3s = w.b2s + m;
  t.hs = w.b3s + n;
  t.z1 = t.hs + kRows * n;
  t.z2 = t.z1 + kRows * ms;
  t.ft = t.z2 + kRows * ms;
  return t.ft + kRows * n;
}

__device__ void load_weights(const float* __restrict__ W1,
                             const float* __restrict__ W2,
                             const float* __restrict__ W3,
                             const float* __restrict__ b2,
                             const float* __restrict__ b3, int n, int m,
                             const Weights& w) {
  const int ms = m + 1;
  const int tid = threadIdx.x;
  for (int i = tid; i < m * n; i += kThreads) {  // W1[j][k], i = j*n + k
    w.w1t[(i % n) * ms + i / n] = W1[i];
  }
  for (int i = tid; i < m * m; i += kThreads) {  // W2[j][k], i = j*m + k
    w.w2t[(i % m) * ms + i / m] = W2[i];
  }
  for (int i = tid; i < n * m; i += kThreads) {  // W3[c][k], i = c*m + k
    w.w3s[(i / m) * ms + i % m] = W3[i];
  }
  for (int i = tid; i < m; i += kThreads) w.b2s[i] = b2[i];
  for (int i = tid; i < n; i += kThreads) w.b3s[i] = b3[i];
}

// hs, z1, z2 and ft of the tile at row0; rows past B are zero inputs.  Ends
// synchronised: every thread may read the whole tile afterwards.
__device__ void forward_tile(const float* __restrict__ h,
                             const float* __restrict__ xc, int row0, int B,
                             int n, int m, const Weights& w, const Tile& t) {
  const int ms = m + 1;
  const int tid = threadIdx.x;
  for (int i = tid; i < kRows * n; i += kThreads) {
    const int row = row0 + i / n;
    t.hs[i] = row < B ? h[(size_t)row0 * n + i] : 0.f;
  }
  __syncthreads();

  // z1 = relu(h W1^T + xc): thread j owns column j for all rows
  for (int j = tid; j < m; j += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < n; ++k) {
      const float wv = w.w1t[k * ms + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(t.hs[r * n + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const float x = row < B ? xc[(size_t)row * m + j] : 0.f;
      t.z1[r * ms + j] = fmaxf(acc[r] + x, 0.f);
    }
  }
  __syncthreads();

  // z2 = relu(z1 W2^T + b2)
  for (int j = tid; j < m; j += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < m; ++k) {
      const float wv = w.w2t[k * ms + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(t.z1[r * ms + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) t.z2[r * ms + j] = fmaxf(acc[r] + w.b2s[j], 0.f);
  }
  __syncthreads();

  // f = z2 W3^T + b3: one thread per (row, c) output
  for (int i = tid; i < kRows * n; i += kThreads) {
    const int r = i / n, c = i % n;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc = fmaf(t.z2[r * ms + k], w.w3s[c * ms + k], acc);
    t.ft[i] = acc + w.b3s[c];
  }
  __syncthreads();
}

// Barrier, optional squash and the bisection for one row: fills lower and
// nom (the projection's inputs) and returns mu; the projected output is
// max(nom - mu, lower).
__device__ __forceinline__ float project_row(
    const float* hr, const float* fr, int n, float alpha_1, float sigma_1,
    float alpha_2, int scale_nominal, int qp_iters, float (&lower)[kMaxN],
    float (&nom)[kMaxN]) {
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxN; ++k) {
    if (k < n) {
      const float hk = hr[k];
      const float lw = -alpha_1 * (expf(sigma_1 * hk) - 1.f);
      float f = fr[k];
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
  return 0.5f * (lo + hi);
}

__global__ void __launch_bounds__(kThreads)
fused_rhs_kernel(const float* __restrict__ h, const float* __restrict__ xc,
                 const float* __restrict__ W1, const float* __restrict__ W2,
                 const float* __restrict__ W3, const float* __restrict__ b2,
                 const float* __restrict__ b3, float* __restrict__ out,
                 int B, int n, int m, float alpha_1, float sigma_1,
                 float alpha_2, int scale_nominal, int qp_iters) {
  extern __shared__ float smem[];
  Weights w;
  Tile t;
  carve(smem, n, m, w, t);
  const int tid = threadIdx.x;
  load_weights(W1, W2, W3, b2, b3, n, m, w);
  __syncthreads();

  const int n_tiles = (B + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    forward_tile(h, xc, row0, B, n, m, w, t);
    if (tid < kRows && row0 + tid < B) {
      float lower[kMaxN], nom[kMaxN];
      const float mu = project_row(t.hs + tid * n, t.ft + tid * n, n, alpha_1,
                                   sigma_1, alpha_2, scale_nominal, qp_iters,
                                   lower, nom);
      const size_t row = row0 + tid;
#pragma unroll
      for (int k = 0; k < kMaxN; ++k) {
        if (k < n) out[row * n + k] = fmaxf(nom[k] - mu, lower[k]);
      }
    }
    __syncthreads();  // hs and ft are rewritten by the next tile
  }
}

// Floats of the weight gradients dW1 (m, n), dW2 (m, m), dW3 (n, m),
// db2 (m), db3 (n), laid out as the output and as one workspace slot.
__host__ __device__ size_t grad_floats(int n, int m) {
  return (size_t)m * n + (size_t)m * m + (size_t)n * m + m + n;
}

template <bool kSquash>
__global__ void __launch_bounds__(kThreads)
fused_rhs_backward_kernel(
    const float* __restrict__ h, const float* __restrict__ xc,
    const float* __restrict__ g, const float* __restrict__ W1,
    const float* __restrict__ W2, const float* __restrict__ W3,
    const float* __restrict__ b2, const float* __restrict__ b3,
    float* __restrict__ dh, float* __restrict__ dxc, float* __restrict__ ws,
    int B, int n, int m, float alpha_1, float sigma_1, float alpha_2,
    int qp_iters, int weight_grads) {
  extern __shared__ float smem[];
  const int ms = m + 1;
  const int tid = threadIdx.x;
  Weights w;
  Tile t;
  float* p = carve(smem, n, m, w, t);
  float* dft = p;                 // d f~ (kRows, n)
  float* dhb = dft + kRows * n;   // barrier part of dh (kRows, n)
  float* dp2 = dhb + kRows * n;   // d pre2 (kRows, ms)
  float* dp1 = t.z2;              // d pre1 overwrites z2 once dW3 is taken
  const int wlen = static_cast<int>(grad_floats(n, m));
  // this block's partial sums, in its own slot
  float* pw1 = ws + (size_t)blockIdx.x * wlen;
  float* pw2 = pw1 + m * n;
  float* pw3 = pw2 + m * m;
  float* pb2 = pw3 + n * m;
  float* pb3 = pb2 + m;

  load_weights(W1, W2, W3, b2, b3, n, m, w);
  if (weight_grads) {
    for (int i = tid; i < wlen; i += kThreads) pw1[i] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (B + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int nr = B - row0 < kRows ? B - row0 : kRows;
    forward_tile(h, xc, row0, B, n, m, w, t);

    // projection VJP on the forward's active set: one thread per row
    if (tid < kRows) {
      const int r = tid;
      if (r < nr) {
        float lower[kMaxN], nom[kMaxN];
        const float mu = project_row(t.hs + r * n, t.ft + r * n, n, alpha_1,
                                     sigma_1, alpha_2, kSquash, qp_iters,
                                     lower, nom);
        const float* gr = g + (size_t)(row0 + r) * n;
        float gsum = 0.f;
        int n_free = 0;
#pragma unroll
        for (int k = 0; k < kMaxN; ++k) {
          if (k < n && !((nom[k] - mu) < lower[k])) {
            gsum += gr[k];
            ++n_free;
          }
        }
        const float corr = gsum / fmaxf((float)n_free, 1.f);
#pragma unroll
        for (int k = 0; k < kMaxN; ++k) {
          if (k < n) {
            const bool active = (nom[k] - mu) < lower[k];
            const float d = gr[k] - corr;
            const float hk = t.hs[r * n + k];
            const float df = active ? 0.f : d;  // d of the nominal f
            float dl = active ? d : 0.f;        // d of lower
            float dft_k = df, du = 0.f;
            if constexpr (kSquash) {
              const float sg = 1.f / (1.f + expf(-t.ft[r * n + k]));
              const float up = alpha_2 * (1.f - hk);
              dft_k = df * (up - lower[k]) * sg * (1.f - sg);
              dl += df * (1.f - sg);
              du = df * sg;
            }
            dft[r * n + k] = dft_k;
            dhb[r * n + k] =
                dl * (-alpha_1 * sigma_1 * expf(sigma_1 * hk)) - alpha_2 * du;
          }
        }
      } else {
        for (int k = 0; k < n; ++k) dft[r * n + k] = dhb[r * n + k] = 0.f;
      }
    }
    __syncthreads();

    // d pre2 = (d f~ W3) [z2 > 0]: thread j owns column j for all rows
    for (int j = tid; j < m; j += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int c = 0; c < n; ++c) {
        const float wv = w.w3s[c * ms + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dft[r * n + c], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        dp2[r * ms + j] = t.z2[r * ms + j] > 0.f ? acc[r] : 0.f;
      }
    }
    __syncthreads();

    if (weight_grads) {
      // dW3[c][j] += sum_r d f~[r][c] z2[r][j];  db3, db2: row sums.  The
      // slot's value is read before the tile's sum, which hides its latency.
      for (int i = tid; i < n * m; i += kThreads) {
        const int c = i / m, j = i % m;
        const float prev = pw3[i];
        float acc = 0.f;
        for (int r = 0; r < nr; ++r) acc = fmaf(dft[r * n + c], t.z2[r * ms + j], acc);
        pw3[i] = prev + acc;
      }
      for (int j = tid; j < m; j += kThreads) {
        const float prev = pb2[j];
        float acc = 0.f;
        for (int r = 0; r < nr; ++r) acc += dp2[r * ms + j];
        pb2[j] = prev + acc;
      }
      for (int c = tid; c < n; c += kThreads) {
        const float prev = pb3[c];
        float acc = 0.f;
        for (int r = 0; r < nr; ++r) acc += dft[r * n + c];
        pb3[c] = prev + acc;
      }
    }
    __syncthreads();  // z2 is overwritten by d pre1 below

    // d pre1 = (d pre2 W2) [z1 > 0]: thread k owns column k; W2[j][k] is
    // w2t[k*ms + j], conflict-free across k thanks to the padded stride
    for (int k = tid; k < m; k += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int j = 0; j < m; ++j) {
        const float wv = w.w2t[k * ms + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dp2[r * ms + j], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = t.z1[r * ms + k] > 0.f ? acc[r] : 0.f;
        dp1[r * ms + k] = v;
        if (r < nr) dxc[(size_t)(row0 + r) * m + k] = v;
      }
    }
    __syncthreads();

    if (weight_grads) {
      // dW2[j][k] += sum_r d pre2[r][j] z1[r][k]
      for (int i = tid; i < m * m; i += kThreads) {
        const int j = i / m, k = i % m;
        const float prev = pw2[i];
        float acc = 0.f;
        for (int r = 0; r < nr; ++r) acc = fmaf(dp2[r * ms + j], t.z1[r * ms + k], acc);
        pw2[i] = prev + acc;
      }
      // dW1[k][c] += sum_r d pre1[r][k] h[r][c]
      for (int i = tid; i < m * n; i += kThreads) {
        const int k = i / n, c = i % n;
        const float prev = pw1[i];
        float acc = 0.f;
        for (int r = 0; r < nr; ++r) acc = fmaf(dp1[r * ms + k], t.hs[r * n + c], acc);
        pw1[i] = prev + acc;
      }
    }

    // dh = barrier part + d pre1 W1: one thread per (row, c)
    for (int i = tid; i < nr * n; i += kThreads) {
      const int r = i / n, c = i % n;
      float acc = 0.f;
      for (int k = 0; k < m; ++k) acc = fmaf(dp1[r * ms + k], w.w1t[c * ms + k], acc);
      dh[(size_t)row0 * n + i] = dhb[i] + acc;
    }
    __syncthreads();  // the next tile rewrites every tile buffer
  }
}

// out[i] = sum over slots s = 0, 1, ... of ws[s][i], in slot order
__global__ void __launch_bounds__(kReduceThreads)
reduce_slots_kernel(const float* __restrict__ ws, int n_slots, int len,
                    float* __restrict__ out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int s = 0; s < n_slots; ++s) acc += ws[(size_t)s * len + i];
  out[i] = acc;
}

size_t forward_smem_bytes(int n, int m) {
  return sizeof(float) * (weights_floats(n, m) + tile_floats(n, m));
}

size_t backward_smem_bytes(int n, int m) {
  const size_t ms = m + 1;
  return sizeof(float) * (weights_floats(n, m) + tile_floats(n, m) +
                          (size_t)kRows * n * 2 + (size_t)kRows * ms);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

}  // namespace

extern "C" {

const char* fused_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory a block of K1 (backward = 0) or K2 (backward = 1) needs,
// and the most a block may have.  A shape needing more is refused.
long long fused_rhs_smem_bytes(int n, int m, int backward) {
  return static_cast<long long>(backward ? backward_smem_bytes(n, m)
                                         : forward_smem_bytes(n, m));
}

long long fused_rhs_smem_limit() { return static_cast<long long>(kSmemLimit); }

// Floats in one weight-gradient slot (and in the packed weight-gradient
// output): dW1 (m, n), dW2 (m, m), dW3 (n, m), db2 (m), db3 (n).
int fused_rhs_grad_floats(int n, int m) {
  return static_cast<int>(grad_floats(n, m));
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
  const size_t smem = forward_smem_bytes(n, m);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int n_tiles = (B + kRows - 1) / kRows;
  const int grid = n_tiles < 2 * sms ? n_tiles : 2 * sms;
  fused_rhs_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      h, xc, W1, W2, W3, b2, b3, out, B, n, m, alpha_1, sigma_1, alpha_2,
      scale_nominal, qp_iters);
  return static_cast<int>(cudaGetLastError());
}

// VJP of fused_rhs_forward for the cotangent g (B, n):
// writes dh (B, n) and dxc (B, m).  If dw is not null it also writes the
// weight gradients packed as [dW1 (m, n) | dW2 (m, m) | dW3 (n, m) | db2 (m)
// | db3 (n)], using ws (ws_slots slots of fused_rhs_grad_floats(n, m)
// floats; one slot per block, at most one block per SM) as scratch.
// Returns a cudaError_t (0 on success).
int fused_rhs_backward(const float* h, const float* xc, const float* g,
                       const float* W1, const float* W2, const float* W3,
                       const float* b2, const float* b3, float* dh, float* dxc,
                       float* dw, float* ws, int ws_slots, int B, int n, int m,
                       float alpha_1, float sigma_1, float alpha_2,
                       int scale_nominal, int qp_iters, void* stream) {
  if (B < 0 || n < 1 || n > kMaxN || m < 1 || qp_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int weight_grads = dw != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wlen = static_cast<int>(grad_floats(n, m));
  if (B == 0) {
    if (!weight_grads) return 0;
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)wlen, s));
  }
  const size_t smem = backward_smem_bytes(n, m);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const int n_tiles = (B + kRows - 1) / kRows;
  const int grid = n_tiles < sms ? n_tiles : sms;
  if (weight_grads && (ws == nullptr || ws_slots < grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = scale_nominal ? fused_rhs_backward_kernel<true>
                                    : fused_rhs_backward_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(h, xc, g, W1, W2, W3, b2, b3, dh, dxc,
                                      ws, B, n, m, alpha_1, sigma_1, alpha_2,
                                      qp_iters, weight_grads);
  err = cudaGetLastError();
  if (err != cudaSuccess || !weight_grads) return static_cast<int>(err);
  const int rgrid = (wlen + kReduceThreads - 1) / kReduceThreads;
  reduce_slots_kernel<<<rgrid, kReduceThreads, 0, s>>>(ws, grid, wlen, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
