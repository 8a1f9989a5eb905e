// The interval QP of a CROWN chunk in one launch (kernel K5).
//
// K5 replaces no Pallas kernel: the JAX package leaves the interval QP
// (fiode_tpu/verify/ibp_qp.py::ibp_cbf_qp_band) to XLA, which fuses its
// bisection into a few loops on the TPU.  In PyTorch the same function is
// ~550 launches a call: for each cell and coordinate i it builds the box
// corner adversarial for f_i's lower bound and the one for its upper bound,
// two (N n, n) float32 tensors, and runs the cone projection's 30 halvings
// on each, every halving a subtraction, a maximum, a row sum and two
// selections over the whole tensor.  At a certify chunk's 131,072 cells
// that streams ~15 GB through device memory a call.
//
// For cell r, with the barrier lower(h) = -alpha_1 (exp(sigma_1 h) - 1)
// (decreasing in h), K5 computes what the plain chain computes:
//   projection (lower, i): nominal_j = ub_j, lower_j = lower(h_lb_j) for
//     j != i; nominal_i = lb_i, lower_i = lower(h_ub_i);
//   projection (upper, i): nominal_j = lb_j, lower_j = lower(h_ub_j) for
//     j != i; nominal_i = ub_i, lower_i = lower(h_lb_i);
//   each: the bracket lo = min(nominal), hi = max(nominal - lower), then
//   qp_iters halvings of s(mu) = sum_j max(nominal_j - mu, lower_j) (lo = mid
//   where s > 0, hi = mid where s < 0), mu = (lo + hi) / 2, and only the
//   diagonal max(nominal_i - mu, lower_i) is written, to f_lb or f_ub.
// Every operation is the plain chain's, in float32 and in the same order
// but the row sum's, which runs over j in increasing order here: expf at
// full precision (no fast math), maxima and minima that return NaN where
// either operand is NaN, as torch.maximum / amin / amax do.
//
// What bounds it on the H100.  A cell reads 4 n floats and writes 2 n, 24 n
// bytes (31.5 MB a chunk at n = 10, ~9 us at 3.35 TB/s); its 2 n projections
// of n lanes take 3 operations a lane and halving, 18,000 a cell at n = 10
// and 30 halvings (2.36 G a chunk, ~35 us at 67 TFLOP/s counted as the
// float32 rate).  None of them is a fused multiply-add, so one warp
// instruction an operation and the issue rate bound it: ~85-95 us a chunk.
// The design keeps every row in registers and issues nothing else in the
// halvings:
// * A block of 128 threads stages its 128 cells' four inputs through shared
//   memory with coalesced loads, the two h arrays through the barrier on the
//   way (2 n expf a cell, each once), and stages its outputs back the same
//   way.
// * A thread owns a cell: its 4 n values in registers, from which every
//   projection's row is a choice made at compile time, and the 2 n brackets,
//   halved side by side (2 n independent chains of work for the scheduler).
//   96 registers at n = 10, no spills.  A thread per (cell, projection), 16
//   cells a block, each thread's row built from shared memory once, took
//   0.150 ms a chunk of 131,072 cells against this layout's 0.122.
// Rows past N compute on zeros and store nothing.
#include <cuda_runtime.h>

#include <cmath>

#ifndef FIODE_QP_N
#define FIODE_QP_N 10
#endif

namespace {

constexpr int KN = FIODE_QP_N;      // the state width
constexpr int kProj = 2 * KN;       // projections a cell
constexpr int kCells = 128;         // cells a block, a thread each
constexpr int kStride = KN % 2 == 1 ? KN : KN + 1;  // a staged row (odd)
static_assert(KN >= 1 && 4 * kCells * kStride * 4 <= 48 * 1024,
              "FIODE_QP_N out of range");

// NaN where either operand is NaN (PTX's max.NaN / min.NaN, sm_80 on)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Args {
  const float* h_lb;
  const float* h_ub;
  const float* lb;
  const float* ub;
  float* f_lb;
  float* f_ub;
  long long N;
  float alpha_1, sigma_1;
  int qp_iters;
};

// Staged per block: [0] lower(h_lb), [1] lower(h_ub), [2] lb, [3] ub, each
// kCells rows of kStride floats (odd: a thread's row is conflict-free); the
// outputs reuse [0] and [1].
struct Tile {
  float v[4][kCells][kStride];
};

// Projection k of a cell (k < n: f_k's lower bound; else f_{k-n}'s upper
// bound): its nominals and barriers, from the cell's values b[w][j] of
// input w (0: lower(h_lb), 1: lower(h_ub), 2: lb, 3: ub).
__device__ __forceinline__ void build_row(const float (&b)[4][KN], int k,
                                          float (&nom)[KN],
                                          float (&low)[KN]) {
  const bool up = k >= KN;
  const int i = up ? k - KN : k;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    const bool self = j == i;
    // lower bound: the others' nominal at ub and h at h_lb, i's at lb and
    // h_ub; the upper bound the other way round
    nom[j] = b[self != up ? 2 : 3][j];
    low[j] = b[self != up ? 1 : 0][j];
  }
}

__device__ __forceinline__ void bracket(const float (&nom)[KN],
                                        const float (&low)[KN], float& lo,
                                        float& hi) {
  lo = nom[0];
  hi = nom[0] - low[0];
#pragma unroll
  for (int j = 1; j < KN; ++j) {
    lo = min_nan(lo, nom[j]);
    hi = max_nan(hi, nom[j] - low[j]);
  }
}

// One halving of [lo, hi]: the sign of s at the midpoint picks the half.
__device__ __forceinline__ void halve(const float (&nom)[KN],
                                      const float (&low)[KN], float& lo,
                                      float& hi) {
  const float mid = 0.5f * (lo + hi);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KN; ++j) s += max_nan(nom[j] - mid, low[j]);
  if (s > 0.f) lo = mid;
  if (s < 0.f) hi = mid;
}

// The projection's diagonal: max(nominal_i - mu, lower_i), mu the midpoint of
// the last bracket.
__device__ __forceinline__ float diagonal(const float (&nom)[KN],
                                          const float (&low)[KN], float lo,
                                          float hi, int i) {
  const float mu = 0.5f * (lo + hi);
  return max_nan(nom[i] - mu, low[i]);
}

__global__ void __launch_bounds__(kCells)
fused_cone_qp_kernel(const Args a) {
  __shared__ Tile tile;
  const long long cell0 = static_cast<long long>(blockIdx.x) * kCells;
  const long long total = a.N * KN;
  // stage: the block's cells of each input, coalesced; h through the barrier
  for (int q = threadIdx.x; q < 4 * kCells * KN; q += kCells) {
    const int w = q / (kCells * KN), e = q % (kCells * KN);
    const long long g = cell0 * KN + e;
    const float* src = w == 0 ? a.h_lb : w == 1 ? a.h_ub : w == 2 ? a.lb : a.ub;
    float v = g < total ? __ldg(src + g) : 0.f;
    if (w < 2) v = -a.alpha_1 * (expf(a.sigma_1 * v) - 1.f);
    tile.v[w][e / KN][e % KN] = v;
  }
  __syncthreads();

  // the cell's 4 n values in registers; k is known at compile time in every
  // loop below, so each row is a choice among them, not a copy
  const int c = threadIdx.x;
  float b[4][KN];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int j = 0; j < KN; ++j) b[w][j] = tile.v[w][c][j];
  }
  float lo[kProj], hi[kProj];
#pragma unroll
  for (int k = 0; k < kProj; ++k) {
    float nom[KN], low[KN];
    build_row(b, k, nom, low);
    bracket(nom, low, lo[k], hi[k]);
  }
  for (int it = 0; it < a.qp_iters; ++it) {
#pragma unroll
    for (int k = 0; k < kProj; ++k) {
      float nom[KN], low[KN];
      build_row(b, k, nom, low);
      halve(nom, low, lo[k], hi[k]);
    }
  }
  __syncthreads();  // every cell is read: the outputs take its place
#pragma unroll
  for (int k = 0; k < kProj; ++k) {
    float nom[KN], low[KN];
    build_row(b, k, nom, low);
    const int i = k >= KN ? k - KN : k;
    tile.v[k >= KN][c][i] = diagonal(nom, low, lo[k], hi[k], i);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 2 * kCells * KN; q += kCells) {
    const int w = q / (kCells * KN), e = q % (kCells * KN);
    const long long g = cell0 * KN + e;
    if (g < total) (w == 0 ? a.f_lb : a.f_ub)[g] = tile.v[w][e / KN][e % KN];
  }
}

}  // namespace

extern "C" {

const char* fused_qp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The state width this library was built for.
int fused_qp_width() { return KN; }

// All pointers are device pointers to contiguous float32 (N, n) arrays.
// Returns a cudaError_t (0 on success).
int fused_cone_qp_bounds(const float* h_lb, const float* h_ub, const float* lb,
                         const float* ub, float alpha_1, float sigma_1,
                         int qp_iters, float* f_lb, float* f_ub, long long N,
                         void* stream) {
  if (N < 0 || qp_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const Args a{h_lb, h_ub, lb, ub, f_lb, f_ub, N, alpha_1, sigma_1, qp_iters};
  const long long blocks = (N + kCells - 1) / kCells;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_cone_qp_kernel<<<static_cast<unsigned>(blocks), kCells, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
