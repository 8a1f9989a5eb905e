// Fused CROWN bounds of the three-layer ReLU dynamics twin (kernel K4).
//
// K4 replaces no Pallas kernel: the JAX package leaves CROWN
// (fiode_tpu/verify/crown.py::crown_mlp_bounds) to XLA, which fuses the
// elementwise passes into the products on the TPU.  In PyTorch the same
// chain is a few dozen launches, and each of layers 2 and 3 builds per-row
// linear forms of shape (rows, n, mlp) in float32 that every clamp, product,
// bias contraction and concretisation streams through device memory once
// more: at a certify chunk's 131,072 rows that is ~0.7 GB a tensor.  K4
// carries out the whole chain for each row with every linear form in
// registers and shared memory, and writes only (lb, ub).
//
// For each row (eta (n), x_bias (m1), eps scalar or (n)), the chain of
// verify/crown.py (its m2 >= n branch at layer 2):
//   layer 1  z1 = eta W1^T + b1 + x_bias +- radius; ReLU relaxation
//            (chord upper line; lower slope 1[u >= -l], or alpha-CROWN's
//            clamped override; stable neurons exact)
//   layer 2  s = (u + l)(b) W2^T, d = (u - l)(b) |W2|^T on the relu lines
//            at the bias point, S = (a_up + a_lo) W1^T . W2^T,
//            D = (a_up - a_lo) W1^T . |W2|^T, then the concretisation of
//            Lu = (S + D) / 2, Ll = (S - D) / 2 over the eta box; relaxation
//   layer 3  W3 split by sign against layer 2's slopes, its bias terms,
//            . W2, the split against layer 1's slopes, the bias terms with
//            b1 + x_bias, . W1, and the concretisation.
// Every product is fp32 FFMA.  No TF32 and no fast-math: float32_matmuls()
// does not reach this kernel, and its bounds are float32 whatever it says.
//
// What bounds it on the H100.  A row reads n etas (and n eps), its image's
// x_bias (m1) and writes 2 out bounds, ~600 bytes, for ~1.4 MFLOP at the
// flagship (n = 10, m1 = m2 = 128, out = 10) if every neuron counted: four
// products of a per-row (10 x 128) operand with the shared 128 x 128 W2 or
// |W2|.  That is 187 GFLOP a chunk of 131,072 rows, 2.8 ms at the 67
// TFLOP/s float32 rate: bound by arithmetic by three orders of magnitude.
// But a neuron that is off on the whole box (u <= 0) has zero slopes and
// adds nothing, and only an unstable one has a_up != a_lo: on the certify
// grid about half the neurons of each layer are off and 4-5% unstable.  So
// each product runs over a row's list of the neurons that add to it (S and
// s: every neuron not off; D and d: the unstable ones), in increasing
// order: the sums are those of the dense loop with its exact zeros left
// out, bit for bit, and the work is about a third.
//
// * A block walks tiles of 16 rows with 256 threads: the 16 threads of a
//   half-warp own one row, thread t the columns t, t + 16, ... of a layer
//   (C1 = m1 / 16, C2 = m2 / 16 of them).  In layer 2 a thread keeps S and
//   D for all n eta slots of its C2 outputs, so the concretisation's sums
//   over the eta axis are its own epilogue; in layer 3 it keeps the two
//   (out x C1) forms of its columns.  That is (2 n + 2) C2 = 176 and
//   2 out C1 = 160 accumulators at the flagship: one block of 8 warps a SM,
//   255 registers a thread, ~0.4 KB of other values spilled.  (A warp a
//   row, 4 columns a lane and 8-16 warps a SM ran 15-36% slower: its
//   per-row sums over 32 lanes cost more than the warps hid.)  The two rows
//   of a warp walk their own lists side by side, to the longer one's end
//   (the shorter adds zeros), each reading its next index ahead; layer 3's
//   loops are unrolled four times.
// * The lists are made where the slopes are (a ballot over the row's lanes
//   per column, so in increasing neuron order) and kept in shared memory
//   beside a row's staged slopes: layer 1's (a_up + a_lo, a_up - a_lo,
//   u + l, u - l at the bias point) for layer 2's products and (a_up,
//   a_lo, b_up, b1 + x_bias) for layer 3's last split, layer 2's (a_up +
//   a_lo, a_up - a_lo) and (a_up, a_lo, b_up, b2).  Layer 3 takes the sign
//   split of W3 in the same factored form as layer 2: Lu2 = (W3 (a_up +
//   a_lo) + |W3| (a_up - a_lo)) / 2 is W3+ a_up + W3- a_lo, so its product
//   with W2 is two scaled products summed after the loops.
// * The weights sit in shared memory for a block's whole walk, loaded once
//   (the grid holds one block per SM, each walking many tiles).  W2 is kept
//   once, row-major with an odd row stride m1 + 1: layer 2 reads a column
//   (W2[t + 16 c][i] for fixed i) and layer 3 a row (W2[i][t + 16 c]), both
//   without bank conflicts; |W2| is taken on load into the register.  A row
//   of W1 (an odd multiple of 4 floats) and of W3^T and |W3|^T are float4
//   reads.
// * What a row's 16 threads hold in parts (layer 3's bias terms and last
//   product, summed over their own columns) is added by four
//   __shfl_xor_sync within the half-warp, the same sum bit for bit in all
//   sixteen lanes.
// * x_bias is read per row with a row stride (0 for one shared bias); the
//   per-row eps and alpha-CROWN's slopes are template variants.  Columns
//   past m1 or m2 are zero padded and left out of the lists.  Rows past N
//   compute on zeros and store nothing.
#include <cuda_runtime.h>

#include <cmath>

#ifndef FIODE_CROWN_N
#define FIODE_CROWN_N 10
#endif
#ifndef FIODE_CROWN_M1
#define FIODE_CROWN_M1 128
#endif
#ifndef FIODE_CROWN_M2
#define FIODE_CROWN_M2 128
#endif
#ifndef FIODE_CROWN_OUT
#define FIODE_CROWN_OUT 10
#endif

namespace {

constexpr int KN = FIODE_CROWN_N;     // the eta axis (state width)
constexpr int M1 = FIODE_CROWN_M1;    // layer 1's width
constexpr int M2 = FIODE_CROWN_M2;    // layer 2's width
constexpr int OUT = FIODE_CROWN_OUT;  // layer 3's width
// layer 3's loops over the lists are unrolled 4 times (its accumulators
// leave room for it; layer 2's do not)
constexpr int kUnroll3 = 4;
constexpr int kLanes = 16;            // threads of a row
constexpr int kRows = 16;             // rows of a tile
constexpr int kThreads = kLanes * kRows;
constexpr int C1 = (M1 + kLanes - 1) / kLanes;  // layer-1 columns a thread
constexpr int C2 = (M2 + kLanes - 1) / kLanes;  // layer-2 columns a thread
constexpr int M1P = kLanes * C1, M2P = kLanes * C2;
constexpr int P2 = M1P + 1;   // row stride of W2 (odd)
constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// row stride of W1: an odd multiple of 4 floats, read as float4
constexpr int S1 = round4(KN) / 4 % 2 == 1 ? round4(KN) : round4(KN) + 4;
constexpr int S3 = round4(OUT);  // row stride of W3^T and |W3|^T
constexpr int MP = M1P > M2P ? M1P : M2P;
// shared memory, in floats; the arrays read as float4 first.  Layer 2's
// (a_up, a_lo, b_up, b2) reuse a row's layer-1 stage once the warp that
// owns the row has done its products.
constexpr int kOffStage1 = 0;                              // float4 [kRows][MP]
constexpr int kOffStage1b = kOffStage1 + 4 * kRows * MP;   // float4 [kRows][M1P]
constexpr int kOffW3 = kOffStage1b + 4 * kRows * M1P;      // [M2P][S3]
constexpr int kOffW3a = kOffW3 + M2P * S3;                 // [M2P][S3]
constexpr int kOffW1 = kOffW3a + M2P * S3;                 // [M1P][S1]
constexpr int kOffStage2 = kOffW1 + M1P * S1;              // float2 [kRows][M2P]
constexpr int kOffW2 = kOffStage2 + 2 * kRows * M2P;       // [M2P][P2]
constexpr int kOffB1 = kOffW2 + M2P * P2;
constexpr int kOffB2 = kOffB1 + M1P;
constexpr int kOffB3 = kOffB2 + M2P;
constexpr int kOffEta = kOffB3 + OUT;                      // [kRows][KN]
constexpr int kOffEps = kOffEta + kRows * KN;              // [kRows][KN]
constexpr int kOffC3 = kOffEps + kRows * KN;               // [kRows][2 OUT]
// the lists (unsigned short) and their lengths (int), per row: layer 1's
// neurons not off and unstable ones, then layer 2's
constexpr int kOffLists = kOffC3 + kRows * 2 * OUT;
constexpr int kOffCounts = kOffLists + kRows * (M1P + M2P);
constexpr int kFloats = kOffCounts + kRows * 4;
constexpr size_t kSmemBytes = sizeof(float) * kFloats;
constexpr size_t kSmemLimit = 232448;  // per-block dynamic shared memory

struct Args {
  const float* W1;  // (M1, KN)
  const float* b1;  // (M1)
  const float* W2;  // (M2, M1)
  const float* b2;  // (M2)
  const float* W3;  // (OUT, M2)
  const float* b3;  // (OUT)
  const float* eta;     // (N, KN)
  const float* eps;     // (N, KN) per-row half-widths, or unused
  const float* xb;      // row r at xb + r * xb_stride, (M1)
  const float* alpha1;  // (N, M1), or unused
  const float* alpha2;  // (N, M2), or unused
  float* lb;            // (N, OUT)
  float* ub;            // (N, OUT)
  long long N;
  long long xb_stride;
  float eps_scalar;
};

struct Relax {
  float a_up, b_up, a_lo;
};

// relu_relaxation of verify/crown.py on [l, u], with alpha-CROWN's lower
// slope (clamped to [0, 1]) on unstable neurons when kAlpha.
template <bool kAlpha>
__device__ __forceinline__ Relax relax(float l, float u, float alpha) {
  Relax q;
  if (l < 0.f && u > 0.f) {
    const float denom = u - l;
    q.a_up = u / denom;
    q.b_up = (-u * l) / denom;
    q.a_lo = kAlpha ? fminf(fmaxf(alpha, 0.f), 1.f) : (u >= -l ? 1.f : 0.f);
  } else {
    const float on = l >= 0.f ? 1.f : 0.f;
    q.a_up = on;
    q.b_up = 0.f;
    q.a_lo = on;
  }
  return q;
}

// the sum over the 16 lanes of a row, the same in each of them
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int s = kLanes / 2; s >= 1; s >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, s);
  }
  return v;
}

// Loads from shared memory that the compiler keeps where they stand.  What
// does not change from one output to the next (a row of W1, a row's slopes
// and etas) would otherwise be hoisted out of the loop over the outputs and
// held, and spilled, beside the accumulators.
__device__ __forceinline__ float4 lds4(const float* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds(const float* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// a row of W1 (S1 floats, float4-aligned) into registers
__device__ __forceinline__ void w1_row(const float* p, float (&w)[S1]) {
#pragma unroll
  for (int v = 0; v < S1 / 4; ++v) {
    const float4 x = lds4(p + 4 * v);
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
}

// a row of W3^T or |W3|^T (S3 floats, float4-aligned) into registers
__device__ __forceinline__ void w3_row(const float* p, float (&w)[S3]) {
#pragma unroll
  for (int v = 0; v < S3 / 4; ++v) {
    const float4 x = lds4(p + 4 * v);
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
}

// the concretisation of one output's linear form L (over the eta axis) and
// its constant c over the row's box: L eta + c +- (radius)
template <bool kRowEps>
__device__ __forceinline__ float concretise(const float (&L)[KN], float c,
                                            float sign, const float* eta_r,
                                            const float* eps_r, float eps) {
  float dot = 0.f, rad = 0.f;
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    dot = fmaf(L[k], lds(eta_r + k), dot);
    rad = kRowEps ? fmaf(fabsf(L[k]), lds(eps_r + k), rad) : rad + fabsf(L[k]);
  }
  if (!kRowEps) rad = eps * rad;
  return (dot + c) + sign * rad;
}

// Appends this lane's neuron (if `in`) to the row's list at `n`, in lane
// order, and advances `n` by the row's count; the lanes of one half-warp
// are one row.
__device__ __forceinline__ void append(bool in, int neuron, unsigned short* list,
                                       int& n) {
  const int lane = threadIdx.x & 31;
  const unsigned row_bits = __ballot_sync(0xffffffffu, in) >> (lane & 16);
  const unsigned below = row_bits & ((1u << (lane & 15)) - 1u);
  if (in) list[n + __popc(below)] = static_cast<unsigned short>(neuron);
  n += __popc(row_bits & 0xffffu);
}

// the j-th neuron of a row's list of n, 0 past its end
__device__ __forceinline__ int entry(const unsigned short* list, int j, int n) {
  return j < n ? list[j] : 0;
}

// the longer of the two lists of a warp's rows
__device__ __forceinline__ int warp_len(int n) {
  const int other = __shfl_xor_sync(0xffffffffu, n, 16);
  return n > other ? n : other;
}

template <bool kRowEps, bool kAlpha>
__global__ void __launch_bounds__(kThreads, 1) fused_crown_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  // the weights, once for the block's walk, zero padded
  for (int e = tid; e < M2P * P2; e += kThreads) {
    const int o = e / P2, i = e - o * P2;
    sm[kOffW2 + e] = (o < M2 && i < M1) ? a.W2[o * M1 + i] : 0.f;
  }
  for (int e = tid; e < M1P * S1; e += kThreads) {
    const int i = e / S1, k = e - i * S1;
    sm[kOffW1 + e] = (i < M1 && k < KN) ? a.W1[i * KN + k] : 0.f;
  }
  for (int e = tid; e < M2P * S3; e += kThreads) {
    const int i = e / S3, o = e - i * S3;
    const float w = (i < M2 && o < OUT) ? a.W3[o * M2 + i] : 0.f;
    sm[kOffW3 + e] = w;
    sm[kOffW3a + e] = fabsf(w);
  }
  for (int e = tid; e < M1P; e += kThreads) {
    sm[kOffB1 + e] = e < M1 ? a.b1[e] : 0.f;
  }
  for (int e = tid; e < M2P; e += kThreads) {
    sm[kOffB2 + e] = e < M2 ? a.b2[e] : 0.f;
  }
  for (int e = tid; e < OUT; e += kThreads) sm[kOffB3 + e] = a.b3[e];

  const float* W1s = sm + kOffW1;
  const float* W2s = sm + kOffW2;
  const int r = tid / kLanes, t = tid % kLanes;
  float4* stage1 = reinterpret_cast<float4*>(sm + kOffStage1) + r * MP;
  float4* stage2b = stage1;  // after the row's layer-2 products
  float4* stage1b = reinterpret_cast<float4*>(sm + kOffStage1b) + r * M1P;
  float2* stage2 = reinterpret_cast<float2*>(sm + kOffStage2) + r * M2P;
  unsigned short* live1 =
      reinterpret_cast<unsigned short*>(sm + kOffLists) + r * 2 * (M1P + M2P);
  unsigned short* unst1 = live1 + M1P;
  unsigned short* live2 = unst1 + M1P;
  unsigned short* unst2 = live2 + M2P;
  int* counts = reinterpret_cast<int*>(sm + kOffCounts) + r * 4;
  const float* eta_r = sm + kOffEta + r * KN;
  const float* eps_r = sm + kOffEps + r * KN;
  float* c3 = sm + kOffC3 + r * 2 * OUT;
  const long long tiles = (a.N + kRows - 1) / kRows;

  __syncthreads();  // the weights are in place
  // Each warp walks its two rows of every tile on its own: from here on a
  // row's shared memory is read and written by its own half-warp only.
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row = tile * kRows + r;
    const bool live = row < a.N;
    __syncwarp();  // the warp's reads of its last rows are done
    for (int k = t; k < KN; k += kLanes) {
      sm[kOffEta + r * KN + k] = live ? a.eta[row * KN + k] : 0.f;
      if (kRowEps) sm[kOffEps + r * KN + k] = live ? a.eps[row * KN + k] : 0.f;
    }
    __syncwarp();

    // ---- layer 1: exact affine in eta, then the relaxation -------------
    {
      int n_live = 0, n_unst = 0;
#pragma unroll
      for (int c = 0; c < C1; ++c) {
        const int i = t + kLanes * c;
        float w[S1];
        w1_row(W1s + i * S1, w);
        float z = eta_r[0] * w[0], rad = 0.f;
#pragma unroll
        for (int k = 1; k < KN; ++k) z = fmaf(eta_r[k], w[k], z);
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          rad = kRowEps ? fmaf(eps_r[k], fabsf(w[k]), rad) : rad + fabsf(w[k]);
        }
        if (!kRowEps) rad = a.eps_scalar * rad;
        float xb = 0.f, alpha = 0.f;
        if (live && i < M1) {
          xb = a.xb[row * a.xb_stride + i];
          if (kAlpha) alpha = a.alpha1[row * M1 + i];
        }
        const float b1 = sm[kOffB1 + i];
        z = (z + b1) + xb;
        const Relax q = relax<kAlpha>(z - rad, z + rad, alpha);
        const float b1_row = b1 + xb;
        // the relu lines at the affine bias point (b_lo is 0)
        const float u_vec = __fadd_rn(__fmul_rn(q.a_up, b1_row), q.b_up);
        const float l_vec = __fmul_rn(q.a_lo, b1_row);
        const float4 st = make_float4(q.a_up + q.a_lo, q.a_up - q.a_lo,
                                      u_vec + l_vec, u_vec - l_vec);
        stage1[i] = st;
        stage1b[i] = make_float4(q.a_up, q.a_lo, q.b_up, b1_row);
        // what this neuron adds to S and s, and to D and d
        append(i < M1 && (st.x != 0.f || st.z != 0.f), i, live1, n_live);
        append(i < M1 && (st.y != 0.f || st.w != 0.f), i, unst1, n_unst);
      }
      if (t == 0) {
        counts[0] = n_live;
        counts[1] = n_unst;
      }
    }
    __syncwarp();

    // ---- layer 2: S, D and s, d of this thread's C2 outputs over the
    // row's lists, then their concretisation and relaxation --------------
    {
      float S[KN][C2], D[KN][C2], s[C2], d[C2];
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        s[c] = d[c] = 0.f;
#pragma unroll
        for (int k = 0; k < KN; ++k) S[k][c] = D[k][c] = 0.f;
      }
      const int n_live = counts[0], n_unst = counts[1];
      const int len_live = warp_len(n_live), len_unst = warp_len(n_unst);
      int next_l1 = entry(live1, 0, n_live);
      for (int j = 0; j < len_live; ++j) {
        const bool on = j < n_live;
        const int i = next_l1;  // the next one's index is read ahead
        next_l1 = entry(live1, j + 1, n_live);
        float4 q = stage1[i];  // a_up + a_lo, a_up - a_lo, u + l, u - l
        const float qx = on ? q.x : 0.f, qz = on ? q.z : 0.f;
        float w[C2], w1[S1];
#pragma unroll
        for (int c = 0; c < C2; ++c) {
          w[c] = W2s[(t + kLanes * c) * P2 + i];
          s[c] = fmaf(qz, w[c], s[c]);
        }
        w1_row(W1s + i * S1, w1);
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          const float ts = qx * w1[k];
#pragma unroll
          for (int c = 0; c < C2; ++c) S[k][c] = fmaf(ts, w[c], S[k][c]);
        }
      }
      int next_u1 = entry(unst1, 0, n_unst);
      for (int j = 0; j < len_unst; ++j) {
        const bool on = j < n_unst;
        const int i = next_u1;  // the next one's index is read ahead
        next_u1 = entry(unst1, j + 1, n_unst);
        float4 q = stage1[i];
        const float qy = on ? q.y : 0.f, qw = on ? q.w : 0.f;
        float aw[C2], w1[S1];
#pragma unroll
        for (int c = 0; c < C2; ++c) {
          aw[c] = fabsf(W2s[(t + kLanes * c) * P2 + i]);
          d[c] = fmaf(qw, aw[c], d[c]);
        }
        w1_row(W1s + i * S1, w1);
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          const float td = qy * w1[k];
#pragma unroll
          for (int c = 0; c < C2; ++c) D[k][c] = fmaf(td, aw[c], D[k][c]);
        }
      }
      __syncwarp();  // the row's layer-1 stage is read: it takes stage2b
      int n_live2 = 0, n_unst2 = 0;
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        const int o2 = t + kLanes * c;
        const float b2 = sm[kOffB2 + o2];
        float Lu[KN], Ll[KN];
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          Lu[k] = 0.5f * (S[k][c] + D[k][c]);
          Ll[k] = 0.5f * (S[k][c] - D[k][c]);
        }
        const float ub = concretise<kRowEps>(Lu, b2 + 0.5f * (s[c] + d[c]),
                                             1.f, eta_r, eps_r, a.eps_scalar);
        const float lb = concretise<kRowEps>(Ll, b2 + 0.5f * (s[c] - d[c]),
                                             -1.f, eta_r, eps_r, a.eps_scalar);
        float alpha = 0.f;
        if (kAlpha && live && o2 < M2) alpha = a.alpha2[row * M2 + o2];
        const Relax q = relax<kAlpha>(lb, ub, alpha);
        const float2 st = make_float2(q.a_up + q.a_lo, q.a_up - q.a_lo);
        stage2[o2] = st;
        stage2b[o2] = make_float4(q.a_up, q.a_lo, q.b_up, b2);
        append(o2 < M2 && st.x != 0.f, o2, live2, n_live2);
        append(o2 < M2 && st.y != 0.f, o2, unst2, n_unst2);
      }
      if (t == 0) {
        counts[2] = n_live2;
        counts[3] = n_unst2;
      }
    }
    __syncwarp();
    // layer 3's terms on this thread's layer-2 neurons: their bias lines
    // (b_lo is 0) and b2 through W3 split by sign, summed over the row
    {
      float pu[OUT], pl[OUT];
#pragma unroll
      for (int o = 0; o < OUT; ++o) pu[o] = pl[o] = 0.f;
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        const int o2 = t + kLanes * c;
        const float4 q = stage2b[o2];  // a_up, a_lo, b_up, b2
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          const float w3 = sm[kOffW3 + o2 * S3 + o];
          const float wp = fmaxf(w3, 0.f), wn = fminf(w3, 0.f);
          pu[o] += wp * q.z + (wp * q.x + wn * q.y) * q.w;
          pl[o] += wn * q.z + (wp * q.y + wn * q.x) * q.w;
        }
      }
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        pu[o] = row_sum(pu[o]);
        pl[o] = row_sum(pl[o]);
      }
      if (t == 0) {
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          c3[o] = pu[o];
          c3[OUT + o] = pl[o];
        }
      }
    }
    __syncwarp();

    // ---- layer 3: (W3 split by layer 2's slopes) . W2 on this thread's
    // C1 columns, as two scaled products over the row's lists -------------
    float A[OUT][C1], B[OUT][C1];
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
#pragma unroll
      for (int c = 0; c < C1; ++c) A[o][c] = B[o][c] = 0.f;
    }
    {
      const int n_live2 = counts[2], n_unst2 = counts[3];
      const int len_live2 = warp_len(n_live2), len_unst2 = warp_len(n_unst2);
      int next_l2 = entry(live2, 0, n_live2);
#pragma unroll kUnroll3
      for (int j = 0; j < len_live2; ++j) {
        const bool on = j < n_live2;
        const int i = next_l2;  // the next one's index is read ahead
        next_l2 = entry(live2, j + 1, n_live2);
        const float qx = on ? stage2[i].x : 0.f;  // a_up + a_lo
        float w[C1], w3[S3];
#pragma unroll
        for (int c = 0; c < C1; ++c) w[c] = W2s[i * P2 + t + kLanes * c];
        w3_row(sm + kOffW3 + i * S3, w3);
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          const float ts = qx * w3[o];
#pragma unroll
          for (int c = 0; c < C1; ++c) A[o][c] = fmaf(ts, w[c], A[o][c]);
        }
      }
      int next_u2 = entry(unst2, 0, n_unst2);
#pragma unroll kUnroll3
      for (int j = 0; j < len_unst2; ++j) {
        const bool on = j < n_unst2;
        const int i = next_u2;  // the next one's index is read ahead
        next_u2 = entry(unst2, j + 1, n_unst2);
        const float qy = on ? stage2[i].y : 0.f;  // a_up - a_lo
        float w[C1], w3[S3];
#pragma unroll
        for (int c = 0; c < C1; ++c) w[c] = W2s[i * P2 + t + kLanes * c];
        w3_row(sm + kOffW3a + i * S3, w3);
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          const float td = qy * w3[o];
#pragma unroll
          for (int c = 0; c < C1; ++c) B[o][c] = fmaf(td, w[c], B[o][c]);
        }
      }
    }
    // the split against layer 1's slopes, its bias terms, . W1 and the
    // concretisation, one output at a time
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      float fu[KN], fl[KN], cu = 0.f, cl = 0.f;
#pragma unroll
      for (int k = 0; k < KN; ++k) fu[k] = fl[k] = 0.f;
#pragma unroll
      for (int c = 0; c < C1; ++c) {
        const int j = t + kLanes * c;
        // a_up, a_lo, b_up, b1 + x_bias
        const float4 q = lds4(reinterpret_cast<const float*>(stage1b + j));
        const float vu = 0.5f * (A[o][c] + B[o][c]);
        const float vl = 0.5f * (A[o][c] - B[o][c]);
        const float up = fmaxf(vu, 0.f), un = fminf(vu, 0.f);
        const float lp = fmaxf(vl, 0.f), ln = fminf(vl, 0.f);
        const float Lu = up * q.x + un * q.y;
        const float Ll = lp * q.y + ln * q.x;
        cu += up * q.z + Lu * q.w;
        cl += ln * q.z + Ll * q.w;
        float w[S1];
        w1_row(W1s + j * S1, w);
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          fu[k] = fmaf(Lu, w[k], fu[k]);
          fl[k] = fmaf(Ll, w[k], fl[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        fu[k] = row_sum(fu[k]);
        fl[k] = row_sum(fl[k]);
      }
      const float b3 = sm[kOffB3 + o];
      const float ub = concretise<kRowEps>(fu, (b3 + c3[o]) + row_sum(cu),
                                           1.f, eta_r, eps_r, a.eps_scalar);
      const float lb = concretise<kRowEps>(fl, (b3 + c3[OUT + o]) + row_sum(cl),
                                           -1.f, eta_r, eps_r, a.eps_scalar);
      if (live && t == o % kLanes) {
        a.ub[row * OUT + o] = ub;
        a.lb[row * OUT + o] = lb;
      }
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

template <bool kRowEps, bool kAlpha>
int launch(const Args& a, void* stream) {
  const auto kernel = fused_crown_kernel<kRowEps, kAlpha>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (a.N + kRows - 1) / kRows;
  const long long held = static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < held ? tiles : held);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fused_crown_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The shape this library was built for, and the shared memory a block of it
// takes and may have.
int fused_crown_shape(int which) {
  const int dims[4] = {KN, M1, M2, OUT};
  return which >= 0 && which < 4 ? dims[which] : -1;
}

long long fused_crown_smem_bytes() { return static_cast<long long>(kSmemBytes); }

long long fused_crown_smem_limit() { return static_cast<long long>(kSmemLimit); }

// All pointers are device pointers to contiguous float32 arrays but x_bias,
// whose row r starts at xb + r * xb_stride (0: one bias for every row).
// eps_rows (N, n) is read when not null, eps otherwise; alpha1 (N, m1) and
// alpha2 (N, m2) are both null or both given.  Returns a cudaError_t (0 on
// success).
int fused_crown_bounds(const float* W1, const float* b1, const float* W2,
                       const float* b2, const float* W3, const float* b3,
                       const float* eta, const float* eps_rows, float eps,
                       const float* xb, long long xb_stride,
                       const float* alpha1, const float* alpha2, float* lb,
                       float* ub, long long N, void* stream) {
  if (N < 0 || kSmemBytes > kSmemLimit ||
      (alpha1 == nullptr) != (alpha2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const Args a{W1, b1, W2, b2, W3, b3, eta, eps_rows, xb, alpha1, alpha2,
               lb, ub, N, xb_stride, eps};
  const bool row_eps = eps_rows != nullptr, alpha = alpha1 != nullptr;
  if (row_eps) {
    return alpha ? launch<true, true>(a, stream)
                 : launch<true, false>(a, stream);
  }
  return alpha ? launch<false, true>(a, stream)
               : launch<false, false>(a, stream);
}

}  // extern "C"
