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
// Per row it recomputes the forward with K1's own device code (same order of
// sums, same bisection), so mu and therefore the active set are bit-identical
// to the forward's, then applies
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
// What bounds them on the H100.  At the flagship (n = 10, mlp = 128) a
// forward row moves 592 bytes (h 40, xc 4 mlp = 512, out 40) for ~36 kFLOP,
// a backward row 1184 bytes for ~72 kFLOP (~108 with weight gradients): both
// are bound by operations, and 86% of those are the mlp x mlp product and
// its transposes.  So the products run on the tensor cores with the batch
// rows as M: a warp owns 16 rows and all output columns and runs
// mma.sync m16n8k8 in 3xTF32 (each fp32 operand a TF32 value plus a TF32
// remainder, three products for one, fp32 accuracy; each group of four
// k-steps, two at a wide state, sums into a fresh partial that a rounded
// fp32 add folds into the running sum, because the tensor cores' own adds
// truncate).  With 16 rows a warp every weight fragment is split for one
// use, two splits for three mma.sync: the split is two integer operations
// and a subtraction, not cvt.rna.tf32.f32, whose rate bounded the kernels at
// 1.8 times these times.  What is left is bound by the schedulers: ~6000
// SASS operations a forward tile, a sixth of them mma.sync, on two warps a
// scheduler (all 255 registers a thread are in use).
//
// * The activations never leave registers.  The accumulator fragment of
//   m16n8k8 holds columns (2t, 2t+1) of rows (g, g+8); the A fragment wants
//   k-slots (t, t+4) of the same rows.  The order of K is free as long as A
//   and B agree, so slot t stands for column 2t and slot t+4 for column
//   2t+1 of each 8-column step: the ReLU'd accumulator of one product is the
//   A operand of the next, and a forward needs no shared scratch and no
//   block-wide barrier.  z2 is made in chunks of 32 columns, each consumed
//   at once by the last product, so z1 and one chunk are all that is live.
//   What a thread holds for the whole walk but uses rarely (a row's
//   addresses, the lanes' swizzle offsets, the block's slot) is computed
//   again at each use (`again`), or it is spilled to make room.
// * The weights are packed once per solve by the wrapper (pack_rhs_params)
//   into the image a block keeps in shared memory, and arrive by 16-byte
//   cp.async: W1 (MP, S1), W2 (MP, S2), W3 (NP, S2), b2 (MP), b3 (NP), each
//   [out][in] row-major, zero padded (MP, NP: mlp and n rounded up to 8; S1,
//   S2: NP and MP rounded up to 32), element (r, c) at r S + (c ^ swz(r)),
//   swz(r) = ((r & 3) ^ ((r >> 2) & 1)) << 3.  With that swizzle both ways
//   of reading a B fragment are free of bank conflicts: the forward's (X W^T:
//   one 8-byte load of columns 2t, 2t+1 of row g) and the backward's (X W:
//   4-byte loads of column g of rows 2t and 2t+1), so one copy serves both.
// * The bisection runs where the last product leaves its result: a row's
//   values sit in the four lanes of a quad, each lane sums its own columns
//   in a fixed order and two __shfl_xor_sync add the quad, so every lane of
//   every warp works and all four get the same sum bit for bit.
// * K2's weight gradients are products with the batch rows as K.  The warps
//   of a block turn their rows through two shared staging buffers (X, Y) and
//   split the output tiles among them; each product's partial lives in
//   registers only while it is computed and is then added to the block's
//   own slot in device memory (L2), in a fixed order.  A second launch adds
//   the slots in slot order.  No atomics: results are bit-reproducible from
//   run to run on one card.  Without weight gradients K2 has no staging, no
//   barrier, and keeps only the ReLU patterns as bits.  z1 is not kept for
//   dW2 but computed again (one narrow product), and a thread parks f~ and
//   the barrier part of dh in its own elements of the output dh.
//
// The tile counts MT = ceil(mlp / 8) and NT = ceil(n / 8) are compile-time
// (every fragment array is indexed statically and lives in registers): the
// wrapper builds one library per (MT, NT) it meets.  The squash and the
// weight gradients are template parameters, so each variant compiles as if
// the others did not exist.  No fast-math: expf and an exact
// 1 / (1 + expf(-x)).
#include <cuda_runtime.h>

#include <cmath>

#ifndef FIODE_RHS_MT
#define FIODE_RHS_MT 16
#endif
#ifndef FIODE_RHS_NT
#define FIODE_RHS_NT 2
#endif

namespace {

constexpr int MT = FIODE_RHS_MT;  // 8-column tiles of the MLP width
constexpr int NT = FIODE_RHS_NT;  // 8-column tiles of the state width
constexpr int MP = 8 * MT, NP = 8 * NT;
constexpr int round32(int x) { return (x + 31) / 32 * 32; }
constexpr int S1 = round32(NP);  // row stride of W1
constexpr int S2 = round32(MP);  // row stride of W2 and W3
constexpr int kOffW2 = MP * S1;
constexpr int kOffW3 = kOffW2 + MP * S2;
constexpr int kOffB2 = kOffW3 + NP * S2;
constexpr int kOffB3 = kOffB2 + MP;
constexpr int kPackFloats = kOffB3 + NP;
// staging strides: an odd multiple of 8 floats, so that the transposed
// fragment reads (k-slot t down the rows, lane group g along the columns)
// touch 32 different banks
constexpr int odd8(int x) { return (x / 8) % 2 == 0 ? x + 8 : x + 16; }
constexpr int SM = odd8(MP), SN = odd8(NP);
constexpr int SY = SM > SN ? SM : SN;
// A wide state's or a wide MLP's own fragments leave fewer registers for a
// product's: it then makes z2 and d pre1 in smaller chunks, sums fewer
// k-steps in the tensor cores before the rounded add (fewer split A
// fragments held), and runs one chain of mma.sync at a time.
constexpr bool kWide = NT > 4 || MT > 16;
constexpr int kChunk = kWide ? 2 : 4;     // z2 / d pre1 tiles made and consumed at a time
constexpr int kGroup = kWide ? 2 : 4;     // k-steps summed by the tensor cores' own adds
constexpr int kTogether = kWide ? 1 : 2;  // result tiles whose mma.sync interleave
constexpr int kMaskWords = (4 * MT + 31) / 32;
constexpr int kMaxWarps = 8;
constexpr int kReduceThreads = 256;
constexpr size_t kSmemLimit = 232448;  // per-block dynamic shared memory

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Loads of the weights from shared memory.  Volatile asm: the weights do
// not change while a block walks its tiles, and a plain load may be hoisted
// out of the tile loop and its value kept in a register for the whole walk.
__device__ __forceinline__ float2 lds2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The same value, as far as the compiler can tell a new one: what is
// computed from it (a row's addresses, a block's slot) is computed again
// where it is used instead of being kept, and spilled, across the products.
__device__ __forceinline__ int again(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ float again(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

__device__ __forceinline__ unsigned shared_address(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// x = big + small for the tensor cores.  big is x rounded to TF32 (10
// mantissa bits, nearest, ties away) with two integer operations: a
// cvt.rna.tf32.f32 runs at a small fraction of their rate, and a warp that
// owns 16 rows splits two weights for every three mma.sync.  x - big is exact
// in fp32; the tensor cores ignore its low 13 mantissa bits, so small keeps
// 11 bits and a product of two splits loses ~2^-21 relative.
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b: the first product of a fresh partial sum
__device__ __forceinline__ void mma_tf32_fresh(float (&c)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c[i] (+)= a b[i] for up to kTogether result tiles in three TF32 products
// each (3xTF32): the small terms first, the small-by-small one dropped; fp32
// accuracy from the tensor cores.  Consecutive mma.sync go to different
// accumulators, so a warp has kTogether independent chains in flight
// instead of one.  `fresh` starts the partial sums c at zero.
__device__ __forceinline__ void mma3(float (&c)[kTogether][4],
                                     const unsigned (&ab)[4],
                                     const unsigned (&as)[4],
                                     const unsigned (&bb)[kTogether][2],
                                     const unsigned (&bs)[kTogether][2],
                                     int tiles, bool fresh) {
#pragma unroll
  for (int i = 0; i < kTogether; ++i) {
    if (i < tiles) {
      if (fresh) {
        mma_tf32_fresh(c[i], as, bb[i]);
      } else {
        mma_tf32(c[i], as, bb[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTogether; ++i) {
    if (i < tiles) mma_tf32(c[i], ab, bs[i]);
  }
#pragma unroll
  for (int i = 0; i < kTogether; ++i) {
    if (i < tiles) mma_tf32(c[i], ab, bb[i]);
  }
}

// Every per-row value of a warp's 16 rows is held in the accumulator layout
// of m16n8k8: v[j][e] is column 8 j + 2 t + (e & 1) of row g + 8 (e >> 1),
// g = lane / 4, t = lane % 4.  As an A operand, step j of K, it stands for
// k-slots (t, t + 4) = columns (2 t, 2 t + 1) of that step.
__device__ __forceinline__ void split_a(const float (&v)[4],
                                        unsigned (&big)[4],
                                        unsigned (&small)[4]) {
  // fragment order: (g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  const int from[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // an empty volatile asm on the value: the split of an operand that two
    // chunks of a product use is made twice, not kept (kept splits would
    // double the registers of the operand)
    float x = v[from[i]];
    asm volatile("" : "+f"(x));
    split(x, big[i], small[i]);
  }
}

__device__ __forceinline__ int swz(int row) {
  return ((row & 3) ^ ((row >> 2) & 1)) << 3;
}

// acc[j - J0] += A B for the result tiles J0 <= j < J1, where A's k-steps
// a[0 .. KS) are the steps K0 .. K0 + KS of the weight W in shared memory
// (row stride S).  kT = false: B = W^T (W is [out][in], the forward's
// products); kT = true: B = W (the backward's).
template <bool kT, int S, int KS, int K0, int J0, int J1, int NACC, int NA>
__device__ __forceinline__ void product(float (&acc)[NACC][4],
                                        const float (&a)[NA][4],
                                        const float* __restrict__ W, int lane_g,
                                        int lane_t) {
  static_assert(J1 - J0 <= NACC && KS <= NA, "fragment arrays too small");
  const unsigned wa = shared_address(W);
  // the offsets are made here, for this product, not once per kernel
  const int g = again(lane_g), t = again(lane_t);
  // the swizzle depends on the row's low three bits only, which are the
  // lane's: four column offsets a lane, one for each 8-column step mod 4
  int off0[4], off1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!kT) {
      off0[q] = g * S + ((8 * q + 2 * t) ^ swz(g));
      off1[q] = 0;
    } else {
      off0[q] = 2 * t * S + ((8 * q + g) ^ swz(2 * t));
      off1[q] = (2 * t + 1) * S + ((8 * q + g) ^ swz(2 * t + 1));
    }
  }
#pragma unroll
  for (int s0 = 0; s0 < KS; s0 += kGroup) {
    unsigned ab[kGroup][4], as[kGroup][4];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (s0 + u < KS) split_a(a[s0 + u], ab[u], as[u]);
    }
#pragma unroll
    for (int j0 = J0; j0 < J1; j0 += kTogether) {
      const int tiles = J1 - j0 < kTogether ? J1 - j0 : kTogether;
      float p[kTogether][4];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (s0 + u < KS) {
          const int s = K0 + s0 + u;
          unsigned bb[kTogether][2], bs[kTogether][2];
#pragma unroll
          for (int i = 0; i < kTogether; ++i) {
            if (i < tiles) {
              const int j = j0 + i;
              float b0, b1;
              if (!kT) {  // W[8 j + g][8 s + 2 t], [.. + 1]
                const float2 v =
                    lds2(wa + 4 * (8 * j * S + 32 * (s >> 2) + off0[s & 3]));
                b0 = v.x;
                b1 = v.y;
              } else {  // W[8 s + 2 t][8 j + g], W[8 s + 2 t + 1][8 j + g]
                b0 = lds(wa + 4 * (8 * s * S + 32 * (j >> 2) + off0[j & 3]));
                b1 = lds(wa + 4 * (8 * s * S + 32 * (j >> 2) + off1[j & 3]));
              }
              split(b0, bb[i][0], bs[i][0]);
              split(b1, bb[i][1], bs[i][1]);
            }
          }
          mma3(p, ab[u], as[u], bb, bs, tiles, u == 0);
        }
      }
#pragma unroll
      for (int i = 0; i < kTogether; ++i) {
        if (i < tiles) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j0 + i - J0][e] += p[i][e];
        }
      }
    }
  }
}

// v[j][e] for the T tiles j0 .. j0 + T of the row-major (B, width) array
// src, rows `row` and `row + 8`; zero past the array's rows and columns
template <int T>
__device__ __forceinline__ void load_rows(const float* src, int width,
                                          int first_row, int B, bool vec_ok,
                                          int lane_t, int j0,
                                          float (&v)[T][4]) {
  // offsets and bounds tests are made here, not kept from an earlier call
  const int t = again(lane_t), row = again(first_row);
  const bool vec = again(static_cast<int>(vec_ok)) != 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    const float* p = src + (size_t)(r < B ? r : 0) * width;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int col = 8 * (j0 + j) + 2 * t;
      float x = 0.f, y = 0.f;
      if (r < B) {
        if (vec && col + 1 < width) {
          const float2 q = *reinterpret_cast<const float2*>(p + col);
          x = q.x;
          y = q.y;
        } else {
          if (col < width) x = p[col];
          if (col + 1 < width) y = p[col + 1];
        }
      }
      v[j][2 * half] = x;
      v[j][2 * half + 1] = y;
    }
  }
}

// the first `tiles` of v as tiles j0 .. of the row-major (B, width) array dst
template <int T>
__device__ __forceinline__ void store_rows(float* dst, int width,
                                           int first_row, int B, bool vec_ok,
                                           int lane_t, int j0,
                                           const float (&v)[T][4],
                                           int tiles = T) {
  // offsets and bounds tests are made here, not kept from an earlier call
  const int t = again(lane_t), row = again(first_row);
  const bool vec = again(static_cast<int>(vec_ok)) != 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= B) continue;
    float* p = dst + (size_t)r * width;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j >= tiles) continue;
      const int col = 8 * (j0 + j) + 2 * t;
      if (vec && col + 1 < width) {
        *reinterpret_cast<float2*>(p + col) =
            make_float2(v[j][2 * half], v[j][2 * half + 1]);
      } else {
        if (col < width) p[col] = v[j][2 * half];
        if (col + 1 < width) p[col + 1] = v[j][2 * half + 1];
      }
    }
  }
}

// tile j of a warp's 16 rows back from its rows of a staging buffer
__device__ __forceinline__ void unstage(const float* rows, int stride, int j,
                                        float (&v)[4], int g, int t) {
  const float2 a =
      *reinterpret_cast<const float2*>(rows + g * stride + 8 * j + 2 * t);
  const float2 b =
      *reinterpret_cast<const float2*>(rows + (g + 8) * stride + 8 * j + 2 * t);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// tile j of a warp's 16 rows into its rows of a staging buffer
__device__ __forceinline__ void stage(float* rows, int stride, int j,
                                      const float (&v)[4], int g, int t) {
  *reinterpret_cast<float2*>(rows + g * stride + 8 * j + 2 * t) =
      make_float2(v[0], v[1]);
  *reinterpret_cast<float2*>(rows + (g + 8) * stride + 8 * j + 2 * t) =
      make_float2(v[2], v[3]);
}

__device__ __forceinline__ void set_bits(unsigned (&mask)[kMaskWords], int j,
                                         const float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int b = 4 * j + e;
    if (v[e] > 0.f) mask[b >> 5] |= 1u << (b & 31);
  }
}

__device__ __forceinline__ void keep_bits(const unsigned (&mask)[kMaskWords],
                                          int j, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int b = 4 * j + e;
    if (!((mask[b >> 5] >> (b & 31)) & 1u)) v[e] = 0.f;
  }
}

// The packed weights into shared memory; ends synchronised.
__device__ __forceinline__ void stage_weights(const float* __restrict__ packed,
                                              float* w) {
  for (int i = threadIdx.x; i < kPackFloats / 4; i += blockDim.x) {
    cp_async16(w + 4 * i, packed + 4 * i);
  }
  cp_async_wait_all();
  __syncthreads();
}

// z1 = relu(h W1^T + xc) of the warp's rows `row`, `row + 8`
__device__ __forceinline__ void first_layer(
    const float* __restrict__ h, const float* __restrict__ xc, int row, int B,
    int n, int m, bool vec_h, bool vec_xc, const float* __restrict__ w, int g,
    int t, float (&z1)[MT][4]) {
  float hv[NT][4];
  load_rows<NT>(h, n, row, B, vec_h, t, 0, hv);
  load_rows<MT>(xc, m, row, B, vec_xc, t, 0, z1);
  product<false, S1, NT, 0, 0, MT>(z1, hv, w, g, t);
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) z1[j][e] = fmaxf(z1[j][e], 0.f);
  }
}

// kMode of the forward: 0 for K1, 1 for K2 (keeps the ReLU patterns m1, m2
// as bits), 2 for K2 with weight gradients (also stages z2 into xs, the
// warp's rows of the staging buffer X).
//
// z2 and f, chunk by chunk: z2's tiles C0 .. C1 from all of z1, then their
// share of f = z2 W3^T + b3.
template <int kMode, int C0>
__device__ __forceinline__ void forward_chunks(
    const float (&z1)[MT][4], float (&ft)[NT][4], unsigned (&m2)[kMaskWords],
    const float* __restrict__ w, float* xs, int g, int t) {
  if constexpr (C0 < MT) {
    constexpr int C1 = C0 + kChunk < MT ? C0 + kChunk : MT;
    float z2[kChunk][4];
#pragma unroll
    for (int j = C0; j < C1; ++j) {
      const float2 b = lds2(shared_address(w + kOffB2 + 8 * j + 2 * t));
      z2[j - C0][0] = z2[j - C0][2] = b.x;
      z2[j - C0][1] = z2[j - C0][3] = b.y;
    }
    product<false, S2, MT, 0, C0, C1>(z2, z1, w + kOffW2, g, t);
#pragma unroll
    for (int j = C0; j < C1; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) z2[j - C0][e] = fmaxf(z2[j - C0][e], 0.f);
      if (kMode >= 1) set_bits(m2, j, z2[j - C0]);
      if (kMode == 2) stage(xs, SM, j, z2[j - C0], g, t);
    }
    product<false, S2, C1 - C0, C0, 0, NT>(ft, z2, w + kOffW3, g, t);
    forward_chunks<kMode, C1>(z1, ft, m2, w, xs, g, t);
  }
}

// The unprojected f~ of the warp's rows `row`, `row + 8`.
template <int kMode>
__device__ __forceinline__ void forward_rows(
    const float* __restrict__ h, const float* __restrict__ xc, int row, int B,
    int n, int m, bool vec_h, bool vec_xc, const float* __restrict__ w,
    float* xs, int g, int t, float (&ft)[NT][4], unsigned (&m1)[kMaskWords],
    unsigned (&m2)[kMaskWords]) {
  float z1[MT][4];
  first_layer(h, xc, row, B, n, m, vec_h, vec_xc, w, g, t, z1);
  if (kMode >= 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j) set_bits(m1, j, z1[j]);
  }
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const float2 b = lds2(shared_address(w + kOffB3 + 8 * c + 2 * t));
    ft[c][0] = ft[c][2] = b.x;
    ft[c][1] = ft[c][3] = b.y;
  }
  forward_chunks<kMode, 0>(z1, ft, m2, w, xs, g, t);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Barrier, optional squash and the bisection on the quads: nom holds f~ on
// entry and the nominal f on return, lower the barrier; past column n they
// are -inf and 0, which add nothing to a row's sum.  mu[r] is the dual of
// row g + 8 r; the projected output is max(nom - mu, lower).
template <bool kSquash>
__device__ __forceinline__ void project_rows(
    const float* __restrict__ h, int row, int B, bool vec_h,
    float (&nom)[NT][4], float (&lower)[NT][4], int n, int t, float alpha_1,
    float sigma_1, float alpha_2, int qp_iters, float (&mu)[2]) {
  float lo[2] = {INFINITY, INFINITY}, hi[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float hv[1][4];
    load_rows<1>(h, n, row, B, vec_h, t, j, hv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float hk = hv[0][e];
      float lw = -alpha_1 * (expf(sigma_1 * hk) - 1.f);
      float f = nom[j][e];
      if (kSquash) {
        const float up = alpha_2 * (1.f - hk);
        f = (up - lw) * (1.f / (1.f + expf(-f))) + lw;
      }
      if (8 * j + 2 * t + (e & 1) < n) {
        lo[r] = fminf(lo[r], f);
        hi[r] = fmaxf(hi[r], f - lw);
      } else {
        f = -INFINITY;
        lw = 0.f;
      }
      nom[j][e] = f;
      lower[j][e] = lw;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int d = 1; d < 4; d *= 2) {
      lo[r] = fminf(lo[r], __shfl_xor_sync(0xffffffffu, lo[r], d));
      hi[r] = fmaxf(hi[r], __shfl_xor_sync(0xffffffffu, hi[r], d));
    }
  }
  for (int it = 0; it < qp_iters; ++it) {
    const float mid[2] = {0.5f * (lo[0] + hi[0]), 0.5f * (lo[1] + hi[1])};
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e >> 1] += fmaxf(nom[j][e] - mid[e >> 1], lower[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(s[r]);
      if (sum > 0.f) lo[r] = mid[r];
      if (sum < 0.f) hi[r] = mid[r];
    }
  }
  mu[0] = 0.5f * (lo[0] + hi[0]);
  mu[1] = 0.5f * (lo[1] + hi[1]);
}

// A block is 1 to 8 warps, each walking its own 16-row tiles: no barrier
// after the weights have arrived.
template <bool kSquash>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
fused_rhs_kernel(const float* __restrict__ h, const float* __restrict__ xc,
                 const float* __restrict__ packed, float* __restrict__ out,
                 int B, int n, int m, float alpha_1, float sigma_1,
                 float alpha_2, int qp_iters, int vec_h, int vec_xc) {
  extern __shared__ __align__(16) float smem[];
  stage_weights(packed, smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warps = blockDim.x / 32;
  for (int tile = blockIdx.x * warps + warp; 16 * tile < B;
       tile += gridDim.x * warps) {
    const int row = 16 * tile + g;
    float nom[NT][4], lower[NT][4], mu[2];
    unsigned m1[kMaskWords], m2[kMaskWords];
    forward_rows<0>(h, xc, row, B, n, m, vec_h, vec_xc, smem, nullptr, g, t,
                    nom, m1, m2);
    const int row_p = again(row);
    project_rows<kSquash>(h, row_p, B, vec_h, nom, lower, n, t, alpha_1,
                          sigma_1, alpha_2, qp_iters, mu);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        nom[j][e] = fmaxf(nom[j][e] - mu[e >> 1], lower[j][e]);
      }
    }
    store_rows<NT>(out, n, row_p, B, vec_h, t, 0, nom);
  }
}

// Floats of the weight gradients dW1 (m, n), dW2 (m, m), dW3 (n, m),
// db2 (m), db3 (n), laid out as the output and as one workspace slot.
__host__ __device__ size_t grad_floats(int n, int m) {
  return (size_t)m * n + (size_t)m * m + (size_t)n * m + m + n;
}

// slot[i ld + k] += sum over the block's staged rows r of As[r][i] Bs[r][k]
// for i < ri, k < rk: a product with the rows as K.  The output's IT x KT
// tiles (16 x 8 each) are dealt to the warps in jobs of one tile row by up
// to eight tile columns; a job's sum lives in registers while it runs.
template <int IT, int KT>
__device__ __forceinline__ void rows_product(
    const float* __restrict__ As, int sa, const float* __restrict__ Bs, int sb,
    float* slot, int ld, int ri, int rk, int warp, int warps, int g, int t) {
  constexpr int NG = (KT + 7) / 8;
  for (int job = warp; job < IT * NG; job += warps) {
    const int it = job / NG, cg = job % NG;
    float acc[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
    }
    const float* ap = As + t * sa + 16 * it + g;
    const float* bp = Bs + t * sb + 64 * cg + g;
    for (int w = 0; w < warps; ++w) {  // one warp's 16 rows: two k-steps
      unsigned ab[2][4], as[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* p = ap + (16 * w + 8 * u) * sa;
        split(p[0], ab[u][0], as[u][0]);           // (i = g, r = t)
        split(p[8], ab[u][1], as[u][1]);           // (g + 8, t)
        split(p[4 * sa], ab[u][2], as[u][2]);      // (g, t + 4)
        split(p[4 * sa + 8], ab[u][3], as[u][3]);  // (g + 8, t + 4)
      }
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += kTogether) {
        if (8 * cg + j0 < KT) {
          const int left = KT - 8 * cg - j0;
          const int tiles = left < kTogether ? left : kTogether;
          float p[kTogether][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            unsigned bb[kTogether][2], bs[kTogether][2];
#pragma unroll
            for (int i = 0; i < kTogether; ++i) {
              if (i < tiles) {
                const float* q = bp + (16 * w + 8 * u) * sb + 8 * (j0 + i);
                split(q[0], bb[i][0], bs[i][0]);       // (r = t, k = g)
                split(q[4 * sb], bb[i][1], bs[i][1]);  // (r = t + 4, k = g)
              }
            }
            mma3(p, ab[u], as[u], bb, bs, tiles, u == 0);
          }
#pragma unroll
          for (int i = 0; i < kTogether; ++i) {
            if (i < tiles) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j0 + i][e] += p[i][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * it + g + 8 * (e >> 1);
        const int k = 64 * cg + 8 * jt + 2 * t + (e & 1);
        if (8 * cg + jt < KT && i < ri && k < rk) slot[i * ld + k] += acc[jt][e];
      }
    }
  }
}

// slot[k] += the column sums of the block's staged rows
__device__ __forceinline__ void rows_sum(const float* __restrict__ s,
                                         int stride, int rows, int width,
                                         float* slot) {
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += s[r * stride + k];
    slot[k] += acc;
  }
}

// d pre1 and dh, chunk by chunk: d pre1's tiles C0 .. C1 from all of d pre2
// (masked by z1's pattern, written to dxc), then their share of d pre1 W1.
template <bool kWeightGrads, int C0>
__device__ __forceinline__ void backward_chunks(
    const float (&dp2)[MT][4], float (&dhv)[NT][4],
    const unsigned (&m1)[kMaskWords], const float* __restrict__ w,
    float* __restrict__ dxc, int row, int B, int m, bool vec_xc, float* xs,
    int g, int t) {
  if constexpr (C0 < MT) {
    constexpr int C1 = C0 + kChunk < MT ? C0 + kChunk : MT;
    float dp1[kChunk][4];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp1[j][e] = 0.f;
    }
    product<true, S2, MT, 0, C0, C1>(dp1, dp2, w + kOffW2, g, t);
#pragma unroll
    for (int j = C0; j < C1; ++j) {
      keep_bits(m1, j, dp1[j - C0]);
      if (kWeightGrads) stage(xs, SM, j, dp1[j - C0], g, t);
    }
    store_rows<kChunk>(dxc, m, row, B, vec_xc, t, C0, dp1, C1 - C0);
    product<true, S1, C1 - C0, C0, 0, NT>(dhv, dp1, w, g, t);
    backward_chunks<kWeightGrads, C1>(dp2, dhv, m1, w, dxc, row, B, m, vec_xc,
                                      xs, g, t);
  }
}

// Without weight gradients a block is 1 to 8 independent warps, as in K1.
// With them its warps meet at six barriers a tile: X and Y hold 16 rows a
// warp; z2 and d f~ give dW3 and db3, then z1 (computed again: cheaper than
// keeping it) and d pre2 give dW2 and db2, then d pre1 and h give dW1.
//
// A thread parks two of its per-row values in its own elements of dh while
// it does not need them, f~ during the bisection (squash only) and the
// barrier part of dh during the products, and reads them back itself: at a
// wide state they would not fit in its registers beside the fragments.
template <bool kSquash, bool kWeightGrads>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
fused_rhs_backward_kernel(
    const float* __restrict__ h, const float* __restrict__ xc,
    const float* __restrict__ gin, const float* __restrict__ packed,
    float* dh, float* __restrict__ dxc, float* __restrict__ ws, int B, int n,
    int m, float alpha_1, float sigma_1, float alpha_2, int qp_iters,
    int vec_h, int vec_xc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kMode = kWeightGrads ? 2 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int warps = blockDim.x / 32;
  const int rows = 16 * warps;  // rows of a block's tile
  // X, Y and this block's slot of partial sums [dW1 | dW2 | dW3 | db2 | db3]
  // are addressed anew at each use (see `again`)
  const auto staging = [&](int floats) {
    return smem + kPackFloats + again(floats);
  };
  const auto slot = [&](int floats) {
    return ws + (size_t)again(static_cast<int>(blockIdx.x)) * grad_floats(n, m) + floats;
  };
  if (kWeightGrads) {
    const int wlen = static_cast<int>(grad_floats(n, m));
    float* mine = slot(0);
    float* X = staging(0);
    for (int i = threadIdx.x; i < wlen; i += blockDim.x) mine[i] = 0.f;
    for (int i = threadIdx.x; i < rows * (SM + SY); i += blockDim.x) X[i] = 0.f;
  }
  stage_weights(packed, smem);

  // the same tiles for each warp of a block
  for (int tile = blockIdx.x; tile * rows < B; tile += gridDim.x) {
    const int row0 = tile * rows + 16 * warp + g;
    float nom[NT][4], lower[NT][4], mu[2];
    unsigned m1[kMaskWords], m2[kMaskWords];
#pragma unroll
    for (int i = 0; i < kMaskWords; ++i) m1[i] = m2[i] = 0u;
    forward_rows<kMode>(h, xc, row0, B, n, m, vec_h, vec_xc, smem,
                        staging(16 * warp * SM), g, t, nom, m1, m2);
    int row = again(row0);
    if (kSquash) store_rows<NT>(dh, n, row, B, vec_h, t, 0, nom);  // park f~
    project_rows<kSquash>(h, row, B, vec_h, nom, lower, n, t, alpha_1, sigma_1,
                          alpha_2, qp_iters, mu);

    // projection VJP on the forward's active set
    float gsum[2] = {0.f, 0.f};
    int n_free[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float gv[1][4];
      load_rows<1>(gin, n, row, B, vec_h, t, j, gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * j + 2 * t + (e & 1) < n;
        if (valid && !((nom[j][e] - mu[e >> 1]) < lower[j][e])) {
          gsum[e >> 1] += gv[0][e];
          ++n_free[e >> 1];
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int nf = n_free[r];
      nf += __shfl_xor_sync(0xffffffffu, nf, 1);
      nf += __shfl_xor_sync(0xffffffffu, nf, 2);
      corr[r] = quad_sum(gsum[r]) / fmaxf((float)nf, 1.f);
    }
    float dft[NT][4];  // d f~
    const float barrier_slope = -again(alpha_1) * again(sigma_1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float gv[1][4], hv[1][4], ft[1][4], dhb[1][4];
      load_rows<1>(gin, n, row, B, vec_h, t, j, gv);
      load_rows<1>(h, n, row, B, vec_h, t, j, hv);
      if (kSquash) load_rows<1>(dh, n, row, B, vec_h, t, j, ft);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * j + 2 * t + (e & 1) < n;
        const bool active = (nom[j][e] - mu[e >> 1]) < lower[j][e];
        const float d = gv[0][e] - corr[e >> 1];
        const float hk = hv[0][e];
        const float df = active ? 0.f : d;  // d of the nominal f
        float dl = active ? d : 0.f;        // d of lower
        float dft_k = df, du = 0.f;
        if constexpr (kSquash) {
          const float sg = 1.f / (1.f + expf(-ft[0][e]));
          const float up = alpha_2 * (1.f - hk);
          dft_k = df * (up - lower[j][e]) * sg * (1.f - sg);
          dl += df * (1.f - sg);
          du = df * sg;
        }
        dft[j][e] = valid ? dft_k : 0.f;
        dhb[0][e] = dl * (barrier_slope * expf(sigma_1 * hk)) - alpha_2 * du;
      }
      store_rows<1>(dh, n, row, B, vec_h, t, j, dhb);  // park the barrier part
    }

    if (kWeightGrads) {  // dW3 = d f~^T z2 (z2 is in X), db3
      const float* X = staging(0);
      float* Y = staging(rows * SM);
      float* ys = Y + 16 * warp * SN;
#pragma unroll
      for (int j = 0; j < NT; ++j) stage(ys, SN, j, dft[j], g, t);
      __syncthreads();
      rows_product<(NT + 1) / 2, MT>(Y, SN, X, SM, slot(m * n + m * m), m, n,
                                     m, warp, warps, g, t);
      rows_sum(Y, SN, rows, n, slot(m * n + m * m + n * m + m));
      __syncthreads();
    }

    // d pre2 = (d f~ W3) [z2 > 0]
    float dp2[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp2[j][e] = 0.f;
    }
    product<true, S2, NT, 0, 0, MT>(dp2, dft, smem + kOffW3, g, t);
#pragma unroll
    for (int j = 0; j < MT; ++j) keep_bits(m2, j, dp2[j]);

    row = again(row);
    if (kWeightGrads) {  // dW2 = d pre2^T z1, db2
      float* X = staging(0);
      float* Y = staging(rows * SM);
      float* xs = X + 16 * warp * SM;
      float* ys = Y + 16 * warp * SM;
#pragma unroll
      for (int j = 0; j < MT; ++j) stage(ys, SM, j, dp2[j], g, t);
      {
        float z1[MT][4];
        first_layer(h, xc, row, B, n, m, vec_h, vec_xc, smem, g, t, z1);
#pragma unroll
        for (int j = 0; j < MT; ++j) stage(xs, SM, j, z1[j], g, t);
      }
      __syncthreads();
      rows_product<(MT + 1) / 2, MT>(Y, SM, X, SM, slot(m * n), m, m, m, warp,
                                     warps, g, t);
      rows_sum(Y, SM, rows, m, slot(m * n + m * m + n * m));
      // d pre2 comes back from Y: held in registers across the product it
      // would crowd out the product's own sums
#pragma unroll
      for (int j = 0; j < MT; ++j) unstage(ys, SM, j, dp2[j], g, t);
      __syncthreads();
    }

    float dhv[NT][4];  // d pre1 W1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dhv[j][e] = 0.f;
    }
    backward_chunks<kWeightGrads, 0>(dp2, dhv, m1, smem, dxc, row, B, m,
                                     vec_xc, staging(16 * warp * SM), g, t);

    row = again(row);
    if (kWeightGrads) {  // dW1 = d pre1^T h (d pre1 is in X)
      const float* X = staging(0);
      float* Y = staging(rows * SM);
      float* ys = Y + 16 * warp * SN;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float hv[1][4];
        load_rows<1>(h, n, row, B, vec_h, t, j, hv);
        stage(ys, SN, j, hv[0], g, t);
      }
      __syncthreads();
      rows_product<(MT + 1) / 2, NT>(X, SM, Y, SN, slot(0), n, m, n, warp,
                                     warps, g, t);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float dhb[1][4];
      load_rows<1>(dh, n, row, B, vec_h, t, j, dhb);
#pragma unroll
      for (int e = 0; e < 4; ++e) dhv[j][e] += dhb[0][e];
    }
    store_rows<NT>(dh, n, row, B, vec_h, t, 0, dhv);
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

// Shared memory of a block: the packed weights, and with weight gradients
// the staging buffers X and Y of 16 rows a warp.
size_t smem_bytes(int staged_warps) {
  return sizeof(float) *
         (kPackFloats + (size_t)16 * staged_warps * (SM + SY));
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

bool shape_fits(int n, int m, int warps) {
  return n >= 1 && m >= 1 && (n + 7) / 8 == NT && (m + 7) / 8 == MT &&
         warps >= 1 && warps <= kMaxWarps;
}

bool aligned8(const void* p) { return reinterpret_cast<size_t>(p) % 8 == 0; }

// Blocks of independent warps for n_blocks blocks' worth of tiles: as many
// as the card holds at once (the rest is walked by the grid-stride loop).
template <class Kernel>
int resident_grid(Kernel kernel, int warps, size_t smem, int n_blocks,
                  int* grid) {
  int sms = 0, per_sm = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, 32 * warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int held = sms * (per_sm > 1 ? per_sm : 1);
  *grid = n_blocks < held ? n_blocks : held;
  return 0;
}

}  // namespace

extern "C" {

const char* fused_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile counts this library was built for, and the floats of the packed
// weights it expects.
int fused_rhs_mlp_tiles() { return MT; }
int fused_rhs_state_tiles() { return NT; }
int fused_rhs_pack_floats() { return kPackFloats; }

// Shared memory a block needs when `staged_warps` warps stage their rows for
// the weight gradients (0: K1, and K2 without them), and the most a block
// may have.  A shape needing more is refused by the wrapper.
long long fused_rhs_smem_bytes(int staged_warps) {
  return static_cast<long long>(smem_bytes(staged_warps));
}

long long fused_rhs_smem_limit() { return static_cast<long long>(kSmemLimit); }

// Floats in one weight-gradient slot (and in the packed weight-gradient
// output): dW1 (m, n), dW2 (m, m), dW3 (n, m), db2 (m), db3 (n).
int fused_rhs_grad_floats(int n, int m) {
  return static_cast<int>(grad_floats(n, m));
}

// All pointers are device pointers to contiguous float32 arrays: h (B, n),
// xc (B, m), packed (fused_rhs_pack_floats(), 16-byte aligned), out (B, n).
// A block has `warps` warps.  Returns a cudaError_t (0 on success).
int fused_rhs_forward(const float* h, const float* xc, const float* packed,
                      float* out, int B, int n, int m, float alpha_1,
                      float sigma_1, float alpha_2, int scale_nominal,
                      int qp_iters, int warps, void* stream) {
  if (B < 0 || qp_iters < 0 || !shape_fits(n, m, warps) ||
      reinterpret_cast<size_t>(packed) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = smem_bytes(0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      scale_nominal ? fused_rhs_kernel<true> : fused_rhs_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  const int rc = resident_grid(kernel, warps, smem,
                               ((B + 15) / 16 + warps - 1) / warps, &grid);
  if (rc != 0) return rc;
  const int vec_h = n % 2 == 0 && aligned8(h) && aligned8(out);
  const int vec_xc = m % 2 == 0 && aligned8(xc);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      h, xc, packed, out, B, n, m, alpha_1, sigma_1, alpha_2, qp_iters, vec_h,
      vec_xc);
  return static_cast<int>(cudaGetLastError());
}

// VJP of fused_rhs_forward for the cotangent g (B, n): writes dh (B, n) and
// dxc (B, m).  If dw is not null it also writes the weight gradients packed
// as [dW1 (m, n) | dW2 (m, m) | dW3 (n, m) | db2 (m) | db3 (n)], using ws
// (ws_slots slots of fused_rhs_grad_floats(n, m) floats; one slot per block,
// at most one block per SM) as scratch.  Returns a cudaError_t (0 on
// success).
int fused_rhs_backward(const float* h, const float* xc, const float* g,
                       const float* packed, float* dh, float* dxc, float* dw,
                       float* ws, int ws_slots, int B, int n, int m,
                       float alpha_1, float sigma_1, float alpha_2,
                       int scale_nominal, int qp_iters, int warps,
                       void* stream) {
  if (B < 0 || qp_iters < 0 || !shape_fits(n, m, warps) ||
      reinterpret_cast<size_t>(packed) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool weight_grads = dw != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wlen = static_cast<int>(grad_floats(n, m));
  if (B == 0) {
    if (!weight_grads) return 0;
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)wlen, s));
  }
  const size_t smem = smem_bytes(weight_grads ? warps : 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      scale_nominal
          ? (weight_grads ? fused_rhs_backward_kernel<true, true>
                          : fused_rhs_backward_kernel<true, false>)
          : (weight_grads ? fused_rhs_backward_kernel<false, true>
                          : fused_rhs_backward_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (B + 16 * warps - 1) / (16 * warps);
  int grid = 0;
  if (weight_grads) {  // one block and one slot per SM
    int sms = 0;
    const int rc = sm_count(&sms);
    if (rc != 0) return rc;
    grid = n_blocks < sms ? n_blocks : sms;
    if (ws == nullptr || ws_slots < grid) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    const int rc = resident_grid(kernel, warps, smem, n_blocks, &grid);
    if (rc != 0) return rc;
  }
  const int vec_h = n % 2 == 0 && aligned8(h) && aligned8(g) && aligned8(dh);
  const int vec_xc = m % 2 == 0 && aligned8(xc) && aligned8(dxc);
  kernel<<<grid, 32 * warps, smem, s>>>(h, xc, g, packed, dh, dxc, ws, B, n, m,
                                        alpha_1, sigma_1, alpha_2, qp_iters,
                                        vec_h, vec_xc);
  err = cudaGetLastError();
  if (err != cudaSuccess || !weight_grads) return static_cast<int>(err);
  const int rgrid = (wlen + kReduceThreads - 1) / kReduceThreads;
  reduce_slots_kernel<<<rgrid, kReduceThreads, 0, s>>>(ws, grid, wlen, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
