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
// s: layer 1's neurons not off; D and d: its unstable ones; layer 3's two
// products: layer 2's), and layer 3 with its last split and product only
// over layer 1's columns not off, where an off column adds exact zeros; all
// in increasing order: the sums are those of the dense loop with its exact
// zeros left out, bit for bit, but for the order of the sums over a row's
// lanes, and the work is about a quarter.
//
// * A block walks tiles of 16 rows with 256 threads: the 16 threads of a
//   half-warp own one row.  In layers 1 and 2 thread t owns the columns t,
//   t + 16, ... of the layer (C1 = m1 / 16, C2 = m2 / 16 of them) and in
//   layer 2 keeps S and D for all n eta slots of its C2 outputs, so the
//   concretisation's sums over the eta axis are its own epilogue: (2 n +
//   2) C2 = 176 accumulators at the flagship, one block of 8 warps a SM,
//   255 registers a thread and no spill.  The two rows of a warp walk their
//   own lists side by side, to the longer one's end (the shorter adds
//   zeros), each reading its next index ahead.
// * Layer 3 runs over the row's list of layer 1's neurons not off, dealt
//   to the lanes a column of 16 entries at a time: lane t takes the
//   entries 16 c + t, and keeps the two (out x C) forms of its C columns.
//   C is what the longer list of the warp's two rows needs (ceil(n / 16),
//   at most 8 a pass: one pass up to m1 = 128, a second one past it), so
//   the work follows each row's own list: about 4-5 columns a lane on the
//   certify grid instead of 8.  Each width is its own instance of the
//   pass, a loop over the list with no unrolling.
// * The lists are made where the slopes are (a ballot over the row's lanes
//   per column, so in increasing neuron order) and kept in shared memory
//   beside a row's stage: (a_up, a_lo, b_up, b1 + x_bias) a layer-1 neuron
//   and (a_up, a_lo) a layer-2 neuron; the sums and differences the
//   products take are made from them at use, with the same float32
//   operations.  Layer 3 takes the sign split of W3 in the same factored
//   form as layer 2: Lu2 = (W3 (a_up + a_lo) + |W3| (a_up - a_lo)) / 2 is
//   W3+ a_up + W3- a_lo, so its product with W2 is two scaled products
//   summed after the loops.
// * The weights sit in shared memory for a block's whole walk, loaded once
//   (the grid holds one block per SM, each walking many tiles).  W2 is kept
//   once, row-major with an odd row stride m1 + 1: layer 2 reads a column
//   (W2[t + 16 c][i] for fixed i) and layer 3 a row (W2[i][j] over a run
//   of a list), both with few bank conflicts; |W2| and |W3| are taken on
//   load into the register.  A row of W1 (an odd multiple of 4 floats) and
//   of W3^T are float4 reads.
// * What a row's 16 threads hold in parts (layer 3's 2 out bias terms from
//   layer 2, and from a pass its 2 out x (n + 1) sums, one eta slot at a
//   time) is added over the lanes by four halving steps: at each a lane
//   keeps one of each pair of values and adds its partner's copy of it, so
//   each sum is the butterfly's bit for bit, in about one shuffle a value
//   instead of four.  The lane that holds a sum adds it into the row's slot
//   in shared memory; the concretisation of each of the 2 out bounds reads
//   its n + 1 slots.  The loop over the eta slots is not unrolled: unrolled,
//   it and the rest of layer 3 were long enough to slow the whole kernel.
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
constexpr int kLanes = 16;            // threads of a row
constexpr int C1 = (M1 + kLanes - 1) / kLanes;  // layer-1 columns a thread
constexpr int C2 = (M2 + kLanes - 1) / kLanes;  // layer-2 columns a thread
constexpr int M1P = kLanes * C1, M2P = kLanes * C2;
// layer 1's columns a lane takes in one pass of layer 3: all of them up to
// m1 = 128
constexpr int kPass = C1 < 8 ? C1 : 8;
constexpr int kSums = 2 * OUT;          // the out bounds' two sides
// per row, each side's form over eta and its constant
constexpr int kSlots = kSums * (KN + 1);
constexpr int P2 = M1P + 1;   // row stride of W2 (odd)
constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// row stride of W1: an odd multiple of 4 floats, read as float4
constexpr int S1 = round4(KN) / 4 % 2 == 1 ? round4(KN) : round4(KN) + 4;
constexpr int S3 = round4(OUT);  // row stride of W3^T
constexpr size_t kSmemLimit = 232448;  // per-block dynamic shared memory
// shared memory, in floats: the weights once, then per row its stage,
// slots, lists, etas and bias terms
constexpr int kWeightFloats =
    M2P * S3 + M1P * S1 + M2P * P2 + M1P + M2P + OUT;
constexpr int kRowFloats =
    4 * M1P + 2 * M2P + kSlots + (M1P + M2P) + 4 + 2 * KN + 2 * OUT;
constexpr bool fits(int rows) {
  return sizeof(float) * (rows * kRowFloats + kWeightFloats) <= kSmemLimit;
}
// rows of a tile: 16, or the most of 8, 4, 2 that fit (a shape with many
// outputs and eta slots, whose slots take the room)
constexpr int kRows = fits(16) ? 16 : fits(8) ? 8 : fits(4) ? 4 : 2;
constexpr int kThreads = kLanes * kRows;
// the arrays read as float4 first, then float2
constexpr int kOffStage1 = 0;                           // float4 [kRows][M1P]
constexpr int kOffW3 = kOffStage1 + 4 * kRows * M1P;    // [M2P][S3]
constexpr int kOffW1 = kOffW3 + M2P * S3;               // [M1P][S1]
constexpr int kOffStage2 = kOffW1 + M1P * S1;           // float2 [kRows][M2P]
constexpr int kOffSlots = kOffStage2 + 2 * kRows * M2P; // [kRows][kSlots]
constexpr int kOffW2 = kOffSlots + kRows * kSlots;      // [M2P][P2]
constexpr int kOffB1 = kOffW2 + M2P * P2;
constexpr int kOffB2 = kOffB1 + M1P;
constexpr int kOffB3 = kOffB2 + M2P;
constexpr int kOffEta = kOffB3 + OUT;                   // [kRows][KN]
constexpr int kOffEps = kOffEta + kRows * KN;           // [kRows][KN]
constexpr int kOffC3 = kOffEps + kRows * KN;            // [kRows][kSums]
// the lists (unsigned short) and their lengths (int), per row: layer 1's
// neurons not off and unstable ones, then layer 2's
constexpr int kOffLists = kOffC3 + kRows * kSums;
constexpr int kOffCounts = kOffLists + kRows * (M1P + M2P);
constexpr int kFloats = kOffCounts + kRows * 4;
constexpr size_t kSmemBytes = sizeof(float) * kFloats;
static_assert(kFloats == kRows * kRowFloats + kWeightFloats,
              "the layout and its count agree");

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

// What layer 2's products take of a layer-1 neuron's stage (a_up, a_lo,
// b_up, b1 + x_bias): a_up +- a_lo, and u +- l of its relu lines at the
// affine bias point (b_lo is 0).
struct Layer1 {
  float sum, diff, u_plus_l, u_minus_l;
};

__device__ __forceinline__ Layer1 layer1(float4 q) {
  const float u_vec = __fadd_rn(__fmul_rn(q.x, q.w), q.z);
  const float l_vec = __fmul_rn(q.y, q.w);
  return {q.x + q.y, q.x - q.y, u_vec + l_vec, u_vec - l_vec};
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

// ---- the sums over a row's 16 lanes --------------------------------------
// One halving step over the lanes t and t ^ S: of each pair (v[2q],
// v[2q + 1]) the lane whose bit S is clear keeps the first and sends the
// second, its partner the other way round, and each adds what it receives
// to what it kept; an odd last value is added whole (a butterfly step).
// the values a lane holds after each of the four steps over kSums
constexpr int kH1 = (kSums + 1) / 2, kH2 = (kH1 + 1) / 2,
              kH3 = (kH2 + 1) / 2, kH4 = (kH3 + 1) / 2;

template <int V, int S>
__device__ __forceinline__ void halve(const float (&v)[V],
                                      float (&u)[(V + 1) / 2], bool hi) {
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    const float send = hi ? v[2 * q] : v[2 * q + 1];
    const float keep = hi ? v[2 * q + 1] : v[2 * q];
    u[q] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if (V % 2 == 1) {
    u[V / 2] = v[V - 1] + __shfl_xor_sync(0xffffffffu, v[V - 1], S);
  }
}

template <int V>
__device__ __forceinline__ void step_ids(const int (&id)[V],
                                         const bool (&own)[V],
                                         int (&nid)[(V + 1) / 2],
                                         bool (&nown)[(V + 1) / 2], bool hi) {
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    nid[q] = hi ? id[2 * q + 1] : id[2 * q];
    nown[q] = hi ? own[2 * q + 1] : own[2 * q];
  }
  if (V % 2 == 1) {
    nid[V / 2] = id[V - 1];
    nown[V / 2] = own[V - 1] && !hi;
  }
}

// The sums over the row's lanes of each lane's v[0..kSums): after it, this
// lane's s[q] is the sum of value id[q], and own[q] says whether this lane
// is the one of those holding it that writes it.
constexpr int kHeld = kH4;
struct RowSumIds {
  int id[kHeld];
  bool own[kHeld];
};

__device__ __forceinline__ RowSumIds row_sum_ids() {
  const int t = threadIdx.x & (kLanes - 1);
  int i0[kSums];
  bool o0[kSums];
#pragma unroll
  for (int v = 0; v < kSums; ++v) {
    i0[v] = v;
    o0[v] = true;
  }
  int i1[kH1], i2[kH2], i3[kH3];
  bool o1[kH1], o2[kH2], o3[kH3];
  RowSumIds r;
  step_ids<kSums>(i0, o0, i1, o1, t & 8);
  step_ids<kH1>(i1, o1, i2, o2, t & 4);
  step_ids<kH2>(i2, o2, i3, o3, t & 2);
  step_ids<kH3>(i3, o3, r.id, r.own, t & 1);
  return r;
}

__device__ __forceinline__ void row_sums(const float (&v)[kSums],
                                         float (&s)[kHeld]) {
  const int t = threadIdx.x & (kLanes - 1);
  float a[kH1], b[kH2], c[kH3];
  halve<kSums, 8>(v, a, t & 8);
  halve<kH1, 4>(a, b, t & 4);
  halve<kH2, 2>(b, c, t & 2);
  halve<kH3, 1>(c, s, t & 1);
}

// Appends this lane's neuron (if `in`) to the row's list at `n`, in lane
// order, and advances `n` by the row's count; the lanes of one half-warp
// are one row.
__device__ __forceinline__ void append(bool in, int neuron,
                                       unsigned short* list,
                                       int& n) {
  const int lane = threadIdx.x & 31;
  const unsigned row_bits = __ballot_sync(0xffffffffu, in) >> (lane & 16);
  const unsigned below = row_bits & ((1u << (lane & 15)) - 1u);
  if (in) list[n + __popc(below)] = static_cast<unsigned short>(neuron);
  n += __popc(row_bits & 0xffffu);
}

// the j-th neuron of a row's list of n, 0 past its end
__device__ __forceinline__ int entry(const unsigned short* list, int j,
                                     int n) {
  return j < n ? list[j] : 0;
}

// the longer of the two lists of a warp's rows
__device__ __forceinline__ int warp_len(int n) {
  const int other = __shfl_xor_sync(0xffffffffu, n, 16);
  return n > other ? n : other;
}

// What a pass of layer 3 reads of its row.
struct Row {
  const float4* stage1;          // (a_up, a_lo, b_up, b1 + x_bias) [M1P]
  const float2* stage2;          // (a_up, a_lo) [M2P]
  const unsigned short* live1;   // layer 1's neurons not off
  const unsigned short* live2;   // layer 2's neurons not off
  const unsigned short* unst2;   // layer 2's unstable neurons
  int n1, n_live2, n_unst2;
  float* slots;                  // [kSums][KN + 1]
};

// One pass of layer 3 over the entries 16 (g + c) + t, c < PC, of the row's
// list of layer 1's neurons not off: (W3 split by layer 2's slopes) . W2 on
// those columns, as two scaled products over layer 2's lists, then the
// split against layer 1's slopes, its bias terms and . W1, each summed over
// the lanes into the row's slots.
template <int PC>
__device__ __forceinline__ void layer3_pass(const Row& rw, int g,
                                            const float* sm,
                                            const RowSumIds& ids) {
  const int t = threadIdx.x & (kLanes - 1);
  const float* W1s = sm + kOffW1;
  const float* W2s = sm + kOffW2;
  int col[PC];
  bool valid[PC];
#pragma unroll
  for (int c = 0; c < PC; ++c) {
    const int pos = kLanes * (g + c) + t;
    valid[c] = pos < rw.n1;
    col[c] = valid[c] ? rw.live1[pos] : 0;
  }
  float A[OUT][PC], B[OUT][PC];
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
#pragma unroll
    for (int c = 0; c < PC; ++c) A[o][c] = B[o][c] = 0.f;
  }
  {
    const int len = warp_len(rw.n_live2);
    int next = entry(rw.live2, 0, rw.n_live2);
#pragma unroll 1
    for (int j = 0; j < len; ++j) {
      const bool on = j < rw.n_live2;
      const int i = next;  // the next one's index is read ahead
      next = entry(rw.live2, j + 1, rw.n_live2);
      const float2 q = rw.stage2[i];
      const float qx = on ? q.x + q.y : 0.f;  // a_up + a_lo
      float w[PC];
#pragma unroll
      for (int c = 0; c < PC; ++c) w[c] = W2s[i * P2 + col[c]];
#pragma unroll
      for (int v = 0; v < S3 / 4; ++v) {
        const float4 x = lds4(sm + kOffW3 + i * S3 + 4 * v);
        const float w3[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 4 * v + e;
          if (o < OUT) {
            const float ts = qx * w3[e];
#pragma unroll
            for (int c = 0; c < PC; ++c) A[o][c] = fmaf(ts, w[c], A[o][c]);
          }
        }
      }
    }
  }
  {
    const int len = warp_len(rw.n_unst2);
    int next = entry(rw.unst2, 0, rw.n_unst2);
#pragma unroll 1
    for (int j = 0; j < len; ++j) {
      const bool on = j < rw.n_unst2;
      const int i = next;  // the next one's index is read ahead
      next = entry(rw.unst2, j + 1, rw.n_unst2);
      const float2 q = rw.stage2[i];
      const float qy = on ? q.x - q.y : 0.f;  // a_up - a_lo
      float w[PC];
#pragma unroll
      for (int c = 0; c < PC; ++c) w[c] = W2s[i * P2 + col[c]];
#pragma unroll
      for (int v = 0; v < S3 / 4; ++v) {
        const float4 x = lds4(sm + kOffW3 + i * S3 + 4 * v);
        const float w3[4] = {fabsf(x.x), fabsf(x.y), fabsf(x.z), fabsf(x.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 4 * v + e;
          if (o < OUT) {
            const float td = qy * w3[e];
#pragma unroll
            for (int c = 0; c < PC; ++c) B[o][c] = fmaf(td, w[c], B[o][c]);
          }
        }
      }
    }
  }
  // the split against layer 1's slopes: A and B become this lane's Lu and
  // Ll, and its parts of the bias terms are summed over the lanes
  {
    float cp[kSums];
#pragma unroll
    for (int v = 0; v < kSums; ++v) cp[v] = 0.f;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      // a_up, a_lo, b_up, b1 + x_bias; zeros past the list's end
      const float4 q =
          valid[c] ? rw.stage1[col[c]] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        const float vu = 0.5f * (A[o][c] + B[o][c]);
        const float vl = 0.5f * (A[o][c] - B[o][c]);
        const float up = fmaxf(vu, 0.f), un = fminf(vu, 0.f);
        const float lp = fmaxf(vl, 0.f), ln = fminf(vl, 0.f);
        const float Lu = up * q.x + un * q.y;
        const float Ll = lp * q.y + ln * q.x;
        cp[o] += up * q.z + Lu * q.w;
        cp[OUT + o] += ln * q.z + Ll * q.w;
        A[o][c] = Lu;
        B[o][c] = Ll;
      }
    }
    float s[kHeld];
    row_sums(cp, s);
#pragma unroll
    for (int q = 0; q < kHeld; ++q) {
      if (ids.own[q]) rw.slots[ids.id[q] * (KN + 1) + KN] += s[q];
    }
  }
  // . W1, one eta slot at a time, summed over the lanes
#pragma unroll 1
  for (int k = 0; k < KN; ++k) {
    float w[PC];
#pragma unroll
    for (int c = 0; c < PC; ++c) w[c] = lds(W1s + col[c] * S1 + k);
    float f[kSums];
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      f[o] = f[OUT + o] = 0.f;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        f[o] = fmaf(A[o][c], w[c], f[o]);
        f[OUT + o] = fmaf(B[o][c], w[c], f[OUT + o]);
      }
    }
    float s[kHeld];
    row_sums(f, s);
#pragma unroll
    for (int q = 0; q < kHeld; ++q) {
      if (ids.own[q]) rw.slots[ids.id[q] * (KN + 1) + k] += s[q];
    }
  }
}

// the pass over `cols` (1..P) columns a lane
template <int P>
__device__ __forceinline__ void layer3_pass_of(int cols, const Row& rw, int g,
                                               const float* sm,
                                               const RowSumIds& ids) {
  if constexpr (P > 1) {
    if (cols < P) {
      layer3_pass_of<P - 1>(cols, rw, g, sm, ids);
      return;
    }
  }
  layer3_pass<P>(rw, g, sm, ids);
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
    sm[kOffW3 + e] = (i < M2 && o < OUT) ? a.W3[o * M2 + i] : 0.f;
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
  float4* stage1 = reinterpret_cast<float4*>(sm + kOffStage1) + r * M1P;
  float2* stage2 = reinterpret_cast<float2*>(sm + kOffStage2) + r * M2P;
  float* slots = sm + kOffSlots + r * kSlots;
  unsigned short* live1 =
      reinterpret_cast<unsigned short*>(sm + kOffLists) + r * 2 * (M1P + M2P);
  unsigned short* unst1 = live1 + M1P;
  unsigned short* live2 = unst1 + M1P;
  unsigned short* unst2 = live2 + M2P;
  int* counts = reinterpret_cast<int*>(sm + kOffCounts) + r * 4;
  const float* eta_r = sm + kOffEta + r * KN;
  const float* eps_r = sm + kOffEps + r * KN;
  float* c3 = sm + kOffC3 + r * kSums;
  const RowSumIds ids = row_sum_ids();
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
        const float4 st = make_float4(q.a_up, q.a_lo, q.b_up, b1 + xb);
        stage1[i] = st;
        // what this neuron adds to S and s, and to D and d
        const Layer1 p = layer1(st);
        append(i < M1 && (p.sum != 0.f || p.u_plus_l != 0.f), i, live1,
               n_live);
        append(i < M1 && (p.diff != 0.f || p.u_minus_l != 0.f), i, unst1,
               n_unst);
      }
      if (t == 0) {
        counts[0] = n_live;
        counts[1] = n_unst;
      }
    }
    __syncwarp();

    // ---- layer 2: S, D and s, d of this thread's C2 outputs over the
    // row's lists, then their concretisation and relaxation --------------
    float bu2[C2];  // layer 2's b_up on this thread's columns
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
        const Layer1 p = layer1(stage1[i]);
        const float qx = on ? p.sum : 0.f, qz = on ? p.u_plus_l : 0.f;
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
        const Layer1 p = layer1(stage1[i]);
        const float qy = on ? p.diff : 0.f, qw = on ? p.u_minus_l : 0.f;
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
        stage2[o2] = make_float2(q.a_up, q.a_lo);
        bu2[c] = q.b_up;
        append(o2 < M2 && q.a_up + q.a_lo != 0.f, o2, live2, n_live2);
        append(o2 < M2 && q.a_up - q.a_lo != 0.f, o2, unst2, n_unst2);
      }
      if (t == 0) {
        counts[2] = n_live2;
        counts[3] = n_unst2;
      }
    }
    // layer 3's terms on this thread's layer-2 neurons: their bias lines
    // (b_lo is 0) and b2 through W3 split by sign, summed over the row
    {
      float p[kSums];  // upper at o, lower at OUT + o
#pragma unroll
      for (int v = 0; v < kSums; ++v) p[v] = 0.f;
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        const int o2 = t + kLanes * c;
        const float2 q = stage2[o2];  // this thread's own: a_up, a_lo
        const float b2 = sm[kOffB2 + o2];
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          const float w3 = sm[kOffW3 + o2 * S3 + o];
          const float wp = fmaxf(w3, 0.f), wn = fminf(w3, 0.f);
          p[o] += wp * bu2[c] + (wp * q.x + wn * q.y) * b2;
          p[OUT + o] += wn * bu2[c] + (wp * q.y + wn * q.x) * b2;
        }
      }
      float s[kHeld];
      row_sums(p, s);
#pragma unroll
      for (int q = 0; q < kHeld; ++q) {
        if (ids.own[q]) c3[ids.id[q]] = s[q];
      }
      for (int e = t; e < kSlots; e += kLanes) slots[e] = 0.f;
    }
    __syncwarp();

    // ---- layer 3 over layer 1's columns not off, in passes --------------
    {
      const Row rw{stage1, stage2, live1, live2, unst2,
                   counts[0], counts[2], counts[3], slots};
      const int cols = (warp_len(rw.n1) + kLanes - 1) / kLanes;
      for (int g = 0; g < cols; g += kPass) {
        layer3_pass_of<kPass>(cols - g, rw, g, sm, ids);
      }
    }
    __syncwarp();
    // the concretisation of each bound from its slots
    for (int v = t; v < kSums; v += kLanes) {
      const int o = v < OUT ? v : v - OUT;
      float L[KN];
#pragma unroll
      for (int k = 0; k < KN; ++k) L[k] = slots[v * (KN + 1) + k];
      const float c = (sm[kOffB3 + o] + c3[v]) + slots[v * (KN + 1) + KN];
      const float bound = concretise<kRowEps>(L, c, v < OUT ? 1.f : -1.f,
                                              eta_r, eps_r, a.eps_scalar);
      if (live) (v < OUT ? a.ub : a.lb)[row * OUT + o] = bound;
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
// takes and may have, and the rows of a block.
int fused_crown_shape(int which) {
  const int dims[4] = {KN, M1, M2, OUT};
  return which >= 0 && which < 4 ? dims[which] : -1;
}

long long fused_crown_smem_bytes() { return static_cast<long long>(kSmemBytes); }

long long fused_crown_smem_limit() { return static_cast<long long>(kSmemLimit); }

int fused_crown_rows() { return kRows; }

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
