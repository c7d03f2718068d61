// Causal grouped-query flash attention for Hopper (sm_90a): the forward,
// and the backward as three kernels (a delta = rowsum(dO * O) pre-pass, a
// dK/dV kernel and a dQ kernel), FA2's shape.
//
// Replaces: ray_tpu/ops/attention.py::full_causal_attention's kernel, the
// Pallas TPU library flash attention (jax.experimental.pallas.ops.tpu.
// flash_attention, forward and backward, causal=True). Same function:
// q [B,S,H,D], k/v [B,S,KH,D] in ray_tpu's BSHD layout (read in place, no
// transposes), query i attends to keys 0..i, logits and softmax in f32,
// sm_scale given by the caller (D^-0.5 by default); the output in the
// input dtype and the log-sum-exp lse [B,H,S] in f32, which the backward
// reads instead of any saved probabilities.
//
// Bound on the H100: operations. At the training shape (B=1, S=2048,
// H=32, D=128) the forward does 4*S*S/2*D*H = 34 GFLOP on 50 MB of
// operands, ~700 flops a byte, well above the ~295 where the card stops
// being memory-bound. So the products go to the tensor cores, and the
// design keeps the S x S matrices out of device memory:
//
//   * The TPU kernel walks kv blocks in order on one core with the softmax
//     carry in VMEM. Here one CTA owns a 64-row q tile of one head (four
//     warps, 16 rows each) and loops over the kv tiles in shared memory up
//     to the diagonal tile, where it masks; the online-softmax carry
//     (row max, row sum, the 16 x D accumulator) stays in registers. Late q
//     tiles have the most kv tiles and are launched first.
//   * Products are mma.sync m16n8k16 (bf16 in, f32 accumulate). Shared-
//     memory rows are padded by 16 bytes, so every fragment load below is
//     free of bank conflicts. P leaves the accumulator registers as the
//     next product's A operand directly (the C and A fragment layouts
//     line up), so P never touches shared memory. P is rounded to bf16 for
//     the P*V product before it is normalised; the plain version
//     normalises first (tolerance in ops/flash_attention.py).
//   * f32 inputs (tests, the f32 model check) run the same kernels with
//     each operand split in two bf16 halves, x = hi + lo, and three
//     products hi*hi + hi*lo + lo*hi: about 16 mantissa bits, where one
//     bf16 product would keep 8.
//   * GQA: the CTA of query head h reads kv head h / (H/KH); K/V are never
//     repeated in memory.
//   * Backward: the dK/dV kernel gives one CTA to a 64-row kv tile of one
//     KV head; it loops over the H/KH query heads of its group and over
//     the q tiles from the diagonal on, recomputes P^T from lse, and sums
//     dV += P^T dO and dK += dS^T Q with dS = P * (dP - delta) in
//     registers: the GQA sum happens inside the CTA, with no atomics. The
//     dQ kernel gives one CTA to a 64-row q tile and loops over kv tiles
//     up to the diagonal. Every sum runs in a fixed order, so the backward
//     is deterministic, and so is the forward that remat runs twice.
//   * Loads are plain 16-byte loads through registers into shared memory;
//     cp.async/TMA rings and wgmma are later work.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// An R x D tile of bf16 in shared memory, row stride D + 8. SPLIT keeps a
// second tile holding the low halves of f32 values.
template <int R, int D, bool SPLIT>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int ELEMS = R * LD;
  static constexpr int BYTES = ELEMS * 2 * (SPLIT ? 2 : 1);
  bf16* hi;
  bf16* lo;
  __device__ explicit Tile(unsigned char* base)
      : hi(reinterpret_cast<bf16*>(base)),
        lo(reinterpret_cast<bf16*>(base) + ELEMS) {}
};

// Rows row0 .. row0+R-1 of a [.., S, .., D] operand whose row r starts at
// src + r * rs; rows at or past S are zero.
template <int R, int D, bool SPLIT>
__device__ __forceinline__ void load_tile(Tile<R, D, SPLIT> t, const bf16* src,
                                          size_t rs, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs +
                                               col));
    *reinterpret_cast<uint4*>(t.hi + r * Tile<R, D, SPLIT>::LD + col) = v;
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int R, int D, bool SPLIT>
__device__ __forceinline__ void load_tile(Tile<R, D, SPLIT> t,
                                          const float* src, size_t rs,
                                          int row0, int S) {
  static_assert(SPLIT, "f32 operands need the split tile");
  constexpr int CH = D / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * rs +
                                                col));
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
    const int off = r * Tile<R, D, SPLIT>::LD + col;
    *reinterpret_cast<uint2*>(t.hi + off) =
        make_uint2(bf16x2_bits(h01), bf16x2_bits(h23));
    *reinterpret_cast<uint2*>(t.lo + off) =
        make_uint2(bf16x2_bits(l01), bf16x2_bits(l23));
  }
}

// mma.sync m16n8k16 fragments (PTX ISA, "Matrix fragments for
// mma.m16n8k16"); g = lane / 4, t = lane % 4. A is 16 x 16 row-major:
// x[0] = A[g][2t..2t+1], x[1] = A[g+8][2t..], x[2] = A[g][2t+8..],
// x[3] = A[g+8][2t+8..]. B is 16 x 8: x[0] = B[2t..2t+1][g],
// x[1] = B[2t+8..2t+9][g]. C is 16 x 8: c[0..1] = C[g][2t..2t+1],
// c[2..3] = C[g+8][2t..2t+1]. The element with the lower index sits in
// the lower 16 bits of each register.
struct FragA {
  uint32_t h[4], l[4];
};
struct FragB {
  uint32_t h[2], l[2];
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool SPLIT>
__device__ __forceinline__ void mma(float* c, const FragA& a,
                                    const FragB& b) {
  if (SPLIT) {  // the small terms first
    mma_bf16(c, a.l, b.h);
    mma_bf16(c, a.h, b.l);
  }
  mma_bf16(c, a.h, b.h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A[m0 .. m0+15][k0 .. k0+15] of a row-major [m][k] tile.
template <int LD, bool SPLIT>
__device__ __forceinline__ void load_a(FragA& a, const bf16* hi,
                                       const bf16* lo, int m0, int k0,
                                       int lane) {
  const int off = (m0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  a.h[0] = ld32(hi + off);
  a.h[1] = ld32(hi + off + 8 * LD);
  a.h[2] = ld32(hi + off + 8);
  a.h[3] = ld32(hi + off + 8 * LD + 8);
  if (SPLIT) {
    a.l[0] = ld32(lo + off);
    a.l[1] = ld32(lo + off + 8 * LD);
    a.l[2] = ld32(lo + off + 8);
    a.l[3] = ld32(lo + off + 8 * LD + 8);
  }
}

// B[k0 .. k0+15][n0 .. n0+7] where the tile holds B^T row-major ([n][k]).
template <int LD, bool SPLIT>
__device__ __forceinline__ void load_b(FragB& b, const bf16* hi,
                                       const bf16* lo, int n0, int k0,
                                       int lane) {
  const int off = (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b.h[0] = ld32(hi + off);
  b.h[1] = ld32(hi + off + 8);
  if (SPLIT) {
    b.l[0] = ld32(lo + off);
    b.l[1] = ld32(lo + off + 8);
  }
}

// B[k0 .. k0+15][n0 .. n0+7] where the tile holds B row-major ([k][n]):
// the pairs run down a column, so each is two 16-bit loads.
template <int LD, bool SPLIT>
__device__ __forceinline__ void load_bt(FragB& b, const bf16* hi,
                                        const bf16* lo, int k0, int n0,
                                        int lane) {
  const int off = (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  const unsigned short* ph = reinterpret_cast<const unsigned short*>(hi) + off;
  b.h[0] = (uint32_t)ph[0] | ((uint32_t)ph[LD] << 16);
  b.h[1] = (uint32_t)ph[8 * LD] | ((uint32_t)ph[9 * LD] << 16);
  if (SPLIT) {
    const unsigned short* pl =
        reinterpret_cast<const unsigned short*>(lo) + off;
    b.l[0] = (uint32_t)pl[0] | ((uint32_t)pl[LD] << 16);
    b.l[1] = (uint32_t)pl[8 * LD] | ((uint32_t)pl[9 * LD] << 16);
  }
}

template <bool SPLIT>
__device__ __forceinline__ void pack(uint32_t& h, uint32_t& l, float x,
                                     float y) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
  h = bf16x2_bits(hv);
  if (SPLIT) {
    const float2 hf = __bfloat1622float2(hv);
    l = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
  }
}

// The A fragment of columns 16kk .. 16kk+15 of a 16-row accumulator held
// as n8 tiles c0 = acc[2kk], c1 = acc[2kk+1].
template <bool SPLIT>
__device__ __forceinline__ void a_from_acc(FragA& a, const float* c0,
                                           const float* c1) {
  pack<SPLIT>(a.h[0], a.l[0], c0[0], c0[1]);
  pack<SPLIT>(a.h[1], a.l[1], c0[2], c0[3]);
  pack<SPLIT>(a.h[2], a.l[2], c1[0], c1[1]);
  pack<SPLIT>(a.h[3], a.l[3], c1[2], c1[3]);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// acc [D/8][4] rows (g, g+8) of a warp's 16 rows, times `mul`, into rows
// r0 and r0 + 8 of dst (row stride rs); rows at or past S are skipped.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, size_t rs, int r0, int S,
                                           float (*acc)[4], float mul0,
                                           float mul1, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < S)
      store2(dst + (size_t)r0 * rs + col, acc[j][0] * mul0, acc[j][1] * mul0);
    if (r0 + 8 < S)
      store2(dst + (size_t)(r0 + 8) * rs + col, acc[j][2] * mul1,
             acc[j][3] * mul1);
  }
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (16 x N) += A (16 x D, rows m0.. of a) * B^T (N rows n0.. of b).
template <int D, int N, int LD, bool SPLIT>
__device__ __forceinline__ void qk(float (*s)[4], const bf16* ahi,
                                   const bf16* alo, int m0, const bf16* bhi,
                                   const bf16* blo, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA a;
    load_a<LD, SPLIT>(a, ahi, alo, m0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      FragB b;
      load_b<LD, SPLIT>(b, bhi, blo, j * 8, kk * 16, lane);
      mma<SPLIT>(s[j], a, b);
    }
  }
}

// acc (16 x D) += P (16 x N, accumulator registers) * V (N x D tile, [k][n]).
template <int D, int N, int LD, bool SPLIT>
__device__ __forceinline__ void pv(float (*acc)[4], float (*p)[4],
                                   const bf16* vhi, const bf16* vlo,
                                   int lane) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    FragA a;
    a_from_acc<SPLIT>(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      FragB b;
      load_bt<LD, SPLIT>(b, vhi, vlo, kk * 16, j * 8, lane);
      mma<SPLIT>(acc[j], a, b);
    }
  }
}

constexpr int kBlockM = 64;   // q rows of a forward / dQ CTA, kv rows of a
                              // dK/dV CTA (16 per warp)
constexpr int kBlockN = 64;   // kv rows per step of the forward / dQ loop
constexpr int kBlockQ = 32;   // q rows per step of the dK/dV loop

struct Shape {
  int S, H, KH;
  float scale;  // natural-log softmax scale
};

// ------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, const Shape sh) {
  constexpr bool SPLIT = IsF32<T>::value;
  using TM = Tile<kBlockM, D, SPLIT>;
  using TN = Tile<kBlockN, D, SPLIT>;
  constexpr int LD = TM::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  TM sq(smem);
  TN sk(smem + TM::BYTES), sv(smem + TM::BYTES + TN::BYTES);

  const int S = sh.S, H = sh.H;
  const int mt = (S + kBlockM - 1) / kBlockM - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / sh.KH);
  const int m0 = mt * kBlockM;
  const size_t qrs = (size_t)H * D, krs = (size_t)sh.KH * D;
  const size_t qoff = (size_t)b * S * qrs + (size_t)h * D;
  const size_t koff = (size_t)b * S * krs + (size_t)kvh * D;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const int r0 = m0 + wr + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const float sl2 = sh.scale * kLog2e;

  load_tile(sq, q + qoff, qrs, m0, S);
  float acc[D / 8][4] = {};
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const int last = min(m0 + kBlockM - 1, S - 1) / kBlockN;
  for (int kt = 0; kt <= last; ++kt) {
    const int n0 = kt * kBlockN;
    __syncthreads();  // the previous step is done with sk, sv
    load_tile(sk, k + koff, krs, n0, S);
    load_tile(sv, v + koff, krs, n0, S);
    __syncthreads();
    float s[kBlockN / 8][4] = {};
    qk<D, kBlockN, LD, SPLIT>(s, sq.hi, sq.lo, wr, sk.hi, sk.lo, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const float x = (col > row || col >= S) ? -INFINITY : s[j][e] * sl2;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(mrow[i], group_max(mx[i]));
      mref[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(mrow[i] - mref[i]);
      mrow[i] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mref[e >> 1]);
        s[j][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) lrow[i] = lrow[i] * alpha[i] + ls[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    pv<D, kBlockN, LD, SPLIT>(acc, s, sv.hi, sv.lo, lane);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] = group_sum(lrow[i]);
    inv[i] = 1.f / lrow[i];
  }
  store_rows<D>(o + qoff, qrs, r0, S, acc, inv[0], inv[1], lane);
  if (t == 0) {
    float* lb = lse + ((size_t)b * H + h) * S;
    if (r0 < S) lb[r0] = (mrow[0] + log2f(lrow[0])) * kLn2;
    if (r0 + 8 < S) lb[r0 + 8] = (mrow[1] + log2f(lrow[1])) * kLn2;
  }
}

// ------------------------------------------------------------ backward

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], in f32; one warp
// per (b, s, h) row of the contiguous [B, S, H, D] tensors.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int S, int H) {
  constexpr int VEC = rtt::Vec16<T>::N;
  const int r = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float ov[VEC], gv[VEC];
    rtt::Vec16<T>::load(o + (size_t)r * D + c, ov);
    rtt::Vec16<T>::load(dout + (size_t)r * D + c, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc = fmaf(ov[j], gv[j], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = r % H, s = (r / H) % S, b = r / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// dK, dV for a 64-row kv tile of one KV head, summed over the query heads
// of its group; the loop runs over the q tiles at or past the tile's first
// row (the others see none of its keys).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, const Shape sh) {
  constexpr bool SPLIT = IsF32<T>::value;
  using TK = Tile<kBlockM, D, SPLIT>;
  using TQ = Tile<kBlockQ, D, SPLIT>;
  constexpr int LD = TK::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  TK sk(smem), sv(smem + TK::BYTES);
  TQ sq(smem + 2 * TK::BYTES), sdo(smem + 2 * TK::BYTES + TQ::BYTES);
  float* slse = reinterpret_cast<float*>(smem + 2 * TK::BYTES +
                                         2 * TQ::BYTES);
  float* sdelta = slse + kBlockQ;

  const int S = sh.S, H = sh.H, rep = H / sh.KH;
  const int n0 = blockIdx.x * kBlockM;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const size_t qrs = (size_t)H * D, krs = (size_t)sh.KH * D;
  const size_t koff = (size_t)b * S * krs + (size_t)kvh * D;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const int c0 = n0 + wr + (lane >> 2);  // this thread's kv rows: c0, c0 + 8
  const float sl2 = sh.scale * kLog2e;

  load_tile(sk, k + koff, krs, n0, S);
  load_tile(sv, v + koff, krs, n0, S);
  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const size_t qoff = (size_t)b * S * qrs + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* db = delta + ((size_t)b * H + h) * S;
    for (int m0 = n0; m0 < S; m0 += kBlockQ) {
      __syncthreads();  // the previous step is done with sq, sdo
      load_tile(sq, q + qoff, qrs, m0, S);
      load_tile(sdo, dout + qoff, qrs, m0, S);
      if (threadIdx.x < kBlockQ) {
        const int r = m0 + threadIdx.x;
        slse[threadIdx.x] = r < S ? lb[r] * kLog2e : 0.f;
        sdelta[threadIdx.x] = r < S ? db[r] : 0.f;
      }
      __syncthreads();
      // P^T (kv rows x q columns), recomputed from lse.
      float p[kBlockQ / 8][4] = {};
      qk<D, kBlockQ, LD, SPLIT>(p, sk.hi, sk.lo, wr, sq.hi, sq.lo, lane);
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = c0 + (e >> 1) * 8;
          const int ql = j * 8 + 2 * t + (e & 1);
          const int qi = m0 + ql;
          p[j][e] = (qi < kv || qi >= S)
                        ? 0.f
                        : exp2f(p[j][e] * sl2 - slse[ql]);
        }
      pv<D, kBlockQ, LD, SPLIT>(dva, p, sdo.hi, sdo.lo, lane);
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place.
      float dp[kBlockQ / 8][4] = {};
      qk<D, kBlockQ, LD, SPLIT>(dp, sv.hi, sv.lo, wr, sdo.hi, sdo.lo, lane);
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = p[j][e] * (dp[j][e] - sdelta[j * 8 + 2 * t + (e & 1)]);
      pv<D, kBlockQ, LD, SPLIT>(dka, dp, sq.hi, sq.lo, lane);
    }
  }
  store_rows<D>(dk + koff, krs, c0, S, dka, sh.scale, sh.scale, lane);
  store_rows<D>(dv + koff, krs, c0, S, dva, 1.f, 1.f, lane);
}

// dQ for a 64-row q tile of one head: kv tiles up to the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, const Shape sh) {
  constexpr bool SPLIT = IsF32<T>::value;
  using TM = Tile<kBlockM, D, SPLIT>;
  using TN = Tile<kBlockN, D, SPLIT>;
  constexpr int LD = TM::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  TM sq(smem), sdo(smem + TM::BYTES);
  TN sk(smem + 2 * TM::BYTES), sv(smem + 2 * TM::BYTES + TN::BYTES);

  const int S = sh.S, H = sh.H;
  const int mt = (S + kBlockM - 1) / kBlockM - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / sh.KH);
  const int m0 = mt * kBlockM;
  const size_t qrs = (size_t)H * D, krs = (size_t)sh.KH * D;
  const size_t qoff = (size_t)b * S * qrs + (size_t)h * D;
  const size_t koff = (size_t)b * S * krs + (size_t)kvh * D;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const int r0 = m0 + wr + (lane >> 2);
  const float sl2 = sh.scale * kLog2e;

  load_tile(sq, q + qoff, qrs, m0, S);
  load_tile(sdo, dout + qoff, qrs, m0, S);
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const size_t at = ((size_t)b * H + h) * S + r;
    lrow[i] = r < S ? lse[at] * kLog2e : 0.f;
    drow[i] = r < S ? delta[at] : 0.f;
  }
  float dqa[D / 8][4] = {};
  const int last = min(m0 + kBlockM - 1, S - 1) / kBlockN;
  for (int kt = 0; kt <= last; ++kt) {
    const int n0 = kt * kBlockN;
    __syncthreads();
    load_tile(sk, k + koff, krs, n0, S);
    load_tile(sv, v + koff, krs, n0, S);
    __syncthreads();
    float p[kBlockN / 8][4] = {};
    qk<D, kBlockN, LD, SPLIT>(p, sq.hi, sq.lo, wr, sk.hi, sk.lo, lane);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        p[j][e] = (col > row || col >= S)
                      ? 0.f
                      : exp2f(p[j][e] * sl2 - lrow[e >> 1]);
      }
    float dp[kBlockN / 8][4] = {};
    qk<D, kBlockN, LD, SPLIT>(dp, sdo.hi, sdo.lo, wr, sv.hi, sv.lo, lane);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - drow[e >> 1]);
    pv<D, kBlockN, LD, SPLIT>(dqa, dp, sk.hi, sk.lo, lane);
  }
  store_rows<D>(dq + qoff, qrs, r0, S, dqa, sh.scale, sh.scale, lane);
}

// ------------------------------------------------------------- launches

template <typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, const Shape& sh, cudaStream_t s) {
  constexpr bool SPLIT = IsF32<T>::value;
  const int smem = Tile<kBlockM, D, SPLIT>::BYTES +
                   2 * Tile<kBlockN, D, SPLIT>::BYTES;
  cudaError_t err = set_smem(fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sh.S + kBlockM - 1) / kBlockM, sh.H, B);
  fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, const Shape& sh, cudaStream_t s) {
  constexpr bool SPLIT = IsF32<T>::value;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);

  const int rows = B * sh.S * sh.H;
  delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const T*>(o), tdo, fdelta, rows, sh.S, sh.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem_kv = 2 * Tile<kBlockM, D, SPLIT>::BYTES +
                      2 * Tile<kBlockQ, D, SPLIT>::BYTES +
                      2 * kBlockQ * (int)sizeof(float);
  err = set_smem(dkdv_kernel<T, D>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((sh.S + kBlockM - 1) / kBlockM, sh.KH, B);
  dkdv_kernel<T, D><<<grid_kv, kThreads, smem_kv, s>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dk), static_cast<T*>(dv),
      sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem_q = 2 * Tile<kBlockM, D, SPLIT>::BYTES +
                     2 * Tile<kBlockN, D, SPLIT>::BYTES;
  err = set_smem(dq_kernel<T, D>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((sh.S + kBlockM - 1) / kBlockM, sh.H, B);
  dq_kernel<T, D><<<grid_q, kThreads, smem_q, s>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int S, int H, int KH, int D) {
  return B > 0 && S > 0 && KH > 0 && H % KH == 0 && (D == 64 || D == 128);
}

}  // namespace

// Contiguous [B,S,H,D] q / o / dq / dout and [B,S,KH,D] k / v / dk / dv of
// storage dtype `dtype` (0 f32, 1 bf16), 16-byte aligned; lse and delta
// [B,H,S] f32. D is 64 or 128 and H a multiple of KH. Return -1 for a
// shape or dtype the kernels do not take, else the CUDA error of the last
// launch (0 on success).

extern "C" int rtt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int S, int H, int KH, int D,
                                       float scale, int dtype, void* stream) {
  if (!shape_ok(B, S, H, KH, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{S, H, KH, scale};
  if (dtype == rtt::kBF16)
    return D == 128 ? launch_fwd<bf16, 128>(q, k, v, o, lse, B, sh, s)
                    : launch_fwd<bf16, 64>(q, k, v, o, lse, B, sh, s);
  if (dtype == rtt::kF32)
    return D == 128 ? launch_fwd<float, 128>(q, k, v, o, lse, B, sh, s)
                    : launch_fwd<float, 64>(q, k, v, o, lse, B, sh, s);
  return -1;
}

extern "C" int rtt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int B, int S, int H, int KH,
                                       int D, float scale, int dtype,
                                       void* stream) {
  if (!shape_ok(B, S, H, KH, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{S, H, KH, scale};
  if (dtype == rtt::kBF16)
    return D == 128 ? launch_bwd<bf16, 128>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, B, sh, s)
                    : launch_bwd<bf16, 64>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, B, sh, s);
  if (dtype == rtt::kF32)
    return D == 128 ? launch_bwd<float, 128>(q, k, v, o, dout, lse, delta,
                                             dq, dk, dv, B, sh, s)
                    : launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, B, sh, s);
  return -1;
}
