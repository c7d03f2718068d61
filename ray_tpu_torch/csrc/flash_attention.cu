// Causal grouped-query flash attention for Hopper (sm_90a): the forward,
// and the backward as three kernels (a delta = rowsum(dO * O) pre-pass, a
// dK/dV kernel and a dQ kernel), FA2's split of the backward.
//
// Replaces: ray_tpu/ops/attention.py::full_causal_attention's kernel, the
// Pallas TPU library flash attention (jax.experimental.pallas.ops.tpu.
// flash_attention, forward and backward, causal=True). Same function:
// q [B,S,H,D], k/v [B,S,KH,D] in ray_tpu's BSHD layout (read in place, no
// transposes), query i attends to keys 0..i, logits and softmax in f32,
// sm_scale given by the caller (D^-0.5 by default); the output in the
// input dtype and the log-sum-exp lse [B,H,S] in f32, which the backward
// reads instead of any saved probabilities. GQA: query head h reads KV
// head h / (H/KH); K/V are never repeated in memory.
//
// Bound on the H100: operations. At the training shape (B=1, S=2048,
// H=32, KH=8, D=128) the forward does 4*D per causal (query, key) pair,
// 34 GFLOP on ~42 MB of operands, far above the ~295 flops a byte where
// the card stops being memory-bound; the backward 10*D a pair as counted
// for its bound (it executes 14*D, below). So the products go to the
// tensor cores at their full rate, and the S x S matrices never leave
// the chip.
//
// bf16, the training path: TMA + wgmma, warp-specialised. These replace
// mma.sync kernels that loaded every tile through registers and waited at
// a barrier before each product (110 and 72 TFLOP/s on the H100: latency-
// bound, not tensor-bound).
//
//   * A CTA is three warpgroups. One thread of warpgroup 0 issues every
//     TMA load into a shared-memory ring (full/empty mbarriers per stage),
//     so the next tiles' copies overlap this tile's products; setmaxnreg
//     moves the producer's registers to the two consumer warpgroups (240
//     each), which run every product as wgmma: S = Q K^T with both
//     operands in shared memory, then P (or dS) packed to bf16 in
//     registers as the A operand of the next product, against an MN-major
//     B in shared memory (wgmma's transpose bit: V, dO, Q and K are never
//     transposed in memory).
//   * TMA maps are 3-D, [B][S][H*D], so rows past S read as zeros inside
//     each sequence (ragged S needs no masking of loads); boxes are 64 x
//     64 with the 128-byte swizzle, which the wgmma descriptors repeat
//     (layouts in hopper.cuh). The maps hold the data pointers, so the C
//     entry points build them on the host at every call.
//   * Causal work is uneven: a late q tile sees many kv tiles, an early
//     one few. The forward and dQ grids put the q tile in their slowest
//     dimension, latest first, so the CTAs start longest first across all
//     heads (with the tile fastest, each head's sawtooth of lengths left a
//     long CTA to start last: 15% of the forward's time at S=2048).
//   * Forward: a CTA owns a 128-row q tile of one head, 64 rows per
//     consumer; kv tiles of 128 rows through a 3-stage ring. Online
//     softmax in registers in log2 units, the scale folded into one FMA
//     before a flush-to-zero ex2 (exp2f's denormal handling cost 10% of
//     the forward and 20% of dQ); only a tile that crosses the diagonal
//     or runs past S pays for the mask. Each
//     consumer issues S of tile j with P*V of tile j-1 and runs tile j's
//     softmax while P*V is in flight, and the two consumers issue their
//     products in turns (FA3's ping-pong), so one's softmax runs under
//     the other's products. P is rounded to bf16 for P*V before it is
//     normalised; the plain version normalises first (tolerance in
//     ops/flash_attention.py).
//   * dK/dV: a CTA owns a 64-row kv tile of one KV head, tile x and then
//     tile T-1-x of the T tiles, so every CTA does the same work and the
//     grid (T/2 x KH) runs in one wave on 132 SMs. The 64-row Q and dO
//     tiles at and past the kv rows (with their lse and delta slices)
//     stream over the group's query heads; the two consumers take them in
//     turns through a 2-stage ring each, so both stay busy. Per tile:
//     S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, dV += P^T
//     dO and dK += dS^T Q. Each consumer's dK and dV (2 x 64 f32 a thread
//     at D=128, the reason for 240 registers) cover half the tiles;
//     consumer 1 hands its sums over through shared memory, always added
//     in the same order, so the GQA sum needs no atomics.
//   * dQ: a CTA owns a 128-row q tile with its dO; a 2-stage ring streams
//     128-row K and V tiles up to the diagonal: S = Q K^T, dP = dO V^T,
//     dQ += dS K (64-row kv tiles took 36% longer: twice the waits).
//   * Both backward kernels recompute S and dP: 14*D operations a pair
//     executed against the bound's 10*D. One kernel that adds dQ with f32
//     atomics (FA2/FA3's route) would save that 1.4x but make dQ
//     nondeterministic: a later choice. Every sum here runs in a fixed
//     order, so the backward is deterministic, and so is the forward that
//     remat runs twice (the recompute must give the lse the backward
//     reads).
//   * Left for later: a persistent grid that overlaps one tile's epilogue
//     with the next one's loads; keeping Q and dO in registers in dQ was
//     slower (spills at 240 registers).
//
// f32 (the tests and the f32 model check only): mma.sync m16n8k16 on four
// warps, each f32 operand split in two bf16 halves, x = hi + lo, and three
// products hi*hi + hi*lo + lo*hi: about 16 mantissa bits, where one bf16
// product would keep 8. Tiles load through registers
// into padded shared memory (rows of D + 8); the dK/dV CTA owns a 64-row
// kv tile and loops over the group's heads, the dQ CTA a 64-row q tile.

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// An R x D f32 tile in shared memory as two bf16 tiles, the high and the
// low halves of each value, row stride D + 8.
template <int R, int D>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int ELEMS = R * LD;
  static constexpr int BYTES = ELEMS * 2 * 2;
  bf16* hi;
  bf16* lo;
  __device__ explicit Tile(unsigned char* base)
      : hi(reinterpret_cast<bf16*>(base)),
        lo(reinterpret_cast<bf16*>(base) + ELEMS) {}
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows row0 .. row0+R-1 of a [.., S, .., D] f32 operand whose row r
// starts at src + r * rs, split into bf16 hi/lo tiles; rows at or past S
// are zero.
template <int R, int D>
__device__ __forceinline__ void load_tile(Tile<R, D> t, const float* src,
                                          size_t rs, int row0, int S) {
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
    const int off = r * Tile<R, D>::LD + col;
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

// hi*hi + hi*lo + lo*hi, the small terms first.
__device__ __forceinline__ void mma(float* c, const FragA& a,
                                    const FragB& b) {
  mma_bf16(c, a.l, b.h);
  mma_bf16(c, a.h, b.l);
  mma_bf16(c, a.h, b.h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A[m0 .. m0+15][k0 .. k0+15] of a row-major [m][k] tile.
template <int LD>
__device__ __forceinline__ void load_a(FragA& a, const bf16* hi,
                                       const bf16* lo, int m0, int k0,
                                       int lane) {
  const int off = (m0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  a.h[0] = ld32(hi + off);
  a.h[1] = ld32(hi + off + 8 * LD);
  a.h[2] = ld32(hi + off + 8);
  a.h[3] = ld32(hi + off + 8 * LD + 8);
  a.l[0] = ld32(lo + off);
  a.l[1] = ld32(lo + off + 8 * LD);
  a.l[2] = ld32(lo + off + 8);
  a.l[3] = ld32(lo + off + 8 * LD + 8);
}

// B[k0 .. k0+15][n0 .. n0+7] where the tile holds B^T row-major ([n][k]).
template <int LD>
__device__ __forceinline__ void load_b(FragB& b, const bf16* hi,
                                       const bf16* lo, int n0, int k0,
                                       int lane) {
  const int off = (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b.h[0] = ld32(hi + off);
  b.h[1] = ld32(hi + off + 8);
  b.l[0] = ld32(lo + off);
  b.l[1] = ld32(lo + off + 8);
}

// B[k0 .. k0+15][n0 .. n0+7] where the tile holds B row-major ([k][n]):
// the pairs run down a column, so each is two 16-bit loads.
template <int LD>
__device__ __forceinline__ void load_bt(FragB& b, const bf16* hi,
                                        const bf16* lo, int k0, int n0,
                                        int lane) {
  const int off = (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  const unsigned short* ph = reinterpret_cast<const unsigned short*>(hi) + off;
  b.h[0] = (uint32_t)ph[0] | ((uint32_t)ph[LD] << 16);
  b.h[1] = (uint32_t)ph[8 * LD] | ((uint32_t)ph[9 * LD] << 16);
  const unsigned short* pl = reinterpret_cast<const unsigned short*>(lo) + off;
  b.l[0] = (uint32_t)pl[0] | ((uint32_t)pl[LD] << 16);
  b.l[1] = (uint32_t)pl[8 * LD] | ((uint32_t)pl[9 * LD] << 16);
}

__device__ __forceinline__ void pack(uint32_t& h, uint32_t& l, float x,
                                     float y) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hv);
  h = bf16x2_bits(hv);
  l = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragment of columns 16kk .. 16kk+15 of a 16-row accumulator held
// as n8 tiles c0 = acc[2kk], c1 = acc[2kk+1].
__device__ __forceinline__ void a_from_acc(FragA& a, const float* c0,
                                           const float* c1) {
  pack(a.h[0], a.l[0], c0[0], c0[1]);
  pack(a.h[1], a.l[1], c0[2], c0[3]);
  pack(a.h[2], a.l[2], c1[0], c1[1]);
  pack(a.h[3], a.l[3], c1[2], c1[3]);
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
template <int D, int N, int LD>
__device__ __forceinline__ void qk(float (*s)[4], const bf16* ahi,
                                   const bf16* alo, int m0, const bf16* bhi,
                                   const bf16* blo, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA a;
    load_a<LD>(a, ahi, alo, m0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      FragB b;
      load_b<LD>(b, bhi, blo, j * 8, kk * 16, lane);
      mma(s[j], a, b);
    }
  }
}

// acc (16 x D) += P (16 x N, accumulator registers) * V (N x D tile, [k][n]).
template <int D, int N, int LD>
__device__ __forceinline__ void pv(float (*acc)[4], float (*p)[4],
                                   const bf16* vhi, const bf16* vlo,
                                   int lane) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    FragA a;
    a_from_acc(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      FragB b;
      load_bt<LD>(b, vhi, vlo, kk * 16, j * 8, lane);
      mma(acc[j], a, b);
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

// ============================== f32: mma.sync on bf16 hi/lo operand pairs

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, const Shape sh) {
  using TM = Tile<kBlockM, D>;
  using TN = Tile<kBlockN, D>;
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
    qk<D, kBlockN, LD>(s, sq.hi, sq.lo, wr, sk.hi, sk.lo, lane);
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
    pv<D, kBlockN, LD>(acc, s, sv.hi, sv.lo, lane);
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

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], in f32; a group
// of kDeltaLanes lanes (16 bytes of each operand a lane) per (b, s, h) row
// of the contiguous [B, S, H, D] tensors.
template <typename T, int D>
constexpr int kDeltaLanes =
    D / rtt::Vec16<T>::N < 32 ? D / rtt::Vec16<T>::N : 32;

template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int S, int H) {
  constexpr int VEC = rtt::Vec16<T>::N, LANES = kDeltaLanes<T, D>;
  const size_t gid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const int r = (int)(gid / LANES), lane = (int)(gid % LANES);
  float acc = 0.f;
  if (r < rows)
    for (int c = lane * VEC; c < D; c += LANES * VEC) {
      float ov[VEC], gv[VEC];
      rtt::Vec16<T>::load(o + (size_t)r * D + c, ov);
      rtt::Vec16<T>::load(dout + (size_t)r * D + c, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc = fmaf(ov[j], gv[j], acc);
    }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && lane == 0) {
    const int h = r % H, s = (r / H) % S, b = r / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// dK, dV for a 64-row kv tile of one KV head, summed over the query heads
// of its group; the loop runs over the q tiles at or past the tile's first
// row (the others see none of its keys).
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, const Shape sh) {
  using TK = Tile<kBlockM, D>;
  using TQ = Tile<kBlockQ, D>;
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
      qk<D, kBlockQ, LD>(p, sk.hi, sk.lo, wr, sq.hi, sq.lo, lane);
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
      pv<D, kBlockQ, LD>(dva, p, sdo.hi, sdo.lo, lane);
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place.
      float dp[kBlockQ / 8][4] = {};
      qk<D, kBlockQ, LD>(dp, sv.hi, sv.lo, wr, sdo.hi, sdo.lo, lane);
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = p[j][e] * (dp[j][e] - sdelta[j * 8 + 2 * t + (e & 1)]);
      pv<D, kBlockQ, LD>(dka, dp, sq.hi, sq.lo, lane);
    }
  }
  store_rows<D>(dk + koff, krs, c0, S, dka, sh.scale, sh.scale, lane);
  store_rows<D>(dv + koff, krs, c0, S, dva, 1.f, 1.f, lane);
}

// dQ for a 64-row q tile of one head: kv tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, const Shape sh) {
  using TM = Tile<kBlockM, D>;
  using TN = Tile<kBlockN, D>;
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
    qk<D, kBlockN, LD>(p, sq.hi, sq.lo, wr, sk.hi, sk.lo, lane);
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
    qk<D, kBlockN, LD>(dp, sdo.hi, sdo.lo, wr, sv.hi, sv.lo, lane);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - drow[e >> 1]);
    pv<D, kBlockN, LD>(dqa, dp, sk.hi, sk.lo, lane);
  }
  store_rows<D>(dq + qoff, qrs, r0, S, dqa, sh.scale, sh.scale, lane);
}

// ================================================ bf16: TMA ring + wgmma
//
// Three warpgroups a CTA: warpgroup 0 is the producer (one thread issues
// every TMA load; setmaxnreg gives its registers away), warpgroups 1 and 2
// are the consumers, 64 rows each. Tiles stream through a ring of
// shared-memory stages (kStages, or the kernel's own count), each with a
// `full` barrier (the TMA transaction bytes) and an `empty` barrier (one
// arrival per consumer warp once its products on the stage completed).

namespace sm = rtt::sm90;

constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kSm90Threads = 3 * kWG;    // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 3;
constexpr int kBox = 64;                 // rows (and columns) of a TMA box
constexpr int kTileM = 128;              // q rows of a forward / dQ CTA
constexpr int kTileN = 128;              // kv rows of a forward ring stage
constexpr int kTile64 = 64;              // kv rows of a dK/dV work item and
                                         // q rows of its ring stages
constexpr int kTmaError = -2;            // no tensor map could be built

// ROWS rows (a multiple of 64) of columns col0 .. col0 + D - 1 of a
// [B][S][width] map, from global row row0 of batch b, into rows r_dst ..
// of the R-row swizzled tile at dst (layout: hopper.cuh).
template <int R, int D, int ROWS = R>
__device__ __forceinline__ void tma_rows(uint32_t dst, int r_dst,
                                         const CUtensorMap* map,
                                         uint32_t bar, int col0, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < ROWS / kBox; ++r)
      sm::tma_load_3d(dst + c * R * 128 + (r_dst + r * kBox) * 128, map, bar,
                      col0 + 64 * c, row0 + r * kBox, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return bf16x2_bits(__floats2bfloat162_rn(x, y));
}

// The register A operands (k-steps of 16 columns) of an m64 x N
// accumulator, rounded to bf16 (layouts: hopper.cuh).
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4],
                                         const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// Rows r0 and r0 + 8 of an m64 x D accumulator, times mul, into dst (row
// stride rs); rows at or past S are skipped.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, size_t rs, int r0,
                                          int S, const float (&acc)[D / 2],
                                          float mul, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < S)
      store2(dst + (size_t)r0 * rs + col, acc[4 * j] * mul,
             acc[4 * j + 1] * mul);
    if (r0 + 8 < S)
      store2(dst + (size_t)(r0 + 8) * rs + col, acc[4 * j + 2] * mul,
             acc[4 * j + 3] * mul);
  }
}

// Barriers at `bars`: [0] a once-loaded operand, [1 + s] full[s],
// [1 + kStages + s] empty[s].
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + kStages + s);
}

__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    sm::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(bar_full(bars, s), 1);
      sm::mbar_init(bar_empty(bars, s), kConsumerWarps);
    }
    sm::mbar_init_fence();
  }
  __syncthreads();
}

// A consumer warp is done with stage s.
__device__ __forceinline__ void release(uint32_t bars, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm::mbar_arrive(bar_empty(bars, s));
}

template <int STAGES = kStages>
__device__ __forceinline__ void advance(int& st, int& ph) {
  if (++st == STAGES) {
    st = 0;
    ph ^= 1;
  }
}

// The 1024-aligned start of the dynamic shared memory (each layout below
// reserves 1024 bytes of slack for it).
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw) {
  return (sm::smem_u32(raw) + 1023u) & ~1023u;
}

template <int D>
struct FwdSmem {
  static constexpr int KV = kTileM * D * 2;          // after the Q tile
  static constexpr int STAGE = 2 * kTileN * D * 2;   // K, V
  static constexpr int BAR = KV + kStages * STAGE;
  static constexpr int BYTES = BAR + 64 + 1024;
};

// The two consumers issue their products in turns, consumer 0 first
// (named barriers 2 and 3), so that one's softmax runs under the other's
// products (FA3's ping-pong). Each takes `turns` turns.
struct PingPong {
  int cw, turns;
  __device__ __forceinline__ void wait() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + cw), "n"(2 * kWG) : "memory");
  }
  // After turn `turn` (-1: before the first), hand over to the other
  // consumer, which takes no turn after consumer 1's last.
  __device__ __forceinline__ void pass(int turn) const {
    if (cw == 0 || turn + 1 < turns)
      asm volatile("bar.arrive %0, %1;\n" ::"r"(3 - cw), "n"(2 * kWG)
                   : "memory");
  }
};

// 2^x in one MUFU op, for the softmax (x <= 0 wherever the result is
// kept): results below
// 2^-126 flush to 0, where exp2f would keep them denormal.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of a consumer over S (m64 x N, raw logits) of
// the kv tile at n0: masked where it crosses the diagonal (rows from mw)
// or runs past S, then exponentiated in place in log2 units against the
// new row maxima, the scale folded into one FMA; mrow (log2 units) and
// lrow are carried, alpha is the factor the output accumulator must take.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2],
                                               float (&mrow)[2],
                                               float (&lrow)[2],
                                               float (&alpha)[2], int n0,
                                               int mw, int r0, int S, int t,
                                               float sl2) {
  const bool edge = n0 + N - 1 > mw || n0 + N > S;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int row = r0 + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        if (col > row || col >= S) s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float mref[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(mrow[i], group_max(mx[i]) * sl2);
    mref[i] = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = ex2(mrow[i] - mref[i]);
    mrow[i] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float p = ex2(fmaf(s[i], sl2, -mref[(i >> 1) & 1]));
    s[i] = p;
    ls[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) lrow[i] = lrow[i] * alpha[i] + ls[i];
}

// ------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    fwd_sm90(__grid_constant__ const CUtensorMap tq,
             __grid_constant__ const CUtensorMap tk,
             __grid_constant__ const CUtensorMap tv, bf16* __restrict__ o,
             float* __restrict__ lse, const Shape sh) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = smem_base(smem_raw), skv = sq + L::KV;
  const uint32_t bars = sq + L::BAR;
  const int S = sh.S, H = sh.H;
  const int m0 = ((S + kTileM - 1) / kTileM - 1 - blockIdx.z) * kTileM;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / sh.KH);
  const int last = min(m0 + kTileM - 1, S - 1) / kTileN;
  init_barriers(bars);

  if (threadIdx.x < kWG) {  // producer
    sm::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm::mbar_expect_tx(bars, kTileM * D * 2);
      tma_rows<kTileM, D>(sq, 0, &tq, bars, h * D, m0, b);
      int st = 0, ph = 0;
      for (int kt = 0; kt <= last; ++kt) {
        sm::mbar_wait(bar_empty(bars, st), ph ^ 1);
        const uint32_t full = bar_full(bars, st);
        const uint32_t sk = skv + st * L::STAGE;
        sm::mbar_expect_tx(full, 2 * kTileN * D * 2);
        tma_rows<kTileN, D>(sk, 0, &tk, full, kvh * D, kt * kTileN, b);
        tma_rows<kTileN, D>(sk + kTileN * D * 2, 0, &tv, full, kvh * D,
                            kt * kTileN, b);
        advance(st, ph);
      }
    }
  } else {  // consumers
    sm::regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWG - 1, tid = threadIdx.x % kWG;
    const int lane = tid & 31, t = lane & 3;
    const int mw = m0 + 64 * cw;                       // the consumer's rows
    const int r0 = mw + 16 * (tid >> 5) + (lane >> 2);  // this thread's: r0,
                                                        // r0 + 8
    const float sl2 = sh.scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    float s[kTileN / 2], alpha[2];
    uint32_t pa[kTileN / 16][4];  // P of the previous kv tile, bf16
    // S = Q K^T of kv tile kt, in flight after the call.
    auto issue_s = [&](uint32_t sk) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm::wgmma_ss(s, sm::desc_k<kTileM>(sq, 64 * cw, kk),
                     sm::desc_k<kTileN>(sk, 0, kk), kk);
      sm::wgmma_commit();
    };
    auto issue_pv = [&](uint32_t sv) {
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk)
        sm::wgmma_rs(acc, pa[kk], sm::desc_mn<kTileN>(sv, kk), 1);
      sm::wgmma_commit();
    };
    sm::mbar_wait(bars, 0);
    // Tile 0 alone, then each step issues S of tile kt and P*V of tile
    // kt - 1 together and runs tile kt's softmax while P*V is in flight.
    const PingPong pp{cw, last + 2};
    if (cw == 1) pp.pass(-1);  // consumer 0 goes first
    int st = 0, ph = 0;
    sm::mbar_wait(bar_full(bars, st), ph);
    sm::wgmma_fence();
    pp.wait();
    issue_s(skv);
    pp.pass(0);
    sm::wgmma_wait0();
    sm::fence_regs(s);
    online_softmax<kTileN>(s, mrow, lrow, alpha, 0, mw, r0, S, t, sl2);
    acc_to_a<kTileN>(pa, s);
    int prev = st;
    advance(st, ph);
    for (int kt = 1; kt <= last; ++kt) {
      const uint32_t sk = skv + st * L::STAGE;
      sm::mbar_wait(bar_full(bars, st), ph);
      sm::fence_regs(acc);
      sm::fence_regs(pa);
      sm::wgmma_fence();
      pp.wait();
      issue_s(sk);
      issue_pv(skv + prev * L::STAGE + kTileN * D * 2);
      pp.pass(kt);
      sm::wgmma_wait1();  // S of tile kt
      sm::fence_regs(s);
      online_softmax<kTileN>(s, mrow, lrow, alpha, kt * kTileN, mw, r0, S, t,
                             sl2);
      sm::wgmma_wait0();  // P*V of tile kt - 1
      sm::fence_regs(acc);
      release(bars, prev);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      acc_to_a<kTileN>(pa, s);
      prev = st;
      advance(st, ph);
    }
    sm::fence_regs(pa);
    sm::wgmma_fence();
    pp.wait();
    issue_pv(skv + prev * L::STAGE + kTileN * D * 2);
    pp.pass(last + 1);
    sm::wgmma_wait0();
    sm::fence_regs(acc);
    release(bars, prev);
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] = group_sum(lrow[i]);
      inv[i] = 1.f / lrow[i];
    }
    const size_t qrs = (size_t)H * D;
    bf16* ob = o + (size_t)b * S * qrs + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {  // rows r0 and r0 + 8
      acc[4 * j] *= inv[0];
      acc[4 * j + 1] *= inv[0];
      acc[4 * j + 2] *= inv[1];
      acc[4 * j + 3] *= inv[1];
    }
    store_acc<D>(ob, qrs, r0, S, acc, 1.f, t);
    if (t == 0) {
      float* lb = lse + ((size_t)b * H + h) * S;
      if (r0 < S) lb[r0] = (mrow[0] + log2f(lrow[0])) * kLn2;
      if (r0 + 8 < S) lb[r0 + 8] = (mrow[1] + log2f(lrow[1])) * kLn2;
    }
  }
}

// ------------------------------------------------------------ backward

constexpr int kDkdvStages = 2;  // a ring of 2 stages for each consumer

template <int D>
struct DkdvSmem {
  static constexpr int V = kTile64 * D * 2;              // after K
  static constexpr int RING = 2 * kTile64 * D * 2;       // after K, V
  static constexpr int STAGE = 2 * kTile64 * D * 2;      // Q, dO
  static constexpr int RED = RING + 2 * kDkdvStages * STAGE;  // partial dK/dV
  static constexpr int LSE = RED + kTile64 * D * 4;      // lse, delta
  static constexpr int BAR = LSE + 2 * kDkdvStages * 2 * kTile64 * 4;
  static constexpr int BYTES = BAR + 128 + 1024;
};

__device__ __forceinline__ void consumers_sync() {  // both consumer WGs
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWG) : "memory");
}

// dK, dV of 64-row kv tiles of one KV head, summed over the query heads
// of its group: tile x, then tile T - 1 - x of the T tiles, so every CTA
// does the same work and the grid (T/2 x KH) fills the card in one wave.
// Per tile the ring streams the 64-row Q and dO tiles (with their lse and
// delta slices) at and past its rows, head by head; the two consumers
// take them in turns, each through its own ring of kDkdvStages stages,
// and each sums dK and dV over its half. Consumer 1 then hands its sums to
// consumer 0 through shared memory, which adds them (always in this
// order: the backward stays deterministic) and stores.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    dkdv_sm90(__grid_constant__ const CUtensorMap tq,
              __grid_constant__ const CUtensorMap tk,
              __grid_constant__ const CUtensorMap tv,
              __grid_constant__ const CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              const Shape sh) {
  using L = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = smem_base(smem_raw), sv = sk + L::V;
  const uint32_t ring = sk + L::RING;
  // [0] K/V full, [1] K/V empty, [2 + s] full[s], [2 + 2 kDkdvStages + s]
  // empty[s]; stage s = kDkdvStages * consumer + i.
  const uint32_t bars = sk + L::BAR;
  unsigned char* const base = smem_raw + (sk - sm::smem_u32(smem_raw));
  float* const red = reinterpret_cast<float*>(base + L::RED);
  float* const slse = reinterpret_cast<float*>(base + L::LSE);
  const int S = sh.S, H = sh.H, rep = H / sh.KH;
  const int T = (S + kTile64 - 1) / kTile64;
  const int tiles[2] = {(int)blockIdx.x, T - 1 - (int)blockIdx.x};
  const int n_items = tiles[1] == tiles[0] ? 1 : 2;
  const int kvh = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x == 0) {
    sm::mbar_init(bars, 1);
    sm::mbar_init(bars + 8, kConsumerWarps);
    for (int s = 0; s < 2 * kDkdvStages; ++s) {
      sm::mbar_init(bars + 8 * (2 + s), 1);
      sm::mbar_init(bars + 8 * (2 + 2 * kDkdvStages + s),
                    kConsumerWarps / 2);
    }
    sm::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer
    sm::regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {  // one warp: lse and delta, then the TMA
      const int lane = threadIdx.x;
      int st[2] = {0, 0}, ph[2] = {0, 0};
      for (int item = 0; item < n_items; ++item) {
        const int kv0 = tiles[item] * kTile64;
        if (item > 0) sm::mbar_wait(bars + 8, 0);  // both done with K/V
        if (lane == 0) {
          sm::mbar_expect_tx(bars, 2 * kTile64 * D * 2);
          tma_rows<kTile64, D>(sk, 0, &tk, bars, kvh * D, kv0, b);
          tma_rows<kTile64, D>(sv, 0, &tv, bars, kvh * D, kv0, b);
        }
        int w = 0;
        for (int hh = 0; hh < rep; ++hh) {
          const int h = kvh * rep + hh;
          const size_t bh = ((size_t)b * H + h) * S;
          for (int m0 = kv0; m0 < S; m0 += kTile64, w ^= 1) {
            const int stage = kDkdvStages * w + st[w];
            sm::mbar_wait(bars + 8 * (2 + 2 * kDkdvStages + stage),
                          ph[w] ^ 1);
            float* sl = slse + stage * 2 * kTile64;
            for (int i = lane; i < kTile64; i += 32) {
              const int r = m0 + i;
              sl[i] = r < S ? lse[bh + r] * kLog2e : 0.f;
              sl[kTile64 + i] = r < S ? delta[bh + r] : 0.f;
            }
            __syncwarp();
            if (lane == 0) {
              const uint32_t full = bars + 8 * (2 + stage);
              const uint32_t sq = ring + stage * L::STAGE;
              sm::mbar_expect_tx(full, 2 * kTile64 * D * 2);
              tma_rows<kTile64, D>(sq, 0, &tq, full, h * D, m0, b);
              tma_rows<kTile64, D>(sq + kTile64 * D * 2, 0, &tdo, full,
                                   h * D, m0, b);
            }
            advance<kDkdvStages>(st[w], ph[w]);
          }
        }
      }
    }
  } else {  // consumers
    sm::regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWG - 1, tid = threadIdx.x % kWG;
    const int lane = tid & 31, t = lane & 3;
    const float sl2 = sh.scale * kLog2e;
    const size_t krs = (size_t)sh.KH * D;
    const size_t koff = (size_t)b * S * krs + (size_t)kvh * D;
    int st = 0, ph = 0;
    for (int item = 0; item < n_items; ++item) {
      const int kv0 = tiles[item] * kTile64;
      const int c0 = kv0 + 16 * (tid >> 5) + (lane >> 2);  // kv rows c0,
                                                           // c0 + 8
      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
      sm::mbar_wait(bars, item & 1);
      int w = 0;
      for (int hh = 0; hh < rep; ++hh) {
        for (int m0 = kv0; m0 < S; m0 += kTile64, w ^= 1) {
          if (w != cw) continue;  // the other consumer's tile
          const int stage = kDkdvStages * cw + st;
          sm::mbar_wait(bars + 8 * (2 + stage), ph);
          const uint32_t sq = ring + stage * L::STAGE;
          const uint32_t sdo = sq + kTile64 * D * 2;
          const float* sl = slse + stage * 2 * kTile64;
          float s[kTile64 / 2], dp[kTile64 / 2];
          sm::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
            sm::wgmma_ss(s, sm::desc_k<kTile64>(sk, 0, kk),
                         sm::desc_k<kTile64>(sq, 0, kk), kk);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
            sm::wgmma_ss(dp, sm::desc_k<kTile64>(sv, 0, kk),
                         sm::desc_k<kTile64>(sdo, 0, kk), kk);
          sm::wgmma_commit();
          sm::wgmma_wait0();
          sm::fence_regs(s);
          sm::fence_regs(dp);
          // P^T from lse; dS^T = P^T * (dP^T - delta), in place.
          const bool edge = m0 == kv0 || m0 + kTile64 > S;
#pragma unroll
          for (int j = 0; j < kTile64 / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e, ql = j * 8 + 2 * t + (e & 1);
              float p = ex2(fmaf(s[i], sl2, -sl[ql]));
              if (edge) {
                const int q = m0 + ql, kv = c0 + (e >> 1) * 8;
                if (q < kv || q >= S) p = 0.f;
              }
              s[i] = p;
              dp[i] = p * (dp[i] - sl[kTile64 + ql]);
            }
          uint32_t pa[kTile64 / 16][4], da[kTile64 / 16][4];
          acc_to_a<kTile64>(pa, s);
          acc_to_a<kTile64>(da, dp);
          sm::fence_regs(dva);
          sm::fence_regs(dka);
          sm::fence_regs(pa);
          sm::fence_regs(da);
          sm::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTile64 / 16; ++kk)  // dV += P^T dO
            sm::wgmma_rs(dva, pa[kk], sm::desc_mn<kTile64>(sdo, kk), 1);
#pragma unroll
          for (int kk = 0; kk < kTile64 / 16; ++kk)  // dK += dS^T Q
            sm::wgmma_rs(dka, da[kk], sm::desc_mn<kTile64>(sq, kk), 1);
          sm::wgmma_commit();
          sm::wgmma_wait0();
          sm::fence_regs(dva);
          sm::fence_regs(dka);
          __syncwarp();
          if (lane == 0)
            sm::mbar_arrive(bars + 8 * (2 + 2 * kDkdvStages + stage));
          advance<kDkdvStages>(st, ph);
        }
      }
      __syncwarp();
      if (lane == 0) sm::mbar_arrive(bars + 8);  // done with K and V
      // dK = consumer 0's sum + consumer 1's, then dV likewise.
      auto hand_over = [&](float(&acc)[D / 2], bf16* dst, float mul) {
        if (cw == 1) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) red[i * kWG + tid] = acc[i];
        }
        consumers_sync();
        if (cw == 0) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] += red[i * kWG + tid];
          store_acc<D>(dst + koff, krs, c0, S, acc, mul, t);
        }
        consumers_sync();
      };
      hand_over(dka, dk, sh.scale);
      hand_over(dva, dv, 1.f);
    }
  }
}

constexpr int kDqN = 128;      // kv rows of a dQ ring stage
constexpr int kDqStages = 2;

template <int D>
struct DqSmem {
  static constexpr int DO = kTileM * D * 2;             // after Q
  static constexpr int RING = 2 * kTileM * D * 2;
  static constexpr int STAGE = 2 * kDqN * D * 2;     // K, V
  static constexpr int BAR = RING + kDqStages * STAGE;
  static constexpr int BYTES = BAR + 64 + 1024;
};

// dQ for a 128-row q tile of one head: 128-row kv tiles up to the
// diagonal (a 2-stage ring: 64 KB a stage at D=128).
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    dq_sm90(__grid_constant__ const CUtensorMap tq,
            __grid_constant__ const CUtensorMap tk,
            __grid_constant__ const CUtensorMap tv,
            __grid_constant__ const CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, const Shape sh) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = smem_base(smem_raw), sdo = sq + L::DO;
  const uint32_t ring = sq + L::RING, bars = sq + L::BAR;
  const int S = sh.S, H = sh.H;
  const int m0 = ((S + kTileM - 1) / kTileM - 1 - blockIdx.z) * kTileM;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / sh.KH);
  const int last = min(m0 + kTileM - 1, S - 1) / kDqN;
  init_barriers(bars);

  if (threadIdx.x < kWG) {  // producer
    sm::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm::mbar_expect_tx(bars, 2 * kTileM * D * 2);
      tma_rows<kTileM, D>(sq, 0, &tq, bars, h * D, m0, b);
      tma_rows<kTileM, D>(sdo, 0, &tdo, bars, h * D, m0, b);
      int st = 0, ph = 0;
      for (int kt = 0; kt <= last; ++kt) {
        sm::mbar_wait(bar_empty(bars, st), ph ^ 1);
        const uint32_t full = bar_full(bars, st);
        const uint32_t sk = ring + st * L::STAGE;
        sm::mbar_expect_tx(full, 2 * kDqN * D * 2);
        tma_rows<kDqN, D>(sk, 0, &tk, full, kvh * D, kt * kDqN, b);
        tma_rows<kDqN, D>(sk + kDqN * D * 2, 0, &tv, full, kvh * D,
                             kt * kDqN, b);
        advance<kDqStages>(st, ph);
      }
    }
  } else {  // consumers
    sm::regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / kWG - 1, tid = threadIdx.x % kWG;
    const int lane = tid & 31, t = lane & 3;
    const int mw = m0 + 64 * cw;
    const int r0 = mw + 16 * (tid >> 5) + (lane >> 2);
    const float sl2 = sh.scale * kLog2e;
    float lrow[2], drow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const size_t at = ((size_t)b * H + h) * S + r;
      lrow[i] = r < S ? lse[at] * kLog2e : 0.f;
      drow[i] = r < S ? delta[at] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    sm::mbar_wait(bars, 0);
    int st = 0, ph = 0;
    for (int kt = 0; kt <= last; ++kt) {
      const int n0 = kt * kDqN;
      sm::mbar_wait(bar_full(bars, st), ph);
      const uint32_t sk = ring + st * L::STAGE, sv = sk + kDqN * D * 2;
      float s[kDqN / 2], dp[kDqN / 2];
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
        sm::wgmma_ss(s, sm::desc_k<kTileM>(sq, 64 * cw, kk),
                     sm::desc_k<kDqN>(sk, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
        sm::wgmma_ss(dp, sm::desc_k<kTileM>(sdo, 64 * cw, kk),
                     sm::desc_k<kDqN>(sv, 0, kk), kk);
      sm::wgmma_commit();
      sm::wgmma_wait0();
      sm::fence_regs(s);
      sm::fence_regs(dp);
      const bool edge = n0 + kDqN - 1 > mw || n0 + kDqN > S;
#pragma unroll
      for (int j = 0; j < kDqN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = ex2(fmaf(s[i], sl2, -lrow[e >> 1]));
          if (edge) {
            const int row = r0 + (e >> 1) * 8;
            const int col = n0 + j * 8 + 2 * t + (e & 1);
            if (col > row || col >= S) p = 0.f;
          }
          dp[i] = p * (dp[i] - drow[e >> 1]);
        }
      uint32_t da[kDqN / 16][4];
      acc_to_a<kDqN>(da, dp);
      sm::fence_regs(dqa);
      sm::fence_regs(da);
      sm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqN / 16; ++kk)  // dQ += dS K
        sm::wgmma_rs(dqa, da[kk], sm::desc_mn<kDqN>(sk, kk), 1);
      sm::wgmma_commit();
      sm::wgmma_wait0();
      sm::fence_regs(dqa);
      release(bars, st);
      advance<kDqStages>(st, ph);
    }
    const size_t qrs = (size_t)H * D;
    store_acc<D>(dq + (size_t)b * S * qrs + (size_t)h * D, qrs, r0, S, dqa,
                 sh.scale, t);
  }
}

// ------------------------------------------------------------- launches

template <typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// cuTensorMapEncodeTiled from the driver library the CUDA runtime has
// loaded, so the build links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A contiguous [B][S][width] bf16 tensor as a 3-D TMA map of 64 x 64
// boxes with the 128-byte swizzle: a box's rows past S read as zeros
// inside each sequence.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int width) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)S * width * 2};
  const cuuint32_t box[3] = {64, kBox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, const Shape& sh, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, sh.S, sh.H * D) ||
      !make_map(&tk, k, B, sh.S, sh.KH * D) ||
      !make_map(&tv, v, B, sh.S, sh.KH * D))
    return kTmaError;
  const int smem = FwdSmem<D>::BYTES;
  cudaError_t err = set_smem(fwd_sm90<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sh.H, B, (sh.S + kTileM - 1) / kTileM);  // longest first
  fwd_sm90<D><<<grid, kSm90Threads, smem, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_sm90(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B,
                    const Shape& sh, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, sh.S, sh.H * D) ||
      !make_map(&tk, k, B, sh.S, sh.KH * D) ||
      !make_map(&tv, v, B, sh.S, sh.KH * D) ||
      !make_map(&tdo, dout, B, sh.S, sh.H * D))
    return kTmaError;
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  const int rows = B * sh.S * sh.H;
  delta_kernel<bf16, D><<<(rows * kDeltaLanes<bf16, D> + 255) / 256, 256, 0,
                          s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), fdelta,
      rows, sh.S, sh.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(dkdv_sm90<D>, DkdvSmem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (sh.S + kTile64 - 1) / kTile64;
  const dim3 grid_kv((tiles + 1) / 2, sh.KH, B);
  dkdv_sm90<D><<<grid_kv, kSm90Threads, DkdvSmem<D>::BYTES, s>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = set_smem(dq_sm90<D>, DqSmem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(sh.H, B, (sh.S + kTileM - 1) / kTileM);
  dq_sm90<D><<<grid_q, kSm90Threads, DqSmem<D>::BYTES, s>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<bf16*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
constexpr int kF32FwdSmem =
    Tile<kBlockM, D>::BYTES + 2 * Tile<kBlockN, D>::BYTES;
template <int D>
constexpr int kF32DkdvSmem = 2 * Tile<kBlockM, D>::BYTES +
                             2 * Tile<kBlockQ, D>::BYTES +
                             2 * kBlockQ * (int)sizeof(float);
template <int D>
constexpr int kF32DqSmem =
    2 * Tile<kBlockM, D>::BYTES + 2 * Tile<kBlockN, D>::BYTES;

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, const Shape& sh, cudaStream_t s) {
  const int smem = kF32FwdSmem<D>;
  cudaError_t err = set_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sh.S + kBlockM - 1) / kBlockM, sh.H, B);
  fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int B,
                   const Shape& sh, cudaStream_t s) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);

  const int rows = B * sh.S * sh.H;
  delta_kernel<float, D><<<(rows * kDeltaLanes<float, D> + 255) / 256, 256,
                           0, s>>>(
      static_cast<const float*>(o), tdo, fdelta, rows, sh.S, sh.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem_kv = kF32DkdvSmem<D>;
  err = set_smem(dkdv_kernel<D>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((sh.S + kBlockM - 1) / kBlockM, sh.KH, B);
  dkdv_kernel<D><<<grid_kv, kThreads, smem_kv, s>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<float*>(dk),
      static_cast<float*>(dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem_q = kF32DqSmem<D>;
  err = set_smem(dq_kernel<D>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((sh.S + kBlockM - 1) / kBlockM, sh.H, B);
  dq_kernel<D><<<grid_q, kThreads, smem_q, s>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<float*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of kernel 0 (forward), 1 (dK/dV) or 2 (dQ) for
// storage dtype `dtype`.
template <int D>
int smem_bytes(int kernel, int dtype) {
  const int bf16_bytes[3] = {FwdSmem<D>::BYTES, DkdvSmem<D>::BYTES,
                             DqSmem<D>::BYTES};
  const int f32_bytes[3] = {kF32FwdSmem<D>, kF32DkdvSmem<D>, kF32DqSmem<D>};
  if (kernel < 0 || kernel > 2) return -1;
  if (dtype == rtt::kBF16) return bf16_bytes[kernel];
  return dtype == rtt::kF32 ? f32_bytes[kernel] : -1;
}

bool shape_ok(int B, int S, int H, int KH, int D) {
  return B > 0 && S > 0 && KH > 0 && H % KH == 0 && (D == 64 || D == 128);
}

}  // namespace

// Contiguous [B,S,H,D] q / o / dq / dout and [B,S,KH,D] k / v / dk / dv of
// storage dtype `dtype` (0 f32, 1 bf16), 16-byte aligned; lse and delta
// [B,H,S] f32. D is 64 or 128 and H a multiple of KH. bf16 runs the TMA +
// wgmma kernels, f32 the mma.sync split kernels. Return -1 for a shape or
// dtype the kernels do not take, -2 when no TMA descriptor could be
// built, else the CUDA error of the last launch (0 on success).

extern "C" int rtt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int S, int H, int KH, int D,
                                       float scale, int dtype, void* stream) {
  if (!shape_ok(B, S, H, KH, D)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{S, H, KH, scale};
  if (dtype == rtt::kBF16)
    return D == 128 ? launch_fwd_sm90<128>(q, k, v, o, lse, B, sh, s)
                    : launch_fwd_sm90<64>(q, k, v, o, lse, B, sh, s);
  if (dtype == rtt::kF32)
    return D == 128 ? launch_fwd_f32<128>(q, k, v, o, lse, B, sh, s)
                    : launch_fwd_f32<64>(q, k, v, o, lse, B, sh, s);
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
    return D == 128 ? launch_bwd_sm90<128>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, B, sh, s)
                    : launch_bwd_sm90<64>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, B, sh, s);
  if (dtype == rtt::kF32)
    return D == 128 ? launch_bwd_f32<128>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, B, sh, s)
                    : launch_bwd_f32<64>(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, B, sh, s);
  return -1;
}

// The dynamic shared memory a CTA of kernel 0 (forward), 1 (dK/dV) or 2
// (dQ) asks for at head_dim D and storage dtype `dtype` (-1 for another),
// for reports beside ptxas' registers.
extern "C" int rtt_flash_attention_smem(int kernel, int D, int dtype) {
  if (D == 128) return smem_bytes<128>(kernel, dtype);
  return D == 64 ? smem_bytes<64>(kernel, dtype) : -1;
}
