// The per-layer glue of the Llama block as hand-written Hopper kernels:
// RMSNorm, RMSNorm with the residual add folded in, rotary embedding of q
// and k in one pass, and SwiGLU.
//
// Replaces the Pallas kernels of ray_tpu/ops/fused.py:
//   rtt_rms_norm           <- fused_rms_norm          (_rms_kernel)
//   rtt_rms_norm_residual  <- fused_rms_norm_residual (_rms_res_kernel)
//   rtt_qk_rope            <- fused_qk_rope           (_rope_kernel)
//   rtt_swiglu             <- fused_swiglu            (_swiglu_kernel)
//
// Bound on the H100: bytes, for all four. Each does a handful of f32
// operations per element it reads, against the ~20 the card can afford
// per byte of device memory, so the design goal is the TPU kernels' own:
// one pass over the operands, no intermediate written back.
//
//   * RMSNorm: one pass over device memory with the row in registers.
//     A row's threads load all of it, of r and of scale with 16-byte
//     loads before anything else, so the cold scale row's latency
//     overlaps the row's; each thread keeps its vectors packed (4
//     registers each) until it stores. The residual form rounds u = x + r
//     once to the storage dtype (as the unfused `x = x + attn` does) and
//     stores it before the reduction, so that store overlaps it. The f32
//     sum of squares is reduced with warp shuffles and, for a row wider
//     than a warp, one exchange of the warps' partials in shared memory
//     (one barrier). Threads a row and vectors a thread are template
//     arguments picked from the width (dispatch_rms); a width outside
//     that table takes the looping variant of the same kernel, which
//     reads the row a second time from L1/L2.
//   * RoPE: one thread per (token, head group, chunk of W = 8
//     frequencies), every load of a call in flight at once. A thread makes
//     its 16-byte loads of the x1 chunk and the matching x2 chunk of each of
//     its HG heads first (q heads, then k heads, one list), computes the W
//     angles' cos and sin once with full-precision sincosf (the angle is
//     (float)pos * inv_freq[i], one f32 product, as apply_rope), and
//     rotates its heads with them: the TPU kernel's "cos/sin once per
//     position", per pair of heads. The decode shape (8 tokens x 40 heads)
//     takes one head a thread, 20 CTAs; the training shape (2048 tokens)
//     two. Rotation is half-split, not interleaved. The inverse
//     frequencies 1/theta^(2i/D) come from the wrapper
//     (ops/rotary.rope_frequencies, D/2 floats): the TPU kernel rebuilds
//     them in-kernel, but a powf here may differ from PyTorch's pow by an
//     ulp, which at position p moves the angle by p ulps; with the plain
//     version's own table the angles match bit for bit. A head_dim whose
//     half is not a multiple of 8 takes chunks of one frequency (W = 1),
//     scalar loads.
//   * SwiGLU: a grid-stride elementwise pass, silu(gate) * up in f32,
//     stored in the gate's dtype.

#include "common.cuh"

namespace {

using rtt::Vec16;

// One 16-byte vector as it lies in memory, and back.
template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// The sum of v over the TPR threads of each row of a CTA. A row's threads
// are consecutive: TPR-aligned lanes of one warp (TPR <= 32) or whole
// warps. Xor shuffles inside the warp; a row wider than a warp then
// exchanges its warps' partial sums once through shared memory (one
// barrier). Every thread of a row ends with the same bits.
template <int TPR, int ROWS>
__device__ __forceinline__ float row_sum(float v) {
  constexpr int LANES = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (TPR > 32) {
    constexpr int WPR = TPR / 32;
    __shared__ float part[ROWS * WPR];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = v;
    __syncthreads();
    const float* mine = part + warp / WPR * WPR;
    v = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) v += mine[w];
  }
  return v;
}

// x, r [n, d]; scale [d]; out, sum_out [n, d]. RES selects the residual
// form (r and sum_out are ignored without it). ROWS rows a CTA, TPR
// threads a row.
//
// V > 0: d == V * TPR * (16 / sizeof(T)). Each thread loads its V 16-byte
// vectors of the row (thread t the vectors t, t + TPR, ..., so a warp's
// loads are contiguous), of r, and of scale, all before the reduction,
// and keeps them packed in registers until its stores: one pass over
// device memory. The residual form stores u = x + r (rounded once to T)
// before the reduction. Rows past n (the last CTA) load row n - 1 and
// store nothing.
//
// V == 0: any d that is a multiple of 16 bytes; one row a CTA, each thread
// looping over the row's vectors twice (the second pass reads x, or u,
// again from L1/L2).
template <typename T, bool RES, int V, int TPR, int ROWS>
__global__ void __launch_bounds__(TPR * ROWS)
    rms_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const T* __restrict__ scale, T* __restrict__ out,
               T* __restrict__ sum_out, int n, int d, float eps) {
  using V16 = Vec16<T>;
  constexpr int VEC = V16::N;
  static_assert((TPR & (TPR - 1)) == 0 && TPR * ROWS % 32 == 0,
                "a row's threads must tile whole warps");
  if constexpr (V == 0) {
    static_assert(ROWS == 1, "the general variant takes one row a CTA");
    const size_t off = (size_t)blockIdx.x * d;
    float ss = 0.f;
    for (int c = threadIdx.x * VEC; c < d; c += TPR * VEC) {
      uint4 u = ld16(x + off + c);
      float a[VEC];
      if constexpr (RES) {
        float b[VEC];
        V16::widen(u, a);
        V16::widen(ld16(r + off + c), b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] += b[e];
        u = V16::pack(a);
        st16(sum_out + off + c, u);
      }
      V16::widen(u, a);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(a[e], a[e], ss);
    }
    const float inv = rsqrtf(row_sum<TPR, 1>(ss) / (float)d + eps);
    for (int c = threadIdx.x * VEC; c < d; c += TPR * VEC) {
      // u was stored by this thread: a plain load sees it.
      const uint4 u = RES ? *reinterpret_cast<const uint4*>(sum_out + off + c)
                          : ld16(x + off + c);
      float a[VEC], sv[VEC];
      V16::widen(u, a);
      V16::load(scale + c, sv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = (a[e] * inv) * (1.f + sv[e]);
      st16(out + off + c, V16::pack(a));
    }
  } else {
    constexpr int D = V * TPR * VEC;
    const int t = threadIdx.x % TPR;
    const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
    const size_t at = (size_t)(row < n ? row : n - 1) * D + t * VEC;
    uint4 xv[V], sv[V];
    [[maybe_unused]] uint4 rv[RES ? V : 1];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sv[j] = ld16(scale + (j * TPR + t) * VEC);
      xv[j] = ld16(x + at + j * TPR * VEC);
      if constexpr (RES) rv[j] = ld16(r + at + j * TPR * VEC);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float a[VEC];
      V16::widen(xv[j], a);
      if constexpr (RES) {
        float b[VEC];
        V16::widen(rv[j], b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] += b[e];
        xv[j] = V16::pack(a);  // u, rounded once to T
        V16::widen(xv[j], a);
        if (row < n) st16(sum_out + at + j * TPR * VEC, xv[j]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(a[e], a[e], ss);
    }
    const float inv = rsqrtf(row_sum<TPR, ROWS>(ss) / (float)D + eps);
    if (row >= n) return;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float a[VEC], s[VEC];
      V16::widen(xv[j], a);
      V16::widen(sv[j], s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = (a[e] * inv) * (1.f + s[e]);
      st16(out + at + j * TPR * VEC, V16::pack(a));
    }
  }
}

// W consecutive values of a row, widened to f32 (W = 8: 16 bytes in
// bf16, 32 in f32; W = 1: one value), and back.
template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* p, float* out) {
  if constexpr (W == 1) {
    out[0] = rtt::to_f32(p[0]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += Vec16<T>::N) Vec16<T>::load(p + i, out + i);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* p, const float* in) {
  if constexpr (W == 1) {
    p[0] = rtt::from_f32<T>(in[0]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += Vec16<T>::N) Vec16<T>::store(p + i, in + i);
  }
}

// q [T, H, D], k [T, KH, D] (T = B*S tokens), pos [T] int32,
// inv_freq [D/2] f32. Thread (token, head group of HG, chunk of W
// frequencies), the chunk fastest: neighbouring threads read neighbouring
// 16 bytes of one head.
template <typename T, int W, int HG>
__global__ void rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const int* __restrict__ pos,
                            const float* __restrict__ inv_freq,
                            T* __restrict__ oq, T* __restrict__ ok,
                            int tokens, int H, int KH, int D, int n_groups) {
  const int half = D / 2;
  const unsigned n_chunk = half / W;
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned chunk = idx % n_chunk;  // three divisions a thread
  const unsigned rest = idx / n_chunk;
  const int grp = rest % n_groups;
  const int tok = rest / n_groups;
  if (tok >= tokens) return;
  const int i0 = chunk * W;
  const int h0 = grp * HG;
  const size_t tq = (size_t)tok * H, tk = (size_t)tok * KH;

  float x1[HG][W], x2[HG][W];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const int hh = h0 + j;
    if (hh < H + KH) {
      const T* src = hh < H ? q + (tq + hh) * D : k + (tk + hh - H) * D;
      load_chunk<T, W>(src + i0, x1[j]);
      load_chunk<T, W>(src + half + i0, x2[j]);
    }
  }
  const float p = (float)pos[tok];
  float c[W], s[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float ang = p * inv_freq[i0 + i];  // one f32 product, as apply_rope
    sincosf(ang, &s[i], &c[i]);
  }
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const int hh = h0 + j;
    if (hh < H + KH) {
      float y1[W], y2[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        y1[i] = x1[j][i] * c[i] - x2[j][i] * s[i];
        y2[i] = x2[j][i] * c[i] + x1[j][i] * s[i];
      }
      T* dst = hh < H ? oq + (tq + hh) * D : ok + (tk + hh - H) * D;
      store_chunk<T, W>(dst + i0, y1);
      store_chunk<T, W>(dst + half + i0, y2);
    }
  }
}

// Nothing: the launch floor the other kernels' times are read against.
__global__ void empty_kernel() {}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return (g * (1.f / (1.f + expf(-g)))) * u;
}

// gate, up, out: n elements each.
template <typename T>
__global__ void swiglu_kernel(const T* __restrict__ gate,
                              const T* __restrict__ up, T* __restrict__ out,
                              size_t n) {
  constexpr int VEC = Vec16<T>::N;
  const size_t nvec = n / VEC;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    float gv[VEC], uv[VEC], ov[VEC];
    Vec16<T>::load(gate + i * VEC, gv);
    Vec16<T>::load(up + i * VEC, uv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ov[j] = silu_mul(gv[j], uv[j]);
    Vec16<T>::store(out + i * VEC, ov);
  }
  for (size_t i = nvec * VEC + tid; i < n; i += stride)
    out[i] = rtt::from_f32<T>(
        silu_mul(rtt::to_f32(gate[i]), rtt::to_f32(up[i])));
}

struct RmsArgs {
  const void *x, *r, *scale;
  void *out, *sum_out;
  int n, d;
  float eps;
  cudaStream_t s;
};

template <typename T, bool RES, int V, int TPR, int ROWS>
void launch_rms(const RmsArgs& a) {
  rms_kernel<T, RES, V, TPR, ROWS>
      <<<(a.n + ROWS - 1) / ROWS, TPR * ROWS, 0, a.s>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.r),
          static_cast<const T*>(a.scale), static_cast<T*>(a.out),
          static_cast<T*>(a.sum_out), a.n, a.d, a.eps);
}

// Up to this many rows (about two an SM) a wide row takes one vector a
// thread, beyond it two.
constexpr int kFewRows = 256;

// The variant by the row's count of 16-byte vectors, nv = d / (16 /
// sizeof(T)), and the count of rows. Register-resident at the widths the
// models run: Llama-3-8B's 4096 (nv 512 in bf16, 1024 in f32; bf16 8192
// has f32 4096's nv), Llama-3.2-1B's 2048 (256, 512) and the tiny test
// config's 64 (8, 16). A wide row takes one CTA; of 1 to 16 vectors a
// thread (nv / V threads a row), one was the fastest up to about 256 rows
// (the latency of a few rows: more threads start the loads and run the
// epilogue sooner) and two beyond (rows enough to fill the card: fewer,
// fuller threads), or within a few per cent of the fastest; f32 4096
// takes two at every count. Narrow rows take one vector a thread and 128
// threads a CTA, several rows to a warp, no barrier. Any other width
// loops.
template <typename T, bool RES>
void dispatch_rms(const RmsArgs& a) {
  const bool few = a.n <= kFewRows;
  switch (a.d / Vec16<T>::N) {
    case 8:
      return launch_rms<T, RES, 1, 8, 16>(a);
    case 16:
      return launch_rms<T, RES, 1, 16, 8>(a);
    case 256:
      return few ? launch_rms<T, RES, 1, 256, 1>(a)
                 : launch_rms<T, RES, 2, 128, 1>(a);
    case 512:
      return few ? launch_rms<T, RES, 1, 512, 1>(a)
                 : launch_rms<T, RES, 2, 256, 1>(a);
    case 1024:
      return launch_rms<T, RES, 2, 512, 1>(a);
    default:
      return launch_rms<T, RES, 0, 256, 1>(a);
  }
}

}  // namespace

// All entry points: contiguous tensors of storage dtype `dtype` (0 f32,
// 1 bf16), 16-byte aligned; row width d a multiple of 16 bytes. Return -1
// for an unsupported dtype, else cudaGetLastError() after the launch.

extern "C" int rtt_rms_norm(const void* x, const void* scale, void* out,
                            int n, int d, float eps, int dtype,
                            void* stream) {
  const RmsArgs a{x, nullptr, scale, out, nullptr, n, d, eps,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kF32)
    dispatch_rms<float, false>(a);
  else if (dtype == rtt::kBF16)
    dispatch_rms<__nv_bfloat16, false>(a);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_rms_norm_residual(const void* x, const void* r,
                                     const void* scale, void* out,
                                     void* sum_out, int n, int d, float eps,
                                     int dtype, void* stream) {
  const RmsArgs a{x, r, scale, out, sum_out, n, d, eps,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kF32)
    dispatch_rms<float, true>(a);
  else if (dtype == rtt::kBF16)
    dispatch_rms<__nv_bfloat16, true>(a);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kRopeThreads = 128;
constexpr long long kRopeTargetThreads = 132LL * 4 * kRopeThreads;

template <typename T, int W, int HG>
void launch_rope(const void* q, const void* k, const int* pos,
                 const float* inv, void* oq, void* ok, int tokens, int H,
                 int KH, int D, cudaStream_t s) {
  const int n_groups = (H + KH + HG - 1) / HG;
  const long long threads = (long long)tokens * n_groups * (D / 2 / W);
  const unsigned blocks =
      (unsigned)((threads + kRopeThreads - 1) / kRopeThreads);
  rope_kernel<T, W, HG><<<blocks, kRopeThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), pos, inv,
      static_cast<T*>(oq), static_cast<T*>(ok), tokens, H, KH, D, n_groups);
}

// Two heads a thread where the grid still has kRopeTargetThreads threads
// (four CTAs of 128 on each SM), else one. At phase 8's shape two were the
// fastest of 1, 2, 4 and 8 heads a thread (PERF.md): larger groups hold
// more loads in registers and leave fewer threads to hide their latency.
template <typename T, int W>
void dispatch_rope(const void* q, const void* k, const int* pos,
                   const float* inv, void* oq, void* ok, int tokens, int H,
                   int KH, int D, cudaStream_t s) {
  const long long pairs =
      (long long)tokens * (D / 2 / W) * ((H + KH + 1) / 2);
  if (pairs >= kRopeTargetThreads)
    launch_rope<T, W, 2>(q, k, pos, inv, oq, ok, tokens, H, KH, D, s);
  else
    launch_rope<T, W, 1>(q, k, pos, inv, oq, ok, tokens, H, KH, D, s);
}

template <typename T>
void rope_width(const void* q, const void* k, const int* pos,
                const float* inv, void* oq, void* ok, int tokens, int H,
                int KH, int D, cudaStream_t s) {
  if ((D / 2) % 8 == 0)
    dispatch_rope<T, 8>(q, k, pos, inv, oq, ok, tokens, H, KH, D, s);
  else
    dispatch_rope<T, 1>(q, k, pos, inv, oq, ok, tokens, H, KH, D, s);
}

}  // namespace

extern "C" int rtt_qk_rope(const void* q, const void* k, const void* pos,
                           const void* inv_freq, void* oq, void* ok,
                           int tokens, int H, int KH, int D, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* inv = static_cast<const float*>(inv_freq);
  if (D <= 0 || D % 2 != 0 || tokens < 0) return -1;
  if (tokens == 0) return 0;
  if (dtype == rtt::kF32)
    rope_width<float>(q, k, p, inv, oq, ok, tokens, H, KH, D, s);
  else if (dtype == rtt::kBF16)
    rope_width<__nv_bfloat16>(q, k, p, inv, oq, ok, tokens, H, KH, D, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel (one CTA of 128 threads): what a launch
// costs on the card with no work, for reading the other kernels' times.
extern "C" int rtt_empty_kernel(void* stream) {
  empty_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_swiglu(const void* gate, const void* up, void* out,
                          long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (dtype == rtt::kF32)
    swiglu_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(gate), static_cast<const float*>(up),
        static_cast<float*>(out), (size_t)n);
  else if (dtype == rtt::kBF16)
    swiglu_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gate),
        static_cast<const __nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(out), (size_t)n);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
