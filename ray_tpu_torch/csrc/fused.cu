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
//   * RMSNorm: one CTA per row; the row is read with 16-byte loads, the
//     f32 sum of squares is reduced over the CTA, and the second pass
//     re-reads the row from L1/L2 (a 4096-wide bf16 row is 8 KB) to
//     scale and store it. The residual form adds x + r in the storage
//     dtype first (as the unfused `x = x + attn` does), writes that sum,
//     and normalises it.
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

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// x, r [N, d]; scale [d]; out, sum_out [N, d]. RES selects the residual
// form (r and sum_out are ignored without it).
template <typename T, bool RES>
__global__ void rms_kernel(const T* __restrict__ x, const T* __restrict__ r,
                           const T* __restrict__ scale, T* __restrict__ out,
                           T* __restrict__ sum_out, int d, float eps) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ float scratch[32];
  const size_t off = (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
    float xv[VEC];
    Vec16<T>::load(x + off + c, xv);
    if (RES) {
      float rv[VEC];
      Vec16<T>::load(r + off + c, rv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) xv[j] = rtt::round_to<T>(xv[j] + rv[j]);
      Vec16<T>::store(sum_out + off + c, xv);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = fmaf(xv[j], xv[j], ss);
  }
  const float inv = rsqrtf(block_sum(ss, scratch) / (float)d + eps);
  for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
    float xv[VEC], sv[VEC], yv[VEC];
    Vec16<T>::load(x + off + c, xv);
    if (RES) {
      float rv[VEC];
      Vec16<T>::load(r + off + c, rv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) xv[j] = rtt::round_to<T>(xv[j] + rv[j]);
    }
    Vec16<T>::load(scale + c, sv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) yv[j] = (xv[j] * inv) * (1.f + sv[j]);
    Vec16<T>::store(out + off + c, yv);
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

int rms_threads(int d, int vec) {
  const int want = ((d / vec + 31) / 32) * 32;
  return want < 32 ? 32 : (want > 256 ? 256 : want);
}

template <typename T, bool RES>
void launch_rms(const void* x, const void* r, const void* scale, void* out,
                void* sum_out, int n, int d, float eps, cudaStream_t s) {
  rms_kernel<T, RES><<<n, rms_threads(d, Vec16<T>::N), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<T*>(out),
      static_cast<T*>(sum_out), d, eps);
}

}  // namespace

// All entry points: contiguous tensors of storage dtype `dtype` (0 f32,
// 1 bf16), 16-byte aligned; row width d a multiple of 16 bytes. Return -1
// for an unsupported dtype, else cudaGetLastError() after the launch.

extern "C" int rtt_rms_norm(const void* x, const void* scale, void* out,
                            int n, int d, float eps, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kF32)
    launch_rms<float, false>(x, nullptr, scale, out, nullptr, n, d, eps, s);
  else if (dtype == rtt::kBF16)
    launch_rms<__nv_bfloat16, false>(x, nullptr, scale, out, nullptr, n, d,
                                     eps, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_rms_norm_residual(const void* x, const void* r,
                                     const void* scale, void* out,
                                     void* sum_out, int n, int d, float eps,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kF32)
    launch_rms<float, true>(x, r, scale, out, sum_out, n, d, eps, s);
  else if (dtype == rtt::kBF16)
    launch_rms<__nv_bfloat16, true>(x, r, scale, out, sum_out, n, d, eps, s);
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
