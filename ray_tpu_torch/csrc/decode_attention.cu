// Single-token decode attention over a KV cache, split-K flash-decode for
// Hopper (sm_90a): the contiguous cache and the paged one, read through a
// block table, in one kernel family.
//
// Replaces: ray_tpu/ops/decode_attention.py::decode_attention (the Pallas
// kernel `_decode_kernel`) and ray_tpu/ops/paged_decode.py::
// paged_decode_attention (the Pallas kernel `_paged_kernel`). Same
// function: one query token per slot, GQA (the G = H/KH query heads of a
// KV head share its cache rows), softmax over each slot's first
// lengths[b] rows with f32 logits, f32 max / sum / accumulator, scale
// D^-0.5; a slot with length 0 outputs 0.
//
// Bound on the H100: bytes. Each cache row is read once and used for G
// dot products and G axpys, about 2*G flops per byte read, far below the
// ~295 flops per byte where the card stops being memory-bound. So the
// design only has to keep enough 16-byte loads in flight:
//
//   * The TPU kernels walk S sequentially on one core with their softmax
//     carry in VMEM. Here blocks run in parallel, so S is split: one CTA
//     per (split, KV head, slot), enough splits that the grid has a few
//     hundred CTAs (B*KH alone is 64 at B=8, half the SMs). Each split
//     writes an f32 partial (max, sum, accumulator); a second small
//     kernel merges the splits and writes the output in storage dtype.
//   * Inside a CTA, a group of D/VEC lanes owns one cache row at a time:
//     each lane loads 16 bytes of k and of v, the G partial dot products
//     are summed with warp shuffles, and the online-softmax update stays
//     in registers (one (max, sum, acc) carry per row group). Rows are
//     unrolled U at a time so each lane has 2*U loads in flight.
//   * Rows at or past lengths[b] are never loaded: the split range is cut
//     at the length, and splits that start past it exit at once (the
//     merge skips them), so a ragged batch streams only its valid rows.
//   * No shared-memory k/v tiles and no tensor cores: at one query row
//     per head group a matrix unit has nothing to amortise. Faster
//     variants (TMA ring, wgmma over the head group) are later work.
//
// Paged addressing (kPaged). The pool is [Bp, KH, S, D] viewed as
// Bp * S/page pages; page t is rows (t % np_row) * page .. of pool row
// t / np_row, and block_table[b, p] names sequence b's logical page p.
// The contiguous cache is the identity-table case: the kernels differ
// only in where a logical row lives. Every split covers a whole number of
// pages (the wrapper rounds split_rows to the page), so a CTA reads the
// table once per page it streams -- one extra 4-byte load per page -- into
// shared memory before its loop, and within a page it keeps the 16-byte
// group-per-row loads. A row's page is a multiply-shift (no integer
// division), and the loads are not behind a branch: with table-dependent
// addresses a branch per row serialised a step's loads and halved the
// achieved bandwidth. Pages at or past ceil(lengths[b]/page) are neither
// read from the table nor loaded. With the identity table and the same
// split plan, every lane loads the same rows in the same order as the
// contiguous kernel, so the two outputs are bit-equal. Bound: the same
// bytes as the contiguous read of the valid rows, plus the table entries
// of the pages read.

#include "common.cuh"

namespace {

using rtt::Vec16;

constexpr float kNegInf = -1e30f;  // same finite sentinel as the reference
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// One launch's shapes and buffers. Contiguous: table == nullptr and
// S_log == S.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const int* table;  // [B, NP] flat page ids (paged only)
  void* out;
  float* part_ml;
  float* part_acc;
  int B, H, KH;
  int S;      // rows of one pool slot (the cache's third axis)
  int S_log;  // logical rows a sequence can hold: S, or NP * page
  int NP, page, np_row;
  // r / page == (r * page_magic) >> page_magic_shift for 0 <= r < 2^31
  // (a multiply in place of an integer division). page_magic <= 2^33, so
  // the 64-bit product cannot wrap there; the kernel's r is a row offset
  // inside one split, below split_rows, an int.
  unsigned long long page_magic;
  int page_magic_shift;
  int split_rows, n_split;
  float scale;
};

template <typename T, int D, int G, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Args a) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LPR = D / VEC;     // lanes that share one cache row
  constexpr int RPW = 32 / LPR;    // rows a warp covers per step
  constexpr int NG = kWarps * RPW; // row groups in the CTA
  constexpr int U = (G * VEC > 32) ? 2 : 4;  // rows unrolled per group
  static_assert(D % VEC == 0 && 32 % LPR == 0, "unsupported head_dim");

  const int sp = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(a.lengths[b], a.S_log);
  const int start = sp * a.split_rows;
  if (start >= len) return;  // the merge reads only splits below len
  const int end = min(start + a.split_rows, len);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp * RPW + lane / LPR;
  const int d0 = (lane % LPR) * VEC;

  const T* q = static_cast<const T*>(a.q);
  float qf[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    Vec16<T>::load(q + ((size_t)b * a.H + (size_t)kh * G + g) * D + d0,
                   qf[g]);

  // Index (in rows of D) of the first row of each page this split reads;
  // `start` is a page multiple. (The q loads above are already in flight
  // while the table is read.)
  extern __shared__ int sm_page_row[];
  size_t base = 0;
  if constexpr (kPaged) {
    const int p0 = start / a.page;
    const int n_pages = (end - start + a.page - 1) / a.page;
    for (int i = threadIdx.x; i < n_pages; i += kThreads) {
      const int t = a.table[(size_t)b * a.NP + p0 + i];
      sm_page_row[i] =
          ((t / a.np_row) * a.KH + kh) * a.S + (t % a.np_row) * a.page;
    }
    __syncthreads();
  } else {
    base = ((size_t)b * a.KH + kh) * (size_t)a.S;
  }
  auto row_index = [&](int row) -> size_t {
    if constexpr (kPaged) {
      const int r = row - start;
      const int p = (int)(((unsigned long long)r * a.page_magic) >>
                          a.page_magic_shift);
      return (size_t)sm_page_row[p] + (r - p * a.page);
    } else {
      return base + row;
    }
  };

  const T* kp = static_cast<const T*>(a.k) + d0;
  const T* vp = static_cast<const T*>(a.v) + d0;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }

  // Trip count is uniform over the CTA, so every lane reaches every
  // shuffle below; rows past `end` are predicated off.
  const int steps = (end - start + NG * U - 1) / (NG * U);
  for (int it = 0; it < steps; ++it) {
    float kf[U][VEC], vf[U][VEC];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = start + (it * U + u) * NG + rg;
      valid[u] = row < end;
      if constexpr (kPaged) {
        // Branch-free: a row past `end` loads row `start` (valid, and
        // already in cache) and is zeroed after the load. Behind a branch,
        // the table-dependent addresses made the compiler serialise the
        // loads of a step (half the contiguous read's rate at S=4096).
        const size_t off = row_index(valid[u] ? row : start) * D;
        Vec16<T>::load(kp + off, kf[u]);
        Vec16<T>::load(vp + off, vf[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          kf[u][j] = valid[u] ? kf[u][j] : 0.f;
          vf[u][j] = valid[u] ? vf[u][j] : 0.f;
        }
      } else if (valid[u]) {
        const size_t off = row_index(row) * D;
        Vec16<T>::load(kp + off, kf[u]);
        Vec16<T>::load(vp + off, vf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[u][j] = vf[u][j] = 0.f;
      }
    }
    float x[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(qf[g][j], kf[u][j], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        x[u][g] = valid[u] ? s * a.scale : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, x[u][g]);
      // Before the first valid row both are kNegInf: corr is 1 and the
      // carry it scales is still 0.
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = valid[u] ? expf(x[u][g] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(p, vf[u][j], acc[g][j]);
      }
      m[g] = mx;
    }
  }

  // Merge the CTA's row groups into one partial for this split.
  __shared__ float sm_m[NG][G];
  __shared__ float sm_l[NG][G];
  __shared__ float sm_acc[NG][G][D];
  if (lane % LPR == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[rg][g] = m[g];
      sm_l[rg][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j) sm_acc[rg][g][d0 + j] = acc[g][j];
  __syncthreads();

  const size_t pbase = ((size_t)(b * a.KH + kh) * a.n_split + sp) * G;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    const int d = e % D;
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < NG; ++r) M = fmaxf(M, sm_m[r][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < NG; ++r) {
      // Empty groups carry kNegInf; M is finite (row `start` is valid),
      // so their weight underflows to exactly 0.
      const float w = expf(sm_m[r][g] - M);
      L = fmaf(sm_l[r][g], w, L);
      A = fmaf(sm_acc[r][g][d], w, A);
    }
    a.part_acc[(pbase + g) * D + d] = A;
    if (d == 0) {
      a.part_ml[(pbase + g) * 2] = M;
      a.part_ml[(pbase + g) * 2 + 1] = L;
    }
  }
}

// One CTA per (query head, slot), one thread per output element.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int H, int KH,
                                    int S_log, int D, int split_rows,
                                    int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int G = H / KH;
  const int kh = h / G;
  const int g = h % G;
  const int len = min(lengths[b], S_log);
  // Splits that hold at least one valid row; none for a length-0 slot.
  const int ns = len > 0 ? min(n_split, (len + split_rows - 1) / split_rows)
                         : 0;
  const size_t base = (size_t)(b * KH + kh) * n_split;
  float M = kNegInf;
  for (int s = 0; s < ns; ++s)
    M = fmaxf(M, part_ml[((base + s) * G + g) * 2]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < ns; ++s) {
    const size_t p = (base + s) * G + g;
    const float w = expf(part_ml[p * 2] - M);
    L = fmaf(part_ml[p * 2 + 1], w, L);
    A = fmaf(part_acc[p * D + d], w, A);
  }
  const float o = ns > 0 ? A / fmaxf(L, 1e-30f) : 0.f;
  out[((size_t)b * H + h) * D + d] = rtt::from_f32<T>(o);
}

template <typename T, int D, int G, bool kPaged>
void launch(const Args& a, size_t smem, cudaStream_t stream) {
  const dim3 grid(a.n_split, a.KH, a.B);
  decode_split_kernel<T, D, G, kPaged><<<grid, kThreads, smem, stream>>>(a);
  decode_merge_kernel<T><<<dim3(a.H, a.B), D, 0, stream>>>(
      a.part_ml, a.part_acc, a.lengths, static_cast<T*>(a.out), a.H, a.KH,
      a.S_log, D, a.split_rows, a.n_split);
}

template <typename T, int D, bool kPaged>
int dispatch_g(int G, const Args& a, size_t smem, cudaStream_t stream) {
  switch (G) {
    case 1:
      launch<T, D, 1, kPaged>(a, smem, stream);
      return 0;
    case 2:
      launch<T, D, 2, kPaged>(a, smem, stream);
      return 0;
    case 4:
      launch<T, D, 4, kPaged>(a, smem, stream);
      return 0;
    case 8:
      launch<T, D, 8, kPaged>(a, smem, stream);
      return 0;
  }
  return -1;
}

template <bool kPaged>
int dispatch(int dtype, int D, const Args& a, size_t smem,
             cudaStream_t stream) {
  if (a.KH <= 0 || a.H % a.KH != 0) return -1;
  const int G = a.H / a.KH;
  int rc = -1;
  if (dtype == rtt::kF32) {
    if (D == 64) rc = dispatch_g<float, 64, kPaged>(G, a, smem, stream);
    if (D == 128) rc = dispatch_g<float, 128, kPaged>(G, a, smem, stream);
  } else if (dtype == rtt::kBF16) {
    if (D == 64)
      rc = dispatch_g<__nv_bfloat16, 64, kPaged>(G, a, smem, stream);
    if (D == 128)
      rc = dispatch_g<__nv_bfloat16, 128, kPaged>(G, a, smem, stream);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,H,D]; k, v [B,KH,S,D] contiguous, storage dtype `dtype`; lengths
// [B] int32; out [B,H,D]; part_ml [B,KH,n_split,G,2] and part_acc
// [B,KH,n_split,G,D] f32 scratch. Returns -1 for an unsupported
// (dtype, D, G), else cudaGetLastError() after the two launches.
extern "C" int rtt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* part_ml, void* part_acc,
                                    int B, int H, int KH, int S, int D,
                                    int split_rows, int n_split, float scale,
                                    int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(lengths), nullptr, out,
               static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               B, H, KH, S, S, 0, 1, S, 1ull << 32, 32, split_rows, n_split,
               scale};
  return dispatch<false>(dtype, D, a, 0, static_cast<cudaStream_t>(stream));
}

// The paged read: k, v [Bp,KH,S,D] page pools (S a multiple of `page`),
// block_table [B,NP] int32 flat page ids, the rest as above. split_rows
// must be a multiple of `page`; the caller sizes the dynamic shared
// memory as split_rows / page ints (one pool row index per page).
extern "C" int rtt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* block_table,
    const void* lengths, void* out, void* part_ml, void* part_acc, int B,
    int H, int KH, int S, int D, int NP, int page, int split_rows,
    int n_split, float scale, int dtype, void* stream) {
  if (page <= 0 || S % page != 0 || split_rows % page != 0) return -1;
  // Round-up reciprocal: with l = ceil(log2(page)) and magic =
  // ceil(2^(32+l) / page) <= 2^33, (r * magic) >> (32+l) == r / page for
  // every r < 2^32 (Granlund and Montgomery, PLDI 1994) as long as the
  // product fits 64 bits: r < 2^31, which holds for r < split_rows.
  int l = 0;
  while ((1ll << l) < page) ++l;
  const unsigned long long magic =
      ((1ull << (32 + l)) + (unsigned long long)page - 1) / page;
  const Args a{q, k, v, static_cast<const int*>(lengths),
               static_cast<const int*>(block_table), out,
               static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               B, H, KH, S, NP * page, NP, page, S / page, magic, 32 + l,
               split_rows, n_split, scale};
  const size_t smem = (size_t)(split_rows / page) * sizeof(int);
  return dispatch<true>(dtype, D, a, smem, static_cast<cudaStream_t>(stream));
}
