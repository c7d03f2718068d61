// Single-token decode attention over a KV cache for Hopper (sm_90a): the
// contiguous cache and the paged one, read through a block table, in one
// kernel of one launch.
//
// Replaces: ray_tpu/ops/decode_attention.py::decode_attention (the Pallas
// kernel `_decode_kernel`) and ray_tpu/ops/paged_decode.py::
// paged_decode_attention (the Pallas kernel `_paged_kernel`). Same
// function: one query token per slot, GQA (the G = H/KH query heads of a
// KV head share its cache rows), softmax over each slot's first
// lengths[b] rows with f32 logits, f32 max / sum / accumulator, scale
// D^-0.5; a slot with length 0 outputs 0.
//
// Bound on the H100: bytes. Each valid cache row is read once and used for
// G dot products and G axpys: 4 f32 operations per byte of K/V at G=4 and
// bf16, where the SIMT units afford about 20 per byte at 3.35 TB/s. So
// the products stay on the SIMT units, from shared memory, and the design
// is about keeping copies in flight while the card computes:
//
//   * One launch per call. The TPU kernels walk S sequentially on one core
//     with their softmax carry in VMEM. Here S is split over a thread block
//     cluster: grid (n_split, KH, B), cluster (n_split, 1, 1), one CTA per
//     (split, KV head, slot), n_split <= 8 (the portable cluster size).
//     Each CTA reduces its rows to an f32 (max, sum, accumulator) per
//     query head in its own shared memory. After a cluster barrier every
//     CTA reads all splits' partials through distributed shared memory,
//     merges them in split order (so the result does not depend on which
//     CTA merges, or when) and writes its share of the slot's outputs in
//     the storage dtype. A second barrier keeps each CTA's shared memory
//     alive until the others have read it. A CTA whose split holds no
//     valid row does no loads but takes part in both barriers. No partials
//     go to device memory and no second kernel merges them.
//   * A split's length follows the slot's: n_split is fixed by the cache
//     size and batch (ops/decode_attention.split_plan keeps the grid to
//     one wave of resident clusters), and each CTA takes ceil(len /
//     n_split) rows rounded up to the granule (16 rows, or the page where
//     that is a larger multiple), so a short slot spreads over its cluster
//     as a full one does.
//   * K and V stream through shared memory. One producer warp starts 1-D
//     bulk copies (cp.async.bulk: no tensor map) into a 64 KB ring of
//     STAGES tiles of TILE rows of K and of V, one copy a tile and tensor
//     (a page piece, paged), each signalling a "full" mbarrier with the
//     bytes it brings; four consumer warps compute on the tiles that have
//     landed and release each on an "empty" mbarrier as soon as its rows
//     are in registers. The next tiles' copies are in flight while one is
//     computed.
//   * Inside a tile a group of D/VEC lanes owns one row at a time: each
//     lane reads 16 bytes of k and of v from shared memory, the G partial
//     dot products are summed with warp shuffles, and the online-softmax
//     carry stays in registers (one (max, sum, acc) per row group), U rows
//     a step. Logits are scaled by D^-0.5 log2(e) and exponentiated with
//     ex2.approx: the 16 lanes of a group each take the G exponentials of
//     a row, and the precise expf made the loop compute-bound. Row r of a
//     split always goes to the same lane group at the same step, whatever
//     the addressing. (An mma.sync version, fed by one copy a row into
//     rows padded against ldmatrix bank conflicts, measured slower.)
//   * The tail. Only valid rows are copied (a copy is any multiple of 16
//     bytes; a row is D * sizeof(T) >= 128), so rows at or past lengths[b]
//     are never loaded. The ring rows past the last valid one hold stale
//     or uninitialised data (NaN included): their logits are masked before
//     the max and their k and v replaced by 0 before any product, so
//     nothing of them reaches the output.
//
// Paged addressing (kPaged). The pool is [Bp, KH, S, D] viewed as
// Bp * S/page pages; page t is rows (t % np_row) * page .. of pool row
// t / np_row, and block_table[b, p] names sequence b's logical page p.
// Every split starts on a page (the granule is a multiple of the page).
// The producer warp first reads the split's table entries (only pages
// below ceil(len / page)) into shared memory, then copies each tile as
// pieces, one per run of the tile's pages that lie back to back in the
// pool (one copy a tile through the engine's slot-identity table; a
// scattered table costs a copy a page, 4 KB at D=128 bf16). The
// consumers do not see the table: with the identity table and the same
// plan they compute the same rows in the same order as the contiguous
// kernel, so the two outputs are bit-equal. Bound: the contiguous read's
// bytes plus the table entries of the pages read.

#include <cstdlib>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using rtt::Vec16;
namespace sm90 = rtt::sm90;

constexpr float kNegInf = -1e30f;  // same finite sentinel as the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRingBytes = 64 * 1024;

// Tile and shared-memory sizes of one instantiation (host and device).
template <typename T, int D, int G>
struct Cfg {
  static constexpr int VEC = Vec16<T>::N;
  static constexpr int LPR = D / VEC;       // lanes that share one row
  static constexpr int RPW = 32 / LPR;      // rows a warp covers per step
  static constexpr int NG = kConsumerWarps * RPW;  // row groups
  static constexpr int U = (G * VEC > 32) ? 2 : 4;  // rows a group per step
  static constexpr int TILE = NG * U;       // rows of one ring stage
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  static constexpr int TILE_BYTES = TILE * ROW_BYTES;  // one tensor
  static constexpr int STAGES = kRingBytes / (2 * TILE_BYTES);
  static constexpr int RING = STAGES * 2 * TILE_BYTES;
  // After the loop the ring holds each row group's carry: m, l [NG][G],
  // acc [NG][G][D].
  static constexpr int MERGE = NG * G * (D + 2) * 4;
  static constexpr int SCRATCH = RING > MERGE ? RING : MERGE;
  // The CTA's partial, read by the cluster: m, l [G][2], acc [G][D].
  static constexpr int PART = G * (D + 2) * 4;
  static constexpr int BARS = 2 * STAGES * 8;  // full[STAGES], empty[STAGES]
  static_assert(D % VEC == 0 && 32 % LPR == 0, "unsupported head_dim");
  static_assert(STAGES >= 3, "the ring needs at least three stages");

  // Dynamic shared memory of a launch that reads `pages` table entries.
  static constexpr size_t bytes(int pages) {
    return (size_t)SCRATCH + PART + BARS + (size_t)pages * 4;
  }
};

// One launch's shapes and buffers. Contiguous: table == nullptr and
// S_log == S.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const int* table;  // [B, NP] flat page ids (paged only)
  void* out;
  int B, H, KH;
  int S;      // rows of one pool slot (the cache's third axis)
  int S_log;  // logical rows a sequence can hold: S, or NP * page
  int NP, page, np_row;
  int split_rows;  // the plan's rows a split (a full slot's)
  int n_split;     // CTAs of one (slot, KV head): the cluster
  int granule;     // a split's rows are a multiple of this
  float scale;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D, int G, bool kPaged>
__global__ void __launch_bounds__(kThreads, G <= 4 ? 2 : 1)
    decode_kernel(const Args a) {
  using C = Cfg<T, D, G>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + C::SCRATCH);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::SCRATCH + C::PART);
  int* page_row = reinterpret_cast<int*>(smem + C::SCRATCH + C::PART +
                                         C::BARS);
  const uint32_t ring = sm90::smem_u32(smem);
  auto full = [&](int s) { return sm90::smem_u32(bars + s); };
  auto empty = [&](int s) { return sm90::smem_u32(bars + C::STAGES + s); };

  const int sp = blockIdx.x;  // the split == the CTA's rank in its cluster
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Logits in log2 units: softmax by exp2 throughout.
  const float scale = a.scale * kLog2e;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_init_fence();
  }

  // This slot's split: every CTA of the cluster computes the same rows.
  const int len = max(0, min(a.lengths[b], a.S_log));
  const int per = (len + a.n_split - 1) / a.n_split;
  const int rows =
      min(a.split_rows, (per + a.granule - 1) / a.granule * a.granule);
  const int start = sp * rows;
  const int end = min(start + rows, len);
  const int n_tiles = end > start ? (end - start + C::TILE - 1) / C::TILE : 0;
  // Splits holding at least one valid row: the merge reads these only.
  const int ns = rows > 0 ? min(a.n_split, (len + rows - 1) / rows) : 0;
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ------------------------------------------------------------ producer
    if (n_tiles > 0) {
      const T* kg = static_cast<const T*>(a.k);
      const T* vg = static_cast<const T*>(a.v);
      size_t base = 0;
      if constexpr (kPaged) {
        // Pool row index of each page this split reads; `start` is a page
        // multiple, and no entry at or past ceil(len / page) is read.
        const int p0 = start / a.page;
        const int n_pages = (end - start + a.page - 1) / a.page;
        for (int i = lane; i < n_pages; i += 32) {
          const int t = a.table[(size_t)b * a.NP + p0 + i];
          page_row[i] =
              ((t / a.np_row) * a.KH + kh) * a.S + (t % a.np_row) * a.page;
        }
        __syncwarp();
      } else {
        base = ((size_t)b * a.KH + kh) * (size_t)a.S + start;
      }
      if (lane == 0) {
        for (int t = 0; t < n_tiles; ++t) {
          const int s = t % C::STAGES;
          if (t >= C::STAGES)
            sm90::mbar_wait(empty(s), (t / C::STAGES - 1) & 1);
          const int r0 = t * C::TILE;  // first row of the tile in the split
          const int n = min(C::TILE, end - start - r0);
          const uint32_t kdst = ring + s * 2 * C::TILE_BYTES;
          const uint32_t vdst = kdst + C::TILE_BYTES;
          sm90::mbar_expect_tx(full(s), 2 * n * C::ROW_BYTES);
          if constexpr (kPaged) {
            // One copy per tensor for each run of pages the tile overlaps
            // that lie back to back in the pool (the engine's slot-identity
            // table gives one run a tile, as the contiguous read).
            for (int r = r0, off = 0; r < r0 + n;) {
              int p = r / a.page;
              const int in = r - p * a.page;
              const size_t src = ((size_t)page_row[p] + in) * D;
              int cnt = a.page - in;
              while (r + cnt < r0 + n &&
                     page_row[p + 1] == page_row[p] + a.page) {
                ++p;
                cnt += a.page;
              }
              cnt = min(cnt, r0 + n - r);
              sm90::bulk_load(kdst + off, kg + src, cnt * C::ROW_BYTES,
                              full(s));
              sm90::bulk_load(vdst + off, vg + src, cnt * C::ROW_BYTES,
                              full(s));
              off += cnt * C::ROW_BYTES;
              r += cnt;
            }
          } else {
            const size_t src = (base + r0) * D;
            sm90::bulk_load(kdst, kg + src, n * C::ROW_BYTES, full(s));
            sm90::bulk_load(vdst, vg + src, n * C::ROW_BYTES, full(s));
          }
        }
      }
    }
  } else if (n_tiles > 0) {
    // ----------------------------------------------------------- consumers
    float* sm_m = scratch;                    // [NG][G]
    float* sm_l = scratch + C::NG * G;        // [NG][G]
    float* sm_acc = scratch + 2 * C::NG * G;  // [NG][G][D]
    const T* q = static_cast<const T*>(a.q) +
                 ((size_t)b * a.H + (size_t)kh * G) * D;
    constexpr int VEC = C::VEC;
    const int rg = warp * C::RPW + lane / C::LPR;
    const int d0 = (lane % C::LPR) * VEC;
    float qf[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) Vec16<T>::load(q + g * D + d0, qf[g]);
    float m[G], l[G], acc[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::STAGES;
      sm90::mbar_wait(full(s), (t / C::STAGES) & 1);
      const unsigned char* kt = smem + s * 2 * C::TILE_BYTES;
      const unsigned char* vt = kt + C::TILE_BYTES;
      const int r0 = start + t * C::TILE;
      float kf[C::U][VEC], vf[C::U][VEC];
      bool valid[C::U];
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
        const int local = u * C::NG + rg;
        valid[u] = r0 + local < end;
        Vec16<T>::load_shared(
            reinterpret_cast<const T*>(kt + local * C::ROW_BYTES) + d0,
            kf[u]);
        Vec16<T>::load_shared(
            reinterpret_cast<const T*>(vt + local * C::ROW_BYTES) + d0,
            vf[u]);
        // Rows past the length were not copied: whatever the ring holds
        // there (NaN included) is replaced before any product.
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          kf[u][j] = valid[u] ? kf[u][j] : 0.f;
          vf[u][j] = valid[u] ? vf[u][j] : 0.f;
        }
      }
      sm90::mbar_arrive(empty(s));  // this thread's rows are in registers

      float x[C::U][G];
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(qf[g][j], kf[u][j], dot);
#pragma unroll
          for (int off = C::LPR / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          x[u][g] = valid[u] ? dot * scale : kNegInf;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < C::U; ++u) mx = fmaxf(mx, x[u][g]);
        const float corr = exp2_approx(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] *= corr;
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          const float p = valid[u] ? exp2_approx(x[u][g] - mx) : 0.f;
          l[g] += p;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[g][j] = fmaf(p, vf[u][j], acc[g][j]);
        }
        m[g] = mx;
      }
    }

    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (lane % C::LPR == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sm_m[rg * G + g] = m[g];
        sm_l[rg * G + g] = l[g];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        sm_acc[(rg * G + g) * D + d0 + j] = acc[g][j];
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

    // Merge the CTA's carries into this split's partial.
    for (int e = threadIdx.x; e < G * D; e += kConsumers) {
      const int g = e / D;
      const int d = e % D;
      float M = kNegInf;
#pragma unroll
      for (int r = 0; r < C::NG; ++r) M = fmaxf(M, sm_m[r * G + g]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int r = 0; r < C::NG; ++r) {
        // Carries that saw no row hold kNegInf; M is finite (row `start`
        // is valid), so their weight underflows to exactly 0.
        const float w = exp2_approx(sm_m[r * G + g] - M);
        L = fmaf(sm_l[r * G + g], w, L);
        A = fmaf(sm_acc[(r * G + g) * D + d], w, A);
      }
      part[2 * G + e] = A;
      if (d == 0) {
        part[2 * g] = M;
        part[2 * g + 1] = L;
      }
    }
  }

  // --------------------------------------------------- the cluster's merge
  sm90::cluster_sync();  // every split's partial is written
  const uint32_t part_addr = sm90::smem_u32(part);
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + (size_t)kh * G) * D;
  for (int e = sp * kThreads + threadIdx.x; e < G * D;
       e += a.n_split * kThreads) {
    const int g = e / D;
    float M = kNegInf;
    for (int s = 0; s < ns; ++s)
      M = fmaxf(M, sm90::ld_cluster(sm90::map_rank(part_addr + 8 * g, s)));
    float L = 0.f, A = 0.f;
    for (int s = 0; s < ns; ++s) {
      const uint32_t base = sm90::map_rank(part_addr, s);
      const float w = exp2_approx(sm90::ld_cluster(base + 8 * g) - M);
      L = fmaf(sm90::ld_cluster(base + 8 * g + 4), w, L);
      A = fmaf(sm90::ld_cluster(base + 4 * (2 * G + e)), w, A);
    }
    out[e] = rtt::from_f32<T>(ns > 0 ? A / fmaxf(L, 1e-30f) : 0.f);
  }
  sm90::cluster_sync();  // no CTA leaves while another reads its partial
}

// Launches the kernel; with `clusters` set, only stores how many clusters
// of this launch can be resident at once.
template <typename T, int D, int G, bool kPaged>
int launch(const Args& a, cudaStream_t stream, int* clusters) {
  using C = Cfg<T, D, G>;
  const auto kern = decode_kernel<T, D, G, kPaged>;
  const int pages = kPaged ? (a.split_rows + a.page - 1) / a.page : 0;
  const size_t smem = C::bytes(pages);
  // Each card's attributes are set again only for a larger launch: setting
  // them is host time on every decode step otherwise. (Two threads racing
  // here both set them.)
  static size_t attr_bytes[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (smem > attr_bytes[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)  // two CTAs an SM need more than the default
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes[dev] = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.KH, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kPaged>
int dispatch_g(int G, const Args& a, cudaStream_t stream, int* clusters) {
  switch (G) {
    case 1:
      return launch<T, D, 1, kPaged>(a, stream, clusters);
    case 2:
      return launch<T, D, 2, kPaged>(a, stream, clusters);
    case 4:
      return launch<T, D, 4, kPaged>(a, stream, clusters);
    case 8:
      return launch<T, D, 8, kPaged>(a, stream, clusters);
  }
  return -1;
}

template <bool kPaged>
int dispatch(int dtype, int D, const Args& a, cudaStream_t stream,
             int* clusters = nullptr) {
  if (a.KH <= 0 || a.H % a.KH != 0 || a.n_split < 1 || a.n_split > 8 ||
      a.granule <= 0 || a.split_rows % a.granule != 0 ||
      (long long)a.split_rows * a.n_split < a.S_log)
    return -1;
  const int G = a.H / a.KH;
  if (dtype == rtt::kF32) {
    if (D == 64) return dispatch_g<float, 64, kPaged>(G, a, stream, clusters);
    if (D == 128)
      return dispatch_g<float, 128, kPaged>(G, a, stream, clusters);
  } else if (dtype == rtt::kBF16) {
    if (D == 64)
      return dispatch_g<__nv_bfloat16, 64, kPaged>(G, a, stream, clusters);
    if (D == 128)
      return dispatch_g<__nv_bfloat16, 128, kPaged>(G, a, stream, clusters);
  }
  return -1;
}

}  // namespace

// q [B,H,D]; k, v [B,KH,S,D] contiguous, storage dtype `dtype`; lengths
// [B] int32; out [B,H,D]. The split plan (ops/decode_attention.split_plan):
// n_split CTAs a (slot, KV head), at most split_rows rows each, a slot's
// split a multiple of `granule` rows. Returns -1 for an unsupported
// (dtype, D, G) or plan, else the CUDA error of the launch (0 on success).
extern "C" int rtt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int H, int KH, int S,
                                    int D, int split_rows, int n_split,
                                    int granule, float scale, int dtype,
                                    void* stream) {
  const Args a{q,  k,  v, static_cast<const int*>(lengths), nullptr, out,
               B,  H,  KH, S, S, 0, S, 1, split_rows, n_split, granule,
               scale};
  return dispatch<false>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// The paged read: k, v [Bp,KH,S,D] page pools (S a multiple of `page`),
// block_table [B,NP] int32 flat page ids, the rest as above; split_rows
// and granule must be multiples of `page`.
extern "C" int rtt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* block_table,
    const void* lengths, void* out, int B, int H, int KH, int S, int D,
    int NP, int page, int split_rows, int n_split, int granule, float scale,
    int dtype, void* stream) {
  if (page <= 0 || S % page != 0 || granule % page != 0) return -1;
  const Args a{q,  k,  v, static_cast<const int*>(lengths),
               static_cast<const int*>(block_table), out,
               B,  H,  KH, S, NP * page, NP, page, S / page, split_rows,
               n_split, granule, scale};
  return dispatch<true>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a CTA of the contiguous kernel asks for at
// (dtype, D, G) (-1 for another), for reports beside ptxas' registers; the
// paged kernel adds 4 bytes a page of its split.
extern "C" int rtt_decode_attention_smem(int dtype, int D, int G) {
  auto pick = [&](auto t, auto d) -> int {
    using T = decltype(t);
    constexpr int kD = decltype(d)::value;
    switch (G) {
      case 1: return (int)Cfg<T, kD, 1>::bytes(0);
      case 2: return (int)Cfg<T, kD, 2>::bytes(0);
      case 4: return (int)Cfg<T, kD, 4>::bytes(0);
      case 8: return (int)Cfg<T, kD, 8>::bytes(0);
    }
    return -1;
  };
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == rtt::kF32 && D == 64) return pick(0.f, D64{});
  if (dtype == rtt::kF32 && D == 128) return pick(0.f, D128{});
  if (dtype == rtt::kBF16 && D == 64) return pick(__nv_bfloat16{}, D64{});
  if (dtype == rtt::kBF16 && D == 128) return pick(__nv_bfloat16{}, D128{});
  return -1;
}

// How many clusters of the contiguous kernel's launch at these shapes and
// plan can be resident on the card at once (a grid of B * KH clusters
// more than this runs in waves); negative on an unsupported shape, a CUDA
// error code otherwise.
extern "C" int rtt_decode_attention_clusters(int B, int H, int KH, int S,
                                             int D, int split_rows,
                                             int n_split, int granule,
                                             int dtype) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               B, H, KH, S, S, 0, S, 1, split_rows, n_split, granule, 1.f};
  int clusters = 0;
  const int rc = dispatch<false>(dtype, D, a, nullptr, &clusters);
  return rc != 0 ? -abs(rc) : clusters;
}
