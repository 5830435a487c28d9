// Backward of the fused additive attention with coverage, per-row form.
//
// Replaces the backward of textsummarization_on_flink_tpu/ops/
// pallas_attention.py's custom_vjp: `_bwd` (:360), which recomputes the
// reference formula `_attention_xla` and differentiates it with jax.vjp
// (not a Pallas kernel).  Per article b, one query row (K = 1), with
// u[t] = tanh(ef[t] + df (+ cov[t] * w_c)) recomputed and attn the
// forward's output:
//
//   d_es[t]  = attn[t] g_ctx
//   ga[t]    = g_attn[t] + es[t] . g_ctx
//   d_e[t]   = attn[t] (ga[t] - sum_s attn[s] ga[s])      (0 where masked)
//   d_f[t]   = d_e[t] v (1 - u[t]^2)
//   d_ef[t]  = d_f[t];  d_df = sum_t d_f[t];  d_cov[t] = d_f[t] . w_c
//   d_v      = sum_{b,t} d_e[t] u[t];  d_w_c = sum_{b,t} d_f[t] cov[t]
//
// A masked position has attn 0, so d_e is 0 there; a fully masked
// article (attn all 0) gets zero gradients, with no division: the
// forward's clamp of the denominator is not differentiated through.
//
// The encoder stream (es, ef, and so d_es, d_ef) is float32 or bfloat16,
// as in the forward.  In bf16 the rows are widened to f32 as they are
// read from the ring (a bf16 is the top half of an f32: exact), all the
// arithmetic is f32 as above, and d_es and d_ef are rounded once to bf16
// (round to nearest even) as they are stored: jax.vjp of the reference
// formula with bf16 es and ef promotes them to f32 (feats = ef + df, df
// f32) and casts the two cotangents back to bf16.  d_df, d_cov, d_v and
// d_w_c stay f32 sums of the unrounded d_f.  A chunk of bf16 rows is
// half the bytes, so the ring holds twice the chunks; the TMA copies
// need 16-byte rows, so D is a multiple of 8 in bf16 (of 4 in f32).
//
// What bounds it on an H100: memory.  es and ef are read once and d_es
// and d_ef written once, 4 * B*T*D*4 bytes: at the training shape (16
// articles, T=400, D=512, f32) 52.4 MB, 15.6 us at 3.35 TB/s.  The
// B*T*D = 3.3 M accurate tanhf cost ~44 SASS instructions an element
// with the rest of the row's work, ~4 us of issue over the card.  The
// design keeps bytes in flight on every SM and puts the work where the
// memory is idle:
//
//   * one thread block cluster per article: 8 blocks (the portable size),
//     or 16 when the articles are few enough that their clusters take at
//     most half the SMs; block r owns a contiguous range of positions,
//     so its rows are contiguous in memory;
//   * each block streams its es rows (pass one), then its ef rows (pass
//     two), through a ring of chunks of 8 rows in shared memory, each
//     chunk one TMA bulk copy (cp.async.bulk on an mbarrier) issued by
//     one thread: 6 chunks of 16 KB at D 512 (96 KB), so ~80 KB are in
//     flight per SM from the start (Little's law asks ~20 KB per SM for
//     3.35 TB/s at ~0.8 us) and the first ef chunks land while the
//     cluster adds up pass one.  96 KB lets two blocks share an SM: 16
//     clusters of 8 blocks do not all fit on the H100's GPCs at one block
//     per SM, and a second wave doubled the time (PERF.md);
//   * the rows' scalars (attn, g_attn; then attn, ga, mask, cov) come 4
//     chunks ahead by cp.async into a small ring of their own, so no warp
//     waits on a scalar load in a row's chain;
//   * pass one: warp w takes row w of a chunk, forms ga = g_attn + es .
//     g_ctx (g_ctx in shared memory), keeps it in the d_cov output (pass
//     two overwrites it) and adds attn * ga to its share of the article's
//     sum S.  It reads es and the prefetched ef at the memory's rate;
//   * the cluster adds the blocks' shares in rank order (distributed
//     shared memory): S;
//   * pass two: a thread owns fixed float4 groups of columns (column group
//     k of rows l, l + kL, ... of each chunk: at D 512 two lanes of rows,
//     128 threads each) and takes its rows 4 at a time with no branch
//     between them, so their tanh chains overlap.  df, v, w_c and g_ctx of
//     its columns and its d_df, d_v and d_w_c sums stay in registers
//     across all its rows: the sums touch shared memory once, at the end.
//     It writes the rows of d_ef and of d_es (attn g_ctx needs no S, but
//     pass one is at the memory's rate already and pass two's tanh leaves
//     it idle: writing d_es here measured 1-3 us faster).  kG, the groups
//     a thread owns (1 up to D 1024, then 2, 3), and kL, the lanes of
//     rows, are the template's counts: every D the wrapper takes runs this
//     one kernel, with idle threads where D/4 does not fill a lane.
//     d_cov[t] is a warp sum per row, added over the row's warps in order;
//   * at the end the block adds its lanes of rows in order, the cluster
//     its blocks in rank order (d_df per article, per-article partials of
//     d_v and d_w_c in `part`), and the last cluster to finish adds the
//     partials over the articles in order.  It learns that it is last
//     from an unsigned ticket in `part` (atomicAdd between __threadfence
//     calls; an integer atomic changes no float bits) and sets it back to
//     0: one launch.
//
// Nothing is kept per position in shared memory, so every T is taken.  No
// float atomics: every sum has a fixed order, and two launches on the
// same inputs give the same bits.  Accurate tanhf (the energies' tanh is
// recomputed, not read back).  ops/fused_attention.py mirrors the sizes
// below in its choice of form (_bwd_form).
//
// The slab form (attention_bwd_slab_kernel) takes every D whose rows do
// not fit the dense form's ring of kMinStages chunks, or whose column
// groups pass kMaxGroups a thread, and only those: a D the dense form
// took runs it as before, with the same bits.  Both passes loop over
// slabs of kSlab columns.  Pass one adds each slab's es . g_ctx into ga,
// kept in d_cov; S follows the last slab.  Pass two recomputes u from
// each ef slab: d_f, d_ef and d_es of the slab's columns, the slab's
// column sums (d_df, d_v, d_w_c) in registers, merged over the cluster
// into their columns after the slab, and d_cov's row sums added over the
// slabs in `part` (past the partials) until the last slab writes d_cov.
// The bytes are the dense form's: es and ef read once, d_es and d_ef
// written once.
//
// The sp-block form (s_ext not null): the rows are one sequence-parallel
// rank's block of T, attn is already normalised over every rank's
// block, and the softmax correction S = sum_s attn[s] ga[s] over the
// whole row comes from outside (s_ext [B]: the ranks' sums of attn .
// g_attn, all-reduced, plus g_ctx . ctx; ops/fused_attention.py), so the
// block's own share is not used.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry point bound with
// ctypes from ops/fused_attention.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"  // cp.async and allow_smem
#include "tma_ring.cuh"    // the ring's mbarriers and bulk copies

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // rows per ring stage: one per warp in pass one
constexpr int kCluster = 8;  // blocks per article (the portable size)
constexpr int kWideCluster = 16;  // for few articles (non-portable size)
// the ring: as many chunks as fit in kRingBytes, within these bounds
constexpr int kMinStages = 3, kMaxStages = 12;
constexpr size_t kRingBytes = 96 * 1024;
constexpr int kAhead = 4;  // chunks whose row scalars are in flight
constexpr int kSlots = kAhead + 1;  // the scalars' ring
constexpr int kMaxGroups = 3;  // column groups a thread owns (D <= 3072)
constexpr size_t kSmemMax = 232448;  // bytes a block may use on Hopper
// floats before the ring: its mbarriers (8 bytes each), 16-byte aligned
constexpr int kBarFloats = 2 * kMaxStages;
constexpr int kSmall = kWarps + 16;  // floats for the block's scalars
// part: the ticket (an unsigned in the first 16 bytes), then [2, B, D]
constexpr int kTicketFloats = 4;

// the slab form: columns per slab, pass two's lanes of rows at that
// width (kSlab / 4 groups for 128 threads each), and its ring's bytes
// (80 KB: with the column sums beside it two blocks share an SM)
constexpr int kSlab = 512, kSlabLanes = 2;
constexpr size_t kSlabRingBytes = 80 * 1024;

static_assert(kBarFloats % 4 == 0, "the ring is 16-byte aligned");
static_assert(kChunk * 4 == 32 && kChunk <= kWarps,
              "warp 0 loads a chunk's scalars, a warp takes a row");

// Built with -DTS_BWD_TRACE (scripts/torch_bwd_phases.py), thread 0 of
// each block records when it reaches each phase: the global timer at the
// start and at its last mark, its SM clock at the start and the clocks
// since then at marks 1-8, and its SM.  Off by default: the marks
// compile to nothing.
#ifdef TS_BWD_TRACE
constexpr int kTraceBlocks = 4096, kTraceSlots = 12;
__device__ unsigned long long g_trace[kTraceBlocks * kTraceSlots];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TS_MARK(k)                                                        \
  do {                                                                    \
    const int blk_ = blockIdx.y * gridDim.x + blockIdx.x;                 \
    if (threadIdx.x == 0 && blk_ < kTraceBlocks) {                        \
      unsigned long long* t_ = g_trace + blk_ * kTraceSlots;              \
      if ((k) == 0) {                                                     \
        unsigned sm_;                                                     \
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                  \
        t_[0] = global_ns();                                              \
        t_[2] = clock64();                                                \
        t_[11] = sm_;                                                     \
      } else {                                                            \
        t_[1] = global_ns();                                              \
        t_[(k) + 2] = clock64() - t_[2];                                  \
      }                                                                   \
    }                                                                     \
  } while (0)
#else
#define TS_MARK(k) \
  do {             \
  } while (0)
#endif

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 bf16 -> f32 (exact: a bf16 is the top half of an f32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
// f32 -> 4 bf16, each rounded to nearest even, the first at the lowest
// address
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // the same bits in every lane (a butterfly of pairwise adds)
}

// chunks in the ring at width D, rows of elt-byte elements
inline int ring_stages(int D, int elt) {
  const int fit = (int)(kRingBytes / ((size_t)kChunk * D * elt));
  return fit < kMinStages ? kMinStages : fit > kMaxStages ? kMaxStages : fit;
}

// the ring's floats: stages chunks of kChunk rows of D elt-byte elements
__host__ __device__ inline size_t ring_floats(int D, int stages, int elt) {
  return (size_t)stages * kChunk * D * elt / sizeof(float);
}

// Dynamic shared memory, in floats: the mbarriers, the ring, g_ctx [D],
// the scalars' ring [kSlots][kChunk][4], the d_cov warp sums
// [2][kChunk][kWarps] and the block's scalars.  The column sums reuse
// the ring at the end.
inline size_t smem_floats(int D, int stages, int elt) {
  return kBarFloats + ring_floats(D, stages, elt) + D + kSlots * kChunk * 4 +
         2 * kChunk * kWarps + kSmall;
}

// C blocks of P positions (a multiple of kChunk) per article, at most
// max_c, none of them empty
struct Geometry {
  int C, P;
  Geometry(int T, int max_c) {
    const int chunks = (T + kChunk - 1) / kChunk;
    const int c0 = chunks < max_c ? chunks : max_c;
    P = ((T + c0 - 1) / c0 + kChunk - 1) / kChunk * kChunk;
    C = (T + P - 1) / P;
  }
};

// grid (C, B) in clusters of (C, 1, 1); smem_floats(D, stages, elt) * 4
// bytes.  TE: the encoder stream's element (float or __nv_bfloat16).
// Pass two: kG groups of 4 columns a thread owns, in kL lanes of rows
// (kG > 1 only with kL == 1).
template <typename TE, bool kCov, int kG, int kL>
__global__ void __launch_bounds__(kThreads, kG == 1 ? 2 : 1)  // blocks per SM
attention_bwd_kernel(const TE* __restrict__ es,
                     const TE* __restrict__ ef,
                     const float* __restrict__ mask,
                     const float* __restrict__ df,
                     const float* __restrict__ cov,
                     const float* __restrict__ v,
                     const float* __restrict__ wc,
                     const float* __restrict__ attn,
                     const float* __restrict__ g_ctx,
                     const float* __restrict__ g_attn,
                     const float* __restrict__ s_ext,
                     TE* __restrict__ d_es, TE* __restrict__ d_ef,
                     float* __restrict__ d_df, float* d_cov, float* d_v,
                     float* d_wc, float* part, int B, int T, int D, int P,
                     int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = D / 4;  // groups of 4 columns of a row
  const int chunk_elems = kChunk * D;

  TS_MARK(0);
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stages]
  TE* ring = reinterpret_cast<TE*>(smem + kBarFloats);  // [stages][kChunk][D]
  float* g_s = smem + kBarFloats +
               ring_floats(D, stages, (int)sizeof(TE));  // [D] g_ctx
  float* sc_s = g_s + D;                      // [kSlots][kChunk][4]
  float* dc_s = sc_s + kSlots * kChunk * 4;   // [2][kChunk][kWarps]
  float* small = dc_s + 2 * kChunk * kWarps;
  float* wsum_s = small;           // [kWarps] each warp's sum of attn * ga
  float* bsum_s = small + kWarps;  // [1] the block's
  float* s_s = bsum_s + 1;         // [1] the article's: S
  float* last_s = s_s + 1;         // [1] 1 in the cluster that ends last

  const int t_begin = rank * P;
  const int n_pos = max(0, min(T, t_begin + P) - t_begin);
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;
  const int n_total = 2 * n_chunks;  // es chunks, then ef chunks
  const size_t row0 = (size_t)b * T + t_begin;  // the block's first row

  // chunk i of the ring's sequence: its first local position, its rows
  auto chunk_pos = [&](int i) {
    return (i < n_chunks ? i : i - n_chunks) * kChunk;
  };
  auto stage = [&](int i) {
    if (tid == 0 && i < n_total) {
      const int c0 = chunk_pos(i);
      const unsigned bytes =
          (unsigned)(min(kChunk, n_pos - c0) * D * (int)sizeof(TE));
      tma::bulk_load(ring + (i % stages) * chunk_elems,
                     (i < n_chunks ? es : ef) + (row0 + c0) * D, bytes,
                     &bars[i % stages]);
    }
  };
  // the row scalars of chunk j into its slot, by warp 0 (a lane per row
  // and field): pass one attn, g_attn; pass two attn, ga (kept in d_cov),
  // mask, cov.  Pass two's are issued only once pass one has written ga.
  bool ga_written = false;
  auto load_scalars = [&](int j) {
    if (warp != 0 || j >= n_total || (j >= n_chunks && !ga_written)) return;
    const bool one = j < n_chunks;
    const int r = lane >> 2, f = lane & 3;
    const int tl = chunk_pos(j) + r;
    if (tl >= n_pos || (one && f >= 2) || (!kCov && f == 3)) return;
    const size_t i = row0 + tl;
    const float* src = f == 0 ? attn + i
                       : one  ? g_attn + i
                       : f == 1 ? d_cov + i
                       : f == 2 ? mask + i
                                : cov + i;
    tf32x3::cp_async4(sc_s + ((j % kSlots) * kChunk + r) * 4 + f, src);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) tma::mbar_init(&bars[s]);
    tma::mbar_fence_init();
  }
  // g_ctx with chunk 0's scalars: the first cp.async group; then one
  // group per chunk, in the ring's order (empty where nothing is issued)
  for (int c = tid; c < n4; c += kThreads)
    tf32x3::cp_async16(g_s + 4 * c, g_ctx + (size_t)b * D + 4 * c, 16);
  for (int j = 0; j < kAhead; ++j) {
    load_scalars(j);
    tf32x3::cp_async_commit();
  }
  __syncthreads();  // the mbarriers are initialised
  for (int i = 0; i < stages - 1; ++i) stage(i);

  // pass two's columns: kL lanes of rows of W threads each; thread k of
  // lane l takes rows l, l + kL, ... of a chunk and column groups
  // k + W * g (those past D / 4 idle)
  constexpr int W = kThreads / kL;
  const int l = tid / W, k = tid % W, wl = k / 32;  // wl: warp in the lane
  float4 dfr[kG], vr[kG], wr[kG], gr[kG];  // df, v, w_c, g_ctx columns
  float4 s_df[kG], s_v[kG], s_wc[kG];  // its sums of d_f, d_e u, d_f cov
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int c = k + W * g;
    const bool ok = c < n4;
    dfr[g] = ok ? load4(df + (size_t)b * D + 4 * c) : zero4;
    vr[g] = ok ? load4(v + 4 * c) : zero4;
    wr[g] = ok ? load4(wc + 4 * c) : zero4;
    gr[g] = ok ? load4(g_ctx + (size_t)b * D + 4 * c) : zero4;
    s_df[g] = s_v[g] = s_wc[g] = zero4;
  }

  // the top of chunk i: it and its scalars have landed for every thread,
  // and every thread is done with chunk i - 1, whose stage and scalar
  // slot are refilled
  auto next_chunk = [&](int i) {
    tma::mbar_wait(&bars[i % stages], (unsigned)(i / stages) & 1u);
    tf32x3::cp_async_wait<kAhead - 1>();
    __syncthreads();
    stage(i + stages - 1);
    load_scalars(i + kAhead);
    tf32x3::cp_async_commit();
  };
  // d_cov of pass-two chunk i: its rows' warp sums, in order
  auto finish_cov = [&](int i) {
    const int c0 = chunk_pos(i);
    if (tid < min(kChunk, n_pos - c0)) {
      float s = 0.f;
      if (kCov) {
        const float* dc = dc_s + ((i & 1) * kChunk + tid) * kWarps;
        for (int q = 0; q < W / 32; ++q) s += dc[q];
      }
      d_cov[row0 + c0 + tid] = s;
    }
  };

  // pass one: ga (kept in d_cov) and the block's share of S
  float wpart = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    next_chunk(i);
    if (i == 0) TS_MARK(1);
    const int tl = chunk_pos(i) + warp;  // warp-uniform
    if (warp < kChunk && tl < n_pos) {
      const TE* row = ring + (i % stages) * chunk_elems + warp * D;
      float dot = 0.f;
#pragma unroll 4
      for (int c = lane; c < n4; c += 32) {
        const float4 x = load4(row + 4 * c);
        const float4 g = load4(g_s + 4 * c);
        dot = fmaf(x.x, g.x, dot);
        dot = fmaf(x.y, g.y, dot);
        dot = fmaf(x.z, g.z, dot);
        dot = fmaf(x.w, g.w, dot);
      }
      const float* sc = sc_s + ((i % kSlots) * kChunk + warp) * 4;
      const float a = sc[0];
      const float ga = sc[1] + warp_sum(dot);
      wpart = fmaf(a, ga, wpart);
      if (lane == 0) d_cov[row0 + tl] = ga;
    }
  }

  TS_MARK(2);
  // S: the block's warps in order, then the cluster's blocks in rank
  // order; pass two's first scalars fly meanwhile
  if (lane == 0) wsum_s[warp] = wpart;
  __syncthreads();  // every ga of the block is in d_cov
  ga_written = true;
  for (int j = n_chunks; j < min(n_total, n_chunks + kAhead); ++j)
    load_scalars(j);
  tf32x3::cp_async_commit();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum_s[w];
    bsum_s[0] = s;
  }
  cluster.sync();  // every block's share is in its shared memory
  TS_MARK(8);
  if (warp == 0) {  // lane r reads rank r's; lane 0 adds them in order
    const float x = lane < C ? cluster.map_shared_rank(bsum_s, lane)[0] : 0.f;
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += __shfl_sync(0xffffffffu, x, r);
    if (lane == 0) s_s[0] = s;
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  const float S = s_ext != nullptr ? s_ext[b] : s_s[0];
  TS_MARK(3);

  // pass two: the rows of d_ef, d_cov's warp sums, the column sums.  A
  // thread takes kRows rows of each chunk, kBatch at a time, with no
  // branch between them (a row past the chunk computes on zeros and
  // stores nothing), so their tanh chains and loads overlap; d_cov's warp
  // sums come after the batch, interleaved.
  constexpr int kRows = kChunk / kL;
  constexpr int kBatch = kG == 1 ? (kRows < 4 ? kRows : 4) : kG == 2 ? 2 : 1;
  for (int i = n_chunks; i < n_total; ++i) {
    next_chunk(i);
    if (i > n_chunks) finish_cov(i - 1);
    const int c0 = chunk_pos(i);
    const int n_here = min(kChunk, n_pos - c0);
    const TE* buf = ring + (i % stages) * chunk_elems;
    float* dc = dc_s + (i & 1) * kChunk * kWarps;
#pragma unroll
    for (int q0 = 0; q0 < kRows; q0 += kBatch) {
      float dcv[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int r = l + (q0 + q) * kL;
        const bool valid = r < n_here;
        const float* sc = sc_s + ((i % kSlots) * kChunk + r) * 4;
        const float a = sc[0];
        const float de = valid && sc[2] > 0.f ? a * (sc[1] - S) : 0.f;
        const float cv = kCov && valid ? sc[3] : 0.f;
        const TE* row = buf + r * D;
        TE* out = d_ef + (row0 + c0 + r) * D;
        TE* out_es = d_es + (row0 + c0 + r) * D;
        float dcov = 0.f;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int c = k + W * g;
          const bool ok = valid && c < n4;
          const float4 x = ok ? load4(row + 4 * c) : zero4;
          const float xs[4] = {x.x, x.y, x.z, x.w};
          const float ds[4] = {dfr[g].x, dfr[g].y, dfr[g].z, dfr[g].w};
          const float vs[4] = {vr[g].x, vr[g].y, vr[g].z, vr[g].w};
          const float ws[4] = {wr[g].x, wr[g].y, wr[g].z, wr[g].w};
          float f_[4], u_[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float f = xs[j] + ds[j];
            if (kCov) f = fmaf(cv, ws[j], f);
            const float u = tanhf(f);
            u_[j] = u;
            f_[j] = de * vs[j] * fmaf(-u, u, 1.f);
            if (kCov) dcov = fmaf(f_[j], ws[j], dcov);
          }
          if (ok) store4(out + 4 * c, make_float4(f_[0], f_[1], f_[2], f_[3]));
          if (ok)
            store4(out_es + 4 * c, make_float4(a * gr[g].x, a * gr[g].y,
                                               a * gr[g].z, a * gr[g].w));
          s_df[g] = make_float4(s_df[g].x + f_[0], s_df[g].y + f_[1],
                                s_df[g].z + f_[2], s_df[g].w + f_[3]);
          s_v[g] = make_float4(fmaf(de, u_[0], s_v[g].x),
                               fmaf(de, u_[1], s_v[g].y),
                               fmaf(de, u_[2], s_v[g].z),
                               fmaf(de, u_[3], s_v[g].w));
          if (kCov)
            s_wc[g] = make_float4(fmaf(f_[0], cv, s_wc[g].x),
                                  fmaf(f_[1], cv, s_wc[g].y),
                                  fmaf(f_[2], cv, s_wc[g].z),
                                  fmaf(f_[3], cv, s_wc[g].w));
        }
        dcv[q] = dcov;
      }
      if (kCov) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q) dcv[q] = warp_sum(dcv[q]);
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int r = l + (q0 + q) * kL;
          if (lane == 0 && r < n_here) dc[r * kWarps + wl] = dcv[q];
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the ring
  if (n_chunks > 0) finish_cov(n_total - 1);
  TS_MARK(4);

  // the block's column sums [3][D]: each lane of rows' sums, then the
  // lanes added in order, in the ring's memory (kL * 3 * D floats fit:
  // launch() checks)
  float* acc = smem + kBarFloats;  // [kL][3][D]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int c = k + W * g;
    if (c < n4) {
      float* dst = acc + (size_t)l * 3 * D + 4 * c;
      *reinterpret_cast<float4*>(dst) = s_df[g];
      *reinterpret_cast<float4*>(dst + D) = s_v[g];
      *reinterpret_cast<float4*>(dst + 2 * D) = s_wc[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * D; i += kThreads) {
    float s = acc[i];
    for (int q = 1; q < kL; ++q) s += acc[q * 3 * D + i];
    acc[i] = s;
  }
  cluster.sync();
  // the article's: block r adds a slice of the columns over the ranks in
  // order; d_df, and the article's partials of d_v and d_w_c
  float* part_v = part + kTicketFloats;
  float* part_wc = part_v + (size_t)B * D;
  const int per = (D + C - 1) / C;
  const int lo = rank * per, hi = min(D, lo + per);
  for (int d = lo + tid; d < hi; d += kThreads) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int q0 = 0; q0 < C; q0 += 8) {  // 8 ranks' loads at once
      float x[3][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* src = cluster.map_shared_rank(acc, min(q0 + j, C - 1));
        x[0][j] = src[d];
        x[1][j] = src[D + d];
        x[2][j] = src[2 * D + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (q0 + j < C) {
          s0 += x[0][j];
          s1 += x[1][j];
          s2 += x[2][j];
        }
      }
    }
    d_df[(size_t)b * D + d] = s0;
    part_v[(size_t)b * D + d] = s1;
    part_wc[(size_t)b * D + d] = s2;
  }
  // the partials are written before the ticket: the cluster barrier
  // orders them before thread 0's fence and atomic below (and the last
  // cluster's reads after its own), with no fence in every thread
  cluster.sync();   // no block reads another's shared memory after this
  TS_MARK(5);
  if (rank == 0 && tid == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(part);
    __threadfence();
    const bool last = atomicAdd(ticket, 1u) == (unsigned)(B - 1);
    __threadfence();
    if (last) atomicExch(ticket, 0u);  // every cluster has taken its ticket
    for (int q = 0; q < C; ++q)
      cluster.map_shared_rank(last_s, q)[0] = last ? 1.f : 0.f;
  }
  cluster.sync();
  TS_MARK(6);
  if (last_s[0] == 0.f) return;
  // the last cluster: d_v and d_w_c, the partials added over the articles
  // in order (read past L1: other SMs wrote them), 8 articles' loads at
  // once
  for (int d = lo + tid; d < hi; d += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int a0 = 0; a0 < B; a0 += 8) {
      float x1[8], x2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = (size_t)min(a0 + j, B - 1) * D + d;
        x1[j] = __ldcg(part_v + at);
        x2[j] = __ldcg(part_wc + at);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (a0 + j < B) {
          s1 += x1[j];
          s2 += x2[j];
        }
      }
    }
    d_v[d] = s1;
    d_wc[d] = kCov ? s2 : 0.f;
  }
  TS_MARK(7);
}

// the slab form's ring: as many chunks of kChunk rows of kSlab columns
// as fit in kSlabRingBytes, within the dense form's bounds
inline int slab_stages(int elt) {
  const int fit = (int)(kSlabRingBytes / ((size_t)kChunk * kSlab * elt));
  return fit < kMinStages ? kMinStages : fit > kMaxStages ? kMaxStages : fit;
}

// Dynamic shared memory of the slab form, in floats: the mbarriers, the
// ring, a slab of g_ctx [kSlab], the d_cov warp sums [2][kChunk][kWarps],
// the slab's column sums [kSlabLanes][3][kSlab] and the block's scalars.
inline size_t slab_smem_floats(int stages, int elt) {
  return kBarFloats + ring_floats(kSlab, stages, elt) + kSlab +
         2 * kChunk * kWarps + (size_t)kSlabLanes * 3 * kSlab + kSmall;
}

// The slab form: grid and clusters as the dense kernel's, D in slabs of
// kSlab columns (see the header).  The ring's sequence: es chunks of
// slab 0, of slab 1, ..., then ef chunks slab by slab.  part: the
// ticket, the partials [2, B, D], then d_cov's running sums [B, T].
template <typename TE, bool kCov>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_slab_kernel(const TE* __restrict__ es,
                          const TE* __restrict__ ef,
                          const float* __restrict__ mask,
                          const float* __restrict__ df,
                          const float* __restrict__ cov,
                          const float* __restrict__ v,
                          const float* __restrict__ wc,
                          const float* __restrict__ attn,
                          const float* __restrict__ g_ctx,
                          const float* __restrict__ g_attn,
                          const float* __restrict__ s_ext,
                          TE* __restrict__ d_es, TE* __restrict__ d_ef,
                          float* __restrict__ d_df, float* d_cov,
                          float* d_v, float* d_wc, float* part, int B, int T,
                          int D, int P, int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nS = (D + kSlab - 1) / kSlab;
  const int chunk_elems = kChunk * kSlab;
  constexpr int kL = kSlabLanes;
  constexpr int W = kThreads / kL;     // threads of a lane of rows
  constexpr int kRows = kChunk / kL;   // rows a thread takes per chunk

  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stages]
  TE* ring = reinterpret_cast<TE*>(smem + kBarFloats);  // [stages][8][kSlab]
  float* g_s = smem + kBarFloats +
               ring_floats(kSlab, stages, (int)sizeof(TE));  // [kSlab]
  float* dc_s = g_s + kSlab;                  // [2][kChunk][kWarps]
  float* col_s = dc_s + 2 * kChunk * kWarps;  // [kL][3][kSlab]
  float* small = col_s + kL * 3 * kSlab;
  float* wsum_s = small;           // [kWarps] each warp's sum of attn * ga
  float* bsum_s = small + kWarps;  // [1] the block's
  float* s_s = bsum_s + 1;         // [1] the article's: S
  float* last_s = s_s + 1;         // [1] 1 in the cluster that ends last

  const int t_begin = rank * P;
  const int n_pos = max(0, min(T, t_begin + P) - t_begin);
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;
  const int per_pass = nS * n_chunks;
  const int n_total = 2 * per_pass;  // es chunks, then ef chunks
  const size_t row0 = (size_t)b * T + t_begin;  // the block's first row
  float* part_v = part + kTicketFloats;
  float* part_wc = part_v + (size_t)B * D;
  float* cov_acc = part_wc + (size_t)B * D;  // [B, T]
  auto width = [&](int s) { return min(kSlab, D - s * kSlab); };

  // chunk i: its rows' slab, one bulk copy per row, the stage's mbarrier
  // armed once with the chunk's bytes
  auto stage = [&](int i) {
    if (tid == 0 && i < n_total) {
      const bool one = i < per_pass;
      const int q = one ? i : i - per_pass;
      const int s = q / n_chunks, c0 = (q % n_chunks) * kChunk;
      const int rows = min(kChunk, n_pos - c0);
      const unsigned row_bytes = (unsigned)(width(s) * (int)sizeof(TE));
      TE* dst = ring + (i % stages) * chunk_elems;
      const TE* src = (one ? es : ef) + (row0 + c0) * D + (size_t)s * kSlab;
      tma::mbar_arrive_tx(&bars[i % stages], rows * row_bytes);
      for (int r = 0; r < rows; ++r)
        tma::bulk_copy(dst + r * kSlab, src + (size_t)r * D, row_bytes,
                       &bars[i % stages]);
    }
  };
  if (tid == 0) {
    for (int q = 0; q < stages; ++q) tma::mbar_init(&bars[q]);
    tma::mbar_fence_init();
  }
  __syncthreads();  // the mbarriers are initialised
  for (int i = 0; i < stages - 1; ++i) stage(i);
  // the top of chunk i: it has landed for every thread, and every thread
  // is done with chunk i - 1, whose stage is refilled
  auto next_chunk = [&](int i) {
    tma::mbar_wait(&bars[i % stages], (unsigned)(i / stages) & 1u);
    __syncthreads();
    stage(i + stages - 1);
  };

  // pass one: ga = g_attn + es . g_ctx, summed over the slabs in d_cov by
  // the lane that owns the row; the block's share of S after the last
  float wpart = 0.f;
  int i = 0;  // the ring's chunk
  for (int s = 0; s < nS; ++s) {
    const int w4 = width(s) / 4;
    __syncthreads();  // every warp is done with the last slab's g_ctx
    for (int c = tid; c < w4; c += kThreads)
      *reinterpret_cast<float4*>(g_s + 4 * c) =
          load4(g_ctx + (size_t)b * D + (size_t)s * kSlab + 4 * c);
    for (int j = 0; j < n_chunks; ++j, ++i) {
      next_chunk(i);
      const int tl = j * kChunk + warp;  // warp-uniform
      if (warp >= kChunk || tl >= n_pos) continue;
      const size_t r = row0 + tl;
      const float prev = lane == 0 ? (s == 0 ? g_attn[r] : d_cov[r]) : 0.f;
      const TE* row = ring + (i % stages) * chunk_elems + warp * kSlab;
      float dot = 0.f;
#pragma unroll 4
      for (int c = lane; c < w4; c += 32) {
        const float4 x = load4(row + 4 * c);
        const float4 g = load4(g_s + 4 * c);
        dot = fmaf(x.x, g.x, dot);
        dot = fmaf(x.y, g.y, dot);
        dot = fmaf(x.z, g.z, dot);
        dot = fmaf(x.w, g.w, dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) {
        const float ga = prev + dot;
        d_cov[r] = ga;
        if (s == nS - 1) wpart = fmaf(attn[r], ga, wpart);
      }
    }
  }

  // S: the block's warps in order, then the cluster's blocks in rank
  // order (as the dense form); the sp-block form's from outside
  if (lane == 0) wsum_s[warp] = wpart;
  __syncthreads();  // every ga of the block is in d_cov
  if (tid == 0) {
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w) x += wsum_s[w];
    bsum_s[0] = x;
  }
  cluster.sync();
  if (warp == 0) {
    const float x = lane < C ? cluster.map_shared_rank(bsum_s, lane)[0] : 0.f;
    float acc = 0.f;
    for (int q = 0; q < C; ++q) acc += __shfl_sync(0xffffffffu, x, q);
    if (lane == 0) s_s[0] = acc;
  }
  __syncthreads();
  const float S = s_ext != nullptr ? s_ext[b] : s_s[0];

  // d_cov of pass-two chunk j of slab s: its rows' warp sums in order,
  // added to the earlier slabs' (d_cov itself holds ga until the last)
  const int l = tid / W, k = tid % W, wl = k / 32;
  auto finish_cov = [&](int s, int j) {
    const int c0 = j * kChunk;
    if (tid < min(kChunk, n_pos - c0)) {
      float x = 0.f;
      if (kCov) {
        const float* dc = dc_s + ((j & 1) * kChunk + tid) * kWarps;
        for (int q = 0; q < W / 32; ++q) x += dc[q];
      }
      const size_t r = row0 + c0 + tid;
      const float before = s == 0 ? 0.f : cov_acc[r];
      if (s == nS - 1) {
        d_cov[r] = before + x;
      } else {
        cov_acc[r] = before + x;
      }
    }
  };

  // pass two, slab by slab: thread k of lane l owns column group k of
  // the slab and takes rows l, l + kL, ... of each chunk
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nS; ++s) {
    const int n4 = width(s) / 4;
    const size_t col0 = (size_t)s * kSlab;
    const bool own = k < n4;
    const float4 dfr = own ? load4(df + (size_t)b * D + col0 + 4 * k) : zero4;
    const float4 vr = own ? load4(v + col0 + 4 * k) : zero4;
    const float4 wr = own ? load4(wc + col0 + 4 * k) : zero4;
    const float4 gr = own ? load4(g_ctx + (size_t)b * D + col0 + 4 * k)
                          : zero4;
    float4 s_df = zero4, s_v = zero4, s_wc = zero4;
    for (int j = 0; j < n_chunks; ++j, ++i) {
      next_chunk(i);
      if (j > 0) finish_cov(s, j - 1);
      const int c0 = j * kChunk;
      const int n_here = min(kChunk, n_pos - c0);
      const TE* buf = ring + (i % stages) * chunk_elems;
      float* dc = dc_s + (j & 1) * kChunk * kWarps;
      float dcv[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = l + q * kL;
        const bool valid = r < n_here;
        const size_t at = row0 + c0 + (valid ? r : 0);
        const float a = valid ? attn[at] : 0.f;
        const float ga = valid ? d_cov[at] : 0.f;
        const float de = valid && mask[at] > 0.f ? a * (ga - S) : 0.f;
        const float cv = kCov && valid ? cov[at] : 0.f;
        const bool ok = valid && own;
        const float4 x = ok ? load4(buf + r * kSlab + 4 * k) : zero4;
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ds[4] = {dfr.x, dfr.y, dfr.z, dfr.w};
        const float vs[4] = {vr.x, vr.y, vr.z, vr.w};
        const float ws[4] = {wr.x, wr.y, wr.z, wr.w};
        float f_[4], u_[4];
        float dcov = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f = xs[e] + ds[e];
          if (kCov) f = fmaf(cv, ws[e], f);
          const float u = tanhf(f);
          u_[e] = u;
          f_[e] = de * vs[e] * fmaf(-u, u, 1.f);
          if (kCov) dcov = fmaf(f_[e], ws[e], dcov);
        }
        if (ok) {
          const size_t out = (row0 + c0 + r) * D + col0 + 4 * k;
          store4(d_ef + out, make_float4(f_[0], f_[1], f_[2], f_[3]));
          store4(d_es + out,
                 make_float4(a * gr.x, a * gr.y, a * gr.z, a * gr.w));
        }
        s_df = make_float4(s_df.x + f_[0], s_df.y + f_[1], s_df.z + f_[2],
                           s_df.w + f_[3]);
        s_v = make_float4(fmaf(de, u_[0], s_v.x), fmaf(de, u_[1], s_v.y),
                          fmaf(de, u_[2], s_v.z), fmaf(de, u_[3], s_v.w));
        if (kCov)
          s_wc = make_float4(fmaf(f_[0], cv, s_wc.x), fmaf(f_[1], cv, s_wc.y),
                             fmaf(f_[2], cv, s_wc.z), fmaf(f_[3], cv, s_wc.w));
        dcv[q] = dcov;
      }
      if (kCov) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) dcv[q] = warp_sum(dcv[q]);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = l + q * kL;
          if (lane == 0 && r < n_here) dc[r * kWarps + wl] = dcv[q];
        }
      }
    }
    __syncthreads();  // every thread is done with the slab's chunks
    if (n_chunks > 0) finish_cov(s, n_chunks - 1);
    // the slab's column sums: each lane of rows', the lanes added in
    // order, then the cluster's blocks in rank order into d_df and the
    // article's partials of d_v and d_w_c
    if (own) {
      float* dst = col_s + (size_t)l * 3 * kSlab + 4 * k;
      *reinterpret_cast<float4*>(dst) = s_df;
      *reinterpret_cast<float4*>(dst + kSlab) = s_v;
      *reinterpret_cast<float4*>(dst + 2 * kSlab) = s_wc;
    }
    __syncthreads();
    for (int idx = tid; idx < 3 * kSlab; idx += kThreads) {
      float x = col_s[idx];
      for (int q = 1; q < kL; ++q) x += col_s[q * 3 * kSlab + idx];
      col_s[idx] = x;
    }
    cluster.sync();
    const int w = width(s);
    const int per = (w + C - 1) / C;
    const int lo = rank * per, hi = min(w, lo + per);
    for (int d = lo + tid; d < hi; d += kThreads) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int q0 = 0; q0 < C; q0 += 8) {  // 8 ranks' loads at once
        float x[3][8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float* src = cluster.map_shared_rank(col_s, min(q0 + e, C - 1));
          x[0][e] = src[d];
          x[1][e] = src[kSlab + d];
          x[2][e] = src[2 * kSlab + d];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (q0 + e < C) {
            s0 += x[0][e];
            s1 += x[1][e];
            s2 += x[2][e];
          }
        }
      }
      const size_t at = (size_t)b * D + col0 + d;
      d_df[at] = s0;
      part_v[at] = s1;
      part_wc[at] = s2;
    }
    cluster.sync();  // no block rewrites col_s while another reads it
  }

  // the last cluster to finish adds d_v and d_w_c over the articles, as
  // the dense form (its blocks split all D columns)
  if (rank == 0 && tid == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(part);
    __threadfence();
    const bool last = atomicAdd(ticket, 1u) == (unsigned)(B - 1);
    __threadfence();
    if (last) atomicExch(ticket, 0u);  // every cluster has taken its ticket
    for (int q = 0; q < C; ++q)
      cluster.map_shared_rank(last_s, q)[0] = last ? 1.f : 0.f;
  }
  cluster.sync();
  if (last_s[0] == 0.f) return;
  const int per = (D + C - 1) / C;
  const int lo = rank * per, hi = min(D, lo + per);
  for (int d = lo + tid; d < hi; d += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int a0 = 0; a0 < B; a0 += 8) {
      float x1[8], x2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const size_t at = (size_t)min(a0 + e, B - 1) * D + d;
        x1[e] = __ldcg(part_v + at);
        x2[e] = __ldcg(part_wc + at);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (a0 + e < B) {
          s1 += x1[e];
          s2 += x2[e];
        }
      }
    }
    d_v[d] = s1;
    d_wc[d] = kCov ? s2 : 0.f;
  }
}

// Launch the kernel instantiation kKernel over (C, B) blocks in clusters
// of C with `smem_bytes` of dynamic shared memory (wide: a non-portable
// cluster of 16 blocks)
template <auto kKernel, typename... Args>
cudaError_t launch_clusters(const Geometry& geo, int B, bool wide,
                            size_t smem_bytes, int dev, cudaStream_t stream,
                            Args... args) {
  auto kernel = kKernel;
  static unsigned smem_set = 0, wide_set = 0;  // per instantiation
  cudaError_t err = tf32x3::allow_smem(kernel, kSmemMax, smem_set);
  if (err != cudaSuccess) return err;
  if (wide && !(dev < 32 && (wide_set >> dev) & 1u)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 32) wide_set |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// whether the dense form takes width D (elt-byte stream elements): at
// most kMaxGroups column groups a thread, and its ring of at least
// kMinStages chunks of whole rows in one block's shared memory
inline bool dense_form(int D, int elt) {
  return D <= 4 * kThreads * kMaxGroups &&
         smem_floats(D, ring_stages(D, elt), elt) * sizeof(float) <=
             kSmemMax;
}

template <typename TE, bool kCov>
cudaError_t launch(const TE* es, const TE* ef, const float* mask,
                   const float* df, const float* cov, const float* v,
                   const float* wc, const float* attn, const float* g_ctx,
                   const float* g_attn, const float* s_ext, TE* d_es,
                   TE* d_ef, float* d_df, float* d_cov, float* d_v,
                   float* d_wc, float* part, int B, int T, int D,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // few articles: 16 blocks each while their clusters take at most half
  // the SMs, as the forward
  const bool wide = B * kWideCluster * 2 <= sms;
  const Geometry geo(T, wide ? kWideCluster : kCluster);
  const int elt = (int)sizeof(TE);
  if (!dense_form(D, elt)) {
    const int stages = slab_stages(elt);
    return launch_clusters<&attention_bwd_slab_kernel<TE, kCov>>(
        geo, B, wide, slab_smem_floats(stages, elt) * sizeof(float), dev,
        stream, es, ef, mask, df, cov, v, wc, attn, g_ctx, g_attn, s_ext,
        d_es, d_ef, d_df, d_cov, d_v, d_wc, part, B, T, D, geo.P, stages);
  }
  const int stages = ring_stages(D, elt);
  // pass two's column groups per thread, and its lanes of rows: as many
  // as leave a lane's threads at least D / 4
  const int n4 = D / 4;
  const int groups = (n4 + kThreads - 1) / kThreads;
  const int lanes = groups > 1          ? 1
                    : n4 <= kThreads / 8 ? 8
                    : n4 <= kThreads / 4 ? 4
                    : n4 <= kThreads / 2 ? 2
                                         : 1;
  // the column sums reuse the ring: [lanes][3][D] floats must fit (in
  // f32 3 stages of 8 rows hold 8 lanes; in bf16 the ring has 12 stages
  // wherever there is more than one lane)
  if ((size_t)3 * lanes * D > ring_floats(D, stages, elt))
    return cudaErrorInvalidValue;
  const size_t bytes = smem_floats(D, stages, elt) * sizeof(float);
#define TS_LAUNCH(G, L)                                                      \
  launch_clusters<&attention_bwd_kernel<TE, kCov, G, L>>(                    \
      geo, B, wide, bytes, dev, stream, es, ef, mask, df, cov, v, wc, attn,  \
      g_ctx, g_attn, s_ext, d_es, d_ef, d_df, d_cov, d_v, d_wc, part, B, T, \
      D, geo.P, stages)
  if (groups == 3) return TS_LAUNCH(3, 1);
  if (groups == 2) return TS_LAUNCH(2, 1);
  if (lanes == 8) return TS_LAUNCH(1, 8);
  if (lanes == 4) return TS_LAUNCH(1, 4);
  if (lanes == 2) return TS_LAUNCH(1, 2);
  return TS_LAUNCH(1, 1);
#undef TS_LAUNCH
}

}  // namespace

// Per-row form: es, ef [B, T, D] (16-byte aligned; float32 with D a
// multiple of 4, or with is_bf16 bfloat16 with D a multiple of 8, as
// d_es, d_ef); mask, cov (read only when use_cov), attn (the forward's output),
// g_attn [B, T]; df, g_ctx [B, D]; v, wc [D]; s_ext [B] or null (the
// sp-block form's softmax correction).  Outputs d_es, d_ef [B, T, D];
// d_df [B, D]; d_cov [B, T] (0 when !use_cov); d_v, d_wc [D] (d_wc 0 when
// !use_cov).  part: scratch of 4 + 2 * B * D floats (4 + 2 * B * D +
// B * T where the width takes the slab form: ts_fused_attention_bwd_part
// says how many) whose first 4 bytes, an unsigned ticket, are 0 before
// the launch and 0 again after it (keep one per stream: launches on one
// stream run in turn).  The rest float32; all contiguous, on one device.
// Launches one kernel on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take: empty,
// more articles than the grid's y extent, or rows that are not a
// multiple of 16 bytes).  Every width D is taken.
extern "C" int ts_fused_attention_bwd(
    const void* es, const void* ef, const float* mask, const float* df,
    const float* cov, const float* v, const float* wc, const float* attn,
    const float* g_ctx, const float* g_attn, const float* s_ext, void* d_es,
    void* d_ef, float* d_df, float* d_cov, float* d_v, float* d_wc,
    float* part, int B, int T, int D, int use_cov, int is_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elt = is_bf16 ? 2 : 4;
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535 || (D * elt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define TS_DISPATCH(TE)                                                     \
  (use_cov ? launch<TE, true>((const TE*)es, (const TE*)ef, mask, df, cov,  \
                              v, wc, attn, g_ctx, g_attn, s_ext, (TE*)d_es, \
                              (TE*)d_ef, d_df, d_cov, d_v, d_wc, part, B, T, \
                              D, st)                                         \
           : launch<TE, false>((const TE*)es, (const TE*)ef, mask, df, cov, \
                               v, wc, attn, g_ctx, g_attn, s_ext,           \
                               (TE*)d_es, (TE*)d_ef, d_df, d_cov, d_v,      \
                               d_wc, part, B, T, D, st))
  return (int)(is_bf16 ? TS_DISPATCH(__nv_bfloat16) : TS_DISPATCH(float));
#undef TS_DISPATCH
}

// The floats of `part` a launch at (B, T, D) needs (is_bf16: a bf16
// stream): the ticket and the partials, and d_cov's running sums where D
// takes the slab form.
extern "C" long long ts_fused_attention_bwd_part(int B, int T, int D,
                                                 int is_bf16) {
  const long long base = kTicketFloats + 2LL * B * D;
  return dense_form(D, is_bf16 ? 2 : 4) ? base : base + (long long)B * T;
}

#ifdef TS_BWD_TRACE
// the marks of the last launch (n <= kTraceBlocks * kTraceSlots values),
// then cleared for the next
extern "C" int ts_fused_attention_bwd_trace(unsigned long long* out, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_trace,
                                         sizeof(unsigned long long) * n);
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, g_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_trace));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}
#endif

extern "C" const char* ts_fused_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
