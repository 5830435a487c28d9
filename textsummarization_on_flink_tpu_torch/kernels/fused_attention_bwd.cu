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
// What bounds it on an H100: memory.  es and ef are read once and d_es
// and d_ef written once, 4 * B*T*D*4 bytes: at the training shape (16
// articles, T=400, D=512, f32) 52.4 MB, 15.6 us at 3.35 TB/s; the
// B*T*D = 3.3 M tanh recomputed are far below that.  The design, a
// simple one:
//
//   * one thread block cluster per article (up to 8 blocks, the portable
//     size), block r owning a contiguous range of positions; a warp takes
//     one position at a time, its lanes float4 groups of columns;
//   * pass one reads the block's es rows, forms ga (kept in the d_cov
//     output, which pass two overwrites) and the block's share of
//     sum attn * ga; the cluster adds the shares through distributed
//     shared memory in rank order;
//   * pass two reads the ef rows, recomputes u and writes d_ef, d_es and
//     d_cov; each warp accumulates its d_df, d_v and d_w_c columns in its
//     own slice of shared memory, the block adds its warps in order and
//     the cluster its blocks in rank order: d_df per article, and per
//     article partials of d_v and d_w_c;
//   * a second small kernel adds the partials over the articles in order.
//
// Nothing is kept per position in shared memory, so every T is taken.  No
// float atomics: every sum has a fixed order, and two launches on the
// same inputs give the same bits.  Accurate tanhf (the energies'
// tanh is recomputed, not read back).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry point bound with
// ctypes from ops/fused_attention.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"  // allow_smem

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks per article at most (portable size)
constexpr size_t kSmemMax = 232448;  // bytes a block may use on Hopper
constexpr int kSmall = 16;  // floats for the block's scalars

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // the same bits in every lane (a butterfly of pairwise adds)
}

// Dynamic shared memory, in floats: g_ctx, df, v and w_c [D], then per
// warp its d_df, d_v and d_w_c columns [3][D], then the block's scalars.
inline size_t smem_floats(int D) {
  return (size_t)(4 + 3 * kWarps) * D + kSmall;
}

// blocks per article and positions per block
struct Geometry {
  int C, P;
  explicit Geometry(int T) {
    const int need = (T + kWarps - 1) / kWarps;  // a position per warp
    C = need < kCluster ? need : kCluster;
    P = (T + C - 1) / C;
  }
};

// one position's column group c (4 columns) of pass two
template <bool kCov>
__device__ __forceinline__ void pass_two_group(
    const float* ef_row, float* d_ef_row, float* d_es_row, const float* g_s,
    const float* df_s, const float* v_s, const float* wc_s, float* acc,
    int D, int c, float a, float de, float cv, float& dcov) {
  const float4 x = load4(ef_row + 4 * c);
  const float4 d = load4(df_s + 4 * c);
  const float4 vv = load4(v_s + 4 * c);
  const float4 w = load4(wc_s + 4 * c);
  const float4 g = load4(g_s + 4 * c);
  const float xs[4] = {x.x, x.y, x.z, x.w}, ds[4] = {d.x, d.y, d.z, d.w};
  const float vs[4] = {vv.x, vv.y, vv.z, vv.w}, ws[4] = {w.x, w.y, w.z, w.w};
  float df_[4], u_[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f = xs[j] + ds[j];
    if (kCov) f = fmaf(cv, ws[j], f);
    const float u = tanhf(f);
    u_[j] = u;
    df_[j] = de * vs[j] * fmaf(-u, u, 1.f);
    if (kCov) dcov = fmaf(df_[j], ws[j], dcov);
  }
  *reinterpret_cast<float4*>(d_ef_row + 4 * c) =
      make_float4(df_[0], df_[1], df_[2], df_[3]);
  *reinterpret_cast<float4*>(d_es_row + 4 * c) =
      make_float4(a * g.x, a * g.y, a * g.z, a * g.w);
  float4* a_df = reinterpret_cast<float4*>(acc + 4 * c);
  float4* a_v = reinterpret_cast<float4*>(acc + D + 4 * c);
  float4* a_wc = reinterpret_cast<float4*>(acc + 2 * D + 4 * c);
  float4 o = *a_df;
  *a_df = make_float4(o.x + df_[0], o.y + df_[1], o.z + df_[2],
                      o.w + df_[3]);
  o = *a_v;
  *a_v = make_float4(fmaf(de, u_[0], o.x), fmaf(de, u_[1], o.y),
                     fmaf(de, u_[2], o.z), fmaf(de, u_[3], o.w));
  if (kCov) {
    o = *a_wc;
    *a_wc = make_float4(fmaf(df_[0], cv, o.x), fmaf(df_[1], cv, o.y),
                        fmaf(df_[2], cv, o.z), fmaf(df_[3], cv, o.w));
  }
}

// grid (C, B) in clusters of (C, 1, 1); smem_floats(D) * 4 bytes.
// part: [2, B, D] per-article partials of d_v and d_w_c.
template <bool kCov>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ es,
                     const float* __restrict__ ef,
                     const float* __restrict__ mask,
                     const float* __restrict__ df,
                     const float* __restrict__ cov,
                     const float* __restrict__ v,
                     const float* __restrict__ wc,
                     const float* __restrict__ attn,
                     const float* __restrict__ g_ctx,
                     const float* __restrict__ g_attn, float* d_es,
                     float* d_ef, float* d_df, float* d_cov, float* part,
                     int B, int T, int D, int P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;          // [D] g_ctx of the article
  float* df_s = g_s + D;      // [D]
  float* v_s = df_s + D;      // [D]
  float* wc_s = v_s + D;      // [D]
  float* acc_s = wc_s + D;    // [kWarps][3][D]: d_df, d_v, d_w_c columns
  float* small = acc_s + 3 * kWarps * D;
  float* wsum_s = small;      // [kWarps] each warp's sum of attn * ga
  float* bsum_s = small + kWarps;  // [1] the block's
  float* s_s = bsum_s + 1;         // [1] the article's

  const int t_begin = rank * P;
  const int n_pos = max(0, min(T, t_begin + P) - t_begin);
  const size_t row0 = (size_t)b * T + t_begin;  // the block's first row
  for (int i = tid; i < D; i += kThreads) {
    g_s[i] = g_ctx[(size_t)b * D + i];
    df_s[i] = df[(size_t)b * D + i];
    v_s[i] = v[i];
    wc_s[i] = wc[i];
  }
  for (int i = tid; i < 3 * kWarps * D; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  // pass one: ga = g_attn + es . g_ctx (kept in d_cov), the block's share
  // of sum attn * ga
  float wpart = 0.f;
  for (int tl = warp; tl < n_pos; tl += kWarps) {
    const float* row = es + (row0 + tl) * D;
    float dot = 0.f;
    for (int c = lane; c < D / 4; c += 32) {
      const float4 x = load4(row + 4 * c);
      const float4 g = load4(g_s + 4 * c);
      dot = fmaf(x.x, g.x, dot);
      dot = fmaf(x.y, g.y, dot);
      dot = fmaf(x.z, g.z, dot);
      dot = fmaf(x.w, g.w, dot);
    }
    const float ga = g_attn[row0 + tl] + warp_sum(dot);
    wpart = fmaf(attn[row0 + tl], ga, wpart);
    if (lane == 0) d_cov[row0 + tl] = ga;
  }
  if (lane == 0) wsum_s[warp] = wpart;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum_s[w];
    bsum_s[0] = s;
  }
  cluster.sync();  // every block's share is in its shared memory
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(bsum_s, r)[0];
    s_s[0] = s;
  }
  __syncthreads();
  const float S = s_s[0];

  // pass two: d_e, then the rows of d_ef and d_es, d_cov, and the warp's
  // column sums
  float* acc = acc_s + 3 * warp * D;
  for (int tl = warp; tl < n_pos; tl += kWarps) {
    const size_t r = row0 + tl;
    const float a = attn[r];
    // pass one's ga, read and then overwritten by this warp's lane 0 alone
    const float ga = __shfl_sync(0xffffffffu, lane == 0 ? d_cov[r] : 0.f, 0);
    const float de = mask[r] > 0.f ? a * (ga - S) : 0.f;
    const float cv = kCov ? cov[r] : 0.f;
    float dcov = 0.f;
    for (int c = lane; c < D / 4; c += 32)
      pass_two_group<kCov>(ef + r * D, d_ef + r * D, d_es + r * D, g_s,
                           df_s, v_s, wc_s, acc, D, c, a, de, cv, dcov);
    dcov = warp_sum(dcov);
    if (lane == 0) d_cov[r] = kCov ? dcov : 0.f;
  }
  __syncthreads();
  // the block's column sums: its warps in order, into warp 0's slice
  for (int i = tid; i < 3 * D; i += kThreads) {
    float s = acc_s[i];
    for (int w = 1; w < kWarps; ++w) s += acc_s[w * 3 * D + i];
    acc_s[i] = s;
  }
  cluster.sync();
  // the article's: block r adds a slice of the columns over the ranks in
  // order
  const int per = (D + C - 1) / C;
  const int hi = min(D, (rank + 1) * per);
  for (int d = rank * per + tid; d < hi; d += kThreads) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < C; ++q) {
      const float* src = cluster.map_shared_rank(acc_s, q);
      s0 += src[d];
      s1 += src[D + d];
      s2 += src[2 * D + d];
    }
    d_df[(size_t)b * D + d] = s0;
    part[(size_t)b * D + d] = s1;
    part[((size_t)B + b) * D + d] = s2;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// d_v, d_w_c [D]: the per-article partials added over the articles in
// order
__global__ void __launch_bounds__(kThreads)
sum_articles_kernel(const float* __restrict__ part, float* d_v, float* d_wc,
                    int B, int D, int use_cov) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float s1 = 0.f, s2 = 0.f;
  for (int b = 0; b < B; ++b) {
    s1 += part[(size_t)b * D + d];
    s2 += part[((size_t)B + b) * D + d];
  }
  d_v[d] = s1;
  d_wc[d] = use_cov ? s2 : 0.f;
}

template <bool kCov>
cudaError_t launch(const float* es, const float* ef, const float* mask,
                   const float* df, const float* cov, const float* v,
                   const float* wc, const float* attn, const float* g_ctx,
                   const float* g_attn, float* d_es, float* d_ef,
                   float* d_df, float* d_cov, float* d_v, float* d_wc,
                   float* part, int B, int T, int D, cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<kCov>;
  static unsigned smem_set = 0;  // per instantiation
  cudaError_t err = tf32x3::allow_smem(kernel, kSmemMax, smem_set);
  if (err != cudaSuccess) return err;
  const Geometry geo(T);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_floats(D) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, es, ef, mask, df, cov, v, wc, attn,
                           g_ctx, g_attn, d_es, d_ef, d_df, d_cov, part, B,
                           T, D, geo.P);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_articles_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, d_v, d_wc, B, D, kCov ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// Per-row form: es, ef [B, T, D] (16-byte aligned, D a multiple of 4);
// mask, cov (read only when use_cov), attn (the forward's output),
// g_attn [B, T]; df, g_ctx [B, D]; v, wc [D].  Outputs d_es, d_ef
// [B, T, D]; d_df [B, D]; d_cov [B, T] (0 when !use_cov); d_v, d_wc [D]
// (d_wc 0 when !use_cov); part: scratch [2, B, D].  All float32,
// contiguous, on one device.  Launches the two kernels on `stream`;
// returns the cudaError_t of the launches (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int ts_fused_attention_bwd(
    const float* es, const float* ef, const float* mask, const float* df,
    const float* cov, const float* v, const float* wc, const float* attn,
    const float* g_ctx, const float* g_attn, float* d_es, float* d_ef,
    float* d_df, float* d_cov, float* d_v, float* d_wc, float* part, int B,
    int T, int D, int use_cov, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535 || D % 4 != 0 ||
      smem_floats(D) * sizeof(float) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  return (int)(use_cov ? launch<true>(es, ef, mask, df, cov, v, wc, attn,
                                      g_ctx, g_attn, d_es, d_ef, d_df, d_cov,
                                      d_v, d_wc, part, B, T, D, st)
                       : launch<false>(es, ef, mask, df, cov, v, wc, attn,
                                       g_ctx, g_attn, d_es, d_ef, d_df,
                                       d_cov, d_v, d_wc, part, B, T, D, st));
}

extern "C" const char* ts_fused_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
