// Flash self-attention backward for Hopper, f32: the dK/dV kernel and the
// dQ kernel.
//
// Replaces the two backward Pallas kernels of the library flash attention
// the JAX package's transformer differentiates through in training
// (`flash_attention` of jax.experimental.pallas.ops.tpu, called at
// textsummarization_on_flink_tpu/models/transformer.py:285; its
// custom_vjp is flash_attention.py:254-318 of the installed jax):
// `_flash_attention_bwd_dkv` (:941, `pl.pallas_call` :1121) and
// `_flash_attention_bwd_dq` (:1287, `pl.pallas_call` :1456).  Per article
// b and head h (q, k, v, dout, dq, dk, dv are [B, T, nh, hd], contiguous;
// lse and dsum are [B, T, nh]), with
//
//   P_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) * sm_scale,
//           on the keys j row i may attend (key_mask[b, j] > 0, or every
//           key when key_mask is null, and j <= i when causal), else 0;
//           0 on a whole row with no key to attend (lse_i = +inf)
//   D_i   = dout_i . out_i   (dsum, computed by the caller, as the
//           library computes it outside its kernels)
//
//   dv_j = sum_i P_ij dout_i
//   dS_ij = P_ij (dout_i . v_j - D_i)
//   dk_j = sm_scale * sum_i dS_ij q_i
//   dq_i = sm_scale * sum_j dS_ij k_j
//
// The split follows the library: the dK/dV kernel takes one block per
// (key tile, head, article) and loops over query tiles; the dQ kernel
// takes one block per (query tile, head, article) and loops over key
// tiles.  Each block owns its outputs, so there are no atomics and a
// run's gradients are the same every time.  The scores are recomputed
// from q, k and the saved lse: the [T, T] matrices never reach device
// memory.
//
// What bounds it on an H100: operations.  Per (row, head, attended key)
// the function needs 10 * hd operations (the products s and dout . v and
// the dv, dk and dq updates; the two kernels do 14 * hd, since both
// recompute s and dout . v), 6.6 GFLOP at the encoder's shape
// (16 x 400 x 8 x hd 32, all keys): 40 us at 165 TFLOP/s (the TF32
// tensor-core rate over the three products of 3xTF32), against 52 MB of
// q, k, v, out, dout and the three gradients (16 us at 3.35 TB/s).
//
// The dK/dV kernel runs its four products on the tensor cores, f32-
// accurate in 3xTF32 (mma_tf32x3.cuh):
//
//   * a block owns 64 keys, 16 per warp; their K and V rows are staged in
//     shared memory once (hi/lo split at use: at hd 128 K, V and the two
//     accumulators would not fit in registers together), and the block
//     loops over tiles of queries (64 rows at hd 32, 16 at hd 128) whose
//     q, dout, lse and D are staged by cp.async, double-buffered, rows
//     padded by 4 floats so the fragment loads are free of bank conflicts;
//   * per tile a warp forms S^T = K Q^T, P^T = exp(S^T * scale - lse),
//     dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D) and dK += dS^T Q
//     as m16n8k8 products; P^T and dS^T feed the next product from their
//     accumulator registers in a permuted query order (a_from_acc /
//     load_b_perm), and dK is scaled by sm_scale at the end;
//   * causal: a warp skips a tile all of whose rows precede its first key.
//
// The dQ kernel is the f32 SIMT design (its redesign is the next step):
//
//   * G = hd / 16 lanes per row (2 at hd 32, 8 at hd 128): a lane holds
//     16 floats of each of its row's q, dout and accumulator in registers,
//     in float4 chunks g, g+G, g+2G, g+3G, so the G lanes of a row read
//     neighbouring 16-byte words of shared memory, without bank
//     conflicts; the two dot products of a pair are reduced over the G
//     lanes with shuffles;
//   * the keys are staged through shared memory in tiles of 64 rows at
//     hd 32 and 32 at hd 128 (16 or 32 KB); a ragged last tile is
//     zero-filled and masked.
//
// Both kernels:
//
//   * a pair the row may not attend gets p = 0 explicitly, never
//     exp(s - lse) with a sentinel, so a row with no key to attend (an
//     empty article) gives exact zeros in dq and nothing to dk or dv; a
//     block none of whose rows (dQ) or keys (dK/dV) may attend anything
//     writes zeros and stops;
//   * causal: the dK/dV kernel starts at its first key's row (earlier
//     query rows attend none of its keys); the dQ kernel stops at the key
//     tile past its last query row, as the forward does.
//
// The dQ kernel is plain f32 FMA; the dK/dV kernel's products are
// f32-accurate 3xTF32.  Both use expf (no fast math), so the result
// differs from the plain version by the order of sums and about one f32
// rounding per product.  wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points bound with
// ctypes from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32x3.cuh"

namespace {

using tf32x3::FragA;

constexpr int kThreads = 128;
constexpr int kVec = 4;  // float4 chunks of each row vector per lane

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float p, float4 x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// sum over the G neighbouring lanes of a row (every lane of the warp
// takes part; G is a power of two up to 32)
template <int G>
__device__ __forceinline__ float row_sum(float d) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  return d;
}

template <int HD>
struct Shape {
  static constexpr int G = HD / (4 * kVec);      // lanes per row
  static constexpr int kRows = kThreads / G;     // rows per block
  static constexpr int kTile = HD == 128 ? 32 : 64;  // rows per shared tile
  static constexpr int kC4 = HD / 4;             // float4 per head row
  static_assert(G * kVec * 4 == HD, "a lane holds 16 floats of a row");
  static_assert(G <= 32 && (G & (G - 1)) == 0, "G lanes share a warp");
};

// The dK/dV kernel's tiling: a block owns 64 keys, 16 per warp, and loops
// over tiles of kQ query rows staged in shared memory.
template <int HD>
struct Dkv {
  static constexpr int kKeys = 64;                // keys per block
  static constexpr int kQ = HD == 128 ? 16 : 32;  // query rows per tile
  static constexpr int kStride = HD + 4;          // floats per shared row
  static constexpr int kKS = HD / 8;  // k-steps over the head dim
  static constexpr int kNT = kQ / 8;  // 8-query column tiles of S^T
  static constexpr int kDT = HD / 8;  // 8-wide column tiles of dK, dV
  static constexpr int kKV = 2 * kKeys * kStride;  // the block's K and V
  static constexpr int kTile = kQ * kStride;       // floats of a q/dO tile
  // q, dO (hi after the split), then lse, D and a row flag (+ kQ floats
  // of padding)
  static constexpr int kStage = 2 * kTile + 4 * kQ;
  // K, V, two stages, then the lo parts of the current q and dO tiles
  static constexpr size_t kSmem =
      (kKV + 2 * kStage + 2 * kTile) * sizeof(float);
  static_assert(kKV % 4 == 0 && kStage % 4 == 0, "16-byte aligned tiles");
};

// grid (ceil(T / 64), nh, B): one block per (64 keys, head, article);
// Dkv<HD>::kSmem bytes of dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const float* __restrict__ key_mask,
                     float* __restrict__ dk, float* __restrict__ dv, int T,
                     int nh, int causal, float sm_scale) {
  using D = Dkv<HD>;
  constexpr int kQ = D::kQ, kStride = D::kStride;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [64][kStride]
  float* vs = smem + D::kKeys * kStride;     // [64][kStride]
  float* stages = smem + D::kKV;             // two query-tile buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t pos_stride = (size_t)nh * HD;  // floats between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;  // lse/dsum of (b, 0, h)
  const int key0 = kb * D::kKeys + warp * 16;      // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};   // this lane's two keys
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = keys[r] < T && (key_mask == nullptr ||
                             key_mask[(size_t)b * T + keys[r]] > 0.f);

  float dka[D::kDT][4], dva[D::kDT][4];
#pragma unroll
  for (int n = 0; n < D::kDT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  // no key of the block is attended: zeros, without reading anything
  const bool any = __syncthreads_or(kok[0] || kok[1]);
  // causal: a row before the block's first key attends none of its keys
  const int q_begin = causal ? kb * D::kKeys : 0;  // block-uniform
  const int n_tiles = any ? (T - q_begin + kQ - 1) / kQ : 0;

  auto stage = [&](int tile, int buf) {
    float* qs = stages + buf * D::kStage;
    float* dos = qs + D::kTile;
    float* lse_s = dos + D::kTile;
    float* d_s = lse_s + kQ;
    float* rok_s = d_s + kQ;
    const int q0 = q_begin + tile * kQ;
    tf32x3::stage_rows<HD, kThreads>(qs, kStride, q + base, pos_stride, q0,
                                     kQ, T, tid);
    tf32x3::stage_rows<HD, kThreads>(dos, kStride, dout + base, pos_stride,
                                     q0, kQ, T, tid);
    for (int i = tid; i < kQ; i += kThreads) {
      const int row = q0 + i;
      float l = 0.f, d = 0.f;
      bool ok = false;
      if (row < T) {
        l = lse[row_base + (size_t)row * nh];
        d = dsum[row_base + (size_t)row * nh];
        ok = isfinite(l);
      }
      lse_s[i] = ok ? l : 0.f;
      d_s[i] = d;
      rok_s[i] = ok ? 1.f : 0.f;  // a real row with a key to attend
    }
    tf32x3::cp_async_commit();
  };

  if (n_tiles > 0) {
    tf32x3::stage_rows<HD, kThreads>(ks, kStride, k + base, pos_stride,
                                     kb * D::kKeys, D::kKeys, T, tid);
    tf32x3::stage_rows<HD, kThreads>(vs, kStride, v + base, pos_stride,
                                     kb * D::kKeys, D::kKeys, T, tid);
    stage(0, 0);  // one group: K, V and the first query tile
  }
  // the warp's 16 keys of K and V as A fragments, split at use
  const float* kw = ks + warp * 16 * kStride;
  const float* vw = vs + warp * 16 * kStride;
  auto k_frag = [&](int kk) {
    return tf32x3::load_a(kw + 8 * kk, kStride, g, t);
  };
  auto v_frag = [&](int kk) {
    return tf32x3::load_a(vw + 8 * kk, kStride, g, t);
  };
  float* q_lo = stages + 2 * D::kStage;  // lo parts of the current tile
  float* do_lo = q_lo + D::kTile;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);  // its buffer was freed at it - 1's end
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    float* qs = stages + (it & 1) * D::kStage;
    float* dos = qs + D::kTile;
    // each thread splits the chunks it copied; then the whole tile is
    // split and has landed for every warp (K and V with the first tile)
    tf32x3::split_tile<HD, kThreads>(qs, q_lo, kStride, kQ, tid);
    tf32x3::split_tile<HD, kThreads>(dos, do_lo, kStride, kQ, tid);
    __syncthreads();

    const int q0 = q_begin + it * kQ;
    // causal: every row of the tile precedes the warp's first key
    if (!causal || q0 + kQ - 1 >= key0) {
      const tf32x3::SplitTile qt{qs, q_lo}, dot{dos, do_lo};
      const float* lse_s = dos + D::kTile;
      const float* d_s = lse_s + kQ;
      const float* rok_s = d_s + kQ;

      // S^T = K Q^T: this warp's 16 keys x the tile's kQ queries, one
      // 16-wide slice of the head dim at a time (mma3)
      float p[D::kNT][4];
      tf32x3::head_dim_product<D::kNT, D::kKS>(p, k_frag, qt, kStride, g,
                                               t);
      // P^T = exp(S^T * scale - lse); exactly 0 where the pair is masked
      // or the row has no key to attend
#pragma unroll
      for (int j = 0; j < D::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const bool ok = kok[r] && rok_s[col] > 0.f &&
                          (!causal || keys[r] <= q0 + col);
          p[j][e] = ok ? expf(p[j][e] * sm_scale - lse_s[col]) : 0.f;
        }
      }
      // dV += P^T dO (the tile's queries in a_from_acc's order)
      tf32x3::tile_product<D::kNT, D::kDT, D::kNT>(dva, p, dot, kStride, g,
                                                   t);
      // dP^T = V dO^T
      float ds[D::kNT][4];
      tf32x3::head_dim_product<D::kNT, D::kKS>(ds, v_frag, dot, kStride, g,
                                               t);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < D::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - d_s[8 * j + 2 * t + (e & 1)]);
      }
      // dK += dS^T Q
      tf32x3::tile_product<D::kNT, D::kDT, D::kNT>(dka, ds, qt, kStride, g,
                                                   t);
    }
    __syncthreads();  // every warp is done with buffer it & 1 and the lo
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= T) continue;
    float* dk_row = dk + base + (size_t)keys[r] * pos_stride;
    float* dv_row = dv + base + (size_t)keys[r] * pos_stride;
#pragma unroll
    for (int n = 0; n < D::kDT; ++n) {
      *reinterpret_cast<float2*>(dk_row + 8 * n + 2 * t) = make_float2(
          dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv_row + 8 * n + 2 * t) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* dsum, const float* key_mask, float* dk,
                       float* dv, int B, int T, int nh, int causal,
                       float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Dkv<HD>::kSmem;
  static unsigned smem_set = 0;  // per instantiation: one per kernel
  const cudaError_t err =
      tf32x3::allow_smem(flash_bwd_dkv_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + Dkv<HD>::kKeys - 1) / Dkv<HD>::kKeys, nh, B);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, key_mask, dk, dv, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

// grid (ceil(T / kRows), nh, B): one block per (query tile, head, article)
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const float* __restrict__ key_mask,
                    float* __restrict__ dq, int T, int nh, int causal,
                    float sm_scale) {
  using S = Shape<HD>;
  constexpr int G = S::G, kRows = S::kRows, kTile = S::kTile, kC4 = S::kC4;

  __shared__ float4 k_s[kTile * kC4];
  __shared__ float4 v_s[kTile * kC4];
  __shared__ int kok_s[kTile];  // 1: a real key inside [0, T)

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int qi = blockIdx.x * kRows + tid / G;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool q_real = qi < T;
  const size_t pos_stride = (size_t)nh * HD;
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float l = 0.f, d = 0.f;
  bool row_ok = false;
  if (q_real) {
    l = lse[row_base + (size_t)qi * nh];
    d = dsum[row_base + (size_t)qi * nh];
    row_ok = isfinite(l);
  }
  float4* dq_row = reinterpret_cast<float4*>(dq + base + (size_t)qi * pos_stride);
  if (!__syncthreads_or(row_ok)) {  // no row of the tile attends a key
    if (q_real) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) dq_row[c * G + g] = zero4;
    }
    return;
  }

  float4 qv[kVec], dov[kVec], acc[kVec];
  const float4* q_row =
      reinterpret_cast<const float4*>(q + base + (size_t)qi * pos_stride);
  const float4* do_row =
      reinterpret_cast<const float4*>(dout + base + (size_t)qi * pos_stride);
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qv[c] = q_real ? q_row[c * G + g] : zero4;
    dov[c] = q_real ? do_row[c * G + g] : zero4;
    acc[c] = zero4;
  }

  // causal: keys past the block's last row are never attended
  const int t_end =
      causal ? min(T, (int)(blockIdx.x + 1) * kRows) : T;  // block-uniform
  for (int k0 = 0; k0 < t_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kTile * kC4; idx += kThreads) {
      const int t = k0 + idx / kC4, c = idx % kC4;
      float4 kk = zero4, vv = zero4;
      if (t < T) {
        kk = reinterpret_cast<const float4*>(k + base + t * pos_stride)[c];
        vv = reinterpret_cast<const float4*>(v + base + t * pos_stride)[c];
      }
      k_s[idx] = kk;
      v_s[idx] = vv;
    }
    for (int j = tid; j < kTile; j += kThreads) {
      const int t = k0 + j;
      kok_s[j] = (t < T && (key_mask == nullptr ||
                            key_mask[(size_t)b * T + t] > 0.f))
                     ? 1
                     : 0;
    }
    __syncthreads();

    const int nk = min(kTile, t_end - k0);  // block-uniform
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      const float4* kr = k_s + j * kC4;
      const float4* vr = v_s + j * kC4;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        s = dot4(s, qv[c], kr[c * G + g]);
        dp = dot4(dp, dov[c], vr[c * G + g]);
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const bool ok = row_ok && kok_s[j] != 0 && (!causal || k0 + j <= qi);
      const float p = ok ? expf(s * sm_scale - l) : 0.f;
      const float ds = p * (dp - d);
#pragma unroll
      for (int c = 0; c < kVec; ++c) axpy4(acc[c], ds, kr[c * G + g]);
    }
  }

  if (!q_real) return;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const float4 a = acc[c];
    dq_row[c * G + g] = make_float4(a.x * sm_scale, a.y * sm_scale,
                                    a.z * sm_scale, a.w * sm_scale);
  }
}

template <int HD>
dim3 grid_of(int B, int T, int nh) {
  constexpr int kRows = Shape<HD>::kRows;
  return dim3((T + kRows - 1) / kRows, nh, B);
}

bool bad_shape(int B, int T, int nh) {
  return B <= 0 || T <= 0 || nh <= 0 || B > 65535 || nh > 65535;
}

}  // namespace

// q, k, v, dout [B, T, nh, hd], lse and dsum [B, T, nh], dk and dv
// [B, T, nh, hd]: float32, contiguous, on one device; key_mask [B, T]
// float32 (1 = real token) or null (every key real).  hd is 32 or 128.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int ts_flash_bwd_dkv(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* dsum,
                                const float* key_mask, float* dk, float* dv,
                                int B, int T, int nh, int hd, int causal,
                                float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, nh)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch_dkv<32>(q, k, v, dout, lse, dsum, key_mask, dk, dv,
                                 B, T, nh, causal, sm_scale, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, lse, dsum, key_mask, dk,
                                  dv, B, T, nh, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As ts_flash_bwd_dkv; writes dq [B, T, nh, hd].
extern "C" int ts_flash_bwd_dq(const float* q, const float* k,
                               const float* v, const float* dout,
                               const float* lse, const float* dsum,
                               const float* key_mask, float* dq, int B, int T,
                               int nh, int hd, int causal, float sm_scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, T, nh)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      flash_bwd_dq_kernel<32><<<grid_of<32>(B, T, nh), kThreads, 0, st>>>(
          q, k, v, dout, lse, dsum, key_mask, dq, T, nh, causal, sm_scale);
      break;
    case 128:
      flash_bwd_dq_kernel<128><<<grid_of<128>(B, T, nh), kThreads, 0, st>>>(
          q, k, v, dout, lse, dsum, key_mask, dq, T, nh, causal, sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ts_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
