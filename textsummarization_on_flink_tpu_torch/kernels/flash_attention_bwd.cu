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
// (16 x 400 x 8 x hd 32, all keys): 98 us at the 67 TFLOP/s f32 rate
// outside the tensor cores, against 52 MB of q, k, v, out, dout and the
// three gradients (16 us at 3.35 TB/s).  The design feeds the FMA units
// from registers and shared memory, as the forward does:
//
//   * G = hd / 16 lanes per row (2 at hd 32, 8 at hd 128): a lane holds
//     16 floats of each of its row's vectors in registers (the dK/dV
//     kernel holds k, v and the two accumulators: 64 floats; the dQ
//     kernel q, dout and its accumulator: 48), in float4 chunks
//     g, g+G, g+2G, g+3G, so the G lanes of a row read neighbouring
//     16-byte words of shared memory, without bank conflicts; the two dot
//     products of a pair are reduced over the G lanes with shuffles;
//   * the other side (queries for dK/dV, keys for dQ) is staged through
//     shared memory in tiles of 64 rows at hd 32 and 32 at hd 128
//     (16 or 32 KB); a ragged last tile is zero-filled and masked;
//   * a pair the row may not attend gets p = 0 explicitly, never
//     exp(s - lse) with a sentinel, so a row with no key to attend (an
//     empty article) gives exact zeros in dq and nothing to dk or dv; a
//     block none of whose rows (dQ) or keys (dK/dV) may attend anything
//     writes zeros and stops;
//   * causal: the dK/dV kernel starts at its first key's row (earlier
//     query rows attend none of its keys); the dQ kernel stops at the key
//     tile past its last query row, as the forward does.
//
// Plain f32 FMA and expf (no tensor cores, no TF32, no fast math), so
// the result differs from the plain version only in the order of sums.
// wgmma, TMA and register tiling are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry points bound with
// ctypes from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// grid (ceil(T / kRows), nh, B): one block per (key tile, head, article)
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
  using S = Shape<HD>;
  constexpr int G = S::G, kRows = S::kRows, kTile = S::kTile, kC4 = S::kC4;

  __shared__ float4 q_s[kTile * kC4];
  __shared__ float4 do_s[kTile * kC4];
  __shared__ float lse_s[kTile];
  __shared__ float d_s[kTile];
  __shared__ int rok_s[kTile];  // 1: a real row with a key to attend

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int kj = blockIdx.x * kRows + tid / G;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool k_real = kj < T;
  const size_t pos_stride = (size_t)nh * HD;  // floats between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const size_t row_base = (size_t)b * T * nh + h;  // lse/dsum of (b, 0, h)
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool key_ok =
      k_real && (key_mask == nullptr || key_mask[(size_t)b * T + kj] > 0.f);

  float4* dk_row = reinterpret_cast<float4*>(dk + base + (size_t)kj * pos_stride);
  float4* dv_row = reinterpret_cast<float4*>(dv + base + (size_t)kj * pos_stride);
  if (!__syncthreads_or(key_ok)) {  // no key of the tile is attended
    if (k_real) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        dk_row[c * G + g] = zero4;
        dv_row[c * G + g] = zero4;
      }
    }
    return;
  }

  float4 kv[kVec], vv[kVec], dk_acc[kVec], dv_acc[kVec];
  const float4* k_row =
      reinterpret_cast<const float4*>(k + base + (size_t)kj * pos_stride);
  const float4* v_row =
      reinterpret_cast<const float4*>(v + base + (size_t)kj * pos_stride);
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    kv[c] = k_real ? k_row[c * G + g] : zero4;
    vv[c] = k_real ? v_row[c * G + g] : zero4;
    dk_acc[c] = zero4;
    dv_acc[c] = zero4;
  }

  // causal: a row before the block's first key attends none of its keys
  const int q_begin = causal ? (int)blockIdx.x * kRows : 0;  // block-uniform
  for (int q0 = q_begin; q0 < T; q0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kTile * kC4; idx += kThreads) {
      const int t = q0 + idx / kC4, c = idx % kC4;
      float4 qq = zero4, dd = zero4;
      if (t < T) {
        qq = reinterpret_cast<const float4*>(q + base + t * pos_stride)[c];
        dd = reinterpret_cast<const float4*>(dout + base + t * pos_stride)[c];
      }
      q_s[idx] = qq;
      do_s[idx] = dd;
    }
    for (int i = tid; i < kTile; i += kThreads) {
      const int t = q0 + i;
      float l = 0.f, d = 0.f;
      int ok = 0;
      if (t < T) {
        l = lse[row_base + (size_t)t * nh];
        d = dsum[row_base + (size_t)t * nh];
        ok = isfinite(l) ? 1 : 0;
      }
      lse_s[i] = ok ? l : 0.f;
      d_s[i] = d;
      rok_s[i] = ok;
    }
    __syncthreads();

    const int nq = min(kTile, T - q0);  // block-uniform
#pragma unroll 2
    for (int i = 0; i < nq; ++i) {
      const float4* qr = q_s + i * kC4;
      const float4* dr = do_s + i * kC4;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        s = dot4(s, qr[c * G + g], kv[c]);
        dp = dot4(dp, dr[c * G + g], vv[c]);
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const bool ok = key_ok && rok_s[i] != 0 && (!causal || kj <= q0 + i);
      const float p = ok ? expf(s * sm_scale - lse_s[i]) : 0.f;
      const float ds = p * (dp - d_s[i]);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        axpy4(dv_acc[c], p, dr[c * G + g]);
        axpy4(dk_acc[c], ds, qr[c * G + g]);
      }
    }
  }

  if (!k_real) return;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const float4 a = dk_acc[c];
    dk_row[c * G + g] = make_float4(a.x * sm_scale, a.y * sm_scale,
                                    a.z * sm_scale, a.w * sm_scale);
    dv_row[c * G + g] = dv_acc[c];
  }
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
      flash_bwd_dkv_kernel<32><<<grid_of<32>(B, T, nh), kThreads, 0, st>>>(
          q, k, v, dout, lse, dsum, key_mask, dk, dv, T, nh, causal,
          sm_scale);
      break;
    case 128:
      flash_bwd_dkv_kernel<128><<<grid_of<128>(B, T, nh), kThreads, 0, st>>>(
          q, k, v, dout, lse, dsum, key_mask, dk, dv, T, nh, causal,
          sm_scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
