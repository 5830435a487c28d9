// Flash self-attention forward for Hopper, f32.
//
// Replaces the library Pallas kernel the JAX package's transformer calls
// for self-attention: `flash_attention` of jax.experimental.pallas.ops.tpu
// (called at textsummarization_on_flink_tpu/models/transformer.py:285),
// whose forward is `_flash_attention_kernel` (flash_attention.py:331 of
// the installed jax) through `pl.pallas_call` (:758).  Per article b,
// head h and query row i (q, k, v, out are [B, T, nh, hd], contiguous):
//
//   s_j   = (q_i . k_j) * sm_scale   for every key j the row may attend:
//           key_mask[b, j] > 0 (all keys when key_mask is null) and, when
//           causal, j <= i
//   out_i = sum_j softmax(s)_j v_j   (zeros when the row may attend none)
//
// That is the einsum path of transformer.py `_mha` (:149-180) on every
// row; padding query rows attend the real keys, as there.
//
// Training also asks for each row's log-sum-exp of its attended scores,
// lse_i = m_i + log(l_i) ([B, T, nh]; +inf for a row with no key to
// attend), which the backward kernels (flash_attention_bwd.cu) recompute
// the probabilities from.  With a null `lse` the kernel is the serving
// kernel and writes nothing else.
//
// What bounds it on an H100: operations.  At the encoder's shape (16
// articles x 400 positions x 8 heads x hd 32) the two products are
// 2 * 2 * T^2 * hd * B * nh = 2.6 GFLOP, 39 us at the 67 TFLOP/s f32
// rate outside the tensor cores, against 26 MB of q, k, v and out
// (7.8 us at 3.35 TB/s).  The design keeps the [T, T] scores out of
// device memory (the plain version writes and reads them, 41 MB per
// call) and feeds the FMA units from registers and shared memory:
//
//   * one block per (query tile, head, article): 128 threads, G = hd/32
//     lanes per query row, so every lane holds 32 floats of its row's q
//     and 32 of its accumulator in registers (hd 128 is split over 4
//     lanes rather than spilling 256 floats); a lane owns the float4
//     chunks g, g+G, g+2G, ... so the G lanes of a row read neighbouring
//     16-byte words of shared memory, without bank conflicts;
//   * the block loops over key/value tiles staged through shared memory
//     (64 keys at hd 32, 32 at hd 128: 16 or 32 KB); a dot product is 8
//     float4 loads and 32 FMAs per lane, reduced over the G lanes with
//     shuffles;
//   * online softmax over chunks of 16 keys: a running max, sum and f32
//     accumulator per row, rescaled once per chunk.  A key the row may
//     not attend gets p = 0 explicitly, so a tile that is wholly masked
//     (a ragged tail, an empty article) adds nothing, and a row whose sum
//     stays 0 writes zeros;
//   * causal: tiles of keys beyond the block's last query row are not
//     loaded at all.
//
// Plain f32 FMA and expf (no tensor cores, no TF32, no fast math), so
// the result differs from the plain version only in the order of sums.
// wgmma, TMA and bf16 are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py).  C entry point bound with
// ctypes from ops/flash_attention.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;  // running-max floor, never -inf
constexpr int kThreads = 128;
constexpr int kChunk = 16;  // keys per online-softmax rescale
constexpr int kVec = 8;     // float4 chunks of q / acc per lane (32 floats)

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

__device__ __forceinline__ void scale4(float4& acc, float a) {
  acc.x *= a;
  acc.y *= a;
  acc.z *= a;
  acc.w *= a;
}

// grid (ceil(T / kRows), nh, B); kThreads threads; static shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask, float* __restrict__ out,
                 float* __restrict__ lse, int T, int nh, int causal,
                 float sm_scale) {
  constexpr int G = HD / 32;             // lanes per query row
  constexpr int kRows = kThreads / G;    // query rows per block
  constexpr int kKeys = HD == 128 ? 32 : 64;  // keys per shared tile
  constexpr int kC4 = HD / 4;            // float4 per head row
  static_assert(G * kVec * 4 == HD, "a lane holds 32 floats of a row");
  static_assert(kKeys % kChunk == 0, "chunks tile the key tile");

  __shared__ float4 k_s[kKeys * kC4];
  __shared__ float4 v_s[kKeys * kC4];
  __shared__ float ok_s[kKeys];  // 1: a real key inside [0, T)

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int qi = blockIdx.x * kRows + tid / G;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool q_real = qi < T;
  const size_t pos_stride = (size_t)nh * HD;  // floats between positions
  const size_t base = (size_t)b * T * pos_stride + (size_t)h * HD;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qv[kVec], acc[kVec];
  const float4* q_row =
      reinterpret_cast<const float4*>(q + base + (size_t)qi * pos_stride);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = q_real ? q_row[i * G + g] : zero4;
    acc[i] = zero4;
  }
  float m = kNeg, l = 0.f;

  // causal: keys past the block's last row are never attended
  const int t_end =
      causal ? min(T, (int)(blockIdx.x + 1) * kRows) : T;  // block-uniform
  for (int k0 = 0; k0 < t_end; k0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKeys * kC4; idx += kThreads) {
      const int t = k0 + idx / kC4, c = idx % kC4;
      float4 kk = zero4, vv = zero4;
      if (t < T) {
        kk = reinterpret_cast<const float4*>(k + base + t * pos_stride)[c];
        vv = reinterpret_cast<const float4*>(v + base + t * pos_stride)[c];
      }
      k_s[idx] = kk;
      v_s[idx] = vv;
    }
    for (int j = tid; j < kKeys; j += kThreads) {
      const int t = k0 + j;
      ok_s[j] = (t < T && (key_mask == nullptr ||
                           key_mask[(size_t)b * T + t] > 0.f))
                    ? 1.f
                    : 0.f;
    }
    __syncthreads();

    const int nk = min(kKeys, t_end - k0);  // block-uniform
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNeg;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* kr = k_s + (j0 + c) * kC4;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) d = dot4(d, qv[i], kr[i * G + g]);
#pragma unroll
        for (int o = 1; o < G; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        const int t = k0 + j0 + c;
        const bool ok = ok_s[j0 + c] > 0.f && (!causal || t <= qi);
        s[c] = ok ? d * sm_scale : kNeg;
        if (ok) cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 on the first real key
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kVec; ++i) scale4(acc[i], alpha);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = k0 + j0 + c;
        const bool ok = ok_s[j0 + c] > 0.f && (!causal || t <= qi);
        const float p = ok ? expf(s[c] - m_new) : 0.f;  // masked: exactly 0
        l += p;
        const float4* vr = v_s + (j0 + c) * kC4;
#pragma unroll
        for (int i = 0; i < kVec; ++i) axpy4(acc[i], p, vr[i * G + g]);
      }
      m = m_new;
    }
  }

  if (!q_real) return;
  float4* o_row = reinterpret_cast<float4*>(out + base + (size_t)qi * pos_stride);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float4 r = zero4;
    if (l > 0.f) r = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l,
                                 acc[i].w / l);
    o_row[i * G + g] = r;
  }
  if (lse != nullptr && g == 0)
    lse[((size_t)b * T + qi) * nh + h] = l > 0.f ? m + logf(l) : INFINITY;
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* key_mask, float* out, float* lse, int B,
                   int T, int nh, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr int kRows = kThreads / (HD / 32);
  const dim3 grid((T + kRows - 1) / kRows, nh, B);
  flash_fwd_kernel<HD><<<grid, kThreads, 0, stream>>>(
      q, k, v, key_mask, out, lse, T, nh, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out [B, T, nh, hd] float32, contiguous, on one device; key_mask
// [B, T] float32 (1 = real token) or null (every key real); lse [B, T, nh]
// float32 or null (not written).  hd is 32 or 128.  Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int ts_flash_attention(const float* q, const float* k,
                                  const float* v, const float* key_mask,
                                  float* out, float* lse, int B, int T,
                                  int nh, int hd, int causal, float sm_scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || nh <= 0 || B > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return (int)launch<32>(q, k, v, key_mask, out, lse, B, T, nh, causal,
                             sm_scale, st);
    case 128:
      return (int)launch<128>(q, k, v, key_mask, out, lse, B, T, nh,
                              causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ts_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
