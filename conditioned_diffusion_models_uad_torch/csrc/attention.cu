// Exact softmax self-attention forward for the UNet middle block (kernel K2),
// scalar variant on the CUDA cores.
//
// Replaces the Pallas TPU kernel
//   conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py
//   fused_attention -> _fused_attention_fwd_impl (kernel _attn_kernel).
//
// ops/attention.py::kernel_for sends it float32 qkv, and bfloat16 qkv whose S
// exceeds what the tensor-core variant (attention_mma.cu) holds on chip
// (576). bfloat16 at S <= 576, the UNet's case, goes to attention_mma.cu.
//
// Computes, for qkv [B, S, 3, H, D] (bfloat16 or float32) -> out [B, S, H, D]:
//   q, k scaled by D^-1/4 in the input dtype; logits q.k^T in float32;
//   softmax in float32; weights rounded to v's dtype; P.V accumulated in f32.
//
// Design: grid (query tile of 64 rows, head, batch), 256 threads. A block
// streams its (b, h)'s K/V rows through shared memory in tiles of 64 keys,
// twice:
//   pass 1 computes every query row's float32 max and sum of exp over all S
//          keys (an online max/sum, combined across the 16 threads that share
//          a row by warp shuffles);
//   pass 2 recomputes the logits, normalises them exp(s - m) / l, ROUNDS the
//          weights to v's dtype exactly as the reference does, and accumulates
//          P.V in float32 registers.
// The [S, S] scores never reach device memory. An online (flash) softmax in
// one pass would round the unnormalised weights instead and would not match
// attention_reference; it is a later optimisation.
//
// Bound on the H100 at the flagship shape (B=576, S=576, H=4, D=64, bf16):
// 4*B*H*S^2*D = 1.96e11 FLOP (0.198 ms at 989 TFLOP/s) against ~680 MB of
// qkv in and out (0.203 ms at 3.35 TB/s), so the bound is ~0.20 ms. This
// first version runs the products as scalar float32 FMAs from shared memory
// (a 4x4 register tile per thread) and does 1.5x the minimum FLOPs (logits
// twice), so it is bound by the FMA pipes and the shared-memory loads that
// feed them, far above the bound. Tensor-core MMAs (mma.sync / wgmma) and
// TMA loads are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kThreads = 256;

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static float store(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  // Q [BQ][D+1], K [BK][D+1], V [BK][D], P [BQ][BK+1]
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S,
                     int H, float scale) {
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / output-column lane
  const int ty = tid >> 4;   // owns query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row_stride = 3LL * H * D;  // elements from token s to s+1
  const T* qbase = qkv + b * S * row_stride + (long long)h * D;
  const T* kbase = qbase + (long long)H * D;
  const T* vbase = qbase + 2LL * H * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - (e / D) * D;
    const int s = q0 + r;
    float v = 0.0f;
    if (s < S) v = Num<T>::round(Num<T>::load(qbase[s * row_stride + d]) * scale);
    Qs[r * (D + 1) + d] = v;
  }

  float acc[4][4];
  auto logits_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
  };
  auto load_k = [&](int k0) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - (e / D) * D;
      const int s = k0 + r;
      float v = 0.0f;
      if (s < S) v = Num<T>::round(Num<T>::load(kbase[s * row_stride + d]) * scale);
      Ks[r * (D + 1) + d] = v;
    }
  };

  // ---- pass 1: row max and sum of exp over all keys -----------------------
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.0f; }
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    logits_tile();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j < S) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = acc[i][j];
          if (s > m[i]) {
            l[i] = l[i] * expf(m[i] - s) + 1.0f;
            m[i] = s;
          } else {
            l[i] += expf(s - m[i]);
          }
        }
      }
    }
  }
  // combine the 16 lanes of a half-warp that share a row (same ty)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      const float a = (m[i] == -INFINITY) ? 0.0f : l[i] * expf(m[i] - mn);
      const float c = (mo == -INFINITY) ? 0.0f : lo * expf(mo - mn);
      l[i] = a + c;
      m[i] = mn;
    }
  }

  // ---- pass 2: normalised weights rounded to v's dtype, then P.V ---------
  float o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    load_k(k0);
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - (e / D) * D;
      const int s = k0 + r;
      Vs[r * D + d] = (s < S) ? Num<T>::load(vbase[s * row_stride + d]) : 0.0f;
    }
    __syncthreads();
    logits_tile();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < S)
                            ? Num<T>::round(expf(acc[i][j] - m[i]) / l[i])
                            : 0.0f;
        Ps[(ty * 4 + i) * (kBK + 1) + c] = p;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    T* orow = out + ((b * S + s) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = Num<T>::store(o[i][j]);
  }
}

template <typename T, int D>
int launch(const void* qkv, void* out, int b, int s, int h, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attention_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)qkv, (T*)out, s, h, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Head dims 32 and 64 are compiled (64 is
// the UNet's num_head_channels).
// Returns a cudaError_t (cudaErrorInvalidValue for an unsupported case).
extern "C" int attention_fwd(const void* qkv, void* out, int b, int s, int h,
                             int d, int dtype, float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (d == 32) return launch<float, 32>(qkv, out, b, s, h, scale, st);
    if (d == 64) return launch<float, 64>(qkv, out, b, s, h, scale, st);
  } else if (dtype == 1) {
    if (d == 32) return launch<__nv_bfloat16, 32>(qkv, out, b, s, h, scale, st);
    if (d == 64) return launch<__nv_bfloat16, 64>(qkv, out, b, s, h, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
