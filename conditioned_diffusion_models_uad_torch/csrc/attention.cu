// Exact softmax self-attention forward for the UNet middle block (kernel K2),
// on the CUDA cores: float32 in one pass, bfloat16 in two.
//
// Replaces the Pallas TPU kernel
//   conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py
//   fused_attention -> _fused_attention_fwd_impl (kernel _attn_kernel).
//
// ops/attention.py::kernel_for sends it float32 qkv. bfloat16 goes to the
// tensor-core kernels (attention_mma.cu up to S = 576, attention_mma_long.cu
// beyond); the bfloat16 mode here is called only directly, for comparison.
//
// Computes, for qkv [B, S, 3, H, D] (bfloat16 or float32) -> out [B, S, H, D]:
//   q, k scaled by D^-1/4 in the input dtype; logits q.k^T in float32;
//   softmax in float32; weights rounded to v's dtype; P.V accumulated in f32.
//
// Bound on the H100: 4*B*H*S^2*D operations (the two products) against
// qkv read once and out written once. In float32 the products run on the
// CUDA cores (67 TFLOP/s), so the operations bound it: 0.061 ms at
// [12, 576, 3, 4, 64] against 0.014 ms of bytes.
//
// Design: grid (query tile of 64 rows, head, batch), 128 threads, two blocks
// an SM (~98 KB of shared memory each). Thread (ty, tx), ty = tid / 8 and
// tx = tid % 8, owns query rows ty + 16 i (i < 4) and, in a key tile of 64,
// keys tx + 8 j (j < 8): a 4 x 8 register tile of logits, and a 4 x D/8 tile
// of the output (columns 32 c + 4 tx .. + 3). The eight lanes that share a
// row are neighbours in one warp, so a row's max and sum combine by three
// shuffles.
//   * One pass (float32): an online (flash) softmax. Per key tile the row
//     max is agreed across the eight lanes, the running sums and the output
//     are rescaled by exp(m_old - m_new), and the weights exp(s - m) go
//     through shared memory (transposed, [key][row]) to the P.V product.
//     The reference rounds the normalised weights to v's dtype; in float32
//     that rounding is the identity, so dividing the output by the sum at
//     the end differs from attention_reference by f32 rounding only. Q is
//     stored once, scaled by round(D^-1/4) twice (the logits' two scale
//     factors, one folded from K).
//   * Two passes (bfloat16): pass 1 computes every row's max and sum over
//     all S keys, pass 2 recomputes the logits and rounds the normalised
//     weights exp(s - m) / l to bfloat16 exactly as the reference does. K
//     tiles are scaled and rounded to bfloat16 in place once they land.
//   * K/V tiles stream through a two-stage ring in shared memory filled by
//     16-byte cp.async copies (zero-filled past S): tile t + 1 is in flight
//     while tile t computes. K rows are padded by 16 bytes so that the eight
//     lanes reading eight keys at one depth hit distinct banks; V, P and the
//     Q rows are read as 16-byte vectors (P and Q broadcast across the eight
//     lanes that share a row).
//   * Per 4-deep step of the logits a thread issues 12 vector loads for 128
//     FMAs; per key of P.V, 3 (D = 64) for 32. Two syncs a tile (three in
//     bfloat16, for the in-place scaling).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;  // 16 row groups x 8 key / column lanes
constexpr int kRows = 4;       // query rows per thread: ty + 16 i
constexpr int kKeys = 8;       // keys per thread per tile: tx + 8 j
constexpr int kQStride = 4;    // float padding of a Q row and a P row

template <typename T> struct Num;
template <> struct Num<float> {
  static constexpr int kKPad = 4;  // elements: 16 bytes
  __device__ static float load(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct Num<__nv_bfloat16> {
  static constexpr int kKPad = 8;
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  __device__ static void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <typename T, int D>
struct Layout {
  static constexpr int kQS = D + kQStride;           // Q row stride, floats
  static constexpr int kPS = kBQ + kQStride;         // P row stride, floats
  static constexpr int kKS = D + Num<T>::kKPad;      // K row stride, elements
  static constexpr int kQBytes = kBQ * kQS * 4;
  static constexpr int kPBytes = kBK * kPS * 4;
  static constexpr int kKBytes = kBK * kKS * (int)sizeof(T);  // one stage
  static constexpr int kVBytes = kBK * D * (int)sizeof(T);    // one stage
  static constexpr int kBytes = kQBytes + kPBytes + 2 * kKBytes + 2 * kVBytes;
  static_assert(kBK * D * (int)sizeof(T) / 16 % kThreads == 0, "whole copies a thread");
  static_assert(kQBytes % 16 == 0 && kPBytes % 16 == 0 && kKBytes % 16 == 0 &&
                kVBytes % 16 == 0, "16-byte aligned shared-memory regions");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float row_max8(float v) {  // over the 8 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S, int H,
                     float scale) {
  using L = Layout<T, D>;
  constexpr bool kOnePass = sizeof(T) == 4;  // float32; bfloat16 takes two
  constexpr int kNC = D / 8;                 // output columns per thread
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = D / kVec;          // 16-byte copies per K or V row
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + L::kQBytes);
  T* Ks = reinterpret_cast<T*>(smem + L::kQBytes + L::kPBytes);
  T* Vs = reinterpret_cast<T*>(smem + L::kQBytes + L::kPBytes + 2 * L::kKBytes);

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row_stride = 3LL * H * D;  // elements from token s to s+1
  const T* qbase = qkv + b * S * row_stride + (long long)h * D;
  const T* kbase = qbase + (long long)H * D;
  const int n_tiles = (S + kBK - 1) / kBK;

  // Q once: round(q * scale) in the input dtype, times scale again in
  // float32 (K's factor) in the one-pass kernel.
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = q0 + r;
    float v = 0.0f;
    if (s < S) {
      v = Num<T>::round(Num<T>::load(qbase[s * row_stride + d]) * scale);
      if (kOnePass) v *= scale;
    }
    Qs[r * L::kQS + d] = v;
  }

  // K (and V) rows k0 .. k0 + 63 into ring stage `st`, one commit group
  auto issue = [&](int st, int k0, bool with_v) {
    T* kd = Ks + st * (L::kKBytes / (int)sizeof(T));
    T* vd = Vs + st * (L::kVBytes / (int)sizeof(T));
#pragma unroll
    for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kChunks, c = (e % kChunks) * kVec;
      const int s = k0 + r;
      const bool valid = s < S;
      const T* src = kbase + (valid ? s : 0) * row_stride + c;
      cp_async16(kd + r * L::kKS + c, src, valid);
      if (with_v) cp_async16(vd + r * D + c, src + (long long)H * D, valid);
    }
    cp_async_commit();
  };

  // the bf16 reference rounds k * scale to bf16: done in place once a tile lands
  auto scale_k = [&](int st) {
    T* kd = Ks + st * (L::kKBytes / (int)sizeof(T));
    for (int e = tid; e < kBK * D / 2; e += kThreads) {
      const int r = e / (D / 2), c = (e % (D / 2)) * 2;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(kd + r * L::kKS + c);
      const float2 f = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
  };

  float s_acc[kRows][kKeys];
  auto logits = [&](int st, int k0) {
    const T* kt = Ks + st * (L::kKBytes / (int)sizeof(T));
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s_acc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qf[kRows], kf[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qf[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::kQS + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kf[j] = Num<T>::load4(kt + (tx + 8 * j) * L::kKS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float a = s_acc[i][j];
          a = fmaf(qf[i].x, kf[j].x, a);
          a = fmaf(qf[i].y, kf[j].y, a);
          a = fmaf(qf[i].z, kf[j].z, a);
          s_acc[i][j] = fmaf(qf[i].w, kf[j].w, a);
        }
    }
    const int valid = S - k0;  // keys of this tile that exist
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      if (tx + 8 * j >= valid) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) s_acc[i][j] = -INFINITY;
      }
  };

  float m[kRows], l[kRows], o[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) o[i][c] = 0.0f;
  }

  // online update of row i's max and sum from this tile's logits; the
  // logits become exp(s - m_new); returns exp(m_old - m_new). expf, not
  // exp2f of (s - m) * log2(e): that product's rounding grows with |s - m|
  // and would move the weights by ~1e-5 at logits of a few tens
  auto online = [&](int i) {
    float mt = s_acc[i][0];
#pragma unroll
    for (int j = 1; j < kKeys; ++j) mt = fmaxf(mt, s_acc[i][j]);
    const float mn = fmaxf(m[i], row_max8(mt));  // finite: a tile has a key
    const float alpha = expf(m[i] - mn);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s_acc[i][j] = expf(s_acc[i][j] - mn);
      sum += s_acc[i][j];
    }
    l[i] = l[i] * alpha + sum;
    m[i] = mn;
    return alpha;
  };

  auto write_p = [&]() {  // Ps[key][4 ty + i]: a float4 of the thread's rows
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 8 * j) * L::kPS + 4 * ty) =
          make_float4(s_acc[0][j], s_acc[1][j], s_acc[2][j], s_acc[3][j]);
  };

  auto pv = [&](int st) {
    const T* vt = Vs + st * (L::kVBytes / (int)sizeof(T));
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + k * L::kPS + 4 * ty);
      const float pr[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c4 = 0; c4 < kNC / 4; ++c4) {
        const float4 v = Num<T>::load4(vt + k * D + 32 * c4 + 4 * tx);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          o[i][4 * c4 + 0] = fmaf(pr[i], v.x, o[i][4 * c4 + 0]);
          o[i][4 * c4 + 1] = fmaf(pr[i], v.y, o[i][4 * c4 + 1]);
          o[i][4 * c4 + 2] = fmaf(pr[i], v.z, o[i][4 * c4 + 2]);
          o[i][4 * c4 + 3] = fmaf(pr[i], v.w, o[i][4 * c4 + 3]);
        }
      }
    }
  };

  if constexpr (!kOnePass) {
    // ---- pass 1 (bf16): every row's max and sum over all keys ----------
    issue(0, 0, false);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      cp_async_wait_all();
      __syncthreads();  // tile t landed; every thread is done with tile t - 1
      if (t + 1 < n_tiles) issue(st ^ 1, (t + 1) * kBK, false);
      scale_k(st);
      __syncthreads();
      logits(st, t * kBK);
#pragma unroll
      for (int i = 0; i < kRows; ++i) online(i);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) l[i] = row_sum8(l[i]);
    __syncthreads();  // pass 2 refills the ring
  }

  // ---- the P.V pass: one pass (f32) or pass 2 (bf16) -------------------
  issue(0, 0, true);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < n_tiles) issue(st ^ 1, (t + 1) * kBK, true);
    if constexpr (!kOnePass) {
      scale_k(st);
      __syncthreads();
    }
    logits(st, t * kBK);
    if constexpr (kOnePass) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float alpha = online(i);
#pragma unroll
        for (int c = 0; c < kNC; ++c) o[i][c] *= alpha;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          s_acc[i][j] = Num<T>::round(expf(s_acc[i][j] - m[i]) / l[i]);
    }
    write_p();
    __syncthreads();  // P visible
    pv(st);
  }

  // the row sums (one pass: the output divides by them; bf16's weights
  // were normalised already), then the 4 x D/8 outputs as 16-byte stores
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float lsum = kOnePass ? row_sum8(l[i]) : 1.0f;  // every lane shuffles
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    T* orow = out + ((b * S + s) * H + h) * (long long)D;
#pragma unroll
    for (int c4 = 0; c4 < kNC / 4; ++c4)
      Num<T>::store4(orow + 32 * c4 + 4 * tx,
                     make_float4(o[i][4 * c4] / lsum, o[i][4 * c4 + 1] / lsum,
                                 o[i][4 * c4 + 2] / lsum, o[i][4 * c4 + 3] / lsum));
  }
}

template <typename T, int D>
int launch(const void* qkv, void* out, int b, int s, int h, float scale,
           cudaStream_t stream) {
  constexpr int smem = Layout<T, D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attention_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)qkv, (T*)out, s, h, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Head dims 32 and 64 are compiled (64 is
// the UNet's num_head_channels). qkv must be 16-byte aligned (the wrapper
// checks). Returns a cudaError_t (cudaErrorInvalidValue for an unsupported
// case).
extern "C" int attention_fwd(const void* qkv, void* out, int b, int s, int h,
                             int d, int dtype, float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
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
