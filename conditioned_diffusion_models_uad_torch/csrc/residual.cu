// The ResBlock's output sum with both convolutions' biases (the port's own
// kernel; no TPU kernel computes it: XLA fuses the bias adds into the
// convolutions and the sum there).
//
// Computes, for s and h [M, C] (bfloat16 or float32, C innermost: the
// channels_last [B, H, W, C] outputs of the skip's 1x1 convolution and of the
// ResBlock's out convolution, both run without their bias, or for an
// identity skip s = x), the per-channel biases b_skip and b_out [C] of the
// same dtype (b_skip may be absent):
//   out = r(r(s + b_skip) + r(h + b_out))
// with r the rounding to the dtype and each sum in float32: the same roundings
// as ATen's chain it replaces (cuDNN's convolution, then its bias add_, for
// each conv, then skip + h), so the result is bit-equal to that chain.
// Without b_skip: out = r(s + r(h + b_out)). out may be h (the ResBlock writes
// into h's storage, which has no other reader); it is never s.
//
// Bound on the H100: three float adds an element, so bytes bound it: two
// reads and one write of [M, C] (8.8 GB at [312, 128, 192, 192] bf16: 2.6 ms
// at 3.35 TB/s). ATen's chain moves the tensor seven times with a skip bias
// (two bias add_ in its broadcast kernel, read and write each, then the sum)
// and five times without. Design: the tensors are flat rows of C, moved in
// 16-byte vectors (8 bf16 or 4 float32 channels, C a multiple of that); a
// block of 256 threads takes one chunk of 256 * kUnroll vectors, each thread
// kUnroll of them, all loads of both inputs issued before it adds; the
// biases sit in shared memory as float32, and a vector's channel index steps
// by 256 modulo C/V (one division a thread). It moves ~3.07 TB/s on an H100
// at the cells' largest sites (92% of 3.35), as ATen's vectorised add of
// the same bytes does; a persistent grid striding over the vectors read
// ~2.90-2.97 whatever its blocks, threads and vectors a thread, and 2 or 4
// vectors a thread or 128 threads a block read the same as this
// (utils/kernel_variants.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// 16 bytes of s and h in, 16 bytes of out
template <typename T, bool kSkipBias>
__device__ __forceinline__ uint4 sum_vec(uint4 sv, uint4 hv, const float* bs,
                                         const float* bo);

template <>
__device__ __forceinline__ uint4 sum_vec<float, true>(uint4 sv, uint4 hv, const float* bs,
                                                      const float* bo) {
  const float* s = reinterpret_cast<const float*>(&sv);
  const float* h = reinterpret_cast<const float*>(&hv);
  uint4 ov;
  float* o = reinterpret_cast<float*>(&ov);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __fadd_rn(__fadd_rn(s[j], bs[j]), __fadd_rn(h[j], bo[j]));
  return ov;
}

template <>
__device__ __forceinline__ uint4 sum_vec<float, false>(uint4 sv, uint4 hv, const float*,
                                                       const float* bo) {
  const float* s = reinterpret_cast<const float*>(&sv);
  const float* h = reinterpret_cast<const float*>(&hv);
  uint4 ov;
  float* o = reinterpret_cast<float*>(&ov);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __fadd_rn(s[j], __fadd_rn(h[j], bo[j]));
  return ov;
}

template <bool kSkipBias>
__device__ __forceinline__ uint4 sum_bf16(uint4 sv, uint4 hv, const float* bs,
                                          const float* bo) {
  const __nv_bfloat162* s = reinterpret_cast<const __nv_bfloat162*>(&sv);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&hv);
  uint4 ov;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 sf = __bfloat1622float2(s[j]);
    const float2 hf = __bfloat1622float2(h[j]);
    if (kSkipBias) {
      sf = __bfloat1622float2(__floats2bfloat162_rn(__fadd_rn(sf.x, bs[2 * j]),
                                                    __fadd_rn(sf.y, bs[2 * j + 1])));
    }
    const float2 uf = __bfloat1622float2(__floats2bfloat162_rn(
        __fadd_rn(hf.x, bo[2 * j]), __fadd_rn(hf.y, bo[2 * j + 1])));
    o[j] = __floats2bfloat162_rn(__fadd_rn(sf.x, uf.x), __fadd_rn(sf.y, uf.y));
  }
  return ov;
}

template <>
__device__ __forceinline__ uint4 sum_vec<__nv_bfloat16, true>(uint4 sv, uint4 hv,
                                                              const float* bs,
                                                              const float* bo) {
  return sum_bf16<true>(sv, hv, bs, bo);
}

template <>
__device__ __forceinline__ uint4 sum_vec<__nv_bfloat16, false>(uint4 sv, uint4 hv,
                                                               const float* bs,
                                                               const float* bo) {
  return sum_bf16<false>(sv, hv, bs, bo);
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// nvec 16-byte vectors of s and h; cvec = C / V vectors a row. Shared memory:
// b_out then b_skip as float32, C each.
template <typename T, bool kSkipBias>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(const uint4* __restrict__ s, const uint4* h, const T* __restrict__ b_skip,
                    const T* __restrict__ b_out, uint4* out, long long nvec, int cvec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float bias[];
  const int c = cvec * V;
  float* bo = bias;
  float* bs = bias + c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    bo[i] = to_float(b_out[i]);
    if (kSkipBias) bs[i] = to_float(b_skip[i]);
  }
  __syncthreads();

  const long long first = static_cast<long long>(blockIdx.x) * (kThreads * kUnroll) +
                          threadIdx.x;
  const int step = kThreads % cvec;
  int ch = static_cast<int>(first % cvec);  // the channel vector of vector `first`
  uint4 sv[kUnroll], hv[kUnroll];
  int chs[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = first + u * kThreads;
    if (j < nvec) {
      sv[u] = s[j];
      hv[u] = h[j];
    }
    chs[u] = ch;
    ch += step;
    if (ch >= cvec) ch -= cvec;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = first + u * kThreads;
    if (j < nvec)
      out[j] = sum_vec<T, kSkipBias>(sv[u], hv[u], bs + chs[u] * V, bo + chs[u] * V);
  }
}

template <typename T, bool kSkipBias>
int launch(const void* s, const void* h, const void* b_skip, const void* b_out, void* out,
           long long rows, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = rows * (c / V);
  if (nvec == 0) return 0;
  const long long grid = (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (grid > 0x7fffffffLL) return -1;
  const size_t smem = (kSkipBias ? 2 : 1) * c * sizeof(float);
  residual_kernel<T, kSkipBias><<<static_cast<unsigned int>(grid), kThreads, smem, stream>>>(
      static_cast<const uint4*>(s), static_cast<const uint4*>(h),
      static_cast<const T*>(b_skip), static_cast<const T*>(b_out), static_cast<uint4*>(out),
      nvec, c / V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest C the kernel takes: both biases in float32 within the 48 KB of
// shared memory a block gets without opting in.
extern "C" int residual_max_channels() { return 48 * 1024 / (2 * sizeof(float)); }

// out = r(r(s + b_skip) + r(h + b_out)) over [rows, c]; b_skip may be null.
// dtype 0 float32, 1 bfloat16. s, h and out 16-byte aligned, c a multiple
// of 16 / itemsize and at most residual_max_channels(). Returns a
// cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int residual_bias_sum(const void* s, const void* h, const void* b_skip,
                                 const void* b_out, void* out, long long rows, int c,
                                 int dtype, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || rows < 0 || c <= 0 || (c * itemsize) % 16 ||
      c > residual_max_channels() || s == nullptr || h == nullptr || b_out == nullptr ||
      out == nullptr || out == s)
    return -1;
  if ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return b_skip ? launch<float, true>(s, h, b_skip, b_out, out, rows, c, st)
                  : launch<float, false>(s, h, b_skip, b_out, out, rows, c, st);
  return b_skip ? launch<__nv_bfloat16, true>(s, h, b_skip, b_out, out, rows, c, st)
                : launch<__nv_bfloat16, false>(s, h, b_skip, b_out, out, rows, c, st);
}
