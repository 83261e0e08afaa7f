// Exact softmax self-attention forward for the UNet middle block (kernel K2),
// bfloat16 on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py:117
//   fused_attention -> _fused_attention_fwd_impl (kernel _attn_kernel :59-82)
// for bfloat16 qkv with head dim 32 or 64 and S <= 576 (kMaxSeq). float32,
// and any longer S, go to the scalar kernel in attention.cu.
//
// Computes, for qkv [B, S, 3, H, D] bf16 -> out [B, S, H, D] bf16:
//   q*s and k*s rounded to bf16 (s = D^-1/4 rounded to bf16), logits q.k^T in
//   f32, softmax in f32, weights normalised and THEN rounded to bf16, P.V
//   accumulated in f32, rounded to bf16.
//
// Bound on the H100 at the flagship shape (B=576, S=576, H=4, D=64):
// 4*B*H*S^2*D = 1.96e11 FLOP (0.198 ms at 989 TFLOP/s) against ~680 MB of qkv
// in and out (0.203 ms at 3.35 TB/s); the 7.6e8 exps have a floor of ~0.2 ms
// of their own (16 per clock per SM). So the kernel must do each product
// once, on the tensor cores, with one exp per logit, and read qkv once.
//
// Design: one block of 8 warps per (b, h). The block copies that head's K and
// V rows ([S, D] each, 147 KB at the flagship shape) into shared memory once,
// as raw bf16 with 16-byte cp.async into XOR-swizzled rows (so ldmatrix reads
// without bank conflicts), then scales and rounds K in place. The warps form
// 2 query groups of 4; a group takes a 16-row query slice at a time and its
// 4 warps split the keys 4 ways (KS 16-key steps each, KS = ceil(S/64)). So a
// warp holds a 16 x 16*KS slice of f32 logits as mma accumulators (72
// registers at S = 576): the logits are computed once and never leave the
// registers. Per slice:
//   Q rows: loaded as 16-byte vectors (prefetched one slice ahead), scaled,
//     rounded to bf16, stored swizzled; ldmatrix gives the A fragments;
//   S = Q K^T: mma.sync.m16n8k16 (bf16 in, f32 accumulate), K by ldmatrix;
//   row max: over the warp's keys, then the quad, then across the 4 warps
//     through 256 bytes of shared memory (max is exact in any order);
//   p = ex2.approx((s - m) * log2e): one exp per logit;
//   row sum: the same way, the 4 warps' sums added in split order 0, 1, 2, 3;
//   p * (1/l), rounded to bf16 and packed straight from the accumulator
//     layout into the A operand of the P.V mma (no shared-memory staging);
//   P V: mma.sync with V by ldmatrix.trans;
//   the 4 warps' f32 partial outputs go through shared memory and are summed
//     in split order 0, 1, 2, 3 (deterministic), rounded to bf16 and stored
//     with 16-byte writes.
// After the K/V copy, each group synchronises on its own named barrier (128
// threads), never on the whole block. Shared memory: 189,440 bytes at D = 64,
// S = 576, so one block per SM; the largest S the layout holds is
// 4 warps x 9 steps x 16 keys = 576 (kMaxSeq), where the logit slice takes
// 72 registers (at 10 steps it would be 80, and K/V 164 KB).
//
// Numerical deviations from the reference, each a matter of f32 ulps before
// the bf16 rounding of the weights (inside TOL_K2["bfloat16"] = 2e-2):
//   - the MMA's accumulation order over D for the logits and over the keys
//     for P.V, and the split order of the row sums and partial outputs;
//   - ex2.approx.ftz on (s - m) * log2e in place of expf(s - m);
//   - multiplying by 1/l (one IEEE reciprocal per row) in place of dividing.
// q*s and k*s are rounded to bf16 before the product, exactly as the
// reference does: cp.async copies raw bf16, so the kernel scales the staged
// tiles itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;                     // warps that share 16 query rows
constexpr int kGroups = 2;                    // query groups per block
constexpr int kWarps = kSplit * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupThreads = 32 * kSplit;
constexpr int kMaxSteps = 9;                  // 16-key steps per warp
constexpr int kMaxSeq = kSplit * kMaxSteps * 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile. The chunk
// index is XORed with the row's position among the 8 rows that ldmatrix
// reads together, so those rows land on distinct banks.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;               // 8 (D = 64) or 4 (D = 32)
  constexpr int kShift = (kChunks == 8) ? 0 : 1;
  return r * (D * 2) + ((c ^ ((r >> kShift) & (kChunks - 1))) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void group_bar(int grp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + grp), "n"(kGroupThreads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a * b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 bf16 values times s, each product rounded to bf16 (the reference's q*s)
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f.x * s, f.y * s);
  }
  return v;
}

template <int D, int KS>
__host__ __device__ constexpr size_t smem_bytes() {
  // K, V [4*16*KS][D] bf16; Q [kGroups][16][D] bf16; partial outputs
  // [kWarps][16][D + 8] f32; row max and sum [kGroups][2][kSplit][16] f32
  return (size_t)2 * kSplit * 16 * KS * D * 2 + (size_t)kGroups * 16 * D * 2 +
         (size_t)kWarps * 16 * (D + 8) * 4 + (size_t)kGroups * 2 * kSplit * 16 * 4;
}

template <int D, int KS>
__global__ void __launch_bounds__(kThreads, 1)
attention_mma_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                         __nv_bfloat16* __restrict__ out, int S, int H, float scale) {
  constexpr int kChunks = D / 8;            // 16-byte chunks in a row
  constexpr int kRows = kSplit * 16 * KS;   // keys held, S padded
  constexpr int NT = 2 * KS;                // 8-key tiles of logits per warp
  constexpr int KD = D / 16;                // 16-deep steps of q.k
  constexpr int DT = D / 8;                 // 8-column tiles of the output
  constexpr int OST = D + 8;                // f32 row stride of the partials

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + kRows * D * 2;
  unsigned char* Qs = Vs + kRows * D * 2;
  float* Os = reinterpret_cast<float*>(Qs + kGroups * 16 * D * 2);
  float* red = Os + kWarps * 16 * OST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / kSplit, split = warp % kSplit;
  const int gtid = tid - grp * kGroupThreads;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const long long rs = 3LL * H * D;  // elements from token s to s+1
  const __nv_bfloat16* qb = qkv + (long long)b * S * rs + (long long)h * D;
  const __nv_bfloat16* kb = qb + (long long)H * D;
  const __nv_bfloat16* vb = kb + (long long)H * D;

  // K and V of this (b, h), raw bf16; rows >= S are zero-filled
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < S;
    cp_async16(smem_u32(Ks + swz<D>(r, c)), kb + (ok ? (long long)r * rs + c * 8 : 0), ok);
  }
  cp_commit();
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < S;
    cp_async16(smem_u32(Vs + swz<D>(r, c)), vb + (ok ? (long long)r * rs + c * 8 : 0), ok);
  }
  cp_commit();
  cp_wait<1>();  // this thread's K chunks have landed: scale them in place
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(Ks + swz<D>(e / kChunks, e % kChunks));
    *p = scale8(*p, scale);
  }
  cp_wait<0>();
  __syncthreads();

  const int n_slices = (S + 15) / 16;
  unsigned char* Qg = Qs + grp * 16 * D * 2;
  float* Og = Os + grp * kSplit * 16 * OST;
  float* rmax = red + grp * 2 * kSplit * 16;
  float* rsum = rmax + kSplit * 16;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = split * 16 * KS;
  // the Q chunk this thread stages: row qr, chunk qc of the slice
  const bool q_owner = gtid < 16 * kChunks;
  const int qr = gtid / kChunks, qc = gtid % kChunks;
  auto load_q = [&](int sl) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int s = sl * 16 + qr;
    if (q_owner && sl < n_slices && s < S)
      v = __ldg(reinterpret_cast<const uint4*>(qb + (long long)s * rs + qc * 8));
    return v;
  };
  uint4 qnext = load_q(grp);

  for (int sl = grp; sl < n_slices; sl += kGroups) {
    const int q0 = sl * 16;
    if (q_owner) *reinterpret_cast<uint4*>(Qg + swz<D>(qr, qc)) = scale8(qnext, scale);
    group_bar(grp);
    qnext = load_q(sl + kGroups);  // arrives while this slice computes

    uint32_t qa[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qa[kk], smem_u32(Qg + swz<D>(lane & 15, kk * 2 + (lane >> 4))));

    // logits of this warp's keys, kept as accumulators
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int r = key0 + j * 16 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(Ks + swz<D>(r, kk * 2 + ((lane >> 3) & 1))));
        mma16816(sc[2 * j], qa[kk], kf[0], kf[1]);
        mma16816(sc[2 * j + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // row max (rows g and g + 8 of the slice), padded keys masked out
    if (key0 + 16 * KS > S) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int kc = key0 + n * 8 + 2 * t;
        if (kc >= S) { sc[n][0] = -INFINITY; sc[n][2] = -INFINITY; }
        if (kc + 1 >= S) { sc[n][1] = -INFINITY; sc[n][3] = -INFINITY; }
      }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      m0 = fmaxf(m0, fmaxf(sc[n][0], sc[n][1]));
      m1 = fmaxf(m1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (t == 0) { rmax[split * 16 + g] = m0; rmax[split * 16 + g + 8] = m1; }
    group_bar(grp);
    m0 = rmax[g];
    m1 = rmax[g + 8];
#pragma unroll
    for (int w = 1; w < kSplit; ++w) {
      m0 = fmaxf(m0, rmax[w * 16 + g]);
      m1 = fmaxf(m1, rmax[w * 16 + g + 8]);
    }

    // one exp per logit, then the row sums
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = ex2((sc[n][0] - m0) * kLog2e);
      sc[n][1] = ex2((sc[n][1] - m0) * kLog2e);
      sc[n][2] = ex2((sc[n][2] - m1) * kLog2e);
      sc[n][3] = ex2((sc[n][3] - m1) * kLog2e);
      l0 += sc[n][0];
      l0 += sc[n][1];
      l1 += sc[n][2];
      l1 += sc[n][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (t == 0) { rsum[split * 16 + g] = l0; rsum[split * 16 + g + 8] = l1; }
    group_bar(grp);
    l0 = rsum[g];
    l1 = rsum[g + 8];
#pragma unroll
    for (int w = 1; w < kSplit; ++w) {
      l0 += rsum[w * 16 + g];
      l1 += rsum[w * 16 + g + 8];
    }
    const float inv0 = __frcp_rn(l0), inv1 = __frcp_rn(l1);

    // normalised weights rounded to bf16, packed from the accumulator layout
    // (row g / g + 8, keys 2t, 2t + 1 of each 8-key tile) into A fragments
    uint32_t pa[KS][4];
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      pa[j][0] = pack_bf16(sc[2 * j][0] * inv0, sc[2 * j][1] * inv0);
      pa[j][1] = pack_bf16(sc[2 * j][2] * inv1, sc[2 * j][3] * inv1);
      pa[j][2] = pack_bf16(sc[2 * j + 1][0] * inv0, sc[2 * j + 1][1] * inv0);
      pa[j][3] = pack_bf16(sc[2 * j + 1][2] * inv1, sc[2 * j + 1][3] * inv1);
    }

    float o[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int r = key0 + j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, smem_u32(Vs + swz<D>(r, dp * 2 + (lane >> 4))));
        mma16816(o[2 * dp], pa[j], vf[0], vf[1]);
        mma16816(o[2 * dp + 1], pa[j], vf[2], vf[3]);
      }
    }

    // partial outputs of the 4 warps, summed in split order
    float* Ow = Og + split * 16 * OST;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<float2*>(&Ow[g * OST + n * 8 + 2 * t]) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(&Ow[(g + 8) * OST + n * 8 + 2 * t]) =
          make_float2(o[n][2], o[n][3]);
    }
    group_bar(grp);
    if (q_owner && q0 + qr < S) {
      const float* src = Og + qr * OST + qc * 8;
      float4 a = *reinterpret_cast<const float4*>(src);
      float4 c = *reinterpret_cast<const float4*>(src + 4);
#pragma unroll
      for (int w = 1; w < kSplit; ++w) {
        const float4 a2 = *reinterpret_cast<const float4*>(src + w * 16 * OST);
        const float4 c2 = *reinterpret_cast<const float4*>(src + w * 16 * OST + 4);
        a.x += a2.x; a.y += a2.y; a.z += a2.z; a.w += a2.w;
        c.x += c2.x; c.y += c2.y; c.z += c2.z; c.w += c2.w;
      }
      uint4 v;
      v.x = pack_bf16(a.x, a.y);
      v.y = pack_bf16(a.z, a.w);
      v.z = pack_bf16(c.x, c.y);
      v.w = pack_bf16(c.z, c.w);
      *reinterpret_cast<uint4*>(out + (((long long)b * S + q0 + qr) * H + h) * D + qc * 8) = v;
    }
    group_bar(grp);  // Q and the partials are free for the next slice
  }
}

template <int D, int KS>
int launch(const void* qkv, void* out, int b, int s, int h, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D, KS>();
  cudaError_t e = cudaFuncSetAttribute(attention_mma_fwd_kernel<D, KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_mma_fwd_kernel<D, KS><<<b * h, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, s, h, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_steps(int steps, const void* qkv, void* out, int b, int s, int h,
                 float scale, cudaStream_t st) {
  switch (steps) {
    case 1: return launch<D, 1>(qkv, out, b, s, h, scale, st);
    case 2: return launch<D, 2>(qkv, out, b, s, h, scale, st);
    case 3: return launch<D, 3>(qkv, out, b, s, h, scale, st);
    case 4: return launch<D, 4>(qkv, out, b, s, h, scale, st);
    case 5: return launch<D, 5>(qkv, out, b, s, h, scale, st);
    case 6: return launch<D, 6>(qkv, out, b, s, h, scale, st);
    case 7: return launch<D, 7>(qkv, out, b, s, h, scale, st);
    case 8: return launch<D, 8>(qkv, out, b, s, h, scale, st);
    case 9: return launch<D, 9>(qkv, out, b, s, h, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bfloat16 qkv [b, s, 3, h, d] -> out [b, s, h, d], d in {32, 64},
// 1 <= s <= kMaxSeq (576); both pointers 16-byte aligned.
// Returns a cudaError_t (cudaErrorInvalidValue for an unsupported case).
extern "C" int attention_mma_fwd(const void* qkv, void* out, int b, int s, int h,
                                 int d, float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || s > kMaxSeq || (long long)b * h > 0x7fffffffLL ||
      ((uintptr_t)qkv & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int steps = (s + kSplit * 16 - 1) / (kSplit * 16);
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 32) return launch_steps<32>(steps, qkv, out, b, s, h, scale, st);
  if (d == 64) return launch_steps<64>(steps, qkv, out, b, s, h, scale, st);
  return (int)cudaErrorInvalidValue;
}
