// Exact softmax self-attention forward for the UNet middle block (kernel K2),
// bfloat16 on the tensor cores, for sequences of any length.
//
// Replaces the Pallas TPU kernel
//   conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py:117
//   fused_attention -> _fused_attention_fwd_impl (kernel _attn_kernel :59-82)
// for bfloat16 qkv with head dim 32 or 64 and S beyond what attention_mma.cu
// holds on chip (576): ops/attention.py::kernel_for sends it every such qkv
// (the full-resolution cDDPM's 48x48 middle block, S = 2304). It takes any
// S >= 1 when called directly.
//
// Computes what attention_mma.cu computes, for qkv [B, S, 3, H, D] bf16 ->
// out [B, S, H, D] bf16: q*s and k*s rounded to bf16 (s = D^-1/4 rounded to
// bf16), logits q.k^T in f32, softmax in f32, weights normalised and THEN
// rounded to bf16, P.V accumulated in f32, rounded to bf16.
//
// Bound on the H100: 4*B*H*S^2*D operations on the tensor cores against qkv
// read once and out written once. At [312, 2304, 3, 4, 64] (a full-resolution
// eval volume) that is 1.70e12 FLOP, 1.72 ms at 989 TFLOP/s, against 1.47 GB
// (0.44 ms); the 6.6e9 exps take ~1.6 ms of their own at 16 a clock an SM.
//
// Design: the reference rounds the NORMALISED weights to bf16, so a row's
// max and sum must be known before any weight is formed; an online one-pass
// softmax would round unnormalised weights. So the kernel makes two passes
// over the keys in one launch: pass 1 computes S = QK^T and each row's max
// and sum, pass 2 recomputes S, forms the weights and accumulates P.V. That
// is 1.5x the products and 2x the exps of one pass (its own floor ~3.2 ms at
// [312, 2304]); both run at tensor-core and MUFU rates.
//   * One block of 4 warps per (b, h, 128-row query tile); a warp owns 32
//     query rows (two m16 tiles), so every K and V fragment it reads from
//     shared memory feeds two MMAs, and rows never meet across warps: no
//     cross-warp reduction and no shared-memory staging of the output.
//   * Q: the tile is copied raw by 16-byte cp.async into XOR-swizzled rows,
//     scaled and rounded to bf16 in place, and its ldmatrix A fragments stay
//     in registers for the whole block.
//   * K/V: 64-key tiles stream through a three-stage shared-memory ring
//     (16-byte cp.async, zero-filled past S), one __syncthreads a tile: the
//     tile for step t + 2 is in flight while step t computes, across the
//     passes (pass 2's first tiles load during pass 1's last). Each thread
//     scales and rounds the K chunks it copied once they land; the ragged
//     last tile's keys are masked to -inf.
//   * Pass 1: S on mma.sync.m16n8k16 (bf16 in, f32 accumulate), K by
//     ldmatrix; each thread keeps a running max and a rescaled running sum
//     of its own columns of its two rows (f32), merged across the quad by
//     shuffles once, after the last tile.
//   * Pass 2: S again; p = ex2((s - m) * log2e) * (1/l), rounded to bf16 and
//     packed straight from the accumulator layout into P.V's A operand; V by
//     ldmatrix.trans; O accumulated in f32 registers, stored as bf16.
//   * Query tiles of one (b, h) are neighbouring blocks, so their K and V
//     reads hit the L2 after the first.
//
// Numerical deviations from the reference, each a matter of f32 ulps before
// the bf16 rounding of the weights (inside TOL_K2["bfloat16"] = 2e-2):
//   - the MMA's accumulation order over D for the logits and over the keys
//     for P.V;
//   - the row sum: each thread's columns summed tile by tile against a
//     running max (rescaled by ex2 when it moves), the four threads of a
//     quad merged after the last tile;
//   - ex2.approx.ftz on (s - m) * log2e in place of expf(s - m);
//   - multiplying by 1/l (one IEEE reciprocal per row) in place of dividing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                  // m16 query tiles a warp
constexpr int kBQ = kWarps * 16 * kMT;  // query rows a block
constexpr int kBK = 64;                 // keys a shared-memory tile
constexpr int kStages = 3;              // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile; the chunk
// index is XORed with the row's position among the 8 rows that ldmatrix reads
// together, so those rows land on distinct banks (as in attention_mma.cu).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;
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

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q [kBQ][D] bf16, then kStages slots of K and V [kBK][D] bf16 each
  return (size_t)kBQ * D * 2 + (size_t)kStages * 2 * kBK * D * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
attention_mma_long_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                              __nv_bfloat16* __restrict__ out, int S, int H,
                              int qtiles, float scale) {
  constexpr int kChunks = D / 8;               // 16-byte chunks in a row
  constexpr int KD = D / 16;                   // 16-deep steps of q.k
  constexpr int DT = D / 8;                    // 8-column tiles of the output
  constexpr int NT = kBK / 8;                  // 8-key tiles of logits a tile
  constexpr int KJ = kBK / 16;                 // 16-key steps a tile
  constexpr int kTile = kBK * D * 2;           // bytes of a K (or V) tile
  constexpr int kCopies = kBK * kChunks / kThreads;  // a thread's chunks a tile
  constexpr int kQCopies = kBQ * kChunks / kThreads;
  static_assert(kBK * kChunks % kThreads == 0 && kBQ * kChunks % kThreads == 0,
                "whole copies a thread");

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + kBQ * D * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x / qtiles;
  const int q0 = (int)(blockIdx.x - bh * qtiles) * kBQ;
  const long long b = bh / H;
  const int h = (int)(bh - b * H);
  const long long rs = 3LL * H * D;  // elements from token s to s+1
  const __nv_bfloat16* qb = qkv + b * S * rs + (long long)h * D;
  const __nv_bfloat16* kb = qb + (long long)H * D;
  const __nv_bfloat16* vb = kb + (long long)H * D;
  const int T = (S + kBK - 1) / kBK;  // key tiles; step i < T is pass 1's
  const int steps = 2 * T;            // tile i, step T + i pass 2's

  // the tile of step i into slot i % kStages: K, and V in pass 2
  auto load = [&](int i) {
    unsigned char* slot = ring + (i % kStages) * 2 * kTile;
    const int k0 = (i < T ? i : i - T) * kBK;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int e = tid + j * kThreads, r = e / kChunks, c = e % kChunks;
      const bool ok = k0 + r < S;
      cp_async16(smem_u32(slot + swz<D>(r, c)), kb + (ok ? (k0 + r) * rs + c * 8 : 0), ok);
    }
    if (i >= T) {
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const int e = tid + j * kThreads, r = e / kChunks, c = e % kChunks;
        const bool ok = k0 + r < S;
        cp_async16(smem_u32(slot + kTile + swz<D>(r, c)),
                   vb + (ok ? (k0 + r) * rs + c * 8 : 0), ok);
      }
    }
  };

#pragma unroll
  for (int j = 0; j < kQCopies; ++j) {
    const int e = tid + j * kThreads, r = e / kChunks, c = e % kChunks;
    const bool ok = q0 + r < S;
    cp_async16(smem_u32(Qs + swz<D>(r, c)), qb + (ok ? (q0 + r) * rs + c * 8 : 0), ok);
  }
  cp_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load(i);
    cp_commit();
  }
  cp_wait<kStages - 1>();  // this thread's Q chunks have landed
#pragma unroll
  for (int j = 0; j < kQCopies; ++j) {
    const int e = tid + j * kThreads;
    uint4* p = reinterpret_cast<uint4*>(Qs + swz<D>(e / kChunks, e % kChunks));
    *p = scale8(*p, scale);
  }
  __syncthreads();
  uint32_t qa[kMT][KD][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qa[mt][kk], smem_u32(Qs + swz<D>(warp * 16 * kMT + mt * 16 + (lane & 15),
                                                kk * 2 + (lane >> 4))));

  // Step i's tile has landed (this thread's K chunks scaled in place), every
  // warp is done with step i - 1, and step i + kStages - 1's tile is in
  // flight into the slot step i - 1 left. Returns step i's K tile.
  auto begin = [&](int i) -> const unsigned char* {
    cp_wait<kStages - 2>();
    unsigned char* ks = ring + (i % kStages) * 2 * kTile;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int e = tid + j * kThreads;
      uint4* p = reinterpret_cast<uint4*>(ks + swz<D>(e / kChunks, e % kChunks));
      *p = scale8(*p, scale);
    }
    __syncthreads();
    if (i + kStages - 1 < steps) load(i + kStages - 1);
    cp_commit();
    return ks;
  };

  // S = Q K^T for one tile, padded keys at -inf
  auto logits = [&](const unsigned char* ks, int k0, float (&sc)[kMT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[mt][n][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int r = j * 16 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(ks + swz<D>(r, kk * 2 + ((lane >> 3) & 1))));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma16816(sc[mt][2 * j], qa[mt][kk], kf[0], kf[1]);
          mma16816(sc[mt][2 * j + 1], qa[mt][kk], kf[2], kf[3]);
        }
      }
    }
    if (k0 + kBK > S) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int kc = k0 + n * 8 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (kc >= S) { sc[mt][n][0] = -INFINITY; sc[mt][n][2] = -INFINITY; }
          if (kc + 1 >= S) { sc[mt][n][1] = -INFINITY; sc[mt][n][3] = -INFINITY; }
        }
      }
    }
  };

  // ---- pass 1: row max and sum; [mt][0] is row g, [mt][1] row g + 8 -------
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) { m[mt][r] = -INFINITY; l[mt][r] = 0.0f; }
  for (int i = 0; i < T; ++i) {
    const unsigned char* ks = begin(i);
    float sc[kMT][NT][4];
    logits(ks, i * kBK, sc);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(sc[mt][n][2 * r], sc[mt][n][2 * r + 1]));
        if (mx == -INFINITY) continue;  // every column so far padded
        float sum = l[mt][r] * ex2((m[mt][r] - mx) * kLog2e);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          sum += ex2((sc[mt][n][2 * r] - mx) * kLog2e);
          sum += ex2((sc[mt][n][2 * r + 1] - mx) * kLog2e);
        }
        m[mt][r] = mx;
        l[mt][r] = sum;
      }
  }
  // the quad's four threads hold a row's columns: merge their max and sum
  float inv[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mq = m[mt][r];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, off));
      float lq = l[mt][r] * ex2((m[mt][r] - mq) * kLog2e);
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) lq += __shfl_xor_sync(0xffffffffu, lq, off);
      m[mt][r] = mq;
      inv[mt][r] = __frcp_rn(lq);
    }

  // ---- pass 2: normalised bf16 weights times V ------------------------------
  float o[kMT][DT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][n][i] = 0.0f;
  for (int i = 0; i < T; ++i) {
    const unsigned char* ks = begin(T + i);
    const unsigned char* vs = ks + kTile;
    uint32_t pa[kMT][KJ][4];
    {
      float sc[kMT][NT][4];
      logits(ks, i * kBK, sc);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float m0 = m[mt][0], m1 = m[mt][1], i0 = inv[mt][0], i1 = inv[mt][1];
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float(&a)[4] = sc[mt][2 * j];
          const float(&c)[4] = sc[mt][2 * j + 1];
          pa[mt][j][0] = pack_bf16(ex2((a[0] - m0) * kLog2e) * i0,
                                   ex2((a[1] - m0) * kLog2e) * i0);
          pa[mt][j][1] = pack_bf16(ex2((a[2] - m1) * kLog2e) * i1,
                                   ex2((a[3] - m1) * kLog2e) * i1);
          pa[mt][j][2] = pack_bf16(ex2((c[0] - m0) * kLog2e) * i0,
                                   ex2((c[1] - m0) * kLog2e) * i0);
          pa[mt][j][3] = pack_bf16(ex2((c[2] - m1) * kLog2e) * i1,
                                   ex2((c[3] - m1) * kLog2e) * i1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int r = j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, smem_u32(vs + swz<D>(r, dp * 2 + (lane >> 4))));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma16816(o[mt][2 * dp], pa[mt][j], vf[0], vf[1]);
          mma16816(o[mt][2 * dp + 1], pa[mt][j], vf[2], vf[3]);
        }
      }
    }
  }

  // rows g and g + 8 of each m16 tile, columns 2t, 2t + 1 of each 8-column tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r0 = q0 + warp * 16 * kMT + mt * 16 + g;
    __nv_bfloat16* o0 = out + ((b * S + r0) * H + h) * D + 2 * t;
    __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o0 + n * 8) = pack_bf16(o[mt][n][0], o[mt][n][1]);
      if (r0 + 8 < S)
        *reinterpret_cast<uint32_t*>(o1 + n * 8) = pack_bf16(o[mt][n][2], o[mt][n][3]);
    }
  }
}

template <int D>
int launch(const void* qkv, void* out, int b, int s, int h, float scale,
           cudaStream_t stream) {
  const long long qtiles = (s + kBQ - 1) / kBQ;
  const long long blocks = (long long)b * h * qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(attention_mma_long_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_mma_long_fwd_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, s, h, (int)qtiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 qkv [b, s, 3, h, d] -> out [b, s, h, d], d in {32, 64}, any
// s >= 1; both pointers 16-byte aligned. Returns a cudaError_t
// (cudaErrorInvalidValue for an unsupported case).
extern "C" int attention_mma_long_fwd(const void* qkv, void* out, int b, int s, int h,
                                      int d, float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || ((uintptr_t)qkv & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 32) return launch<32>(qkv, out, b, s, h, scale, st);
  if (d == 64) return launch<64>(qkv, out, b, s, h, scale, st);
  return (int)cudaErrorInvalidValue;
}
