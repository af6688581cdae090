// Causal or full GQA softmax attention with an online softmax, for Hopper.
//
// Replaces the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:28).  The models reach its math
// through layers.attention_chunked, the kernel's XLA twin; in the port the
// prefill attention on the card is this kernel.
//
// Contract: q [B, T, Hq, D], k and v [B, S, Hkv, D], o [B, T, Hq, D], all
// fp32 or all bf16, read and written through the (batch, sequence, head)
// strides they come with and unit stride along D, so the caller makes no
// transposed copies.  Hq is a multiple of Hkv; q-head h reads kv-head
// h / (Hq / Hkv).  Query row i sits at position q_offset + i and, when
// causal, sees keys j <= q_offset + i.  The running max, the running sum and
// the output accumulator are fp32; the output is written in the input's
// type.  A row that sees no key at all is written as 0 (the TPU kernel's
// l == 0 guard).  When the caller passes an fp32 buffer lse [B, Hq, T]
// (the training forward), each row's log-sum-exp of its scaled logits,
// m + log l, is written there too, +inf for a row that sees no key, for
// the backward kernels (flash_attention_bwd.cu) to recompute P from; the
// serve path passes null and nothing more is written.
//
// Design.  The TPU kernel walks the kv blocks as a sequential grid axis and
// keeps the output tile and its softmax statistics resident in VMEM.  Hopper
// blocks carry nothing between them, so here one block owns one (batch,
// q-head, q tile) and loops over kv tiles itself.  kv tiles wholly above
// the diagonal are never loaded, and blocks are issued heaviest q tile
// first so the causal triangle's long rows do not trail.  Three instances
// of that schedule; kernels/flash_attention.py's choose_instance picks one
// from dtype, head dim, strides and pointer alignment before any launch:
//   * wgmma (bf16 whose rows, bases and strides are 16-byte aligned: the
//     serve path).  128 q rows per block: two consumer warpgroups of 64
//     rows and one producer warpgroup (registers moved to the consumers
//     with setmaxnreg).  The producer brings the q tile once and
//     K and V tiles of 128 keys through a three-stage shared-memory ring,
//     each a TMA load with the 128-byte swizzle (64-byte at D = 32) that
//     wgmma's descriptors read, guarded by full and empty mbarriers.  Each
//     consumer runs S = q k^T as wgmma m64n128k16 with both operands in
//     shared memory (K-major), the online softmax on the fp32 accumulators
//     (the mask only on tiles that cross the diagonal or the end of S), and
//     O += P V as wgmma m64nDk16 with P in registers (the S accumulators of
//     16 keys are exactly its A fragment, rounded to bf16) and V read from
//     shared memory in wgmma's transposed (MN-major) layout: no transposing
//     store.  Per tile, S of this tile is issued and the previous tile's
//     P V behind it, so the softmax of this tile runs while P V is still on
//     the tensor cores (FlashAttention-3's overlap inside a warpgroup),
//     and at D <= 64 the two warpgroups take turns issuing their products
//     (named barriers), so one's softmax overlaps the other's products.
//     Tiles that need no mask run a step with no mask code at all, and
//     the first tile is peeled: ptxas serializes every wgmma of a kernel
//     that issues one under a runtime branch or writes accumulators on a
//     path it takes for divergent.
//     Tensor maps are encoded on the host with
//     cuTensorMapEncodeTiled, reached through the CUDA runtime
//     (hopper.cuh), so the build needs no -lcuda.
//   * mma.sync (bf16 otherwise: the [1,700,48,65] views of a fused tensor):
//     4 warps, each owning 16 of 64 q rows.  The q tile is staged once and
//     kept in registers as mma A fragments; per 64-key tile, K (row-major)
//     and V (transposed, d-major) are staged in shared memory with padded
//     rows, S = q k^T and O += P V run as mma.sync m16n8k16 bf16 products
//     with fp32 accumulators, and P never leaves the registers.
//   * fp32: 256 threads, each computing a 4x4 micro-tile of S with fp32 FMAs
//     on the CUDA cores from shared memory; P goes through shared memory.
// In every instance row max and sum reduce over the four lanes that share a
// row, and P is rounded to bf16 for the P V product in bf16, as the
// reference's attention_chunked does.
//
// Bound on an H100 at the serve path's shape (bf16, B 1, T = S = 2048,
// Hq 32, Hkv 8, D 64, causal): 2 T^2 D Hq = 17.2 GFLOP against 989 TFLOP/s
// of bf16 tensor cores is 17.4 us, and the 21.0 MB it must move take 6.3 us
// at 3.35 TB/s, so the work is bound by operations.  wgmma is the only
// full-rate path, and TMA keeps the next kv tile in flight while the tensor
// cores work.  At D = 64 the softmax's exponentials are a bound of their
// own: one ex2 per score on 16 special-function lanes per SM takes as long
// as the 4 D = 256 flops per score on the tensor cores, so the two must
// overlap.  What still holds the wgmma instance back: ptxas places the
// wait for P V(t-1) early in the softmax, so the overlap inside a
// warpgroup is partial; at D = 128 the consumers' registers run out
// (setmaxnreg's budget is not used by the allocator) and wgmma is
// serialized; the softmax spends about five FP32 instructions per score;
// the diagonal tile is computed whole and masked; and each of the four
// q-heads of a GQA group loads the same K and V tiles again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv rows per tile
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, t, h;  // elements between batches, rows, heads
};

// keys the q tile of `rows` rows starting at q0 can see: all of S, or up
// to its last row's diagonal when causal
__device__ __forceinline__ int kv_extent(int q0, int rows, int Tq, int S,
                                         int causal, int q_offset) {
  if (!causal) return S;
  const long long last =
      static_cast<long long>(q_offset) + min(q0 + rows, Tq) - 1;
  return static_cast<int>(max(0LL, min(static_cast<long long>(S), last + 1)));
}

// ------------------------------------------------- bf16: mma.sync tiles
namespace tensor_core {

constexpr int THREADS = 128;  // 4 warps x 16 q rows
constexpr int KP = BK + 8;    // row length of the transposed V tile

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+8], Ks [BK][D+8], Vt [D][KP], all bf16
  return sizeof(bf16) * ((BQ + BK) * size_t(D + 8) + size_t(D) * KP);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive bf16 (zeros when !in): one 16-byte load when the operand is
// 16-byte aligned with strides that are multiples of 8 (VEC), else 8 loads
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* p, bool in) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!in) return r;
  if constexpr (VEC) {
    r = *reinterpret_cast<const uint4*>(p);
  } else {
    bf16* e = reinterpret_cast<bf16*>(&r);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = p[j];
  }
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Tq, int S, int group,
                      Strides qs, Strides ks, Strides vs, Strides os, int causal,
                      int q_offset, float scale) {
  constexpr int DP = D + 8;   // padded row: fragment reads hit 32 banks
  constexpr int DC = D / 8;   // 8-wide chunks of a row; n-tiles of O
  constexpr int KC = D / 16;  // k steps of S = q k^T
  constexpr int NT = BK / 8;  // n-tiles of S
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // Qs[r * DP + d]
  bf16* Ks = Qs + BQ * DP;                      // Ks[key * DP + d]
  bf16* Vt = Ks + BK * DP;                      // Vt[d * KP + key]
  const uint32_t* Qw = reinterpret_cast<const uint32_t*>(Qs);
  const uint32_t* Kw = reinterpret_cast<const uint32_t*>(Ks);
  const uint32_t* Vw = reinterpret_cast<const uint32_t*>(Vt);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int t4 = lane % 4;  // fragment column pair
  const int r0 = (tid / 32) * 16 + g;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h;

  // rows fastest: a warp's shared-memory stores land on distinct banks
  for (int e = tid; e < BQ * DC; e += THREADS) {
    const int r = e % BQ;
    const int c = e / BQ;
    const int gq = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * DP + c * 8) =
        load8<VEC>(qb + gq * qs.t + c * 8, gq < Tq);
  }
  __syncthreads();
  uint32_t qf[KC][4];  // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qf[kc][0] = Qw[(r0 * DP + kc * 16 + 2 * t4) / 2];
    qf[kc][1] = Qw[((r0 + 8) * DP + kc * 16 + 2 * t4) / 2];
    qf[kc][2] = Qw[(r0 * DP + kc * 16 + 8 + 2 * t4) / 2];
    qf[kc][3] = Qw[((r0 + 8) * DP + kc * 16 + 8 + 2 * t4) / 2];
  }

  const int kv_end = kv_extent(q0, BQ, Tq, S, causal, q_offset);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  float oacc[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[c][j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's reads of Ks and Vt are done
    for (int e = tid; e < BK * DC; e += THREADS) {
      const int r = e % BK;
      const int c = e / BK;
      const int gk = k0 + r;
      const bool in = gk < S;
      *reinterpret_cast<uint4*>(Ks + r * DP + c * 8) =
          load8<VEC>(kb + gk * ks.t + c * 8, in);
      const uint4 vv = load8<VEC>(vb + gk * vs.t + c * 8, in);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c * 8 + j) * KP + r] = ve[j];
    }
    __syncthreads();

    // S = q k^T: rows r0 and r0 + 8, keys nt*8 + 2*t4 + {0, 1}
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int kr = nt * 8 + g;
        mma(s[nt], qf[kc], Kw[(kr * DP + kc * 16 + 2 * t4) / 2],
            Kw[(kr * DP + kc * 16 + 8 + 2 * t4) / 2]);
      }

    // mask and online softmax in base 2 (m is in units of log2 e); s
    // becomes P (fp32)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = q_offset + q0 + r0 + 8 * rr;
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + nt * 8 + 2 * t4 + j;
          const bool ok = kpos < S && (!causal || qpos >= kpos);
          float& x = s[nt][2 * rr + j];
          x = ok ? x * scale_log2 : -INFINITY;
          mt = fmaxf(mt, x);
        }
      const float mn = fmaxf(m[rr], quad_max(mt));
      const float base = mn == -INFINITY ? 0.f : mn;  // no key seen yet
      const float corr = exp2f(m[rr] - base);
      float ls = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * rr + j];
          x = exp2f(x - base);
          ls += x;
        }
      l[rr] = l[rr] * corr + ls;
      m[rr] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        oacc[c][2 * rr] *= corr;
        oacc[c][2 * rr + 1] *= corr;
      }
    }

    // O += P V: the S tiles 2kk and 2kk+1 are the A fragment of keys
    // 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dr = c * 8 + g;
        mma(oacc[c], a, Vw[(dr * KP + kk * 16 + 2 * t4) / 2],
            Vw[(dr * KP + kk * 16 + 8 + 2 * t4) / 2]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float sum = quad_sum(l[rr]);
    const int gq = q0 + r0 + 8 * rr;
    if (gq >= Tq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    if (lse != nullptr && t4 == 0)  // m is in log2 units
      lse[(static_cast<long long>(b) * gridDim.y + h) * Tq + gq] =
          sum > 0.f ? (m[rr] + log2f(sum)) * LN2 : INFINITY;
    bf16* orow = o + b * os.b + gq * os.t + h * os.h;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * t4) =
          pack(oacc[c][2 * rr] * inv, oacc[c][2 * rr + 1] * inv);
  }
}

template <int D, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int S, int Hq, int group, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_bf16_kernel<D, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Tq, S, group, qs,
      ks, vs, os, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tensor_core

// ------------------------------------------------ fp32: CUDA-core FMAs
namespace cuda_core {

constexpr int THREADS = 256;  // 16 x 16 threads; (ty, tx) owns rows ty*4+i
constexpr int PAD = BQ + 4;   // row length of the d-major and P tiles

// reduce over the 16 lanes that share a row (lane bits 0..3 are tx)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs [D][PAD], Ks [D][PAD], Vs [BK][D], Ps [BK][PAD]
  return sizeof(float) * (2 * size_t(D) * PAD + size_t(BK) * D + size_t(BK) * PAD);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int Tq, int S, int group,
                      Strides qs, Strides ks, Strides vs, Strides os, int causal,
                      int q_offset, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float4 smem_fp[];
  float* Qs = reinterpret_cast<float*>(smem_fp);  // Qs[d * PAD + r]
  float* Ks = Qs + D * PAD;                       // Ks[d * PAD + r]
  float* Vs = Ks + D * PAD;                       // Vs[r * D + d]
  float* Ps = Vs + BK * D;                        // Ps[key * PAD + row]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int gq = q0 + r;
    Qs[d * PAD + r] = gq < Tq ? qb[gq * qs.t + d] : 0.f;
  }

  const int kv_end = kv_extent(q0, BQ, Tq, S, causal, q_offset);
  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const int gk = k0 + r;
      const bool in = gk < S;
      Ks[d * PAD + r] = in ? kb[gk * ks.t + d] : 0.f;
      Vs[r * D + d] = in ? vb[gk * vs.t + d] : 0.f;
    }
    __syncthreads();

    // S = q k^T for rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + d * PAD + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Ks + d * PAD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < S && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float base = mn == -INFINITY ? 0.f : mn;  // no key seen yet
      const float corr = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx * 4 + j) * PAD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V for rows ty*4+i, columns tx*DC+c
    const int kt = min(BK, kv_end - k0);
    for (int kk = 0; kk < kt; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + kk * PAD + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DC];
      const float* vrow = Vs + kk * D + tx * DC;
      if constexpr (DC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = t4.x;
          vv[c + 1] = t4.y;
          vv[c + 2] = t4.z;
          vv[c + 3] = t4.w;
        }
      } else {  // D = 32: two columns per thread
        const float2 t2 = *reinterpret_cast<const float2*>(vrow);
        vv[0] = t2.x;
        vv[1] = t2.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty * 4 + i;
    if (gq >= Tq) continue;
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Tq + gq] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    float* orow = o + b * os.b + gq * os.t + h * os.h + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int S, int Hq, int group, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fp32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, S, group,
      qs, ks, vs, os, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_core

// --------------------------------- bf16 on Hopper: TMA ring and wgmma
namespace wgmma_tc {

using namespace hopper;

constexpr int BQW = 128;      // q rows per block: two consumer warpgroups
constexpr int BKV = 128;      // keys per kv tile
constexpr int STAGES = 3;     // kv ring depth
constexpr int CONSUMERS = 2;  // warpgroups of 64 q rows
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + one producer warpgroup
// registers per thread after setmaxnreg: the producer gives up what the
// consumers take (128 * 40 + 256 * 232 = 64,512 of the SM's 65,536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// the two consumer warpgroups take turns issuing their products (named
// barriers 1 and 2), so one's softmax runs while the other's products
// hold the tensor cores.  At D = 128 the turns cost more than they give
// (measured on the H100: the warpgroups then wait on each other with no
// registers to spare), so only D <= 64 takes them.
template <int D>
constexpr bool kTakeTurns = D <= 64;
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMERS * 128));
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMERS * 128));
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Geometry {
  static constexpr int SW = D >= 64 ? 128 : 64;  // TMA swizzle span, bytes
  static constexpr int CE = SW / 2;              // bf16 per box row
  static constexpr int NB = D / CE;              // column boxes per row
  static constexpr int Q_BYTES = BQW * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM =
      size_t(Q_BYTES) + size_t(STAGES) * STAGE_BYTES + 1024 + 8 * (1 + 2 * STAGES);
};

// Where a map keeps the (row, head, batch) coordinates: the map's dims are
// ordered by stride (innermost first), so dim index 1..3 of each, 2 bits
// apiece, t in bits 0-1, h in bits 2-3, b in bits 4-5.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, uint32_t order, int col,
                                         int t, int h, int b) {
  int c[4];
  c[0] = col;
  c[order & 3] = t;
  c[(order >> 2) & 3] = h;
  c[(order >> 4) & 3] = b;
  tma_load_4d(dst, map, bar, c[0], c[1], c[2], c[3]);
}

template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_bf16_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_bf16_rs_n64(o, a, db);
  } else {
    wgmma_bf16_rs_n128(o, a, db);
  }
}

// O += P V for one kv tile: P (bf16 A fragments) from registers, V read
// from shared memory in wgmma's MN-major (transposed) layout, 16 keys per
// step; committed as one group
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&pf)[BKV / 16][4],
                                         const uint8_t* Vs) {
  constexpr int SW = Geometry<D>::SW;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    pv_wgmma<D>(oacc, pf[kk], smem_desc(Vs + kk * 16 * SW, BKV * SW, 8 * SW, SW));
  wgmma_commit();
}

// One consumer warpgroup: what is fixed for the block, the running
// softmax state and accumulators, and its step over kv tile t.  MASK steps
// are the tiles that cross the diagonal or the end of S; the kernel runs
// the others first, with no mask code at all (wgmma is serialized when the
// compiler sees accumulators written on a path it takes for divergent).
template <int D>
struct Consumer {
  using G = Geometry<D>;
  static constexpr int SW = G::SW;
  const uint8_t* Qw;    // this warpgroup's 64 q rows
  const uint8_t* ring;  // the kv stages
  uint64_t* full;
  uint64_t* empty;
  int wg, lane, t4, row0, qrow, S, causal, q_offset, n_tiles;
  float scale_log2;
  float oacc[D / 2];
  float sacc[BKV / 2];       // S of the current tile, then its P (fp32)
  uint32_t pf[BKV / 16][4];  // the previous tile's P as bf16 A fragments
  float m[2], l[2];          // running max (log2 units), this lane's sums

  // Issue S(t) = Q K(t)^T, then P(t-1) V(t-1) behind it (FIRST: tile 0,
  // which has no P V before it); the softmax of S(t) runs while P V(t-1)
  // is still on the tensor cores, and only then is O rescaled and P(t)
  // packed.  No wgmma is in flight when a step starts or ends, and none
  // is issued under a runtime condition: the compiler serializes wgmma
  // whose group count differs between paths.
  template <bool MASK, bool FIRST>
  __device__ __forceinline__ void step(int t) {
    const int s = t % STAGES;
    const int k0 = t * BKV;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* Ks = ring + s * G::STAGE_BYTES;
    if constexpr (kTakeTurns<D>) turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = (16 * kc) / G::CE;
      const int off = ((16 * kc) % G::CE) * 2;
      wgmma_bf16_ss_n128(sacc, smem_desc(Qw + c * BQW * SW + off, 16, 8 * SW, SW),
                         smem_desc(Ks + c * BKV * SW + off, 16, 8 * SW, SW),
                         kc > 0 ? 1 : 0);
    }
    wgmma_commit();
    if constexpr (!FIRST)
      issue_pv<D>(oacc, pf,
                  ring + ((t - 1) % STAGES) * G::STAGE_BYTES + G::KV_BYTES);
    // the other warpgroup's turn (warpgroup 1 passes none after its last
    // tile, so every turn_wait meets exactly one pass)
    if (kTakeTurns<D> && (wg == 0 || t + 1 < n_tiles)) turn_pass(wg);
    if constexpr (FIRST) {
      wgmma_wait<0>();
    } else {
      wgmma_wait<1>();  // S(t) is done; P V(t-1) may still run
    }
    fence_regs(sacc);

    // mask (MASK: a tile that crosses the diagonal or the end of S) and
    // online softmax in base 2; sacc becomes P (fp32)
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long qpos = static_cast<long long>(q_offset) + qrow + 8 * rr;
      float mt[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = sacc[4 * i + 2 * rr + j];
          x *= scale_log2;
          if constexpr (MASK) {
            const int kpos = k0 + 8 * i + 2 * t4 + j;
            const bool ok = (kpos < S) & (!causal | (qpos >= kpos));
            x = ok ? x : -INFINITY;
          }
          mt[(2 * i + j) % 4] = fmaxf(mt[(2 * i + j) % 4], x);
        }
      const float mn = fmaxf(
          m[rr], tensor_core::quad_max(fmaxf(fmaxf(mt[0], mt[1]),
                                             fmaxf(mt[2], mt[3]))));
      const float base = mn == -INFINITY ? 0.f : mn;  // no key seen yet
      corr[rr] = ex2(m[rr] - base);
      float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = sacc[4 * i + 2 * rr + j];
          x = ex2(x - base);
          ls[(2 * i + j) % 4] += x;
        }
      l[rr] = l[rr] * corr[rr] + ((ls[0] + ls[1]) + (ls[2] + ls[3]));
      m[rr] = mn;
    }

    // the softmax's results as operands of an ordered no-op: the compiler
    // may not sink the softmax below the wait for P V(t-1) (it would run
    // while the tensor cores idle)
    fence_regs(sacc);
    fence_regs(corr);
    if constexpr (!FIRST) {
      wgmma_wait<0>();  // P V(t-1) is done: O, pf and its stage are free
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pf[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        oacc[4 * c + 2 * rr] *= corr[rr];
        oacc[4 * c + 2 * rr + 1] *= corr[rr];
      }
    // the S columns 16kk .. 16kk + 15 are the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kk][r] = tensor_core::pack(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ o, float* __restrict__ lse, int Tq,
                       int S, int group, Strides os, uint32_t qord,
                       uint32_t kord, uint32_t vord, int causal, int q_offset,
                       float scale) {
  using G = Geometry<D>;
  constexpr int SW = G::SW;
  extern __shared__ uint8_t smem_fa[];
  // swizzled tiles repeat every 8 rows of SW bytes: align to 1024
  uint8_t* Qs = smem_fa + ((1024 - (smem_u32(smem_fa) & 1023)) & 1023);
  uint8_t* ring = Qs + G::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQW;
  const int kv_end = kv_extent(q0, BQW, Tq, S, causal, q_offset);
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  // read through a shuffle so that the compiler sees the warp index, and
  // all that derives from it, as uniform across the warp: wgmma in a path
  // it takes for divergent is serialized
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      const int hk = h / group;
      mbar_expect_tx(qbar, G::Q_BYTES);
      for (int c = 0; c < G::NB; ++c)
        tma_rows(Qs + c * BQW * SW, &qmap, qbar, qord, c * G::CE, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* ks = ring + s * G::STAGE_BYTES;
        mbar_expect_tx(&full[s], G::STAGE_BYTES);
        for (int c = 0; c < G::NB; ++c) {
          tma_rows(ks + c * BKV * SW, &kmap, &full[s], kord, c * G::CE, t * BKV,
                   hk, b);
          tma_rows(ks + G::KV_BYTES + c * BKV * SW, &vmap, &full[s], vord,
                   c * G::CE, t * BKV, hk, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  Consumer<D> c;
  c.wg = warp / 4;
  c.lane = lane;
  c.t4 = lane % 4;
  c.row0 = q0 + 64 * c.wg;                        // this warpgroup's first row
  c.qrow = c.row0 + 16 * (warp % 4) + lane / 4;   // and this thread's (+ 8)
  c.Qw = Qs + c.wg * 64 * SW;
  c.ring = ring;
  c.full = full;
  c.empty = empty;
  c.S = S;
  c.causal = causal;
  c.q_offset = q_offset;
  c.n_tiles = n_tiles;
  c.scale_log2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) c.oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) c.sacc[i] = 0.f;
  c.m[0] = c.m[1] = -INFINITY;
  c.l[0] = c.l[1] = 0.f;

  // tiles before t_edge end at or before this warpgroup's first row's
  // diagonal and inside S: they need no mask
  const long long seen =
      causal ? max(0LL, static_cast<long long>(q_offset) + c.row0 + 1) : S;
  const int t_edge = static_cast<int>(min(static_cast<long long>(n_tiles),
                                          min(seen, static_cast<long long>(S)) / BKV));
  mbar_wait(qbar, 0);
  if (kTakeTurns<D> && c.wg == 1 && n_tiles > 0) turn_pass(c.wg);  // 0 first
  if (n_tiles > 0) {
    if (t_edge > 0)
      c.template step<false, true>(0);
    else
      c.template step<true, true>(0);
  }
  int t = 1;
  for (; t < t_edge; ++t) c.template step<false, false>(t);
  for (; t < n_tiles; ++t) c.template step<true, false>(t);
  if (n_tiles > 0) {  // the last tile's P V
    wgmma_fence();
    issue_pv<D>(c.oacc, c.pf,
                ring + ((n_tiles - 1) % STAGES) * G::STAGE_BYTES + G::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(c.oacc);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(c.pf[kk]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float sum = tensor_core::quad_sum(c.l[rr]);
    const int gq = c.qrow + 8 * rr;
    if (gq >= Tq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    if (lse != nullptr && c.t4 == 0)  // m is in log2 units
      lse[(static_cast<long long>(b) * gridDim.y + h) * Tq + gq] =
          sum > 0.f ? (c.m[rr] + log2f(sum)) * LN2 : INFINITY;
    bf16* orow = o + b * os.b + gq * os.t + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * c.t4) = tensor_core::pack(
          c.oacc[4 * j + 2 * rr] * inv, c.oacc[4 * j + 2 * rr + 1] * inv);
  }
}

// A [B, rows, H, D] bf16 operand as a 4-D tensor map whose dims after D
// are ordered by stride, loaded in boxes of `rows` x one swizzle span of D.
// Sets `order` (see tma_rows); false when cuTensorMapEncodeTiled refuses it.
template <int D>
bool operand_map(CUtensorMap* map, uint32_t* order, const void* base, int B,
                 int T, int H, const Strides& st, int rows) {
  using G = Geometry<D>;
  struct Dim {
    uint64_t extent, stride;
    uint32_t box;
    int logical;  // 0 t, 1 h, 2 b
  } dims[3] = {{uint64_t(T > 0 ? T : 1), uint64_t(st.t) * 2, uint32_t(rows), 0},
               {uint64_t(H), uint64_t(st.h) * 2, 1u, 1},
               {uint64_t(B), uint64_t(st.b) * 2, 1u, 2}};
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim tmp = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = tmp;
    }
  uint64_t extent[4] = {uint64_t(D)}, stride[3];
  uint32_t box[4] = {uint32_t(G::CE)};
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    extent[i + 1] = dims[i].extent;
    stride[i] = dims[i].stride;
    box[i + 1] = dims[i].box;
    *order |= uint32_t(i + 1) << (2 * dims[i].logical);
  }
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, extent,
                  stride, box, G::SW);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int S, int Hq, int Hkv, int group, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  using G = Geometry<D>;
  CUtensorMap qm, km, vm;
  uint32_t qord, kord, vord;
  if (!operand_map<D>(&qm, &qord, q, B, Tq, Hq, qs, BQW) ||
      !operand_map<D>(&km, &kord, k, B, S, Hkv, ks, BKV) ||
      !operand_map<D>(&vm, &vord, v, B, S, Hkv, vs, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQW - 1) / BQW, Hq, B);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, Tq, S, group, os, qord, kord,
      vord, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_tc

// 16-byte loads need 16-byte aligned rows: base pointers and every stride a
// multiple of 8 bf16
bool aligned8(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.t % 8 == 0 && s.h % 8 == 0;
}

// instance 0: fp32 on the CUDA cores; 1: bf16 on mma.sync (16-byte loads
// where the operands allow them); 2: bf16 on wgmma fed by TMA, which needs
// every operand 16-byte aligned (the wrapper's choose_instance decides)
template <int D>
int dispatch(int instance, const void* q, const void* k, const void* v,
             void* o, float* lse, int B, int Tq, int S, int Hq, int Hkv, int group,
             const Strides& qs, const Strides& ks, const Strides& vs,
             const Strides& os, int causal, int q_offset, float scale,
             cudaStream_t st) {
  const bool aligned = aligned8(q, qs) && aligned8(k, ks) && aligned8(v, vs);
  switch (instance) {
    case 0:
      return cuda_core::launch<D>(q, k, v, o, lse, B, Tq, S, Hq, group, qs, ks,
                                  vs, os, causal, q_offset, scale, st);
    case 1:
      if (aligned)
        return tensor_core::launch<D, true>(q, k, v, o, lse, B, Tq, S, Hq, group,
                                            qs, ks, vs, os, causal, q_offset,
                                            scale, st);
      return tensor_core::launch<D, false>(q, k, v, o, lse, B, Tq, S, Hq, group,
                                           qs, ks, vs, os, causal, q_offset,
                                           scale, st);
    case 2:
      if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
      return wgmma_tc::launch<D>(q, k, v, o, lse, B, Tq, S, Hq, Hkv, group, qs,
                                 ks, vs, os, causal, q_offset, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `instance` picks the kernel
// (see dispatch): 0 takes fp32 operands, 1 and 2 bf16.  Strides are in
// elements, in the order (batch, sequence, head); D has unit stride, and
// the output (bf16) is 4-byte aligned with even strides.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim without an instance (32, 64, 128), an unknown instance, wgmma
// operands that are not 16-byte aligned or whose tensor map CUDA
// refuses, a head count that is not a multiple of the kv heads, or a grid
// too large.  `lse` is null (serving) or an fp32 [B, Hq, Tq] buffer for each
// row's log-sum-exp (training).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int instance, int B,
    int Tq, int S, int Hq, int Hkv, int D, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, long long osb, long long ost, long long osh,
    int causal, int q_offset, float scale, void* stream) {
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  if (instance < 0 || instance > 2 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      os{osb, ost, osh};
  auto st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32: return dispatch<32>(instance, q, k, v, o, l, B, Tq, S, Hq, Hkv, group, qs, ks, vs, os, causal, q_offset, scale, st);
    case 64: return dispatch<64>(instance, q, k, v, o, l, B, Tq, S, Hq, Hkv, group, qs, ks, vs, os, causal, q_offset, scale, st);
    case 128: return dispatch<128>(instance, q, k, v, o, l, B, Tq, S, Hq, Hkv, group, qs, ks, vs, os, causal, q_offset, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
