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
// l == 0 guard).
//
// Design.  The TPU kernel walks the kv blocks as a sequential grid axis and
// keeps the output tile and its softmax statistics resident in VMEM.  Hopper
// blocks carry nothing between them, so here one block owns one (batch,
// q-head, 64-row q tile) and loops over 64-row kv tiles itself.  kv tiles
// wholly above the diagonal are never loaded, and blocks are issued heaviest
// q tile first so the causal triangle's long rows do not trail.  Two
// instances of that schedule:
//   * bf16 (the serve path): 4 warps, each owning 16 q rows.  The q tile is
//     staged once and kept in registers as mma A fragments; per kv tile, K
//     (row-major) and V (transposed, d-major) are staged in shared memory
//     with padded rows, S = q k^T and O += P V run as mma.sync m16n8k16 bf16
//     tensor-core products with fp32 accumulators, and P never leaves the
//     registers: the S accumulators of two adjacent 8-key tiles are exactly
//     the A fragment of one 16-key step.  Row max and sum reduce over the
//     four lanes that share a row.  P is rounded to bf16 for the P V
//     product, as the reference's attention_chunked does.
//   * fp32: 256 threads, each computing a 4x4 micro-tile of S with fp32 FMAs
//     on the CUDA cores from shared memory; P goes through shared memory.
//
// Bound on an H100 at the serve path's shape (bf16, B 1, T = S = 2048,
// Hq 32, Hkv 8, D 64, causal): 2 T^2 D Hq = 17.2 GFLOP against 989 TFLOP/s
// of bf16 tensor cores is 17.4 us, and the 21.0 MB it must move take 6.3 us
// at 3.35 TB/s, so the work is bound by operations.  mma.sync reaches only
// part of that peak (wgmma is the full-rate path), and this version neither
// overlaps its tile loads with the products (cp.async/TMA) nor splits the
// work into producer and consumer warps; those are the later steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv rows per tile

struct Strides {
  long long b, t, h;  // elements between batches, rows, heads
};

// keys the q tile starting at q0 can see: all of S, or up to its last row's
// diagonal when causal
__device__ __forceinline__ int kv_extent(int q0, int Tq, int S, int causal,
                                         int q_offset) {
  if (!causal) return S;
  const long long last = static_cast<long long>(q_offset) + min(q0 + BQ, Tq) - 1;
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
                      const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
                      int S, int group, Strides qs, Strides ks, Strides vs,
                      Strides os, int causal, int q_offset, float scale) {
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

  const int kv_end = kv_extent(q0, Tq, S, causal, q_offset);
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
    bf16* orow = o + b * os.b + gq * os.t + h * os.h;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * t4) =
          pack(oacc[c][2 * rr] * inv, oacc[c][2 * rr + 1] * inv);
  }
}

template <int D, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq,
           int S, int Hq, int group, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_bf16_kernel<D, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Tq, S, group, qs, ks,
      vs, os, causal, q_offset, scale);
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
                      const float* __restrict__ v, float* __restrict__ o, int Tq,
                      int S, int group, Strides qs, Strides ks, Strides vs,
                      Strides os, int causal, int q_offset, float scale) {
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

  const int kv_end = kv_extent(q0, Tq, S, causal, q_offset);
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
    float* orow = o + b * os.b + gq * os.t + h * os.h + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq,
           int S, int Hq, int group, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fp32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, S, group, qs,
      ks, vs, os, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_core

// 16-byte loads need 16-byte aligned rows: base pointers and every stride a
// multiple of 8 bf16
bool aligned8(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.t % 8 == 0 && s.h % 8 == 0;
}

template <int D>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* o,
             int B, int Tq, int S, int Hq, int group, const Strides& qs,
             const Strides& ks, const Strides& vs, const Strides& os,
             int causal, int q_offset, float scale, cudaStream_t st) {
  if (dtype == 0)
    return cuda_core::launch<D>(q, k, v, o, B, Tq, S, Hq, group, qs, ks, vs, os,
                         causal, q_offset, scale, st);
  if (aligned8(q, qs) && aligned8(k, ks) && aligned8(v, vs))
    return tensor_core::launch<D, true>(q, k, v, o, B, Tq, S, Hq, group, qs, ks,
                                        vs, os, causal, q_offset, scale, st);
  return tensor_core::launch<D, false>(q, k, v, o, B, Tq, S, Hq, group, qs, ks,
                                       vs, os, causal, q_offset, scale, st);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 is fp32, 1 is bf16.
// Strides are in elements, in the order (batch, sequence, head); D has unit
// stride, and the output (bf16) is 4-byte aligned with even strides.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a head dim without an instance (32, 64, 128), a dtype other than 0 or 1, a
// head count that is not a multiple of the kv heads, or a grid too large.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Tq, int S, int Hq, int Hkv, int D, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
    long long vst, long long vsh, long long osb, long long ost, long long osh,
    int causal, int q_offset, float scale, void* stream) {
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  if ((dtype != 0 && dtype != 1) || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      os{osb, ost, osh};
  auto st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  switch (D) {
    case 32: return dispatch<32>(dtype, q, k, v, o, B, Tq, S, Hq, group, qs, ks, vs, os, causal, q_offset, scale, st);
    case 64: return dispatch<64>(dtype, q, k, v, o, B, Tq, S, Hq, group, qs, ks, vs, os, causal, q_offset, scale, st);
    case 128: return dispatch<128>(dtype, q, k, v, o, B, Tq, S, Hq, group, qs, ks, vs, os, causal, q_offset, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
