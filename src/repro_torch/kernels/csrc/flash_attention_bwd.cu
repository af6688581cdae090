// The backward of causal or full GQA softmax attention, for Hopper.
//
// Replaces the XLA autodiff of attention_chunked
// (src/repro/models/layers.py:68), through which the JAX package trains: no
// JAX kernel has a custom_vjp.  In the port the training forward is the
// flash kernel (flash_attention.cu), so its gradient is a kernel too.
//
// Contract.  q [B, T, Hq, D]; k, v [B, S, Hkv, D]; o and dO [B, T, Hq, D],
// all fp32 or all bf16, read through their (batch, sequence, head) strides
// with unit stride along D; lse [B, Hq, T] fp32, the forward's per-row
// log-sum-exp of the scaled logits (+inf for a row that sees no key).
// Writes dq [B, T, Hq, D] and dk, dv [B, S, Hkv, D] in the inputs' type,
// through their strides, with fp32 accumulation.  Hq is a multiple of Hkv;
// q-head h reads kv-head h / (Hq / Hkv).  Query row i sits at position
// q_offset + i and, when causal, sees keys j <= q_offset + i.  A row that
// sees no key gets zero gradients (P is exp(-inf) = 0 there), not NaN.
//
// The math (FlashAttention-2's backward): with P = exp(S scale - lse)
// recomputed from q, k and lse, and D_i = rowsum(dO_i o O_i),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = dS K scale,  dK = dS^T Q scale,
// summed over the q-heads of each kv-head's group for dK and dV.
//
// Design: simple and right first.  Three kernels on the caller's stream:
//   1. delta: one warp per (b, h, row), D = rowsum(dO o O) in fp32 into a
//      scratch [B, Hq, T] the wrapper allocates.
//   2. dK/dV: a block owns one (batch, kv-head, kv tile) and loops over the
//      group's q-heads and over the q tiles that can see the tile (causal:
//      from the tile's diagonal on).  Per q tile it recomputes S^T = K Q^T
//      and dP^T = V dO^T, forms P^T and dS^T in registers, and accumulates
//      dV += P^T dO and dK += dS^T Q in fp32 registers.  The GQA sum stays
//      inside the block, so no atomics: every run gives the same bits.
//   3. dQ: a block owns one (batch, q-head, q tile) and loops over the kv
//      tiles up to its diagonal, accumulating dQ += dS K.
// bf16 runs on mma.sync m16n8k16 (fp32 accumulators), four warps of 16
// rows, the fragments of the forward's mma_sync instance: P^T and dS^T go
// from the accumulators straight into A fragments, rounded to bf16 as the
// forward rounds P.  Q and dO are staged in shared memory in both layouts
// (row-major for S^T and dP^T, transposed for dK and dV), K transposed for
// dQ.  fp32 runs on the CUDA cores (256 threads, P and dS through shared
// memory).
//
// Bound on an H100 at llama3.2-1b's training shape (bf16 q [4,2048,32,64],
// k and v [4,2048,8,64], causal): the five products take 10 D flops per
// visible (row, key) pair and head, 2.5 times the forward's 68.7 GFLOP,
// 172 GFLOP: 0.174 ms at 989 TFLOP/s; the 84 MB it must move take 0.025 ms,
// so it is bound by operations.  This version is far from it: mma.sync
// reaches about a third of wgmma's rate, each block restages Q and dO for
// every kv tile, and S and dP are computed twice (once per kernel).  The
// fast design, left for a later change: wgmma with TMA-fed operands and a
// persistent grid, dQ accumulated by one kernel over kv tiles in the same
// pass (FlashAttention-3's layout).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, t, h;  // elements between batches, rows, heads
};

// keys the q tile of `rows` rows starting at q0 can see: all of S, or up to
// its last row's diagonal when causal (as the forward's kv_extent)
__device__ __forceinline__ int kv_extent(int q0, int rows, int Tq, int S,
                                         int causal, long long q_offset) {
  if (!causal) return S;
  const long long last = q_offset + min(q0 + rows, Tq) - 1;
  return static_cast<int>(max(0LL, min(static_cast<long long>(S), last + 1)));
}

__device__ __forceinline__ bool visible(long long qpos, int kpos, int causal,
                                        long long q_offset) {
  return !causal || q_offset + qpos >= kpos;
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------ 1. D = rowsum(dO o O)
template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int B, int Tq, int Hq, Strides os,
                 Strides ds) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * Hq * Tq) return;
  const int lane = threadIdx.x % 32;
  const int t = static_cast<int>(row % Tq);
  const int h = static_cast<int>((row / Tq) % Hq);
  const int b = static_cast<int>(row / (static_cast<long long>(Tq) * Hq));
  const T* orow = o + b * os.b + t * os.t + h * os.h;
  const T* drow = dout + b * ds.b + t * ds.t + h * ds.h;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += as_float(orow[d]) * as_float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;  // delta is [B, Hq, T]: row's own index
}

// ------------------------------------------------- bf16: mma.sync tiles
namespace tensor_core {

constexpr int THREADS = 128;  // 4 warps x 16 rows (keys in dK/dV, q in dQ)
constexpr int BKV = 64;       // keys per dK/dV block
constexpr int BQ2 = 64;       // q rows per dQ block
constexpr int BK2 = 64;       // keys per dQ kv tile

// q rows per dK/dV step: 32 at D = 128 keeps S^T, dP^T and the dK, dV
// accumulators inside the register budget
template <int D>
constexpr int kBQ = D >= 128 ? 32 : 64;

template <int D>
constexpr size_t dkdv_smem() {
  constexpr int BQ = kBQ<D>;
  // Ks, Vs [BKV][D+8]; Qs, dOs [BQ][D+8]; Qt, dOt [D][BQ+8]; lse, D [BQ]
  return sizeof(bf16) * (2 * size_t(BKV) * (D + 8) + 2 * size_t(BQ) * (D + 8) +
                         2 * size_t(D) * (BQ + 8)) +
         sizeof(float) * 2 * BQ;
}

template <int D>
constexpr size_t dq_smem() {
  // Qs, dOs [BQ2][D+8]; Ks, Vs [BK2][D+8]; Kt [D][BK2+8]
  return sizeof(bf16) * (2 * size_t(BQ2) * (D + 8) + 2 * size_t(BK2) * (D + 8) +
                         size_t(D) * (BK2 + 8));
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

// 8 consecutive bf16 (zeros when !in); rows are 16-byte aligned (the
// wrapper copies an operand that is not)
__device__ __forceinline__ uint4 load8(const bf16* p, bool in) {
  return in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// the A fragment of rows r, r + 8 and k columns c0 .. c0 + 15 of a
// row-major bf16 tile with `ld` elements a row, read as 32-bit words
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint32_t* w,
                                       int ld, int r, int c0, int t4) {
  a[0] = w[(r * ld + c0 + 2 * t4) / 2];
  a[1] = w[((r + 8) * ld + c0 + 2 * t4) / 2];
  a[2] = w[(r * ld + c0 + 8 + 2 * t4) / 2];
  a[3] = w[((r + 8) * ld + c0 + 8 + 2 * t4) / 2];
}

// the accumulators of n-tiles 2kk and 2kk + 1 (16 x 8 each) as one A
// fragment of their 16 columns, rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// stage `rows` rows of D bf16 from a strided operand into a row-major tile
// [rows][D+8] and, when `tr` is given, its transpose [D][rows+8]
template <int D>
__device__ __forceinline__ void stage(bf16* tile, bf16* tr, const bf16* base,
                                      long long row_stride, int r0, int rows,
                                      int limit, int tid) {
  constexpr int DP = D + 8;
  const int rp = rows + 8;
  for (int e = tid; e < rows * (D / 8); e += THREADS) {
    const int r = e % rows;  // rows fastest: distinct banks per warp
    const int c = e / rows;
    const int gr = r0 + r;
    const uint4 x = load8(base + gr * row_stride + c * 8, gr < limit);
    *reinterpret_cast<uint4*>(tile + r * DP + c * 8) = x;
    if (tr != nullptr) {
      const bf16* xe = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c * 8 + j) * rp + r] = xe[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int S,
                int Hq, int group, Strides qs, Strides ks, Strides vs,
                Strides dos, Strides dks, Strides dvs, int causal,
                long long q_offset, float scale) {
  constexpr int BQ = kBQ<D>;
  constexpr int DP = D + 8;
  constexpr int QP = BQ + 8;
  constexpr int DC = D / 8;   // n-tiles of dK, dV over D
  constexpr int KC = D / 16;  // k steps of S^T, dP^T over D
  constexpr int NQ = BQ / 8;  // n-tiles of S^T, dP^T over q
  extern __shared__ uint4 smem_dkdv[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_dkdv);  // [BKV][DP]
  bf16* Vs = Ks + BKV * DP;                       // [BKV][DP]
  bf16* Qs = Vs + BKV * DP;                       // [BQ][DP]
  bf16* dOs = Qs + BQ * DP;                       // [BQ][DP]
  bf16* Qt = dOs + BQ * DP;                       // [D][QP]
  bf16* dOt = Qt + D * QP;                        // [D][QP]
  float* Ls = reinterpret_cast<float*>(dOt + D * QP);  // [BQ] lse, log2 units
  float* Dl = Ls + BQ;                                 // [BQ] delta
  const uint32_t* Kw = reinterpret_cast<const uint32_t*>(Ks);
  const uint32_t* Vw = reinterpret_cast<const uint32_t*>(Vs);
  const uint32_t* Qw = reinterpret_cast<const uint32_t*>(Qs);
  const uint32_t* dOw = reinterpret_cast<const uint32_t*>(dOs);
  const uint32_t* Qtw = reinterpret_cast<const uint32_t*>(Qt);
  const uint32_t* dOtw = reinterpret_cast<const uint32_t*>(dOt);

  const int k0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int kr = (tid / 32) * 16 + g;  // this thread's key rows kr, kr + 8
  const float scale_log2 = scale * LOG2E;

  stage<D>(Ks, nullptr, k + b * ks.b + hk * ks.h, ks.t, k0, BKV, S, tid);
  stage<D>(Vs, nullptr, v + b * vs.b + hk * vs.h, vs.t, k0, BKV, S, tid);

  float dka[DC][4], dva[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[c][j] = dva[c][j] = 0.f;

  // the first q row that sees any key of this tile
  const long long first = causal ? max(0LL, k0 - q_offset) : 0LL;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int qt0 = first >= Tq ? n_qt : static_cast<int>(first / BQ);

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* db = dout + b * dos.b + h * dos.h;
    const float* lrow = lse + (static_cast<long long>(b) * Hq + h) * Tq;
    const float* drow = delta + (static_cast<long long>(b) * Hq + h) * Tq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last step's reads of the q tiles are done
      stage<D>(Qs, Qt, qb, qs.t, q0, BQ, Tq, tid);
      stage<D>(dOs, dOt, db, dos.t, q0, BQ, Tq, tid);
      for (int e = tid; e < BQ; e += THREADS) {
        const int gq = q0 + e;
        Ls[e] = gq < Tq ? lrow[gq] * LOG2E : INFINITY;
        Dl[e] = gq < Tq ? drow[gq] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: key rows kr, kr + 8, q columns
      // nt*8 + 2*t4 + {0, 1}
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        a_frag(ka, Kw, DP, kr, kc * 16, t4);
        a_frag(va, Vw, DP, kr, kc * 16, t4);
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const int qr = nt * 8 + g;
          mma(s[nt], ka, Qw[(qr * DP + kc * 16 + 2 * t4) / 2],
              Qw[(qr * DP + kc * 16 + 8 + 2 * t4) / 2]);
          mma(dp[nt], va, dOw[(qr * DP + kc * 16 + 2 * t4) / 2],
              dOw[(qr * DP + kc * 16 + 8 + 2 * t4) / 2]);
        }
      }

      // P^T = exp(S^T scale - lse) on visible pairs, dS^T = P^T o (dP^T - D)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kpos = k0 + kr + 8 * rr;
            const int col = nt * 8 + 2 * t4 + j;
            const int qpos = q0 + col;
            const bool ok = kpos < S && qpos < Tq &&
                            visible(qpos, kpos, causal, q_offset);
            const float p =
                ok ? exp2f(s[nt][2 * rr + j] * scale_log2 - Ls[col]) : 0.f;
            s[nt][2 * rr + j] = p;
            dp[nt][2 * rr + j] = p * (dp[nt][2 * rr + j] - Dl[col]);
          }

      // dV += P^T dO and dK += dS^T Q over this tile's q rows
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int dr = c * 8 + g;
          mma(dva[c], pa, dOtw[(dr * QP + kk * 16 + 2 * t4) / 2],
              dOtw[(dr * QP + kk * 16 + 8 + 2 * t4) / 2]);
          mma(dka[c], sa, Qtw[(dr * QP + kk * 16 + 2 * t4) / 2],
              Qtw[(dr * QP + kk * 16 + 8 + 2 * t4) / 2]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int gk = k0 + kr + 8 * rr;
    if (gk >= S) continue;
    bf16* krow = dk + b * dks.b + gk * dks.t + hk * dks.h;
    bf16* vrow = dv + b * dvs.b + gk * dvs.t + hk * dvs.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      *reinterpret_cast<uint32_t*>(krow + c * 8 + 2 * t4) =
          pack(dka[c][2 * rr] * scale, dka[c][2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + c * 8 + 2 * t4) =
          pack(dva[c][2 * rr], dva[c][2 * rr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Tq, int S, int Hq, int group,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              int causal, long long q_offset, float scale) {
  constexpr int DP = D + 8;
  constexpr int KP = BK2 + 8;
  constexpr int DC = D / 8;    // n-tiles of dQ over D
  constexpr int KC = D / 16;   // k steps of S, dP over D
  constexpr int NT = BK2 / 8;  // n-tiles of S, dP over keys
  extern __shared__ uint4 smem_dq[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dq);  // [BQ2][DP]
  bf16* dOs = Qs + BQ2 * DP;                    // [BQ2][DP]
  bf16* Ks = dOs + BQ2 * DP;                    // [BK2][DP]
  bf16* Vs = Ks + BK2 * DP;                     // [BK2][DP]
  bf16* Kt = Vs + BK2 * DP;                     // [D][KP]
  const uint32_t* Qw = reinterpret_cast<const uint32_t*>(Qs);
  const uint32_t* dOw = reinterpret_cast<const uint32_t*>(dOs);
  const uint32_t* Kw = reinterpret_cast<const uint32_t*>(Ks);
  const uint32_t* Vw = reinterpret_cast<const uint32_t*>(Vs);
  const uint32_t* Ktw = reinterpret_cast<const uint32_t*>(Kt);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ2;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int r0 = (tid / 32) * 16 + g;  // this thread's rows r0, r0 + 8
  const int hk = h / group;
  const float scale_log2 = scale * LOG2E;

  stage<D>(Qs, nullptr, q + b * qs.b + h * qs.h, qs.t, q0, BQ2, Tq, tid);
  stage<D>(dOs, nullptr, dout + b * dos.b + h * dos.h, dos.t, q0, BQ2, Tq, tid);
  float l2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int gq = q0 + r0 + 8 * rr;
    const long long at = (static_cast<long long>(b) * Hq + h) * Tq + gq;
    l2[rr] = gq < Tq ? lse[at] * LOG2E : INFINITY;
    dl[rr] = gq < Tq ? delta[at] : 0.f;
  }

  float dqa[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[c][j] = 0.f;

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int kv_end = kv_extent(q0, BQ2, Tq, S, causal, q_offset);
  for (int k0 = 0; k0 < kv_end; k0 += BK2) {
    __syncthreads();  // the last tile's reads of Ks, Vs and Kt are done
    stage<D>(Ks, Kt, kb, ks.t, k0, BK2, S, tid);
    stage<D>(Vs, nullptr, vb, vs.t, k0, BK2, S, tid);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], da[4];
      a_frag(qa, Qw, DP, r0, kc * 16, t4);
      a_frag(da, dOw, DP, r0, kc * 16, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int kr = nt * 8 + g;
        mma(s[nt], qa, Kw[(kr * DP + kc * 16 + 2 * t4) / 2],
            Kw[(kr * DP + kc * 16 + 8 + 2 * t4) / 2]);
        mma(dp[nt], da, Vw[(kr * DP + kc * 16 + 2 * t4) / 2],
            Vw[(kr * DP + kc * 16 + 8 + 2 * t4) / 2]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qpos = q0 + r0 + 8 * rr;
          const int kpos = k0 + nt * 8 + 2 * t4 + j;
          const bool ok = kpos < S && qpos < Tq &&
                          visible(qpos, kpos, causal, q_offset);
          const float p =
              ok ? exp2f(s[nt][2 * rr + j] * scale_log2 - l2[rr]) : 0.f;
          dp[nt][2 * rr + j] = p * (dp[nt][2 * rr + j] - dl[rr]);
        }
    // dQ += dS K over this tile's keys
#pragma unroll
    for (int kk = 0; kk < BK2 / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dr = c * 8 + g;
        mma(dqa[c], sa, Ktw[(dr * KP + kk * 16 + 2 * t4) / 2],
            Ktw[(dr * KP + kk * 16 + 8 + 2 * t4) / 2]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int gq = q0 + r0 + 8 * rr;
    if (gq >= Tq) continue;
    bf16* row = dq + b * dqs.b + gq * dqs.t + h * dqs.h;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<uint32_t*>(row + c * 8 + 2 * t4) =
          pack(dqa[c][2 * rr] * scale, dqa[c][2 * rr + 1] * scale);
  }
}

}  // namespace tensor_core

// ------------------------------------------------ fp32: CUDA-core FMAs
namespace cuda_core {

constexpr int THREADS = 256;  // (tid / 8) owns a row, (tid % 8) its columns
constexpr int TILE = 32;      // keys (dK/dV) or q rows (dQ) per block, and
                              // the other side's rows per step

template <int D>
constexpr size_t smem_bytes() {
  // four [TILE][D+1] operand tiles, two [TILE][TILE+1] P/dS tiles, lse, D
  return sizeof(float) * (4 * size_t(TILE) * (D + 1) +
                          2 * size_t(TILE) * (TILE + 1) + 2 * TILE);
}

template <int D>
__device__ __forceinline__ void stage(float* tile, const float* base,
                                      long long row_stride, int r0, int limit,
                                      int tid) {
  for (int e = tid; e < TILE * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int gr = r0 + r;
    tile[r * (D + 1) + d] = gr < limit ? base[gr * row_stride + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int Tq, int S,
                int Hq, int group, Strides qs, Strides ks, Strides vs,
                Strides dos, Strides dks, Strides dvs, int causal,
                long long q_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int TP = TILE + 1;
  constexpr int DJ = D / 8;  // dK, dV columns per thread
  extern __shared__ float smem_cc[];
  float* Ks = smem_cc;            // [TILE][DP]
  float* Vs = Ks + TILE * DP;     // [TILE][DP]
  float* Qs = Vs + TILE * DP;     // [TILE][DP]
  float* dOs = Qs + TILE * DP;    // [TILE][DP]
  float* Ps = dOs + TILE * DP;    // [key][q]
  float* dSs = Ps + TILE * TP;    // [key][q]
  float* Ls = dSs + TILE * TP;    // [TILE]
  float* Dl = Ls + TILE;          // [TILE]

  const int k0 = blockIdx.x * TILE;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / 8;      // key row of S^T and of dK, dV
  const int sub = tid % 8;      // q columns sub*4 .. +3; D columns sub + 8 j
  stage<D>(Ks, k + b * ks.b + hk * ks.h, ks.t, k0, S, tid);
  stage<D>(Vs, v + b * vs.b + hk * vs.h, vs.t, k0, S, tid);

  float dka[DJ], dva[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dka[j] = dva[j] = 0.f;
  const long long first = causal ? max(0LL, k0 - q_offset) : 0LL;
  const int n_qt = (Tq + TILE - 1) / TILE;
  const int qt0 = first >= Tq ? n_qt : static_cast<int>(first / TILE);

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const float* lrow = lse + (static_cast<long long>(b) * Hq + h) * Tq;
    const float* drow = delta + (static_cast<long long>(b) * Hq + h) * Tq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();
      stage<D>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, Tq, tid);
      stage<D>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, Tq, tid);
      for (int e = tid; e < TILE; e += THREADS) {
        Ls[e] = q0 + e < Tq ? lrow[q0 + e] : INFINITY;
        Dl[e] = q0 + e < Tq ? drow[q0 + e] : 0.f;
      }
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float kd = Ks[row * DP + d];
        const float vd = Vs[row * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] = fmaf(kd, Qs[(sub * 4 + i) * DP + d], s[i]);
          dp[i] = fmaf(vd, dOs[(sub * 4 + i) * DP + d], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = sub * 4 + i;
        const int kpos = k0 + row;
        const int qpos = q0 + col;
        const bool ok =
            kpos < S && qpos < Tq && visible(qpos, kpos, causal, q_offset);
        const float p = ok ? expf(s[i] * scale - Ls[col]) : 0.f;
        Ps[row * TP + col] = p;
        dSs[row * TP + col] = p * (dp[i] - Dl[col]);
      }
      __syncthreads();
      for (int c = 0; c < TILE; ++c) {
        const float p = Ps[row * TP + c];
        const float ds = dSs[row * TP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dva[j] = fmaf(p, dOs[c * DP + sub + 8 * j], dva[j]);
          dka[j] = fmaf(ds, Qs[c * DP + sub + 8 * j], dka[j]);
        }
      }
    }
  }
  const int gk = k0 + row;
  if (gk < S) {
    float* krow = dk + b * dks.b + gk * dks.t + hk * dks.h;
    float* vrow = dv + b * dvs.b + gk * dvs.t + hk * dvs.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[sub + 8 * j] = dka[j] * scale;
      vrow[sub + 8 * j] = dva[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Tq, int S, int Hq, int group,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              int causal, long long q_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int TP = TILE + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem_cq[];
  float* Qs = smem_cq;            // [TILE][DP]
  float* dOs = Qs + TILE * DP;    // [TILE][DP]
  float* Ks = dOs + TILE * DP;    // [TILE][DP]
  float* Vs = Ks + TILE * DP;     // [TILE][DP]
  float* dSs = Vs + TILE * DP;    // [q][key]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * TILE;
  const int tid = threadIdx.x;
  const int row = tid / 8;   // q row of S and of dQ
  const int sub = tid % 8;   // keys sub*4 .. +3; D columns sub + 8 j
  const int hk = h / group;
  stage<D>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, Tq, tid);
  stage<D>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, Tq, tid);
  const int gq = q0 + row;
  const long long at = (static_cast<long long>(b) * Hq + h) * Tq + gq;
  const float lrow = gq < Tq ? lse[at] : INFINITY;
  const float drow = gq < Tq ? delta[at] : 0.f;

  float dqa[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dqa[j] = 0.f;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int kv_end = kv_extent(q0, TILE, Tq, S, causal, q_offset);
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();
    stage<D>(Ks, kb, ks.t, k0, S, tid);
    stage<D>(Vs, vb, vs.t, k0, S, tid);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[row * DP + d];
      const float dd = dOs[row * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(qd, Ks[(sub * 4 + i) * DP + d], s[i]);
        dp[i] = fmaf(dd, Vs[(sub * 4 + i) * DP + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + sub * 4 + i;
      const bool ok = kpos < S && gq < Tq && visible(gq, kpos, causal, q_offset);
      const float p = ok ? expf(s[i] * scale - lrow) : 0.f;
      dSs[row * TP + sub * 4 + i] = p * (dp[i] - drow);
    }
    __syncthreads();
    for (int c = 0; c < TILE; ++c) {
      const float ds = dSs[row * TP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqa[j] = fmaf(ds, Ks[c * DP + sub + 8 * j], dqa[j]);
    }
  }
  if (gq < Tq) {
    float* out = dq + b * dqs.b + gq * dqs.t + h * dqs.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[sub + 8 * j] = dqa[j] * scale;
  }
}

}  // namespace cuda_core

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Tq, S, Hq, Hkv, group;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal;
  long long q_offset;
  float scale;
  cudaStream_t st;
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int D>
int run_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.Tq;
  if (rows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  delta_kernel<T, D><<<blocks, 256, 0, a.st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.B,
      a.Tq, a.Hq, a.os, a.dos);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_bf16(const Args& a) {
  using namespace tensor_core;
  int err = run_delta<bf16, D>(a);
  if (err) return err;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  if (a.S > 0) {  // with T = 0, dK and dV are written as zeros
    if ((err = set_smem(dkdv_kernel<D>, dkdv_smem<D>()))) return err;
    dkdv_kernel<D><<<dim3((a.S + BKV - 1) / BKV, a.Hkv, a.B), THREADS,
                     dkdv_smem<D>(), a.st>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.Tq, a.S, a.Hq, a.group, a.qs, a.ks, a.vs,
        a.dos, a.dks, a.dvs, a.causal, a.q_offset, a.scale);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (a.Tq == 0) return 0;
  if ((err = set_smem(dq_kernel<D>, dq_smem<D>()))) return err;
  dq_kernel<D><<<dim3((a.Tq + BQ2 - 1) / BQ2, a.Hq, a.B), THREADS, dq_smem<D>(),
                 a.st>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq),
                         a.Tq, a.S, a.Hq, a.group, a.qs, a.ks, a.vs, a.dos,
                         a.dqs, a.causal, a.q_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_fp32(const Args& a) {
  using namespace cuda_core;
  int err = run_delta<float, D>(a);
  if (err) return err;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  if (a.S > 0) {
    if ((err = set_smem(dkdv_kernel<D>, smem_bytes<D>()))) return err;
    dkdv_kernel<D><<<dim3((a.S + TILE - 1) / TILE, a.Hkv, a.B), THREADS,
                     smem_bytes<D>(), a.st>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.Tq, a.S, a.Hq, a.group, a.qs, a.ks, a.vs,
        a.dos, a.dks, a.dvs, a.causal, a.q_offset, a.scale);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (a.Tq == 0) return 0;
  if ((err = set_smem(dq_kernel<D>, smem_bytes<D>()))) return err;
  dq_kernel<D><<<dim3((a.Tq + TILE - 1) / TILE, a.Hq, a.B), THREADS,
                 smem_bytes<D>(), a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Tq, a.S,
      a.Hq, a.group, a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.q_offset,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run(int instance, const Args& a) {
  return instance == 1 ? run_bf16<D>(a) : run_fp32<D>(a);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `instance` 0 takes fp32
// operands (CUDA cores), 1 bf16 (mma.sync).  Strides are in elements, in
// the order (batch, sequence, head), for q, k, v, o, dO, dq, dk, dv; D has
// unit stride, and in bf16 every row is 16-byte aligned.  lse and the
// scratch `delta` are contiguous fp32 [B, Hq, Tq].  Launches the three
// kernels on `stream` and returns cudaGetLastError() after the last, the
// first error, or cudaErrorInvalidValue for a head dim without an instance
// (32, 64, 128), an unknown instance, a head count that is not a multiple
// of the kv heads, or a grid too large.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int instance, int B, int Tq, int S, int Hq, int Hkv, int D,
    long long qsb, long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh, long long osb,
    long long ost, long long osh, long long dosb, long long dost,
    long long dosh, long long dqsb, long long dqst, long long dqsh,
    long long dksb, long long dkst, long long dksh, long long dvsb,
    long long dvst, long long dvsh, int causal, long long q_offset,
    float scale, void* stream) {
  if (B == 0 || Hq == 0 || (Tq == 0 && S == 0)) return 0;
  if (instance < 0 || instance > 1 || Hkv < 1 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535 || Tq < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv, B, Tq, S, Hq, Hkv, Hq / Hkv,
         Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh},
         Strides{osb, ost, osh}, Strides{dosb, dost, dosh},
         Strides{dqsb, dqst, dqsh}, Strides{dksb, dkst, dksh},
         Strides{dvsb, dvst, dvsh}, causal, q_offset, scale,
         static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return run<32>(instance, a);
    case 64: return run<64>(instance, a);
    case 128: return run<128>(instance, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
