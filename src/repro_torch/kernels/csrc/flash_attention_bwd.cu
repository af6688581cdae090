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
// Design.  Three instances; kernels/flash_attention.py's choose_bwd_instance
// picks one before any launch.  Each runs a Delta pass and then two
// kernels, dK/dV and dQ, so no gradient is summed across blocks: no
// atomics, and every run gives the same bits (the train phase's bit-exact
// resume relies on it).  That is choice (a) of the two deterministic
// layouts: FlashAttention-3's single pass would accumulate dQ across the
// kv-tile blocks in an fp32 scratch in an order fixed by a semaphore; the
// two passes instead recompute S and dP in the dQ kernel, 7 products' work
// for 5.
//   0. delta: D = rowsum(dO o O) in fp32 into a scratch [B, Hq, Tpad]
//      (bf16: D / 8 lanes a row, 16-byte loads; fp32: a warp a row); for
//      the wgmma instance also lse in log2 units into a second scratch,
//      rows t >= T padded (lse +inf, D 0) up to Tpad, a multiple of 128,
//      so that every q tile reads whole lines.
//   * wgmma (bf16, D 64 and 128, every operand's rows, bases and strides
//     16-byte aligned: the training path).  Both kernels have two
//     warpgroups of 64 rows and no producer warp: ptxas sizes a wgmma
//     kernel's registers by whole warpgroups, so a producer warp cost a
//     third warpgroup's share and left 168 registers a thread, which
//     spilled the D = 128 dK/dV step and serialized its wgmma; with 256
//     threads each may have 255.  TMA copies (128-byte swizzle) fill a
//     four-stage ring behind full mbarriers: thread 0 issues the first
//     four, and the warp that is the last of the eight to finish a step (a
//     counter per stage in shared memory) refills its stage, so no warp
//     waits for another.  (Thread 0 refilling with a wait of its own
//     coupled the warpgroups and was slower; the producer-warp layout was
//     faster at D = 64 alone: PERF.md.)
//     dK/dV: a block owns one (batch, kv-head, 128-key tile), each
//     consumer 64 of its keys, K and V loaded once; it walks the group's
//     q-heads and, per head, the 64-row q tiles that can see the tile
//     (causal: from the tile's diagonal on), so the GQA sum stays in the
//     block.  A stage holds a q tile's Q and dO and its lse and D (1-D
//     bulk copies from the padded scratch).  Per stage: S^T = K Q^T and
//     dP^T = V dO^T as wgmma m64n64k16 with both operands K-major in shared
//     memory; P^T = exp2(S^T scale log2e - lse) (ex2.approx) and dS^T =
//     P^T o (dP^T - D) on the fp32 accumulators, the mask only on q tiles
//     that cross the warpgroup's diagonal; then dV += P^T dO and dK += dS^T
//     Q as wgmma m64nDk16 with P^T and dS^T from registers (the S^T
//     accumulators of 16 q rows are the A fragment, rounded to bf16) and
//     dO and Q read MN-major from the same stage: the transposes cost no
//     store.  dK and dV stay in fp32 registers until the end.
//     dQ: a block owns one (batch, q-head, 128-row q tile), Q and dO
//     loaded once, and walks 64-key K and V tiles up to its diagonal:
//     S = Q K^T and dP = dO V^T (m64n64k16, K-major), dS = P o (dP - D),
//     dQ += dS K with K read MN-major.  Rows past T and rows that see no
//     key have lse +inf, so P = 0 there and their gradients are 0, not
//     NaN; keys past S are masked in dQ and never stored in dK/dV.
//     In dQ, S and dP are two commit groups, so P is formed while dP is
//     on the tensor cores; in dK/dV the same split (and dV issued before
//     dS^T) measured slower, so each pair is one group there.  The two
//     warpgroups overlap each other.
//   * mma_sync (bf16 otherwise, and D = 32): mma.sync m16n8k16 (fp32
//     accumulators), four warps of 16 rows, the fragments of the forward's
//     mma_sync instance: P^T and dS^T go from the accumulators straight
//     into A fragments, rounded to bf16 as the forward rounds P.  Q and dO
//     are staged in shared memory in both layouts (row-major for S^T and
//     dP^T, transposed for dK and dV), K transposed for dQ.
//   * cuda_core (fp32): 256 threads, P and dS through shared memory.
//
// Bound on an H100 at llama3.2-1b's training shape (bf16 q [4,2048,32,64],
// k and v [4,2048,8,64], causal): the five products take 10 D flops per
// visible (row, key) pair and head, 2.5 times the forward's 68.7 GFLOP,
// 172 GFLOP: 0.174 ms at 989 TFLOP/s; the 84 MB it must move take 0.025 ms,
// so it is bound by operations, and wgmma is the only full-rate path.
// What holds the wgmma instance back: the two passes' 7 products for 5;
// each step still ends on a wait for its last product (no overlap across
// steps inside a warpgroup); the diagonal tiles are computed whole and
// masked; and one exponential per (row, key) pair and head on 16
// special-function lanes per SM, twice (once per pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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

// ------------------------------------------------ 0. D = rowsum(dO o O)
// delta is [B, Hq, Tpad]; rows t >= Tq get 0.  When lse2 is not null it
// gets lse in log2 units in the same layout, +inf on those rows (the
// wgmma instance reads both a q tile at a time).
template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ lse2, int B, int Tq, int Tpad, int Hq,
                 Strides os, Strides ds) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * Hq * Tpad) return;
  const int lane = threadIdx.x % 32;
  const int t = static_cast<int>(row % Tpad);
  const long long bh = row / Tpad;
  const int h = static_cast<int>(bh % Hq);
  const int b = static_cast<int>(bh / Hq);
  if (t >= Tq) {
    if (lane == 0) {
      delta[row] = 0.f;
      if (lse2 != nullptr) lse2[row] = INFINITY;
    }
    return;
  }
  const T* orow = o + b * os.b + t * os.t + h * os.h;
  const T* drow = dout + b * ds.b + t * ds.t + h * ds.h;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += as_float(orow[d]) * as_float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    if (lse2 != nullptr) lse2[row] = lse[bh * Tq + t] * LOG2E;
  }
}

// The same for bf16, whose rows are 16-byte aligned: D / 8 lanes a row,
// each loading 8 elements of O and of dO in one 16-byte load
template <int D>
__global__ void __launch_bounds__(256)
    delta_bf16_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      float* __restrict__ lse2, int B, int Tq, int Tpad, int Hq,
                      Strides os, Strides ds) {
  constexpr int LPR = D / 8;     // lanes a row
  constexpr int RPW = 32 / LPR;  // rows a warp
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32) * RPW +
      (threadIdx.x % 32) / LPR;
  const int sub = threadIdx.x % LPR;
  const bool in = row < static_cast<long long>(B) * Hq * Tpad;
  const int t = static_cast<int>(row % Tpad);
  const long long bh = row / Tpad;
  const int h = static_cast<int>(bh % Hq);
  const int b = static_cast<int>(bh / Hq);
  float acc = 0.f;
  if (in && t < Tq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + t * os.t +
                                                     h * os.h + 8 * sub);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * ds.b + t * ds.t +
                                                     h * ds.h + 8 * sub);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += as_float(oe[j]) * as_float(de[j]);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, LPR);
  if (in && sub == 0) {
    delta[row] = acc;  // 0 for rows t >= Tq
    if (lse2 != nullptr) lse2[row] = t < Tq ? lse[bh * Tq + t] * LOG2E : INFINITY;
  }
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

// --------------------------------- bf16 on Hopper: TMA ring and wgmma
namespace wgmma_tc {

using namespace hopper;

// Two warpgroups and no producer warp: ptxas sizes the registers of a
// kernel that issues wgmma by whole warpgroups, so a producer warp would
// cost a third warpgroup's share (168 registers a thread); at 256 threads
// each may have 255.  Thread 0 issues the first STAGES stages' copies;
// after that, whichever warp is the last to finish a step refills its
// stage (release below).
constexpr int CONSUMERS = 2;                       // warpgroups of BR rows
constexpr int THREADS = CONSUMERS * 128;
constexpr int STAGES = 4;                          // ring depth
constexpr int SW = 128;                            // TMA swizzle span, bytes
constexpr int CE = SW / 2;                         // bf16 per box row
constexpr int BR = 64;   // rows per consumer; q rows (dK/dV) or keys (dQ) a stage
constexpr int BB = CONSUMERS * BR;  // keys (dK/dV) or q rows (dQ) per block

template <int D>
struct Geometry {
  static constexpr int BIG = BB * D * 2;    // a tile of BB rows
  static constexpr int SMALL = BR * D * 2;  // a tile of BR rows
  // two BR-row tiles, then (dK/dV) the q tile's lse and D; 1024-aligned
  static constexpr int STAGE = 2 * SMALL + 1024;
  static constexpr size_t SMEM =
      1024 + 2 * size_t(BIG) + STAGES * size_t(STAGE) + 8 * (1 + 2 * STAGES);
};

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the box at (col, t, h, b) of a map whose (t, h, b) dims are ordered by
// stride (see operand_map; 2 bits apiece: t in bits 0-1, h 2-3, b 4-5)
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

// `rows` rows of D bf16 from row t: D / CE boxes, box c at dst + c rows SW
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, uint32_t order,
                                         int rows, int t, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / CE; ++c)
    tma_rows(dst + c * rows * SW, map, bar, order, c * CE, t, h, b);
}

// wgmma descriptors of k-step kk of a tile whose boxes hold `rows` rows:
// K-major (16 columns of D from `tile`, which may start inside a box at a
// multiple of 8 rows), and MN-major (16 rows, all D columns: the
// transposed read)
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int rows,
                                          int kk) {
  return smem_desc(tile + ((16 * kk) / CE) * rows * SW + ((16 * kk) % CE) * 2,
                   16, 8 * SW, SW);
}
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int rows,
                                           int kk) {
  return smem_desc(tile + kk * 16 * SW, rows * SW, 8 * SW, SW);
}

// acc[64 x D] += A (registers) B[16 x D] (MN-major)
template <int D>
__device__ __forceinline__ void rs_wgmma(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_bf16_rs_n64(acc, a, db);
  } else {
    wgmma_bf16_rs_n128(acc, a, db);
  }
}

// the fp32 accumulators of a 64 x BR product as BR / 16 bf16 A fragments:
// columns 16 kk .. 16 kk + 15 are the A fragment of k-step kk
__device__ __forceinline__ void to_frags(uint32_t (&f)[BR / 16][4],
                                         const float (&acc)[BR / 2]) {
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = tensor_core::pack(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

template <typename T, int N>
__device__ __forceinline__ void zero(T (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = T(0);
}

// The end of step i for one warp: its lane 0 counts the warp in
// done[stage], and the last of the block's 8 warps to finish the step
// refills the stage with step i + STAGES (`issue(j)` loads step j into
// stage j % STAGES).  No warp ever waits for another.
template <typename Issue>
__device__ __forceinline__ void release(uint32_t* done, int i, int n,
                                        const Issue& issue) {
  static_assert(CONSUMERS * 4 == 8, "the count below takes 8 warps a use");
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    __threadfence_block();
    if ((atomicAdd(&done[i % STAGES], 1u) & 7u) == 7u) {  // the last warp
      __threadfence_block();
      if (i + STAGES < n) {
        fence_proxy_async();
        issue(i + STAGES);
      }
    }
  }
  __syncwarp();
}

// One dK/dV consumer warpgroup: BR keys, their dK and dV accumulators,
// and its step over the ring's stage i (q rows q0 .. q0 + BR - 1 of one
// q-head).  MASK steps are the q tiles with a row that does not see every
// key of the warpgroup; the others run no mask code.
template <int D>
struct DkdvConsumer {
  using G = Geometry<D>;
  const uint8_t* Kw;  // this warpgroup's BR keys of the K and V tiles
  const uint8_t* Vw;
  const uint8_t* ring;
  uint64_t* full;
  int t4, krow;  // this thread's keys krow, krow + 8
  long long q_offset;
  float scale_log2;
  float dka[D / 2], dva[D / 2];
  float sacc[BR / 2], dpacc[BR / 2];  // S^T then P^T; dP^T then dS^T
  uint32_t pf[BR / 16][4], sf[BR / 16][4];

  // One commit group for S^T and dP^T, one for dV and dK: splitting them
  // so that P^T is formed while dP^T runs was slower on the H100 (PERF.md)
  template <bool MASK>
  __device__ __forceinline__ void step(int i, int q0) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* Qt = ring + s * G::STAGE;
    const uint8_t* dOt = Qt + G::SMALL;
    const float* Ls = reinterpret_cast<const float*>(Qt + 2 * G::SMALL);
    const float* Dl = Ls + BR;
    // S^T = K Q^T and dP^T = V dO^T, both operands K-major
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_bf16_ss_n64(sacc, kmajor(Kw, BB, kc), kmajor(Qt, BR, kc),
                        kc > 0 ? 1 : 0);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_bf16_ss_n64(dpacc, kmajor(Vw, BB, kc), kmajor(dOt, BR, kc),
                        kc > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);
    // P^T = exp2(S^T scale log2e - lse) and dS^T = P^T o (dP^T - D): the
    // accumulator of column c is q row q0 + c (lse +inf past T and for
    // rows that see no key: P = 0)
#pragma unroll
    for (int c8 = 0; c8 < BR / 8; ++c8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * c8 + 2 * t4 + j;
        const float l2 = Ls[col];
        const float dl = Dl[col];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 4 * c8 + 2 * rr + j;
          float p = ex2(sacc[e] * scale_log2 - l2);
          if constexpr (MASK)
            p = q_offset + q0 + col >= krow + 8 * rr ? p : 0.f;
          sacc[e] = p;
          dpacc[e] = p * (dpacc[e] - dl);
        }
      }
    to_frags(pf, sacc);
    to_frags(sf, dpacc);
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) rs_wgmma<D>(dva, pf[kk], mnmajor(dOt, BR, kk));
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) rs_wgmma<D>(dka, sf[kk], mnmajor(Qt, BR, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {  // the A operands stay live until
      fence_regs(pf[kk]);                   // their products are done
      fence_regs(sf[kk]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Tq, int Tpad, int S, int Hq,
                      int group, Strides dks, Strides dvs, uint32_t qord,
                      uint32_t kord, uint32_t vord, uint32_t dord, int causal,
                      long long q_offset, float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_bw[];
  // swizzled tiles repeat every 8 rows of SW bytes: align to 1024
  uint8_t* Ks = smem_bw + ((1024 - (smem_u32(smem_bw) & 1023)) & 1023);
  uint8_t* Vs = Ks + G::BIG;
  uint8_t* ring = Vs + G::BIG;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE);
  uint64_t* full = kvbar + 1;
  uint32_t* done = reinterpret_cast<uint32_t*>(full + STAGES);

  const int k0 = blockIdx.x * BB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  // the warp index through a shuffle: uniform to the compiler (wgmma on a
  // path it takes for divergent is serialized)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  // the q tiles from the one that holds the first row seeing a key of the
  // block, for each q-head of the group: n steps in all
  const long long first = causal ? max(0LL, k0 - q_offset) : 0LL;
  const int n_qt = (Tq + BR - 1) / BR;
  const int qt0 = first >= Tq ? n_qt : static_cast<int>(first / BR);
  const int per_head = n_qt - qt0;
  const int n = group * per_head;

  // step j's q tile, dO tile, lse and D into stage j % STAGES
  auto issue = [&](int j) {
    const int s = j % STAGES;
    const int h = hk * group + j / per_head;
    const int q0 = (qt0 + j % per_head) * BR;
    const long long at = (static_cast<long long>(b) * Hq + h) * Tpad + q0;
    uint8_t* st = ring + s * G::STAGE;
    mbar_expect_tx(&full[s], 2 * G::SMALL + 2 * BR * 4);
    tma_tile<D>(st, &qmap, &full[s], qord, BR, q0, h, b);
    tma_tile<D>(st + G::SMALL, &dmap, &full[s], dord, BR, q0, h, b);
    bulk_load(st + 2 * G::SMALL, lse2 + at, BR * 4, &full[s]);
    bulk_load(st + 2 * G::SMALL + BR * 4, delta + at, BR * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_expect_tx(kvbar, 2 * G::BIG);
    tma_tile<D>(Ks, &kmap, kvbar, kord, BB, k0, hk, b);
    tma_tile<D>(Vs, &vmap, kvbar, vord, BB, k0, hk, b);
    for (int j = 0; j < min(STAGES, n); ++j) issue(j);
  }
  __syncthreads();

  DkdvConsumer<D> c;
  const int wg = warp / 4;
  const int kw0 = k0 + BR * wg;  // this warpgroup's first key
  c.Kw = Ks + wg * BR * SW;
  c.Vw = Vs + wg * BR * SW;
  c.ring = ring;
  c.full = full;
  c.t4 = lane % 4;
  c.krow = kw0 + 16 * (warp % 4) + lane / 4;
  c.q_offset = q_offset;
  c.scale_log2 = scale * LOG2E;
  zero(c.dka);
  zero(c.dva);
  zero(c.sacc);
  zero(c.dpacc);
  // q tiles before qt_edge hold a row that does not see every key of this
  // warpgroup: row q sees them all when q_offset + q >= kw0 + BR - 1
  int qt_edge = qt0;
  if (causal) {
    const long long need = kw0 + BR - 1 - q_offset;
    if (need > 0)
      qt_edge = static_cast<int>(min(static_cast<long long>(n_qt),
                                     max(static_cast<long long>(qt0),
                                         (need + BR - 1) / BR)));
  }
  mbar_wait(kvbar, 0);
  int i = 0;
  for (int gi = 0; gi < group; ++gi) {
    int qt = qt0;
    for (; qt < qt_edge; ++qt, ++i) {
      c.template step<true>(i, qt * BR);
      release(done, i, n, issue);
    }
    for (; qt < n_qt; ++qt, ++i) {
      c.template step<false>(i, qt * BR);
      release(done, i, n, issue);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int gk = c.krow + 8 * rr;
    if (gk >= S) continue;  // keys past S: never stored
    bf16* krow = dk + b * dks.b + gk * dks.t + hk * dks.h;
    bf16* vrow = dv + b * dvs.b + gk * dvs.t + hk * dvs.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j + 2 * c.t4) = tensor_core::pack(
          c.dka[4 * j + 2 * rr] * scale, c.dka[4 * j + 2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j + 2 * c.t4) = tensor_core::pack(
          c.dva[4 * j + 2 * rr], c.dva[4 * j + 2 * rr + 1]);
    }
  }
}

// One dQ consumer warpgroup: BR q rows, their dQ accumulator, and its step
// over kv tile t.  MASK steps are the tiles that cross the diagonal of one
// of its rows or the end of S.
template <int D>
struct DqConsumer {
  using G = Geometry<D>;
  const uint8_t* Qw;  // this warpgroup's BR rows of the Q and dO tiles
  const uint8_t* dOw;
  const uint8_t* ring;
  uint64_t* full;
  int t4, qrow, S, causal;  // this thread's rows qrow, qrow + 8
  long long q_offset;
  float scale_log2;
  float l2[2], dl[2];  // lse (log2 units) and D of the two rows
  float dqa[D / 2];
  float sacc[BR / 2], dpacc[BR / 2];  // S then P; dP then dS
  uint32_t sf[BR / 16][4];

  // S and dP are issued as two groups; P is formed while dP is on the
  // tensor cores
  template <bool MASK>
  __device__ __forceinline__ void step(int t) {
    const int s = t % STAGES;
    const int k0 = t * BR;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* Kt = ring + s * G::STAGE;
    const uint8_t* Vt = Kt + G::SMALL;
    // S = Q K^T and dP = dO V^T, both operands K-major
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_bf16_ss_n64(sacc, kmajor(Qw, BB, kc), kmajor(Kt, BR, kc),
                        kc > 0 ? 1 : 0);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_bf16_ss_n64(dpacc, kmajor(dOw, BB, kc), kmajor(Vt, BR, kc),
                        kc > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();  // S is done; dP may still run
    fence_regs(sacc);
    // P = exp2(S scale log2e - lse) on the visible keys
#pragma unroll
    for (int c8 = 0; c8 < BR / 8; ++c8)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 4 * c8 + 2 * rr + j;
          float p = ex2(sacc[e] * scale_log2 - l2[rr]);
          if constexpr (MASK) {
            const int kpos = k0 + 8 * c8 + 2 * t4 + j;
            const bool ok =
                (kpos < S) & (!causal | (q_offset + qrow + 8 * rr >= kpos));
            p = ok ? p : 0.f;
          }
          sacc[e] = p;
        }
    wgmma_wait<0>();  // dP is done
    fence_regs(dpacc);
    // dS = P o (dP - D)
#pragma unroll
    for (int e = 0; e < BR / 2; ++e) dpacc[e] = sacc[e] * (dpacc[e] - dl[(e / 2) % 2]);
    to_frags(sf, dpacc);
    // dQ += dS K, K read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) rs_wgmma<D>(dqa, sf[kk], mnmajor(Kt, BR, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) fence_regs(sf[kk]);
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Tq, int Tpad, int S, int Hq, int group, Strides dqs,
                    uint32_t qord, uint32_t kord, uint32_t vord, uint32_t dord,
                    int causal, long long q_offset, float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_bw[];
  uint8_t* Qs = smem_bw + ((1024 - (smem_u32(smem_bw) & 1023)) & 1023);
  uint8_t* dOs = Qs + G::BIG;
  uint8_t* ring = dOs + G::BIG;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE);
  uint64_t* full = qbar + 1;
  uint32_t* done = reinterpret_cast<uint32_t*>(full + STAGES);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BB;
  const int hk = h / group;
  const int n_tiles = (kv_extent(q0, BB, Tq, S, causal, q_offset) + BR - 1) / BR;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  // kv tile j's K and V into stage j % STAGES
  auto issue = [&](int j) {
    const int s = j % STAGES;
    uint8_t* st = ring + s * G::STAGE;
    mbar_expect_tx(&full[s], 2 * G::SMALL);
    tma_tile<D>(st, &kmap, &full[s], kord, BR, j * BR, hk, b);
    tma_tile<D>(st + G::SMALL, &vmap, &full[s], vord, BR, j * BR, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_expect_tx(qbar, 2 * G::BIG);
    tma_tile<D>(Qs, &qmap, qbar, qord, BB, q0, h, b);
    tma_tile<D>(dOs, &dmap, qbar, dord, BB, q0, h, b);
    for (int j = 0; j < min(STAGES, n_tiles); ++j) issue(j);
  }
  __syncthreads();

  DqConsumer<D> c;
  const int wg = warp / 4;
  const int row0 = q0 + BR * wg;  // this warpgroup's first row
  c.Qw = Qs + wg * BR * SW;
  c.dOw = dOs + wg * BR * SW;
  c.ring = ring;
  c.full = full;
  c.t4 = lane % 4;
  c.qrow = row0 + 16 * (warp % 4) + lane / 4;
  c.S = S;
  c.causal = causal;
  c.q_offset = q_offset;
  c.scale_log2 = scale * LOG2E;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {  // rows < q0 + BB <= Tpad
    const long long at = (static_cast<long long>(b) * Hq + h) * Tpad + c.qrow + 8 * rr;
    c.l2[rr] = lse2[at];
    c.dl[rr] = delta[at];
  }
  zero(c.dqa);
  zero(c.sacc);
  zero(c.dpacc);
  // tiles before t_edge end at or before this warpgroup's first row's
  // diagonal and inside S: they need no mask
  const long long seen =
      causal ? max(0LL, q_offset + row0 + 1) : static_cast<long long>(S);
  const int t_edge = static_cast<int>(
      min(static_cast<long long>(n_tiles), min(seen, static_cast<long long>(S)) / BR));
  mbar_wait(qbar, 0);
  int t = 0;
  for (; t < t_edge; ++t) {
    c.template step<false>(t);
    release(done, t, n_tiles, issue);
  }
  for (; t < n_tiles; ++t) {
    c.template step<true>(t);
    release(done, t, n_tiles, issue);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int gq = c.qrow + 8 * rr;
    if (gq >= Tq) continue;
    bf16* row = dq + b * dqs.b + gq * dqs.t + h * dqs.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * c.t4) = tensor_core::pack(
          c.dqa[4 * j + 2 * rr] * scale, c.dqa[4 * j + 2 * rr + 1] * scale);
  }
}

// A [B, rows, H, D] bf16 operand as a 4-D tensor map whose dims after D
// are ordered by stride, loaded in boxes of `rows` x CE columns (as
// flash_attention.cu's operand_map).  Sets `order` (see tma_rows); false
// when cuTensorMapEncodeTiled refuses it.
inline bool operand_map(CUtensorMap* map, uint32_t* order, const void* base,
                        int B, int T, int H, const Strides& st, int D,
                        int rows) {
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
  uint32_t box[4] = {uint32_t(CE)};
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    extent[i + 1] = dims[i].extent;
    stride[i] = dims[i].stride;
    box[i + 1] = dims[i].box;
    *order |= uint32_t(i + 1) << (2 * dims[i].logical);
  }
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, extent,
                  stride, box, SW);
}

}  // namespace wgmma_tc

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  float* lse2;  // the wgmma instance's lse in log2 units, or null
  int Tpad;     // the delta (and lse2) scratch's row length
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
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.Tpad;
  if (rows == 0) return 0;
  if constexpr (sizeof(T) == 2) {  // bf16 rows are 16-byte aligned
    constexpr long long per_block = 8 * (32 / (D / 8));
    const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
    delta_bf16_kernel<D><<<blocks, 256, 0, a.st>>>(
        static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse,
        a.delta, a.lse2, a.B, a.Tq, a.Tpad, a.Hq, a.os, a.dos);
  } else {
    const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
    delta_kernel<T, D><<<blocks, 256, 0, a.st>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
        a.delta, a.lse2, a.B, a.Tq, a.Tpad, a.Hq, a.os, a.dos);
  }
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

// 16-byte loads and TMA need 16-byte aligned rows: base pointers and every
// stride a multiple of 8 bf16
bool aligned8(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.t % 8 == 0 && s.h % 8 == 0;
}

template <int D>
int run_wgmma(const Args& a) {
  using namespace wgmma_tc;
  using G = Geometry<D>;
  if (!aligned8(a.q, a.qs) || !aligned8(a.k, a.ks) || !aligned8(a.v, a.vs) ||
      !aligned8(a.dout, a.dos) || a.lse2 == nullptr || a.Tpad % BB != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = run_delta<bf16, D>(a);
  if (err) return err;
  // dK/dV take q tiles of BR rows and K, V tiles of BB keys; dQ the other
  // way round
  CUtensorMap qs, ks, vs, ds, qb, kb, vb, db;
  uint32_t oqs, oks, ovs, ods, oqb, okb, ovb, odb;
  if (!operand_map(&qs, &oqs, a.q, a.B, a.Tq, a.Hq, a.qs, D, BR) ||
      !operand_map(&ds, &ods, a.dout, a.B, a.Tq, a.Hq, a.dos, D, BR) ||
      !operand_map(&kb, &okb, a.k, a.B, a.S, a.Hkv, a.ks, D, BB) ||
      !operand_map(&vb, &ovb, a.v, a.B, a.S, a.Hkv, a.vs, D, BB) ||
      !operand_map(&qb, &oqb, a.q, a.B, a.Tq, a.Hq, a.qs, D, BB) ||
      !operand_map(&db, &odb, a.dout, a.B, a.Tq, a.Hq, a.dos, D, BB) ||
      !operand_map(&ks, &oks, a.k, a.B, a.S, a.Hkv, a.ks, D, BR) ||
      !operand_map(&vs, &ovs, a.v, a.B, a.S, a.Hkv, a.vs, D, BR))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S > 0) {  // with T = 0, dK and dV are written as zeros
    if ((err = set_smem(dkdv_wgmma_kernel<D>, G::SMEM))) return err;
    dkdv_wgmma_kernel<D><<<dim3((a.S + BB - 1) / BB, a.Hkv, a.B), THREADS,
                           G::SMEM, a.st>>>(
        qs, kb, vb, ds, a.lse2, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.Tq, a.Tpad, a.S, a.Hq, a.group, a.dks,
        a.dvs, oqs, okb, ovb, ods, a.causal, a.q_offset, a.scale);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (a.Tq == 0) return 0;
  if ((err = set_smem(dq_wgmma_kernel<D>, G::SMEM))) return err;
  dq_wgmma_kernel<D><<<dim3((a.Tq + BB - 1) / BB, a.Hq, a.B), THREADS, G::SMEM,
                       a.st>>>(
      qb, ks, vs, db, a.lse2, a.delta, static_cast<bf16*>(a.dq), a.Tq, a.Tpad,
      a.S, a.Hq, a.group, a.dqs, oqb, oks, ovs, odb, a.causal, a.q_offset,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run(int instance, const Args& a) {
  if (instance == 2) {
    if constexpr (D == 64 || D == 128) return run_wgmma<D>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return instance == 1 ? run_bf16<D>(a) : run_fp32<D>(a);
}

}  // namespace

// Plain C entry point (bound with ctypes).  `instance` 0 takes fp32
// operands (CUDA cores), 1 bf16 (mma.sync), 2 bf16 (wgmma; D 64 or 128,
// every operand 16-byte aligned).  Strides are in elements, in the order
// (batch, sequence, head), for q, k, v, o, dO, dq, dk, dv; D has unit
// stride, and in bf16 every row is 16-byte aligned.  lse is contiguous fp32
// [B, Hq, Tq]; the scratch `delta` is fp32 [B, Hq, Tpad] with Tpad = Tq
// for instances 0 and 1, and for instance 2 a multiple of 128 at least Tq,
// with `lse2` a second scratch of that shape (null for 0 and 1).
// Launches the three kernels on `stream` and returns cudaGetLastError()
// after the last, the first error, or cudaErrorInvalidValue for a head dim
// without an instance (32, 64, 128; wgmma 64 and 128), an unknown
// instance, wgmma operands that are not 16-byte aligned or whose tensor
// map CUDA refuses, a head count that is not a multiple of the kv heads, or
// a grid too large.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* lse2, int Tpad,
    void* dq, void* dk, void* dv, int instance, int B, int Tq, int S, int Hq,
    int Hkv, int D,
    long long qsb, long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh, long long osb,
    long long ost, long long osh, long long dosb, long long dost,
    long long dosh, long long dqsb, long long dqst, long long dqsh,
    long long dksb, long long dkst, long long dksh, long long dvsb,
    long long dvst, long long dvsh, int causal, long long q_offset,
    float scale, void* stream) {
  if (B == 0 || Hq == 0 || (Tq == 0 && S == 0)) return 0;
  if (instance < 0 || instance > 2 || Hkv < 1 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535 || Tq < 0 || S < 0 || Tpad < Tq ||
      (instance < 2 && (Tpad != Tq || lse2 != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), static_cast<float*>(lse2), Tpad,
         dq, dk, dv, B, Tq, S, Hq, Hkv, Hq / Hkv,
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
