// Batched modular matrix product O[w] = (A[w] @ B[w]) mod p on Hopper's
// int8 tensor cores, over 8-bit limbs: the tensor-core instance.
//
// Replaces the Pallas kernel _modmatmul_batched_kernel
// (src/repro/kernels/modmatmul.py:64) for the products whose output fills
// 64x64 tiles: the main path's [17,1024,1024] @ [17,1024,1024] worker
// products.  modmatmul.cu, the CUDA-core instance, keeps what this tile
// cannot fill (the W = 1 tags product [17, 2^20] @ [2^20, 1], N = 1, with
// its split K); kernels/modmatmul.py's choose_instance picks between them.
//
// Contract: as modmatmul.cu.  A [W, M, K], B [W, K, N], O [W, M, N], all
// contiguous int64, elements in [0, p) with p < 2^31 pseudo-Mersenne.
// The caller passes scratch for the limb planes (below) and the number of
// clusters (kernels/modmatmul.py's tc_grid).
//
// Arithmetic.  Every element splits into four unsigned 8-bit limbs,
// x = sum_i 2^(8i) x_i, which covers any x < 2^32.  Then
//     A @ B = sum_{d=0..6} 2^(8d) D_d,   D_d = sum_{i+j=d} A_i @ B_j:
// 16 limb products, each pair (i, j) accumulated into its diagonal's s32
// accumulator by wgmma .s32.u8.u8.  A diagonal has at most 4 pairs, so
// after a run of k products |D_d| <= 4 * 255^2 * k, below 2^31 while
// k <= K_RUN_MAX = 8256:
//     4 * 255^2 * 8256 = 2,147,385,600 < 2^31 = 2,147,483,648
//                      < 2,147,645,700 = 4 * 255^2 * 8257,
// so the constant is tight for 8-bit limbs.  The kernel folds every K_RUN
// = 8192 products (64 k-tiles of 128), and at the end, by Horner over the
// diagonals, reducing only where the running value would leave mod_p<NF>'s
// domain (x < 2^63; field.cuh):
//     v = mod_p(D_6 2^32 + D_5 2^24 + D_4 2^16 + D_3 2^8 + D_2) 2^16
//         + D_1 2^8 + D_0 + R,        R <- mod_p(v).
// A diagonal of n limb pairs is at most n 255^2 K_RUN < n 2^29, so the
// first argument is below 2^62 and v below 2^48.  The arithmetic is exact,
// so the result equals the plain version's, element for element
// (kernels/modmatmul.py's modmatmul_tc_emulation repeats it;
// analysis/overflow.py's prove_tensor_core certifies its bounds).
//
// Layout.  wgmma reads its shared-memory operand only K-major for 8-bit
// types, and B arrives N-major.  Two pre-pass kernels write limb planes
// Al [W, 4, M, Kp] and Bl [W, 4, N, Kp] (B transposed), Kp = K rounded up
// to 16 bytes for TMA's strides.  TMA delivers 128-byte-swizzled tiles
// straight from the planes; the consumers spend nothing on the split.  At
// the main shape the pre-passes read 285 MB of int64 and write 143 MB of
// limbs, about 0.13 ms at 3.35 TB/s.
//
// Schedule.  A persistent grid of 2-CTA clusters along M, one CTA per SM:
// kernels/modmatmul.py's tc_grid launches one cluster per pair of SMs the
// card can hold clusters on (66 on an H100), or one per unit if there are
// fewer.  A unit is (worker, pair of 64-row M-tiles, 64-column N-tile);
// cluster c walks units c, c + clusters, ... numbered worker by worker
// (tc_tiles lists the walk), so the units in flight span one or two
// workers' limb planes (8 MB each at the main shape), which stay in the
// 50 MB L2.  CTA r of the pair takes M-tile 2 q + r; with an odd number of
// M-tiles the last pair's second CTA loads the first's rows and stores
// nothing.  Each CTA has two consumer warpgroups, each owning 64 rows x 32
// columns of its 64x64 output tile, and a producer warpgroup:
//   * one thread streams k-tiles of 128 bytes through a ring of 3 stages,
//     across units, so the next unit's first stages load while the
//     consumers finish the last: per stage one TMA box of [4 limbs]
//     [64 rows][128 bytes] of A for this CTA and one of [4 limbs][32 rows]
//     [128 bytes] of B multicast to both CTAs of the cluster, which share
//     the N-tile (128-byte swizzle, 64 KB a stage).  A stage is refilled
//     once all 16 consumer warps of the cluster have released it;
//   * three warps are the epilogue: a consumer warpgroup hands its half of
//     the tile over in shared memory as v above (32 KB for the tile) and
//     goes on to the next unit, while the epilogue takes mod_p(v) and
//     stores O, coalesced.
// Per k32 step a consumer warpgroup loads the 4 A limbs' fragments of its
// 64 rows from shared memory once (ldmatrix: 16 registers a thread) and
// issues 16 wgmma m64n32k32 with A from registers, each limb's fragment
// serving all 4 B limbs.  Two steps' groups stay in flight; the fragments
// of the step two ahead load under them (4 buffers, 64 registers).
//
// Bound on an H100 at the main shape: the 16 limb products are 2 * 17 *
// 1024^3 * 16 = 5.8e11 int8 operations, 0.295 ms at 1979 TOP/s (4096 MACs
// a clock an SM); the operands and result (428 MB of int64) take 0.128 ms
// at 3.35 TB/s.  So the work is bound by operations.  Shared memory at
// the full rate: wgmma reads 1 KB of B per m64n32k32 (65,536 MACs), 64
// bytes a clock; the fragments 2 KB a limb a step for 4 such products, 32
// bytes a clock; TMA writes 64 KB a stage for 8.4 M MACs, 32 bytes a
// clock: 128 of the 128 bytes a clock an SM has (with both operands from
// shared memory, the design before this one needed 224).  L2 reads of limb
// planes: 1.14 GB of A and, multicast, 0.57 GB of B a block (2.28 GB
// without the cluster).  Registers: ptxas gives every thread 168 (384
// threads); setmaxnreg takes the producer warpgroup to 40 and the
// consumers to 232, which hold the 112 accumulators, 64 fragment registers
// and R: 0 bytes of spills (ptxas -v), and no serialized wgmma.  Measured
// 0.418-0.425 ms a launch (70 % of the peak; PERF.md).  What still holds
// it back: at each unit's end both consumer warpgroups drain their wgmma
// groups and reduce 16 elements a thread at the same time, about 2.2 us
// of a 12.7 us unit with the tensor cores idle (the kernel without it
// takes 0.351 ms); the ring is too shallow for the warpgroups to drift
// apart and cover each other (a deliberate start offset did not hold).
// The multicast cluster costs about 2 % beside separate loads, for 25 %
// fewer L2 bytes.  And the pre-passes' bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;           // output rows per CTA
constexpr int BN = 64;           // output columns per CTA
constexpr int BK = 128;          // K bytes per stage (one 128-byte swizzle row)
constexpr int LIMBS = 4;         // 8-bit limbs per element (p < 2^32)
constexpr int DIAGS = 2 * LIMBS - 1;
constexpr int STAGES = 3;
constexpr int CLUSTER = 2;       // CTAs along M that share each B stage
constexpr int CONSUMERS = 2;     // warpgroups; each owns BN / 2 columns
constexpr int WG_N = BN / CONSUMERS;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int EPILOGUE_THREADS = 96;  // the producer warpgroup's last 3 warps
constexpr int DEPTH = 2;         // wgmma groups a consumer keeps in flight
// registers a thread after setmaxnreg: the producer warpgroup keeps
// PRODUCER_REGS, the consumers take the rest of the 64,512 the launch
// allocates (168 a thread: too few for 112 accumulators, 64 fragment
// registers and R)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <=
                  65536 / THREADS / 8 * 8 * THREADS,
              "the hand-over stays within what the launch allocates");
constexpr int A_PLANE = BM * BK;               // bytes of one limb's A tile
constexpr int A_BYTES = LIMBS * A_PLANE;       // 32 KB
constexpr int B_PLANE = WG_N * BK;             // one limb of one B half
constexpr int B_HALF = LIMBS * B_PLANE;        // 16 KB, one CTA's multicast
constexpr int STAGE_BYTES = A_BYTES + CLUSTER * B_HALF;  // 64 KB
constexpr int HAND_BYTES = BM * BN * 8;        // a tile's values v: 32 KB
constexpr size_t SMEM = size_t(STAGES) * STAGE_BYTES + HAND_BYTES + 1024 +
                        (2 * STAGES + 2 * CONSUMERS) * 8;
constexpr long long K_RUN_MAX = 8256;
constexpr int K_RUN = (K_RUN_MAX / BK) * BK;   // 8192: folds on tile edges
constexpr int FOLD_LOW = 2;   // diagonals after the fold's first reduction
static_assert(BN == CLUSTER * WG_N, "each CTA of a pair multicasts one warpgroup's B");
static_assert(4LL * 255 * 255 * K_RUN_MAX < (1LL << 31) &&
                  4LL * 255 * 255 * (K_RUN_MAX + 1) >= (1LL << 31),
              "K_RUN_MAX is the longest run whose diagonals fit s32");

constexpr int SPLIT_THREADS = 256;
constexpr int TT_K = 64;  // B transpose tile: K rows
constexpr int TT_N = 32;  //                   N columns

// Al[w, l, m, k] = limb l of A[w, m, k]; one thread per 4 bytes of a row,
// zeros past K
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_a_kernel(const int64_t* __restrict__ A, uint8_t* __restrict__ Al,
                   int W, int M, int K, int Kp) {
  const int groups = Kp / 4;
  const long long g =
      static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (g >= static_cast<long long>(W) * M * groups) return;
  const int c = static_cast<int>(g % groups);
  const long long row = g / groups;  // w * M + m
  const long long w = row / M;
  const int m = static_cast<int>(row % M);
  const int64_t* src = A + row * K;
  uint32_t limb[LIMBS] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = 4 * c + e;
    const uint32_t x = k < K ? static_cast<uint32_t>(src[k]) : 0u;
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) limb[l] |= ((x >> (8 * l)) & 0xffu) << (8 * e);
  }
#pragma unroll
  for (int l = 0; l < LIMBS; ++l)
    *reinterpret_cast<uint32_t*>(
        Al + ((w * LIMBS + l) * M + m) * static_cast<long long>(Kp) + 4 * c) =
        limb[l];
}

// Bl[w, l, n, k] = limb l of B[w, k, n]: a 64 x 32 tile through shared
// memory, read along N and written along K, zeros past K
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_bt_kernel(const int64_t* __restrict__ B, uint8_t* __restrict__ Bl,
                    int K, int N, int Kp) {
  __shared__ uint32_t tile[TT_K][TT_N + 1];
  const int k0 = blockIdx.x * TT_K;
  const int n0 = blockIdx.y * TT_N;
  const long long w = blockIdx.z;
  const int64_t* src = B + w * K * static_cast<long long>(N);
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < TT_K * TT_N / SPLIT_THREADS; ++r) {
    const int kk = tid / TT_N + r * (SPLIT_THREADS / TT_N);
    const int nn = tid % TT_N;
    const int k = k0 + kk;
    const int n = n0 + nn;
    tile[kk][nn] = (k < K && n < N)
                       ? static_cast<uint32_t>(src[static_cast<long long>(k) * N + n])
                       : 0u;
  }
  __syncthreads();
  const int nn = tid / 8;  // 32 rows of 8 threads, 8 bytes each
  const int kq = tid % 8;
  const int n = n0 + nn;
  const int k = k0 + 8 * kq;
  if (n >= N || k >= Kp) return;
#pragma unroll
  for (int l = 0; l < LIMBS; ++l) {
    uint2 v = make_uint2(0u, 0u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t byte = (tile[8 * kq + e][nn] >> (8 * l)) & 0xffu;
      if (e < 4)
        v.x |= byte << (8 * e);
      else
        v.y |= byte << (8 * (e - 4));
    }
    *reinterpret_cast<uint2*>(
        Bl + ((w * LIMBS + l) * N + n) * static_cast<long long>(Kp) + k) = v;
  }
}

// Horner over element e's diagonals, reducing only where the running value
// would leave mod_p's domain: v - R = mod_p(D_6 2^32 + D_5 2^24 +
// D_4 2^16 + D_3 2^8 + D_2) 2^16 + D_1 2^8 + D_0 (the note above)
template <int NF>
__device__ __forceinline__ uint64_t horner(const int32_t (&acc)[DIAGS][16],
                                           int e, const FoldParams& f) {
  uint64_t x = static_cast<uint32_t>(acc[DIAGS - 1][e]);
#pragma unroll
  for (int d = DIAGS - 2; d >= 0; --d) {
    if (d == FOLD_LOW - 1) x = mod_p<NF>(x, f);
    x = (x << 8) + static_cast<uint32_t>(acc[d][e]);
  }
  return x;
}

// R <- mod_p(horner + R): a K-run folded into R, then the diagonals restart
template <int NF>
__device__ __forceinline__ void fold_run(int32_t (&acc)[DIAGS][16],
                                         uint32_t (&R)[16],
                                         const FoldParams& f) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    R[e] = static_cast<uint32_t>(mod_p<NF>(horner<NF>(acc, e, f) + R[e], f));
#pragma unroll
    for (int d = 0; d < DIAGS; ++d) acc[d][e] = 0;
  }
}

// where element (r, c) of a tile's values v sits in the hand-over buffer:
// rows of 64 values, odd rows with their 8-value halves of each 16
// swapped, so a consumer warp's 16-byte stores of 8 rows fall in both
// halves of the banks
__device__ __forceinline__ int hand_index(int r, int c) {
  return r * BN + (c ^ ((r & 1) << 3));
}

// One unit of the walk: worker, M-tile pair, N-tile (kernels/modmatmul.py's
// tc_tiles enumerates the same order)
struct Unit {
  int w, m_tile, n_tile;
};

__device__ __forceinline__ Unit unit_at(long long u, int m_pairs, int n_tiles,
                                        int rank) {
  const long long per_worker = static_cast<long long>(m_pairs) * n_tiles;
  const int r = static_cast<int>(u % per_worker);
  return {static_cast<int>(u / per_worker), CLUSTER * (r % m_pairs) + rank,
          r / m_pairs};
}

// the 4 A limbs' fragments of k32 step ks for this warp's 16 rows: lane l
// addresses row l % 16 and 16-byte chunk 2 ks + l / 16, through the
// 128-byte swizzle (chunk ^ row % 8)
__device__ __forceinline__ void load_fragments(uint32_t (&fr)[LIMBS][4],
                                               const uint8_t* a, int ks,
                                               int row, int half) {
  const int off = row * BK + (((2 * ks + half) ^ (row & 7)) << 4);
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) ldmatrix_x4(fr[i], a + i * A_PLANE + off);
}

// a stage is free again once every consumer warp of the cluster has
// arrived on its empty barrier in both CTAs: lane c of each warp arrives in
// CTA c.  Plain (CTA-scope) arrivals: the wgmma reads they answer for have
// retired, and a cluster-scope release costs a third of the kernel's rate.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane < CLUSTER) mbar_arrive_cluster(empty, lane);
}

template <int NF>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    modmatmul_tc_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        int64_t* __restrict__ O, int W, int M, int K, int N,
                        FoldParams f) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* hand = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* full = hand + BM * BN;
  uint64_t* empty = full + STAGES;
  uint64_t* hand_full = empty + STAGES;  // a consumer warpgroup's half written
  uint64_t* hand_empty = hand_full + CONSUMERS;  // ... and stored to O

  const int m_tiles = (M + BM - 1) / BM;
  const int m_pairs = (m_tiles + CLUSTER - 1) / CLUSTER;
  const int n_tiles = (N + BN - 1) / BN;
  const long long units = static_cast<long long>(W) * m_pairs * n_tiles;
  const int k_tiles = (K + BK - 1) / BK;
  const int rank = static_cast<int>(cluster_ctarank());
  const int cluster = blockIdx.x / CLUSTER;
  const int clusters = gridDim.x / CLUSTER;
  // a shuffle makes the warp index provably uniform to the compiler, which
  // serializes wgmma on paths it takes for divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CLUSTER * CONSUMERS * 4);  // every consumer warp
    }
    for (int g = 0; g < CONSUMERS; ++g) {
      mbar_init(&hand_full[g], 128);
      mbar_init(&hand_empty[g], EPILOGUE_THREADS);
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4) {  // one thread issues every TMA load
      if (lane != 0) return;
      int it = 0;
      for (long long u = cluster; u < units; u += clusters) {
        const Unit un = unit_at(u, m_pairs, n_tiles, rank);
        const int m0 = min(un.m_tile, m_tiles - 1) * BM;
        for (int t = 0; t < k_tiles; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_3d(st, &amap, &full[s], t * BK, m0, LIMBS * un.w);
          tma_load_3d_multicast(st + A_BYTES + rank * B_HALF, &bmap, &full[s],
                                t * BK, un.n_tile * BN + rank * WG_N,
                                LIMBS * un.w, (1u << CLUSTER) - 1);
        }
      }
      // stay until the cluster's consumers have released every stage: the
      // peer's consumers arrive on this CTA's barriers to the end
      for (int j = 0; j < STAGES; ++j, ++it)
        if (it >= STAGES) mbar_wait(&empty[it % STAGES], ((it / STAGES) - 1) & 1);
      return;
    }
    // the epilogue: each tile's last reduction and its int64 stores, behind
    // the consumers' next tile
    const int et = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
    int q = 0;
    for (long long u = cluster; u < units; u += clusters) {
      const Unit un = unit_at(u, m_pairs, n_tiles, rank);
      if (un.m_tile >= m_tiles) continue;  // the odd pair's stand-in
      int64_t* Ow = O + static_cast<long long>(un.w) * M * N;
      for (int g = 0; g < CONSUMERS; ++g) {
        mbar_wait(&hand_full[g], q & 1);
        for (int e = et; e < BM * WG_N; e += EPILOGUE_THREADS) {
          const int r = e / WG_N;
          const int c = g * WG_N + e % WG_N;
          const int row = un.m_tile * BM + r;
          const int col = un.n_tile * BN + c;
          if (row < M && col < N)
            Ow[static_cast<long long>(row) * N + col] =
                static_cast<int64_t>(mod_p<NF>(hand[hand_index(r, c)], f));
        }
        mbar_arrive(&hand_empty[g]);
      }
      ++q;
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row = 16 * (warp % 4) + lane % 16;  // this lane's ldmatrix row
  const int half = lane / 16;
  constexpr int STEPS = BK / 32;
  int32_t acc[DIAGS][16];
  uint32_t R[16];
  uint32_t fr[2 * DEPTH][LIMBS][4];  // step g's fragments in fr[g % 2 DEPTH]
#pragma unroll
  for (int d = 0; d < DIAGS; ++d)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[d][e] = 0;

  int it = 0;
  int q = 0;
  for (long long u = cluster; u < units; u += clusters) {
    const Unit un = unit_at(u, m_pairs, n_tiles, rank);
#pragma unroll
    for (int e = 0; e < 16; ++e) R[e] = 0u;
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < DEPTH; ++ks)
      load_fragments(fr[ks], smem + (it % STAGES) * STAGE_BYTES, ks, row, half);
    for (int t = 0; t < k_tiles; ++t, ++it) {
      const uint8_t* a = smem + (it % STAGES) * STAGE_BYTES;
      const uint8_t* b = a + A_BYTES + wg * B_HALF;
#pragma unroll
      for (int ks = 0; ks < STEPS; ++ks) {
#pragma unroll
        for (int d = 0; d < DIAGS; ++d) fence_regs(acc[d]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < LIMBS; ++j) {
          const uint64_t db = smem_desc(b + j * B_PLANE + ks * 32, 16, 1024, 128);
#pragma unroll
          for (int i = 0; i < LIMBS; ++i)
            wgmma_u8_rs_n32(acc[i + j], fr[ks % (2 * DEPTH)][i], db);
        }
        wgmma_commit();
        // the step DEPTH back has retired: its fragments' registers, and at
        // ks = DEPTH - 1 the last reads of the stage before
        wgmma_wait<DEPTH>();
#pragma unroll
        for (int d = 0; d < DIAGS; ++d) fence_regs(acc[d]);
        if (ks == DEPTH - 1 && t > 0) release(&empty[(it - 1) % STAGES], lane);
        const int ahead = ks + DEPTH;  // the step whose fragments load now
        if (ahead < STEPS) {
          load_fragments(fr[ahead % (2 * DEPTH)], a, ahead, row, half);
        } else if (t + 1 < k_tiles) {
          const int next = it + 1;
          if (ahead == STEPS) mbar_wait(&full[next % STAGES], (next / STAGES) & 1);
          load_fragments(fr[ahead % (2 * DEPTH)], smem + (next % STAGES) * STAGE_BYTES,
                         ahead - STEPS, row, half);
        }
      }
      if ((t + 1) % (K_RUN / BK) == 0 && t + 1 < k_tiles) {
        wgmma_wait<0>();
#pragma unroll
        for (int d = 0; d < DIAGS; ++d) fence_regs(acc[d]);
        fold_run<NF>(acc, R, f);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < DIAGS; ++d) fence_regs(acc[d]);
    release(&empty[(it - 1) % STAGES], lane);

    // hand the tile's values, reduced once, to the epilogue:
    // R[4i + 2h + e] is row 16 (warp % 4) + lane / 4 + 8h, column
    // wg * 32 + 8i + 2 (lane % 4) + e of the tile
    if (un.m_tile < m_tiles) {
      if (q > 0) mbar_wait(&hand_empty[wg], (q - 1) & 1);
#pragma unroll
      for (int i = 0; i < WG_N / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
          const int c = wg * WG_N + 8 * i + 2 * (lane % 4);
          const int e = 4 * i + 2 * h;
          *reinterpret_cast<ulonglong2*>(hand + hand_index(r, c)) =
              make_ulonglong2(horner<NF>(acc, e, f) + R[e],
                              horner<NF>(acc, e + 1, f) + R[e + 1]);
        }
      mbar_arrive(&hand_full[wg]);
      ++q;
    }
#pragma unroll
    for (int d = 0; d < DIAGS; ++d)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[d][e] = 0;
  }
}

template <int NF>
int launch(const int64_t* A, const int64_t* B, int64_t* O, uint8_t* Al,
           uint8_t* Bl, int W, int M, int K, int N, int Kp, int clusters,
           const FoldParams& f, cudaStream_t s) {
  const long long groups = static_cast<long long>(W) * M * (Kp / 4);
  split_a_kernel<<<static_cast<unsigned>((groups + SPLIT_THREADS - 1) /
                                         SPLIT_THREADS),
                   SPLIT_THREADS, 0, s>>>(A, Al, W, M, K, Kp);
  const dim3 tgrid((Kp + TT_K - 1) / TT_K, (N + TT_N - 1) / TT_N, W);
  split_bt_kernel<<<tgrid, SPLIT_THREADS, 0, s>>>(B, Bl, K, N, Kp);

  // limb planes as 3-D tensors [4W][rows][K] of bytes, row stride Kp; an A
  // box is all four limbs of one 64-row, 128-byte tile, a B box all four
  // limbs of one 32-row half of it
  CUtensorMap amap, bmap;
  const uint32_t abox[3] = {BK, BM, LIMBS};
  const uint32_t bbox[3] = {BK, WG_N, LIMBS};
  const uint64_t adims[3] = {uint64_t(K), uint64_t(M), uint64_t(LIMBS) * W};
  const uint64_t astr[2] = {uint64_t(Kp), uint64_t(M) * Kp};
  const uint64_t bdims[3] = {uint64_t(K), uint64_t(N), uint64_t(LIMBS) * W};
  const uint64_t bstr[2] = {uint64_t(Kp), uint64_t(N) * Kp};
  if (!make_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, Al, adims, astr, abox,
                128) ||
      !make_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, Bl, bdims, bstr, bbox,
                128))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = modmatmul_tc_kernel<NF>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<clusters * CLUSTER, THREADS, SMEM, s>>>(amap, bmap, O, W, M, K, N, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// modmatmul_tc_launch: a_limbs and b_limbs are scratch of W * 4 * M * Kp
// and W * 4 * N * Kp bytes, Kp a multiple of 16 and at least K; clusters
// as tc_grid gives it.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a fold count without an instance, K < 1, a
// grid too large, or a tensor map CUDA refuses.
extern "C" int modmatmul_tc_launch(const void* a, const void* b, void* o,
                                   void* a_limbs, void* b_limbs, int W, int M,
                                   int K, int N, int Kp, int clusters,
                                   long long p, int fold_bits,
                                   long long fold_c, int n_folds, void* stream) {
  if (W == 0 || M == 0 || N == 0) return 0;
  if (K < 1 || Kp < K || Kp % 16 != 0 || W > 65535 || (M + BM - 1) / BM > 65535 ||
      clusters < 1 || clusters > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldParams f{static_cast<uint64_t>(p), static_cast<uint32_t>(fold_bits),
                     static_cast<uint64_t>(fold_c)};
  const auto* A = static_cast<const int64_t*>(a);
  const auto* B = static_cast<const int64_t*>(b);
  auto* O = static_cast<int64_t*>(o);
  auto* Al = static_cast<uint8_t*>(a_limbs);
  auto* Bl = static_cast<uint8_t*>(b_limbs);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_folds) {
    case 1: return launch<1>(A, B, O, Al, Bl, W, M, K, N, Kp, clusters, f, s);
    case 2: return launch<2>(A, B, O, Al, Bl, W, M, K, N, Kp, clusters, f, s);
    case 3: return launch<3>(A, B, O, Al, Bl, W, M, K, N, Kp, clusters, f, s);
    case 4: return launch<4>(A, B, O, Al, Bl, W, M, K, N, Kp, clusters, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// modmatmul_tc_clusters: how many of the kernel's 2-CTA clusters the
// current device holds at once (cudaOccupancyMaxActiveClusters; the SMs of
// a GPC pair up), or a negative cudaError_t.
extern "C" int modmatmul_tc_clusters() {
  auto kernel = modmatmul_tc_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(sms / CLUSTER * CLUSTER);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = SMEM;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
