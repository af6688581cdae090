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
// The caller passes scratch for the limb planes (below).
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
// = 8192 products (64 k-tiles of 128), and at the end, by Horner:
//     R' = D_6;  R' <- mod_p(R' * 2^8 + D_d) for d = 5 .. 0;  R <- mod_p(R + R').
// R' * 2^8 + D_d < 2^31 * 2^8 + 2^31 < 2^40 stays inside mod_p<NF>'s
// domain (x < 2^63; field.cuh).  The arithmetic is exact, so the result
// equals the plain version's, element for element.
//
// Layout.  wgmma reads 8-bit operands only K-major in shared memory, and B
// arrives N-major.  Two pre-pass kernels write limb planes Al [W, 4, M, Kp]
// and Bl [W, 4, N, Kp] (B transposed), Kp = K rounded up to 16 bytes for
// TMA's strides.  That was chosen over splitting limbs in producer warps:
// TMA then delivers swizzled tiles straight from the planes, and the
// consumers spend no registers or instructions on the split.  The price is
// the planes' bytes: at the main shape the pre-passes read 285 MB of int64
// and write 143 MB of limbs, about 0.13 ms at 3.35 TB/s.
//
// Schedule.  One block per (worker, 64x64 output tile): two consumer
// warpgroups, each owning 64 rows x 32 columns, and one producer warp.
// The producer streams k-tiles of 128 bytes through a ring of 3 stages,
// one TMA box of [4 limbs][64 rows][128 bytes] for A and one for B per
// stage (128-byte swizzle, 64 KB per stage), guarded by full and empty
// mbarriers.  Per k-tile each consumer issues 4 k32 steps x 16 limb pairs
// = 64 wgmma m64n32k32.  Registers set the tile: 7 diagonals x 16 s32 per
// thread (64 x 32 / 128) = 112 accumulators, plus 16 for R.  n32 per
// warpgroup is the widest that fits; n64 would need 224 accumulators alone.
//
// Bound on an H100 at the main shape: the 16 limb products are 2 * 17 *
// 1024^3 * 16 = 5.8e11 int8 operations, 0.295 ms at 1979 TOP/s; the
// operands and result (428 MB of int64) take 0.128 ms at 3.35 TB/s.  So
// the work is bound by operations.  What holds this design back: both
// wgmma operands come from shared memory, 2 KB of A and 1 KB of B per
// m64n32k32 (65,536 MACs), which at the full rate would need about 192
// bytes per clock against shared memory's 128, so at most about 2/3 of the
// peak; one block per SM (a 192 KB ring, 128 accumulator registers), so a
// block's ring fill and epilogue are not hidden behind another block; and
// the pre-passes' bytes.  A from registers and a persistent grid are the
// next steps.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 128;          // K bytes per stage (one 128-byte swizzle row)
constexpr int LIMBS = 4;         // 8-bit limbs per element (p < 2^32)
constexpr int DIAGS = 2 * LIMBS - 1;
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;     // warpgroups; each owns BN / 2 columns
constexpr int WG_N = BN / CONSUMERS;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int PLANE = BM * BK;                 // bytes of one limb's tile
constexpr int STAGE_BYTES = 2 * LIMBS * PLANE;  // A and B: 64 KB
constexpr size_t SMEM = size_t(STAGES) * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr long long K_RUN_MAX = 8256;
constexpr int K_RUN = (K_RUN_MAX / BK) * BK;   // 8192: folds on tile edges
static_assert(BM == BN, "one plane size for A and B tiles");
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

// R <- (R + sum_d 2^(8d) D_d) mod p by Horner, then the diagonals restart
template <int NF>
__device__ __forceinline__ void fold_run(int32_t (&acc)[DIAGS][16],
                                         uint32_t (&R)[16],
                                         const FoldParams& f) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    uint64_t r = static_cast<uint32_t>(acc[DIAGS - 1][e]);
#pragma unroll
    for (int d = DIAGS - 2; d >= 0; --d)
      r = mod_p<NF>((r << 8) + static_cast<uint32_t>(acc[d][e]), f);
    R[e] = static_cast<uint32_t>(mod_p<NF>(r + R[e], f));
#pragma unroll
    for (int d = 0; d < DIAGS; ++d) acc[d][e] = 0;
  }
}

template <int NF>
__global__ void __launch_bounds__(THREADS, 1)
    modmatmul_tc_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        int64_t* __restrict__ O, int M, int K, int N,
                        FoldParams f) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int w = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_tiles = (K + BK - 1) / BK;
  // a shuffle makes the warp index provably uniform to the compiler, which
  // serializes wgmma on paths it takes for divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {  // the producer warp: one thread issues TMA
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(st, &amap, &full[s], t * BK, m0, LIMBS * w);
        tma_load_3d(st + LIMBS * PLANE, &bmap, &full[s], t * BK, n0, LIMBS * w);
      }
    }
    return;
  }

  const int wg = warp / 4;
  int32_t acc[DIAGS][16];
  uint32_t R[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    R[e] = 0u;
#pragma unroll
    for (int d = 0; d < DIAGS; ++d) acc[d][e] = 0;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* a = smem + s * STAGE_BYTES;
    const uint8_t* b = a + LIMBS * PLANE + wg * WG_N * BK;
#pragma unroll
    for (int d = 0; d < DIAGS; ++d) fence_regs(acc[d]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
#pragma unroll
      for (int i = 0; i < LIMBS; ++i) {
        const uint64_t da = smem_desc(a + i * PLANE + ks * 32, 16, 1024, 128);
#pragma unroll
        for (int j = 0; j < LIMBS; ++j)
          wgmma_u8_ss_n32(acc[i + j], da,
                          smem_desc(b + j * PLANE + ks * 32, 16, 1024, 128));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < DIAGS; ++d) fence_regs(acc[d]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if ((t + 1) % (K_RUN / BK) == 0 || t + 1 == n_tiles) fold_run<NF>(acc, R, f);
  }

  // R[4i + 2h + e] is row 16 (warp % 4) + lane / 4 + 8h, column
  // wg * 32 + 8i + 2 (lane % 4) + e of the tile
  const int r0 = m0 + 16 * (warp % 4) + lane / 4;
  const int c0 = n0 + wg * WG_N + 2 * (lane % 4);
  int64_t* Ow = O + static_cast<long long>(w) * M * N;
#pragma unroll
  for (int i = 0; i < WG_N / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * i + e;
        if (col < N)
          Ow[static_cast<long long>(row) * N + col] =
              static_cast<int64_t>(R[4 * i + 2 * h + e]);
      }
    }
}

template <int NF>
int launch(const int64_t* A, const int64_t* B, int64_t* O, uint8_t* Al,
           uint8_t* Bl, int W, int M, int K, int N, int Kp, const FoldParams& f,
           cudaStream_t s) {
  const long long groups = static_cast<long long>(W) * M * (Kp / 4);
  split_a_kernel<<<static_cast<unsigned>((groups + SPLIT_THREADS - 1) /
                                         SPLIT_THREADS),
                   SPLIT_THREADS, 0, s>>>(A, Al, W, M, K, Kp);
  const dim3 tgrid((Kp + TT_K - 1) / TT_K, (N + TT_N - 1) / TT_N, W);
  split_bt_kernel<<<tgrid, SPLIT_THREADS, 0, s>>>(B, Bl, K, N, Kp);

  // limb planes as 3-D tensors [4W][rows][K] of bytes, row stride Kp; a box
  // is all four limbs of one 64-row, 128-byte tile
  CUtensorMap amap, bmap;
  const uint32_t box[3] = {BK, BM, LIMBS};
  const uint64_t adims[3] = {uint64_t(K), uint64_t(M), uint64_t(LIMBS) * W};
  const uint64_t astr[2] = {uint64_t(Kp), uint64_t(M) * Kp};
  const uint64_t bdims[3] = {uint64_t(K), uint64_t(N), uint64_t(LIMBS) * W};
  const uint64_t bstr[2] = {uint64_t(Kp), uint64_t(N) * Kp};
  if (!make_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, Al, adims, astr, box,
                128) ||
      !make_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, Bl, bdims, bstr, box,
                128))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = modmatmul_tc_kernel<NF>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, W);
  kernel<<<grid, THREADS, SMEM, s>>>(amap, bmap, O, M, K, N, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  a_limbs and b_limbs are scratch
// of W * 4 * M * Kp and W * 4 * N * Kp bytes, Kp a multiple of 16 and at
// least K.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a fold count without an instance, K < 1, a
// grid too large, or a tensor map CUDA refuses.
extern "C" int modmatmul_tc_launch(const void* a, const void* b, void* o,
                                   void* a_limbs, void* b_limbs, int W, int M,
                                   int K, int N, int Kp, long long p,
                                   int fold_bits, long long fold_c, int n_folds,
                                   void* stream) {
  if (W == 0 || M == 0 || N == 0) return 0;
  if (K < 1 || Kp < K || Kp % 16 != 0 || W > 65535 || (M + BM - 1) / BM > 65535)
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
    case 1: return launch<1>(A, B, O, Al, Bl, W, M, K, N, Kp, f, s);
    case 2: return launch<2>(A, B, O, Al, Bl, W, M, K, N, Kp, f, s);
    case 3: return launch<3>(A, B, O, Al, Bl, W, M, K, N, Kp, f, s);
    case 4: return launch<4>(A, B, O, Al, Bl, W, M, K, N, Kp, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
