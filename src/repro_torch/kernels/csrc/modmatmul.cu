// Batched modular matrix product O[w] = (A[w] @ B[w]) mod p for Hopper.
//
// Replaces the Pallas kernel _modmatmul_batched_kernel
// (src/repro/kernels/modmatmul.py:64) and, as its W = 1 launch,
// _modmatmul_kernel (src/repro/kernels/modmatmul.py:42).
//
// Contract: A [W, M, K], B [W, K, N], O [W, M, N], all contiguous int64;
// inputs are field elements in [0, p) with p < 2^31, so each product is one
// 32x32 -> 64-bit wide multiply.
//
// Design.  The TPU kernel walks K as a sequential grid dimension and keeps
// the output tile resident as the modular accumulator.  Hopper blocks carry
// nothing between them, so here one block owns one (worker, 64x64 output
// tile) and loops over K itself: 32-deep tiles of A and B are staged in
// shared memory as uint32, and each of the 256 threads keeps a 4x4 register
// micro-tile of uint64 accumulators.  Ragged M, N and K are masked at the
// loads and the store; the host pads nothing.
//
// Split K.  When the output tiles alone cannot fill the card (the MAC-tag
// product [N, (m/t)^2] @ [(m/t)^2, 1] is a single tile), the wrapper asks for
// `splits` > 1: block z = w * splits + s covers K rows [s * k_chunk,
// (s + 1) * k_chunk), stores its partial folded below p into the scratch
// P [splits, W, M, N], and a second kernel sums the splits and folds once.
// That sum stays below splits * p < 2^63 for any splits < 2^32.
//
// Fold cadence.  Every accumulator is folded with mod_p (field.cuh) at least
// every `window` = acc_window(p) products: after a fold it is < p, and
// p + window * (p-1)^2 < 2^63 by acc_window's definition, so the sum never
// leaves mod_p's domain (x < 2^63), the all-(p-1) corner included.  That is
// one fold per 2048 products for p = 2^26 - 5 and one per 2 for M31.
//
// Bound on an H100 at the main path's shape ([17,1024,1024] @ [17,1024,1024],
// 1.83e10 MACs): moving 3 * 17 * 1024^2 * 8 B = 428 MB takes 0.128 ms at
// 3.35 TB/s; the same products as an int8 tensor-core schedule of 7-bit
// limbs (16 limb products for 26-bit p) are 5.8e11 int8 ops, 0.295 ms at
// 1979 TOP/s.  So the work is bound by operations.  This kernel issues its
// MACs as scalar IMAD.WIDE on the CUDA cores, far from that bound; the limb
// schedule on wgmma is the later step that closes the gap.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <int NF>
__device__ __forceinline__ void fold_tile(uint64_t (&acc)[4][4],
                                          const FoldParams& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = mod_p<NF>(acc[i][j], f);
}

template <int NF>
__global__ void __launch_bounds__(THREADS)
    modmatmul_kernel(const int64_t* __restrict__ A,
                     const int64_t* __restrict__ B, int64_t* __restrict__ O,
                     int64_t* __restrict__ P, int M, int K, int N,
                     FoldParams f, int window, int splits, int k_chunk) {
  // A is stored transposed (k-major) and padded by one column so the
  // transposing store hits 32 distinct banks.
  __shared__ uint32_t As[BK][BM + 1];
  __shared__ uint32_t Bs[BK][BN];

  const int w = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int64_t* Aw = A + static_cast<size_t>(w) * M * K;
  const int64_t* Bw = B + static_cast<size_t>(w) * K * N;
  const int W = gridDim.z / splits;
  int64_t* Ow = splits == 1
                    ? O + static_cast<size_t>(w) * M * N
                    : P + (static_cast<size_t>(split) * W + w) * M * N;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  uint64_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  int since = 0;  // products accumulated since the last fold

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK;
      const int col = e % BK;
      const int gm = m0 + row;
      const int gk = k0 + col;
      As[col][row] =
          (gm < M && gk < k_end)
              ? static_cast<uint32_t>(Aw[static_cast<size_t>(gm) * K + gk])
              : 0u;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BN;
      const int col = e % BN;
      const int gk = k0 + row;
      const int gn = n0 + col;
      Bs[row][col] =
          (gk < k_end && gn < N)
              ? static_cast<uint32_t>(Bw[static_cast<size_t>(gk) * N + gn])
              : 0u;
    }
    __syncthreads();

    const int kt = min(BK, k_end - k0);
    for (int kk = 0; kk < kt;) {
      // products allowed before the next fold is due
      const int run = min(kt - kk, window - since);
#pragma unroll 4
      for (int q = 0; q < run; ++q, ++kk) {
        uint32_t a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += mul_wide(a[i], b[j]);
      }
      since += run;
      if (since == window) {
        fold_tile<NF>(acc, f);
        since = 0;
      }
    }
    __syncthreads();
  }

  fold_tile<NF>(acc, f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        Ow[static_cast<size_t>(gm) * N + gn] = static_cast<int64_t>(acc[i][j]);
    }
  }
}

// O[i] = (sum_s P[s, i]) mod p over the splits' partials (each < p).
template <int NF>
__global__ void __launch_bounds__(THREADS)
    sum_splits_kernel(const int64_t* __restrict__ P, int64_t* __restrict__ O,
                      long long total, int splits, FoldParams f) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  uint64_t acc = 0;
  for (int s = 0; s < splits; ++s)
    acc += static_cast<uint64_t>(P[static_cast<size_t>(s) * total + i]);
  O[i] = static_cast<int64_t>(mod_p<NF>(acc, f));
}

template <int NF>
int launch(const int64_t* A, const int64_t* B, int64_t* O, int64_t* P, int W,
           int M, int K, int N, const FoldParams& f, int window, int splits,
           int k_chunk, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, W * splits);
  modmatmul_kernel<NF><<<grid, THREADS, 0, s>>>(A, B, O, P, M, K, N, f, window,
                                                splits, k_chunk);
  if (splits > 1) {
    const long long total = static_cast<long long>(W) * M * N;
    sum_splits_kernel<NF><<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                            THREADS, 0, s>>>(P, O, total, splits, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  `partial` is scratch of
// splits * W * M * N int64 when splits > 1 (unused otherwise); splits *
// k_chunk must cover K.  Returns cudaGetLastError() after the launches;
// cudaErrorInvalidValue for a fold count without an instance or a split
// layout that does not cover K.
extern "C" int modmatmul_batched_launch(const void* a, const void* b, void* o,
                                        void* partial, int W, int M, int K,
                                        int N, int splits, int k_chunk,
                                        long long p, int fold_bits,
                                        long long fold_c, int n_folds,
                                        int window, void* stream) {
  if (W == 0 || M == 0 || N == 0) return 0;
  if (splits < 1 || k_chunk < 1 ||
      static_cast<long long>(splits) * k_chunk < K ||
      static_cast<long long>(W) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldParams f{static_cast<uint64_t>(p), static_cast<uint32_t>(fold_bits),
                     static_cast<uint64_t>(fold_c)};
  const auto* A = static_cast<const int64_t*>(a);
  const auto* B = static_cast<const int64_t*>(b);
  auto* O = static_cast<int64_t*>(o);
  auto* P = static_cast<int64_t*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_folds) {
    case 1: return launch<1>(A, B, O, P, W, M, K, N, f, window, splits, k_chunk, s);
    case 2: return launch<2>(A, B, O, P, W, M, K, N, f, window, splits, k_chunk, s);
    case 3: return launch<3>(A, B, O, P, W, M, K, N, f, window, splits, k_chunk, s);
    case 4: return launch<4>(A, B, O, P, W, M, K, N, f, window, splits, k_chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
