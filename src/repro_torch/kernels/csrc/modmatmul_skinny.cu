// Skinny modular product O[w] = (A[w] @ B[w]) mod p for Hopper, N <= 4.
//
// Replaces the Pallas kernel _modmatmul_kernel
// (src/repro/kernels/modmatmul.py:42) at the shape the protocol gives it:
// the MAC tags' compression [N, (m/t)^2] @ [(m/t)^2, 1], one product per
// request, and _modmatmul_batched_kernel (src/repro/kernels/modmatmul.py:64)
// for a wave of B requests' tags, [B, N, (m/t)^2] @ [B, (m/t)^2, 1].
//
// Contract: A [W, M, K], B [W, K, N], O [W, M, N], all contiguous int64;
// inputs are field elements in [0, p) with p < 2^31, so each product is one
// 32x32 -> 64-bit wide multiply.
//
// Bound on an H100: bytes.  The work is 2 M K N multiply-adds on 8 (M + N) K
// bytes, about one multiply-add per 8 bytes at N = 1: the product is a
// streaming reduction, and the least time is one read of A and B at the
// copy rate.  At [17, 2^20] @ [2^20, 1]: 151 MB, 0.045 ms at 3.35 TB/s.
//
// Design.  A grid-stride reduction over K, one grid row of blocks per lane
// w and pass of R rows (grid.z = W, grid.y = ceil(M / R), grid.x = G blocks
// sharing K; the wrapper's skinny_blocks sizes G: up to six blocks per SM
// over the grid, each thread taking at least eight steps of K).  Each thread walks K two elements at a time (when K is even
// and the bases 16-byte aligned; one at a time otherwise): it loads the two
// B values once, then the R rows of A with 16-byte streaming loads, and
// keeps R x N uint64 sums in registers.  So every byte of A and B is read
// once, with R independent 16-byte loads in flight per thread, and nothing
// is staged in shared memory.  Sums fold with mod_p every `window` =
// acc_window(p) products: after a fold a sum is < p, and p + window (p-1)^2
// < 2^63 by acc_window's definition, so any K is exact on either prime, the
// all-(p-1) corner included (one fold per 2048 products for p = 2^26 - 5,
// one per 2 for M31).  At the end each sum is folded below p and reduced
// across the warp with shuffles (< 32 p), across the block's 8 warps in
// shared memory (< 256 p < 2^39), folded, and stored as the block's partial.
// A second kernel sums the G partials of each output (< G p < 2^63) and
// folds once; with G = 1 the first kernel writes O itself.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// mod_p with a run-time fold count (field.cuh's mod_p<NF> unrolls a
// template count): nf folds, then one conditional subtract
__device__ __forceinline__ uint64_t fold_rt(uint64_t x, const FoldParams& f,
                                            int nf) {
  const uint64_t mask = (uint64_t{1} << f.b) - 1;
  for (int i = 0; i < nf; ++i) x = f.c * (x >> f.b) + (x & mask);
  return x >= f.p ? x - f.p : x;
}

template <int R, int NN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    skinny_kernel(const int64_t* __restrict__ A, const int64_t* __restrict__ B,
                  int64_t* __restrict__ P, int M, long long K, int N,
                  FoldParams f, int nf, int window) {
  constexpr int STEP = VEC ? 2 : 1;
  __shared__ uint64_t red[WARPS][R * NN];

  const int w = blockIdx.z;
  const int W = gridDim.z;
  const int m0 = blockIdx.y * R;
  const int rows = min(R, M - m0);
  const int64_t* Aw = A + (static_cast<long long>(w) * M + m0) * K;
  const int64_t* Bw = B + static_cast<long long>(w) * K * N;

  uint64_t acc[R][NN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[r][n] = 0;
  int since = 0;  // products per sum since the last fold

  const long long stride = static_cast<long long>(gridDim.x) * THREADS * STEP;
  for (long long k =
           (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * STEP;
       k < K; k += stride) {
    if (since + STEP > window) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int n = 0; n < NN; ++n) acc[r][n] = fold_rt(acc[r][n], f, nf);
      since = 0;
    }
    uint32_t bv[STEP][NN];
    if constexpr (VEC && NN == 1) {
      const ulonglong2 x = __ldg(reinterpret_cast<const ulonglong2*>(Bw + k));
      bv[0][0] = static_cast<uint32_t>(x.x);
      bv[1][0] = static_cast<uint32_t>(x.y);
    } else {
#pragma unroll
      for (int s = 0; s < STEP; ++s)
#pragma unroll
        for (int n = 0; n < NN; ++n)
          bv[s][n] = n < N ? static_cast<uint32_t>(__ldg(Bw + (k + s) * N + n))
                           : 0u;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      const int64_t* ar = Aw + r * K + k;
      uint32_t av[STEP];
      if constexpr (VEC) {
        const longlong2 x = __ldcs(reinterpret_cast<const longlong2*>(ar));
        av[0] = static_cast<uint32_t>(x.x);
        av[1] = static_cast<uint32_t>(x.y);
      } else {
        av[0] = static_cast<uint32_t>(__ldcs(ar));
      }
#pragma unroll
      for (int s = 0; s < STEP; ++s)
#pragma unroll
        for (int n = 0; n < NN; ++n) acc[r][n] += mul_wide(av[s], bv[s][n]);
    }
    since += STEP;
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint64_t v = fold_rt(acc[r][n], f, nf);            // < p
#pragma unroll
      for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][r * NN + n] = v;           // < 32 p
    }
  __syncthreads();
  if (threadIdx.x < R * NN) {
    const int r = threadIdx.x / NN;
    const int n = threadIdx.x % NN;
    if (r < rows && n < N) {
      uint64_t v = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) v += red[q][threadIdx.x];  // < 256 p
      P[(static_cast<long long>(blockIdx.x) * W + w) * M * N +
        static_cast<long long>(m0 + r) * N + n] =
          static_cast<int64_t>(fold_rt(v, f, nf));
    }
  }
}

// O[i] = (sum_g P[g, i]) mod p over the G blocks' partials (each < p)
__global__ void __launch_bounds__(THREADS)
    sum_partials_kernel(const int64_t* __restrict__ P, int64_t* __restrict__ O,
                        long long total, int G, FoldParams f, int nf) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  uint64_t acc = 0;
  for (int g = 0; g < G; ++g)
    acc += static_cast<uint64_t>(P[static_cast<long long>(g) * total + i]);
  O[i] = static_cast<int64_t>(fold_rt(acc, f, nf));
}

template <int R, int NN>
int launch(const int64_t* A, const int64_t* B, int64_t* O, int64_t* P, int W,
           int M, long long K, int N, int G, const FoldParams& f, int nf,
           int window, cudaStream_t s) {
  const bool vec = K % 2 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0 && window >= 2;
  int64_t* out = G == 1 ? O : P;
  const dim3 grid(G, (M + R - 1) / R, W);
  if (vec)
    skinny_kernel<R, NN, true><<<grid, THREADS, 0, s>>>(A, B, out, M, K, N, f,
                                                        nf, window);
  else
    skinny_kernel<R, NN, false><<<grid, THREADS, 0, s>>>(A, B, out, M, K, N, f,
                                                         nf, window);
  if (G > 1) {
    const long long total = static_cast<long long>(W) * M * N;
    sum_partials_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                          THREADS, 0, s>>>(P, O, total, G, f, nf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  `rows` is R, the rows of A one
// block sums (the wrapper's skinny_rows: 8, 20 or 32 for N = 1, 8 or 16
// for N = 2, 8 for N <= 4); `blocks` is G, the blocks sharing one lane's K.
// `partial` is scratch of G * W * M * N int64 when G > 1 (unused
// otherwise).  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or (R, N) it has no instance for.
extern "C" int modmatmul_skinny_launch(const void* a, const void* b, void* o,
                                       void* partial, int W, int M,
                                       long long K, int N, int rows,
                                       int blocks, long long p, int fold_bits,
                                       long long fold_c, int n_folds,
                                       int window, void* stream) {
  if (W == 0 || M == 0 || N == 0) return 0;
  if (K < 1 || N > 4 || blocks < 1 || W > 65535 || window < 1 ||
      n_folds < 1 || n_folds > 4 || (M + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldParams f{static_cast<uint64_t>(p), static_cast<uint32_t>(fold_bits),
                     static_cast<uint64_t>(fold_c)};
  const auto* A = static_cast<const int64_t*>(a);
  const auto* B = static_cast<const int64_t*>(b);
  auto* O = static_cast<int64_t*>(o);
  auto* P = static_cast<int64_t*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  const int nn = N == 1 ? 1 : (N == 2 ? 2 : 4);
  if (nn == 1 && rows == 8)
    return launch<8, 1>(A, B, O, P, W, M, K, N, blocks, f, n_folds, window, s);
  if (nn == 1 && rows == 20)
    return launch<20, 1>(A, B, O, P, W, M, K, N, blocks, f, n_folds, window, s);
  if (nn == 1 && rows == 32)
    return launch<32, 1>(A, B, O, P, W, M, K, N, blocks, f, n_folds, window, s);
  if (nn == 2 && rows == 8)
    return launch<8, 2>(A, B, O, P, W, M, K, N, blocks, f, n_folds, window, s);
  if (nn == 2 && rows == 16)
    return launch<16, 2>(A, B, O, P, W, M, K, N, blocks, f, n_folds, window, s);
  if (nn == 4 && rows == 8)
    return launch<8, 4>(A, B, O, P, W, M, K, N, blocks, f, n_folds, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
