// Share evaluation F[n, c] = (sum_k V[n, k] * T[k, c]) mod p for Hopper.
//
// Replaces the Pallas kernel _polyeval_kernel
// (src/repro/kernels/polyeval.py:33).  The protocol's table products all
// have this shape: a tiny table V [N, K] (Vandermonde rows, G-mix, decode
// rows; K is tens) against a long T [K, C] whose rows are flattened blocks
// (C = (m/t)^2 or (m/t)(m/s), a million at the main path's shape).
//
// Design.  One thread per output column c; a block of 256 threads covers
// 256 consecutive columns and NB rows of V (NB in {4, 8, 16, 32}, the
// smallest that covers N, with further row groups on gridDim.y).  V is
// staged in shared memory 64 columns of K at a time as uint32 (broadcast
// reads); each thread streams its column of T once, keeping NB uint64
// accumulators in registers, and every load of T feeds NB wide multiplies.
// Rows of V past N are zero in shared memory, so the MAC loop has no
// branches; only the store is masked.  Unlike the Pallas kernel, which kept
// all of K resident and folded once (so it needed K <= acc_window(p) and
// refused M31), this one folds every `window` = acc_window(p) products and
// takes any K on either prime: after a fold an accumulator is < p, and
// p + window * (p-1)^2 < 2^63.
//
// Bound on an H100: the work is bound by bytes, K*C*8 B read plus N*C*8 B
// written.  At the main path's shapes: encode 193 MB (0.058 ms at
// 3.35 TB/s), the G-mix 286 MB (0.085 ms), the mask term 160 MB (0.048 ms),
// decode 84 MB (0.025 ms).  Coalesced 8-byte loads of T, one pass, are what
// this design does about it.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int KT = 64;        // columns of V staged per pass
constexpr int THREADS = 256;  // output columns per block

template <int NB, int NF>
__global__ void __launch_bounds__(THREADS)
    polyeval_kernel(const int64_t* __restrict__ V,
                    const int64_t* __restrict__ T, int64_t* __restrict__ O,
                    int N, int K, long long C, FoldParams f, int window) {
  __shared__ uint32_t Vs[KT][NB];  // Vs[k][r] = V[n0 + r, k0 + k]

  const int n0 = blockIdx.y * NB;
  const long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = c < C;

  uint64_t acc[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = 0;
  int since = 0;  // products accumulated since the last fold

  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int e = threadIdx.x; e < KT * NB; e += THREADS) {
      const int kk = e / NB;
      const int r = e % NB;
      Vs[kk][r] = (n0 + r < N && k0 + kk < K)
                      ? static_cast<uint32_t>(
                            V[static_cast<size_t>(n0 + r) * K + k0 + kk])
                      : 0u;
    }
    __syncthreads();

    const int kt = min(KT, K - k0);
    if (live) {
      for (int kk = 0; kk < kt;) {
        // products allowed before the next fold is due
        const int run = min(kt - kk, window - since);
        for (int q = 0; q < run; ++q, ++kk) {
          const uint32_t t = static_cast<uint32_t>(
              T[static_cast<size_t>(k0 + kk) * C + c]);
#pragma unroll
          for (int r = 0; r < NB; ++r) acc[r] += mul_wide(Vs[kk][r], t);
        }
        since += run;
        if (since == window) {
#pragma unroll
          for (int r = 0; r < NB; ++r) acc[r] = mod_p<NF>(acc[r], f);
          since = 0;
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (n0 + r < N)
      O[static_cast<size_t>(n0 + r) * C + c] =
          static_cast<int64_t>(mod_p<NF>(acc[r], f));
  }
}

template <int NB>
int launch_nb(const int64_t* V, const int64_t* T, int64_t* O, int N, int K,
              long long C, const FoldParams& f, int n_folds, int window,
              cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((C + THREADS - 1) / THREADS),
                  (N + NB - 1) / NB);
  switch (n_folds) {
    case 1:
      polyeval_kernel<NB, 1><<<grid, THREADS, 0, s>>>(V, T, O, N, K, C, f, window);
      break;
    case 2:
      polyeval_kernel<NB, 2><<<grid, THREADS, 0, s>>>(V, T, O, N, K, C, f, window);
      break;
    case 3:
      polyeval_kernel<NB, 3><<<grid, THREADS, 0, s>>>(V, T, O, N, K, C, f, window);
      break;
    case 4:
      polyeval_kernel<NB, 4><<<grid, THREADS, 0, s>>>(V, T, O, N, K, C, f, window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns cudaGetLastError() after
// the launch; cudaErrorInvalidValue for a fold count without an instance.
extern "C" int polyeval_launch(const void* v, const void* t, void* o, int N,
                               int K, long long C, long long p, int fold_bits,
                               long long fold_c, int n_folds, int window,
                               void* stream) {
  if (N == 0 || C == 0) return 0;
  const FoldParams f{static_cast<uint64_t>(p), static_cast<uint32_t>(fold_bits),
                     static_cast<uint64_t>(fold_c)};
  const auto* Vp = static_cast<const int64_t*>(v);
  const auto* Tp = static_cast<const int64_t*>(t);
  auto* Op = static_cast<int64_t*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch_nb<4>(Vp, Tp, Op, N, K, C, f, n_folds, window, s);
  if (N <= 8) return launch_nb<8>(Vp, Tp, Op, N, K, C, f, n_folds, window, s);
  if (N <= 16) return launch_nb<16>(Vp, Tp, Op, N, K, C, f, n_folds, window, s);
  return launch_nb<32>(Vp, Tp, Op, N, K, C, f, n_folds, window, s);
}
