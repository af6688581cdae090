// One hop's fold of the phase-2 ring reduce-scatter: O = (A + B) mod p,
// elementwise, for int32 and int64 payloads.
//
// A port-only kernel.  In the JAX package the fold is plain JAX inside the
// fori_loop of mod_ring_reduce_scatter (src/repro/mpc/secure_matmul.py:43),
// not a Pallas kernel: `(acc.astype(int64) + chunk.astype(int64)) % p`, cast
// back to the wire's type.  The sharded runner
// (src/repro_torch/mpc/secure_matmul.py) launches it once per shard and hop,
// D (D - 1) launches per block on a D-shard mesh with the int32 wire.
//
// Contract: A, B and O contiguous, of one type (int32 or int64) and n
// elements; A and B hold field elements in [0, p) with p < 2^31.  The sum
// is taken in the unsigned type of the payload's width: at most 2 (p - 1) =
// 2^32 - 4 for Mersenne-31, which fits uint32 although it overflows int32.
// One conditional subtract brings it below p.  O may not alias A or B's
// pending readers; the wrapper always allocates it fresh.
//
// Bound on an H100: bytes.  One add and one compare per element against 3
// element-widths of traffic (A and B read once, O written once): at a
// shard's [5, 2^20] int32 chunk, 62.9 MB, 0.019 ms at 3.35 TB/s.
//
// Design.  A grid-stride loop of 16-byte loads and stores (four int32 or two
// int64 per access) when the three bases are 16-byte aligned, with the
// ragged tail done one element at a time; plain element accesses otherwise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

template <typename U>
__device__ __forceinline__ U fold(U a, U b, U p) {
  const U s = a + b;
  return s >= p ? s - p : s;
}

// V: the 16-byte vector of U (uint4 for uint32, ulonglong2 for uint64)
template <typename U, typename V>
__global__ void __launch_bounds__(THREADS)
    ring_fold_vec_kernel(const V* __restrict__ a, const V* __restrict__ b,
                         V* __restrict__ o, long long n_vec, U p) {
  constexpr int L = sizeof(V) / sizeof(U);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < n_vec; i += stride) {
    V x = __ldcs(a + i), y = __ldcs(b + i), z;
    const U* xs = reinterpret_cast<const U*>(&x);
    const U* ys = reinterpret_cast<const U*>(&y);
    U* zs = reinterpret_cast<U*>(&z);
#pragma unroll
    for (int l = 0; l < L; ++l) zs[l] = fold<U>(xs[l], ys[l], p);
    __stcs(o + i, z);
  }
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
    ring_fold_kernel(const U* __restrict__ a, const U* __restrict__ b,
                     U* __restrict__ o, long long n, U p) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride)
    o[i] = fold<U>(a[i], b[i], p);
}

long long blocks_for(long long items) {
  const long long want = (items + THREADS - 1) / THREADS;
  return want < MAX_BLOCKS ? (want > 0 ? want : 1) : MAX_BLOCKS;
}

template <typename U, typename V>
int launch(const void* a, const void* b, void* o, long long n, U p,
           cudaStream_t s) {
  constexpr int L = sizeof(V) / sizeof(U);
  const auto ua = reinterpret_cast<uintptr_t>(a);
  const auto ub = reinterpret_cast<uintptr_t>(b);
  const auto uo = reinterpret_cast<uintptr_t>(o);
  long long done = 0;
  if (((ua | ub | uo) & 15) == 0 && n >= L) {
    const long long n_vec = n / L;
    ring_fold_vec_kernel<U, V><<<blocks_for(n_vec), THREADS, 0, s>>>(
        static_cast<const V*>(a), static_cast<const V*>(b), static_cast<V*>(o),
        n_vec, p);
    done = n_vec * L;
  }
  if (done < n)
    ring_fold_kernel<U><<<blocks_for(n - done), THREADS, 0, s>>>(
        static_cast<const U*>(a) + done, static_cast<const U*>(b) + done,
        static_cast<U*>(o) + done, n - done, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ring_fold_launch(const void* a, const void* b, void* o,
                                long long n, int elem_bytes, long long p,
                                void* stream) {
  if (n == 0) return 0;
  if (n < 0 || p < 2 || p >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<uint32_t, uint4>(a, b, o, n, static_cast<uint32_t>(p), s);
  if (elem_bytes == 8)
    return launch<uint64_t, ulonglong2>(a, b, o, n, static_cast<uint64_t>(p), s);
  return static_cast<int>(cudaErrorInvalidValue);
}
