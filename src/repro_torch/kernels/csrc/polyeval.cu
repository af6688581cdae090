// Share evaluation F[n, c] = (sum_k V[n, k] * T[k, c]) mod p for Hopper.
//
// Replaces the Pallas kernel _polyeval_kernel
// (src/repro/kernels/polyeval.py:33).  The protocol's table products all
// have this shape: a tiny table V [N, K] (Vandermonde rows, the G-mix with
// the mask table beside it, decode rows; K is tens) against long rows of T
// (flattened blocks, C = (m/t)^2 or (m/t)(m/s): a million at the main
// path's shape).
//
// Operands.  The K rows of T come from up to two sources, stacked: source 0
// gives its first rows0 rows, source 1 the next rows1.  A source is a base
// pointer and a row stride (rows need unit column stride only), and may
// carry a device index vector: row k of the source is then base row idx[k].
// So the exchange reads [h; mask] against [G-mix^T | mask table] in one
// launch with no stacked copy, and decode reads the survivors' rows of the
// I-points in place of an index_select.  Nothing is built on the host per
// launch, and the index is read on the device only.
//
// Lanes.  One launch also serves B lanes that share V (the batched engine's
// wave of B requests): lane b reads row k of a source at base + b * bs +
// row * ld, with row = idx[b * ibs + k] (or k), and writes O + b * N * C.
// The units of work simply run over the lanes too, so a wave's encode,
// exchange and decode stay one launch each whatever B is.
//
// Bound on an H100: bytes, K*C*8 B read plus N*C*8 B written.  At the main
// path's shapes (p = 2^26-5, C = 2^20, N = 17, z = 2) one block of the
// private matmul makes four launches: encode A and B, K = 6 (192.9 MB,
// 0.0576 ms at 3.35 TB/s, each); the exchange, K = 17 + 2 (302.0 MB,
// 0.0901 ms); decode, K = 6, 4 rows out (83.9 MB, 0.0250 ms).  The MACs are
// 32x32->64-bit integer multiply-adds (IMAD.WIDE), about half the bytes'
// time at K = 19, so the design has to keep HBM busy while they run.
//
// Design.  A persistent grid (two blocks per SM) walks units of work: one
// tile of TC columns and one pass of up to G*R rows of V.  Warp 0 is the
// producer.  For every chunk of KS rows of a unit it waits for a free stage
// of a STAGES-deep ring in shared memory, writes the chunk's V entries
// there as uint32, and issues one 1-D bulk copy (cp.async.bulk) per row
// segment, all completing on the stage's mbarrier.  At KS = 8 rows of 4 KB
// a stage holds 32 KB, so an SM keeps up to 192 KB of loads in flight, far
// above the ~20 KB Little's law asks for at 3.35 TB/s and ~0.8 us.  The
// eight consumer warps own two adjacent columns and R rows of V each (G
// groups of threads split the rows: N = 17 runs as two groups of 9, so no
// row is padded to a power of two); they read T and V from the stage,
// release it, and keep 2R uint64 accumulators in registers, folded every
// `window` = acc_window(p) products: after a fold an accumulator is < p,
// and p + window*(p-1)^2 < 2^63, so any K is exact on either prime.  At
// the end of a unit they fold and store straight from registers, 16 bytes a
// thread, coalesced, while the producer already fills the next stages.
// Measured on an H100, the ring is deep enough (more stages or a second
// ring per SM change nothing); at K = 19 the IMAD.WIDE multiply-adds, not
// the bytes, set the pace (PERF.md).
//
// Bulk copies need 16-byte aligned addresses and sizes.  A row segment that
// starts 8 bytes off alignment (odd C, an odd row stride, a view's offset)
// has its first element loaded by an ordinary load and the rest shifted one
// slot in shared memory; an odd last element is an ordinary load too.  The
// stage records each row's shift.  A ragged last tile copies what exists;
// its unused columns are computed but never stored.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "field.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int PRODUCER = 32;                // warp 0
constexpr int CONSUMERS = 256;              // warps 1..8
constexpr int THREADS = PRODUCER + CONSUMERS;
constexpr int KS = 8;                       // rows of T per stage
constexpr int STAGES = 3;
constexpr int TC_MAX = 2 * CONSUMERS;       // tile columns with one row group
constexpr int ROW_CAP = TC_MAX + 2;         // staged row: shift + odd tail
constexpr int RB_MAX = 64;                  // rows of V per pass (G * RP)

struct Source {
  const int64_t* base;  // row 0 of lane 0
  const int64_t* idx;   // device row indices, or null for rows 0, 1, ...
  long long ld;         // elements between rows
  long long nrows;      // rows an index may address
  int rows;             // rows this source gives to K
  long long bs;         // elements between lanes (0: lanes share the rows)
  long long ibs;        // index entries between lanes (0: one shared index)
};

struct __align__(16) Stage {
  uint32_t v[KS][RB_MAX];                   // V[n0 + g*R + r, k0 + kk] at [kk][g*RP + r]
  int shift[KS];                            // where element 0 of row kk sits
  __align__(16) int64_t t[KS][ROW_CAP];     // element j of row kk at [kk][j + shift]
};
static_assert(sizeof(Stage) % 16 == 0, "stages must stay 16-byte aligned");
static_assert((ROW_CAP * 8) % 16 == 0, "staged rows must stay 16-byte aligned");

constexpr size_t SMEM = STAGES * sizeof(Stage) + 2 * STAGES * sizeof(uint64_t);

// The next unit of a block's walk: `step` units on, carried into the lanes
// (`u` counts units within lane `bl`) without a division.  A one-lane
// instance (LANES false) keeps bl at 0 and compiles the lanes away.
template <bool LANES>
__device__ __forceinline__ void advance(int& bl, int& u, int step,
                                        int lane_units) {
  u += step;
  if (LANES)
    for (; u >= lane_units; u -= lane_units) ++bl;
  else if (u >= lane_units)
    bl = 1;
}

// NF folds of every accumulator (NF is a runtime count, at most 4), then one
// conditional subtract: the twin of field.cuh's mod_p<NF> for an array
template <int N>
__device__ __forceinline__ void fold_all(uint64_t (&a)[N], const FoldParams& f,
                                         int nf) {
  const uint64_t mask = (uint64_t{1} << f.b) - 1;
  for (int i = 0; i < nf; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = f.c * (a[j] >> f.b) + (a[j] & mask);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = a[j] >= f.p ? a[j] - f.p : a[j];
}

template <int R, bool LANES>
__global__ void __launch_bounds__(THREADS, 2)
    polyeval_kernel(const int64_t* __restrict__ V, Source s0, Source s1,
                    int64_t* __restrict__ O, int N, int K, long long C, int G,
                    int tiles, int lane_units, int lanes,
                    FoldParams f, int nf, int window) {
  constexpr int RP = (R + 3) & ~3;          // a row group's stride in v
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * sizeof(Stage));
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCER);            // every producer lane arrives
      mbar_init(&empty[s], CONSUMERS / 32);     // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int tc = TC_MAX / G;                  // tile columns
  const int rblk = G * R;                     // rows of V per pass
  const int lane = threadIdx.x % 32;

  // the batch lane a unit belongs to: 0, known to the compiler, without
  // lanes
  const auto lane_of = [](int bl) { return LANES ? bl : 0; };

  if (threadIdx.x < PRODUCER) {
    // ------------------------------------------------------------ producer
    int it = 0;
    int bl = 0, u = 0;                          // batch lane, unit in it
    for (advance<LANES>(bl, u, blockIdx.x, lane_units); bl < lanes;
         advance<LANES>(bl, u, gridDim.x, lane_units)) {
      const int n0 = u / tiles * rblk;
      const long long c0 = static_cast<long long>(u % tiles) * tc;
      const int len = static_cast<int>(min(static_cast<long long>(tc), C - c0));
      for (int k0 = 0; k0 < K; k0 += KS, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        Stage& st = stage[s];
        const int nk = min(KS, K - k0);
        for (int e = lane; e < nk * G * RP; e += 32) {
          const int kk = e / (G * RP), gr = e % (G * RP);
          const int g = gr / RP, r = gr % RP;
          const int n = n0 + g * R + r;
          st.v[kk][gr] = (r < R && n < N)
                             ? static_cast<uint32_t>(
                                   V[static_cast<long long>(n) * K + k0 + kk])
                             : 0u;
        }
        uint32_t bytes = 0;
        const int64_t* src = nullptr;
        int64_t* dst = nullptr;
        if (lane < nk) {
          const int k = k0 + lane;
          const bool first = k < s0.rows;
          // fields picked one by one: a reference to either parameter
          // struct would copy both to the stack
          const int64_t* base = first ? s0.base : s1.base;
          const int64_t* idx = first ? s0.idx : s1.idx;
          const long long kr = first ? k : k - s0.rows;
          const long long row =
              idx ? idx[lane_of(bl) * (first ? s0.ibs : s1.ibs) + kr] : kr;
          if (row < 0 || row >= (first ? s0.nrows : s1.nrows)) __trap();
          const int64_t* rp = base + lane_of(bl) * (first ? s0.bs : s1.bs) +
                              row * (first ? s0.ld : s1.ld) + c0;
          const int head = (reinterpret_cast<uintptr_t>(rp) & 15) ? 1 : 0;
          const int body = (len - head) & ~1;
          int64_t* row_s = st.t[lane];
          if (head) row_s[1] = __ldg(rp);
          if (head + body < len) row_s[len - 1 + head] = __ldg(rp + len - 1);
          st.shift[lane] = head;
          bytes = static_cast<uint32_t>(body) * 8u;
          src = rp + head;
          dst = row_s + 2 * head;
        }
        fence_proxy_async();
        mbar_expect_tx(&full[s], bytes);        // arrive, and expect the copy
        if (bytes) bulk_load(dst, src, bytes, &full[s]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int ct = threadIdx.x - PRODUCER;
  const int per_group = CONSUMERS / G;        // threads per row group
  const int g = ct / per_group;
  const int j = 2 * (ct % per_group);         // this thread's first column
  int it = 0;
  int bl = 0, u = 0;                            // batch lane, unit in it
  for (advance<LANES>(bl, u, blockIdx.x, lane_units); bl < lanes;
       advance<LANES>(bl, u, gridDim.x, lane_units)) {
    const int n0 = u / tiles * rblk + g * R;
    const long long c = static_cast<long long>(u % tiles) * tc + j;
    uint64_t acc[2 * R];
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) acc[i] = 0;
    int since = 0;                            // products since the last fold
    for (int k0 = 0; k0 < K; k0 += KS, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const Stage& st = stage[s];
      const int nk = min(KS, K - k0);
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const int sh = st.shift[kk];
        uint32_t t0, t1;
        if (sh == 0) {
          const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(&st.t[kk][j]);
          t0 = static_cast<uint32_t>(x.x);
          t1 = static_cast<uint32_t>(x.y);
        } else {
          t0 = static_cast<uint32_t>(st.t[kk][j + 1]);
          t1 = static_cast<uint32_t>(st.t[kk][j + 2]);
        }
        const uint32_t* vrow = &st.v[kk][g * RP];
        uint32_t vv[RP];
#pragma unroll
        for (int q = 0; q < RP; q += 4) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(vrow + q);
          vv[q] = w4.x;
          vv[q + 1] = w4.y;
          vv[q + 2] = w4.z;
          vv[q + 3] = w4.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[2 * r] += mul_wide(vv[r], t0);
          acc[2 * r + 1] += mul_wide(vv[r], t1);
        }
        if (++since == window) {
          fold_all(acc, f, nf);
          since = 0;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fold_all(acc, f, nf);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      if (n >= N || c >= C) continue;
      long long* o =
          reinterpret_cast<long long*>(O) + (lane_of(bl) * N + n) * C + c;
      const long long lo = static_cast<long long>(acc[2 * r]);
      const long long hi = static_cast<long long>(acc[2 * r + 1]);
      // streaming stores: F is read by the next stage, not by this one
      if (c + 1 < C && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
        __stcs(reinterpret_cast<longlong2*>(o), make_longlong2(lo, hi));
      } else {
        __stcs(o, lo);
        if (c + 1 < C) __stcs(o + 1, hi);
      }
    }
  }
}

template <int R, bool LANES>
int launch(const int64_t* V, const Source& s0, const Source& s1, int64_t* O,
           int N, int K, long long C, int B, const FoldParams& f, int nf,
           int window, cudaStream_t stream) {
  // The shared-memory attribute belongs to the current device's context, so
  // it is set, and the occupancy read, on every launch: nothing is cached
  // per process, and a second card in the same process launches too.
  cudaError_t e = cudaFuncSetAttribute(
      polyeval_kernel<R, LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;                             // resident blocks per SM
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, polyeval_kernel<R, LANES>, THREADS, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rb = min(N, RB_MAX);
  const int G = rb <= 16 ? 1 : (rb <= 32 ? 2 : 4);
  const long long tiles = (C + TC_MAX / G - 1) / (TC_MAX / G);
  const long long passes = (N + G * R - 1) / (G * R);
  const long long lane_units = tiles * passes;
  const long long units = lane_units * B;
  const long long grid = min(units, static_cast<long long>(sms) * per_sm);
  // the kernel walks units in 32-bit counters
  if (lane_units + grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  polyeval_kernel<R, LANES>
      <<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(
      V, s0, s1, O, N, K, C, G, static_cast<int>(tiles),
      static_cast<int>(lane_units), B, f, nf, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  For each of B lanes, F = V [N, K]
// against the K rows of T: rows0 rows of source 0, then rows1 of source 1
// (rows1 = 0: none).  A source is (base, idx, ld, nrows, rows, bs, ibs): row
// k of lane b is base + b * bs + (idx ? idx[b * ibs + k] : k) * ld, with idx
// a device int64 array the kernel reads (an entry outside [0, nrows) traps).
// Every row has unit column stride and C columns; O is [B, N, C] contiguous.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// K != rows0 + rows1 or a fold count above 4.
extern "C" int polyeval_launch(const void* v, const void* base0,
                               const void* idx0, long long ld0,
                               long long nrows0, int rows0, long long bs0,
                               long long ibs0, const void* base1,
                               const void* idx1, long long ld1,
                               long long nrows1, int rows1, long long bs1,
                               long long ibs1, void* o, int N, int K,
                               long long C, int B, long long p, int fold_bits,
                               long long fold_c, int n_folds, int window,
                               void* stream) {
  if (K != rows0 + rows1 || n_folds < 1 || n_folds > 4 || window < 1 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || C == 0 || B == 0) return 0;
  const FoldParams f{static_cast<uint64_t>(p), static_cast<uint32_t>(fold_bits),
                     static_cast<uint64_t>(fold_c)};
  const Source s0{static_cast<const int64_t*>(base0),
                  static_cast<const int64_t*>(idx0), ld0, nrows0, rows0, bs0,
                  ibs0};
  const Source s1{static_cast<const int64_t*>(base1),
                  static_cast<const int64_t*>(idx1), ld1, nrows1, rows1, bs1,
                  ibs1};
  const auto* Vp = static_cast<const int64_t*>(v);
  auto* Op = static_cast<int64_t*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  // rows of V per thread: G groups share a pass of up to 64 rows, each group
  // R rows, R the smallest instance that covers them (17 rows: 2 x 9)
  const int rb = N < RB_MAX ? N : RB_MAX;
  const int G = rb <= 16 ? 1 : (rb <= 32 ? 2 : 4);
  const int need = (rb + G - 1) / G;
  // one lane (the unbatched stages) takes the instance without lanes
  const auto run = [&](auto r) {
    constexpr int RR = decltype(r)::value;
    return B == 1
               ? launch<RR, false>(Vp, s0, s1, Op, N, K, C, B, f, n_folds,
                                   window, st)
               : launch<RR, true>(Vp, s0, s1, Op, N, K, C, B, f, n_folds,
                                  window, st);
  };
  if (need <= 2) return run(std::integral_constant<int, 2>{});
  if (need <= 4) return run(std::integral_constant<int, 4>{});
  if (need <= 6) return run(std::integral_constant<int, 6>{});
  if (need <= 9) return run(std::integral_constant<int, 9>{});
  if (need <= 12) return run(std::integral_constant<int, 12>{});
  return run(std::integral_constant<int, 16>{});
}
