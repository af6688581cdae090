// The backward of Mamba's selective scan (diagonal A), for Hopper.
//
// A port-only kernel: the JAX package trains through the XLA autodiff of
// _selective_scan_chunked (src/repro/models/ssm.py:59), plain JAX.  In the
// port the training forward is selective_scan.cu, so its gradient is a
// kernel too.  Mamba's own selective_scan_bwd_kernel (state-spaces/mamba)
// is the model for the layout: the forward keeps h every few steps, and the
// backward re-runs a stretch forward before scanning it in reverse.
//
// Forward, per (batch, channel d, state n), with e_t = exp(dt_t a):
//   h_t = e_t h_{t-1} + dt_t u_t b_t,   h_{-1} = 0;   y_t = sum_n h_t c_t
// Backward, given dy and the final state's gradient (or 0), with
// G_t = dL/dh_t = c_t dy_t + e_{t+1} G_{t+1} running backward in time:
//   du_t[d]   = dt_t sum_n G_t b_t
//   ddt_t[d]  = sum_n G_t (u_t b_t + a e_t h_{t-1})
//   da[d, n]  = sum over batch and t of G_t dt_t e_t h_{t-1}
//   db_t[n]   = sum_d G_t dt_t u_t
//   dc_t[n]   = sum_d h_t dy_t
// h_{t-1} cannot be had from h_t by dividing by e_t: e_t underflows to 0
// where dt is large.
//
// Contract: u, dt [B, T, Di] and b, c [B, T, N], all fp32 or all bf16, read
// through their (batch, step) strides with unit stride along the last dim;
// a [Di, N] fp32; hck [B, ceil(T / 32), Di, N] fp32, h at the start of every
// 32 steps as selective_scan.cu writes it under autograd; dy [B, T, Di] fp32
// contiguous; dhT [B, Di, N] fp32 or null (zero).  Writes du, ddt [B, T, Di]
// and db, dc [B, T, N] in the operands' type, and da [Di, N] fp32, all
// contiguous.  Scratch: db and dc per block of channels [B, nblk, T, N] and
// da per batch row [B, Di, N], fp32.  N is 8, 16 or 32.  No atomics: the
// sums over channels and batch rows go through those partials and a reduce
// kernel that adds them in one order, so the same inputs give the same bits.
//
// Two instances (kernels/selective_scan.py's choose_bwd_instance picks
// one): the `sweep` below, for any operands, and the `tma` instance after
// it, for bf16 operands a TMA map takes (the training path).
//
// The sweep: two kernels in one launch.
//   1. scan_bwd_kernel: one block per (batch row, 32 channels), 2 states a thread
//      (a channel's N states on N / 2 neighbouring lanes: 4 states a thread,
//      as the forward's tma instance lays them out, gave half the warps and
//      ran slower).  It walks the 32-step stretches backward;
//      for each it stages u, dt, dy, b and c in shared memory as fp32, re-runs
//      the stretch forward from its checkpoint storing h_{t-1} and h_t for
//      every step (33 x 32 channels x N floats: 66 KB at N = 16; each thread
//      its own float2s), sums dc over the block's channels from those states,
//      then steps G backward: du and ddt reduce over the channel's lanes (3
//      shuffles each at N = 16), da stays in registers for all of T, and
//      G dt u overwrites the slot of h_t (no longer needed) so that db sums
//      over the channels from shared memory too.  The exponentials are
//      ex2.approx of dt a log2(e), as in the tma forward.
//   2. scan_bwd_reduce_kernel: db and dc over the blocks of channels, da over the
//      batch rows, in order.
//
// Bound on an H100 at jamba-v0.1-52b's training microbatch (bf16, B 1, T
// 2048, Di 8192, N 16): u and dt read and du and ddt written in bf16 (134.2
// MB), dy read in fp32 (67.1 MB), the checkpoints (16.8 MB) and b, c, a,
// db, dc and da (about 1.3 MB) are 219 MB, 0.065 ms at 3.35 TB/s; about 20
// fp32 operations per (b, t, d, n) are 5.4 GFLOP, 0.080 ms at 67 TFLOP/s; and
// one exponential per (b, t, d, n), 0.27e9 of them on 16 special-function
// lanes per SM (132 SMs, 1.98 GHz) take 0.064 ms.  This design takes two
// exponentials per element (the re-run's and the reverse step's), a floor of
// 0.128 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CK = 32;             // steps between checkpoints (selective_scan.cu)
constexpr int CH = 32;             // channels per block
constexpr int SPT = 2;             // states per thread
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, t;                  // elements between batch rows, steps
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
struct Layout {                    // shared memory, in floats
  static constexpr int L = N / SPT;                // lanes a channel
  static constexpr int THREADS = CH * L;
  static constexpr int HS = (CK + 1) * CH * N;     // h_{t0-1} .. h_{t0+31}
  static constexpr int OPS = 5 * CK * CH;          // u, dt, dy, du, ddt
  static constexpr int BC = 2 * CK * N;            // b, c
  static constexpr size_t BYTES = sizeof(float) * (HS + OPS + BC);
};

template <typename T, int N>
__global__ void __launch_bounds__(Layout<N>::THREADS)
    scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
             const float* __restrict__ a, const T* __restrict__ bt,
             const T* __restrict__ ct, const float* __restrict__ hck,
             const float* __restrict__ dy, const float* __restrict__ dhT,
             T* __restrict__ du, T* __restrict__ ddt, float* __restrict__ da_part,
             float* __restrict__ db_part, float* __restrict__ dc_part, int Tn,
             int Di, Strides us, Strides ds, Strides bs, Strides cs) {
  using Ly = Layout<N>;
  constexpr int L = Ly::L;
  constexpr int THREADS = Ly::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                        // [CK + 1][CH][N]: slot s holds h_{t0+s-1}
  float* su = hs + Ly::HS;                 // [CK][CH]
  float* sdt = su + CK * CH;
  float* sdy = sdt + CK * CH;
  float* sdu = sdy + CK * CH;
  float* sddt = sdu + CK * CH;
  float* sb = sddt + CK * CH;              // [CK][N]
  float* sc = sb + CK * N;

  const int tid = threadIdx.x;
  const int ch = tid / L;
  const int n0 = (tid % L) * SPT;          // this thread's states n0, n0 + 1
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const bool live = d < Di;
  const int nck = (Tn + CK - 1) / CK;

  float a2[SPT], av[SPT], g[SPT], enext[SPT], da[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = live ? a[static_cast<long long>(d) * N + n0 + j] : 0.f;
    a2[j] = av[j] * LOG2E;
    g[j] = (live && dhT != nullptr)
               ? dhT[(static_cast<long long>(b) * Di + d) * N + n0 + j] : 0.f;
    enext[j] = 1.f;                        // e_{t+1}: none past T
    da[j] = 0.f;
  }

  // the next stretch's operands and checkpoint, loaded into registers while
  // this one computes (staged by plain loads one after another, the loads'
  // latency set the pace): u, dt, dy at channel jc of steps js + q SR, b and
  // c at element tid + q THREADS
  constexpr int OPT = CK * CH / THREADS, BPT = CK * N / THREADS;
  constexpr int SR = THREADS / CH;
  const int jc = tid % CH, js = tid / CH;
  float pu[OPT], pdt[OPT], pdy[OPT], pb[BPT], pc[BPT];
  float2 ph = make_float2(0.f, 0.f);
  auto fetch = [&](int ci) {
    const int t0 = ci * CK, n = min(CK, Tn - t0);
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int s = js + q * SR;
      const long long t = t0 + s;
      pu[q] = pdt[q] = pdy[q] = 0.f;
      if (s < n && d0 + jc < Di) {
        pu[q] = to_f32(u[b * us.b + t * us.t + d0 + jc]);
        pdt[q] = to_f32(dt[b * ds.b + t * ds.t + d0 + jc]);
        pdy[q] = dy[(static_cast<long long>(b) * Tn + t) * Di + d0 + jc];
      }
    }
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      const int e = tid + q * THREADS, s = e / N, k = e % N;
      const long long t = t0 + s;
      if (s < n) {
        pb[q] = to_f32(bt[b * bs.b + t * bs.t + k]);
        pc[q] = to_f32(ct[b * cs.b + t * cs.t + k]);
      }
    }
    if (live)
      ph = *reinterpret_cast<const float2*>(
          hck + ((static_cast<long long>(b) * nck + ci) * Di + d) * N + n0);
  };

  if (nck > 0) fetch(nck - 1);
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int t0 = ci * CK, n = min(CK, Tn - t0);
    // stage the stretch as fp32 (zero past Di)
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int s = js + q * SR;
      if (s < n) {
        su[s * CH + jc] = pu[q];
        sdt[s * CH + jc] = pdt[q];
        sdy[s * CH + jc] = pdy[q];
      }
    }
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      const int e = tid + q * THREADS;
      if (e / N < n) {
        sb[e] = pb[q];
        sc[e] = pc[q];
      }
    }
    float h[SPT] = {ph.x, ph.y};
    __syncthreads();
    if (ci > 0) fetch(ci - 1);
    // re-run the stretch forward: slot s + 1 gets h_{t0+s}
    *reinterpret_cast<float2*>(&hs[ch * N + n0]) = make_float2(h[0], h[1]);
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float dtv = sdt[s * CH + ch];
      const float dtu = dtv * su[s * CH + ch];
      const float2 b2 = *reinterpret_cast<const float2*>(&sb[s * N + n0]);
      const float bv[SPT] = {b2.x, b2.y};
#pragma unroll
      for (int j = 0; j < SPT; ++j) h[j] = fmaf(ex2(dtv * a2[j]), h[j], dtu * bv[j]);
      *reinterpret_cast<float2*>(&hs[((s + 1) * CH + ch) * N + n0]) =
          make_float2(h[0], h[1]);
    }
    __syncthreads();
    // dc_t[k] = sum over the block's channels of h_t dy_t
    for (int e = tid; e < n * N; e += THREADS) {
      const int s = e / N, k = e % N;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < CH; ++c)
        acc = fmaf(hs[((s + 1) * CH + c) * N + k], sdy[s * CH + c], acc);
      dc_part[((static_cast<long long>(b) * nblk + blockIdx.x) * Tn + t0 + s) * N + k] =
          acc;
    }
    __syncthreads();
    // the reverse steps
#pragma unroll 4
    for (int s = n - 1; s >= 0; --s) {
      const float dtv = sdt[s * CH + ch], uv = su[s * CH + ch], dyv = sdy[s * CH + ch];
      const float2 b2 = *reinterpret_cast<const float2*>(&sb[s * N + n0]);
      const float2 c2 = *reinterpret_cast<const float2*>(&sc[s * N + n0]);
      const float2 p2 = *reinterpret_cast<const float2*>(&hs[(s * CH + ch) * N + n0]);
      const float bv[SPT] = {b2.x, b2.y};
      const float cv[SPT] = {c2.x, c2.y};
      const float hp[SPT] = {p2.x, p2.y};             // h_{t-1}
      float dup = 0.f, ddtp = 0.f, q[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float gt = fmaf(enext[j], g[j], cv[j] * dyv);   // G_t
        const float e = ex2(dtv * a2[j]);
        const float eh = e * hp[j];
        dup = fmaf(gt, bv[j], dup);
        ddtp = fmaf(gt, fmaf(uv, bv[j], av[j] * eh), ddtp);
        da[j] = fmaf(gt * dtv, eh, da[j]);
        q[j] = gt * dtv * uv;
        g[j] = gt;
        enext[j] = e;
      }
      // slot s + 1 (h_t) was last read by step t + 1: it takes G_t dt_t u_t
      *reinterpret_cast<float2*>(&hs[((s + 1) * CH + ch) * N + n0]) =
          make_float2(q[0], q[1]);
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        dup += __shfl_xor_sync(0xffffffffu, dup, off, L);
        ddtp += __shfl_xor_sync(0xffffffffu, ddtp, off, L);
      }
      if (n0 == 0) {
        sdu[s * CH + ch] = dup * dtv;
        sddt[s * CH + ch] = ddtp;
      }
    }
    __syncthreads();
    // db_t[k] = sum over the block's channels of G_t dt_t u_t
    for (int e = tid; e < n * N; e += THREADS) {
      const int s = e / N, k = e % N;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < CH; ++c) acc += hs[((s + 1) * CH + c) * N + k];
      db_part[((static_cast<long long>(b) * nblk + blockIdx.x) * Tn + t0 + s) * N + k] =
          acc;
    }
    for (int e = tid; e < n * CH; e += THREADS) {
      const int s = e / CH, c = e % CH;
      if (d0 + c < Di) {
        const long long at = (static_cast<long long>(b) * Tn + t0 + s) * Di + d0 + c;
        put(du + at, sdu[e]);
        put(ddt + at, sddt[e]);
      }
    }
    __syncthreads();
  }
  if (live)
    *reinterpret_cast<float2*>(da_part + (static_cast<long long>(b) * Di + d) * N + n0) =
        make_float2(da[0], da[1]);
}

// db and dc over the blocks of channels, da over the batch rows, in order
template <typename T>
__global__ void __launch_bounds__(256)
    scan_bwd_reduce_kernel(const float* __restrict__ db_part,
                    const float* __restrict__ dc_part,
                    const float* __restrict__ da_part, T* __restrict__ db,
                    T* __restrict__ dc, float* __restrict__ da, int B, int Tn,
                    int Di, int N, int nblk) {
  const long long tn = static_cast<long long>(Tn) * N;
  const long long nbc = B * tn, nda = static_cast<long long>(Di) * N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < nbc + nda;
       i += 256LL * gridDim.x) {
    if (i < nbc) {
      const long long b = i / tn, r = i % tn;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < nblk; ++k) {
        sb += db_part[(b * nblk + k) * tn + r];
        sc += dc_part[(b * nblk + k) * tn + r];
      }
      put(db + i, sb);
      put(dc + i, sc);
    } else {
      const long long j = i - nbc;
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += da_part[b * nda + j];
      da[j] = s;
    }
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* a, const void* bt,
           const void* ct, const void* hck, const void* dy, const void* dhT,
           void* du, void* ddt, void* da, void* db, void* dc, void* da_part,
           void* db_part, void* dc_part, int B, int Tn, int Di,
           const Strides& us, const Strides& ds, const Strides& bs,
           const Strides& cs, cudaStream_t st) {
  using Ly = Layout<N>;
  const int nblk = (Di + CH - 1) / CH;
  auto kernel = scan_bwd_kernel<T, N>;
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Ly::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nblk, B), Ly::THREADS, Ly::BYTES, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bt),
      static_cast<const T*>(ct), static_cast<const float*>(hck),
      static_cast<const float*>(dy), static_cast<const float*>(dhT),
      static_cast<T*>(du), static_cast<T*>(ddt), static_cast<float*>(da_part),
      static_cast<float*>(db_part), static_cast<float*>(dc_part), Tn, Di, us,
      ds, bs, cs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = static_cast<long long>(B) * Tn * N + static_cast<long long>(Di) * N;
  const long long blocks = (work + 255) / 256;
  const int grid = static_cast<int>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
  scan_bwd_reduce_kernel<T><<<grid, 256, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<const float*>(da_part), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), B, Tn, Di, N, nblk);
  return static_cast<int>(cudaGetLastError());
}


// ================================================== the tma instance
// (scan_bwd_kernel above stays as the `sweep` instance: any strides)
//
// For bf16 operands a TMA map takes (bases 16-byte aligned, batch and
// step strides multiples of 16 bytes: the served layout).  One block of 128
// threads per (batch row, CH = 512 / N channels: 32 at N = 16), 4 states a
// thread (N / 4 lanes a channel: du's and ddt's sums over the channel's
// lanes are log2(N / 4) shuffles for 4 states; 2 states a thread, 16 warps
// an SM, ran slower on an H100: PERF.md).  It walks the 32-step stretches
// backward; for each:
//   * one thread keeps a ring of three stretches in flight: u, dt and dy as
//     [32, CH] boxes and b, c as [32, N] boxes by TMA, zero past T and Di,
//     completing on the stage's mbarrier;
//   * the stretch in two halves of 16 steps, the later first: the re-run
//     forward from the checkpoint keeps e_t = exp(dt_t a) and e_t h_{t-1}
//     for the half's steps in shared memory (64 KB, so two blocks share an
//     SM; the later half first advances h over the earlier one, so an
//     element takes 1.5 exponentials, not the sweep's 2): the reverse step
//     reads e_{t+1} for G's chain and e_t h_{t-1} for ddt and da, and
//     rebuilds h_t = e_t h_{t-1} + dt u b for dc;
//   * steps in groups of U = 4, each group's shared-memory loads issued
//     before its stores (the compiler cannot tell them apart and had kept
//     each step's loads behind the step before); G's fma chains from step
//     to step, the rest of the group (the sums, their shuffles) is
//     independent; each step overwrites its two slots with h_t dy_t and
//     G_t dt_t u_t;
//   * dc and db are those slots summed over the block's channels in one
//     order (two lanes a (step, 4 states), half the channels each), du and
//     ddt leave from shared memory;
//   * db and dc over the blocks, and da over the batch rows, in a fixed
//     tree (tree_reduce_kernel).
// Bound as the sweep's; its 1.5 exponentials an element are a 0.096 ms
// floor at jamba's training shape.  fp32 operands double the ring and fit
// one block an SM: selective_scan.py routes them to the sweep.
namespace ring {

using namespace hopper;

constexpr int SPT = 4;             // states per thread
constexpr int STAGES = 3;          // stretches in flight
constexpr int U = 4;               // reverse steps per group
constexpr int HS = CK / 2;         // steps whose e and e h are kept at once

template <typename T, int N>
struct Geo {
  static constexpr int CH = 512 / N;             // channels per block
  static constexpr int L = N / SPT;              // lanes a channel
  static constexpr int THREADS = CH * L;
  static constexpr int UT = CK * CH * sizeof(T); // a u or dt box
  static constexpr int YT = CK * CH * 4;         // a dy box (fp32)
  static constexpr int BT = CK * N * sizeof(T);  // a b or c box
  static constexpr int STAGE = 2 * UT + YT + 2 * BT;  // a multiple of 128
  static constexpr int EB = HS * CH * N * 4;     // e (or e h) of half a stretch
  static constexpr size_t SMEM = 128 + STAGES * size_t(STAGE) + 2 * size_t(EB) +
                                 CK * 2 * N * 4 + 2 * CK * CH * 4 + 8 * STAGES;
};

__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// this thread's SPT consecutive floats (one 8- or 16-byte access)
__device__ __forceinline__ void ld(float (&x)[SPT], const float* p) {
  if constexpr (SPT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}
__device__ __forceinline__ void sto(float* p, const float (&x)[SPT]) {
  if constexpr (SPT == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

template <typename T, int N>
__global__ void __launch_bounds__(512 / SPT, 2)
    ring_bwd_kernel(const __grid_constant__ CUtensorMap umap,
                    const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const float* __restrict__ a, const float* __restrict__ hck,
                    const float* __restrict__ dhT, T* __restrict__ du,
                    T* __restrict__ ddt, float* __restrict__ da_part,
                    float* __restrict__ db_part, float* __restrict__ dc_part, int Tn,
                    int Di) {
  using G = Geo<T, N>;
  constexpr int CH = G::CH, L = G::L, THREADS = G::THREADS;
  extern __shared__ uint8_t smem_rb[];
  uint8_t* stages = smem_rb + ((128 - (smem_u32(smem_rb) & 127)) & 127);
  float* E = reinterpret_cast<float*>(stages + STAGES * G::STAGE);  // [HS][CH][N]
  float* EH = E + HS * CH * N;
  float* sbc = EH + HS * CH * N;           // [CK][b | c] as fp32
  float* sdu = sbc + CK * 2 * N;           // [CK][CH]
  float* sddt = sdu + CK * CH;
  uint64_t* full = reinterpret_cast<uint64_t*>(sddt + CK * CH);

  const int tid = threadIdx.x;
  const int ch = tid / L;
  const int n0 = (tid % L) * SPT;          // this thread's states n0 .. n0 + 3
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const bool live = d < Di;
  const int nck = (Tn + CK - 1) / CK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // the i-th stretch from the end into stage i % STAGES
  auto issue = [&](int i) {
    uint8_t* st = stages + (i % STAGES) * G::STAGE;
    uint64_t* bar = &full[i % STAGES];
    const int t0 = (nck - 1 - i) * CK;
    mbar_expect_tx(bar, G::STAGE);
    tma_load_3d(st, &umap, bar, d0, t0, b);
    tma_load_3d(st + G::UT, &dmap, bar, d0, t0, b);
    tma_load_3d(st + 2 * G::UT, &ymap, bar, d0, t0, b);
    tma_load_3d(st + 2 * G::UT + G::YT, &bmap, bar, 0, t0, b);
    tma_load_3d(st + 2 * G::UT + G::YT + G::BT, &cmap, bar, 0, t0, b);
  };
  if (tid == 0)
    for (int i = 0; i < min(STAGES - 1, nck); ++i) issue(i);

  float a2[SPT], av[SPT], g[SPT], enext[SPT], da[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = live ? a[static_cast<long long>(d) * N + n0 + j] : 0.f;
    a2[j] = av[j] * LOG2E;
    g[j] = (live && dhT != nullptr)
               ? dhT[(static_cast<long long>(b) * Di + d) * N + n0 + j] : 0.f;
    enext[j] = 1.f;                        // e_{t+1}: none past T
    da[j] = 0.f;
  }
  float hnext[SPT] = {};
  auto checkpoint = [&](int ci) {
    if (live) ld(hnext, hck + ((static_cast<long long>(b) * nck + ci) * Di + d) * N + n0);
  };
  if (nck > 0) checkpoint(nck - 1);

  for (int i = 0; i < nck; ++i) {
    const int ci = nck - 1 - i, t0 = ci * CK, n = min(CK, Tn - t0);
    // the stage of stretch i - 1 is free: every thread passed the barrier
    // that ended it
    if (tid == 0 && i + STAGES - 1 < nck) {
      fence_proxy_async();
      issue(i + STAGES - 1);
    }
    float h[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) h[j] = hnext[j];
    if (i + 1 < nck) checkpoint(ci - 1);
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    const uint8_t* st = stages + (i % STAGES) * G::STAGE;
    const T* su = reinterpret_cast<const T*>(st);
    const T* sd = reinterpret_cast<const T*>(st + G::UT);
    const float* sy = reinterpret_cast<const float*>(st + 2 * G::UT);
    const T* sb = reinterpret_cast<const T*>(st + 2 * G::UT + G::YT);
    const T* sc = reinterpret_cast<const T*>(st + 2 * G::UT + G::YT + G::BT);
    for (int e = tid; e < CK * N; e += THREADS) {  // b and c as fp32, once
      const int r = e / N, k = e % N;
      sbc[r * 2 * N + k] = to_f32(sb[e]);
      sbc[r * 2 * N + N + k] = to_f32(sc[e]);
    }
    __syncthreads();
    // two halves of HS steps, the later first: re-run the half forward
    // keeping e_t and e_t h_{t-1} (the later half first advances h over the
    // earlier one), scan it in reverse, then sum its slots (rows past T are
    // zero: e = 1 there, and their slots are never read)
    float* Ec = E + ch * N + n0;
    float* EHc = EH + ch * N + n0;
    for (int hf = 1; hf >= 0; --hf) {
      const int base = hf * HS, m = min(HS, n - base);
      if (m <= 0) continue;
      float hh[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) hh[j] = h[j];
      if (hf == 1) {
#pragma unroll 4
        for (int s = 0; s < HS; ++s) {
          const float dtv = to_f32(sd[s * CH + ch]);
          const float dtu = dtv * to_f32(su[s * CH + ch]);
          float bv[SPT];
          ld(bv, sbc + s * 2 * N + n0);
#pragma unroll
          for (int j = 0; j < SPT; ++j) hh[j] = fmaf(ex2(dtv * a2[j]), hh[j], dtu * bv[j]);
        }
      }
      // each group of U steps loads all its operands before its first store
      // (the stores to E and EH could alias the loads for the compiler,
      // which then kept every step's loads behind the last step's stores)
#pragma unroll 2
      for (int s0 = 0; s0 < m; s0 += U) {
        float dtv[U], dtu[U], bv[U][SPT], ev[U][SPT];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int r = base + s0 + k;
          dtv[k] = to_f32(sd[r * CH + ch]);
          dtu[k] = dtv[k] * to_f32(su[r * CH + ch]);
          ld(bv[k], sbc + r * 2 * N + n0);
        }
#pragma unroll
        for (int k = 0; k < U; ++k)
#pragma unroll
          for (int j = 0; j < SPT; ++j) ev[k][j] = ex2(dtv[k] * a2[j]);
#pragma unroll
        for (int k = 0; k < U; ++k) {
          float ehv[SPT];
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            ehv[j] = ev[k][j] * hh[j];
            hh[j] = fmaf(dtu[k], bv[k][j], ehv[j]);
          }
          sto(Ec + (s0 + k) * CH * N, ev[k]);
          sto(EHc + (s0 + k) * CH * N, ehv);
        }
      }
      // the reverse steps, U at a time (the last group may reach below 0)
      for (int s1 = m - 1; s1 >= 0; s1 -= U) {
        float dtv[U], uv[U], dyv[U], bv[U][SPT], cv[U][SPT], ev[U][SPT], ehv[U][SPT];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int s = max(s1 - k, 0), r = base + s;
          dtv[k] = to_f32(sd[r * CH + ch]);
          uv[k] = to_f32(su[r * CH + ch]);
          dyv[k] = sy[r * CH + ch];
          ld(bv[k], sbc + r * 2 * N + n0);
          ld(cv[k], sbc + r * 2 * N + N + n0);
          ld(ev[k], Ec + s * CH * N);
          ld(ehv[k], EHc + s * CH * N);
        }
        float dup[U], ddtp[U], hd[U][SPT], q[U][SPT];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const bool ok = s1 - k >= 0;
          const float dtu = dtv[k] * uv[k];
          dup[k] = ddtp[k] = 0.f;
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            const float gt = fmaf(enext[j], g[j], cv[k][j] * dyv[k]);   // G_t
            dup[k] = fmaf(gt, bv[k][j], dup[k]);
            ddtp[k] = fmaf(gt, fmaf(uv[k], bv[k][j], av[j] * ehv[k][j]), ddtp[k]);
            q[k][j] = gt * dtu;
            hd[k][j] = fmaf(dtu, bv[k][j], ehv[k][j]) * dyv[k];          // h_t dy_t
            if (ok) {
              da[j] = fmaf(gt * dtv[k], ehv[k][j], da[j]);
              g[j] = gt;
              enext[j] = ev[k][j];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (s1 - k >= 0) {
            sto(Ec + (s1 - k) * CH * N, hd[k]);
            sto(EHc + (s1 - k) * CH * N, q[k]);
          }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
          for (int k = 0; k < U; ++k) {
            dup[k] += __shfl_xor_sync(0xffffffffu, dup[k], off, L);
            ddtp[k] += __shfl_xor_sync(0xffffffffu, ddtp[k], off, L);
          }
        if (n0 == 0) {
#pragma unroll
          for (int k = 0; k < U; ++k)
            if (s1 - k >= 0) {
              sdu[(base + s1 - k) * CH + ch] = dup[k] * dtv[k];
              sddt[(base + s1 - k) * CH + ch] = ddtp[k];
            }
        }
      }
      __syncthreads();
      // dc and db of the half: the slots summed over the block's channels,
      // in one order: two neighbouring lanes take half the channels each
      // and add their sums (every lane busy, half the chain)
      for (int e0 = 0; e0 < 2 * m * (N / 4); e0 += THREADS) {  // uniform: the
        const int e = e0 + tid;                                 // shuffle below
        const bool act = e < 2 * m * (N / 4);
        const int item = act ? e >> 1 : 0, part = e & 1;
        const int s = item / (N / 4), k4 = (item % (N / 4)) * 4;
        float4 dc4 = make_float4(0.f, 0.f, 0.f, 0.f), db4 = dc4;
#pragma unroll 4
        for (int c = part * (CH / 2); c < (part + 1) * (CH / 2); ++c) {
          const float4 x = f4(E + (s * CH + c) * N + k4), y = f4(EH + (s * CH + c) * N + k4);
          dc4.x += x.x; dc4.y += x.y; dc4.z += x.z; dc4.w += x.w;
          db4.x += y.x; db4.y += y.y; db4.z += y.z; db4.w += y.w;
        }
        float v[8] = {dc4.x, dc4.y, dc4.z, dc4.w, db4.x, db4.y, db4.z, db4.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float other = __shfl_xor_sync(0xffffffffu, v[j], 1);
          v[j] = part ? other + v[j] : v[j] + other;   // channels 0.. first
        }
        if (act && part == 0) {
          const long long at =
              ((static_cast<long long>(b) * nblk + blockIdx.x) * Tn + t0 + base + s) * N + k4;
          *reinterpret_cast<float4*>(dc_part + at) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(db_part + at) = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
      __syncthreads();                     // E and EH are refilled by the next half
    }
    for (int e = tid; e < n * CH; e += THREADS) {
      const int s = e / CH, c = e % CH;
      if (d0 + c < Di) {
        const long long at = (static_cast<long long>(b) * Tn + t0 + s) * Di + d0 + c;
        put(du + at, sdu[e]);
        put(ddt + at, sddt[e]);
      }
    }
    __syncthreads();                       // the stage and the staging are reused
  }
  if (live) sto(da_part + (static_cast<long long>(b) * Di + d) * N + n0, da);
}

// db and dc over the blocks of channels in a fixed tree (8 groups of a
// block's threads each add every 8th partial of 32 outputs, then the 8 sums
// are added in order; the sweep's one thread an output, 256 partials in a
// row, is latency-bound); da over the batch rows, in order
template <typename T>
__global__ void __launch_bounds__(256)
    tree_reduce_kernel(const float* __restrict__ db_part,
                       const float* __restrict__ dc_part,
                       const float* __restrict__ da_part, T* __restrict__ db,
                       T* __restrict__ dc, float* __restrict__ da, int B, int Tn,
                       int Di, int N, int nblk) {
  __shared__ float sb[8][32], sc[8][32];
  const long long tn = static_cast<long long>(Tn) * N, nbc = B * tn;
  const long long nbc_blocks = (nbc + 31) / 32;
  const int o = threadIdx.x & 31, grp = threadIdx.x >> 5;
  if (blockIdx.x < nbc_blocks) {
    const long long i = blockIdx.x * 32LL + o;
    float xb = 0.f, xc = 0.f;
    if (i < nbc) {
      const long long bb = i / tn, r = i % tn;
      for (int k = grp; k < nblk; k += 8) {
        xb += db_part[(bb * nblk + k) * tn + r];
        xc += dc_part[(bb * nblk + k) * tn + r];
      }
    }
    sb[grp][o] = xb;
    sc[grp][o] = xc;
    __syncthreads();
    if (grp == 0 && i < nbc) {
      float yb = 0.f, yc = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        yb += sb[q][o];
        yc += sc[q][o];
      }
      put(db + i, yb);
      put(dc + i, yc);
    }
  } else {
    const long long j = (blockIdx.x - nbc_blocks) * 256LL + threadIdx.x;
    const long long nda = static_cast<long long>(Di) * N;
    if (j < nda) {
      float sum = 0.f;
      for (int bb = 0; bb < B; ++bb) sum += da_part[bb * nda + j];
      da[j] = sum;
    }
  }
}

// a [B, T, W] operand as a 3-D tensor map (W, T, B) loaded in boxes of
// (box_w, CK, 1), no swizzle, zero fill outside; false when CUDA refuses it
// (a base or stride that is not a multiple of 16 bytes)
template <typename T>
bool operand_map(CUtensorMap* map, const void* base, int B, int Tn, int W,
                 const Strides& st, int box_w) {
  const uint64_t dims[3] = {uint64_t(W), uint64_t(Tn > 0 ? Tn : 1), uint64_t(B)};
  const uint64_t strides[2] = {uint64_t(st.t) * sizeof(T), uint64_t(st.b) * sizeof(T)};
  const uint32_t box[3] = {uint32_t(box_w), uint32_t(CK), 1u};
  return make_map(map,
                  sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, base, dims, strides, box, 0);
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* a, const void* bt,
           const void* ct, const void* hck, const void* dy, const void* dhT,
           void* du, void* ddt, void* da, void* db, void* dc, void* da_part,
           void* db_part, void* dc_part, int B, int Tn, int Di,
           const Strides& us, const Strides& ds, const Strides& bs,
           const Strides& cs, cudaStream_t st) {
  using Gm = Geo<T, N>;
  CUtensorMap um, dm, ym, bm, cm;
  const Strides ys{static_cast<long long>(Tn) * Di, Di};  // dy is contiguous
  if (!operand_map<T>(&um, u, B, Tn, Di, us, Gm::CH) ||
      !operand_map<T>(&dm, dt, B, Tn, Di, ds, Gm::CH) ||
      !operand_map<float>(&ym, dy, B, Tn, Di, ys, Gm::CH) ||
      !operand_map<T>(&bm, bt, B, Tn, N, bs, N) ||
      !operand_map<T>(&cm, ct, B, Tn, N, cs, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (Di + Gm::CH - 1) / Gm::CH;
  auto kernel = ring_bwd_kernel<T, N>;
  // set on every launch: the attribute belongs to the current device's context
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Gm::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nblk, B), Gm::THREADS, Gm::SMEM, st>>>(
      um, dm, ym, bm, cm, static_cast<const float*>(a), static_cast<const float*>(hck),
      static_cast<const float*>(dhT), static_cast<T*>(du), static_cast<T*>(ddt),
      static_cast<float*>(da_part), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), Tn, Di);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (static_cast<long long>(B) * Tn * N + 31) / 32 +
                           (static_cast<long long>(Di) * N + 255) / 256;
  tree_reduce_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<const float*>(da_part), static_cast<T*>(db), static_cast<T*>(dc),
      static_cast<float*>(da), B, Tn, Di, N, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring

// instance 0: the sweep; 1: the TMA ring
template <typename T, int N>
int launch_i(int instance, const void* u, const void* dt, const void* a,
             const void* bt, const void* ct, const void* hck, const void* dy,
             const void* dhT, void* du, void* ddt, void* da, void* db, void* dc,
             void* da_part, void* db_part, void* dc_part, int B, int Tn, int Di,
             const Strides& us, const Strides& ds, const Strides& bs,
             const Strides& cs, cudaStream_t st) {
  if (instance == 1)
    return ring::launch<T, N>(u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc,
                              da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs, st);
  return launch<T, N>(u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc, da_part,
                      db_part, dc_part, B, Tn, Di, us, ds, bs, cs, st);
}

template <typename T>
int launch_n(int instance, int N, const void* u, const void* dt, const void* a,
             const void* bt, const void* ct, const void* hck, const void* dy,
             const void* dhT, void* du, void* ddt, void* da, void* db, void* dc,
             void* da_part, void* db_part, void* dc_part, int B, int Tn, int Di,
             const Strides& us, const Strides& ds, const Strides& bs,
             const Strides& cs, cudaStream_t st) {
  switch (N) {
    case 8:
      return launch_i<T, 8>(instance, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db,
                            dc, da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs, st);
    case 16:
      return launch_i<T, 16>(instance, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db,
                             dc, da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs, st);
    case 32:
      return launch_i<T, 32>(instance, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db,
                             dc, da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  instance 0 is the sweep, 1 the
// TMA ring (operands a tensor map takes).  dtype 0 is fp32, 1 is bf16 (u,
// dt, b, c and du, ddt, db, dc alike).  Strides are in elements, in the
// order (batch, step); the last dim has unit stride.  dhT may be null.
// Scratch: da_part [B, Di, N], db_part and dc_part [B, nblk, T, N], fp32,
// nblk = ceil(Di / 32) (sweep) or ceil(Di / (512 / N)) (ring).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// unknown instance or dtype, an N other than 8, 16 or 32, a grid too large
// or operands a tensor map refuses.
extern "C" int selective_scan_bwd_launch(
    const void* u, const void* dt, const void* a, const void* bt,
    const void* ct, const void* hck, const void* dy, const void* dhT,
    void* du, void* ddt, void* da, void* db, void* dc, void* da_part,
    void* db_part, void* dc_part, int instance, int dtype, int B, int Tn, int Di,
    int N, long long usb, long long ust, long long dsb, long long dst, long long bsb,
    long long bst, long long csb, long long cst, void* stream) {
  if ((instance != 0 && instance != 1) || (dtype != 0 && dtype != 1) || B > 65535 ||
      Tn < 0 || Di < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Di == 0) return 0;
  const Strides us{usb, ust}, ds{dsb, dst}, bs{bsb, bst}, cs{csb, cst};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(instance, N, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db,
                           dc, da_part, db_part, dc_part, B, Tn, Di, us, ds,
                           bs, cs, st);
  return launch_n<bf16>(instance, N, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc,
                        da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs,
                        st);
}
