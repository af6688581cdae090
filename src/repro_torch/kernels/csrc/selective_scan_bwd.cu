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
// Design: two kernels in one launch.
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

template <typename T>
int launch_n(int N, const void* u, const void* dt, const void* a,
             const void* bt, const void* ct, const void* hck, const void* dy,
             const void* dhT, void* du, void* ddt, void* da, void* db, void* dc,
             void* da_part, void* db_part, void* dc_part, int B, int Tn, int Di,
             const Strides& us, const Strides& ds, const Strides& bs,
             const Strides& cs, cudaStream_t st) {
  switch (N) {
    case 8:
      return launch<T, 8>(u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc,
                          da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs,
                          st);
    case 16:
      return launch<T, 16>(u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc,
                           da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs,
                           st);
    case 32:
      return launch<T, 32>(u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc,
                           da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs,
                           st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 is fp32, 1 is bf16 (u,
// dt, b, c and du, ddt, db, dc alike).  Strides are in elements, in the
// order (batch, step); the last dim has unit stride.  dhT may be null.
// Scratch: da_part [B, Di, N], db_part and dc_part [B, ceil(Di / 32), T, N],
// fp32.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a dtype other than 0 or 1, an N other than 8,
// 16 or 32, or a grid too large.
extern "C" int selective_scan_bwd_launch(
    const void* u, const void* dt, const void* a, const void* bt,
    const void* ct, const void* hck, const void* dy, const void* dhT,
    void* du, void* ddt, void* da, void* db, void* dc, void* da_part,
    void* db_part, void* dc_part, int dtype, int B, int Tn, int Di, int N,
    long long usb, long long ust, long long dsb, long long dst, long long bsb,
    long long bst, long long csb, long long cst, void* stream) {
  if ((dtype != 0 && dtype != 1) || B > 65535 || Tn < 0 || Di < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Di == 0) return 0;
  const Strides us{usb, ust}, ds{dsb, dst}, bs{bsb, bst}, cs{csb, cst};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(N, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db,
                           dc, da_part, db_part, dc_part, B, Tn, Di, us, ds,
                           bs, cs, st);
  return launch_n<bf16>(N, u, dt, a, bt, ct, hck, dy, dhT, du, ddt, da, db, dc,
                        da_part, db_part, dc_part, B, Tn, Di, us, ds, bs, cs,
                        st);
}
