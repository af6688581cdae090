// Mamba's selective scan (diagonal A) for Hopper, returning the final state.
//
// A port-only kernel.  In the JAX package the scan is plain JAX, not a Pallas
// kernel: _selective_scan_chunked (src/repro/models/ssm.py:59), a lax.scan
// over chunks with a lax.associative_scan inside each, which materializes
// [B, chunk, Di, N] fp32 decays and increments per chunk.  Here the state
// never leaves registers.
//
//   h_t = exp(dt_t * a) . h_{t-1} + (dt_t * u_t) . b_t      h_0 = 0
//   y_t = sum_n h_t[n] c_t[n]
//
// per (batch, channel d, state n), with a [Di, N].
//
// Contract: u, dt [B, T, Di] and b, c [B, T, N], all fp32 or all bf16, read
// through the (batch, time) strides they come with and unit stride along the
// last dim; a [Di, N] fp32 contiguous.  Writes y [B, T, Di] fp32 contiguous
// and, when hT is not null, the final state hT [B, Di, N] fp32 contiguous.
// N is 8, 16 or 32.  Every operand is cast to fp32 before it is multiplied,
// as ssm.py:85-89 does; exp is the accurate expf.
//
// Bound on an H100 at jamba-v0.1-52b's prefill (bf16, B 4, T 2048, Di 8192,
// N 16): u and dt 268.4 MB, b and c 0.5 MB, a 0.5 MB, y 268.4 MB and the
// state 2.1 MB are 539.9 MB, 0.161 ms at 3.35 TB/s; about 6 fp32 operations
// per (b, t, d, n) (dt a, the exponential, the update's fma, h c and the
// sum), 6.4 GFLOP, 0.096 ms at 67 TFLOP/s.  So bytes bound it.
//
// Design (the simple one).  One thread per (b, d, n): the N states of a
// channel sit on N neighbouring lanes of a warp, a block of 256 threads
// holds 256 / N channels of one batch row, and each thread keeps its h in a
// register for the whole sequence.  The block walks T in tiles of TS steps:
// it stages the tile's u and dt for its channels and the tile's b and c
// (which every channel shares) in shared memory as fp32, then each thread
// runs the TS steps of its recurrence; y_t is a __shfl_xor sum over the N
// lanes, parked in shared memory and written out as rows of the block's
// channels after the tile.  The loop is bounded by T, so a ragged last tile
// runs only its real steps.  Each lane computes its own exponential and
// takes part in log2(N) shuffles a step; that instruction count, not the
// bytes, is what this design can approach.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TS = 64;             // steps per tile

struct Strides {
  long long b, t;                  // elements between batch rows, steps
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bt,
                const T* __restrict__ ct, float* __restrict__ y,
                float* __restrict__ hT, int Tn, int Di, Strides us, Strides ds,
                Strides bs, Strides cs) {
  constexpr int C = THREADS / N;   // channels per block
  __shared__ float su[TS][C];
  __shared__ float sdt[TS][C];
  __shared__ float sb[TS][N];
  __shared__ float sc[TS][N];
  __shared__ float sy[TS][C];

  const int tid = threadIdx.x;
  const int n = tid % N;
  const int ch = tid / N;
  const int d0 = blockIdx.x * C;
  const int d = d0 + ch;
  const long long b = blockIdx.y;
  const bool live = d < Di;
  // a dead lane (d >= Di) runs with a = 0 and zero inputs: its h stays 0,
  // and it still takes part in the shuffles of its warp
  const float an = live ? a[static_cast<long long>(d) * N + n] : 0.f;
  const T* ub = u + b * us.b;
  const T* db = dt + b * ds.b;
  const T* bb = bt + b * bs.b;
  const T* cb = ct + b * cs.b;
  float* yb = y + b * Tn * static_cast<long long>(Di);
  float h = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += TS) {
    const int steps = min(TS, Tn - t0);
    __syncthreads();               // the last tile's reads of sy are done
    for (int i = tid; i < TS * C; i += THREADS) {
      const int s = i / C, c = i % C;
      float uv = 0.f, dv = 0.f;
      if (s < steps && d0 + c < Di) {
        const long long t = t0 + s;
        uv = to_f32(ub[t * us.t + d0 + c]);
        dv = to_f32(db[t * ds.t + d0 + c]);
      }
      su[s][c] = uv;
      sdt[s][c] = dv;
    }
    for (int i = tid; i < TS * N; i += THREADS) {
      const int s = i / N, k = i % N;
      float bv = 0.f, cv = 0.f;
      if (s < steps) {
        const long long t = t0 + s;
        bv = to_f32(bb[t * bs.t + k]);
        cv = to_f32(cb[t * cs.t + k]);
      }
      sb[s][k] = bv;
      sc[s][k] = cv;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float dtv = sdt[s][ch];
      const float decay = expf(dtv * an);
      h = fmaf(decay, h, (dtv * su[s][ch]) * sb[s][n]);
      float part = h * sc[s][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off, N);
      if (n == 0) sy[s][ch] = part;
    }
    __syncthreads();
    for (int i = tid; i < steps * C; i += THREADS) {
      const int s = i / C, c = i % C;
      if (d0 + c < Di)
        yb[static_cast<long long>(t0 + s) * Di + d0 + c] = sy[s][c];
    }
  }
  if (hT != nullptr && live)
    hT[(b * Di + d) * N + n] = h;
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* a, const void* bt,
           const void* ct, void* y, void* hT, int B, int Tn, int Di,
           Strides us, Strides ds, Strides bs, Strides cs, cudaStream_t st) {
  constexpr int C = THREADS / N;
  const dim3 grid((Di + C - 1) / C, B);
  scan_kernel<T, N><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bt),
      static_cast<const T*>(ct), static_cast<float*>(y),
      static_cast<float*>(hT), Tn, Di, us, ds, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* u, const void* dt, const void* a, const void* bt,
             const void* ct, void* y, void* hT, int B, int Tn, int Di, int N,
             Strides us, Strides ds, Strides bs, Strides cs, cudaStream_t st) {
  switch (N) {
    case 8:
      return launch<T, 8>(u, dt, a, bt, ct, y, hT, B, Tn, Di, us, ds, bs, cs,
                          st);
    case 16:
      return launch<T, 16>(u, dt, a, bt, ct, y, hT, B, Tn, Di, us, ds, bs, cs,
                           st);
    case 32:
      return launch<T, 32>(u, dt, a, bt, ct, y, hT, B, Tn, Di, us, ds, bs, cs,
                           st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_launch(
    const void* u, const void* dt, const void* a, const void* bt,
    const void* ct, void* y, void* hT, int dtype, int B, int Tn, int Di, int N,
    long long usb, long long ust, long long dsb, long long dst, long long bsb,
    long long bst, long long csb, long long cst, void* stream) {
  if (B == 0 || Di == 0) return 0;
  if ((dtype != 0 && dtype != 1) || B > 65535 || Tn < 0 || Di < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides us{usb, ust}, ds{dsb, dst}, bs{bsb, bst}, cs{csb, cst};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(u, dt, a, bt, ct, y, hT, B, Tn, Di, N, us, ds, bs,
                           cs, st);
  return launch_n<bf16>(u, dt, a, bt, ct, y, hT, B, Tn, Di, N, us, ds, bs, cs,
                        st);
}
