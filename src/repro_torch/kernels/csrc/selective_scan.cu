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
// and, when hT is not null, the final state hT [B, Di, N] fp32 contiguous;
// when hck is not null (training: selective_scan_bwd.cu reads them), h at
// the start of every CK = 32 steps, hck [B, ceil(T / 32), Di, N] fp32
// contiguous (checkpoint i is h_{32 i - 1}, zero for i = 0).  The serve
// path passes null and writes nothing more.
// N is 8, 16 or 32.  Every operand is cast to fp32 before it is multiplied,
// as ssm.py:85-89 does.
//
// Bound on an H100 at jamba-v0.1-52b's prefill (bf16, B 4, T 2048, Di 8192,
// N 16): u and dt 268.4 MB, b and c 0.5 MB, a 0.5 MB, y 268.4 MB and the
// state 2.1 MB are 539.9 MB, 0.161 ms at 3.35 TB/s; about 6 fp32 operations
// per (b, t, d, n) (dt a, the exponential, the update's fma, h c and the
// sum), 6.4 GFLOP, 0.096 ms at 67 TFLOP/s.  So bytes bound it, but neither
// count sees the special-function unit: one exponential per (b, t, d, n),
// 1.07e9 of them, at 16 a clock per SM on 132 SMs at 1.98 GHz take 0.26 ms
// (0.064 ms at the served [1, 2048]), more than the bytes.  The design
// accepts that floor: every exponential is one ex2.approx on the MUFU (an
// FMA-pipe polynomial for a share of them would lower it, at the cost of
// about ten fp32 instructions each; a later step).
//
// Two instances; kernels/selective_scan.py's choose_instance picks one from
// the operands' pointers and strides before any launch.
//   * tma (every operand's base 16-byte aligned and its batch and step
//     strides multiples of 16 bytes: the served layout).  A block owns one
//     batch row and CH = 32 channels; each channel's N states are split over
//     L = N / 4 neighbouring lanes (4 states a thread: y's sum is 3 fp32
//     adds in registers and log2(L) shuffles), so at B = 1, Di = 8192
//     there are 256 blocks of 4 warps for the 132 SMs.  (8 states a thread
//     halve the warps, and at B = 1 each warp is latency-bound: slower on
//     the H100.)  The block walks T in
//     tiles of TS = 64 steps through a three-stage ring: one thread issues
//     four TMA copies a tile (u and dt as a [TS, CH] box, coalesced 16-byte
//     units along Di; b and c as [TS, N]), zero-filled past T and Di, two
//     tiles ahead, completing on the stage's mbarrier.  The tile's b and c
//     are turned into fp32 once in shared memory for the whole block; u and
//     dt are read in their own type per channel.  Per step a thread does
//     dt u once, then per state ex2(dt (a log2 e)) (a log2 e computed once
//     per block), the update's fma, the increment's multiply and y's fma;
//     steps go in groups of U = 4 whose loads and exponentials are
//     independent of h, so only the update's fma chains from step to step.
//     y_t goes from the channel's first lane into a [TS, CH] tile in
//     shared memory (two, alternating), which leaves as one TMA store a
//     tile: per-step 4-byte stores from the lanes took a quarter of the
//     kernel's time (measured on the H100).
//     The checkpoints for the backward: at every CK = 32 steps (twice a
//     tile, before the group that starts there) each thread stores its 4
//     states as one 16-byte store; the backward re-runs 32 steps forward
//     from one before scanning them in reverse.  A template flag: the
//     serve path's instance carries no trace of them.
//   * simple (any strides): one thread per (b, d, n), the N states of a
//     channel on N neighbouring lanes; a block of 256 threads holds 256 / N
//     channels of one batch row and walks T in tiles of 64 steps staged in
//     shared memory as fp32 by plain loads; y_t is a __shfl_xor sum over the
//     N lanes, parked in shared memory and written as rows after the tile;
//     exp is the accurate expf.
// The loops are bounded by T, so a ragged last tile runs only its real
// steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TS = 64;             // steps per tile
constexpr int CK = 32;             // steps between the backward's checkpoints

struct Strides {
  long long b, t;                  // elements between batch rows, steps
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

namespace simple {

constexpr int THREADS = 256;

template <typename T, int N, bool CKPT>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bt,
                const T* __restrict__ ct, float* __restrict__ y,
                float* __restrict__ hT, float* __restrict__ hck, int Tn, int Di,
                Strides us, Strides ds, Strides bs, Strides cs) {
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
      if (CKPT && live && (t0 + s) % CK == 0)
        hck[((b * ((Tn + CK - 1) / CK) + (t0 + s) / CK) * Di + d) * N + n] = h;
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
           const void* ct, void* y, void* hT, void* hck, int B, int Tn, int Di,
           const Strides& us, const Strides& ds, const Strides& bs,
           const Strides& cs, cudaStream_t st) {
  constexpr int C = THREADS / N;
  const dim3 grid((Di + C - 1) / C, B);
  auto kernel = hck != nullptr ? scan_kernel<T, N, true> : scan_kernel<T, N, false>;
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bt),
      static_cast<const T*>(ct), static_cast<float*>(y),
      static_cast<float*>(hT), static_cast<float*>(hck), Tn, Di, us, ds, bs,
      cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simple

// ---------------------------------------- Hopper: TMA ring, 4 states a thread
namespace ring {

using namespace hopper;

constexpr int CH = 32;             // channels per block
constexpr int STAGES = 3;          // tiles in flight
constexpr int SPT = 4;             // states per thread
constexpr int U = 4;               // steps per group (TS is a multiple)
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Threads {                   // N / SPT lanes a channel
  static constexpr int value = CH * (N / SPT);
};

template <typename T, int N>
struct Stage {                     // byte offsets inside one ring stage
  static constexpr int UT = TS * CH * sizeof(T);  // a u or dt tile
  static constexpr int BT = TS * N * sizeof(T);   // a b or c tile
  static constexpr int BYTES = 2 * UT + 2 * BT;   // a multiple of 128
  static constexpr size_t SMEM = 128 + STAGES * size_t(BYTES) +
                                 TS * 2 * N * sizeof(float) +
                                 2 * TS * CH * sizeof(float) + 8 * STAGES;
};

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int N, bool CKPT>
__global__ void __launch_bounds__(Threads<N>::value)
    ring_scan_kernel(const __grid_constant__ CUtensorMap umap,
                     const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap ymap,
                     const float* __restrict__ a, float* __restrict__ hT,
                     float* __restrict__ hck, int Tn, int Di) {
  using St = Stage<T, N>;
  constexpr int L = N / SPT;
  constexpr int THREADS = Threads<N>::value;
  extern __shared__ uint8_t smem_ss[];
  uint8_t* stages = smem_ss + ((128 - (hopper::smem_u32(smem_ss) & 127)) & 127);
  float* sbc = reinterpret_cast<float*>(stages + STAGES * St::BYTES);  // [TS][b | c]
  float* ybuf = sbc + TS * 2 * N;  // two [TS][CH] tiles of y
  uint64_t* full = reinterpret_cast<uint64_t*>(ybuf + 2 * TS * CH);

  const int tid = threadIdx.x;
  const int ch = tid / L;
  const int n0 = (tid % L) * SPT;  // this thread's states n0 .. n0 + 3
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const int b = blockIdx.y;
  const bool live = d < Di;
  const int n_tiles = (Tn + TS - 1) / TS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // tile i's u, dt, b and c into stage i % STAGES, zero past T and Di
  auto issue = [&](int i) {
    uint8_t* st = stages + (i % STAGES) * St::BYTES;
    uint64_t* bar = &full[i % STAGES];
    mbar_expect_tx(bar, St::BYTES);
    tma_load_3d(st, &umap, bar, d0, i * TS, b);
    tma_load_3d(st + St::UT, &dmap, bar, d0, i * TS, b);
    tma_load_3d(st + 2 * St::UT, &bmap, bar, 0, i * TS, b);
    tma_load_3d(st + 2 * St::UT + St::BT, &cmap, bar, 0, i * TS, b);
  };
  if (tid == 0)
    for (int i = 0; i < min(STAGES - 1, n_tiles); ++i) issue(i);

  float a2[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    a2[j] = live ? a[static_cast<long long>(d) * N + n0 + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    // the stage of tile i - 1 is free: every thread passed the barrier
    // that ends it; and tile i - 2's y store has read ybuf[i % 2]
    if (tid == 0) {
      if (i + STAGES - 1 < n_tiles) {
        fence_proxy_async();
        issue(i + STAGES - 1);
      }
      bulk_wait_read<1>();
    }
    float* yt = ybuf + (i % 2) * TS * CH;
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = stages + s * St::BYTES;
    const T* su = reinterpret_cast<const T*>(st);
    const T* sd = reinterpret_cast<const T*>(st + St::UT);
    const T* sb = reinterpret_cast<const T*>(st + 2 * St::UT);
    const T* sc = reinterpret_cast<const T*>(st + 2 * St::UT + St::BT);
    for (int e = tid; e < TS * N; e += THREADS) {  // b and c as fp32, once
      const int r = e / N, k = e % N;
      sbc[r * 2 * N + k] = to_f32(sb[e]);
      sbc[r * 2 * N + N + k] = to_f32(sc[e]);
    }
    __syncthreads();
    // U steps at a time: their loads, decays and increments are
    // independent of h, so only the update's fma chains from step to
    // step.  Rows past T are zero (TMA's fill): dt = 0 there gives decay 1
    // and increment 0, so a group that runs past T leaves h as it is, and
    // the store drops its y.
    const int steps = min(TS, Tn - i * TS);
    for (int r0 = 0; r0 < steps; r0 += U) {
      if (CKPT && live && r0 % CK == 0) {
        float* hrow = hck + ((static_cast<long long>(b) * ((Tn + CK - 1) / CK) +
                              (i * TS + r0) / CK) * Di + d) * N + n0;
#pragma unroll
        for (int j = 0; j < SPT; j += 4)
          *reinterpret_cast<float4*>(hrow + j) =
              make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
      }
      float dtv[U], dtu[U], bv[U][SPT], cv[U][SPT];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int r = r0 + k;
        dtv[k] = to_f32(sd[r * CH + ch]);
        dtu[k] = dtv[k] * to_f32(su[r * CH + ch]);
#pragma unroll
        for (int j = 0; j < SPT; j += 4) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(&sbc[r * 2 * N + n0 + j]);
          const float4 c4 =
              *reinterpret_cast<const float4*>(&sbc[r * 2 * N + N + n0 + j]);
          bv[k][j] = b4.x; bv[k][j + 1] = b4.y; bv[k][j + 2] = b4.z; bv[k][j + 3] = b4.w;
          cv[k][j] = c4.x; cv[k][j + 1] = c4.y; cv[k][j + 2] = c4.z; cv[k][j + 3] = c4.w;
        }
      }
      float yv[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        yv[k] = 0.f;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          h[j] = fmaf(ex2(dtv[k] * a2[j]), h[j], dtu[k] * bv[k][j]);
          yv[k] = fmaf(h[j], cv[k][j], yv[k]);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < U; ++k)
          yv[k] += __shfl_xor_sync(0xffffffffu, yv[k], off, L);
      if (n0 == 0)
#pragma unroll
        for (int k = 0; k < U; ++k) yt[(r0 + k) * CH + ch] = yv[k];
    }
    // y of the tile leaves as one TMA store, which writes no row past T
    // and no channel past Di
    fence_proxy_async();
    __syncthreads();  // the tile's stage, its fp32 b, c and its y are done
    if (tid == 0) {
      tma_store_3d(&ymap, yt, d0, i * TS, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the stores have read shared memory
  if (hT != nullptr && live) {
    float* hrow = hT + (static_cast<long long>(b) * Di + d) * N + n0;
#pragma unroll
    for (int j = 0; j < SPT; j += 4)
      *reinterpret_cast<float4*>(hrow + j) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
  }
}

// a [B, T, W] operand as a 3-D tensor map (W, T, B) loaded in boxes of
// (box_w, TS, 1), no swizzle, zero fill outside; false when CUDA refuses
// it (a base or stride that is not a multiple of 16 bytes)
template <typename T>
bool operand_map(CUtensorMap* map, const void* base, int B, int Tn, int W,
                 const Strides& st, int box_w) {
  const uint64_t dims[3] = {uint64_t(W), uint64_t(Tn > 0 ? Tn : 1), uint64_t(B)};
  const uint64_t strides[2] = {uint64_t(st.t) * sizeof(T), uint64_t(st.b) * sizeof(T)};
  const uint32_t box[3] = {uint32_t(box_w), uint32_t(TS), 1u};
  return make_map(map,
                  sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, base, dims, strides, box, 0);
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* a, const void* bt,
           const void* ct, void* y, void* hT, void* hck, int B, int Tn, int Di,
           const Strides& us, const Strides& ds, const Strides& bs,
           const Strides& cs, cudaStream_t st) {
  using S = Stage<T, N>;
  CUtensorMap um, dm, bm, cm, ym;
  const Strides ys{static_cast<long long>(Tn) * Di, Di};  // y is contiguous
  if (!operand_map<T>(&um, u, B, Tn, Di, us, CH) ||
      !operand_map<T>(&dm, dt, B, Tn, Di, ds, CH) ||
      !operand_map<T>(&bm, bt, B, Tn, N, bs, N) ||
      !operand_map<T>(&cm, ct, B, Tn, N, cs, N) ||
      !operand_map<float>(&ym, y, B, Tn, Di, ys, CH))
    return static_cast<int>(cudaErrorInvalidValue);
  // the checkpoints are a template flag: the serve path's instance has no
  // trace of them (as a run-time test in the step loop it cost the serve
  // forward several percent on an H100)
  auto kernel = hck != nullptr ? ring_scan_kernel<T, N, true>
                               : ring_scan_kernel<T, N, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Di + CH - 1) / CH, B);
  kernel<<<grid, Threads<N>::value, S::SMEM, st>>>(
      um, dm, bm, cm, ym, static_cast<const float*>(a),
      static_cast<float*>(hT), static_cast<float*>(hck), Tn, Di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring

// instance 0: simple; 1: the TMA ring
template <typename T, int N>
int launch(int instance, const void* u, const void* dt, const void* a,
           const void* bt, const void* ct, void* y, void* hT, void* hck, int B,
           int Tn, int Di, const Strides& us, const Strides& ds,
           const Strides& bs, const Strides& cs, cudaStream_t st) {
  if (instance == 1)
    return ring::launch<T, N>(u, dt, a, bt, ct, y, hT, hck, B, Tn, Di, us, ds,
                              bs, cs, st);
  return simple::launch<T, N>(u, dt, a, bt, ct, y, hT, hck, B, Tn, Di, us, ds,
                              bs, cs, st);
}

template <typename T>
int launch_n(int instance, const void* u, const void* dt, const void* a,
             const void* bt, const void* ct, void* y, void* hT, void* hck,
             int B, int Tn, int Di, int N, const Strides& us,
             const Strides& ds, const Strides& bs, const Strides& cs,
             cudaStream_t st) {
  switch (N) {
    case 8:
      return launch<T, 8>(instance, u, dt, a, bt, ct, y, hT, hck, B, Tn, Di,
                          us, ds, bs, cs, st);
    case 16:
      return launch<T, 16>(instance, u, dt, a, bt, ct, y, hT, hck, B, Tn, Di,
                           us, ds, bs, cs, st);
    case 32:
      return launch<T, 32>(instance, u, dt, a, bt, ct, y, hT, hck, B, Tn, Di,
                           us, ds, bs, cs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// instance: 0 simple, 1 the TMA ring (every operand's base 16-byte aligned,
// its strides multiples of 16 bytes); dtype: 0 fp32, 1 bf16.  hT and hck
// may be null.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown instance or dtype, an N without an instance (8, 16, 32), or
// operands a tensor map refuses.
extern "C" int selective_scan_launch(
    const void* u, const void* dt, const void* a, const void* bt,
    const void* ct, void* y, void* hT, void* hck, int instance, int dtype,
    int B, int Tn, int Di, int N, long long usb, long long ust, long long dsb,
    long long dst, long long bsb, long long bst, long long csb, long long cst,
    void* stream) {
  if (B == 0 || Di == 0) return 0;
  if ((instance != 0 && instance != 1) || (dtype != 0 && dtype != 1) ||
      B > 65535 || Tn < 0 || Di < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides us{usb, ust}, ds{dsb, dst}, bs{bsb, bst}, cs{csb, cst};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(instance, u, dt, a, bt, ct, y, hT, hck, B, Tn, Di, N,
                           us, ds, bs, cs, st);
  return launch_n<bf16>(instance, u, dt, a, bt, ct, y, hT, hck, B, Tn, Di, N,
                        us, ds, bs, cs, st);
}
