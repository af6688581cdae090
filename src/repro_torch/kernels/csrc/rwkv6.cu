// RWKV-6 ("Finch") WKV recurrence with data-dependent decay, for Hopper,
// returning the final state.
//
// Replaces the Pallas kernel _wkv_kernel (src/repro/kernels/rwkv6.py:27).
// The models reach its math through ref.rwkv6_chunked (the chunked-parallel
// schedule) or ref.rwkv6_scan_with_state; in the port every WKV on the card
// is this kernel, and it also returns the state that seeds decode.
//
//   out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t   = diag(exp(-exp(w_t))) S_{t-1} + k_t^T v_t
//
// Contract: r, k, w [B, T, H, K] and v [B, T, H, V], all fp32 or all bf16,
// read through the (batch, time, head) strides they come with and unit
// stride along the last dim; u [H, K] fp32 contiguous (it broadcasts over
// B); s0 [B, H, K, V] fp32 contiguous, or null for a zero state.  Writes out
// [B, T, H, V] and sT [B, H, K, V], both fp32 contiguous.  K = V = 64 (the
// model's HEAD_K).  The arithmetic is fp32 (exp is the accurate expf),
// apart from the bonus scalar a_t = sum_k r u k, which is summed in fp64 and
// rounded once: at t = 0 (zero state) a_0 v_0 alone is the output row, and
// a_0 can cancel (terms of 0.25 summing to 1e-3 occur on a model's real
// operands), where an fp32 sum carries a relative error of 1e-3.
//
// Bound on an H100 at the serve path's prefill shape (bf16, B 4, T 2048,
// H 32): 134.2 MB of inputs, 67.1 MB of output and 2.1 MB of final state are
// 203.4 MB, 0.0607 ms at 3.35 TB/s; the sequential form's 7 K V flops per
// (b, t, h) are 7.5 GFLOP, 0.112 ms on 67 TFLOP/s of fp32 CUDA cores, so
// the fp32 issue, not the bytes, is what this form can approach.  (The
// chunked form on tensor cores would need a 3xTF32 split to hold the
// agreement limits; it is a later step.)
//
// Design.  A block owns one (batch, head, slice of VC state columns) and
// walks all of T in tiles of TS steps, warp-specialized:
//  * eight producer warps.  One thread loads each tile of r, k, w and of
//    the slice's v with one TMA copy per operand (a 4-D tensor map over
//    [B, T, H, 64] as the strides lay it out, a box of TS steps) into a
//    RAW-deep ring of raw tiles, completing on the slot's mbarrier, RAW - 1
//    tiles ahead.  (Per-step 1-D bulk copies of 128-byte rows were tried
//    first: at 128 copies a tile the copy engine, not the math, set the
//    pace.)  The warps then turn a landed tile into fp32 r, k, v, the decay
//    exp(-exp(w)) and the fp64 bonus scalar per step (a warp per step, two
//    elements a lane, a shuffle reduction), in a 2-deep ring of fp32
//    tiles.  Operands a tensor map refuses (rows not 16-byte aligned) are
//    copied by the producers with ordinary loads instead.
//  * consumer warps, each thread holding a 4 x 4 block of the state (4
//    rows of 4 columns; 16 threads cover a group of 4 columns) in
//    registers for all of T.  A step reads one float4 each of r, k, decay
//    and v from shared memory and does 48 fp32 operations, so every
//    value read serves four columns: a layout of 16 rows of one column
//    read three times as much and was bound by shared-memory wavefronts.
//    out_t is a reduce-scatter over the 16 row groups (5 shuffles).  No
//    load from device memory and no transcendental.  Outputs go through
//    shared memory and leave as rows of VC contiguous floats.
// Measured on an H100, the consumers set the pace: their per-step
// reduction and the fp32 issue of two warps per SM sub-partition, with
// the producers a little behind (PERF.md).
// VC is 64 when B*H fills the card (one producer pair per head, nothing
// computed twice); for small B*H it drops to 16 or 8, so [1, 1000, 32, 64]
// runs 256 blocks.  The loop is bounded by T: a ragged last tile runs only its
// real steps, so no padded step ever touches the state.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int K = 64;              // state rows (head size of k, r, w)
constexpr int V = 64;              // state columns (head size of v)
constexpr int TS = 32;             // steps per tile
constexpr int G = 4;               // consumer threads per state column
constexpr int PRODUCERS = 256;     // eight warps
constexpr int RAW = 3;             // raw tiles in flight

struct Strides {
  long long b, t, h;  // elements between batches, steps, heads
};

template <typename T, int VC>
struct Raw {                       // one tile as it lies in device memory
  T r[TS][K];
  T k[TS][K];
  T w[TS][K];
  T v[TS][VC];
};

template <int VC>
struct Tile {                      // one tile as the consumers read it
  float r[TS][K];
  float k[TS][K];
  float d[TS][K];                  // exp(-exp(w))
  float v[TS][VC];
  float a[TS];                     // sum_k r u k, summed in fp64
};

template <typename T, int VC>
constexpr size_t smem_bytes() {
  return RAW * sizeof(Raw<T, VC>) + 2 * sizeof(Tile<VC>) +
         2 * TS * VC * sizeof(float) + (RAW + 4) * sizeof(uint64_t);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, int VC>
__global__ void __launch_bounds__(PRODUCERS + VC * G)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ out, float* __restrict__ sT, int Tn, int H,
               Strides rs, Strides ks, Strides vs, Strides ws,
               const __grid_constant__ CUtensorMap mr,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mw,
               const __grid_constant__ CUtensorMap mv, int tma) {
  constexpr int NC = VC * G;       // consumer threads
  extern __shared__ __align__(128) unsigned char smem[];
  auto* raw = reinterpret_cast<Raw<T, VC>*>(smem);
  auto* tile = reinterpret_cast<Tile<VC>*>(smem + RAW * sizeof(Raw<T, VC>));
  auto* obuf = reinterpret_cast<float(*)[TS][VC]>(
      smem + RAW * sizeof(Raw<T, VC>) + 2 * sizeof(Tile<VC>));
  auto* raw_full = reinterpret_cast<uint64_t*>(
      smem + RAW * sizeof(Raw<T, VC>) + 2 * sizeof(Tile<VC>) +
      2 * TS * VC * sizeof(float));
  uint64_t* f_full = raw_full + RAW;
  uint64_t* f_empty = f_full + 2;

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (Tn + TS - 1) / TS;

  if (tid == 0) {
    for (int i = 0; i < RAW; ++i) mbar_init(&raw_full[i], PRODUCERS);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&f_full[i], PRODUCERS);
      mbar_init(&f_empty[i], NC / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < PRODUCERS) {
    // ------------------------------------------------------------ producers
    const T* rb = r + b * rs.b + h * rs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* wb = w + b * ws.b + h * ws.h;
    const T* vb = v + b * vs.b + h * vs.h + v0;
    const int lane = tid % 32, pw = tid / 32;
    constexpr int NPW = PRODUCERS / 32;

    // raw tile j into slot j % RAW
    auto issue = [&](int j) {
      Raw<T, VC>& R = raw[j % RAW];
      uint64_t* bar = &raw_full[j % RAW];
      const long long t0 = static_cast<long long>(j) * TS;
      const int n = min(TS, static_cast<int>(Tn - t0));
      if (tma) {
        if (tid == 0) {                      // whole boxes, zero past T
          fence_proxy_async();
          mbar_expect_tx(bar, static_cast<uint32_t>(sizeof(Raw<T, VC>)));
          const int t = static_cast<int>(t0);
          tma_load_4d(R.r, &mr, bar, 0, h, t, b);
          tma_load_4d(R.k, &mk, bar, 0, h, t, b);
          tma_load_4d(R.w, &mw, bar, 0, h, t, b);
          tma_load_4d(R.v, &mv, bar, v0, h, t, b);
        } else {
          mbar_arrive(bar);
        }
      } else {
        for (int i = tid; i < n * K; i += PRODUCERS) {
          const int s = i / K, c = i % K;
          const long long t = t0 + s;
          R.r[s][c] = rb[t * rs.t + c];
          R.k[s][c] = kb[t * ks.t + c];
          R.w[s][c] = wb[t * ws.t + c];
        }
        for (int i = tid; i < n * VC; i += PRODUCERS) {
          const int s = i / VC, c = i % VC;
          R.v[s][c] = vb[(t0 + s) * vs.t + c];
        }
        mbar_arrive(bar);
      }
    };

    const double u0 = u[h * K + lane], u1 = u[h * K + lane + 32];
    for (int j = 0; j < min(RAW, ntiles); ++j) issue(j);
    for (int i = 0; i < ntiles; ++i) {
      if (i > 0 && i + RAW - 1 < ntiles) {
        named_sync(2, PRODUCERS);            // every producer is done with
        issue(i + RAW - 1);                  // the slot tile i - 1 held
      }
      const int n = min(TS, Tn - i * TS);
      mbar_wait(&raw_full[i % RAW], (i / RAW) & 1);
      mbar_wait(&f_empty[i & 1], ((i >> 1) & 1) ^ 1);
      const Raw<T, VC>& R = raw[i % RAW];
      Tile<VC>& F = tile[i & 1];
#pragma unroll 2
      for (int s = pw; s < n; s += NPW) {
        const float r0 = to_f32(R.r[s][lane]), r1 = to_f32(R.r[s][lane + 32]);
        const float k0 = to_f32(R.k[s][lane]), k1 = to_f32(R.k[s][lane + 32]);
        F.r[s][lane] = r0;
        F.r[s][lane + 32] = r1;
        F.k[s][lane] = k0;
        F.k[s][lane + 32] = k1;
        F.d[s][lane] = expf(-expf(to_f32(R.w[s][lane])));
        F.d[s][lane + 32] = expf(-expf(to_f32(R.w[s][lane + 32])));
        double p = static_cast<double>(r0) * u0 * static_cast<double>(k0) +
                   static_cast<double>(r1) * u1 * static_cast<double>(k1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) F.a[s] = static_cast<float>(p);
      }
      for (int e = tid; e < n * VC; e += PRODUCERS)
        F.v[e / VC][e % VC] = to_f32(R.v[e / VC][e % VC]);
      mbar_arrive(&f_full[i & 1]);
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int ct = tid - PRODUCERS;
  const int c0 = 4 * (ct / 16);            // this thread's 4 columns
  const int rj = ct % 16;                  // and its rows 4 rj .. 4 rj + 3
  const int lane = tid % 32;
  const long long bh = static_cast<long long>(b) * H + h;
  // after the reduce-scatter below, lane rj holds the sum of column
  // c0 + cidx; the lanes with rj % 4 == 0 write it
  const int cidx = 2 * ((rj >> 3) & 1) + ((rj >> 2) & 1);

  float S[16];                             // S[4c + i]: row 4 rj + i, column c0 + c
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      S[4 * c + i] =
          s0 ? s0[(bh * K + 4 * rj + i) * V + v0 + c0 + c] : 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TS;
    const int n = min(TS, Tn - t0);
    mbar_wait(&f_full[it & 1], (it >> 1) & 1);
    const Tile<VC>& F = tile[it & 1];
    float(*O)[VC] = obuf[it & 1];
    // operands of step s + 1 are read before step s's output is stored:
    // the store could alias them, so the compiler would not hoist them
    auto step = [&](int s, float4& rq, float4& kq, float4& dq, float4& vq,
                    float& a) {
      rq = *reinterpret_cast<const float4*>(&F.r[s][4 * rj]);
      kq = *reinterpret_cast<const float4*>(&F.k[s][4 * rj]);
      dq = *reinterpret_cast<const float4*>(&F.d[s][4 * rj]);
      vq = *reinterpret_cast<const float4*>(&F.v[s][c0]);
      a = F.a[s];
    };
    float4 rq, kq, dq, vq;
    float a;
    step(0, rq, kq, dq, vq, a);
#pragma unroll 2
    for (int s = 0; s < n; ++s) {
      float4 rn, kn, dn, vn;
      float an;
      step(min(s + 1, n - 1), rn, kn, dn, vn, an);
      const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
      const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
      const float dd[4] = {dq.x, dq.y, dq.z, dq.w};
      const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& st = S[4 * c + i];
          acc[c] = fmaf(rr[i], st, acc[c]);      // reads S_{t-1}
          st = fmaf(st, dd[i], kk[i] * vv[c]);   // then S_t
        }
      }
      // reduce-scatter over the 16 row groups: halve the columns twice,
      // then sum the pairs
      const bool hi8 = rj & 8, hi4 = rj & 4;
      float keep0 = hi8 ? acc[2] : acc[0], keep1 = hi8 ? acc[3] : acc[1];
      keep0 += __shfl_xor_sync(0xffffffffu, hi8 ? acc[0] : acc[2], 8);
      keep1 += __shfl_xor_sync(0xffffffffu, hi8 ? acc[1] : acc[3], 8);
      float sum = hi4 ? keep1 : keep0;
      sum += __shfl_xor_sync(0xffffffffu, hi4 ? keep0 : keep1, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float vc = hi8 ? (hi4 ? vv[3] : vv[2]) : (hi4 ? vv[1] : vv[0]);
      if ((rj & 3) == 0) O[s][c0 + cidx] = fmaf(vc, a, sum);
      rq = rn;
      kq = kn;
      dq = dn;
      vq = vn;
      a = an;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&f_empty[it & 1]);
    named_sync(1, NC);                     // the tile's outputs are in O
    float* ob = out + ((static_cast<long long>(b) * Tn + t0) * H + h) * V + v0;
    for (int e = ct; e < n * VC; e += NC)
      ob[static_cast<long long>(e / VC) * H * V + e % VC] = O[e / VC][e % VC];
  }

#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sT[(bh * K + 4 * rj + i) * V + v0 + c0 + c] = S[4 * c + i];
}

// One [B, T, H, width] operand as a 4-D tensor map (width, H, T, B), loaded
// in boxes of `box` columns by TS steps.  False when the base or a stride
// is not a nonzero multiple of 16 bytes, or cuTensorMapEncodeTiled refuses.
template <typename T>
bool operand_map(CUtensorMap* map, const void* base, int B, int Tn, int H,
                 const Strides& s, int width, int box) {
  const long long e = sizeof(T);
  const uint64_t extent[4] = {uint64_t(width), uint64_t(H),
                              uint64_t(Tn > 0 ? Tn : 1), uint64_t(B)};
  const long long bytes[3] = {s.h * e, s.t * e, s.b * e};
  uint64_t stride[3];
  for (int i = 0; i < 3; ++i) {
    if (bytes[i] <= 0 || bytes[i] % 16) return false;
    stride[i] = uint64_t(bytes[i]);
  }
  if (reinterpret_cast<uintptr_t>(base) % 16) return false;
  const uint32_t boxes[4] = {uint32_t(box), 1u, uint32_t(TS), 1u};
  return make_map(map,
                  sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  4, base, extent, stride, boxes, 0);
}

template <typename T, int VC>
int launch_vc(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* out, void* sT, int B,
              int Tn, int H, const Strides& rs, const Strides& ks,
              const Strides& vs, const Strides& ws, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, VC>();
  // set on every launch: the attribute belongs to the current device's
  // context, so a flag kept per process would refuse a second card
  const cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<T, VC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap mr{}, mk{}, mw{}, mv{};
  const int tma = operand_map<T>(&mr, r, B, Tn, H, rs, K, K) &&
                  operand_map<T>(&mk, k, B, Tn, H, ks, K, K) &&
                  operand_map<T>(&mw, w, B, Tn, H, ws, K, K) &&
                  operand_map<T>(&mv, v, B, Tn, H, vs, V, VC);
  const dim3 grid(V / VC, H, B);
  wkv_kernel<T, VC><<<grid, PRODUCERS + VC * G, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), Tn, H, rs, ks, vs,
      ws, mr, mk, mw, mv, tma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sT, int B, int Tn,
           int H, const Strides& rs, const Strides& ks, const Strides& vs,
           const Strides& ws, cudaStream_t st) {
  // whole heads (64 columns, nothing staged twice) when B*H heads nearly
  // fill the card; else slices narrow enough for two blocks per SM: 16
  // columns, or 8 at the least
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long bh = static_cast<long long>(B) * H;
  if (10 * bh >= 9LL * sms)
    return launch_vc<T, 64>(r, k, v, w, u, s0, out, sT, B, Tn, H, rs, ks, vs, ws, st);
  if (4 * bh >= 2LL * sms)
    return launch_vc<T, 16>(r, k, v, w, u, s0, out, sT, B, Tn, H, rs, ks, vs, ws, st);
  return launch_vc<T, 8>(r, k, v, w, u, s0, out, sT, B, Tn, H, rs, ks, vs, ws, st);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 is fp32, 1 is bf16 (r,
// k, v and w alike).  Strides are in elements, in the order (batch, step,
// head); the last dim has unit stride.  s0 may be null (zero state).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// head sizes other than K = V = 64, a dtype other than 0 or 1, or a grid too
// large.
extern "C" int rwkv6_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, void* out, void* sT, int dtype, int B, int Tn, int H,
    int Kd, int Vd, long long rsb, long long rst, long long rsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
    long long wsb, long long wst, long long wsh, void* stream) {
  if (B == 0 || H == 0) return 0;
  if ((dtype != 0 && dtype != 1) || Kd != K || Vd != V || B > 65535 ||
      H > 65535 || Tn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides rs{rsb, rst, rsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      ws{wsb, wst, wsh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, out, sT, B, Tn, H, rs, ks, vs, ws,
                         st);
  return launch<bf16>(r, k, v, w, u, s0, out, sT, B, Tn, H, rs, ks, vs, ws,
                      st);
}
