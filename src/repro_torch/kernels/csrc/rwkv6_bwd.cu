// The backward of the RWKV-6 WKV recurrence, for Hopper.
//
// A port-only kernel: the JAX package has no backward Pallas kernel; it
// trains through the XLA autodiff of ref.rwkv6_chunked
// (src/repro/kernels/ref.py:58) or ref.rwkv6_scan_with_state (ref.py:34).
// In the port the training forward is rwkv6.cu, so its gradient is a
// kernel too.
//
// Forward (rwkv6.cu), per (batch, head), with d_t = exp(-exp(w_t)):
//   out_t = r_t S_{t-1} + a_t v_t,        a_t = sum_k r_t u k_t
//   S_t   = diag(d_t) S_{t-1} + k_t^T v_t
// Backward, given dout and the final state's gradient G_{T-1} (or 0), with
// G_t = dL/dS_t running backward in time:
//   G_{t-1} = diag(d_t) G_t + r_t^T dout_t          (G_{-1} = dL/dstate0)
//   dr_t = S_{t-1} dout_t + u o k_t (v_t . dout_t)
//   dk_t = G_t v_t        + u o r_t (v_t . dout_t)
//   dv_t = k_t G_t        + a_t dout_t
//   dw_t = -exp(w_t) d_t o rowsum(G_t o S_{t-1})
//   du   = sum over batch and t of r_t o k_t (v_t . dout_t)
// Every S and G element evolves on its own; only the products couple them:
// dr and dk sum over the state's columns, dv over its rows, dw needs S_{t-1}
// and G_t at once.  S_{t-1} cannot be had from S_t in the reverse sweep:
// dividing by d_t fails where d_t is near 0 (w of 3 gives 2e-9).  Nor can dw
// come from the forward sweep's and the reverse sweep's per-step terms
// alone (RWKV-LM's wkv6_cuda.cu identity dL/dlog d_t = sum_{s>t} r_s o
// (S_{s-1} dout_s) - sum_{s>=t} k_s o (G_s v_s), exact in real numbers):
// at T = 2048 with w ~ N(0, 1) the fp32 terms' rounding, summed over the
// suffix and scaled by exp(w) up to 20, leaves dw beyond the 1e-5 relative
// Frobenius limit (and beyond the element limit where d_t is near 0),
// fp64 suffix sums or not.
//
// Contract: r, k, w [B, T, H, 64] and v [B, T, H, 64], all fp32 or all
// bf16, read through their (batch, step, head) strides with unit stride
// along the last dim; u [H, 64] fp32; s0 [B, H, 64, 64] fp32 or null (zero
// start state); dout [B, T, H, 64] fp32 contiguous; dsT [B, H, 64, 64] fp32
// or null (zero).  Writes dr, dk, dv, dw [B, T, H, 64] in the operands' type
// and contiguous, du [H, 64] fp32 and, when ds0 is not null, ds0 [B, H, 64,
// 64] fp32.  Scratch: ck [B, ceil(T / 16), H, 64, 64] fp32 (S at the start
// of every 16-step tile), du_part [B, H, 64] fp64, vd [B, T, H] fp64 and
// av [B, T, H] fp32.  No atomics: every sum is taken in one order, so the
// same inputs give the same bits.
//
// Two instances (kernels/rwkv6.py's choose_bwd_instance picks one): the
// `sweep` below, for fp32 operands (held to fp32's 1e-5), and the `chunked`
// instance after it, for bf16 (the training path).
//
// The sweep: five kernels in one launch, all sums in fp32 but the bonus terms
// (v . dout and a_t in fp64, as the forward sums a_t) and du (fp64).  Every
// sweep stages its operands in shared memory a tile at a time, each thread
// loading the next tile into registers while this one computes (staged by
// plain loads one after another, the loads' latency had set the pace).
//   0. scalars_kernel: v_t . dout_t and a_t for every (b, t, h), a warp
//      each, into scratch the sweeps stage with their tiles (summed inside
//      each sweep's tiles, the fp64 shuffles sat on every tile's path).
//   1. rows_forward_kernel: one block per (batch, head, 16 state rows) of
//      256 threads, each holding 4 columns of one row, so that a half-warp
//      spans the row's 64 columns: S_{t-1} dout_t is a sum over the
//      half-warp (4 shuffles), then the update; tiles of 32 steps.  Writes
//      dr, S at the start of every 16-step tile into ck, and du's partial
//      sums over T (one thread a row and step set, in step order).  (4 x 4
//      elements a thread, as rwkv6.cu's consumers hold them, gave a quarter
//      of the warps and ran slower at the training shape.)
//   2. cols_reverse_kernel: one block per (batch, head, 16 state columns)
//      of 64 threads of 4 x 4 elements, a half-warp spanning all 64 rows of
//      4 columns, walks T backward carrying G: k_t G_t is a reduce-scatter
//      over the rows (5 shuffles for 4 columns); gives dv.  (It is
//      rwkv6.cu's recurrence run backward with r and k exchanged and dout in
//      place of v.  Here 4 rows of one column a thread, four times the
//      warps, ran slower: three times the loads and shuffles an element.)
//   3. rows_reverse_kernel: the layout of (1), walking 16-step tiles
//      backward: from the tile's S in ck it recomputes the tile's 16 states
//      S_{t-1} into shared memory (64 KB, each thread's own float4s, so no
//      barrier), then steps G backward: G_t v_t and rowsum(G_t o S_{t-1})
//      as two sums over the half-warp; gives dk, dw and ds0.
//   4. du_reduce_kernel: du over the batch, in order.
// Kernels 1 and 2 recompute G's and S's sweep once more than a fused kernel
// would; in exchange no sum crosses blocks.
//
// Bound on an H100 at rwkv6-1.6b's training microbatch (bf16, B 2, T 2048,
// H 32): the sweeps' 10 K V flops per (b, t, h) (S's update and S_{t-1}
// dout_t, G's update, G_t v_t and k_t G_t; dw's rowsum and the recompute
// are this design's extra) are 5.4 GFLOP, 0.080 ms at 67 TFLOP/s of fp32
// CUDA cores; r, k, v, w and the gradients in bf16 and dout in fp32 are
// 168 MB, 0.050 ms at 3.35 TB/s.  So the fp32 issue bounds it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 64;              // state rows (head size of r, k, w)
constexpr int V = 64;              // state columns (head size of v)
constexpr int TS = 32;             // steps per tile of kernels 1 and 2
constexpr int CK = 16;             // steps per tile of kernel 3 (S kept at each start)
constexpr int RB = 16;             // state rows per block of kernels 1 and 3
constexpr int VB = 16;             // state columns per block of kernel 2
constexpr int RTHREADS = RB * 16;  // kernels 1 and 3: 4 columns of a row a thread
constexpr int THREADS = 64;        // kernel 2: 4 x 4 state elements a thread

struct Strides {
  long long b, t, h;               // elements between batches, steps, heads
};

struct Operands {                  // the forward's r, k, v, w as they lie
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  Strides rs, ks, vs, ws;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ float load(const void* base, const Strides& s, int b,
                                      long long t, int h, int c) {
  return to_f32(static_cast<const T*>(base)[b * s.b + t * s.t + h * s.h + c]);
}

// The 16 lanes that share bit 4 of the lane id each hold acc[4].  Returns,
// to each, the sum over the 16 of acc[2 * ((lane >> 3) & 1) + ((lane >> 2)
// & 1)]: halve the four values twice, then sum the pairs (5 shuffles).
__device__ __forceinline__ float reduce_scatter16(const float acc[4], int lane) {
  const bool hi8 = lane & 8, hi4 = lane & 4;
  float keep0 = hi8 ? acc[2] : acc[0], keep1 = hi8 ? acc[3] : acc[1];
  keep0 += __shfl_xor_sync(0xffffffffu, hi8 ? acc[0] : acc[2], 8);
  keep1 += __shfl_xor_sync(0xffffffffu, hi8 ? acc[1] : acc[3], 8);
  float sum = hi4 ? keep1 : keep0;
  sum += __shfl_xor_sync(0xffffffffu, hi4 ? keep0 : keep1, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return sum;
}

// the sum over the 16 lanes that share bit 4 of the lane id, to each of them
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void unpack(const float4 q, float* x) {
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

// ------------------------------------- 0. the per-step scalars, once
// vd[b, t, h] = v_t . dout_t in fp64 (the bonus terms of dr and dk) and
// a[b, t, h] = sum_k r_t u k_t summed in fp64, rounded once (dv's bonus, as
// the forward sums it): a warp a (b, t, h), two elements a lane
template <typename T>
__global__ void __launch_bounds__(256)
    scalars_kernel(Operands o, const float* __restrict__ u,
                   const float* __restrict__ dout, double* __restrict__ vd,
                   float* __restrict__ av, int B, int Tn, int H) {
  const int lane = threadIdx.x & 31;
  const long long i = blockIdx.x * 8LL + (threadIdx.x >> 5);   // (b, t, h)
  if (i >= static_cast<long long>(B) * Tn * H) return;
  const int h = static_cast<int>(i % H);
  const long long bt = i / H;
  const int b = static_cast<int>(bt / Tn);
  const long long t = bt % Tn;
  double p = 0.0, q = 0.0;
#pragma unroll
  for (int c = lane; c < 64; c += 32) {
    p += static_cast<double>(load<T>(o.v, o.vs, b, t, h, c)) * dout[i * V + c];
    q += static_cast<double>(load<T>(o.r, o.rs, b, t, h, c)) * u[h * K + c] *
         load<T>(o.k, o.ks, b, t, h, c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p += __shfl_xor_sync(0xffffffffu, p, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  if (lane == 0) {
    vd[i] = p;
    av[i] = static_cast<float>(q);
  }
}

// ------------------------------------------------ 1. the forward row sweep
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    rows_forward_kernel(Operands o, const float* __restrict__ u,
                        const float* __restrict__ s0,
                        const float* __restrict__ dout, T* __restrict__ dr,
                        float* __restrict__ ck, double* __restrict__ du_part,
                        const double* __restrict__ vd, int Tn, int H) {
  constexpr int RPT = TS * RB / RTHREADS;  // row operand elements a thread
  constexpr int CPT = TS * V / RTHREADS;   // column operand elements a thread
  constexpr int SR = RTHREADS / RB;        // steps between a thread's row elements
  constexpr int SC = RTHREADS / V;         // and between its column elements
  __shared__ __align__(16) float sk[TS][RB];
  __shared__ __align__(16) float sr[TS][RB];
  __shared__ __align__(16) float sd[TS][RB];
  __shared__ __align__(16) float sy[TS][RB];
  __shared__ __align__(16) float sv[TS][V];
  __shared__ __align__(16) float sdo[TS][V];
  __shared__ double svd[TS];
  __shared__ double sdu[SR][RB];

  const int tid = threadIdx.x;
  const int cg = tid & 15;                 // columns 4 cg .. 4 cg + 3
  const int row = tid >> 4;                // of block row `row`
  const int row0 = blockIdx.x * RB, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nck = (Tn + CK - 1) / CK;
  // staging and the epilogue: block row jrow at steps js + SR q; column jc
  // at steps jsc + SC q
  const int jrow = tid % RB, js = tid / RB, jc = tid % V, jsc = tid / V;
  const double uj = u[h * K + row0 + jrow];

  // the next tile's operands, loaded into registers while this one computes
  float pk[RPT], pr[RPT], pw[RPT], pv[CPT], po[CPT];
  double pvd = 0.0;
  auto fetch = [&](int t0, int n) {
    if (tid < n) pvd = vd[(static_cast<long long>(b) * Tn + t0 + tid) * H + h];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int s = js + q * SR;
      if (s < n) {
        pk[q] = load<T>(o.k, o.ks, b, t0 + s, h, row0 + jrow);
        pr[q] = load<T>(o.r, o.rs, b, t0 + s, h, row0 + jrow);
        pw[q] = load<T>(o.w, o.ws, b, t0 + s, h, row0 + jrow);
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int s = jsc + q * SC;
      if (s < n) {
        pv[q] = load<T>(o.v, o.vs, b, t0 + s, h, jc);
        po[q] = dout[((static_cast<long long>(b) * Tn + t0 + s) * H + h) * V + jc];
      }
    }
  };

  float X[4];                              // row `row`, columns 4 cg .. 4 cg + 3
#pragma unroll
  for (int c = 0; c < 4; ++c)
    X[c] = s0 ? s0[(bh * K + row0 + row) * V + 4 * cg + c] : 0.f;
  double du_acc = 0.0;

  if (Tn > 0) fetch(0, min(TS, Tn));
  for (int t0 = 0; t0 < Tn; t0 += TS) {
    const int n = min(TS, Tn - t0);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int s = js + q * SR;
      if (s < n) {
        sk[s][jrow] = pk[q];
        sr[s][jrow] = pr[q];
        sd[s][jrow] = expf(-expf(pw[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int s = jsc + q * SC;
      if (s < n) {
        sv[s][jc] = pv[q];
        sdo[s][jc] = po[q];
      }
    }
    if (tid < n) svd[tid] = pvd;
    __syncthreads();
    if (t0 + TS < Tn) fetch(t0 + TS, min(TS, Tn - t0 - TS));
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      if (t % CK == 0)                     // S_{t-1}: the start of a 16-step tile
        *reinterpret_cast<float4*>(
            ck + (((static_cast<long long>(b) * nck + t / CK) * H + h) * K + row0 +
                  row) * V + 4 * cg) = make_float4(X[0], X[1], X[2], X[3]);
      const float kk = sk[s][row], dd = sd[s][row];
      float vv[4], oo[4];
      unpack(*reinterpret_cast<const float4*>(&sv[s][4 * cg]), vv);
      unpack(*reinterpret_cast<const float4*>(&sdo[s][4 * cg]), oo);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc = fmaf(X[c], oo[c], acc);               // reads S_{t-1}
        X[c] = fmaf(X[c], dd, kk * vv[c]);          // then S_t
      }
      acc = sum16(acc);
      if (cg == 0) sy[s][row] = acc;
    }
    __syncthreads();
    for (int s = js; s < n; s += SR) {
      const double kvd = static_cast<double>(sk[s][jrow]) * svd[s];
      put(dr + ((static_cast<long long>(b) * Tn + t0 + s) * H + h) * K + row0 + jrow,
          sy[s][jrow] + static_cast<float>(uj * kvd));
      du_acc += static_cast<double>(sr[s][jrow]) * kvd;
    }
    __syncthreads();
  }
  sdu[js][jrow] = du_acc;
  __syncthreads();
  if (tid < RB) {
    double sum = 0.0;
#pragma unroll
    for (int q = 0; q < SR; ++q) sum += sdu[q][tid];
    du_part[bh * K + row0 + tid] = sum;
  }
}

// ------------------------------------------- 2. the reverse column sweep
template <typename T>
__global__ void __launch_bounds__(THREADS)
    cols_reverse_kernel(Operands o, const float* __restrict__ u,
                        const float* __restrict__ dsT,
                        const float* __restrict__ dout, T* __restrict__ dv,
                        const float* __restrict__ av, int Tn, int H) {
  constexpr int OPT = TS * VB / THREADS;   // dout elements a thread
  __shared__ __align__(16) float sr[TS][K];
  __shared__ __align__(16) float sk[TS][K];
  __shared__ __align__(16) float sd[TS][K];
  __shared__ __align__(16) float sdo[TS][VB];
  __shared__ __align__(16) float sy[TS][VB];
  __shared__ float sa[TS];

  const int tid = threadIdx.x, lane = tid & 31;
  const int rj = lane & 15;                // rows 4 rj .. 4 rj + 3
  const int c0 = 4 * (tid >> 4);           // block columns c0 .. c0 + 3
  const int col0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const bool hi8 = rj & 8, hi4 = rj & 4;
  const int ci = 2 * hi8 + hi4;
  // staging: row tid at every step; dout column jc at steps js + 4 q
  const int jc = tid % VB, js = tid / VB;

  float pr[TS], pk[TS], pw[TS], po[OPT], pa = 0.f;
  auto fetch = [&](int t0, int n) {
    if (tid < n) pa = av[(static_cast<long long>(b) * Tn + t0 + tid) * H + h];
#pragma unroll
    for (int q = 0; q < TS; ++q)
      if (q < n) {
        pr[q] = load<T>(o.r, o.rs, b, t0 + q, h, tid);
        pk[q] = load<T>(o.k, o.ks, b, t0 + q, h, tid);
        pw[q] = load<T>(o.w, o.ws, b, t0 + q, h, tid);
      }
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int s = js + q * (THREADS / VB);
      if (s < n)
        po[q] = dout[((static_cast<long long>(b) * Tn + t0 + s) * H + h) * V + col0 + jc];
    }
  };

  float X[16];                             // X[4 c + i]: row 4 rj + i, column c0 + c
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      X[4 * c + i] = dsT ? dsT[(bh * K + 4 * rj + i) * V + col0 + c0 + c] : 0.f;

  const int ntiles = (Tn + TS - 1) / TS;
  if (ntiles > 0) fetch((ntiles - 1) * TS, Tn - (ntiles - 1) * TS);
  for (int it = ntiles - 1; it >= 0; --it) {
    const int t0 = it * TS, n = min(TS, Tn - t0);
#pragma unroll
    for (int q = 0; q < TS; ++q)
      if (q < n) {
        sr[q][tid] = pr[q];
        sk[q][tid] = pk[q];
        sd[q][tid] = expf(-expf(pw[q]));
      }
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int s = js + q * (THREADS / VB);
      if (s < n) sdo[s][jc] = po[q];
    }
    if (tid < n) sa[tid] = pa;
    __syncthreads();
    if (it > 0) fetch(t0 - TS, TS);
#pragma unroll 4
    for (int s = n - 1; s >= 0; --s) {
      float kk[4], rr[4], dd[4], oo[4];
      unpack(*reinterpret_cast<const float4*>(&sk[s][4 * rj]), kk);
      unpack(*reinterpret_cast<const float4*>(&sr[s][4 * rj]), rr);
      unpack(*reinterpret_cast<const float4*>(&sd[s][4 * rj]), dd);
      unpack(*reinterpret_cast<const float4*>(&sdo[s][c0]), oo);
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& x = X[4 * c + i];
          acc[c] = fmaf(kk[i], x, acc[c]);        // reads G_t
          x = fmaf(x, dd[i], rr[i] * oo[c]);      // then G_{t-1}
        }
      }
      const float sum = reduce_scatter16(acc, lane);
      const float oc = hi8 ? (hi4 ? oo[3] : oo[2]) : (hi4 ? oo[1] : oo[0]);
      if ((rj & 3) == 0) sy[s][c0 + ci] = fmaf(oc, sa[s], sum);
    }
    __syncthreads();
    for (int s = js; s < n; s += THREADS / VB)
      put(dv + ((static_cast<long long>(b) * Tn + t0 + s) * H + h) * V + col0 + jc,
          sy[s][jc]);
    __syncthreads();
  }
}

// ----------------------------------------------- 3. the reverse row sweep
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    rows_reverse_kernel(Operands o, const float* __restrict__ u,
                        const float* __restrict__ dsT,
                        const float* __restrict__ dout,
                        const float* __restrict__ ck, T* __restrict__ dk,
                        T* __restrict__ dw, float* __restrict__ ds0,
                        const double* __restrict__ vd, int Tn, int H) {
  constexpr int RPT = CK * RB / RTHREADS;  // row operand elements a thread
  constexpr int CPT = CK * V / RTHREADS;   // column operand elements a thread
  constexpr int SR = RTHREADS / RB;
  constexpr int SC = RTHREADS / V;
  extern __shared__ float4 states[];       // [CK][RTHREADS]: S_{t-1}, each thread's own
  __shared__ __align__(16) float sr[CK][RB];
  __shared__ __align__(16) float sk[CK][RB];
  __shared__ __align__(16) float sd[CK][RB];
  __shared__ __align__(16) float sew[CK][RB];
  __shared__ __align__(16) float sy[CK][RB];
  __shared__ __align__(16) float sz[CK][RB];
  __shared__ __align__(16) float sv[CK][V];
  __shared__ __align__(16) float sdo[CK][V];
  __shared__ double svd[CK];

  const int tid = threadIdx.x;
  const int cg = tid & 15, row = tid >> 4;
  const int row0 = blockIdx.x * RB, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nck = (Tn + CK - 1) / CK;
  const int jrow = tid % RB, js = tid / RB, jc = tid % V, jsc = tid / V;
  const double uj = u[h * K + row0 + jrow];

  // the next tile's operands and start state, loaded while this one computes
  float pr[RPT], pk[RPT], pw[RPT], pv[CPT], po[CPT];
  float4 ps = make_float4(0.f, 0.f, 0.f, 0.f);
  double pvd = 0.0;
  auto fetch = [&](int ti) {
    const int t0 = ti * CK, n = min(CK, Tn - t0);
    if (tid < n) pvd = vd[(static_cast<long long>(b) * Tn + t0 + tid) * H + h];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int s = js + q * SR;
      if (s < n) {
        pr[q] = load<T>(o.r, o.rs, b, t0 + s, h, row0 + jrow);
        pk[q] = load<T>(o.k, o.ks, b, t0 + s, h, row0 + jrow);
        pw[q] = load<T>(o.w, o.ws, b, t0 + s, h, row0 + jrow);
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int s = jsc + q * SC;
      if (s < n) {
        pv[q] = load<T>(o.v, o.vs, b, t0 + s, h, jc);
        po[q] = dout[((static_cast<long long>(b) * Tn + t0 + s) * H + h) * V + jc];
      }
    }
    ps = *reinterpret_cast<const float4*>(
        ck + (((static_cast<long long>(b) * nck + ti) * H + h) * K + row0 + row) * V +
        4 * cg);
  };

  float G[4];                              // row `row`, columns 4 cg .. 4 cg + 3
#pragma unroll
  for (int c = 0; c < 4; ++c)
    G[c] = dsT ? dsT[(bh * K + row0 + row) * V + 4 * cg + c] : 0.f;

  if (nck > 0) fetch(nck - 1);
  for (int ti = nck - 1; ti >= 0; --ti) {
    const int t0 = ti * CK, n = min(CK, Tn - t0);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int s = js + q * SR;
      if (s < n) {
        const float ew = expf(pw[q]);
        sr[s][jrow] = pr[q];
        sk[s][jrow] = pk[q];
        sew[s][jrow] = ew;
        sd[s][jrow] = expf(-ew);
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int s = jsc + q * SC;
      if (s < n) {
        sv[s][jc] = pv[q];
        sdo[s][jc] = po[q];
      }
    }
    if (tid < n) svd[tid] = pvd;
    float S[4];                            // the tile's start state, from ck
    unpack(ps, S);
    __syncthreads();
    if (ti > 0) fetch(ti - 1);
    // the tile's states S_{t-1}, t = t0 .. t0 + n - 1, into this thread's
    // slots (read back only by this thread: no barrier)
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float kk = sk[s][row], dd = sd[s][row];
      float vv[4];
      unpack(*reinterpret_cast<const float4*>(&sv[s][4 * cg]), vv);
      states[s * RTHREADS + tid] = make_float4(S[0], S[1], S[2], S[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) S[c] = fmaf(S[c], dd, kk * vv[c]);
    }
#pragma unroll 4
    for (int s = n - 1; s >= 0; --s) {
      const float rr = sr[s][row], dd = sd[s][row];
      float vv[4], oo[4], sp[4];
      unpack(*reinterpret_cast<const float4*>(&sv[s][4 * cg]), vv);
      unpack(*reinterpret_cast<const float4*>(&sdo[s][4 * cg]), oo);
      unpack(states[s * RTHREADS + tid], sp);
      float y = 0.f, z = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y = fmaf(G[c], vv[c], y);                   // G_t v_t
        z = fmaf(G[c], sp[c], z);                   // rowsum(G_t o S_{t-1})
        G[c] = fmaf(G[c], dd, rr * oo[c]);          // then G_{t-1}
      }
      y = sum16(y);
      z = sum16(z);
      if (cg == 0) {
        sy[s][row] = y;
        sz[s][row] = z;
      }
    }
    __syncthreads();
    for (int s = js; s < n; s += SR) {
      const long long at =
          ((static_cast<long long>(b) * Tn + t0 + s) * H + h) * K + row0 + jrow;
      const double rvd = static_cast<double>(sr[s][jrow]) * svd[s];
      put(dk + at, sy[s][jrow] + static_cast<float>(uj * rvd));
      put(dw + at, -sew[s][jrow] * sd[s][jrow] * sz[s][jrow]);
    }
    __syncthreads();
  }
  if (ds0 != nullptr)
    *reinterpret_cast<float4*>(ds0 + (bh * K + row0 + row) * V + 4 * cg) =
        make_float4(G[0], G[1], G[2], G[3]);
}

// ------------------------------------------------ 4. du over the batch
__global__ void __launch_bounds__(K)
    du_reduce_kernel(const double* __restrict__ du_part, float* __restrict__ du, int B,
              int H) {
  const int h = blockIdx.x, k = threadIdx.x;
  double sum = 0.0;
  for (int b = 0; b < B; ++b) sum += du_part[(static_cast<long long>(b) * H + h) * K + k];
  du[h * K + k] = static_cast<float>(sum);
}

constexpr int STATES_SMEM = CK * RTHREADS * static_cast<int>(sizeof(float4));

template <typename T>
int launch(const Operands& o, const float* u, const float* s0,
           const float* dout, const float* dsT, void* dr, void* dk, void* dv,
           void* dw, float* du, float* ds0, float* ck, double* du_part,
           double* vd, float* av, int B, int Tn, int H, cudaStream_t st) {
  const dim3 rows(K / RB, H, B), cols(V / VB, H, B);
  const long long steps = static_cast<long long>(B) * Tn * H;
  if (steps > 0) {
    scalars_kernel<T><<<static_cast<unsigned>((steps + 7) / 8), 256, 0, st>>>(
        o, u, dout, vd, av, B, Tn, H);
    const cudaError_t e0 = cudaGetLastError();
    if (e0 != cudaSuccess) return static_cast<int>(e0);
  }
  rows_forward_kernel<T><<<rows, RTHREADS, 0, st>>>(o, u, s0, dout, static_cast<T*>(dr),
                                            ck, du_part, vd, Tn, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cols_reverse_kernel<T><<<cols, THREADS, 0, st>>>(o, u, dsT, dout, static_cast<T*>(dv),
                                            av, Tn, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // set on every launch: the attribute belongs to the current device's context
  e = cudaFuncSetAttribute(rows_reverse_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, STATES_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  rows_reverse_kernel<T><<<rows, RTHREADS, STATES_SMEM, st>>>(
      o, u, dsT, dout, ck, static_cast<T*>(dk), static_cast<T*>(dw), ds0, vd,
      Tn, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  du_reduce_kernel<<<H, K, 0, st>>>(du_part, du, B, H);
  return static_cast<int>(cudaGetLastError());
}


// ================================================ the chunked instance
// (the `sweep` kernels above stay as the fp32 instance and the yardstick)
//
// Design origin: the chunked forms of flash-linear-attention's chunk_rwkv6
// and GLA's two-level chunking (Yang et al. 2023, arXiv:2312.06635, sec. 4),
// with gates arranged so that no exponential ever exceeds 1.  Per (batch,
// head), with log-decay l_t = -exp(w_t), chunks of L = 64 steps and
// sub-chunks of SL = 16:
//   A. The chunk states.  A1, chunk_product_kernel, one warpgroup per
//      (head, chunk, batch and role), every chunk at once: the chunk's
//      product (k o e^{sum of l after s})^T v (S) or (r o e^{sum of l
//      before j})^T dout (G), 64 x 64 x 64 on TF32 wgmma (m64n64k8), its
//      gates on CUDA cores; A2, chunk_scan_kernel, a thread per (role, row,
//      4 columns) walks the chunks: S_{c+1} = diag(e^{sum l}) S_c + X_c
//      forward from s0, G_{c-1} = diag(e^{sum l}) G_c + X_c backward from
//      dsT, writing S at each chunk's start and G at its end (the last G is
//      ds0).  (One warpgroup per (role, 32 state columns) walking the chunks
//      with the product inside the walk ran slower on an H100: each chunk's
//      loads and gates sat on the walk.)
//   B. chunk_grads_kernel: one block per (batch, head, chunk), two
//      warpgroups.  From S_c and G_c it runs the same two recurrences over
//      the chunk's four sub-chunks (warpgroup 1: G at each sub-chunk's end;
//      warpgroup 0: S at each start), and per sub-chunk q with pex / X the
//      sums of l over its steps before / after a step:
//        dr = e^pex o (dout S_q^T) + sum_{s<i} A_is g(i,s) k_s + u k (v.dout)
//        dk = e^X o (v G_q^T) + sum_{s>i} A_si g(s,i) r_s + u r (v.dout)
//        dv = (k o e^X) G_q + sum_{s>i} P_si dout_s + a_i dout_i
//      with A = dout v^T and g(s2, s) = e^{sum of l strictly between} the
//      exact pairwise gate, P_{s2 s} = sum_k r_s2 k_s g.  The products
//      (A, the sub-chunk states, dout S_q^T, v G_q^T, (k o e^X) G_q) run on
//      TF32 wgmma with fp32 sums, S_q and G_q as register A operands where
//      they are contracted over V; the diagonal sub-chunk pairs (120 a
//      sub-chunk, exact gates) on CUDA cores, one thread a (row k,
//      sub-chunk).  dw = l o d_i rowsum(G_i o S_{i-1}), expanded as
//        e^{sum l} rowsum(S_q o G_q) + sum_{s2>i} r o dr's state term
//        + sum_{s<i} k o dk's state term + sum_{s<i<s2} g(s2,s) r k A
//      inside the sub-chunk: every term is gated by the decays it spans, so
//      nothing cancels where a decay is near 0 and nothing is divided by
//      one (the suffix-sum identity the sweep's note rejects does both).
//   The scalar pre-pass (scalars_kernel) and the in-order du reduce are the
//   sweep's; du's partials are per (batch, chunk).  No atomics.
// bf16 operands are the training path; wgmma reads tf32, so the products
// see dout, the states and the gated operands rounded to 10 bits of
// mantissa (r, k, v are bf16 already): within the bf16 gradients' 2^-7.
// fp32 operands run the same kernels (checks and timing only): one TF32
// rounding misses fp32's 1e-5, and 3xTF32 throughout would need the low
// halves of chunk_grads_kernel's nine operand tiles, 144 KB beyond its 210.
//
// Bound at rwkv6-1.6b's training microbatch (bf16, B 2, T 2048, H 32):
// the function moves r, k, v, w, the four gradients in bf16 and dout in
// fp32 once (168 MB, 0.050 ms at 3.35 TB/s), and its 5.4 GFLOP take 0.011
// ms at TF32's 495 TFLOP/s: bytes bound it (chip_smoke.py's bound_ms).
// This design adds its fp32 scratch, each written and read once (the
// chunks' products of both roles, 2 x 67 MB; the chunk states S and G, 2 x
// 2 x 33.5 MB: 436 MB in all, 0.130 ms), and runs 10.2 GFLOP of TF32
// products (0.021 ms; wkv_chunked_work) beside the CUDA cores' diagonal
// pairs.  The kernels run far from either (PERF.md): chunk_grads_kernel
// holds 210 KB of shared memory and 255 registers a thread, one block of
// 8 warps an SM, and its phases (staging, the short chained products, the
// diagonal pairs) are latency-bound there.
namespace chunked {

using namespace hopper;

constexpr int L = 64;              // steps per chunk
constexpr int SL = 16;             // steps per sub-chunk
constexpr int NS = L / SL;
constexpr int TILE = 64 * 64 * 4;  // a 64 x 64 fp32 tile, bytes

__device__ __forceinline__ float tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}
__device__ __forceinline__ uint32_t tf32_bits(float x) { return __float_as_uint(tf32(x)); }

// Element (row, col) of a K-major wgmma tile of `rows` rows and 64 fp32
// columns: two boxes of 32 columns (128-byte rows), each swizzled as TMA's
// 128-byte swizzle lays it (16-byte unit c ^ (row & 7)); tiles are
// 1024-aligned.
__device__ __forceinline__ int swz(int rows, int row, int col) {
  const int c = col & 31;
  return (col >> 5) * rows * 128 + row * 128 + (((c >> 2) ^ (row & 7)) << 4) +
         ((c & 3) << 2);
}
__device__ __forceinline__ void st(uint8_t* tile, int rows, int row, int col, float x) {
  *reinterpret_cast<float*>(tile + swz(rows, row, col)) = tf32(x);
}
// the descriptor of k-step kk (8 columns) of such a tile from row row0 (a
// multiple of 8)
__device__ __forceinline__ uint64_t desc(const uint8_t* tile, int rows, int row0, int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16,
                   1024, 128);
}
// Where v sits in a tile contracted over V against a register A operand: an
// accumulator holds columns 8i + 2 (lane % 4) + {0, 1}, the tf32 A fragment
// columns 8i + lane % 4 + {0, 4}, so within each 8 columns v = 2j lies at j
// and v = 2j + 1 at j + 4 (every operand contracted over V uses this order)
__device__ __forceinline__ int vperm(int v) {
  return (v & ~7) + ((v & 1) << 2) + ((v & 7) >> 1);
}
// the A fragments of an accumulator's 64 x 64 tile, contracted over its
// columns: k-step kk takes d[4kk], d[4kk + 2], d[4kk + 1], d[4kk + 3]
__device__ __forceinline__ void frags(uint32_t (&f)[8][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    f[kk][0] = tf32_bits(d[4 * kk]);
    f[kk][1] = tf32_bits(d[4 * kk + 2]);
    f[kk][2] = tf32_bits(d[4 * kk + 1]);
    f[kk][3] = tf32_bits(d[4 * kk + 3]);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One halving step of reduce_scatter32: lanes with bit W set keep the
// upper W values, the others the lower, each adding its partner's
template <int W>
__device__ __forceinline__ void halve(float (&x)[32], int lane) {
  const bool hi = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = hi ? x[i] : x[i + W];
    const float keep = hi ? x[i + W] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Returns to lane l the sum over the warp of x[l]: halve the values five
// times (31 shuffles for 32 sums).  Clobbers x.
__device__ __forceinline__ float reduce_scatter32(float (&x)[32], int lane) {
  halve<16>(x, lane);
  halve<8>(x, lane);
  halve<4>(x, lane);
  halve<2>(x, lane);
  halve<1>(x, lane);
  return x[0];
}

// D[64x64] += A[64x8] B[8x64], tf32, both K-major in shared memory
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64x16] += A[64x8] B[8x16], tf32, both K-major in shared memory
__device__ __forceinline__ void mma_ss_n16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// D[64x16] += A[64x8] (registers, tf32 bits) B[8x16] (K-major in shared memory)
__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --------------------------------------- A. the chunk states, two kernels
// A1. chunk_product_kernel: one warpgroup per (head, chunk, batch and
// role), all chunks at once: the S role's X_c = (k o e^{sum of l after s})^T
// v, the G role's (r o e^{sum of l before j})^T dout, 64 x 64 x 64 on TF32
// wgmma, and the chunk's sum of l per row.  The G role runs in 3xTF32
// (hi x hi + hi x lo + lo x hi): its last state is dstate0, an fp32
// gradient held to fp32's 1e-5, which one TF32 rounding of dout and the
// gated r (2^-11) would miss.
template <typename T>
__global__ void __launch_bounds__(128)
    chunk_product_kernel(Operands o, const float* __restrict__ dout,
                         float* __restrict__ xck, float* __restrict__ lck, int Tn,
                         int H) {
  extern __shared__ uint8_t smem_cp[];
  uint8_t* X = align1024(smem_cp);            // [64 k][64 steps]: gated k or r
  uint8_t* Y = X + TILE;                      // [64 v][64 steps]: v or dout
  uint8_t* Xlo = Y + TILE;                    // the G role's rounding residues
  uint8_t* Ylo = Xlo + TILE;
  float* part = reinterpret_cast<float*>(Ylo + TILE);  // [2][64]: each half's sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z >> 1, role = blockIdx.z & 1;
  const int nc = gridDim.y, t0 = c * L, last = min(L, Tn - t0) - 1;
  const int kr = tid & 63, half = tid >> 6;   // gates: row kr, steps 32 half + ..
  const int yc = tid & 63, ys = tid >> 6;     // y: column yc, steps ys + 2 m
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const void* xs = role == 0 ? o.k : o.r;
  const Strides xst = role == 0 ? o.ks : o.rs;

  // the operands as they lie (steps past T read the last step; zeroed below)
  float xr[32], lv[32], yr[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int t = t0 + min(32 * half + j, last);
    xr[j] = load<T>(xs, xst, b, t, h, kr);
    lv[j] = load<T>(o.w, o.ws, b, t, h, kr);
  }
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const int t = t0 + min(ys + 2 * m, last);
    yr[m] = role == 0 ? load<T>(o.v, o.vs, b, t, h, yc)
                      : dout[((static_cast<long long>(b) * Tn + t) * H + h) * V + yc];
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const bool in = 32 * half + j <= last;
    xr[j] = in ? xr[j] : 0.f;
    lv[j] = in ? -expf(lv[j]) : 0.f;
    sum += lv[j];
  }
  part[half * 64 + kr] = sum;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const int s = ys + 2 * m;
    const float y = s <= last ? yr[m] : 0.f;
    st(Y, 64, yc, s, y);
    if (role == 1) st(Ylo, 64, yc, s, y - tf32(y));
  }
  __syncthreads();
  // S: the gate of step s is e^{sum of l after s}; G: e^{sum of l before s}
  float run = role == 0 ? (half == 0 ? part[64 + kr] : 0.f) : (half == 1 ? part[kr] : 0.f);
  if (role == 0) {
#pragma unroll
    for (int j = 31; j >= 0; --j) {
      st(X, 64, kr, 32 * half + j, xr[j] * expf(run));
      run += lv[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float x = xr[j] * expf(run);
      st(X, 64, kr, 32 * half + j, x);
      st(Xlo, 64, kr, 32 * half + j, x - tf32(x));
      run += lv[j];
    }
  }
  const long long at = ((static_cast<long long>(b) * nc + c) * 2 + role) * H + h;
  if (half == 0) lck[at * K + kr] = part[kr] + part[64 + kr];
  fence_proxy_async();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_ss_n64(acc, desc(X, 64, 0, kk), desc(Y, 64, 0, kk));
  if (role == 1) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      mma_ss_n64(acc, desc(X, 64, 0, kk), desc(Ylo, 64, 0, kk));
      mma_ss_n64(acc, desc(Xlo, 64, 0, kk), desc(Y, 64, 0, kk));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  float* dst = xck + at * K * V;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int row = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + c0;
    *reinterpret_cast<float2*>(dst + row * V + col) = make_float2(acc[e], acc[e + 1]);
  }
}

constexpr size_t PRODUCT_SMEM = 1024 + 4 * TILE + 2 * 64 * 4;

// A2. chunk_scan_kernel: one thread per (role, batch, head, row, 4
// columns) walks the chunks, S forward from s0 (or 0), G backward from dsT
// (or 0): state_{next} = e^{sum l} state + X_c, writing each chunk's start
// (S) or end (G) state; the G role's last is ds0
__global__ void __launch_bounds__(256)
    chunk_scan_kernel(const float* __restrict__ xck, const float* __restrict__ lck,
                      const float* __restrict__ s0, const float* __restrict__ dsT,
                      float* __restrict__ sck, float* __restrict__ gck,
                      float* __restrict__ ds0, int B, int nc, int H) {
  const long long per_role = static_cast<long long>(B) * H * K * (V / 4);
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= 2 * per_role) return;
  const int role = static_cast<int>(idx / per_role);
  long long rem = idx % per_role;
  const int v4 = static_cast<int>(rem % (V / 4));
  rem /= V / 4;
  const int k = static_cast<int>(rem % K);
  rem /= K;
  const int h = static_cast<int>(rem % H);
  const int b = static_cast<int>(rem / H);
  const long long bh = static_cast<long long>(b) * H + h;
  const float* init = role == 0 ? s0 : dsT;
  float4 st4 = init ? *reinterpret_cast<const float4*>(init + (bh * K + k) * V + 4 * v4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  float* out = role == 0 ? sck : gck;
#pragma unroll 4
  for (int it = 0; it < nc; ++it) {
    const int c = role == 0 ? it : nc - 1 - it;
    const long long bc = static_cast<long long>(b) * nc + c;
    *reinterpret_cast<float4*>(out + ((bc * H + h) * K + k) * V + 4 * v4) = st4;
    const long long at = (bc * 2 + role) * H + h;
    const float d = expf(lck[at * K + k]);
    const float4 x = *reinterpret_cast<const float4*>(xck + (at * K + k) * V + 4 * v4);
    st4 = make_float4(fmaf(d, st4.x, x.x), fmaf(d, st4.y, x.y), fmaf(d, st4.z, x.z),
                      fmaf(d, st4.w, x.w));
  }
  if (role == 1 && ds0 != nullptr)
    *reinterpret_cast<float4*>(ds0 + (bh * K + k) * V + 4 * v4) = st4;
}

// --------------------------------------- B. the chunk-local gradients
struct GradsSmem {                         // byte offsets from a 1024-aligned base
  static constexpr int DO = 0;             // [i][v perm] dout
  static constexpr int DOT = DO + TILE;    // [v][j] dout
  static constexpr int VV = DOT + TILE;    // [j][v perm] v
  static constexpr int VT = VV + TILE;     // [v][s] v
  static constexpr int KBT = VT + TILE;    // [k][s] k o e^X
  static constexpr int KB = KBT + TILE;    // [i][k] k o e^X
  static constexpr int RBT = KB + TILE;    // [k][j] r o e^pex
  static constexpr int GT = RBT + TILE;    // [2][v][k] G_q, alternating
  static constexpr int GBUF = GT + 2 * TILE;  // [4][32][128]: G_q as warpgroup 1 holds it
  static constexpr int AD = GBUF + NS * TILE;        // [4][16][16]: A's diagonal blocks
  static constexpr int PP = AD + NS * SL * SL * 4;   // [4][2][128]: P's sums per warp
  static constexpr int TOT = PP + NS * 2 * 128 * 4;  // [4][64]: sum of l over sub-chunk q
  static constexpr int SG = TOT + NS * 64 * 4;       // [4][64]: rowsum(S_q o G_q)
  static constexpr int VD = SG + NS * 64 * 4;        // [64] fp64: v . dout
  static constexpr int DU = VD + L * 8;              // [4][64] fp64: du's sums
  static constexpr int AV = DU + NS * 64 * 8;        // [64]: a_t
  static constexpr int BYTES = AV + L * 4;
  // after the products, plain [64][64] fp32 in tiles that are read no more
  static constexpr int DR = KBT, DK = VT, DV = RBT;
};
constexpr size_t GRADS_SMEM = 1024 + GradsSmem::BYTES;

// Row kr of sub-chunk q's 16 steps (from s0q) as they lie: r, k and w
// (steps past T read the last step; sub_gates zeroes them)
template <typename T>
__device__ __forceinline__ void sub_load(const Operands& o, int b, int t0, int n, int h,
                                         int kr, int s0q, float (&rr)[SL],
                                         float (&kv)[SL], float (&wr)[SL]) {
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    const int t = t0 + min(s0q + i, n - 1);
    rr[i] = load<T>(o.r, o.rs, b, t, h, kr);
    kv[i] = load<T>(o.k, o.ks, b, t, h, kr);
    wr[i] = load<T>(o.w, o.ws, b, t, h, kr);
  }
}

// From sub_load's values: r, k, l (0 past T), and the sums of l over the
// sub-chunk's steps before (pex) and after (xs) each step, and over all of
// it (tot)
__device__ __forceinline__ void sub_gates(int n, int s0q, float (&rr)[SL], float (&kv)[SL],
                                          const float (&wr)[SL], float (&lam)[SL],
                                          float (&pex)[SL], float (&xs)[SL], float& tot) {
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    const bool in = s0q + i < n;
    rr[i] = in ? rr[i] : 0.f;
    kv[i] = in ? kv[i] : 0.f;
    lam[i] = in ? -expf(wr[i]) : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    pex[i] = run;
    run += lam[i];
  }
  tot = run;
  run = 0.f;
#pragma unroll
  for (int i = SL - 1; i >= 0; --i) {
    xs[i] = run;
    run += lam[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 1)
    chunk_grads_kernel(Operands o, const float* __restrict__ u,
                       const float* __restrict__ dout, const float* __restrict__ sck,
                       const float* __restrict__ gck, const double* __restrict__ vd,
                       const float* __restrict__ av, T* __restrict__ dr,
                       T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dw,
                       double* __restrict__ du_part, int Tn, int H) {
  using M = GradsSmem;
  extern __shared__ uint8_t smem_cg[];
  uint8_t* base = align1024(smem_cg);
  uint8_t* DO = base + M::DO;
  uint8_t* DOT = base + M::DOT;
  uint8_t* VV = base + M::VV;
  uint8_t* VT = base + M::VT;
  uint8_t* KBT = base + M::KBT;
  uint8_t* KB = base + M::KB;
  uint8_t* RBT = base + M::RBT;
  uint8_t* GT = base + M::GT;
  float* gbuf = reinterpret_cast<float*>(base + M::GBUF);
  float* ad = reinterpret_cast<float*>(base + M::AD);
  float* pp = reinterpret_cast<float*>(base + M::PP);
  float* tots = reinterpret_cast<float*>(base + M::TOT);
  float* sg = reinterpret_cast<float*>(base + M::SG);
  double* vds = reinterpret_cast<double*>(base + M::VD);
  double* dus = reinterpret_cast<double*>(base + M::DU);
  float* avs = reinterpret_cast<float*>(base + M::AV);

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // uniform to the compiler
  const int wt = tid & 127, w = wt >> 5;   // thread and warp in the warpgroup
  const int r0 = 16 * w + (lane >> 2), c0 = 2 * (lane & 3);
  // heads vary fastest over the grid: blocks in flight read whole rows of
  // the [B, T, H, 64] operands
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * L, n = min(L, Tn - t0);
  const int kr = tid & 63, q = tid >> 6;   // CUDA-core work: row kr of sub-chunk q
  const int s0q = SL * q;
  const long long rowstride = static_cast<long long>(H) * V;
  const float* dob = dout + ((static_cast<long long>(b) * Tn + t0) * H + h) * V;

  // ---- stage: v and dout (column tid % 64, steps tid / 64 + 4 m), the
  // gated k and r, the per-step scalars, and S_c (warpgroup 0) or G_c (1).
  // Every global load is issued before the first shared-memory store (the
  // compiler keeps a load behind a store it cannot tell apart from it).
  float vr[16], orr[16], rr[SL], kv[SL], wr[SL], sv[32];
#pragma unroll
  for (int m = 0; m < 16; ++m) {            // past T: the last step's, zeroed below
    const int s = min((tid >> 6) + 4 * m, n - 1), col = tid & 63;
    vr[m] = load<T>(o.v, o.vs, b, t0 + s, h, col);
    orr[m] = dob[s * rowstride + col];
  }
  sub_load<T>(o, b, t0, n, h, kr, s0q, rr, kv, wr);
  {
    const float* src = (wg == 0 ? sck : gck) +
                       ((static_cast<long long>(b) * nc + c) * H + h) * K * V;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + c0;
      const float2 x = *reinterpret_cast<const float2*>(src + row * V + col);
      sv[e] = x.x;
      sv[e + 1] = x.y;
    }
  }
  double vdv = 0.0;
  float avv = 0.f;
  if (tid < L) {
    const long long i = (static_cast<long long>(b) * Tn + t0 + min(tid, n - 1)) * H + h;
    vdv = tid < n ? vd[i] : 0.0;
    avv = tid < n ? av[i] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int s = (tid >> 6) + 4 * m, col = tid & 63;
    const float vv = s < n ? vr[m] : 0.f, oo = s < n ? orr[m] : 0.f;
    st(VV, 64, s, vperm(col), vv);
    st(VT, 64, col, s, vv);
    st(DO, 64, s, vperm(col), oo);
    st(DOT, 64, col, s, oo);
  }
  if (tid < L) {
    vds[tid] = vdv;
    avs[tid] = avv;
  }
  {
    float lam[SL], pex[SL], xs[SL], tot;
    sub_gates(n, s0q, rr, kv, wr, lam, pex, xs, tot);
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      const float kb = kv[i] * expf(xs[i]);
      st(KBT, 64, kr, s0q + i, kb);
      st(KB, 64, s0q + i, kr, kb);
      st(RBT, 64, kr, s0q + i, rr[i] * expf(pex[i]));
    }
    tots[q * 64 + kr] = tot;
  }
  fence_proxy_async();
  __syncthreads();

  // ---- products.  Warpgroup 0: A = dout v^T, then S at each sub-chunk's
  // start with dr's state term (dout S_q^T, as dr^T) and rowsum(S_q o G_q).
  // Warpgroup 1: G at each sub-chunk's end, then dk's state term (v G_q^T,
  // as dk^T) and dv's ((k o e^X) G_q, as dv^T).
  float acc_a[32], acc1[32], acc2[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc_a[e] = acc1[e] = acc2[e] = 0.f;
  if (wg == 0) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      mma_ss_n64(acc_a, desc(DO, 64, 0, kk), desc(VV, 64, 0, kk));
    wgmma_commit();
  } else {
#pragma unroll
    for (int qq = NS - 1; qq >= 0; --qq) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
        *reinterpret_cast<float4*>(gbuf + qq * 4096 + (m * 128 + wt) * 4) =
            make_float4(sv[4 * m], sv[4 * m + 1], sv[4 * m + 2], sv[4 * m + 3]);
      if (qq == 0) break;
      const float e0 = expf(tots[qq * 64 + r0]), e1 = expf(tots[qq * 64 + r0 + 8]);
#pragma unroll
      for (int e = 0; e < 32; ++e) sv[e] *= (e & 2) ? e1 : e0;
      wgmma_fence();
      mma_ss_n64(sv, desc(RBT, 64, 0, 2 * qq), desc(DOT, 64, 0, 2 * qq));
      mma_ss_n64(sv, desc(RBT, 64, 0, 2 * qq + 1), desc(DOT, 64, 0, 2 * qq + 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sv);
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int qq = 0; qq < NS; ++qq) {
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float4 g = *reinterpret_cast<const float4*>(gbuf + qq * 4096 + (m * 128 + wt) * 4);
        p0 = fmaf(sv[4 * m], g.x, fmaf(sv[4 * m + 1], g.y, p0));
        p1 = fmaf(sv[4 * m + 2], g.z, fmaf(sv[4 * m + 3], g.w, p1));
      }
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      if ((lane & 3) == 0) {
        sg[qq * 64 + r0] = p0;
        sg[qq * 64 + r0 + 8] = p1;
      }
      uint32_t f[8][4];
      frags(f, sv);
      if (qq < NS - 1) {
        const float e0 = expf(tots[qq * 64 + r0]), e1 = expf(tots[qq * 64 + r0 + 8]);
#pragma unroll
        for (int e = 0; e < 32; ++e) sv[e] *= (e & 2) ? e1 : e0;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) mma_rs_n16(acc1 + 8 * qq, f[kk], desc(DO, 64, SL * qq, kk));
      if (qq < NS - 1) {
        mma_ss_n64(sv, desc(KBT, 64, 0, 2 * qq), desc(VT, 64, 0, 2 * qq));
        mma_ss_n64(sv, desc(KBT, 64, 0, 2 * qq + 1), desc(VT, 64, 0, 2 * qq + 1));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sv);
      fence_regs(acc1);
      fence_regs(acc_a);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(f[kk]);
    }
  } else {
#pragma unroll
    for (int qq = 0; qq < NS; ++qq) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float4 g = *reinterpret_cast<const float4*>(gbuf + qq * 4096 + (m * 128 + wt) * 4);
        sv[4 * m] = g.x;
        sv[4 * m + 1] = g.y;
        sv[4 * m + 2] = g.z;
        sv[4 * m + 3] = g.w;
      }
      uint32_t f[8][4];
      frags(f, sv);
      // G_q^T into buffer qq % 2, whose products of qq - 2 are done (the
      // wait below and the barrier after it)
      uint8_t* gt = GT + (qq & 1) * TILE;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        st(gt, 64, 8 * (e >> 2) + c0 + (e & 1), r0 + 8 * ((e >> 1) & 1), sv[e]);
      fence_proxy_async();
      wg_barrier(1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) mma_rs_n16(acc1 + 8 * qq, f[kk], desc(VV, 64, SL * qq, kk));
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mma_ss_n16(acc2 + 8 * qq, desc(gt, 64, 0, kk), desc(KB, 64, SL * qq, kk));
      wgmma_commit();
      // done before f is rebuilt; the second buffer spares a barrier after
      wgmma_wait<0>();
      fence_regs(acc1);
      fence_regs(acc2);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(f[kk]);
    }
  }
  __syncthreads();

  // ---- the accumulators into plain [64][64] tiles: A's diagonal blocks,
  // dr's and dk's state terms ([i][k], ungated), dv's ([i][v])
  float* drs_t = reinterpret_cast<float*>(base + M::DR);
  float* dks_t = reinterpret_cast<float*>(base + M::DK);
  float* dvs_t = reinterpret_cast<float*>(base + M::DV);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int row = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + c0 + (e & 1);
    if (wg == 0) {
      if ((e >> 3) == w) ad[row * SL + col - SL * w] = acc_a[e];
      drs_t[col * 64 + row] = acc1[e];
    } else {
      dks_t[col * 64 + row] = acc1[e];
      dvs_t[col * 64 + row] = acc2[e];
    }
  }
  __syncthreads();

  // ---- row kr of sub-chunk q on CUDA cores: the gates again, the diagonal
  // pairs, dw, and dr, dk, dw out
  {
    float lam[SL], pex[SL], xs[SL], tot;
    sub_load<T>(o, b, t0, n, h, kr, s0q, rr, kv, wr);
    sub_gates(n, s0q, rr, kv, wr, lam, pex, xs, tot);
    float drv[SL], dkv[SL], ddd[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      drv[i] = expf(pex[i]) * drs_t[(s0q + i) * 64 + kr];
      dkv[i] = expf(xs[i]) * dks_t[(s0q + i) * 64 + kr];
    }
    // dw's boundary and state terms: e^tot rowsum(S_q o G_q), the suffix
    // sums of r o dr's state term and the prefix sums of k o dk's
    const float base_term = expf(tot) * sg[q * 64 + kr];
    float run = 0.f;
#pragma unroll
    for (int i = SL - 1; i >= 0; --i) {
      ddd[i] = base_term + run;
      run = fmaf(rr[i], drv[i], run);
    }
    run = 0.f;
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      ddd[i] += run;
      run = fmaf(kv[i], dkv[i], run);
    }
    // the pairs s < s2 of the sub-chunk, exact gates; P's terms summed over
    // the warp's 32 rows, 32 pairs at a time
    // (the straddling terms of a given s2 as a running sum over s: ddd_i
    // gains the terms s < i)
    const float* adq = ad + q * SL * SL;
    float* ppw = pp + (q * 2 + ((tid >> 5) & 1)) * 128;
    float vals[32], pex2[SL], pin2[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      pex2[i] = pex[i] * LOG2E;
      pin2[i] = (pex[i] + lam[i]) * LOG2E;
    }
#pragma unroll
    for (int s2 = 1; s2 < SL; ++s2) {
      float run = 0.f;
#pragma unroll
      for (int s = 0; s < s2; ++s) {
        const int p = s2 * (s2 - 1) / 2 + s;
        const float gm = ex2(pex2[s2] - pin2[s]);
        const float a = adq[s2 * SL + s];
        const float ag = a * gm;
        drv[s2] = fmaf(ag, kv[s], drv[s2]);
        dkv[s] = fmaf(ag, rr[s2], dkv[s]);
        const float pr = rr[s2] * kv[s] * gm;
        if (s + 1 < s2) {
          run = fmaf(pr, a, run);
          ddd[s + 1] += run;
        }
        vals[p & 31] = pr;
        if ((p & 31) == 31) ppw[(p & ~31) + lane] = reduce_scatter32(vals, lane);
      }
    }
#pragma unroll
    for (int j = 24; j < 32; ++j) vals[j] = 0.f;
    ppw[96 + lane] = reduce_scatter32(vals, lane);
    const double uk = u[h * K + kr];
    double du_acc = 0.0;
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      const int s = s0q + i;
      if (s < n) {
        const double kvd = static_cast<double>(kv[i]) * vds[s];
        const double rvd = static_cast<double>(rr[i]) * vds[s];
        const long long at = ((static_cast<long long>(b) * Tn + t0 + s) * H + h) * K + kr;
        put(dr + at, drv[i] + static_cast<float>(uk * kvd));
        put(dk + at, dkv[i] + static_cast<float>(uk * rvd));
        put(dw + at, lam[i] * ddd[i]);
        du_acc += static_cast<double>(rr[i]) * kvd;
      }
    }
    dus[q * 64 + kr] = du_acc;
  }
  __syncthreads();

  // ---- column kr of dv over sub-chunk q: the state term, a_i dout_i and
  // the pairs; du's partial sums of the chunk, in order
  if (tid < K)
    du_part[((static_cast<long long>(b) * nc + c) * H + h) * K + tid] =
        dus[tid] + dus[64 + tid] + dus[128 + tid] + dus[192 + tid];
  {
    float oo[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) oo[i] = dob[min(s0q + i, n - 1) * rowstride + kr];
#pragma unroll
    for (int i = 0; i < SL; ++i) oo[i] = s0q + i < n ? oo[i] : 0.f;
    const float* pq = pp + q * 2 * 128;
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      if (s0q + i >= n) break;
      float acc = fmaf(avs[s0q + i], oo[i], dvs_t[(s0q + i) * 64 + kr]);
#pragma unroll
      for (int s2 = i + 1; s2 < SL; ++s2) {
        const int p = s2 * (s2 - 1) / 2 + i;
        acc = fmaf(pq[p] + pq[128 + p], oo[s2], acc);
      }
      put(dv + ((static_cast<long long>(b) * Tn + t0 + s0q + i) * H + h) * V + kr, acc);
    }
  }
}

template <typename T>
int launch(const Operands& o, const float* u, const float* s0, const float* dout,
           const float* dsT, void* dr, void* dk, void* dv, void* dw, float* du,
           float* ds0, float* sck, float* gck, float* xck, float* lck, double* du_part,
           double* vd, float* av, int B, int Tn, int H, cudaStream_t st) {
  const long long steps = static_cast<long long>(B) * Tn * H;
  if (steps > 0) {
    scalars_kernel<T><<<static_cast<unsigned>((steps + 7) / 8), 256, 0, st>>>(
        o, u, dout, vd, av, B, Tn, H);
    const cudaError_t e0 = cudaGetLastError();
    if (e0 != cudaSuccess) return static_cast<int>(e0);
  }
  const int nc = (Tn + L - 1) / L;
  cudaError_t e;
  if (nc > 0) {
    e = cudaFuncSetAttribute(chunk_product_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(PRODUCT_SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    chunk_product_kernel<T><<<dim3(H, nc, 2 * B), 128, PRODUCT_SMEM, st>>>(
        o, dout, xck, lck, Tn, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long threads = 2LL * B * H * K * (V / 4);
  chunk_scan_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      xck, lck, s0, dsT, sck, gck, ds0, B, nc, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nc > 0) {
    // set on every launch: the attribute belongs to the current device's context
    e = cudaFuncSetAttribute(chunk_grads_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(GRADS_SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    chunk_grads_kernel<T><<<dim3(H, nc, B), 256, GRADS_SMEM, st>>>(
        o, u, dout, sck, gck, vd, av, static_cast<T*>(dr), static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<T*>(dw), du_part, Tn, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  du_reduce_kernel<<<H, K, 0, st>>>(du_part, du, B * nc, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 is fp32, 1 is bf16 (r,
// k, v, w and dr, dk, dv, dw alike).  Strides are in elements, in the order
// (batch, step, head) for r, k, v, w; the last dim has unit stride.  s0, dsT
// and ds0 may be null.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for head sizes other than 64, a dtype other than 0
// or 1, or a grid too large.
extern "C" int rwkv6_bwd_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, const void* dout, const void* dsT, void* dr, void* dk,
    void* dv, void* dw, void* du, void* ds0, void* ck, void* du_part,
    void* vd, void* av, int dtype, int B, int Tn, int H, int Kd, int Vd, long long rsb,
    long long rst, long long rsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, long long wsb, long long wst,
    long long wsh, void* stream) {
  if (B == 0 || H == 0) return 0;
  if ((dtype != 0 && dtype != 1) || Kd != K || Vd != V || B > 65535 ||
      H > 65535 || Tn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{r, k, v, w, Strides{rsb, rst, rsh}, Strides{ksb, kst, ksh},
                   Strides{vsb, vst, vsh}, Strides{wsb, wst, wsh}};
  auto st = static_cast<cudaStream_t>(stream);
  auto uf = static_cast<const float*>(u);
  auto s0f = static_cast<const float*>(s0);
  auto dof = static_cast<const float*>(dout);
  auto dsf = static_cast<const float*>(dsT);
  if (dtype == 0)
    return launch<float>(o, uf, s0f, dof, dsf, dr, dk, dv, dw,
                         static_cast<float*>(du), static_cast<float*>(ds0),
                         static_cast<float*>(ck), static_cast<double*>(du_part),
                         static_cast<double*>(vd), static_cast<float*>(av), B,
                         Tn, H, st);
  return launch<bf16>(o, uf, s0f, dof, dsf, dr, dk, dv, dw,
                      static_cast<float*>(du), static_cast<float*>(ds0),
                      static_cast<float*>(ck), static_cast<double*>(du_part),
                      static_cast<double*>(vd), static_cast<float*>(av), B, Tn,
                      H, st);
}

// The chunked instance's entry point: the arguments of rwkv6_bwd_launch,
// with the scratch sck and gck [B, nc, H, 64, 64] fp32 (S at each chunk's
// start, G at each chunk's end), xck [B, nc, 2, H, 64, 64] and lck [B, nc,
// 2, H, 64] fp32 (each chunk's products and sums of l, S role then G role)
// and du_part [B, nc, H, 64] fp64 in place of ck and du_part, nc =
// ceil(T / 64).  dtype 1 (bf16) is the training path; dtype 0 (fp32) runs
// the same TF32 products, which miss fp32's 1e-5 (kernels/rwkv6.py routes
// fp32 to the sweep), for checks and timing only; returns
// cudaErrorInvalidValue for anything else.
extern "C" int rwkv6_bwd_chunked_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, const void* dout, const void* dsT, void* dr, void* dk,
    void* dv, void* dw, void* du, void* ds0, void* sck, void* gck, void* xck,
    void* lck, void* du_part, void* vd, void* av, int dtype, int B, int Tn, int H,
    int Kd, int Vd,
    long long rsb, long long rst, long long rsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh, long long wsb,
    long long wst, long long wsh, void* stream) {
  if (B == 0 || H == 0) return 0;
  if ((dtype != 0 && dtype != 1) || Kd != K || Vd != V || B > 65535 || H > 65535 ||
      Tn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{r, k, v, w, Strides{rsb, rst, rsh}, Strides{ksb, kst, ksh},
                   Strides{vsb, vst, vsh}, Strides{wsb, wst, wsh}};
  auto run = dtype == 0 ? chunked::launch<float> : chunked::launch<bf16>;
  return run(o, static_cast<const float*>(u), static_cast<const float*>(s0),
             static_cast<const float*>(dout), static_cast<const float*>(dsT), dr, dk, dv,
             dw, static_cast<float*>(du), static_cast<float*>(ds0),
             static_cast<float*>(sck), static_cast<float*>(gck), static_cast<float*>(xck),
             static_cast<float*>(lck), static_cast<double*>(du_part),
             static_cast<double*>(vd), static_cast<float*>(av), B, Tn, H,
             static_cast<cudaStream_t>(stream));
}
