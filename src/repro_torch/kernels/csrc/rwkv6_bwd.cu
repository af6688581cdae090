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
// Design: five kernels in one launch, all sums in fp32 but the bonus terms
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
