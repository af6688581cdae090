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
// apart from the bonus scalar below.
//
// Design.  The TPU kernel walks T as a sequential grid axis with the [K, V]
// state resident in VMEM, one (batch, head) per grid row.  Hopper blocks
// carry nothing between them, so here each block owns one (batch, head,
// 16-column slice of V) and loops over all of T itself, its slice of the
// state in registers from the first step to the last.  Columns of the state
// are independent (S[:, v] reads only v_t[v]), so splitting V gives 4x the
// blocks of one per (batch, head): 512 at the serve shape B 4, H 32.  Eight
// threads share a column, each holding 8 of its 64 rows (rows 4g..4g+3 and
// 32+4g..32+4g+3, so the float4 reads of a step row hit distinct banks);
// out_t[v] is their partial sums reduced with three warp shuffles.  The
// bonus term r_t . diag(u) k_t^T v_t = v_t (sum_k r u k) is one scalar per
// step, computed once per staged step and shared by every column.  It is
// summed in fp64 and rounded once: at t = 0 (zero state) it alone sets the
// output row, and it can cancel (terms of 0.25 summing to 1e-3 occur on a
// model's real operands), where an fp32 sum carries a relative error of
// 1e-3.  Everything else is fp32.
//
// Tiles of TS steps of r, k, w and the block's v columns are staged in
// shared memory as fp32 before the sequential loop runs over them, so the
// loop never waits on device memory; the decay exp(-exp(w)) is computed
// once per staged element.  The loop is bounded by T: a ragged last tile
// runs only its real steps, so no padded step ever touches the state.
//
// Bound on an H100 at the serve path's prefill shape (bf16, B 4, T 2048,
// H 32, K = V = 64): 134.2 MB of inputs, 67.1 MB of output and 2.1 MB of
// final state are 203.4 MB, 0.0607 ms at 3.35 TB/s.  The sequential form
// does about 7 K V flops per (b, t, h), 7.5 GFLOP, 0.112 ms on 67 TFLOP/s
// of fp32 CUDA cores; the chunked form on tensor cores would do the same
// work in matrix products, so the bytes are the bound to reach.  This
// version stages without overlap (no cp.async or TMA ring) and runs the
// sequential form; the chunked tensor-core schedule is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 64;            // state rows (head size of k, r, w)
constexpr int V = 64;            // state columns (head size of v)
constexpr int G = 8;             // threads per state column
constexpr int VC = 16;           // state columns per block
constexpr int THREADS = VC * G;  // 128
constexpr int TS = 32;           // steps staged per tile

struct Strides {
  long long b, t, h;  // elements between batches, steps, heads
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ sT, int Tn, int H,
            Strides rs, Strides ks, Strides vs, Strides ws) {
  __shared__ __align__(16) float r_s[TS][K];
  __shared__ __align__(16) float k_s[TS][K];
  __shared__ __align__(16) float d_s[TS][K];  // exp(-exp(w))
  __shared__ float v_s[TS][VC];
  __shared__ float o_s[TS][VC];
  __shared__ float a_s[TS];                   // sum_k r u k per step
  __shared__ float u_s[K];

  const int tid = threadIdx.x;
  const int col = tid / G;                    // column within the block
  const int g = tid % G;                      // which 8 rows of it
  const int v0 = blockIdx.x * VC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int vcol = v0 + col;

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h + v0;
  const T* wb = w + b * ws.b + h * ws.h;
  const long long bh = static_cast<long long>(b) * H + h;

  for (int i = tid; i < K; i += THREADS) u_s[i] = u[h * K + i];

  // this thread's rows of column vcol: 4g + j and 32 + 4g + j, j < 4
  float S[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = (j < 4 ? 4 * g + j : 32 + 4 * g + j - 4);
    S[j] = s0 ? s0[(bh * K + row) * V + vcol] : 0.f;
  }

  const long long ostep = static_cast<long long>(H) * V;
  float* ob = out + static_cast<long long>(b) * Tn * ostep + h * V + v0;

  for (int t0 = 0; t0 < Tn; t0 += TS) {
    const int n = min(TS, Tn - t0);
    // ---- stage n steps: r, k, decay for all K rows; v for our columns
    for (int i = tid; i < n * K; i += THREADS) {
      const int s = i / K, c = i % K;
      const long long tt = t0 + s;
      r_s[s][c] = to_f32(rb[tt * rs.t + c]);
      k_s[s][c] = to_f32(kb[tt * ks.t + c]);
      d_s[s][c] = expf(-expf(to_f32(wb[tt * ws.t + c])));
    }
    for (int i = tid; i < n * VC; i += THREADS) {
      const int s = i / VC, c = i % VC;
      v_s[s][c] = to_f32(vb[(t0 + s) * vs.t + c]);
    }
    __syncthreads();
    // ---- the bonus scalar of each staged step, summed in fp64: one warp
    // per step
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int s = warp; s < n; s += THREADS / 32) {
        double p = static_cast<double>(r_s[s][lane]) * u_s[lane] * k_s[s][lane] +
                   static_cast<double>(r_s[s][lane + 32]) * u_s[lane + 32] *
                       k_s[s][lane + 32];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) a_s[s] = static_cast<float>(p);
      }
    }
    __syncthreads();
    // ---- the recurrence over the staged steps, in order
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float4 r0 = *reinterpret_cast<const float4*>(&r_s[s][4 * g]);
      const float4 r1 = *reinterpret_cast<const float4*>(&r_s[s][32 + 4 * g]);
      const float4 k0 = *reinterpret_cast<const float4*>(&k_s[s][4 * g]);
      const float4 k1 = *reinterpret_cast<const float4*>(&k_s[s][32 + 4 * g]);
      const float4 d0 = *reinterpret_cast<const float4*>(&d_s[s][4 * g]);
      const float4 d1 = *reinterpret_cast<const float4*>(&d_s[s][32 + 4 * g]);
      const float rr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float vv = v_s[s][col];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc = fmaf(rr[j], S[j], acc);           // reads S_{t-1}
        S[j] = fmaf(S[j], dd[j], kk[j] * vv);   // then S_t
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (g == 0) o_s[s][col] = fmaf(vv, a_s[s], acc);
    }
    __syncthreads();
    // ---- write the tile's outputs: VC contiguous floats per step
    for (int i = tid; i < n * VC; i += THREADS) {
      const int s = i / VC, c = i % VC;
      ob[(t0 + s) * ostep + c] = o_s[s][c];
    }
    // the next tile's staging writes r_s..v_s only, which every thread has
    // finished reading (the barrier above); o_s is next written after two
    // more barriers
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = (j < 4 ? 4 * g + j : 32 + 4 * g + j - 4);
    sT[(bh * K + row) * V + vcol] = S[j];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sT, int B, int Tn,
           int H, const Strides& rs, const Strides& ks, const Strides& vs,
           const Strides& ws, cudaStream_t stream) {
  const dim3 grid(V / VC, H, B);
  wkv_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), Tn, H, rs, ks, vs,
      ws);
  return static_cast<int>(cudaGetLastError());
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
