// Backward of the quad configuration's cost epilogue (cost_epilogue.cu) for
// Hopper (sm_90a): the gradients with respect to the reference features,
// the gathered quad rows and the tap weights.
//
// Replaces, on the TPU side:
//   scripts/kernel_cost_epilogue.py::_var_vjp_bwd (pallas_call at :224,
//   kernel _var_bwd_kernel), TPU kernel #4, and
//   scripts/kernel_cost_epilogue.py::_gw_vjp_bwd (:404, _gw_bwd_kernel),
//   TPU kernel #6.
//
// What it computes, per (b, d, pixel) with o_v the forward's 4-tap reduce,
// g the incoming gradient and S = V-1 source views:
//   variance:   m = (ref + sum_v o_v) / V, gs = g * (2/V);
//               d ref += gs * (ref - m)     summed over d;
//               do_v = gs * (o_v - m);
//   groupwise:  ge[c] = g[c / (C/G)] / ((C/G) * S);
//               d ref += sum_v ge * o_v     summed over d;
//               do_v = ge * ref;
//   both:       d rows_v[q*C + c] = w_v[q] * do_v[c],
//               d ws_v[q] = sum_c rows_v[q*C + c] * do_v[c].
// Plain version: ops/cost_epilogue.py::plain_variance_epilogue_bwd /
// plain_groupwise_epilogue_bwd.
//
// Layout: one thread per (b, pixel, chunk of 8 channels) that loops over
// the D depths. The TPU kernel walks D innermost in its grid and carries
// d ref in VMEM across it; here the loop over d takes that place and d ref
// stays in f32 registers, written once at the end. d ws needs a sum over
// all C channels of a pixel: the C/8 chunks of a pixel sit on neighbouring
// lanes and add their partial sums with warp shuffles. Every output element
// has exactly one writer and there are no atomics, so the result is the
// same from run to run.
//
// Variance needs m over all views before any do_v is known, so it reduces
// each view's taps twice per depth (once for m, once for the gradients);
// the second read finds the rows the first just brought into L1/L2.
//
// What bounds it on the card: bytes. It reads the rows and writes d rows
// of the same size (bf16 at the default config), plus the f32 weights and
// their gradient; d ref and the incoming gradient are small beside them.
// 16-byte loads and stores throughout; nothing but the outputs is written.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr int kN = 8;  // channels per thread

// The kN channels at row of each of the 4 taps, in f32.
template <typename T, int C>
__device__ __forceinline__ void load_taps(const T* __restrict__ row,
                                          float (&t)[4][kN]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) load_row<T, kN>(row + q * C, t[q]);
}

// o = sum_q w[q] * t[q], taps in order, as cost_epilogue.cu rounds it.
__device__ __forceinline__ void reduce(const float (&t)[4][kN],
                                       const float4 w, float (&o)[kN]) {
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    o[c] = __fmul_rn(t[0][c], w.x);
    o[c] = __fadd_rn(o[c], __fmul_rn(t[1][c], w.y));
    o[c] = __fadd_rn(o[c], __fmul_rn(t[2][c], w.z));
    o[c] = __fadd_rn(o[c], __fmul_rn(t[3][c], w.w));
  }
}

// Writes d rows (w[q] * dv) of this chunk and, from the pixel's first chunk
// (lead), d ws (the sum over the pixel's kChunks lanes of t[q] . dv). Every
// lane takes part in the shuffles; only a live lane stores.
template <typename T, int C>
__device__ __forceinline__ void write_grads(const float (&t)[4][kN],
                                            const float4 w,
                                            const float (&dv)[kN],
                                            T* __restrict__ drow,
                                            float4* __restrict__ dw,
                                            bool live, bool lead) {
  constexpr int kChunks = C / kN;
  const float wq[4] = {w.x, w.y, w.z, w.w};
  float p[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float dr[kN];
    p[q] = __fmul_rn(t[q][0], dv[0]);
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      dr[c] = __fmul_rn(dv[c], wq[q]);
      if (c > 0) p[q] = __fadd_rn(p[q], __fmul_rn(t[q][c], dv[c]));
    }
#pragma unroll
    for (int off = 1; off < kChunks; off <<= 1) {
      p[q] = __fadd_rn(p[q], __shfl_xor_sync(0xffffffffu, p[q], off));
    }
    if (live) store_row<T, kN>(drow + q * C, dr);
  }
  if (live && lead) *dw = make_float4(p[0], p[1], p[2], p[3]);
}

// G == 1: variance. G > 1: groupwise correlation.
template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads)
    cost_epilogue_bwd_kernel(const T* __restrict__ ref,
                             const T* __restrict__ rows,
                             const float* __restrict__ ws,
                             const T* __restrict__ grad,
                             float* __restrict__ dref,
                             T* __restrict__ drows, float* __restrict__ dws,
                             int S, int D, int HW) {
  static_assert(C % G == 0 && C % kN == 0, "bad (C, G)");
  constexpr bool kVariance = G == 1;
  constexpr int kChunks = C / kN;
  constexpr int kPer = C / G;

  // Every lane runs to the end (the d ws shuffle needs the whole warp); a
  // lane past the end works on the last chunk and stores nothing.
  const int64_t total = static_cast<int64_t>(HW) * kChunks;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool live = tid < total;
  const int64_t t = live ? tid : total - 1;
  const int64_t pix = t / kChunks;
  const int c0 = static_cast<int>(t % kChunks) * kN;
  const int64_t b = blockIdx.y;

  float r[kN], dr[kN];
  load_row<T, kN>(ref + (b * HW + pix) * C + c0, r);
#pragma unroll
  for (int c = 0; c < kN; ++c) dr[c] = 0.f;
  const float inv = __frcp_rn(static_cast<float>(S + 1));
  const float scale = __fmul_rn(2.f, inv);
  const float inv_kv = __frcp_rn(static_cast<float>(kPer * S));

  for (int d = 0; d < D; ++d) {
    const int64_t bdp = (b * D + d) * HW + pix;
    float tp[4][kN], o[kN], dv[kN];
    if constexpr (kVariance) {
      float m[kN], gs[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) m[c] = r[c];
      for (int v = 0; v < S; ++v) {
        const int64_t n = ((b * S + v) * D + d) * HW + pix;
        const float4 w = __ldg(reinterpret_cast<const float4*>(ws) + n);
        load_taps<T, C>(rows + n * 4 * C + c0, tp);
        reduce(tp, w, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) m[c] = __fadd_rn(m[c], o[c]);
      }
      load_row<T, kN>(grad + bdp * C + c0, gs);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        m[c] = __fmul_rn(m[c], inv);
        gs[c] = __fmul_rn(gs[c], scale);
        dr[c] = __fadd_rn(dr[c], __fmul_rn(gs[c], __fsub_rn(r[c], m[c])));
      }
      for (int v = 0; v < S; ++v) {
        const int64_t n = ((b * S + v) * D + d) * HW + pix;
        const float4 w = __ldg(reinterpret_cast<const float4*>(ws) + n);
        load_taps<T, C>(rows + n * 4 * C + c0, tp);
        reduce(tp, w, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          dv[c] = __fmul_rn(gs[c], __fsub_rn(o[c], m[c]));
        }
        write_grads<T, C>(tp, w, dv, drows + n * 4 * C + c0,
                          reinterpret_cast<float4*>(dws) + n, live, c0 == 0);
      }
    } else {
      float ge[kN], so[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        ge[c] = __fmul_rn(to_float(grad[bdp * G + (c0 + c) / kPer]), inv_kv);
        dv[c] = __fmul_rn(ge[c], r[c]);
        so[c] = 0.f;
      }
      for (int v = 0; v < S; ++v) {
        const int64_t n = ((b * S + v) * D + d) * HW + pix;
        const float4 w = __ldg(reinterpret_cast<const float4*>(ws) + n);
        load_taps<T, C>(rows + n * 4 * C + c0, tp);
        reduce(tp, w, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          so[c] = __fadd_rn(so[c], __fmul_rn(ge[c], o[c]));
        }
        write_grads<T, C>(tp, w, dv, drows + n * 4 * C + c0,
                          reinterpret_cast<float4*>(dws) + n, live, c0 == 0);
      }
#pragma unroll
      for (int c = 0; c < kN; ++c) dr[c] = __fadd_rn(dr[c], so[c]);
    }
  }
  if (live) store_row<float, kN>(dref + (b * HW + pix) * C + c0, dr);
}

template <typename T, int C, int G>
int launch(const void* ref, const void* rows, const void* ws,
           const void* grad, void* dref, void* drows, void* dws, int B,
           int S, int D, int HW, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(HW) * (C / kN);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || B > 65535) return kBadShape;
  const dim3 grid(static_cast<unsigned>(blocks), B);
  cost_epilogue_bwd_kernel<T, C, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(rows),
      static_cast<const float*>(ws), static_cast<const T*>(grad),
      static_cast<float*>(dref), static_cast<T*>(drows),
      static_cast<float*>(dws), S, D, HW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref (B, HW, C) of dtype (0: float32, 1: bfloat16); rows (B, S, D, HW, 4C)
// of the same dtype; ws (B, S, D, HW, 4) f32; grad (B, D, HW, C if G == 1
// else G) of the same dtype. Writes dref (B, HW, C) f32, drows (B, S, D,
// HW, 4C) of the dtype and dws (B, S, D, HW, 4) f32, every element once.
// All contiguous and 16-byte aligned. Returns 0, a cudaError_t from the
// launch, or a negative code of sampling.cuh (cost_volume_error_string
// names it).
static int cost_epilogue_bwd_typed(const void* ref, const void* rows,
                                   const void* ws, const void* grad, void* dref,
                                   void* drows, void* dws, int B, int S, int D,
                                   int HW, int C, int G, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cv::dispatch(dtype, C, G, [&](auto t, auto c, auto g) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(c)::value, decltype(g)::value>(
        ref, rows, ws, grad, dref, drows, dws, B, S, D, HW, st);
  });
}

// cost_epilogue_bwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int cost_epilogue_bwd(const int64_t* args) {
  return cv::call_packed(cost_epilogue_bwd_typed, args);
}
