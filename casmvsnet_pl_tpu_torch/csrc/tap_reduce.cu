// Weighted 4-tap reduce of gathered packed-quad rows, and its VJP, for
// Hopper (sm_90a): the combine of the packed-quad sampler
// (ops/grid_sample.py::grid_sample_quad).
//
// Replaces, on the TPU side:
//   scripts/kernel_tap_reduce.py::_forward (pallas_call at :86, kernel
//   _fwd_kernel), TPU kernel #7, and
//   scripts/kernel_tap_reduce.py::_vjp_bwd (:121, _bwd_kernel), TPU
//   kernel #8.
//
// What it computes, per sample n of N, C channels a tap:
//   forward:   out[n, c]          = sum_q w[n, q] * rows[n, q*C + c]
//   backward:  d rows[n, q*C + c] = w[n, q] * g[n, c],
//              d w[n, q]          = sum_c rows[n, q*C + c] * g[n, c].
// rows and d rows are float32 or bfloat16; w, g, out and d w float32. Every
// sum is taken in float32, the taps in order; d rows is rounded once to the
// rows' dtype. Plain versions: ops/tap_reduce.py::plain_tap_reduce /
// plain_tap_reduce_bwd.
//
// Layout: the TPU kernel takes w as (4, N), tap-major for its lane layout,
// and pads N to its 1024-row tile. Here w is (N, 4), one 16-byte load per
// sample, and N is taken as it is: the grid covers N * C/8 threads and the
// ragged end is masked.
//
// What bounds it on the card: bytes. A sample moves 12C + 16 bytes forward
// (bf16 rows; f32 weights and output) and 20C + 32 backward (rows, weights
// and the f32 gradient read; d rows and d w written), for 8C and 12C
// operations. One thread per (sample, chunk of 8 channels), the chunks of a
// sample on neighbouring lanes, so a warp's 16-byte loads of one tap cover
// whole 32-byte sectors; nothing but the outputs is written. The backward
// writes d rows once and sums d w over the C/8 lanes of a sample with warp
// shuffles: every output element has one writer and there are no atomics,
// so the result is the same from run to run. cp.async/TMA staging is a
// later step.
//
// Numerics: in float32 the forward and d rows equal the plain versions to
// the last bit (every product and sum rounded separately, in its order); d w
// sums its channels in another order than torch's reduction.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 256;
constexpr int kN = 8;  // channels per thread

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    tap_reduce_kernel(const T* __restrict__ rows, const float* __restrict__ w,
                      float* __restrict__ out, int64_t N) {
  constexpr int kChunks = C / kN;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= N * kChunks) return;
  const int64_t n = t / kChunks;
  const int c0 = static_cast<int>(t % kChunks) * kN;
  const float4 wq = __ldg(reinterpret_cast<const float4*>(w) + n);
  const T* row = rows + n * 4 * C + c0;
  float o[kN];
  load_row<T, kN>(row, o);
#pragma unroll
  for (int c = 0; c < kN; ++c) o[c] = __fmul_rn(o[c], wq.x);
  add_tap<T, kN>(row + C, wq.y, o);
  add_tap<T, kN>(row + 2 * C, wq.z, o);
  add_tap<T, kN>(row + 3 * C, wq.w, o);
  store_row<float, kN>(out + n * C + c0, o);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    tap_reduce_bwd_kernel(const T* __restrict__ rows,
                          const float* __restrict__ w,
                          const float* __restrict__ g, T* __restrict__ drows,
                          float* __restrict__ dw, int64_t N) {
  constexpr int kChunks = C / kN;
  // Every lane runs to the end (the d w shuffle needs the whole warp); a
  // lane past the end works on the last chunk and stores nothing. A
  // sample's kChunks lanes are all live or all past the end.
  const int64_t total = N * kChunks;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool live = tid < total;
  const int64_t t = live ? tid : total - 1;
  const int64_t n = t / kChunks;
  const int c0 = static_cast<int>(t % kChunks) * kN;
  const float4 w4 = __ldg(reinterpret_cast<const float4*>(w) + n);
  const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
  float gv[kN];
  load_row<float, kN>(g + n * C + c0, gv);
  const T* row = rows + n * 4 * C + c0;
  T* drow = drows + n * 4 * C + c0;
  float p[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float tap[kN], dr[kN];
    load_row<T, kN>(row + q * C, tap);
    p[q] = __fmul_rn(tap[0], gv[0]);
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      dr[c] = __fmul_rn(gv[c], wq[q]);
      if (c > 0) p[q] = __fadd_rn(p[q], __fmul_rn(tap[c], gv[c]));
    }
#pragma unroll
    for (int off = 1; off < kChunks; off <<= 1) {
      p[q] = __fadd_rn(p[q], __shfl_xor_sync(0xffffffffu, p[q], off));
    }
    if (live) store_row<T, kN>(drow + q * C, dr);
  }
  if (live && c0 == 0) {
    reinterpret_cast<float4*>(dw)[n] = make_float4(p[0], p[1], p[2], p[3]);
  }
}

// Calls f(Type<T>{}, Int<C>{}) for dtype 0 (float32) or 1 (bfloat16) and
// C in {8, 16, 32}; returns f's result, or kUnsupported.
template <typename F>
int dispatch_tap(int dtype, int C, F&& f) {
  const auto by_channels = [&](auto t) {
    switch (C) {
      case 8: return f(t, Int<8>{});
      case 16: return f(t, Int<16>{});
      case 32: return f(t, Int<32>{});
      default: return kUnsupported;
    }
  };
  if (dtype == 0) return by_channels(Type<float>{});
  if (dtype == 1) return by_channels(Type<__nv_bfloat16>{});
  return kUnsupported;
}

// The launch grid of N samples of C channels, or 0 where it is too large.
int64_t blocks_for(int64_t N, int C) {
  const int64_t blocks = (N * (C / kN) + kThreads - 1) / kThreads;
  return blocks > 0x7fffffff ? 0 : blocks;
}

}  // namespace

// rows (N, 4C) of dtype (0: float32, 1: bfloat16); w (N, 4) f32; out (N, C)
// f32. All contiguous and 16-byte aligned, N >= 1. Returns 0, a
// cudaError_t from the launch, or a negative code of sampling.cuh
// (cost_volume_error_string names it).
static int tap_reduce_fwd_typed(const void* rows, const void* w, void* out,
                                int64_t N, int C, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_tap(dtype, C, [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    const int64_t blocks = blocks_for(N, kC);
    if (blocks < 1) return kBadShape;
    tap_reduce_kernel<T, kC><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(static_cast<const T*>(rows),
                                     static_cast<const float*>(w),
                                     static_cast<float*>(out), N);
    return static_cast<int>(cudaGetLastError());
  });
}

// tap_reduce_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int tap_reduce_fwd(const int64_t* args) {
  return cv::call_packed(tap_reduce_fwd_typed, args);
}

// rows and w as tap_reduce_fwd; g (N, C) f32. Writes drows (N, 4C) of the
// rows' dtype and dw (N, 4) f32, every element once. Returns as
// tap_reduce_fwd.
static int tap_reduce_bwd_typed(const void* rows, const void* w, const void* g,
                                void* drows, void* dw, int64_t N, int C,
                                int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_tap(dtype, C, [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    const int64_t blocks = blocks_for(N, kC);
    if (blocks < 1) return kBadShape;
    tap_reduce_bwd_kernel<T, kC><<<static_cast<unsigned>(blocks), kThreads,
                                   0, st>>>(
        static_cast<const T*>(rows), static_cast<const float*>(w),
        static_cast<const float*>(g), static_cast<T*>(drows),
        static_cast<float*>(dw), N);
    return static_cast<int>(cudaGetLastError());
  });
}

// tap_reduce_bwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int tap_reduce_bwd(const int64_t* args) {
  return cv::call_packed(tap_reduce_bwd_typed, args);
}
