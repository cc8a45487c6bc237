// Cost epilogue of the quad configuration for Hopper (sm_90a): the 4-tap
// bilinear reduce of gathered packed-quad rows, then the variance or the
// groupwise correlation over the views, in one pass that writes only the
// finished volume.
//
// Replaces, on the TPU side:
//   scripts/kernel_cost_epilogue.py::variance_epilogue (pallas_call at
//   :197, kernel _var_fwd_kernel), TPU kernel #3, and
//   scripts/kernel_cost_epilogue.py::groupwise_epilogue (:377,
//   _gw_fwd_kernel), TPU kernel #5.
//
// What it computes, per (b, d, pixel n) with S = V-1 source views:
//   o_v[c] = sum_q w_v[q] * rows_v[q*C + c]              (taps in order)
//   variance:  s = ref + sum_v o_v, sq = ref^2 + sum_v o_v^2,
//              out = sq * inv - m*m with m = s * inv, inv = 1/V;
//   groupwise: out[g] = (sum_v sum_{c in g} o_v[c] * ref[c]) * inv,
//              inv = 1/((C/G) * S).
// The tap weights stay float32, as the TPU kernel's _taps keeps them; the
// inverse is multiplied, not divided by, as there. Plain version:
// ops/cost_epilogue.py::plain_variance_epilogue / plain_groupwise_epilogue.
//
// What bounds it on the card: bytes. Each (pixel, depth, view) row of 4C
// features is read once (bf16 at the default config, 1.5 GB of rows over
// the three levels at B=1), with 16 f32 bytes of weights, for ~10 flops per
// row byte-pair; the finished volume is written once. The design reads each
// row with 16-byte vector loads, keeps the taps, the sums and the group
// reductions in f32 registers and writes nothing else: one thread per
// (b, d, pixel, chunk of 8 channels), chunks of a pixel on neighbouring
// lanes, so a warp's loads of one tap cover whole 32-byte sectors. A group
// wider than a chunk (C/G = 16) is summed across its two lanes with a warp
// shuffle. cp.async/TMA staging and several depths per thread are later
// steps.
//
// Numerics: in float32 the variance equals the plain version to the last
// bit (every product and sum rounded separately, in its order); the
// groupwise sums its groups in another order than torch's reduction.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr int kN = 8;  // channels per thread

// G == 1: variance over the S + 1 views. G > 1: groupwise correlation.
template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads)
    cost_epilogue_kernel(const T* __restrict__ ref, const T* __restrict__ rows,
                         const float* __restrict__ ws, T* __restrict__ out,
                         int S, int D, int HW) {
  static_assert(C % G == 0 && C % kN == 0, "bad (C, G)");
  constexpr bool kVariance = G == 1;
  constexpr int kChunks = C / kN;
  constexpr int kPer = C / G;                        // channels per group
  constexpr int kSlots = kPer < kN ? kN / kPer : 1;  // groups in a chunk
  constexpr int kSpan = kPer > kN ? kPer / kN : 1;   // lanes per group

  // Every lane runs to the end (the group shuffle needs the whole warp); a
  // lane past the end works on the last chunk and stores nothing.
  const int64_t total = static_cast<int64_t>(HW) * kChunks;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool live = tid < total;
  const int64_t t = live ? tid : total - 1;
  const int64_t pix = t / kChunks;
  const int c0 = static_cast<int>(t % kChunks) * kN;
  const int64_t b = blockIdx.z;
  const int64_t d = blockIdx.y;

  float r[kN];
  load_row<T, kN>(ref + (b * HW + pix) * C + c0, r);
  float s[kN], sq[kN], acc[kSlots];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    s[c] = r[c];
    sq[c] = __fmul_rn(r[c], r[c]);
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) acc[j] = 0.f;

  for (int v = 0; v < S; ++v) {
    const int64_t n = ((b * S + v) * D + d) * HW + pix;
    const float4 w = __ldg(reinterpret_cast<const float4*>(ws) + n);
    float o[kN];
    reduce_taps<T, C>(rows + n * 4 * C + c0, w, o);
    if constexpr (kVariance) {
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        s[c] = __fadd_rn(s[c], o[c]);
        sq[c] = __fadd_rn(sq[c], __fmul_rn(o[c], o[c]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        constexpr int kLen = kPer < kN ? kPer : kN;
        float p = __fmul_rn(o[j * kLen], r[j * kLen]);
#pragma unroll
        for (int k = 1; k < kLen; ++k) {
          p = __fadd_rn(p, __fmul_rn(o[j * kLen + k], r[j * kLen + k]));
        }
#pragma unroll
        for (int off = 1; off < kSpan; off <<= 1) {
          p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
        }
        acc[j] = __fadd_rn(acc[j], p);
      }
    }
  }
  if (!live) return;

  const int64_t bdp = (b * D + d) * HW + pix;
  if constexpr (kVariance) {
    const float inv = __frcp_rn(static_cast<float>(S + 1));
    float res[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const float m = __fmul_rn(s[c], inv);
      res[c] = __fsub_rn(__fmul_rn(sq[c], inv), __fmul_rn(m, m));
    }
    store_row<T, kN>(out + bdp * C + c0, res);
  } else {
    if (c0 % (kSpan * kN) != 0) return;  // the group's first lane stores
    const float inv = __frcp_rn(static_cast<float>(kPer * S));
    T* dst = out + bdp * G + c0 / kPer;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      dst[j] = from_float<T>(__fmul_rn(acc[j], inv));
    }
  }
}

template <typename T, int C, int G>
int launch(const void* ref, const void* rows, const void* ws, void* out,
           int B, int S, int D, int HW, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(HW) * (C / kN);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || D > 65535 || B > 65535) return kBadShape;
  const dim3 grid(static_cast<unsigned>(blocks), D, B);
  cost_epilogue_kernel<T, C, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(rows),
      static_cast<const float*>(ws), static_cast<T*>(out), S, D, HW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref (B, HW, C) of dtype (0: float32, 1: bfloat16); rows (B, S, D, HW, 4C)
// of the same dtype; ws (B, S, D, HW, 4) f32; out (B, D, HW, C if G == 1
// else G) of the same dtype. All contiguous and 16-byte aligned. Returns 0,
// a cudaError_t from the launch, or a negative code of sampling.cuh
// (cost_volume_error_string names it).
static int cost_epilogue_fwd_typed(const void* ref, const void* rows,
                                   const void* ws, void* out, int B, int S,
                                   int D, int HW, int C, int G, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cv::dispatch(dtype, C, G, [&](auto t, auto c, auto g) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(c)::value, decltype(g)::value>(
        ref, rows, ws, out, B, S, D, HW, st);
  });
}

// cost_epilogue_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int cost_epilogue_fwd(const int64_t* args) {
  return cv::call_packed(cost_epilogue_fwd_typed, args);
}
