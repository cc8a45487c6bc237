// Variance-epilogue probes for Hopper (sm_90a): TPU kernel #3's function
// (the 4-tap reduce of gathered packed-quad rows, then the variance over
// the views) in the two shapes that the TPU probes swept.
//
// Replaces, on the TPU side:
//   scripts/probe_epi2.py::variance_dblk (pallas_call at :69, body
//   dblk_kernel at :39), TPU kernel #9: #3 with Dblk depths per grid step,
//   swept over (Dblk, T) in {(4, 1024), (8, 1024), (8, 2048), (D, 2048)};
//   scripts/probe_epi3.py::make_var.<fn> (pallas_call at :62, body
//   var_kernel at :35), TPU kernel #10: #3 with V = 3 written out, swept
//   over the tile T in {1024, 4096, 8192, 16384}, a VMEM limit and the
//   grid's dimension semantics.
//
// What both compute, per (b, d, pixel n) with S source views:
//   o_v[c] = sum_q w_v[q] * rows_v[q*C + c]               (taps in order)
//   s = ref + sum_v o_v, sq = ref^2 + sum_v o_v^2,
//   out = sq * inv - m*m with m = s * inv, inv = 1/(S+1).
// Plain version: ops/cost_epilogue.py::plain_variance_epilogue, through
// probes/epi2.py and probes/epi3.py.
//
// The design is #3's (cost_epilogue.cu): one thread per (b, pixel, chunk of
// 8 channels), 16-byte row loads, f32 taps and sums with every product and
// sum rounded separately in #3's order, so that f32 equals the plain
// version to the last bit. What bounds it is bytes: rows and weights are
// read once; only ref could be shared across depths, and it is under 0.5 %
// of the bytes at the probes' shapes.
//   #9 variance_dblk: a thread also walks dblk consecutive depths (dblk in
//      {1, 4, 8, D}, the counterpart of Dblk) and reads its ref chunk once
//      for all of them; blocks of 128 threads.
//   #10 variance_v3: S = 2 at compile time (the views' loop unrolled, as
//      var_kernel writes it out) and kThreads threads per block in {64,
//      128, 256, 512, 1024}, the counterpart of T. The VMEM limit and the
//      dimension semantics have no counterpart on the card: blocks run in
//      parallel in no order, and a block has no scoped memory to size.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kN = 8;  // channels per thread
constexpr int kDblkThreads = 128;

// The variance at (b, d) for the chunk c0 of pixel pix, stored to out.
template <typename T, int C, int S>
__device__ __forceinline__ void variance_at(
    const float (&r)[kN], const float (&r2)[kN], const T* __restrict__ rows,
    const float* __restrict__ ws, T* __restrict__ out, int64_t b, int64_t d,
    int64_t pix, int c0, int s_views, int D, int HW) {
  float s[kN], sq[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    s[c] = r[c];
    sq[c] = r2[c];
  }
  const int views = S > 0 ? S : s_views;
#pragma unroll
  for (int v = 0; v < views; ++v) {
    const int64_t n = ((b * views + v) * D + d) * HW + pix;
    const float4 w = __ldg(reinterpret_cast<const float4*>(ws) + n);
    float o[kN];
    reduce_taps<T, C>(rows + n * 4 * C + c0, w, o);
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      s[c] = __fadd_rn(s[c], o[c]);
      sq[c] = __fadd_rn(sq[c], __fmul_rn(o[c], o[c]));
    }
  }
  const float inv = __frcp_rn(static_cast<float>(views + 1));
  float res[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const float m = __fmul_rn(s[c], inv);
    res[c] = __fsub_rn(__fmul_rn(sq[c], inv), __fmul_rn(m, m));
  }
  store_row<T, kN>(out + ((b * D + d) * HW + pix) * C + c0, res);
}

// Loads the chunk c0 of pixel pix's reference features and their squares.
template <typename T, int C>
__device__ __forceinline__ void load_ref(const T* __restrict__ ref, int64_t b,
                                         int64_t pix, int c0, int HW,
                                         float (&r)[kN], float (&r2)[kN]) {
  load_row<T, kN>(ref + (b * HW + pix) * C + c0, r);
#pragma unroll
  for (int c = 0; c < kN; ++c) r2[c] = __fmul_rn(r[c], r[c]);
}

// #9: grid (pixel chunks / 128, ceil(D / dblk), B).
template <typename T, int C>
__global__ void __launch_bounds__(kDblkThreads)
    variance_dblk_kernel(const T* __restrict__ ref, const T* __restrict__ rows,
                         const float* __restrict__ ws, T* __restrict__ out,
                         int S, int D, int HW, int dblk) {
  constexpr int kChunks = C / kN;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDblkThreads +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(HW) * kChunks) return;
  const int64_t pix = t / kChunks;
  const int c0 = static_cast<int>(t % kChunks) * kN;
  const int64_t b = blockIdx.z;
  const int d0 = blockIdx.y * dblk;
  const int d1 = min(d0 + dblk, D);
  float r[kN], r2[kN];
  load_ref<T, C>(ref, b, pix, c0, HW, r, r2);
  for (int d = d0; d < d1; ++d) {
    variance_at<T, C, 0>(r, r2, rows, ws, out, b, d, pix, c0, S, D, HW);
  }
}

// #10: grid (pixel chunks / kThreads, D, B), two source views.
template <typename T, int C, int kThreads>
__global__ void __launch_bounds__(kThreads)
    variance_v3_kernel(const T* __restrict__ ref, const T* __restrict__ rows,
                       const float* __restrict__ ws, T* __restrict__ out, int D,
                       int HW) {
  constexpr int kChunks = C / kN;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(HW) * kChunks) return;
  const int64_t pix = t / kChunks;
  const int c0 = static_cast<int>(t % kChunks) * kN;
  float r[kN], r2[kN];
  load_ref<T, C>(ref, blockIdx.z, pix, c0, HW, r, r2);
  variance_at<T, C, 2>(r, r2, rows, ws, out, blockIdx.z, blockIdx.y, pix, c0,
                       2, D, HW);
}

int pixel_blocks(int HW, int C, int threads, unsigned* blocks) {
  const int64_t n = static_cast<int64_t>(HW) * (C / kN);
  const int64_t b = (n + threads - 1) / threads;
  if (b > 0x7fffffff) return kBadShape;
  *blocks = static_cast<unsigned>(b);
  return 0;
}

template <typename T, int C, int kThreads>
int launch_v3(const void* ref, const void* rows, const void* ws, void* out,
              int B, int D, int HW, cudaStream_t stream) {
  unsigned blocks = 0;
  if (const int err = pixel_blocks(HW, C, kThreads, &blocks)) return err;
  variance_v3_kernel<T, C, kThreads><<<dim3(blocks, D, B), kThreads, 0,
                                       stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(rows),
      static_cast<const float*>(ws), static_cast<T*>(out), D, HW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref (B, HW, C) of dtype (0: float32, 1: bfloat16); rows (B, S, D, HW, 4C)
// of the same dtype; ws (B, S, D, HW, 4) f32; out (B, D, HW, C) of the same
// dtype. All contiguous and 16-byte aligned; C in {8, 16, 32}; 1 <= dblk.
// Returns 0, a cudaError_t from the launch, or a negative code of
// sampling.cuh (cost_volume_error_string names it).
static int variance_dblk_fwd_typed(const void* ref, const void* rows,
                                   const void* ws, void* out, int B, int S,
                                   int D, int HW, int C, int dblk, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dblk < 1) return kUnsupported;
  const int d_blocks = (D + dblk - 1) / dblk;
  if (d_blocks > 65535 || B > 65535) return kBadShape;
  return cv::dispatch(dtype, C, 1, [&](auto t, auto c, auto) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    unsigned blocks = 0;
    if (const int err = pixel_blocks(HW, kC, kDblkThreads, &blocks)) {
      return err;
    }
    variance_dblk_kernel<T, kC><<<dim3(blocks, d_blocks, B), kDblkThreads, 0,
                                  st>>>(
        static_cast<const T*>(ref), static_cast<const T*>(rows),
        static_cast<const float*>(ws), static_cast<T*>(out), S, D, HW, dblk);
    return static_cast<int>(cudaGetLastError());
  });
}

// variance_dblk_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int variance_dblk_fwd(const int64_t* args) {
  return cv::call_packed(variance_dblk_fwd_typed, args);
}

// As variance_dblk_fwd with S = 2 source views; threads per block in {64,
// 128, 256, 512, 1024}.
static int variance_v3_fwd_typed(const void* ref, const void* rows,
                                 const void* ws, void* out, int B, int D, int HW,
                                 int C, int threads, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 65535 || B > 65535) return kBadShape;
  return cv::dispatch(dtype, C, 1, [&](auto t, auto c, auto) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value;
    switch (threads) {
      case 64: return launch_v3<T, kC, 64>(ref, rows, ws, out, B, D, HW, st);
      case 128: return launch_v3<T, kC, 128>(ref, rows, ws, out, B, D, HW, st);
      case 256: return launch_v3<T, kC, 256>(ref, rows, ws, out, B, D, HW, st);
      case 512: return launch_v3<T, kC, 512>(ref, rows, ws, out, B, D, HW, st);
      case 1024:
        return launch_v3<T, kC, 1024>(ref, rows, ws, out, B, D, HW, st);
      default: return kUnsupported;
    }
  });
}

// variance_v3_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int variance_v3_fwd(const int64_t* args) {
  return cv::call_packed(variance_v3_fwd_typed, args);
}
