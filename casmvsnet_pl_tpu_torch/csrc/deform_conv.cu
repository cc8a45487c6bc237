// The modulated deformable 3x3 convolution (DCNv2) of TransMVSNet's ARF
// (models/transmvsnet.py, ops/deform_conv.py), stride 1, padding 1,
// dilation 1, no bias, C -> C channels, forward only, for Hopper (sm_90a);
// its backward is deform_conv_bwd.cu.
//
// Replaces no TPU kernel: the JAX package has no TransMVSNet.
//
// What it computes, for every image n, pixel (h, w) and output channel co:
//   y[n, h, w, co] = sum over taps k = 3 i + j (i, j < 3) and ci < C of
//                    W[co, ci, i, j] * m_k * x~(n, h - 1 + i + dy_k,
//                                                  w - 1 + j + dx_k, ci)
// where om = conv_offset_mask's 27 channels at (n, h, w): dy_k = om[2k],
// dx_k = om[2k + 1] (DCNv2's offset layout, cat(o1, o2) = om[0:18]) and
// m_k = sigmoid(om[18 + k]); x~ is the bilinear sample of x, each of its 4
// taps zero outside the image. x, om and y are NHWC (the NCHW views of
// channels_last tensors), float32 or bfloat16; W is (C, C, 3, 3) of x's
// dtype. Each sample (the taps' weighted sum, times the mask) is formed
// in float32 and the contraction accumulates in float32; each output is
// rounded once to y's dtype. Plain version: ops/deform_conv.py::
// plain_deform_conv.
//
// What bounds it on the card: per pixel 9 C^2 multiply-adds (C = 32: 9216)
// and 9 C bilinear samples against C values in, 27 offset-and-mask values
// in and C out. At the eval shape (5 views at 1152x864, one conv a level,
// bfloat16) the least time is 0.195 ms (perfbench/counts/deform_conv.py):
// bytes bound C = 16 and 32, whose contraction runs on the tensor cores
// (0.044 and 0.017 ms at 3.35 TB/s), and C = 8's operations on the CUDA
// cores bound it (9.0 GFLOP, 0.134 ms at 67 TFLOP/s).
// Two forms:
// - deform_conv_kernel, on the CUDA cores (every C in float32, C = 8 in
//   bfloat16): a thread owns kPix pixels (a block stride apart, so a warp's
//   offset loads and output stores touch neighbouring pixels) and walks the
//   9 taps; for each tap it forms the C masked samples of each pixel in
//   registers (4 16-byte-vector tap loads), then adds their contraction
//   into C accumulators a pixel. The weights, in float32 and reordered
//   [tap][ci][co], sit in shared memory and are read as float4
//   broadcasts, each used kPix times. A tap outside the image reads pixel 0
//   with weight 0, with no branch.
// - deform_conv_kernel_mma, on the tensor cores (bfloat16 at C = 16 and
//   32), described at its definition.
// Measured on the H100 at the eval shape (PERF.md, phase 55), one conv a
// level: 1.636 ms with the CUDA-core form alone and its contraction loop
// unrolled by 4 (the samples then sat in local memory), 1.197 ms unrolled
// fully, 1.015 ms with the tensor-core form at C = 16 and 32 (L2 0.336 ->
// 0.186 ms, L1 0.343 -> 0.314 ms; L0, C = 8, 0.518 ms).
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr int kTaps = 9;
constexpr int kOm = 27;         // offset (18) and mask (9) channels

// pixels a thread, per channel count
template <int C>
struct DcnTune {
  static constexpr int kPix = 2;
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    deform_conv_kernel(const T* __restrict__ x, const T* __restrict__ om,
                       const T* __restrict__ weight, T* __restrict__ out,
                       int64_t total, int H, int W) {
  constexpr int R = DcnTune<C>::kPix;
  __shared__ __align__(16) float ws[kTaps * C * C];  // [k][ci][co]
  for (int i = threadIdx.x; i < kTaps * C * C; i += kThreads) {
    const int co = i % C, ci = (i / C) % C, k = i / (C * C);
    ws[i] = to_float(weight[(co * C + ci) * kTaps + k]);
  }
  __syncthreads();

  const int64_t HW = static_cast<int64_t>(H) * W;
  int64_t pix[R];
  bool live[R];
  int ph[R], pw[R];
  const T* img[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t p = (static_cast<int64_t>(blockIdx.x) * R + r) * kThreads +
                      threadIdx.x;
    live[r] = p < total;
    pix[r] = live[r] ? p : total - 1;  // the tail computes the last pixel
    const int64_t n = pix[r] / HW, q = pix[r] - n * HW;
    ph[r] = static_cast<int>(q / W);
    pw[r] = static_cast<int>(q - static_cast<int64_t>(ph[r]) * W);
    img[r] = x + n * HW * C;
  }
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const int ki = k / 3, kj = k - 3 * (k / 3);
    float s[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* o = om + pix[r] * kOm;
      const float dy = to_float(o[2 * k]), dx = to_float(o[2 * k + 1]);
      const float m = 1.f / (1.f + expf(-to_float(o[18 + k])));
      const float sy = static_cast<float>(ph[r] - 1 + ki) + dy;
      const float sx = static_cast<float>(pw[r] - 1 + kj) + dx;
      const Corners cn = corners_at(sy, sx, H, W);
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float v[C];
        load_row<T, C>(img[r] + static_cast<int64_t>(cn.q[t]) * C, v);
#pragma unroll
        for (int c = 0; c < C; ++c) s[r][c] = fmaf(v[c], cn.w[t], s[r][c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] *= m;
    }
    const float4* wk = reinterpret_cast<const float4*>(ws + k * C * C);
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 w4 = wk[ci * (C / 4) + c4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sv = s[r][ci];
          acc[r][4 * c4] = fmaf(w4.x, sv, acc[r][4 * c4]);
          acc[r][4 * c4 + 1] = fmaf(w4.y, sv, acc[r][4 * c4 + 1]);
          acc[r][4 * c4 + 2] = fmaf(w4.z, sv, acc[r][4 * c4 + 2]);
          acc[r][4 * c4 + 3] = fmaf(w4.w, sv, acc[r][4 * c4 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r]) store_row<T, C>(out + pix[r] * C, acc[r]);
  }
}

// The tensor-core form, for bfloat16 x, offsets and weight at C >= 16: a
// warp owns 16 pixels; for each tap its lanes form the 16 x C masked
// samples (two lanes a pixel, C / 2 channels each) in float32, split each
// into bfloat16 hi + lo (hi + lo equals the sample to ~2^-17 of it), store
// both in the warp's shared tile, and the warp adds W_k hi + W_k lo into
// 16 x C float32 accumulators with mma.sync m16n8k16 (the weights are
// bfloat16 already, so the products are those of the float32 samples to
// that rounding).
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16;    // pixels a warp

template <int C>
__global__ void __launch_bounds__(kMmaWarps * 32)
    deform_conv_kernel_mma(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ om,
                           const __nv_bfloat16* __restrict__ weight,
                           __nv_bfloat16* __restrict__ out, int64_t total,
                           int H, int W) {
  constexpr int kLd = C + 8;      // row stride (bf16): no bank conflicts
  constexpr int kHalf = C / 2;    // channels a lane samples
  // weights [tap][co][ci]; the warps' sample tiles [warp][hi, lo][row][ci]
  __shared__ __align__(16) __nv_bfloat16 ws[kTaps * C * kLd];
  __shared__ __align__(16) __nv_bfloat16 tile[kMmaWarps][2][kMmaRows * kLd];
  for (int i = threadIdx.x; i < kTaps * C * C; i += kMmaWarps * 32) {
    const int ci = i % C, co = (i / C) % C, k = i / (C * C);
    ws[(k * C + co) * kLd + ci] = weight[(co * C + ci) * kTaps + k];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' row and pair
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kMmaWarps + warp) * kMmaRows;
  // the pixel this lane samples, and the channels
  const int64_t p = min(row0 + lane / 2, total - 1);
  const int c0 = (lane % 2) * kHalf;
  const int64_t n = p / HW, q = p - n * HW;
  const int ph = static_cast<int>(q / W);
  const int pw = static_cast<int>(q - static_cast<int64_t>(ph) * W);
  const __nv_bfloat16* img = x + n * HW * C + c0;
  __nv_bfloat16* hi = tile[warp][0] + (lane / 2) * kLd + c0;
  __nv_bfloat16* lo = tile[warp][1] + (lane / 2) * kLd + c0;

  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const int ki = k / 3, kj = k - 3 * (k / 3);
    const __nv_bfloat16* o = om + p * kOm;
    const float dy = to_float(o[2 * k]), dx = to_float(o[2 * k + 1]);
    const float m = 1.f / (1.f + expf(-to_float(o[18 + k])));
    const Corners cn = corners_at(static_cast<float>(ph - 1 + ki) + dy,
                                  static_cast<float>(pw - 1 + kj) + dx, H, W);
    float s[kHalf];
#pragma unroll
    for (int c = 0; c < kHalf; ++c) s[c] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[kHalf];
      load_row<__nv_bfloat16, kHalf>(img + static_cast<int64_t>(cn.q[e]) * C,
                                     v);
#pragma unroll
      for (int c = 0; c < kHalf; ++c) s[c] = fmaf(v[c], cn.w[e], s[c]);
    }
    float h[kHalf], l[kHalf];
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      s[c] *= m;
      h[c] = __bfloat162float(__float2bfloat16(s[c]));
      l[c] = s[c] - h[c];
    }
    __syncwarp();   // the last tap's fragments are read
    store_row<__nv_bfloat16, kHalf>(hi, h);
    store_row<__nv_bfloat16, kHalf>(lo, l);
    __syncwarp();
    const __nv_bfloat16* wk = ws + k * C * kLd;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const __nv_bfloat16* tp = tile[warp][part] + kk * 16 + 2 * t;
        a[part][0] = *reinterpret_cast<const unsigned*>(tp + g * kLd);
        a[part][1] = *reinterpret_cast<const unsigned*>(tp + (g + 8) * kLd);
        a[part][2] = *reinterpret_cast<const unsigned*>(tp + g * kLd + 8);
        a[part][3] =
            *reinterpret_cast<const unsigned*>(tp + (g + 8) * kLd + 8);
      }
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const __nv_bfloat16* wp = wk + (j * 8 + g) * kLd + kk * 16 + 2 * t;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(wp);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(wp + 8);
        mma_bf16(acc[j], a[0], b0, b1);
        mma_bf16(acc[j], a[1], b0, b1);
      }
    }
  }
  // rows g and g + 8 of the warp's 16, columns 8 j + 2 t and + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t r = row0 + g + 8 * half;
    if (r >= total) continue;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16(acc[j][2 * half]);
      v.y = __float2bfloat16(acc[j][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + r * C + j * 8 + 2 * t) = v;
    }
  }
}

template <int C>
int launch_mma(const void* x, const void* om, const void* weight, void* out,
               int64_t total, int H, int W, cudaStream_t st) {
  constexpr int kPerBlock = kMmaWarps * kMmaRows;
  const int64_t blocks = (total + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffff) return kBadShape;
  deform_conv_kernel_mma<C><<<static_cast<unsigned>(blocks), kMmaWarps * 32,
                              0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(om),
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<__nv_bfloat16*>(out), total, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch(const void* x, const void* om, const void* weight, void* out,
           int64_t total, int H, int W, cudaStream_t st) {
  constexpr int kPerBlock = kThreads * DcnTune<C>::kPix;
  const int64_t blocks = (total + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffff) return kBadShape;
  deform_conv_kernel<T, C><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(weight), static_cast<T*>(out), total, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, C), om (N, H, W, 27), weight (C, C, 3, 3) and out (N, H, W,
// C), all of dtype (0: float32, 1: bfloat16) and contiguous, x and out
// 16-byte aligned; C in {8, 16, 32}. float32 runs on the CUDA cores at
// every C, bfloat16 on the CUDA cores at C = 8 and on the tensor cores at
// C = 16 and 32. Returns 0, a cudaError_t from the launch, or a negative
// code of sampling.cuh (cost_volume_error_string names it).
static int deform_conv_fwd_typed(const void* x, const void* om,
                                 const void* weight, void* out, int N, int H,
                                 int W, int C, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(N) * H * W;
  if (dtype == 0) {
    switch (C) {
      case 8: return launch<float, 8>(x, om, weight, out, total, H, W, st);
      case 16: return launch<float, 16>(x, om, weight, out, total, H, W, st);
      case 32: return launch<float, 32>(x, om, weight, out, total, H, W, st);
      default: return kUnsupported;
    }
  }
  if (dtype == 1) {
    switch (C) {
      case 8:
        return launch<__nv_bfloat16, 8>(x, om, weight, out, total, H, W, st);
      case 16: return launch_mma<16>(x, om, weight, out, total, H, W, st);
      case 32: return launch_mma<32>(x, om, weight, out, total, H, W, st);
      default: return kUnsupported;
    }
  }
  return kUnsupported;
}

// deform_conv_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int deform_conv_fwd(const int64_t* args) {
  return cv::call_packed(deform_conv_fwd_typed, args);
}
