// CostRegNet's input block at one input channel: the 3x3x3 convolution of
// 1 channel to 8 with zero padding 1 and no bias, then BatchNorm in eval
// mode, then leaky ReLU 0.01 (models/cost_reg.py, `conv0`, whose input is
// TransMVSNet's one-group correlation volume), for Hopper (sm_90a).
//
// Replaces no TPU kernel: XLA runs this block on the TPU. On the card cuDNN
// sends a convolution with one input channel to a generic implicit GEMM
// (implicit_convolveNd_sgemm) that leaves the tensor cores idle and took
// 3.4 ms of a 40 ms TransMVSNet eval map at 1152x864x5; BatchNorm and the
// activation were two more passes over its 8-channel output.
//
// What it computes, for every b, d, h, w and output channel n < 8:
//   conv = sum over kd, kh, kw < 3 of
//          w[n, 0, kd, kh, kw] * x[b, d+kd-1, h+kh-1, w+kw-1]
//   scale = gamma[n] * rsqrt(var[n] + eps), shift = beta[n] - mean[n] * scale
//   y = conv * scale + shift, out = y > 0 ? y : 0.01 y
// with zeros outside the volume. BatchNorm is computed from the module's own
// tensors (gamma, beta, running mean and var) at every call, in float32. x
// is (B, D, H, W) contiguous (the (B, 1, D, H, W) volume), float32 or
// bfloat16; out is (B, 8, D, H, W) in channels_last_3d, so a voxel's 8
// channels lie together, in x's dtype; the weight (8, 1, 3, 3, 3) and the
// BatchNorm tensors are of one dtype, float32 or bfloat16. Sums are float32
// and each output is rounded once to out's dtype. Plain version:
// ops/in_conv.py::plain_in_conv.
//
// What bounds it on the card: bytes, and mostly the writes. A bf16 voxel
// reads 2 bytes and writes 16 and takes 216 multiply-adds: at eval's three
// levels 18.9 M voxels, 340.4 MB (0.102 ms at 3.35 TB/s) and 8.17 GFLOP
// (0.122 ms in float32 on the CUDA cores at 67 TFLOP/s, 0.008 ms on the
// tensor cores). So the products run on the tensor cores, and the design
// spends the rest of its instructions on moving bytes:
// - the products are a GEMM per tile of 16 voxels along W: [16 voxels x 36
//   taps] . [36 x 8 channels] with bf16 mma.sync (m16n8k16 twice, then
//   m16n8k8), the 8 channels exactly mma's N. The 27 taps go in as 18 pairs
//   (kw 0 and 1, then kw 2 and a zero) of 9 rows (kd, kh), so that each pair
//   of an A fragment is one 32-bit word of shared memory;
// - the block's input tile with its halo (10 x 10 x 34 values for 8 x 8 x
//   32 outputs) sits in shared memory as such words: word c of a row holds
//   x at columns c and c + 1 (c counted from the halo), built once by the
//   warp that loads the row (one 2-byte load a lane, a shuffle), every
//   load of a warp's 13 rows in flight at once; the row and plane pitches
//   (16 words modulo 32 banks) keep the four pairs a lane group reads at
//   once on distinct banks;
// - the weights' B fragments (5 words a lane) and the lane's two channels'
//   scale and shift stay in registers for the block's 128 tiles;
// - each lane's sums are 2 channels of 2 voxels; they go out as 4-byte
//   stores (8-byte in float32), so a warp's store covers the 16-byte slots
//   of 8 consecutive voxels: 128 contiguous bytes, whole sectors;
// - float32 values go in as bf16 hi + lo (x from a second tile of words, the
//   weights as a second set of fragments; lo lo products dropped), each
//   product within ~2^-16 of its terms; bf16 ones go in as they are, and
//   their products are exact.
// Measured on the H100 at eval's three levels (PERF.md, phase 57): 0.198-
// 0.210 ms against a bound of 0.102 (48-51 %) and cuDNN's conv, BatchNorm
// and leaky ReLU at 4.93-4.97 ms; loading a warp's rows one after another
// took 0.251 ms. 55 registers and 19.8 KB of shared memory a block (bf16).
#include <cstring>

#include "sampling.cuh"

namespace {

using namespace cv;
using bf16 = __nv_bfloat16;

constexpr int kOut = 8;              // output channels (mma's N)
constexpr int kTaps = 27;
constexpr int kTileW = 32;           // outputs along W a block: a warp's lanes
constexpr int kTileH = 8;
constexpr int kTileD = 8;            // one output plane a warp
constexpr int kWarps = kTileD;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = (kTileD + 2) * (kTileH + 2);   // input rows a block
constexpr int kPitch = 48;           // words a row (34 used), 16 mod 32
constexpr int kPlane = 496;          // words a plane (480 used), 16 mod 32
constexpr int kWords = (kTileD + 2) * kPlane;
constexpr float kSlope = 0.01f;

template <typename T>
constexpr bool kF32 = std::is_same_v<T, float>;

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The bits of x's bf16 rounding (hi) and of the rest's (lo; 0 for bf16).
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  const bf16 h = __float2bfloat16_rn(v);
  hi = __bfloat16_as_ushort(h);
  lo = bf16_bits(v - __bfloat162float(h));
}
__device__ __forceinline__ void split(bf16 v, unsigned& hi, unsigned& lo) {
  hi = __bfloat16_as_ushort(v);
  lo = 0u;
}

template <typename P>
__device__ __forceinline__ float param(const void* p, int i) {
  return to_float(static_cast<const P*>(p)[i]);
}

__device__ __forceinline__ void mma_k8(float (&c)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The products of one tile: A's pairs q0..q4 of rows g and g + 8 (a[q][0],
// a[q][1]) against the weights' pairs (b[q]).
__device__ __forceinline__ void tile_mma(float (&acc)[4],
                                         const unsigned (&a)[5][2],
                                         const unsigned (&b)[5]) {
  const unsigned a0[4] = {a[0][0], a[0][1], a[1][0], a[1][1]};
  const unsigned a1[4] = {a[2][0], a[2][1], a[3][0], a[3][1]};
  mma_bf16(acc, a0, b[0], b[1]);
  mma_bf16(acc, a1, b[2], b[3]);
  mma_k8(acc, a[4][0], a[4][1], b[4]);
}

// The input rows of the block's tile into shared memory as pair words (hi,
// and lo for float32): word c of a row holds x at halo columns c and c + 1
// (only the low half of words 32 and 33 is read). A warp a row, a lane a
// column; zeros outside the volume. A warp's loads of all its rows go out
// before the first is used.
template <typename T>
__device__ __forceinline__ void fill(const T* __restrict__ xb,
                                     unsigned* __restrict__ hi_s,
                                     unsigned* __restrict__ lo_s, int d0,
                                     int h0, int w0, int D, int H, int W,
                                     int warp, int lane) {
  constexpr int kSteps = (kRows + kWarps - 1) / kWarps;
  unsigned vh[kSteps], vl[kSteps], eh[kSteps], el[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int row = warp + kWarps * i;
    const int ld = row / (kTileH + 2), lh = row - ld * (kTileH + 2);
    const int d = d0 + ld - 1, h = h0 + lh - 1;
    vh[i] = vl[i] = eh[i] = el[i] = 0u;
    if (row < kRows && d >= 0 && d < D && h >= 0 && h < H) {
      const T* xr = xb + (static_cast<int64_t>(d) * H + h) * W;
      const int c = w0 - 1 + lane, e = w0 + 31 + lane;
      if (c >= 0 && c < W) split(xr[c], vh[i], vl[i]);
      if (lane < 2 && e < W) split(xr[e], eh[i], el[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int row = warp + kWarps * i;
    if (row >= kRows) break;
    const int ld = row / (kTileH + 2), lh = row - ld * (kTileH + 2);
    const int at = ld * kPlane + lh * kPitch;
    unsigned nh = __shfl_down_sync(0xffffffffu, vh[i], 1);
    const unsigned eh0 = __shfl_sync(0xffffffffu, eh[i], 0);
    if (lane == 31) nh = eh0;
    hi_s[at + lane] = vh[i] | (nh << 16);
    if (lane < 2) hi_s[at + 32 + lane] = eh[i];
    if constexpr (kF32<T>) {
      unsigned nl = __shfl_down_sync(0xffffffffu, vl[i], 1);
      const unsigned el0 = __shfl_sync(0xffffffffu, el[i], 0);
      if (lane == 31) nl = el0;
      lo_s[at + lane] = vl[i] | (nl << 16);
      if (lane < 2) lo_s[at + 32 + lane] = el[i];
    }
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    in_conv_kernel(const T* __restrict__ x, const void* __restrict__ weight,
                   const void* __restrict__ gamma,
                   const void* __restrict__ beta,
                   const void* __restrict__ mean,
                   const void* __restrict__ var, float eps,
                   T* __restrict__ out, int D, int H, int W, int chunks) {
  __shared__ unsigned hi_s[kWords];
  __shared__ unsigned lo_s[kF32<T> ? kWords : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = blockIdx.x * kTileW, h0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / chunks;
  const int d0 = (blockIdx.z - b * chunks) * kTileD;
  const int64_t plane = static_cast<int64_t>(H) * W;
  fill<T>(x + static_cast<int64_t>(b) * D * plane, hi_s, lo_s, d0, h0, w0, D,
          H, W, warp, lane);

  // The lane's pairs q = 0..4 are t + 4 q (q = 4 only for t < 2; lanes
  // t >= 2 read pair t there, on other banks than pair 16 + t, and zero
  // it): in shared memory at off[q] from the tile's first word, row g; in
  // the weights, the B fragments of output channel g. Pairs of kw 2 (t odd)
  // keep the low half of their word.
  int off[5];
  unsigned bh[5], bl[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int p = q < 4 || t < 2 ? t + 4 * q : t;
    const int r = p >> 1, s = p & 1, kd = r / 3, kh = r - 3 * kd;
    off[q] = kd * kPlane + kh * kPitch + 2 * s + g;
    const int tap = g * kTaps + 3 * r + 2 * s;
    const float w_lo = param<P>(weight, tap);
    const float w_hi = s ? 0.f : param<P>(weight, tap + 1);
    unsigned h0b, l0b, h1b, l1b;
    split(w_lo, h0b, l0b);
    split(w_hi, h1b, l1b);
    const bool live = q < 4 || t < 2;
    bh[q] = live ? h0b | (h1b << 16) : 0u;
    bl[q] = live && kF32<P> ? l0b | (l1b << 16) : 0u;
  }
  const unsigned keep = t & 1 ? 0xffffu : 0xffffffffu;
  const unsigned keep4 = t < 2 ? keep : 0u;
  float scale[2], shift[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = 2 * t + j;
    scale[j] = param<P>(gamma, n) * rsqrtf(param<P>(var, n) + eps);
    shift[j] = param<P>(beta, n) - param<P>(mean, n) * scale[j];
  }
  __syncthreads();

  const int d = d0 + warp;
  if (d >= D) return;
  T* ob = out + (static_cast<int64_t>(b) * D + d) * plane * kOut + 2 * t;
  for (int lh = 0; lh < kTileH; ++lh) {
    const int h = h0 + lh;
    if (h >= H) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int base = warp * kPlane + lh * kPitch + 16 * half;
      unsigned ah[5][2], al[5][2];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const unsigned k = q < 4 ? keep : keep4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ah[q][r] = hi_s[base + off[q] + 8 * r] & k;
          al[q][r] = kF32<T> ? lo_s[base + off[q] + 8 * r] & k : 0u;
        }
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      tile_mma(acc, ah, bh);
      if constexpr (kF32<T>) tile_mma(acc, al, bh);
      if constexpr (kF32<P>) tile_mma(acc, ah, bl);
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // voxels g and g + 8
        const int w = w0 + 16 * half + g + 8 * r;
        if (w >= W) continue;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = fmaf(acc[2 * r + j], scale[j], shift[j]);
          y[j] = v > 0.f ? v : v * kSlope;
        }
        T* o = ob + (static_cast<int64_t>(h) * W + w) * kOut;
        if constexpr (kF32<T>) {
          *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
  }
}

template <typename T, typename P>
int launch(const void* x, const void* weight, const void* gamma,
           const void* beta, const void* mean, const void* var, float eps,
           void* out, int B, int D, int H, int W, cudaStream_t st) {
  const int64_t gx = (W + kTileW - 1) / kTileW;
  const int64_t gy = (H + kTileH - 1) / kTileH;
  const int64_t chunks = (D + kTileD - 1) / kTileD;
  const int64_t gz = B * chunks;
  if (gx > 0x7fffffff || gy > 65535 || gz > 65535) return kBadShape;
  in_conv_kernel<T, P><<<dim3(static_cast<unsigned>(gx),
                              static_cast<unsigned>(gy),
                              static_cast<unsigned>(gz)),
                         kThreads, 0, st>>>(
      static_cast<const T*>(x), weight, gamma, beta, mean, var, eps,
      static_cast<T*>(out), D, H, W, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int pdtype, const void* x, const void* weight, const void* gamma,
             const void* beta, const void* mean, const void* var, float eps,
             void* out, int B, int D, int H, int W, cudaStream_t st) {
  if (pdtype == 0) {
    return launch<T, float>(x, weight, gamma, beta, mean, var, eps, out, B,
                            D, H, W, st);
  }
  if (pdtype == 1) {
    return launch<T, bf16>(x, weight, gamma, beta, mean, var, eps, out, B, D,
                           H, W, st);
  }
  return kUnsupported;
}

}  // namespace

// x (B, D, H, W) contiguous, of dtype (0: float32, 1: bfloat16); weight
// (8, 1, 3, 3, 3), gamma, beta, mean and var (8,) contiguous, of pdtype;
// eps_bits the float32 eps's bits; out (B, 8, D, H, W) in channels_last_3d,
// of dtype, 8-byte aligned. Returns 0, a cudaError_t from the launch, or a
// negative code of sampling.cuh (cost_volume_error_string names it).
static int in_conv_fwd_typed(const void* x, const void* weight,
                             const void* gamma, const void* beta,
                             const void* mean, const void* var, void* out,
                             int B, int D, int H, int W, int dtype, int pdtype,
                             int eps_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  if (dtype == 0) {
    return launch_p<float>(pdtype, x, weight, gamma, beta, mean, var, eps,
                           out, B, D, H, W, st);
  }
  if (dtype == 1) {
    return launch_p<bf16>(pdtype, x, weight, gamma, beta, mean, var, eps, out,
                          B, D, H, W, st);
  }
  return kUnsupported;
}

// in_conv_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int in_conv_fwd(const int64_t* args) {
  return cv::call_packed(in_conv_fwd_typed, args);
}
