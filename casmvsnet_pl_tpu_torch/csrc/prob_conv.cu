// CostRegNet's last layer, the 3x3x3 convolution of 8 channels to 1 with
// zero padding 1 (models/cost_reg.py, `prob`), for Hopper (sm_90a).
//
// Replaces no TPU kernel: XLA runs this convolution on the TPU. On the card
// cuDNN sends a convolution with one output channel to a generic implicit
// GEMM (implicit_convolveNd_sgemm) that leaves the tensor cores idle and
// took 18.7 ms of a 46 ms eval map at 1152x864x5. This kernel does the same
// work as a stencil pass.
//
// What it computes, for every b, d, h, w:
//   out[b, d, h, w] = bias + sum over kd, kh, kw < 3 and c < 8 of
//                     w[0, c, kd, kh, kw] * x[b, c, d+kd-1, h+kh-1, w+kw-1]
// with zeros outside the volume. x is the NCDHW view of a channels_last_3d
// tensor, so a voxel's 8 channels lie together (16 bytes in bfloat16); x
// and out are float32 or bfloat16, w (1, 8, 3, 3, 3) and bias (1,) float32
// or bfloat16 (bfloat16 parameters in eval, float32 ones under autocast).
// The 216 products are summed in float32 with fused multiply-adds, the bias
// is added last and the sum is rounded once to out's dtype. Plain version:
// F.conv3d (ops/prob_conv.py).
//
// What bounds it on the card: bytes and operations, nearly equally. A bf16
// voxel moves 16 bytes in and 2 out and takes 216 multiply-adds: at eval's
// three levels 340 MB (0.102 ms at 3.35 TB/s) and 8.17 GFLOP (0.122 ms in
// float32 on the CUDA cores at 67 TFLOP/s). So the design spends its
// instructions on the multiply-adds and reads each voxel from device memory
// about once:
// - a thread owns R = 2 neighbouring outputs along W of one row and walks
//   along D through its chunk of planes. An input plane feeds the outputs at
//   d-1, d and d+1, whose three partial sums stay in registers; each input
//   row the thread loads (R + 2 voxels, one 16-byte load each in bf16) is
//   converted to float32 once and used for 9 R multiply-adds a value;
// - the weights, converted to float32, sit in shared memory and are read as
//   float4 broadcasts (every lane the same address), each used R times;
// - a block covers 16 rows of 16 R columns, so the rows above and below a
//   thread's come from L1, not from device memory;
// - a block takes at most 16 planes of D (chunks of 16 at D = 32 and 48,
//   all of D = 8), so the coarse level, with few columns, still fills the
//   card, at the cost of two more planes read a chunk;
// - each output is written once, R at a time where the row allows.
// Measured on the H100 (PERF.md): R = 2 beat R = 1 and 4, and blocks of
// 32 x 8 and 32 x 4 threads, within 5 %; chunks of 16 planes beat 8 and all
// of D. What holds it at about a quarter of its bound is the shared-memory
// pipe, which serves the weights' broadcasts (54 float4 loads a plane and
// thread, for 432 multiply-adds) beside the input's loads; tensor-core
// products (mma.sync, the weights held in registers) would lift that.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kC = 8;           // input channels
constexpr int kTaps = 27 * kC;  // weights
constexpr int kRun = 2;         // outputs along W a thread
constexpr int kBlockX = 16;     // threads along W
constexpr int kBlockY = 16;     // rows
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kDTile = 16;      // planes of D a block at most

__device__ __forceinline__ float load_param(const void* p, int i, int dtype) {
  return dtype == 0 ? __ldg(static_cast<const float*>(p) + i)
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p)[i]);
}

// Stores the first n of N values as T: one vector store where all N go and
// the row allows (whole), else one at a time.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* __restrict__ p,
                                          const float (&v)[N], int n,
                                          bool whole) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes == 8 || kBytes == 4, "two float32 or bfloat16 values");
  using Vec = std::conditional_t<kBytes == 8, uint2, uint32_t>;
  if (whole) {
    Vec raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = from_float<T>(v[j]);
    *reinterpret_cast<Vec*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n) p[j] = from_float<T>(v[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prob_conv_kernel(const T* __restrict__ x, const void* __restrict__ weight,
                     const void* __restrict__ bias, int pdtype,
                     T* __restrict__ out, int D, int H, int W, int d_tile,
                     int chunks) {
  constexpr int R = kRun;
  __shared__ __align__(16) float ws[kTaps];  // [kh][kw][kd][c]
  __shared__ float bs;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < kTaps; i += kThreads) {
    const int c = i % kC, kd = (i / kC) % 3, khw = i / (3 * kC);
    ws[i] = load_param(weight, c * 27 + kd * 9 + khw, pdtype);
  }
  if (tid == 0) bs = load_param(bias, 0, pdtype);
  __syncthreads();

  const int w0 = (blockIdx.x * kBlockX + threadIdx.x) * R;
  const int h = blockIdx.y * kBlockY + threadIdx.y;
  if (w0 >= W || h >= H) return;
  const int b = blockIdx.z / chunks;
  const int d0 = (blockIdx.z - b * chunks) * d_tile;
  const int d1 = min(d0 + d_tile, D);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* xb = x + static_cast<int64_t>(b) * D * plane * kC;
  T* ob = out + static_cast<int64_t>(b) * D * plane +
          static_cast<int64_t>(h) * W + w0;
  const int n = min(R, W - w0);
  const bool whole = W % R == 0;
  const float bias_v = bs;

  // the partial sums of the outputs at p-1 (lo), p (mid) and p+1 (hi)
  float lo[R], mid[R], hi[R];
#pragma unroll
  for (int j = 0; j < R; ++j) lo[j] = mid[j] = hi[j] = 0.f;
  for (int p = d0 - 1; p <= d1; ++p) {
    if (p >= 0 && p < D) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int row = h + kh - 1;
        if (row < 0 || row >= H) continue;
        const T* xr = xb + (p * plane + static_cast<int64_t>(row) * W) * kC;
        float v[R + 2][kC];
#pragma unroll
        for (int j = 0; j < R + 2; ++j) {
          const int col = w0 - 1 + j;
          if (col >= 0 && col < W) {
            load_row<T, kC>(xr + static_cast<int64_t>(col) * kC, v[j]);
          } else {
#pragma unroll
            for (int c = 0; c < kC; ++c) v[j][c] = 0.f;
          }
        }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4* wq =
              reinterpret_cast<const float4*>(ws + (kh * 3 + kw) * 3 * kC);
          float wk[3][kC];
#pragma unroll
          for (int q = 0; q < 3 * kC / 4; ++q) {
            const float4 t = wq[q];
            float* dst = &wk[0][0] + 4 * q;
            dst[0] = t.x;
            dst[1] = t.y;
            dst[2] = t.z;
            dst[3] = t.w;
          }
#pragma unroll
          for (int c = 0; c < kC; ++c) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const float xv = v[j + kw][c];
              hi[j] = fmaf(wk[0][c], xv, hi[j]);   // kd = 0: output p+1
              mid[j] = fmaf(wk[1][c], xv, mid[j]);  // kd = 1: output p
              lo[j] = fmaf(wk[2][c], xv, lo[j]);    // kd = 2: output p-1
            }
          }
        }
      }
    }
    if (p - 1 >= d0) {   // every plane of output p-1 is in
      float o[R];
#pragma unroll
      for (int j = 0; j < R; ++j) o[j] = __fadd_rn(lo[j], bias_v);
      store_run<T, R>(ob + static_cast<int64_t>(p - 1) * plane, o, n, whole);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      lo[j] = mid[j];
      mid[j] = hi[j];
      hi[j] = 0.f;
    }
  }
}

template <typename T>
int launch(const void* x, const void* weight, const void* bias, void* out,
           int B, int D, int H, int W, int pdtype, cudaStream_t st) {
  const int64_t gx = (W + kBlockX * kRun - 1) / (kBlockX * kRun);
  const int64_t gy = (H + kBlockY - 1) / kBlockY;
  const int d_tile = min(D, kDTile);
  const int64_t chunks = (D + d_tile - 1) / d_tile;
  const int64_t gz = B * chunks;
  if (gx > 0x7fffffff || gy > 65535 || gz > 65535) return kBadShape;
  prob_conv_kernel<T><<<dim3(static_cast<unsigned>(gx),
                             static_cast<unsigned>(gy),
                             static_cast<unsigned>(gz)),
                        dim3(kBlockX, kBlockY), 0, st>>>(
      static_cast<const T*>(x), weight, bias, pdtype, static_cast<T*>(out), D,
      H, W, d_tile, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, 8, D, H, W) in channels_last_3d, of dtype (0: float32, 1:
// bfloat16), 16-byte aligned; weight (1, 8, 3, 3, 3) and bias (1,)
// contiguous, of pdtype; out (B, D, H, W) contiguous, of dtype. Returns 0,
// a cudaError_t from the launch, or a negative code of sampling.cuh
// (cost_volume_error_string names it).
static int prob_conv_fwd_typed(const void* x, const void* weight,
                               const void* bias, void* out, int B, int D,
                               int H, int W, int dtype, int pdtype,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pdtype != 0 && pdtype != 1) return kUnsupported;
  if (dtype == 0) {
    return launch<float>(x, weight, bias, out, B, D, H, W, pdtype, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, weight, bias, out, B, D, H, W, pdtype,
                                 st);
  }
  return kUnsupported;
}

// prob_conv_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int prob_conv_fwd(const int64_t* args) {
  return cv::call_packed(prob_conv_fwd_typed, args);
}
