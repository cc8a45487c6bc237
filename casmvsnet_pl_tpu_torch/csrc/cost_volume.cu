// Fused plane-sweep cost volume for Hopper (sm_90a): projection, bilinear
// sampling of the V-1 source views and the variance / groupwise combine in
// one pass, writing only the finished volume.
//
// Replaces, on the TPU side:
//   casmvsnet_pl_tpu/kernels/patch_epilogue.py::_pallas_fwd_call (the
//   bilinear extraction of the plane-sweep samples), and the projection,
//   tap gathers and sample/variance (or groupwise) combine that XLA runs
//   around it in ops/plane_sweep.py::batched_variance_cost_volume and
//   batched_groupwise_cost_volume.
//
// What bounds it on the card: bytes. It does ~30 flops per tap per channel
// and reads source features that stay in the 50 MB L2 (one source map is at
// most 5 MB at 640x512), so the write of the (B, D, H, W, C) output
// dominates. An unfused version writes every view's warped (B, D, H, W, C)
// samples and reads them back for the combine; here each output element is
// written once, samples and sums live in f32 registers, and nothing else
// touches device memory.
//
// Layout: one thread per (b, d, pixel), neighbouring threads on neighbouring
// pixels, so the depth-map read and the output write are coalesced and the
// tap reads of a warp fall on nearby rows. Each tap reads the C contiguous
// channels of an NHWC pixel with 16-byte vector loads.
//
// Numerics match the plain PyTorch version (ops/plane_sweep.py::
// plain_cost_volume) to the last bit in float32: the projection and taps
// (sampling.cuh) and the combine below round every product and sum
// separately, in the plain version's order.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;

// G == 1: variance over the V views. G > 1: groupwise correlation.
template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads)
    cost_volume_kernel(const T* __restrict__ feats,
                       const float* __restrict__ proj,
                       const float* __restrict__ depth, T* __restrict__ out,
                       int V, int H, int W, int D) {
  static_assert(C % G == 0, "groups must divide C");
  constexpr bool kVariance = G == 1;
  constexpr int kOut = kVariance ? C : G;

  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (pix >= HW) return;
  const int64_t b = blockIdx.z;
  const int64_t bd = b * D + blockIdx.y;
  const float xf = static_cast<float>(pix % W);
  const float yf = static_cast<float>(pix / W);
  const float dep = depth[bd * HW + pix];

  const int64_t view = HW * C;
  const T* fb = feats + b * V * view;
  float ref[C];
  load_row<T, C>(fb + pix * C, ref);

  float s[C], sq[C], acc[G];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[c] = ref[c];
    sq[c] = __fmul_rn(ref[c], ref[c]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int v = 1; v < V; ++v) {
    const Footprint f =
        project(proj + (b * (V - 1) + (v - 1)) * 12, xf, yf, dep, H, W);
    float o[C];
    sample<T, C>(fb + v * view, C, 0, f, H, W, o);

    if constexpr (kVariance) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[c] = __fadd_rn(s[c], o[c]);
        sq[c] = __fadd_rn(sq[c], __fmul_rn(o[c], o[c]));
      }
    } else {
      constexpr int kPer = C / G;
      const float inv = 1.f / kPer;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          t = __fadd_rn(t, __fmul_rn(o[g * kPer + k], ref[g * kPer + k]));
        }
        acc[g] = __fadd_rn(acc[g], __fmul_rn(t, inv));
      }
    }
  }

  float res[kOut];
  if constexpr (kVariance) {
    const float inv_v = __frcp_rn(static_cast<float>(V));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float m = __fmul_rn(s[c], inv_v);
      res[c] = __fsub_rn(__fmul_rn(sq[c], inv_v), __fmul_rn(m, m));
    }
  } else {
    const float inv_src = __frcp_rn(static_cast<float>(V - 1));
#pragma unroll
    for (int g = 0; g < G; ++g) res[g] = __fmul_rn(acc[g], inv_src);
  }
  store_row<T, kOut>(out + (bd * HW + pix) * kOut, res);
}

template <typename T, int C, int G>
int launch(const void* feats, const void* proj, const void* depth, void* out,
           int B, int V, int H, int W, int D, cudaStream_t stream) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t blocks = (hw + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || D > 65535 || B > 65535) return kBadShape;
  const dim3 grid(static_cast<unsigned>(blocks), D, B);
  cost_volume_kernel<T, C, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(proj),
      static_cast<const float*>(depth), static_cast<T*>(out), V, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (B, V, H, W, C) of dtype (0: float32, 1: bfloat16), contiguous and
// 16-byte aligned; proj (B, V-1, 3, 4) f32; depth (B, D, H, W) f32;
// out (B, D, H, W, C if G == 1 else G) of the feats dtype.
// Returns 0, a cudaError_t from the launch, or a negative code of this file.
extern "C" int cost_volume_fwd(const void* feats, const void* proj,
                               const void* depth, void* out, int B, int V,
                               int H, int W, int D, int C, int G, int dtype,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cv::dispatch(dtype, C, G, [&](auto t, auto c, auto g) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(c)::value, decltype(g)::value>(
        feats, proj, depth, out, B, V, H, W, D, st);
  });
}

extern "C" const char* cost_volume_error_string(int code) {
  if (code == cv::kUnsupported) return "unsupported (dtype, C, groups)";
  if (code == cv::kBadShape) return "shape exceeds the launch grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
