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
// plain_cost_volume) to the last bit in float32: every product and sum that
// the plain version rounds separately is written with an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, ...), which nvcc never
// contracts into an FMA, in the plain version's order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;  // (dtype, C, groups) not instantiated
constexpr int kBadShape = -2;     // a dimension exceeds the launch grid

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Loads the C channels of one NHWC pixel into f32 registers.
template <typename T, int C>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&v)[C]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(C % kVec == 0, "C must fill whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < C / kVec; ++i) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[i * kVec + j] = to_float(e[j]);
  }
}

// o += w * row, for the C channels of one tap.
template <typename T, int C>
__device__ __forceinline__ void add_tap(const T* __restrict__ p, float w,
                                        float (&o)[C]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < C / kVec; ++i) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      o[i * kVec + j] =
          __fadd_rn(o[i * kVec + j], __fmul_rn(to_float(e[j]), w));
    }
  }
}

// Stores N f32 values as T, with 16-byte stores where the row allows.
template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ p,
                                          const float (&v)[N]) {
  constexpr int kVec = 16 / sizeof(T);
  if constexpr (N % kVec == 0) {
#pragma unroll
    for (int i = 0; i < N / kVec; ++i) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = from_float<T>(v[i * kVec + j]);
      reinterpret_cast<uint4*>(p)[i] = raw;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = from_float<T>(v[k]);
  }
}

// Adds one tap at integer-valued (yt, xt) with weight w to o, or nothing if
// the tap lies outside the image (per-tap zeros padding). The test is on
// the float coordinates, so far-outside or NaN coordinates never wrap.
template <typename T, int C>
__device__ __forceinline__ void tap(const T* __restrict__ src, int H, int W,
                                    float yt, float xt, float w,
                                    float (&o)[C]) {
  if (xt >= 0.f && xt <= static_cast<float>(W - 1) && yt >= 0.f &&
      yt <= static_cast<float>(H - 1)) {
    const int64_t pix = static_cast<int64_t>(yt) * W + static_cast<int64_t>(xt);
    add_tap<T, C>(src + pix * C, w, o);
  }
}

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
    const float* P = proj + (b * (V - 1) + (v - 1)) * 12;
    // n = (R @ (x, y, 1)) * d + T, rounded as ops/geometry.py::project_to_src
    float n[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float rot = __fadd_rn(
          __fadd_rn(__fmul_rn(__ldg(P + 4 * i), xf),
                    __fmul_rn(__ldg(P + 4 * i + 1), yf)),
          __ldg(P + 4 * i + 2));
      n[i] = __fadd_rn(__fmul_rn(rot, dep), __ldg(P + 4 * i + 3));
    }
    float sx = static_cast<float>(W), sy = static_cast<float>(H);
    if (!(n[2] <= __fmul_rn(1e-7f, dep))) {  // behind camera -> (W, H)
      const float r = __frcp_rn(n[2]);
      sx = __fmul_rn(n[0], r);
      sy = __fmul_rn(n[1], r);
    }
    const float x0 = floorf(sx), y0 = floorf(sy);
    const float x1 = x0 + 1.f, y1 = y0 + 1.f;
    const float wx1 = __fsub_rn(sx, x0), wy1 = __fsub_rn(sy, y0);
    const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);

    float o[C];
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = 0.f;
    const T* src = fb + v * view;
    tap<T, C>(src, H, W, y0, x0, __fmul_rn(wy0, wx0), o);
    tap<T, C>(src, H, W, y0, x1, __fmul_rn(wy0, wx1), o);
    tap<T, C>(src, H, W, y1, x0, __fmul_rn(wy1, wx0), o);
    tap<T, C>(src, H, W, y1, x1, __fmul_rn(wy1, wx1), o);

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

template <typename T, int C>
int launch_groups(int G, const void* feats, const void* proj,
                  const void* depth, void* out, int B, int V, int H, int W,
                  int D, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, C, 1>(feats, proj, depth, out, B, V, H, W, D, stream);
    case 2: return launch<T, C, 2>(feats, proj, depth, out, B, V, H, W, D, stream);
    case 4: return launch<T, C, 4>(feats, proj, depth, out, B, V, H, W, D, stream);
    case 8: return launch<T, C, 8>(feats, proj, depth, out, B, V, H, W, D, stream);
    default: return kUnsupported;
  }
}

template <typename T>
int launch_channels(int C, int G, const void* feats, const void* proj,
                    const void* depth, void* out, int B, int V, int H, int W,
                    int D, cudaStream_t stream) {
  switch (C) {
    case 8: return launch_groups<T, 8>(G, feats, proj, depth, out, B, V, H, W, D, stream);
    case 16: return launch_groups<T, 16>(G, feats, proj, depth, out, B, V, H, W, D, stream);
    case 32: return launch_groups<T, 32>(G, feats, proj, depth, out, B, V, H, W, D, stream);
    default: return kUnsupported;
  }
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
  if (dtype == 0) {
    return launch_channels<float>(C, G, feats, proj, depth, out, B, V, H, W,
                                  D, st);
  }
  if (dtype == 1) {
    return launch_channels<__nv_bfloat16>(C, G, feats, proj, depth, out, B,
                                          V, H, W, D, st);
  }
  return kUnsupported;
}

extern "C" const char* cost_volume_error_string(int code) {
  if (code == kUnsupported) return "unsupported (dtype, C, groups)";
  if (code == kBadShape) return "shape exceeds the launch grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
