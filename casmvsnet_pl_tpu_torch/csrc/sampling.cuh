// Device helpers shared by the cost-volume kernels (cost_volume.cu, the
// forward, and cost_volume_bwd.cu, its adjoint): dtype conversion, 16-byte
// row loads, the plane-sweep projection and the bilinear taps.
//
// Every product and sum that the plain PyTorch version (ops/geometry.py::
// project_to_src, ops/grid_sample.py) rounds separately is written with an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, ...), which
// nvcc never contracts into an FMA, in the plain version's order, so the
// kernels' samples equal the plain version's to the last bit in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cv {

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

// Loads N consecutive values (16-byte aligned) into f32 registers.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&v)[N]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(N % kVec == 0, "N must fill whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N / kVec; ++i) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[i * kVec + j] = to_float(e[j]);
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

// o += w * row, for N consecutive channels of one tap.
template <typename T, int N>
__device__ __forceinline__ void add_tap(const T* __restrict__ p, float w,
                                        float (&o)[N]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / kVec; ++i) {   // one 16-byte load at a time
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      o[i * kVec + j] =
          __fadd_rn(o[i * kVec + j], __fmul_rn(to_float(e[j]), w));
    }
  }
}

// The bilinear footprint of one plane-sweep sample in a source view: the
// top-left tap (x0, y0) and the weights of the two columns (wx0, wx1) and
// rows (wy0, wy1).
struct Footprint {
  float x0, y0, wx0, wx1, wy0, wy1;
};

// Projects reference pixel (xf, yf) at depth dep through P (3x4, row
// major): n = (R @ (x, y, 1)) * d + T, rounded as ops/geometry.py::
// project_to_src; a sample with n_z <= 1e-7 * d (behind the source camera)
// goes to (W, H), outside the image.
__device__ __forceinline__ Footprint project(const float* __restrict__ P,
                                             float xf, float yf, float dep,
                                             int H, int W) {
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
  if (!(n[2] <= __fmul_rn(1e-7f, dep))) {
    const float r = __frcp_rn(n[2]);
    sx = __fmul_rn(n[0], r);
    sy = __fmul_rn(n[1], r);
  }
  Footprint f;
  f.x0 = floorf(sx);
  f.y0 = floorf(sy);
  f.wx1 = __fsub_rn(sx, f.x0);
  f.wy1 = __fsub_rn(sy, f.y0);
  f.wx0 = __fsub_rn(1.f, f.wx1);
  f.wy0 = __fsub_rn(1.f, f.wy1);
  return f;
}

// Calls fn(q, w) for each tap of f that lies inside the image, q being the
// tap's pixel index and w its weight (per-tap zeros padding), in the order
// (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1). The test is on the float
// coordinates, so far-outside or NaN coordinates never wrap.
template <typename F>
__device__ __forceinline__ void for_each_tap(const Footprint& f, int H, int W,
                                             F&& fn) {
  const auto tap = [&](float yt, float xt, float w) {
    if (xt >= 0.f && xt <= static_cast<float>(W - 1) && yt >= 0.f &&
        yt <= static_cast<float>(H - 1)) {
      fn(static_cast<int64_t>(yt) * W + static_cast<int64_t>(xt), w);
    }
  };
  const float x1 = f.x0 + 1.f, y1 = f.y0 + 1.f;
  tap(f.y0, f.x0, __fmul_rn(f.wy0, f.wx0));
  tap(f.y0, x1, __fmul_rn(f.wy0, f.wx1));
  tap(y1, f.x0, __fmul_rn(f.wy1, f.wx0));
  tap(y1, x1, __fmul_rn(f.wy1, f.wx1));
}

// o = the bilinear sample of N channels (from channel offset c0 of rows of
// C channels) of one source view at footprint f.
template <typename T, int N>
__device__ __forceinline__ void sample(const T* __restrict__ src, int C,
                                       int c0, const Footprint& f, int H,
                                       int W, float (&o)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) o[c] = 0.f;
  for_each_tap(f, H, W, [&](int64_t q, float w) {
    add_tap<T, N>(src + q * C + c0, w, o);
  });
}

// Calls f(Type<T>{}, Int<C>{}, Int<G>{}) for the instantiated (dtype, C, G):
// dtype 0 float32, 1 bfloat16; C in {8, 16, 32}; G in {1, 2, 4, 8}.
// Returns f's result, or kUnsupported.
template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

template <typename T, int C, typename F>
int dispatch_groups(int G, F&& f) {
  switch (G) {
    case 1: return f(Type<T>{}, Int<C>{}, Int<1>{});
    case 2: return f(Type<T>{}, Int<C>{}, Int<2>{});
    case 4: return f(Type<T>{}, Int<C>{}, Int<4>{});
    case 8: return f(Type<T>{}, Int<C>{}, Int<8>{});
    default: return kUnsupported;
  }
}

template <typename T, typename F>
int dispatch_channels(int C, int G, F&& f) {
  switch (C) {
    case 8: return dispatch_groups<T, 8>(G, f);
    case 16: return dispatch_groups<T, 16>(G, f);
    case 32: return dispatch_groups<T, 32>(G, f);
    default: return kUnsupported;
  }
}

template <typename F>
int dispatch(int dtype, int C, int G, F&& f) {
  if (dtype == 0) return dispatch_channels<float>(C, G, f);
  if (dtype == 1) return dispatch_channels<__nv_bfloat16>(C, G, f);
  return kUnsupported;
}

}  // namespace cv
