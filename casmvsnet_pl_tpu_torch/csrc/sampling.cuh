// Device helpers shared by the cost-volume kernels (cost_volume.cu, the
// forward, and cost_volume_bwd.cu, its adjoint), the quad configuration's
// cost epilogues (cost_epilogue.cu, cost_epilogue_bwd.cu), the probes, the
// deformable conv (deform_conv.cu, deform_conv_bwd.cu) and the FMT's layer
// (fmt_layer.cu): dtype conversion, 16-byte row loads and stores, the bf16
// mma.sync, the 4-tap reduce of a packed-quad row, the plane-sweep
// projection, the bilinear taps (of a plane-sweep footprint, and of a
// deformable sample) and the (dtype, C, G) dispatch.
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
#include <utility>

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

// c += A B on the tensor cores (mma.sync m16n8k16, bf16 in, float32 sums):
// a the A fragment of a 16 x 16 row-major tile (rows g and g + 8, columns
// 2 t, 2 t + 1 and 8 more, g = lane / 4, t = lane % 4), b0 and b1 the B
// fragment of a 16 x 8 column-major tile (rows 2 t, 2 t + 1 and 8 more of
// column g), c the 16 x 8 sums (rows g, g + 8; columns 2 t, 2 t + 1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// o = sum_q w[q] * row[q*C + c] for the N channels at row, a packed-quad
// row of 4C channels, the taps added in order (the cost epilogues').
template <typename T, int C, int N>
__device__ __forceinline__ void reduce_taps(const T* __restrict__ row,
                                            const float4 w, float (&o)[N]) {
  load_row<T, N>(row, o);
#pragma unroll
  for (int c = 0; c < N; ++c) o[c] = __fmul_rn(o[c], w.x);
  add_tap<T, N>(row + C, w.y, o);
  add_tap<T, N>(row + 2 * C, w.z, o);
  add_tap<T, N>(row + 3 * C, w.w, o);
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

// Calls fn(k, y, x, w) for each tap k of f that lies inside the image, (y,
// x) being the tap's pixel and w its weight (per-tap zeros padding), in the
// order k = 0 (y0, x0), 1 (y0, x0+1), 2 (y0+1, x0), 3 (y0+1, x0+1). The
// test is on the float coordinates, so far-outside or NaN coordinates never
// wrap.
template <typename F>
__device__ __forceinline__ void for_each_tap_xy(const Footprint& f, int H,
                                                int W, F&& fn) {
  const auto tap = [&](int k, float yt, float xt, float w) {
    if (xt >= 0.f && xt <= static_cast<float>(W - 1) && yt >= 0.f &&
        yt <= static_cast<float>(H - 1)) {
      fn(k, static_cast<int>(yt), static_cast<int>(xt), w);
    }
  };
  const float x1 = f.x0 + 1.f, y1 = f.y0 + 1.f;
  tap(0, f.y0, f.x0, __fmul_rn(f.wy0, f.wx0));
  tap(1, f.y0, x1, __fmul_rn(f.wy0, f.wx1));
  tap(2, y1, f.x0, __fmul_rn(f.wy1, f.wx0));
  tap(3, y1, x1, __fmul_rn(f.wy1, f.wx1));
}

// As for_each_tap_xy, with fn(q, w), q the tap's pixel index y * W + x.
template <typename F>
__device__ __forceinline__ void for_each_tap(const Footprint& f, int H, int W,
                                             F&& fn) {
  for_each_tap_xy(f, H, W, [&](int, int y, int x, float w) {
    fn(static_cast<int64_t>(y) * W + x, w);
  });
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

// The 4 bilinear taps of (sy, sx) in an H x W image: each tap's pixel
// index, weight and whether it lies inside the image, in the order y0x0,
// y0x1, y1x0, y1x1, and the fractions fy, fx; a tap outside the image
// reads pixel 0 with weight 0. The tests are on the float
// coordinates, so far-outside or NaN coordinates never index memory.
struct Corners {
  int q[4];
  float w[4];
  bool in[4];    // the tap lies inside the image
  float fy, fx;  // the point's fractions past its top-left tap
};

__device__ __forceinline__ Corners corners_at(float sy, float sx, int H,
                                              int W) {
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx1 = sx - x0, wy1 = sy - y0;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const bool cx0 = x0 >= 0.f && x0 <= static_cast<float>(W - 1);
  const bool cx1 = x0 >= -1.f && x0 <= static_cast<float>(W - 2);
  const bool cy0 = y0 >= 0.f && y0 <= static_cast<float>(H - 1);
  const bool cy1 = y0 >= -1.f && y0 <= static_cast<float>(H - 2);
  // in range wherever a tap is used; elsewhere saturated and wrapped
  // (unsigned), never undefined
  const int q0 = static_cast<int>(
      static_cast<unsigned>(__float2int_rz(y0)) * static_cast<unsigned>(W) +
      static_cast<unsigned>(__float2int_rz(x0)));
  Corners c;
  c.in[0] = cx0 && cy0;
  c.in[1] = cx1 && cy0;
  c.in[2] = cx0 && cy1;
  c.in[3] = cx1 && cy1;
  c.q[0] = c.in[0] ? q0 : 0;
  c.q[1] = c.in[1] ? q0 + 1 : 0;
  c.q[2] = c.in[2] ? q0 + W : 0;
  c.q[3] = c.in[3] ? q0 + W + 1 : 0;
  c.w[0] = c.in[0] ? wy0 * wx0 : 0.f;
  c.w[1] = c.in[1] ? wy0 * wx1 : 0.f;
  c.w[2] = c.in[2] ? wy1 * wx0 : 0.f;
  c.w[3] = c.in[3] ? wy1 * wx1 : 0.f;
  c.fy = wy1;
  c.fx = wx1;
  return c;
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

// The entries' calling convention (kernels/cost_volume.py::_Kernel._launch):
// one array of int64, every argument of the typed entry in order, pointers
// and the stream as their addresses. One ctypes argument converts in a
// fraction of the time of a dozen.
template <typename P>
P from_i64(int64_t v) {
  if constexpr (std::is_pointer_v<P>) {
    return reinterpret_cast<P>(static_cast<intptr_t>(v));
  } else {
    return static_cast<P>(v);
  }
}

template <typename... P, size_t... I>
int call_packed(int (*fn)(P...), const int64_t* a, std::index_sequence<I...>) {
  return fn(from_i64<P>(a[I])...);
}

// fn(a[0], a[1], ...) with each a[i] converted to fn's parameter type.
template <typename... P>
int call_packed(int (*fn)(P...), const int64_t* a) {
  return call_packed(fn, a, std::index_sequence_for<P...>{});
}

}  // namespace cv
