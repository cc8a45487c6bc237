// Backward of the fused plane-sweep cost volume (cost_volume.cu) for Hopper
// (sm_90a): the gradient with respect to the features, for the variance and
// the groupwise combine (G = 1 included: TransMVSNet's one-channel
// correlation). The projected coordinates get no gradient, as in
// the JAX package, which stops it at ops/plane_sweep.py::_patch_view.
//
// Replaces, on the TPU side:
//   casmvsnet_pl_tpu/kernels/patch_epilogue.py::_pallas_bwd_call (the
//   adjoint of the bilinear extraction, d_rowsT = sum_j w_j * goT_j over a
//   depth group), and the cotangent scatter of ops/plane_sweep.py::
//   _patch_sample_bwd (ops/banded_take.py::banded_scatter_add) and the
//   combine's adjoint that XLA ran around it.
//
// What it computes (s = ref + sum_v o_v, m = s / V, g the incoming gradient
// of the output at (b, d, pixel)):
//   variance:   d ref += g * (2/V) * (ref - m)   summed over d;
//               d o_v  = g * (2/V) * (o_v - m)   spread onto o_v's 4 taps;
//   groupwise:  with k = C/G and g_c = g[c / k] / (k * (V-1)) (G = 1:
//               g_c = g / (C (V-1))),
//               d ref[c] += g_c * sum_v o_v[c]   summed over d;
//               d o_v[c]  = g_c * ref[c]         spread onto o_v's 4 taps.
// Each sample is recomputed from feats, proj and depth exactly as the
// forward computes it (sampling.cuh): the kernel keeps no residual beyond
// the forward's inputs, as the JAX custom VJP keeps only coordinates.
//
// What bounds it on the card: the scatter. B*D*H*W*(V-1)*4*C f32 adds
// (0.34-0.67 G per level at B=2 for the default config) land on a source
// gradient of a few MB per view. Added one sample at a time, as float4
// atomics into device memory, they run at the L2's atomic rate (~90 G
// float4 operations/s), 20x the kernel's byte bound. The design cuts the
// atomics, not their rate:
//
// - Runs (variance, V = 3: the default config). A pixel's footprint moves
//   by a few source pixels over all of its depths (at the lower levels the
//   hypotheses are a few intervals wide), so a thread sums, in registers,
//   the shares that consecutive depths send to the same 4 taps, and adds
//   them to device memory only when the footprint moves: at the default
//   config's levels, 5-16x fewer atomics. It samples each source view once
//   per depth and keeps the samples in registers between the mean and the
//   scatter.
// - Other V, and groupwise, add every sample's taps at once; variance there
//   samples twice (once for the mean, once to scatter). Runs are compiled
//   for the one case only: their register arrays make an instantiation
//   several times slower to build, and the library is built at first use.
// - The reference view's gradient of a thread's (pixel, chunk) is kept in
//   registers over all depths and written once, with no atomics.
// - Layout: one thread per (b, pixel, chunk of 8 channels), chunks
//   fastest, so a warp's atomics fall on few L2 sectors.
// Designs measured and lost (PERF.md §6): accumulating in shared-memory
// tiles first (sm_90 has no shared-memory float add: atomicAdd on a shared
// float compiles to a compare-and-swap loop); keeping, when a run moves by
// one pixel, the 2 taps it shares with the next (fewer atomics, ~45 more
// registers); two threads per (pixel, chunk), each scattering one view; and
// 4 blocks an SM asked of the register allocator (spills).
//
// Summation order: atomics add in an order that changes from run to run, so
// results agree with the plain version (ops/plane_sweep.py::
// plain_cost_volume_bwd) to rounding, not to the bit.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr int kN = 8;  // channels per thread

// Var: variance (G == 1). Otherwise the groupwise correlation with G
// groups, G = 1 included. S: 2 for variance at V = 3 (samples cached in
// registers, runs), else 0 (runtime V).
template <typename T, int C, int G, int S, bool Var>
__global__ void __launch_bounds__(kThreads)
    cost_volume_bwd_kernel(const T* __restrict__ feats,
                           const float* __restrict__ proj,
                           const float* __restrict__ depth,
                           const T* __restrict__ grad_out,
                           float* __restrict__ grad, int V, int H, int W,
                           int D) {
  static_assert(C % G == 0 && C % kN == 0, "bad (C, G)");
  static_assert(!Var || G == 1, "a variance has one group");
  static_assert(S == 0 || (S == 2 && Var), "S is 2 (variance) or 0");
  constexpr bool kVariance = Var;
  constexpr int kOut = kVariance ? C : G;
  constexpr int kChunks = C / kN;
  constexpr int kPer = C / G;
  constexpr int kSrc = S > 0 ? S : 1;

  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (tid >= HW * kChunks) return;
  const int64_t pix = tid / kChunks;
  const int c0 = static_cast<int>(tid % kChunks) * kN;
  const int64_t b = blockIdx.y;
  const float xf = static_cast<float>(pix % W);
  const float yf = static_cast<float>(pix / W);
  const int nsrc = S > 0 ? S : V - 1;

  const int64_t view = HW * C;
  const T* fb = feats + b * V * view;
  float* gb = grad + b * V * view;
  const float* pb = proj + b * (V - 1) * 12;
  float ref[kN], dref[kN];
  load_row<T, kN>(fb + pix * C + c0, ref);
#pragma unroll
  for (int c = 0; c < kN; ++c) dref[c] = 0.f;
  const float inv_v = __frcp_rn(static_cast<float>(V));
  const float two_v = __fdiv_rn(2.f, static_cast<float>(V));
  const float inv_kv = __frcp_rn(static_cast<float>(kPer * (V - 1)));

  // vals added to channels c0.. of source view v at pixel (y, x): two
  // float4 atomics (sm_90 adds a float4 in one operation)
  const auto add_tap = [&](int v, int y, int x, const float(&vals)[kN]) {
    float4* p = reinterpret_cast<float4*>(
        gb + (v + 1) * view + (static_cast<int64_t>(y) * W + x) * C + c0);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      atomicAdd(p + i, make_float4(vals[4 * i], vals[4 * i + 1],
                                   vals[4 * i + 2], vals[4 * i + 3]));
    }
  };

  // runs: per source view the run's top-left tap and the shares summed at
  // its 4 taps (k = 0 (y0, x0), 1 (y0, x0+1), 2 (y0+1, x0), 3 (y0+1, x0+1))
  float run_x[kSrc], run_y[kSrc], acc[kSrc][4][kN];
#pragma unroll
  for (int v = 0; v < kSrc; ++v) {
    run_x[v] = run_y[v] = __int_as_float(0x7fc00000);  // NaN: no run yet
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < kN; ++c) acc[v][k][c] = 0.f;
    }
  }
  // adds view v's run sums to its source gradient and clears them
  const auto flush = [&](int v) {
    const Footprint f{run_x[v], run_y[v], 1.f, 1.f, 1.f, 1.f};
    for_each_tap_xy(f, H, W, [&](int k, int y, int x, float) {
      add_tap(v, y, x, acc[v][k]);
    });
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < kN; ++c) acc[v][k][c] = 0.f;
    }
  };

  // d (one sample's share, per channel) spread onto the taps of f in view v
  const auto scatter = [&](int v, const Footprint& f, const float(&d)[kN]) {
    if constexpr (S > 0) {
      // moved (or no run: NaN). Tested on the differences: the same answer
      // as comparing the coordinates, in faster code (7 % at L2, measured)
      const float dx = __fsub_rn(f.x0, run_x[v]);
      const float dy = __fsub_rn(f.y0, run_y[v]);
      if (dx != 0.f || dy != 0.f) {
        flush(v);
        run_x[v] = f.x0;
        run_y[v] = f.y0;
      }
      const float w[4] = {__fmul_rn(f.wy0, f.wx0), __fmul_rn(f.wy0, f.wx1),
                          __fmul_rn(f.wy1, f.wx0), __fmul_rn(f.wy1, f.wx1)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          acc[v][k][c] = __fmaf_rn(d[c], w[k], acc[v][k][c]);
        }
      }
    } else {
      for_each_tap_xy(f, H, W, [&](int, int y, int x, float w) {
        float vals[kN];
#pragma unroll
        for (int c = 0; c < kN; ++c) vals[c] = __fmul_rn(d[c], w);
        add_tap(v, y, x, vals);
      });
    }
  };

  for (int d = 0; d < D; ++d) {
    const int64_t bdp = (b * D + d) * HW + pix;
    const float dep = depth[bdp];
    const T* go = grad_out + bdp * kOut;
    float g[kN], dv[kN];
    if constexpr (kVariance) {
      float m[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) m[c] = ref[c];
      Footprint f[kSrc];
      float o[kSrc][kN];
#pragma unroll
      for (int v = 0; v < nsrc; ++v) {
        const int s = S > 0 ? v : 0;
        f[s] = project(pb + v * 12, xf, yf, dep, H, W);
        sample<T, kN>(fb + (v + 1) * view, C, c0, f[s], H, W, o[s]);
#pragma unroll
        for (int c = 0; c < kN; ++c) m[c] = __fadd_rn(m[c], o[s][c]);
      }
      load_row<T, kN>(go + c0, g);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        m[c] = __fmul_rn(m[c], inv_v);
        g[c] = __fmul_rn(g[c], two_v);
        dref[c] = __fadd_rn(dref[c], __fmul_rn(g[c], __fsub_rn(ref[c], m[c])));
      }
#pragma unroll
      for (int v = 0; v < nsrc; ++v) {
        const int s = S > 0 ? v : 0;
        if constexpr (S == 0) {   // sample again: V is not known here
          f[0] = project(pb + v * 12, xf, yf, dep, H, W);
          sample<T, kN>(fb + (v + 1) * view, C, c0, f[0], H, W, o[0]);
        }
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          dv[c] = __fmul_rn(g[c], __fsub_rn(o[s][c], m[c]));
        }
        scatter(v, f[s], dv);
      }
    } else {
      float so[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        g[c] = __fmul_rn(to_float(go[(c0 + c) / kPer]), inv_kv);
        dv[c] = __fmul_rn(g[c], ref[c]);
        so[c] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < nsrc; ++v) {
        float o[kN];
        const Footprint f = project(pb + v * 12, xf, yf, dep, H, W);
        sample<T, kN>(fb + (v + 1) * view, C, c0, f, H, W, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) so[c] = __fadd_rn(so[c], o[c]);
        scatter(v, f, dv);
      }
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        dref[c] = __fadd_rn(dref[c], __fmul_rn(g[c], so[c]));
      }
    }
  }
  if constexpr (S > 0) {
#pragma unroll
    for (int v = 0; v < kSrc; ++v) flush(v);
  }
  store_row<float, kN>(gb + pix * C + c0, dref);
}

template <typename T, int C, int G, int S, bool Var>
int launch(const void* feats, const void* proj, const void* depth,
           const void* grad_out, void* grad, int B, int V, int H, int W,
           int D, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(H) * W * (C / kN);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || B > 65535) return kBadShape;
  const dim3 grid(static_cast<unsigned>(blocks), B);
  cost_volume_bwd_kernel<T, C, G, S, Var><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(proj),
      static_cast<const float*>(depth), static_cast<const T*>(grad_out),
      static_cast<float*>(grad), V, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (B, V, H, W, C) of dtype (0: float32, 1: bfloat16); proj
// (B, V-1, 3, 4) f32; depth (B, D, H, W) f32; kind 0: the variance (G ==
// 1), grad_out (B, D, H, W, C); kind 1: the groupwise correlation with G
// groups (1, 2, 4 or 8), grad_out (B, D, H, W, G); grad_out of the feats
// dtype; grad (B, V, H, W, C) f32, zeroed by the caller. All contiguous and 16-byte aligned. Adds the gradient with
// respect to feats into grad. Returns 0, a cudaError_t from the launch, or
// a negative code of sampling.cuh (cost_volume_error_string names it).
static int cost_volume_bwd_typed(const void* feats, const void* proj,
                                 const void* depth, const void* grad_out,
                                 void* grad, int B, int V, int H, int W, int D,
                                 int C, int G, int kind, int dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind != 0 && kind != 1) return cv::kUnsupported;
  return cv::dispatch(dtype, C, G, [&](auto t, auto c, auto g) {
    using T = typename decltype(t)::type;
    constexpr int kC = decltype(c)::value, kG = decltype(g)::value;
    if (kind == 1) {
      return launch<T, kC, kG, 0, false>(feats, proj, depth, grad_out, grad,
                                         B, V, H, W, D, st);
    }
    if constexpr (kG == 1) {
      if (V == 3) {
        return launch<T, kC, 1, 2, true>(feats, proj, depth, grad_out, grad,
                                         B, V, H, W, D, st);
      }
      return launch<T, kC, 1, 0, true>(feats, proj, depth, grad_out, grad, B,
                                       V, H, W, D, st);
    } else {
      return cv::kUnsupported;
    }
  });
}

// cost_volume_bwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int cost_volume_bwd(const int64_t* args) {
  return cv::call_packed(cost_volume_bwd_typed, args);
}
