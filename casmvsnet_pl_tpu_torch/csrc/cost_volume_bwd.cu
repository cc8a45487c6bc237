// Backward of the fused plane-sweep cost volume (cost_volume.cu) for Hopper
// (sm_90a): the gradient with respect to the features, for the variance and
// the groupwise combine. The projected coordinates get no gradient, as in
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
//   groupwise:  with k = C/G and g_c = g[c / k] / (k * (V-1)),
//               d ref[c] += g_c * sum_v o_v[c]   summed over d;
//               d o_v[c]  = g_c * ref[c]         spread onto o_v's 4 taps.
// Each sample is recomputed from feats, proj and depth exactly as the
// forward computes it (sampling.cuh): the kernel keeps no residual beyond
// the forward's inputs, as the JAX custom VJP keeps only coordinates.
//
// Layout: one thread per (b, pixel, chunk of 8 channels), chunks fastest,
// looping over the D depths. The reference view's gradient of the thread's
// (pixel, chunk) is kept in registers over the whole loop and written once,
// with no atomics. A source view's gradient is a scatter: the taps of many
// (pixel, depth) samples land on one source pixel, so each tap's 8 values
// are added with two float4 atomicAdds into a float32 buffer that the
// caller zeroes.
// Variance needs the mean m before any source tap's share is known, so it
// samples the source views twice per depth (once for m, once to scatter);
// the second pass reads taps that the first just brought into L1/L2.
//
// What bounds it on the card: the atomics. B*D*H*W*(V-1)*4*C f32 adds
// (0.34-0.67 G per level at B=2 for the default config) land on a source
// gradient of a few MB per view that stays in the 50 MB L2, so the L2's
// atomic rate, not device memory, is the limit: with one scalar atomic per
// channel the kernel ran at ~85 G adds/s. The design keeps the reference
// view (a third of the gradient at V=3) out of the atomics and writes it
// once, adds 4 channels per atomic operation (float4, sm_90), and puts the
// chunks of a pixel on neighbouring lanes so a warp's atomics fall on few
// L2 sectors. Shared-memory tile accumulation before the global atomics is
// the next step.
//
// Summation order: the atomics add in an order that changes from run to
// run, so results agree with the plain version (ops/plane_sweep.py::
// plain_cost_volume_bwd) to rounding, not to the bit.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr int kN = 8;  // channels per thread

// dst[q * C + c0 + c] += w_t * d[c] for each in-image tap q of footprint f,
// as two 16-byte vector atomics per tap (sm_90 adds a float4 in one
// operation; the 8 channels of a chunk are 32-byte aligned).
__device__ __forceinline__ void scatter(float* __restrict__ dst, int C,
                                        int c0, const Footprint& f, int H,
                                        int W, const float (&d)[kN]) {
  for_each_tap(f, H, W, [&](int64_t q, float w) {
    float4* p = reinterpret_cast<float4*>(dst + q * C + c0);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      atomicAdd(p + i, make_float4(__fmul_rn(d[4 * i], w),
                                   __fmul_rn(d[4 * i + 1], w),
                                   __fmul_rn(d[4 * i + 2], w),
                                   __fmul_rn(d[4 * i + 3], w)));
    }
  });
}

// G == 1: variance. G > 1: groupwise correlation.
template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads)
    cost_volume_bwd_kernel(const T* __restrict__ feats,
                           const float* __restrict__ proj,
                           const float* __restrict__ depth,
                           const T* __restrict__ grad_out,
                           float* __restrict__ grad, int V, int H, int W,
                           int D) {
  static_assert(C % G == 0 && C % kN == 0, "bad (C, G)");
  constexpr bool kVariance = G == 1;
  constexpr int kOut = kVariance ? C : G;
  constexpr int kChunks = C / kN;
  constexpr int kPer = C / G;

  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (tid >= HW * kChunks) return;
  const int64_t pix = tid / kChunks;
  const int c0 = static_cast<int>(tid % kChunks) * kN;
  const int64_t b = blockIdx.y;
  const float xf = static_cast<float>(pix % W);
  const float yf = static_cast<float>(pix / W);

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

  for (int d = 0; d < D; ++d) {
    const int64_t bdp = (b * D + d) * HW + pix;
    const float dep = depth[bdp];
    const T* go = grad_out + bdp * kOut;
    float g[kN], o[kN], dv[kN];
    if constexpr (kVariance) {
      float m[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) m[c] = ref[c];
      for (int v = 1; v < V; ++v) {
        const Footprint f = project(pb + (v - 1) * 12, xf, yf, dep, H, W);
        sample<T, kN>(fb + v * view, C, c0, f, H, W, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) m[c] = __fadd_rn(m[c], o[c]);
      }
      load_row<T, kN>(go + c0, g);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        m[c] = __fmul_rn(m[c], inv_v);
        g[c] = __fmul_rn(g[c], two_v);
        dref[c] = __fadd_rn(dref[c], __fmul_rn(g[c], __fsub_rn(ref[c], m[c])));
      }
      for (int v = 1; v < V; ++v) {
        const Footprint f = project(pb + (v - 1) * 12, xf, yf, dep, H, W);
        sample<T, kN>(fb + v * view, C, c0, f, H, W, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) dv[c] = __fmul_rn(g[c], __fsub_rn(o[c], m[c]));
        scatter(gb + v * view, C, c0, f, H, W, dv);
      }
    } else {
      float so[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        g[c] = __fmul_rn(to_float(go[(c0 + c) / kPer]), inv_kv);
        dv[c] = __fmul_rn(g[c], ref[c]);
        so[c] = 0.f;
      }
      for (int v = 1; v < V; ++v) {
        const Footprint f = project(pb + (v - 1) * 12, xf, yf, dep, H, W);
        sample<T, kN>(fb + v * view, C, c0, f, H, W, o);
#pragma unroll
        for (int c = 0; c < kN; ++c) so[c] = __fadd_rn(so[c], o[c]);
        scatter(gb + v * view, C, c0, f, H, W, dv);
      }
#pragma unroll
      for (int c = 0; c < kN; ++c) dref[c] = __fadd_rn(dref[c], __fmul_rn(g[c], so[c]));
    }
  }
  store_row<float, kN>(gb + pix * C + c0, dref);
}

template <typename T, int C, int G>
int launch(const void* feats, const void* proj, const void* depth,
           const void* grad_out, void* grad, int B, int V, int H, int W,
           int D, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(H) * W * (C / kN);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || B > 65535) return kBadShape;
  const dim3 grid(static_cast<unsigned>(blocks), B);
  cost_volume_bwd_kernel<T, C, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(proj),
      static_cast<const float*>(depth), static_cast<const T*>(grad_out),
      static_cast<float*>(grad), V, H, W, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (B, V, H, W, C) of dtype (0: float32, 1: bfloat16); proj
// (B, V-1, 3, 4) f32; depth (B, D, H, W) f32; grad_out (B, D, H, W, C if
// G == 1 else G) of the feats dtype; grad (B, V, H, W, C) f32, zeroed by the
// caller. All contiguous and 16-byte aligned. Adds the gradient with
// respect to feats into grad. Returns 0, a cudaError_t from the launch, or
// a negative code of sampling.cuh (cost_volume_error_string names it).
extern "C" int cost_volume_bwd(const void* feats, const void* proj,
                               const void* depth, const void* grad_out,
                               void* grad, int B, int V, int H, int W, int D,
                               int C, int G, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cv::dispatch(dtype, C, G, [&](auto t, auto c, auto g) {
    using T = typename decltype(t)::type;
    return launch<T, decltype(c)::value, decltype(g)::value>(
        feats, proj, depth, grad_out, grad, B, V, H, W, D, st);
  });
}
