// The backward of the modulated deformable 3x3 convolution (DCNv2) of
// TransMVSNet's ARF (deform_conv.cu, ops/deform_conv.py) for Hopper
// (sm_90a): the gradients of the input, of the offsets and masks and of
// the weight, in one launch.
//
// Replaces no TPU kernel: the JAX package has no TransMVSNet. Plain
// version: the autograd of ops/deform_conv.py::plain_deform_conv.
//
// For float32 and bfloat16 x, offsets, weight and incoming gradient gy at
// C = 8, 16 and 32, on the CUDA cores.
// With u_k(p) = sum_co W[co, :, k] gy(p, co), the gradient of the masked
// sample m_k s_k(p), and s_k(p) = sum_t w_t x(q_t) over the 4 taps t:
//   dx(q_t)      += m_k w_t u_k(p)           (a scatter of float32 atomics)
//   d dy_k(p)     = m_k sum_t dw_t/dsy (u_k . x(q_t)), d dx_k likewise
//   d om[18 + k]  = (sum_t w_t (u_k . x(q_t))) m_k (1 - m_k)
//   dW[co, ci, k] = sum_p gy(p, co) m_k s_k(p, ci)
// Taps outside the image read zero and get nothing, as in the forward; the
// bilinear weights are differentiated as the plain version's autograd does
// (floor's gradient zero). Every product is formed and summed in float32.
// Layout: the tap loop outermost; for each tap a block walks kTiles tiles
// of kThreads pixels, a thread a pixel. The tile's gy (C a pixel) and
// masked samples (C a pixel) sit in shared memory, and the threads of the
// block sum the tile's outer products into dW_k, each kCo x kCi of the
// (co, ci) over a share of the tile's pixels, in registers over the tiles,
// then add them to dW with float32 atomics once a tap.
// What bounds it on the card: the scatter, 36 C float32 adds a pixel
// (4 taps of 9 samples, as float4 atomics) at the L2's atomic rate; the
// two contractions take 36 C^2 operations a pixel on the CUDA cores.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr int kTaps = 9;
constexpr int kOm = 27;         // offset (18) and mask (9) channels
constexpr int kStride = kThreads + 4;   // a shared row: no bank conflicts

template <int C>
struct BwdTune {
  static constexpr int kCo = 2;                  // dW's (co, ci) a thread
  static constexpr int kCi = C == 32 ? 4 : 2;
  static constexpr int kTiles = C == 32 ? 2 : (C == 16 ? 4 : 8);
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    deform_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ om,
                           const T* __restrict__ weight,
                           const T* __restrict__ gy, float* __restrict__ gx,
                           T* __restrict__ gom, float* __restrict__ gw,
                           int64_t total, int H, int W) {
  using Tune = BwdTune<C>;
  constexpr int kCo = Tune::kCo, kCi = Tune::kCi;
  constexpr int kGroups = (C / kCo) * (C / kCi);   // (co, ci) blocks
  static_assert(kThreads % kGroups == 0, "bad dW tiling");
  constexpr int kParts = kThreads / kGroups;       // threads a block shares
  constexpr int kSpan = kThreads / kParts;         // pixels a part sums
  __shared__ __align__(16) float ws[C * C];        // W_k as [co][ci]
  __shared__ __align__(16) float gys[C * kStride];  // [co][pixel]
  __shared__ __align__(16) float col[C * kStride];  // [ci][pixel]

  const int tid = threadIdx.x;
  const int grp = tid % kGroups, part = tid / kGroups;
  // this thread's (co, ci): co = co0 + j C / kCo, ci = ci0 + i C / kCi, so
  // that the 8 lanes of a 16-byte load phase read distinct banks
  const int co0 = grp / (C / kCi), ci0 = grp % (C / kCi);
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * Tune::kTiles *
                        kThreads;

#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const int ki = k / 3, kj = k - 3 * (k / 3);
    float dw[kCo][kCi];
#pragma unroll
    for (int a = 0; a < kCo; ++a) {
#pragma unroll
      for (int b = 0; b < kCi; ++b) dw[a][b] = 0.f;
    }
#pragma unroll 1
    for (int tile = 0; tile < Tune::kTiles; ++tile) {
      const int64_t base = first + static_cast<int64_t>(tile) * kThreads;
      if (base >= total) break;           // the same for the whole block
      const int64_t p = base + tid;
      const bool live = p < total;
      const int64_t pc = live ? p : total - 1;
      __syncthreads();    // the last tile's (or tap's) shared reads are done
      if (tile == 0) {
        for (int i = tid; i < C * C; i += kThreads) {
          const int ci = i % C, co = i / C;
          ws[i] = to_float(weight[(co * C + ci) * kTaps + k]);
        }
      }
      {
        float g[C];
        if (live) {
          load_row<T, C>(gy + pc * C, g);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) g[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) gys[c * kStride + tid] = g[c];
      }
      __syncthreads();

      // u = W_k^T gy
      float u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = 0.f;
#pragma unroll
      for (int co = 0; co < C; ++co) {
        const float gv = gys[co * kStride + tid];
        const float4* w4 = reinterpret_cast<const float4*>(ws + co * C);
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 w = w4[c4];
          u[4 * c4] = fmaf(w.x, gv, u[4 * c4]);
          u[4 * c4 + 1] = fmaf(w.y, gv, u[4 * c4 + 1]);
          u[4 * c4 + 2] = fmaf(w.z, gv, u[4 * c4 + 2]);
          u[4 * c4 + 3] = fmaf(w.w, gv, u[4 * c4 + 3]);
        }
      }

      const int64_t n = pc / HW, q = pc - n * HW;
      const int ph = static_cast<int>(q / W);
      const int pw = static_cast<int>(q - static_cast<int64_t>(ph) * W);
      const T* o = om + pc * kOm;
      const float dy = to_float(o[2 * k]), dx = to_float(o[2 * k + 1]);
      const float m = 1.f / (1.f + expf(-to_float(o[18 + k])));
      const float sy = static_cast<float>(ph - 1 + ki) + dy;
      const float sx = static_cast<float>(pw - 1 + kj) + dx;
      const Corners cn = corners_at(sy, sx, H, W);
      // the tap weights' derivatives by sy and sx (order y0x0, y0x1, y1x0,
      // y1x1, as corners_at's)
      const float fy = cn.fy, fx = cn.fx;
      const float by[4] = {-(1.f - fx), -fx, 1.f - fx, fx};
      const float bx[4] = {-(1.f - fy), 1.f - fy, -fy, fy};
      const T* img = x + n * HW * C;
      float* gimg = gx + n * HW * C;
      float s[C];
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = 0.f;
      float ddy = 0.f, ddx = 0.f, dm = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool in = cn.in[t];
        float v[C];
        load_row<T, C>(img + static_cast<int64_t>(cn.q[t]) * C, v);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[c] = fmaf(v[c], cn.w[t], s[c]);
          dot = fmaf(u[c], v[c], dot);
        }
        if (!in) dot = 0.f;
        ddy = fmaf(by[t], dot, ddy);
        ddx = fmaf(bx[t], dot, ddx);
        dm = fmaf(cn.w[t], dot, dm);
        if (live && in) {
          const float mw = m * cn.w[t];
          float4* dst = reinterpret_cast<float4*>(
              gimg + static_cast<int64_t>(cn.q[t]) * C);
#pragma unroll
          for (int c4 = 0; c4 < C / 4; ++c4) {
            atomicAdd(dst + c4, make_float4(mw * u[4 * c4], mw * u[4 * c4 + 1],
                                            mw * u[4 * c4 + 2],
                                            mw * u[4 * c4 + 3]));
          }
        }
      }
      if (live) {
        T* go = gom + pc * kOm;
        go[2 * k] = from_float<T>(m * ddy);
        go[2 * k + 1] = from_float<T>(m * ddx);
        go[18 + k] = from_float<T>(dm * m * (1.f - m));
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        col[c * kStride + tid] = live ? m * s[c] : 0.f;
      }
      __syncthreads();

      // dW_k += the tile's outer products, this thread's block over its part
      const int p0 = part * kSpan;
#pragma unroll 4
      for (int pp = 0; pp < kSpan; pp += 4) {
        float4 a[kCo], b[kCi];
#pragma unroll
        for (int j = 0; j < kCo; ++j) {
          a[j] = *reinterpret_cast<const float4*>(
              gys + (co0 + j * (C / kCo)) * kStride + p0 + pp);
        }
#pragma unroll
        for (int i = 0; i < kCi; ++i) {
          b[i] = *reinterpret_cast<const float4*>(
              col + (ci0 + i * (C / kCi)) * kStride + p0 + pp);
        }
#pragma unroll
        for (int j = 0; j < kCo; ++j) {
#pragma unroll
          for (int i = 0; i < kCi; ++i) {
            dw[j][i] = fmaf(a[j].x, b[i].x, dw[j][i]);
            dw[j][i] = fmaf(a[j].y, b[i].y, dw[j][i]);
            dw[j][i] = fmaf(a[j].z, b[i].z, dw[j][i]);
            dw[j][i] = fmaf(a[j].w, b[i].w, dw[j][i]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCo; ++j) {
#pragma unroll
      for (int i = 0; i < kCi; ++i) {
        const int co = co0 + j * (C / kCo), ci = ci0 + i * (C / kCi);
        atomicAdd(gw + (co * C + ci) * kTaps + k, dw[j][i]);
      }
    }
  }
}

template <typename T, int C>
int launch_bwd(const void* x, const void* om, const void* weight,
               const void* gy, void* gx, void* gom, void* gw, int64_t total,
               int H, int W, cudaStream_t st) {
  constexpr int kPerBlock = kThreads * BwdTune<C>::kTiles;
  const int64_t blocks = (total + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffff) return kBadShape;
  deform_conv_bwd_kernel<T, C><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(weight), static_cast<const T*>(gy),
      static_cast<float*>(gx), static_cast<T*>(gom), static_cast<float*>(gw),
      total, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward. x, om, weight as the forward's; gy (N, H, W, C) the
// gradient of its output, of their dtype; gx (N, H, W, C) and gw (C, C, 3,
// 3) float32, zeroed by the caller, into which the gradients of x and the
// weight are added; gom (N, H, W, 27) of the dtype, which receives the
// gradient of om. All contiguous, x, gy and gx 16-byte aligned; C in {8,
// 16, 32}; dtype 0 float32, 1 bfloat16. Returns 0, a cudaError_t from the
// launch, or a negative code of sampling.cuh.
static int deform_conv_bwd_typed(const void* x, const void* om,
                                 const void* weight, const void* gy, void* gx,
                                 void* gom, void* gw, int N, int H, int W,
                                 int C, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(N) * H * W;
  const auto go = [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    return launch_bwd<T, decltype(c)::value>(x, om, weight, gy, gx, gom, gw,
                                             total, H, W, st);
  };
  if (dtype != 0 && dtype != 1) return kUnsupported;
  const bool f32 = dtype == 0;
  switch (C) {
    case 8: return f32 ? go(Type<float>{}, Int<8>{})
                       : go(Type<__nv_bfloat16>{}, Int<8>{});
    case 16: return f32 ? go(Type<float>{}, Int<16>{})
                        : go(Type<__nv_bfloat16>{}, Int<16>{});
    case 32: return f32 ? go(Type<float>{}, Int<32>{})
                        : go(Type<__nv_bfloat16>{}, Int<32>{});
    default: return kUnsupported;
  }
}

// deform_conv_bwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int deform_conv_bwd(const int64_t* args) {
  return cv::call_packed(deform_conv_bwd_typed, args);
}
