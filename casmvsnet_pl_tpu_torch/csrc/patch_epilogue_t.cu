// The 4x4 patch epilogue in the transposed, pixel-on-lanes layout, for
// Hopper (sm_90a).
//
// Replaces, on the TPU side: scripts/probe_epi5.py::_pallas_epi (pallas_call
// at :101, through pallas_epilogue at :119), TPU kernel #12, the probe of
// whether putting pixels on the lanes makes the patch sampler's hat-weight
// epilogue cheap.
//
// What it computes, for each group i of g consecutive depths, depth j of
// the group, channel c and pixel p, with Ch channels per split:
//   out[i, j, c, p] = sum_{dy, dx} hat(fx[i, j, p] - dx) * hat(fy[i, j, p] - dy)
//                                  * rowsT[i, (dy*4 + dx)*Ch + c, p],
//   hat(t) = max(0, 1 - |t|),
// over dy outer and dx inner in 0..3, as the probe's kernel sums them (fx
// is -9 at an invalid sample, so all its hats are 0). rowsT (n_i, 16 Ch,
// HW) f32 or bf16, fx and fy (n_i, g, HW) f32, out (n_i, g, Ch, HW) f32.
// Plain version: casmvsnet_pl_tpu_torch/probes/epi5.py::
// plain_patch_epilogue_t (the probe's "tfma" form in this layout).
//
// What bounds it on the card: bytes (rowsT, fx and fy read once, the f32
// output written once; 16 multiply-adds per output element). Pixels are
// the fast axis of every array, so a warp's loads and stores of one
// (row, pixel range) are coalesced without a transpose. One thread takes
// one (i, pixel) and a chunk of kCh channels: it builds the four x and four
// y hats of each of the g depths once (f32, in registers), then walks the
// 16 taps, loads the tap's kCh channel values once and adds them, weighted
// by hx * hy, into all g depths' sums. Every product and sum is rounded
// separately in the probe's order, so f32 equals the plain version to the
// last bit. Any HW runs: the ragged end of the pixels is masked.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kP = 4;        // patch height and width
constexpr int kCh = 4;       // channels per thread
constexpr int kThreads = 128;

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(t)));
}

// grid (ceil(HW / kThreads), Ch / kCh, n_i).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    patch_epilogue_t_kernel(const T* __restrict__ rowsT,
                            const float* __restrict__ fx,
                            const float* __restrict__ fy,
                            float* __restrict__ out, int Ch, int HW) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int c0 = blockIdx.y * kCh;
  const int64_t i = blockIdx.z;
  float hx[G][kP], hy[G][kP];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float x = __ldg(fx + (i * G + j) * HW + p);
    const float y = __ldg(fy + (i * G + j) * HW + p);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      hx[j][k] = hat(__fsub_rn(x, static_cast<float>(k)));
      hy[j][k] = hat(__fsub_rn(y, static_cast<float>(k)));
    }
  }
  float acc[G][kCh];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[j][c] = 0.f;
  }
  const T* base = rowsT + (i * kP * kP * Ch + c0) * HW + p;
#pragma unroll
  for (int dy = 0; dy < kP; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kP; ++dx) {
      const T* tap = base + static_cast<int64_t>(dy * kP + dx) * Ch * HW;
      float r[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        r[c] = to_float(tap[static_cast<int64_t>(c) * HW]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float w = __fmul_rn(hx[j][dx], hy[j][dy]);
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          acc[j][c] = __fadd_rn(acc[j][c], __fmul_rn(w, r[c]));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      out[((i * G + j) * Ch + c0 + c) * HW + p] = acc[j][c];
    }
  }
}

template <typename T, int G>
int launch(const void* rowsT, const void* fx, const void* fy, void* out,
           int n_i, int Ch, int HW, cudaStream_t stream) {
  const dim3 grid((HW + kThreads - 1) / kThreads, Ch / kCh, n_i);
  patch_epilogue_t_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(rowsT), static_cast<const float*>(fx),
      static_cast<const float*>(fy), static_cast<float*>(out), Ch, HW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_groups(const void* rowsT, const void* fx, const void* fy,
                  void* out, int n_i, int G, int Ch, int HW,
                  cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, 1>(rowsT, fx, fy, out, n_i, Ch, HW, stream);
    case 2: return launch<T, 2>(rowsT, fx, fy, out, n_i, Ch, HW, stream);
    case 4: return launch<T, 4>(rowsT, fx, fy, out, n_i, Ch, HW, stream);
    case 8: return launch<T, 8>(rowsT, fx, fy, out, n_i, Ch, HW, stream);
    default: return kUnsupported;
  }
}

}  // namespace

// rowsT (n_i, 16 Ch, HW) of dtype (0: float32, 1: bfloat16); fx, fy (n_i,
// G, HW) f32; out (n_i, G, Ch, HW) f32; all contiguous. G in {1, 2, 4, 8};
// Ch a positive multiple of 4. Returns 0, a cudaError_t from the launch, or
// a negative code of sampling.cuh.
static int patch_epilogue_t_fwd_typed(const void* rowsT, const void* fx,
                                      const void* fy, void* out, int n_i, int G,
                                      int Ch, int HW, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ch <= 0 || Ch % kCh) return kUnsupported;
  if (n_i > 65535 || Ch / kCh > 65535) return kBadShape;
  if (dtype == 0) {
    return launch_groups<float>(rowsT, fx, fy, out, n_i, G, Ch, HW, st);
  }
  if (dtype == 1) {
    return launch_groups<__nv_bfloat16>(rowsT, fx, fy, out, n_i, G, Ch, HW,
                                        st);
  }
  return kUnsupported;
}

// patch_epilogue_t_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int patch_epilogue_t_fwd(const int64_t* args) {
  return cv::call_packed(patch_epilogue_t_fwd_typed, args);
}
