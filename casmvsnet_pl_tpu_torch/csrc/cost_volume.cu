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
// What bounds it on the card: instruction issue, then the tap gathers'
// latency; its byte bound (each input read once, the volume written once)
// lies far below either. The float32 arithmetic has to be the plain
// version's, rounded step by step: per channel and source view 4 bf16
// converts, 4 products and 3 sums for the bilinear sample (no FMA may
// contract them) and 3 more for the variance; per sample the projection,
// its reciprocal and the tap weights. At the default config's B=1 levels
// that is ~0.13 ms of issue at one instruction a clock on every scheduler,
// against a 0.072 ms byte bound (PERF.md §6). The design cuts what
// comes on top of that floor:
//
// - Layout: an item = (b, pixel) at one or more depths; a lane holds 16
//   consecutive channels (C = 32: two neighbouring lanes an item), so the
//   projection and the tap weights serve 16 channels, and a warp's tap
//   load reads whole 32-byte chunks of neighbouring rows.
// - Depths a thread, warps along depth and registers, per channel count
//   (Tune): two depths a thread at C = 32 and 8 (the reference, depth and
//   R (x, y, 1) loaded or computed once, two samples' loads in flight); at
//   C = 16 the four warps of a block take consecutive depths of the same
//   pixels, whose footprints move by a fraction of a pixel from one depth
//   to the next, so the L1 serves the later warps; the blocks an SM asked
//   of the register allocator set how many warps hide the gathers.
// - A tap outside the image reads pixel 0 with weight 0, as the plain
//   version does, with no branch: every lane issues its 4 tap loads at
//   once.
// Designs measured and lost (PERF.md §6): one 16-byte chunk a lane
// (the projection repeated on 2-4 lanes), the projection computed by one
// lane of an item and shuffled, 4 or 8 depths a thread (registers,
// spills), both source views' taps loaded together (V = 3 compiled),
// shared-memory tiles of the source footprint (the staging, two barriers
// and a per-tap test cost more than the L1 hits they replace), 256
// threads a block.
//
// Numerics match the plain PyTorch version (ops/plane_sweep.py::
// plain_cost_volume) to the last bit in float32, for variance and every
// group count: the projection, taps and combine round every product and
// sum separately, in the plain version's order, and a group's channels
// are summed in the order of torch's CUDA warp reduction (Reduce.cuh::
// block_x_reduce: offsets halving, across lanes first).
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Tuned per channel count on the H100 at the default config's levels (C =
// 32, 16, 8 at L2, L1, L0; bf16; probes/k1.py): depths a thread, whether
// all of a thread's tap loads are issued before any is used, warps of a
// block along depth, and the blocks an SM asked of the register allocator.
template <int C>
struct Tune {
  static constexpr int kDepths = C == 16 ? 1 : 2;
  static constexpr bool kPhased = C == 8;
  static constexpr int kWarpDepths = C == 16 ? 4 : 1;
  static constexpr int kMinBlocks = C == 32 ? 4 : C == 16 ? 7 : 6;
};

// A sample's 4 taps in the plain version's order (y0x0, y0x1, y1x0, y1x1):
// the pixel index of each and its weight; a tap outside the image reads
// pixel 0 with weight 0, as ops/grid_sample.py::_taps does.
struct Taps {
  int q[4];
  float w[4];
};

// The taps of source coordinates (sx, sy).
__device__ __forceinline__ Taps taps_at(float sx, float sy, int H, int W) {
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx1 = __fsub_rn(sx, x0), wy1 = __fsub_rn(sy, y0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  // the tests on the float coordinates, as the plain version's
  const bool cx0 = x0 >= 0.f && x0 <= static_cast<float>(W - 1);
  const bool cx1 = x0 >= -1.f && x0 <= static_cast<float>(W - 2);
  const bool cy0 = y0 >= 0.f && y0 <= static_cast<float>(H - 1);
  const bool cy1 = y0 >= -1.f && y0 <= static_cast<float>(H - 2);
  // In range wherever a tap is used (x0, y0 in [-1, W-1] x [-1, H-1]);
  // elsewhere saturated (__float2int_rz) and wrapped (unsigned), so never
  // undefined. (Builds that converted with static_cast, undefined out of
  // range in C++, read illegal addresses in two of twelve configurations.)
  const int q0 = static_cast<int>(
      static_cast<unsigned>(__float2int_rz(y0)) * static_cast<unsigned>(W) +
      static_cast<unsigned>(__float2int_rz(x0)));
  Taps t;
  t.q[0] = cx0 && cy0 ? q0 : 0;
  t.q[1] = cx1 && cy0 ? q0 + 1 : 0;
  t.q[2] = cx0 && cy1 ? q0 + W : 0;
  t.q[3] = cx1 && cy1 ? q0 + W + 1 : 0;
  t.w[0] = cx0 && cy0 ? __fmul_rn(wy0, wx0) : 0.f;
  t.w[1] = cx1 && cy0 ? __fmul_rn(wy0, wx1) : 0.f;
  t.w[2] = cx0 && cy1 ? __fmul_rn(wy1, wx0) : 0.f;
  t.w[3] = cx1 && cy1 ? __fmul_rn(wy1, wx1) : 0.f;
  return t;
}

// Source coordinates of a pixel at depth dep, from its depth-independent
// rotation rot = R (x, y, 1) and the translation tr, rounded as
// sampling.cuh::project (ops/geometry.py::project_to_src).
__device__ __forceinline__ void project_rot(const float (&rot)[3],
                                            const float (&tr)[3], float dep,
                                            int H, int W, float& sx,
                                            float& sy) {
  float n[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = __fadd_rn(__fmul_rn(rot[i], dep), tr[i]);
  sx = static_cast<float>(W);
  sy = static_cast<float>(H);
  if (!(n[2] <= __fmul_rn(1e-7f, dep))) {
    const float r = __frcp_rn(n[2]);
    sx = __fmul_rn(n[0], r);
    sy = __fmul_rn(n[1], r);
  }
}

// R (x, y, 1) and the translation of source view v of sample b.
__device__ __forceinline__ void view_constants(const float* __restrict__ proj,
                                               int64_t b, int V, int v,
                                               float xf, float yf,
                                               float (&rot)[3],
                                               float (&tr)[3]) {
  const float* P = proj + (b * (V - 1) + (v - 1)) * 12;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rot[i] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(P + 4 * i), xf),
                                 __fmul_rn(__ldg(P + 4 * i + 1), yf)),
                       __ldg(P + 4 * i + 2));
    tr[i] = __ldg(P + 4 * i + 3);
  }
}

// p[0] = the sum of p[0..N) in the order of torch's warp reduction:
// offsets halving, p[i] += p[i + N/2], then N/4, ...
template <int N>
__device__ __forceinline__ void tree_sum(float* p) {
#pragma unroll
  for (int off = N / 2; off > 0; off /= 2) {
#pragma unroll
    for (int i = 0; i < off; ++i) p[i] = __fadd_rn(p[i], p[i + off]);
  }
}

// Stores N values as T at p, in 16-byte stores where N fills them, else in
// one store of 4 or 8 bytes, else one by one.
template <typename T, int N>
__device__ __forceinline__ void store_vals(T* __restrict__ p,
                                           const float (&v)[N]) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    store_row<T, N>(p, v);
  } else if constexpr (kBytes == 8 || kBytes == 4) {
    using U = std::conditional_t<kBytes == 8, uint2, unsigned>;
    U raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = from_float<T>(v[k]);
    *reinterpret_cast<U*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = from_float<T>(v[k]);
  }
}

// The sums of one item: kLanes neighbouring lanes, a lane kCh consecutive
// channels (kM 16-byte chunks), at kDepths consecutive depths.
// G == 1: variance over the V views. G > 1: groupwise correlation.
template <typename T, int C, int G>
struct Item {
  static_assert(C % G == 0, "groups must divide C");
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kCh = C < 16 ? C : 16;
  static constexpr int kM = kCh / kVec;
  static constexpr int kLanes = C / kCh;
  static constexpr int kDepths = Tune<C>::kDepths;
  static constexpr bool kVariance = G == 1;
  static constexpr int kPer = C / G;           // channels of a group
  // groupwise: groups a lane holds whole, or lanes a group spans
  static constexpr int kGroups = kPer <= kCh ? kCh / kPer : 1;
  static constexpr int kSpan = kPer > kCh ? kPer / kCh : 1;
  static_assert(kCh % kVec == 0 && 32 % kLanes == 0, "bad C");

  float ref[kCh];
  float s[kVariance ? kDepths : 1][kCh], sq[kVariance ? kDepths : 1][kCh];
  float acc[kVariance ? 1 : kDepths][kGroups];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kDepths; ++j) {
      if constexpr (kVariance) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          s[j][c] = ref[c];
          sq[j][c] = __fmul_rn(ref[c], ref[c]);
        }
      } else {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) acc[j][g] = 0.f;
      }
    }
  }

  // Adds depth j's sample of one source view, from its 4 taps' raw
  // 16-byte chunks and weights.
  __device__ __forceinline__ void add(int j, const uint4 (&raw)[4][kM],
                                      const float (&w)[4]) {
    // o = ((t0 + t1) + t2) + t3, t_k = tap_k * w_k (grid_sample_batched)
    float o[kCh];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const T* e = reinterpret_cast<const T*>(&raw[k][m]);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float t = __fmul_rn(to_float(e[c]), w[k]);
          o[m * kVec + c] = k == 0 ? t : __fadd_rn(o[m * kVec + c], t);
        }
      }
    }
    if constexpr (kVariance) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        s[j][c] = __fadd_rn(s[j][c], o[c]);
        sq[j][c] = __fadd_rn(sq[j][c], __fmul_rn(o[c], o[c]));
      }
    } else {
      const float inv_per = 1.f / kPer;
      float p[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) p[c] = __fmul_rn(o[c], ref[c]);
      if constexpr (kSpan > 1) {
        // halving offsets: across the group's lanes first, element-wise
#pragma unroll
        for (int off = kSpan / 2; off > 0; off /= 2) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            p[c] = __fadd_rn(p[c], __shfl_down_sync(kFull, p[c], off, kSpan));
          }
        }
        tree_sum<kCh>(p);
        acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(p[0], inv_per));
      } else {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          tree_sum<kPer>(p + g * kPer);
          acc[j][g] = __fadd_rn(acc[j][g], __fmul_rn(p[g * kPer], inv_per));
        }
      }
    }
  }

  // Writes depths d0.. (those below D) of pixel pix.
  __device__ __forceinline__ void store(T* __restrict__ out, int64_t b,
                                        int d0, int D, int64_t HW,
                                        int64_t pix, int chunk, int V) {
    const float inv_v = __frcp_rn(static_cast<float>(V));
    const float inv_src = __frcp_rn(static_cast<float>(V - 1));
#pragma unroll
    for (int j = 0; j < kDepths; ++j) {
      if (d0 + j >= D) break;
      const int64_t row = (b * D + d0 + j) * HW + pix;
      if constexpr (kVariance) {
        float res[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const float m = __fmul_rn(s[j][c], inv_v);
          res[c] = __fsub_rn(__fmul_rn(sq[j][c], inv_v), __fmul_rn(m, m));
        }
        store_vals<T, kCh>(out + row * C + chunk * kCh, res);
      } else if constexpr (kSpan > 1) {
        if (chunk % kSpan == 0) {
          const float r[1] = {__fmul_rn(acc[j][0], inv_src)};
          store_vals<T, 1>(out + row * G + chunk / kSpan, r);
        }
      } else {
        float res[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          res[g] = __fmul_rn(acc[j][g], inv_src);
        }
        store_vals<T, kGroups>(out + row * G + chunk * kGroups, res);
      }
    }
  }
};

template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads, Tune<C>::kMinBlocks)
    cost_volume_kernel(const T* __restrict__ feats,
                       const float* __restrict__ proj,
                       const float* __restrict__ depth, T* __restrict__ out,
                       int V, int H, int W, int D) {
  using It = Item<T, C, G>;
  constexpr int kCh = It::kCh, kM = It::kM, kLanes = It::kLanes;
  constexpr int kDepths = It::kDepths;
  constexpr bool kPhased = Tune<C>::kPhased;
  constexpr int kPixWarps = kThreads / 32 / Tune<C>::kWarpDepths;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = lane % kLanes;
  const int64_t item = (static_cast<int64_t>(blockIdx.x) * kPixWarps +
                        warp % kPixWarps) * (32 / kLanes) + lane / kLanes;
  const bool live = item < HW;  // the tail's lanes compute pixel HW-1, for
  const int64_t pix = live ? item : HW - 1;  // the shuffles, and store none
  const int64_t b = blockIdx.z;
  const int d0 = (blockIdx.y * Tune<C>::kWarpDepths + warp / kPixWarps) *
                 kDepths;
  const float xf = static_cast<float>(pix % W);
  const float yf = static_cast<float>(pix / W);

  const int64_t view = HW * C;
  const T* fb = feats + b * V * view + chunk * kCh;
  It it;
  load_row<T, kCh>(fb + pix * C, it.ref);
  it.init();
  float dep[kDepths];
#pragma unroll
  for (int j = 0; j < kDepths; ++j) {
    dep[j] = __ldg(depth + (b * D + min(d0 + j, D - 1)) * HW + pix);
  }

  for (int v = 1; v < V; ++v) {
    float rot[3], tr[3];
    view_constants(proj, b, V, v, xf, yf, rot, tr);
    const uint4* src = reinterpret_cast<const uint4*>(fb + v * view);
    Taps taps[kDepths];
    uint4 raw[kPhased ? kDepths : 1][4][kM];
#pragma unroll
    for (int j = 0; j < kDepths; ++j) {
      float sx, sy;
      project_rot(rot, tr, dep[j], H, W, sx, sy);
      taps[j] = taps_at(sx, sy, H, W);
      auto& r = raw[kPhased ? j : 0];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          r[k][m] = __ldg(src + taps[j].q[k] * (C / It::kVec) + m);
        }
      }
      if constexpr (!kPhased) it.add(j, r, taps[j].w);
    }
    if constexpr (kPhased) {
#pragma unroll
      for (int j = 0; j < kDepths; ++j) it.add(j, raw[j], taps[j].w);
    }
  }
  if (live) it.store(out, b, d0, D, HW, pix, chunk, V);
}

template <typename T, int C, int G>
int launch(const void* feats, const void* proj, const void* depth, void* out,
           int B, int V, int H, int W, int D, cudaStream_t stream) {
  using It = Item<T, C, G>;
  // a block: kThreads / 32 warps, kWarpDepths of them along depth
  constexpr int kItems =
      kThreads / 32 / Tune<C>::kWarpDepths * (32 / It::kLanes);
  constexpr int kBlockDepths = It::kDepths * Tune<C>::kWarpDepths;
  const int64_t blocks = (static_cast<int64_t>(H) * W + kItems - 1) / kItems;
  const int64_t dblocks = (static_cast<int64_t>(D) + kBlockDepths - 1) /
                          kBlockDepths;
  if (blocks > 0x7fffffff || dblocks > 65535 || B > 65535) return kBadShape;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(dblocks), B);
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
static int cost_volume_fwd_typed(const void* feats, const void* proj,
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

// cost_volume_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int cost_volume_fwd(const int64_t* args) {
  return cv::call_packed(cost_volume_fwd_typed, args);
}

extern "C" const char* cost_volume_error_string(int code) {
  if (code == cv::kUnsupported) return "unsupported (dtype, C, groups)";
  if (code == cv::kBadShape) return "shape exceeds the launch grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
