// One LoFTR encoder layer of TransMVSNet's Feature Matching Transformer
// (models/fmt.py, ops/fmt_layer.py), d_model 32, 8 heads of 4, over the
// views of B scenes, updated in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no TransMVSNet. On the card
// the plain layer was ~25 PyTorch operators (Linear, elu, einsum, sum,
// repeat_interleave, LayerNorm, cat, ReLU, adds), each moving 16-40 MB of
// bf16, and its LayerNorms gave each 32-value token a block of its own.
//
// What it computes, for the token x (32 values) of query view n and its
// source sequence s (S tokens y):
//   q = x Wq^T, k = y Wk^T, v = y Wv^T, phi(a) = elu(a) + 1, per head h:
//   KV_h = sum_y phi(k_h)^T (v_h / S) (4 x 4), ksum_h = sum_y phi(k_h),
//   msg_h = phi(q_h) KV_h / (phi(q_h) . ksum_h + 1e-6) * S,
//   m1 = LayerNorm1(msg Wm^T), m2 = LayerNorm2(relu([x, m1] W0^T) W2^T),
//   x <- x + m2,
// Linear layers without bias, LayerNorms with weight and bias, eps 1e-5.
// A self layer (cross 0) takes every view as its own source; a cross layer
// (cross 1) takes view 0 of each scene as the source of its views 1..V-1
// and leaves view 0 as it is. Two launches a layer:
// - fmt_layer_kv_kernel, the reduction: blocks over 256 source tokens
//   each sum KV and ksum (160 floats) into a partial; the last block of a
//   sequence to finish (an integer counter, reset by that block) adds the
//   partials in a fixed order, so two calls give the same bits;
// - fmt_layer_apply_kernel, one pass over the query tokens: each reads its
//   x, computes its output and writes it into its own slot. A token reads
//   only its own x, and the reduction has finished before the pass starts,
//   so the update in place is safe.
// x is (B, V, L, 32) contiguous, float32 or bfloat16; the weights are of
// x's dtype. Plain version: ops/fmt_layer.py::plain_fmt_layer.
//
// What bounds it on the card: bytes. A token moves 64 bytes in and 64 out
// (bf16) for ~8.2 K multiply-adds of projections and MLP, 160 of attention
// and two LayerNorms; at the eval shape (5 views of 62,208 tokens, 8
// layers) 302.6 MB, 0.090 ms at 3.35 TB/s, against 42.8 GFLOP of products
// (0.043 ms on the tensor cores, 0.64 ms on the CUDA cores) and 1.1 GFLOP
// of attention (perfbench/counts/fmt_layer.py). So the products run on the
// tensor cores and nothing between them leaves the registers:
// - a warp owns 16 tokens; every product (q, k, v, merge, mlp.0, mlp.2) is
//   bf16 mma.sync m16n8k16 with float32 sums, and the sums of one product
//   are, as they lie in the registers, the A fragments of the next (the
//   16 x 8 C tiles 2 kk and 2 kk + 1 hold A's columns 16 kk .. 16 kk + 15);
// - every value fed to a product that is not bf16 already (the message,
//   LayerNorm1's output, the ReLU's, and a float32 x) goes in as bf16
//   hi + lo, and float32 weights as hi + lo too (hi lo products dropped),
//   so each product is that of the float32 values to ~2^-16 of its terms:
//   float32 between the operators, where the plain bf16 module rounds each
//   operator's output to bf16;
// - phi, the heads' 4 x 4 products (two lanes a head, one shuffle), both
//   LayerNorms (four lanes a token, two shuffles) and the residual run in
//   registers in float32; each output is rounded once to x's dtype;
// - the weights (10,240 values, bf16 in shared memory, rows padded by 8 so
//   the B fragments meet no bank conflict) are staged once a block, and a
//   block of the pass walks a contiguous range of 64-token units, its
//   source's KV in shared memory, over a grid that fills the card once,
//   each warp loading its next tile while it computes one;
// - a warp of the reduction loads its four tiles at once.
// Measured on the H100 at the eval shape (PERF.md, phase 56): 0.646 ms for
// the eight layers, against 13.71 for the plain layers and a bound of
// 0.090 (14 %): the reductions 0.19 ms, the passes 0.45. Builds that drop
// a part of the pass read the LayerNorms at 0.09 ms, the attention at
// 0.16, the MLP at 0.19; the lo halves of the split products cost 0.07.
// Reductions of 16 tiles a warp took 0.38 ms (each warp's tiles one after
// the other); independent products interleaved in the K loop, correctly
// rounded reciprocals, a cap of 102 registers (5 blocks an SM) and 8
// tiles a reduction warp gained 3 % at most or lost: the pass, at 4 warps
// a scheduler, waits on its own chains of dependent instructions.
#include "sampling.cuh"

namespace {

using namespace cv;
using bf16 = __nv_bfloat16;

constexpr int kC = 32;                       // d_model
constexpr int kHeads = 8;
constexpr int kDh = kC / kHeads;             // 4
constexpr int kKsum = kHeads * kDh * kDh;    // 128: KV_h[d][v], then ksum_h[d]
constexpr int kKV = kKsum + kHeads * kDh;    // 160 floats a source sequence
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                    // tokens a warp tile (mma's M)
constexpr int kUnit = kWarps * kRows;        // tokens a block of the pass takes
constexpr int kKvTiles = 4;                  // tiles a warp of the reduction
constexpr int kKvTokens = kUnit * kKvTiles;  // 256 tokens a reduction block
constexpr int kStripes = 3;                  // threads a float4 of the final sum
constexpr float kLnEps = 1e-5f;
constexpr float kAttnEps = 1e-6f;

// weights in shared memory, [n][k] with rows of k + 8 bf16
constexpr int kLd32 = kC + 8, kLd64 = 2 * kC + 8;
// the pass: q and merge (32 x 32), mlp.0 (64 x 64), mlp.2 (32 x 64)
constexpr int kOffQ = 0;
constexpr int kOffM = kOffQ + kC * kLd32;
constexpr int kOff0 = kOffM + kC * kLd32;
constexpr int kOff2 = kOff0 + 2 * kC * kLd64;
constexpr int kApplyW = kOff2 + kC * kLd64;
// the reduction: k and v (32 x 32)
constexpr int kOffK = 0;
constexpr int kOffV = kC * kLd32;
constexpr int kKvW = 2 * kC * kLd32;

template <typename T>
constexpr bool kF32 = std::is_same_v<T, float>;

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (a, b) = hi + lo: hi their bf16 rounding, lo the bf16 rounding of the rest
__device__ __forceinline__ void split(float a, float b, unsigned& hi,
                                      unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - f.x, b - f.y));
}

__device__ __forceinline__ float phi(float a) {
  return a > 0.f ? a + 1.f : expf(a);
}

// W (N, K) of T, row major and 16-byte aligned, into ws (its bf16
// rounding) and, for float32, ws + lo_stride (the bf16 rounding of the
// rest), rows of K + 8; 8 values a thread and step, every load of a thread
// in flight at once.
template <int N, int K, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ w, bf16* ws,
                                      int lo_stride) {
  constexpr int kSteps = N * K / 8;
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    if (s >= kSteps) break;
    bf16* dst = ws + (s / (K / 8)) * (K + 8) + (s % (K / 8)) * 8;
    if constexpr (kF32<T>) {
      const float4 a = reinterpret_cast<const float4*>(w)[2 * s];
      const float4 b = reinterpret_cast<const float4*>(w)[2 * s + 1];
      uint4 hi, lo;
      split(a.x, a.y, hi.x, lo.x);
      split(a.z, a.w, hi.y, lo.y);
      split(b.x, b.y, hi.z, lo.z);
      split(b.z, b.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(dst) = hi;
      *reinterpret_cast<uint4*>(dst + lo_stride) = lo;
    } else {
      *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>(w)[s];
    }
  }
}

// acc (16 x 8 NJ, C fragments) += A W^T for A (16 x 16 NK) given as A
// fragments hi (+ lo where kLo) and W's rows at w (+ the rest at
// w + lo_stride where kLoW, against A's hi), rows of ld.
template <bool kLo, bool kLoW, int NK, int NJ>
__device__ __forceinline__ void gemm(float (&acc)[NJ][4],
                                     const unsigned (&hi)[NK][4],
                                     const unsigned (&lo)[NK][4],
                                     const bf16* w, int lo_stride, int ld,
                                     int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* p = w + (j * 8 + g) * ld + kk * 16 + 2 * t;
      const unsigned b0 = *reinterpret_cast<const unsigned*>(p);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(p + 8);
      mma_bf16(acc[j], hi[kk], b0, b1);
      if constexpr (kLo) mma_bf16(acc[j], lo[kk], b0, b1);
      if constexpr (kLoW) {
        mma_bf16(acc[j], hi[kk],
                 *reinterpret_cast<const unsigned*>(p + lo_stride),
                 *reinterpret_cast<const unsigned*>(p + lo_stride + 8));
      }
    }
  }
}

// The A fragments (hi + lo) of the 16 x 16 NK values held as C fragments.
template <int NK>
__device__ __forceinline__ void to_a(const float (&c)[2 * NK][4],
                                     unsigned (&hi)[NK][4],
                                     unsigned (&lo)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      split(c[2 * kk + e][0], c[2 * kk + e][1], hi[kk][2 * e], lo[kk][2 * e]);
      split(c[2 * kk + e][2], c[2 * kk + e][3], hi[kk][2 * e + 1],
            lo[kk][2 * e + 1]);
    }
  }
}

// A lane's share of a tile of x: rows r0 (g) and r1 (g + 8), columns
// 8 j + 2 t and + 1 for j < 4, as stored.
template <typename T>
using Word = std::conditional_t<kF32<T>, float2, unsigned>;

template <typename T>
__device__ __forceinline__ void load_tile(const T* xs, int r0, int r1, int t,
                                          Word<T> (&raw)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* p = xs + static_cast<int64_t>(half ? r1 : r0) * kC + 8 * j +
                   2 * t;
      raw[j][half] = *reinterpret_cast<const Word<T>*>(p);
    }
  }
}

// The tile as A fragments (hi, and lo for float32) and as float32 values in
// the C layout of a 16 x 32 product.
template <typename T>
__device__ __forceinline__ void unpack_tile(const Word<T> (&raw)[4][2],
                                            unsigned (&hi)[2][4],
                                            unsigned (&lo)[2][4],
                                            float (&xf)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kk = j / 2, r = 2 * (j % 2) + half;
      float2 f;
      if constexpr (kF32<T>) {
        f = raw[j][half];
        split(f.x, f.y, hi[kk][r], lo[kk][r]);
      } else {
        hi[kk][r] = raw[j][half];
        lo[kk][r] = 0u;
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw[j][half]));
      }
      xf[j][2 * half] = f.x;
      xf[j][2 * half + 1] = f.y;
    }
  }
}

// LayerNorm over the 32 channels of each of the 16 rows of c (C layout: a
// row's channels on the four lanes of one g), weight w and bias b.
__device__ __forceinline__ void layer_norm(float (&c)[4][4],
                                           const float* w, const float* b,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += c[j][2 * half] + c[j][2 * half + 1];
    s += __shfl_xor_sync(~0u, s, 1);
    s += __shfl_xor_sync(~0u, s, 2);
    const float mean = s * (1.f / kC);
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = c[j][2 * half] - mean, e = c[j][2 * half + 1] - mean;
      var += a * a + e * e;
    }
    var += __shfl_xor_sync(~0u, var, 1);
    var += __shfl_xor_sync(~0u, var, 2);
    const float rstd = 1.f / sqrtf(var * (1.f / kC) + kLnEps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      c[j][2 * half] = (c[j][2 * half] - mean) * rstd * w[col] + b[col];
      c[j][2 * half + 1] =
          (c[j][2 * half + 1] - mean) * rstd * w[col + 1] + b[col + 1];
    }
  }
}

// The reduction. Block (i, s) sums tokens [256 i, 256 i + 256) of source
// sequence s, which starts at x + s * seq_stride tokens and holds L; the
// sequence's last block to finish writes kv[s], the partials' sum, KV_h
// divided by S there (once, in place of each v).
//
// A lane holds, of each 16 x 32 tile of k and v, rows g and g + 8 and, in
// each 8-column tile j, head h = 2 j + t / 2 at d = 2 (t % 2) and + 1: its
// own two values of v and, by one shuffle, its partner lane's (t ^ 1) two,
// so it sums KV_h[d][0..3] and ksum_h[d] for its two d's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fmt_layer_kv_kernel(const T* x, const T* __restrict__ wk,
                        const T* __restrict__ wv, float* __restrict__ partial,
                        int* __restrict__ count, float* __restrict__ kv,
                        int L, int64_t seq_stride) {
  constexpr int kParts = kF32<T> ? 2 : 1;
  __shared__ __align__(16) bf16 ws[kParts * kKvW];
  __shared__ float red[kWarps][kKV];
  __shared__ float4 stripe[kStripes][kKV / 4];
  __shared__ bool last;
  stage<kC, kC>(wk, ws + kOffK, kKvW);
  stage<kC, kC>(wv, ws + kOffV, kKvW);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int seq = blockIdx.y, nblk = gridDim.x;
  const T* xs = x + seq * seq_stride * kC;
  const float S = static_cast<float>(L);
  // [j][dd][e]: S KV_h[d0 + dd][own v d0 + e, partner's v (d0 ^ 2) + e]
  float own[4][2][2] = {}, other[4][2][2] = {}, ks[4][2] = {};

  // every tile of the warp on its way at once
  const int base = blockIdx.x * kKvTokens + warp * kRows;
  Word<T> raw[kKvTiles][4][2];
#pragma unroll
  for (int i = 0; i < kKvTiles; ++i) {
    const int row0 = base + i * kUnit;
    if (row0 < L) {
      load_tile(xs, min(row0 + g, L - 1), min(row0 + g + 8, L - 1), t,
                raw[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kKvTiles; ++i) {
    const int row0 = base + i * kUnit;
    if (row0 >= L) break;
    unsigned hi[2][4], lo[2][4];
    float xf[4][4];
    unpack_tile<T>(raw[i], hi, lo, xf);
    float k[4][4] = {}, v[4][4] = {};
    gemm<kF32<T>, kF32<T>>(k, hi, lo, ws + kOffK, kKvW, kLd32, g, t);
    gemm<kF32<T>, kF32<T>>(v, hi, lo, ws + kOffV, kKvW, kLd32, g, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool live = row0 + g + 8 * half < L;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f0 = live ? phi(k[j][2 * half]) : 0.f;
        const float f1 = live ? phi(k[j][2 * half + 1]) : 0.f;
        const float v0 = live ? v[j][2 * half] : 0.f;
        const float v1 = live ? v[j][2 * half + 1] : 0.f;
        const float o0 = __shfl_xor_sync(~0u, v0, 1);
        const float o1 = __shfl_xor_sync(~0u, v1, 1);
        own[j][0][0] += f0 * v0;
        own[j][0][1] += f0 * v1;
        own[j][1][0] += f1 * v0;
        own[j][1][1] += f1 * v1;
        other[j][0][0] += f0 * o0;
        other[j][0][1] += f0 * o1;
        other[j][1][0] += f1 * o0;
        other[j][1][1] += f1 * o1;
        ks[j][0] += f0;
        ks[j][1] += f1;
      }
    }
  }

  // the warp's sums over g (lanes t, t + 4, ..., t + 28), into red[warp]
  const auto warp_sum = [](float a) {
    a += __shfl_xor_sync(~0u, a, 4);
    a += __shfl_xor_sync(~0u, a, 8);
    return a + __shfl_xor_sync(~0u, a, 16);
  };
  const int d0 = 2 * (t & 1), dp = d0 ^ 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int h = 2 * j + t / 2;
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = d0 + dd;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = warp_sum(own[j][dd][e]);
        const float b = warp_sum(other[j][dd][e]);
        if (g == 0) {
          red[warp][h * 16 + d * 4 + d0 + e] = a;
          red[warp][h * 16 + d * 4 + dp + e] = b;
        }
      }
      const float s = warp_sum(ks[j][dd]);
      if (g == 0) red[warp][kKsum + h * 4 + d] = s;
    }
  }
  __syncthreads();
  float* mine = partial + (static_cast<int64_t>(seq) * nblk + blockIdx.x) * kKV;
  for (int i = threadIdx.x; i < kKV; i += kThreads) {
    float s = red[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][i];
    mine[i] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + seq, 1) == nblk - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials' sum in block order: thread i < 120 adds float4 column
  // i % 40 of blocks i / 40, + 3, + 6, ...; then the three stripes in order
  const float4* all = reinterpret_cast<const float4*>(
      partial + static_cast<int64_t>(seq) * nblk * kKV);
  if (threadIdx.x < kStripes * kKV / 4) {
    const int c = threadIdx.x % (kKV / 4), r = threadIdx.x / (kKV / 4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int b = r; b < nblk; b += kStripes) {
      const float4 p = __ldcg(all + b * (kKV / 4) + c);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    stripe[r][c] = s;
  }
  __syncthreads();
  const float* st = reinterpret_cast<const float*>(stripe);
  for (int i = threadIdx.x; i < kKV; i += kThreads) {
    float s = st[i];
#pragma unroll
    for (int r = 1; r < kStripes; ++r) s += st[r * kKV + i];
    kv[seq * kKV + i] = i < kKsum ? s / S : s;   // KV_h = sum phi(k) v / S
  }
  if (threadIdx.x == 0) count[seq] = 0;   // ready for the next launch
}

// The pass over the query tokens: query sequence i (of B (V - cross)) is
// view cross + i % (V - cross) of scene i / (V - cross), L tokens, with
// source sequence i (self) or i / (V - 1) (cross). Block b takes units
// [U b / grid, U (b + 1) / grid) of the U = sequences x ceil(L / 64) units
// of 64 tokens, a warp the unit's 16-token tile w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fmt_layer_apply_kernel(T* x, const T* __restrict__ wq,
                           const T* __restrict__ wm, const T* __restrict__ w0,
                           const T* __restrict__ w2,
                           const T* __restrict__ n1w, const T* __restrict__ n1b,
                           const T* __restrict__ n2w, const T* __restrict__ n2b,
                           const float* __restrict__ kv, int V, int L,
                           int cross, int64_t units, int units_per_seq) {
  constexpr int kParts = kF32<T> ? 2 : 1;
  constexpr bool kLoX = kF32<T>, kLoW = kF32<T>;
  __shared__ __align__(16) bf16 ws[kParts * kApplyW];
  __shared__ float ln[4][kC];     // norm1 weight, bias; norm2 weight, bias
  __shared__ float kvs[kKV];
  stage<kC, kC>(wq, ws + kOffQ, kApplyW);
  stage<kC, kC>(wm, ws + kOffM, kApplyW);
  stage<2 * kC, 2 * kC>(w0, ws + kOff0, kApplyW);
  stage<kC, 2 * kC>(w2, ws + kOff2, kApplyW);
  if (threadIdx.x < kC) {
    const int c = threadIdx.x;
    ln[0][c] = to_float(n1w[c]);
    ln[1][c] = to_float(n1b[c]);
    ln[2][c] = to_float(n2w[c]);
    ln[3][c] = to_float(n2b[c]);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int d0 = 2 * (t & 1), dp = d0 ^ 2;
  const int views = V - cross;
  const float S = static_cast<float>(L);
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t u1 = units * (blockIdx.x + 1) / gridDim.x;
  // unit u's source sequence and this warp's tile of it: its view's tokens
  // and first row (row0 >= L: the tile lies past the end)
  const auto locate = [&](int64_t u, int& src, T*& xs, int& row0) {
    const int seq = static_cast<int>(u / units_per_seq);
    const int unit = static_cast<int>(u - static_cast<int64_t>(seq) *
                                              units_per_seq);
    src = cross ? seq / (V - 1) : seq;
    xs = x + (static_cast<int64_t>(seq / views) * V + cross + seq % views) *
                 L * kC;
    row0 = unit * kUnit + warp * kRows;
  };
  int src = 0, row0 = L, src_now = -1;
  T* xs = x;
  Word<T> raw[4][2];
  if (u0 < u1) {
    locate(u0, src, xs, row0);
    if (row0 < L) {
      load_tile(xs, min(row0 + g, L - 1), min(row0 + g + 8, L - 1), t, raw);
    }
  }
#pragma unroll 1
  for (int64_t u = u0; u < u1; ++u) {
    if (src != src_now) {   // block-uniform
      __syncthreads();      // (the first time: the staged weights too)
      for (int i = threadIdx.x; i < kKV; i += kThreads) {
        kvs[i] = kv[src * kKV + i];
      }
      __syncthreads();
      src_now = src;
    }
    // the next unit's tile on its way while this one is computed
    int nsrc = src, nrow0 = L;
    T* nxs = xs;
    Word<T> nraw[4][2];
    if (u + 1 < u1) {
      locate(u + 1, nsrc, nxs, nrow0);
      if (nrow0 < L) {
        load_tile(nxs, min(nrow0 + g, L - 1), min(nrow0 + g + 8, L - 1), t,
                  nraw);
      }
    }
    if (row0 < L) {
      unsigned xh[2][4], xl[2][4];
      float xf[4][4];
      unpack_tile<T>(raw, xh, xl, xf);

      // q, phi(q) and each head's message
      float q[4][4] = {};
      gemm<kLoX, kLoW>(q, xh, xl, ws + kOffQ, kApplyW, kLd32, g, t);
      float m[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = 2 * j + t / 2;
        const float* kvh = kvs + h * 16;
        const float* ksh = kvs + kKsum + h * 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float f0 = phi(q[j][2 * half]), f1 = phi(q[j][2 * half + 1]);
          // this lane's d's against its own columns and its partner's
          const float a0 = f0 * kvh[d0 * 4 + d0] + f1 * kvh[(d0 + 1) * 4 + d0];
          const float a1 =
              f0 * kvh[d0 * 4 + d0 + 1] + f1 * kvh[(d0 + 1) * 4 + d0 + 1];
          const float o0 = f0 * kvh[d0 * 4 + dp] + f1 * kvh[(d0 + 1) * 4 + dp];
          const float o1 =
              f0 * kvh[d0 * 4 + dp + 1] + f1 * kvh[(d0 + 1) * 4 + dp + 1];
          const float den = f0 * ksh[d0] + f1 * ksh[d0 + 1];
          const float num0 = a0 + __shfl_xor_sync(~0u, o0, 1);
          const float num1 = a1 + __shfl_xor_sync(~0u, o1, 1);
          const float z =
              1.f / (den + __shfl_xor_sync(~0u, den, 1) + kAttnEps);
          m[j][2 * half] = num0 * z * S;
          m[j][2 * half + 1] = num1 * z * S;
        }
      }

      // merge, norm1
      unsigned ah[2][4], al[2][4];
      to_a<2>(m, ah, al);
      float n1[4][4] = {};
      gemm<true, kLoW>(n1, ah, al, ws + kOffM, kApplyW, kLd32, g, t);
      layer_norm(n1, ln[0], ln[1], t);

      // mlp.0 over [x, n1], ReLU, mlp.2, norm2
      float h0[8][4] = {};
      gemm<kLoX, kLoW>(h0, xh, xl, ws + kOff0, kApplyW, kLd64, g, t);
      to_a<2>(n1, ah, al);
      gemm<true, kLoW>(h0, ah, al, ws + kOff0 + kC, kApplyW, kLd64, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) h0[j][e] = fmaxf(h0[j][e], 0.f);
      }
      unsigned rh[4][4], rl[4][4];
      to_a<4>(h0, rh, rl);
      float o[4][4] = {};
      gemm<true, kLoW>(o, rh, rl, ws + kOff2, kApplyW, kLd64, g, t);
      layer_norm(o, ln[2], ln[3], t);

      // x + the message, into the token's own slot
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (row0 + g + 8 * half >= L) continue;
        T* p = xs + static_cast<int64_t>(row0 + g + 8 * half) * kC + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = xf[j][2 * half] + o[j][2 * half];
          const float e = xf[j][2 * half + 1] + o[j][2 * half + 1];
          if constexpr (kF32<T>) {
            *reinterpret_cast<float2*>(p + 8 * j) = make_float2(a, e);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
                __floats2bfloat162_rn(a, e);
          }
        }
      }
    }
    src = nsrc;
    xs = nxs;
    row0 = nrow0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) raw[j][half] = nraw[j][half];
    }
  }
}

template <typename T>
int launch(void* x, const void* wq, const void* wk, const void* wv,
           const void* wm, const void* w0, const void* w2, const void* n1w,
           const void* n1b, const void* n2w, const void* n2b, void* kv,
           void* partial, int64_t partial_len, void* count, int64_t count_len,
           int B, int V, int L, int cross, int phase, cudaStream_t st) {
  const int sources = cross ? B : B * V;
  if (phase == 0) {
    const int64_t nblk = (L + kKvTokens - 1) / kKvTokens;
    if (nblk > 0x7fffffff || sources > 65535) return kBadShape;
    if (partial_len < nblk * sources * kKV || count_len < sources) {
      return kBadShape;
    }
    fmt_layer_kv_kernel<T><<<dim3(static_cast<unsigned>(nblk), sources),
                             kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(wk),
        static_cast<const T*>(wv), static_cast<float*>(partial),
        static_cast<int*>(count), static_cast<float*>(kv), L,
        cross ? static_cast<int64_t>(V) * L : static_cast<int64_t>(L));
    return static_cast<int>(cudaGetLastError());
  }
  if (phase != 1) return kUnsupported;
  // a grid that fills the card once: every SM holds per_sm blocks
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fmt_layer_apply_kernel<T>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int units_per_seq = (L + kUnit - 1) / kUnit;
  const int64_t units =
      static_cast<int64_t>(B) * (V - cross) * units_per_seq;
  const int64_t fill = static_cast<int64_t>(per_sm) * sms;
  const int64_t blocks = units < fill ? units : fill;
  fmt_layer_apply_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              st>>>(
      static_cast<T*>(x), static_cast<const T*>(wq),
      static_cast<const T*>(wm), static_cast<const T*>(w0),
      static_cast<const T*>(w2), static_cast<const T*>(n1w),
      static_cast<const T*>(n1b), static_cast<const T*>(n2w),
      static_cast<const T*>(n2b), static_cast<const float*>(kv), V, L, cross,
      units, units_per_seq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, V, L, 32), updated in place; wq, wk, wv, wm (32, 32), w0 (64, 64),
// w2 (32, 64), n1w, n1b, n2w, n2b (32,): all of dtype (0: float32, 1:
// bfloat16), contiguous and 16-byte aligned. kv (sources, 160) float32, the
// reduction's result; partial (partial_len floats) its per-block partials;
// count (count_len int32, zero, and left zero) its counters; sources = B
// (cross) or B V. phase 0 launches the reduction, 1 the pass; the caller
// launches both, in that order, on one stream. Returns 0, a cudaError_t
// from the launch, or a negative code of sampling.cuh.
static int fmt_layer_fwd_typed(void* x, const void* wq, const void* wk,
                               const void* wv, const void* wm, const void* w0,
                               const void* w2, const void* n1w,
                               const void* n1b, const void* n2w,
                               const void* n2b, void* kv, void* partial,
                               int64_t partial_len, void* count,
                               int64_t count_len, int B, int V, int L,
                               int cross, int phase, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || V < 1 + cross || (cross != 0 && cross != 1)) {
    return kBadShape;
  }
  if (dtype == 0) {
    return launch<float>(x, wq, wk, wv, wm, w0, w2, n1w, n1b, n2w, n2b, kv,
                         partial, partial_len, count, count_len, B, V, L,
                         cross, phase, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, wq, wk, wv, wm, w0, w2, n1w, n1b, n2w,
                                 n2b, kv, partial, partial_len, count,
                                 count_len, B, V, L, cross, phase, st);
  }
  return kUnsupported;
}

// fmt_layer_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int fmt_layer_fwd(const int64_t* args) {
  return cv::call_packed(fmt_layer_fwd_typed, args);
}
