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
//   dx(q_t)      += m_k w_t u_k(p)           (the scatter: 36 shares a pixel)
//   d dy_k(p)     = m_k sum_t dw_t/dsy (u_k . x(q_t)), d dx_k likewise
//   d om[18 + k]  = (sum_t w_t (u_k . x(q_t))) m_k (1 - m_k)
//   dW[co, ci, k] = sum_p gy(p, co) m_k s_k(p, ci)
// Taps outside the image read zero and get nothing, as in the forward; the
// bilinear weights are differentiated as the plain version's autograd does
// (floor's gradient zero). Every product is formed and summed in float32.
//
// Layout: a block owns a tile of kTH x kTW output pixels of one image and
// does all 9 taps for it, C / 8 threads a pixel (8 channels each, 256
// threads at every C); blocks stay resident and walk the tiles (a grid that
// fills the card once). The tile's gy and its 27-channel offset/mask rows
// are read once, coalesced, into shared memory; the offset/mask gradients
// replace them there tap by tap and leave as one coalesced store a tile.
// W_k is staged a tap. dW sums in shared memory over every tile of the
// block (each element owned by one thread; a group's parts reduced by
// halving shuffles) and goes out with one float32 atomic an element a
// block.
//
// The scatter, binned by destination. A tap sends a pixel's 4 shares (C
// floats each) to the 2 x 2 block of pixels at its sample's top-left tap,
// so a (pixel, tap) is one entry, binned by that top-left pixel. The bins
// cover the window, the tile plus a halo of kR pixels, and are lists in
// shared memory: a head a bin and a next a pixel, an entry pushed with one
// integer shared-memory atomicExch (native on sm_90); the entry's u_k and
// (fy, fx, m_k) stay in shared memory. After a barrier the threads of each
// bin's head pixel walk its list once, summing the entries' shares to each
// pixel t of the block (u_k m_k w_t, w_t from the fractions as corners_at
// forms it) in float32 registers, and add the 4 sums to the window's float32
// sums in shared memory, one t between barriers: no two bins share their
// t-th pixel, so no two threads add to one sum. After the 9 taps each
// destination inside the image with a nonzero sum goes to dx as float4
// atomics, 4 channels each: ~(tile + halo) / tile adds a pixel where every
// share made one. An entry whose block falls outside the window (a large
// offset) spills: its taps inside the image go to dx as float4 atomics, as
// every share did in the first design, so the result is exact for any
// offset. kR is chosen by C against the ARF's offsets (PERF.md: under 1 %
// of the training cell's shares spill). The spilled shares, all shares and
// the windows' floats added to dx are counted (counts, once a block).
// Lists, not a count, a prefix sum and slots: a list needs one atomic an
// entry and no scan. The window's sums are summed a tap at a time, so the
// shares of all 9 taps (36 C floats a pixel) never sit in shared memory at
// once.
// Not used: float atomicAdd into shared memory, which sm_90 compiles to a
// compare-and-swap loop (cost_volume_bwd.cu's notes: measured and lost).
// Measured and lost (PERF.md row DB): the first design, the taps outermost
// and a pixel's 36 C shares as global float4 atomics at the L2's atomic
// rate (8.2 ms at C = 8: 4.5 ms of atomics, 1.3 ms of 27 strided 2-byte
// stores a pixel); a thread a pixel at every C (C = 32 at 4 warps an SM,
// 1.41 ms against 0.97); a thread a destination pulling the 4 bins that
// cover it, which reads each entry 4 times (2.38 ms at C = 8 against
// 2.04), also with the 4 lists walked side by side (no gain).
//
// What bounds it now: latency, not a unit. At C = 8 it issues at ~30 % of
// the SMs' rate: a tap is a chain (the offsets from shared memory, the
// taps' loads, the dots, then the bins) behind 5 barriers, and shared
// memory (and, at C = 32, registers) leave 16-24 warps an SM.
// Summation order: a bin's entries are summed in the order of the
// atomicExch, and the windows and spills add into dx by atomics in an order
// that changes from run to run, so dx and dW agree with the plain version
// to rounding, and from run to run to rounding, not to the bit.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kTaps = 9;
constexpr int kOm = 27;         // offset (18) and mask (9) channels
constexpr int kCh = 8;          // channels a thread

// Tile (kTH x kTW pixels, C / kCh threads each, 256 threads a block at
// every C), halo kR, dW's (co, ci) a thread (kCo x kCi), the shared rows'
// stride pad (no bank conflicts in the dW contraction's 16-byte loads), and
// the blocks an SM that the block's shared memory leaves room for.
template <int C>
struct BwdTune;
template <>
struct BwdTune<8> {
  static constexpr int kTH = 16, kTW = 16, kR = 4, kCo = 2, kCi = 2, kPad = 4;
  static constexpr int kBlocks = 3;
};
template <>
struct BwdTune<16> {
  static constexpr int kTH = 8, kTW = 16, kR = 3, kCo = 2, kCi = 2,
                       kPad = 16;
  static constexpr int kBlocks = 3;
};
template <>
struct BwdTune<32> {
  static constexpr int kTH = 8, kTW = 8, kR = 3, kCo = 4, kCi = 4, kPad = 16;
  static constexpr int kBlocks = 2;
};

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// The block's shared memory, in bytes from its start (each region 16-byte
// aligned).
template <typename T, int C>
struct BwdLayout {
  using Tune = BwdTune<C>;
  static constexpr int kTH = Tune::kTH, kTW = Tune::kTW, kR = Tune::kR;
  static constexpr int kP = kTH * kTW;               // pixels
  static constexpr int kS = C / kCh;                 // threads a pixel
  static constexpr int kThreads = kP * kS;
  static constexpr int kDH = kTH + 2 * kR, kDW = kTW + 2 * kR;  // window
  static constexpr int kDests = kDH * kDW;
  static constexpr int kBW = kDW - 1;                // bins: top-left taps
  static constexpr int kBins = (kDH - 1) * kBW;
  static constexpr int kStride = kP + Tune::kPad;    // a [c][pixel] row
  static constexpr int kDws = 0;                     // float [9][C][C]
  static constexpr int kWs = kDws + 4 * kTaps * C * C;      // float [C][C]
  static constexpr int kGys = kWs + 4 * C * C;       // float [C][kStride]
  static constexpr int kCol = kGys + 4 * C * kStride;  // float [C][kStride]
  static constexpr int kU = kCol + 4 * C * kStride;  // float [kP][C]
  static constexpr int kAcc = kU + 4 * kP * C;       // float [kDests][C]
  static constexpr int kPf = kAcc + 4 * kDests * C;  // float4 [kP]
  static constexpr int kOmS = kPf + 16 * kP;         // T [kP][27]
  static constexpr int kHead =                       // int [2][kBins]
      kOmS + align16(kP * kOm * static_cast<int>(sizeof(T)));
  static constexpr int kNext = kHead + align16(4 * 2 * kBins);  // int [kP]
  static constexpr int kBytes = kNext + align16(4 * kP);
};

template <typename T, int C>
__global__ void __launch_bounds__(BwdLayout<T, C>::kThreads,
                                  BwdTune<C>::kBlocks)
    deform_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ om,
                           const T* __restrict__ weight,
                           const T* __restrict__ gy, float* __restrict__ gx,
                           T* __restrict__ gom, float* __restrict__ gw,
                           unsigned long long* __restrict__ counts, int H,
                           int W, int tiles_x, int64_t tiles_img,
                           int64_t tiles) {
  using L = BwdLayout<T, C>;
  using Tune = BwdTune<C>;
  constexpr int kTH = L::kTH, kTW = L::kTW, kR = L::kR, kP = L::kP;
  constexpr int kS = L::kS, kThreads = L::kThreads;
  constexpr int kDW = L::kDW, kBW = L::kBW, kBins = L::kBins;
  constexpr int kDests = L::kDests, kStride = L::kStride;
  constexpr int kCo = Tune::kCo, kCi = Tune::kCi;
  constexpr int kGroups = (C / kCo) * (C / kCi);   // (co, ci) blocks
  static_assert(kThreads % kGroups == 0, "bad dW tiling");
  constexpr int kParts = kThreads / kGroups;       // threads a block shares
  static_assert(kParts <= 32 && 32 % kParts == 0, "parts span one warp");
  static_assert(kP % (4 * kParts) == 0, "parts take whole quads");
  static_assert(32 % kS == 0, "a pixel's threads span one warp");
  extern __shared__ __align__(16) unsigned char smem[];
  float* dws = reinterpret_cast<float*>(smem + L::kDws);
  float* ws = reinterpret_cast<float*>(smem + L::kWs);
  float* gys = reinterpret_cast<float*>(smem + L::kGys);
  float* col = reinterpret_cast<float*>(smem + L::kCol);
  float* us = reinterpret_cast<float*>(smem + L::kU);
  float* acc = reinterpret_cast<float*>(smem + L::kAcc);
  float4* pf = reinterpret_cast<float4*>(smem + L::kPf);
  T* oms = reinterpret_cast<T*>(smem + L::kOmS);
  int* heads = reinterpret_cast<int*>(smem + L::kHead);
  int* next = reinterpret_cast<int*>(smem + L::kNext);
  __shared__ unsigned long long block_counts[3];

  const int tid = threadIdx.x;
  // this thread's pixel of the tile and its kCh channels from c0; the
  // pixel's kS threads are neighbouring lanes (mask: those lanes)
  const int pix = tid / kS, c0 = (tid % kS) * kCh;
  const bool first_slice = tid % kS == 0;
  const unsigned lanes = (kS == 32 ? 0xffffffffu : (1u << kS) - 1u)
                         << ((tid % 32) / kS * kS);
  const int ty_in = pix / kTW, tx_in = pix - ty_in * kTW;
  const int part = tid % kParts, grp = tid / kParts;
  // this thread's (co, ci) of dW: co = co0 + j C / kCo, ci = ci0 + i C / kCi
  const int co0 = grp / (C / kCi), ci0 = grp % (C / kCi);
  unsigned spilled = 0, shares = 0, adds = 0;

  for (int i = tid; i < kTaps * C * C; i += kThreads) dws[i] = 0.f;
  if (tid < 3) block_counts[tid] = 0;

#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t n = tile / tiles_img;
    const int64_t rest = tile - n * tiles_img;
    const int ty = static_cast<int>(rest / tiles_x) * kTH;
    const int tx = static_cast<int>(rest % tiles_x) * kTW;
    const int ph = ty + ty_in, pw = tx + tx_in;
    const bool live = ph < H && pw < W;
    const int64_t img = n * H;                      // the image's first row
    const int64_t p = (img + ph) * W + pw;
    const int rows = min(kTH, H - ty), row_len = min(kTW, W - tx) * kOm;

    __syncthreads();   // the last tile's readers of the shared rows are done
    for (int i = tid; i < kTH * kTW * kOm; i += kThreads) {
      const int r = i / (kTW * kOm), j = i - r * (kTW * kOm);
      if (r < rows && j < row_len) {
        oms[i] = om[((img + ty + r) * W + tx) * kOm + j];
      }
    }
    {
      float g[kCh];
      if (live) {
        load_row<T, kCh>(gy + p * C + c0, g);
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) g[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kCh; ++c) gys[(c0 + c) * kStride + pix] = g[c];
    }
    for (int i = tid; i < kDests * C / 4; i += kThreads) {
      reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < 2 * kBins; i += kThreads) heads[i] = -1;
    for (int i = tid; i < C * C; i += kThreads) {
      ws[i] = to_float(weight[i * kTaps]);
    }
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < kTaps; ++k) {
      int* head = heads + (k & 1) * kBins;
      int bin = -1;        // this pixel's bin, if it has one
      // --- kS threads a pixel, kCh channels each: the tap's sample, its
      // dots, the offset and mask gradients, u_k, and the entry (binned or
      // spilled)
      if (live) {
        const int ki = k / 3, kj = k - 3 * (k / 3);
        T* o = oms + pix * kOm;
        const float dy = to_float(o[2 * k]), dx = to_float(o[2 * k + 1]);
        const float m = 1.f / (1.f + expf(-to_float(o[18 + k])));
        const float sy = static_cast<float>(ph - 1 + ki) + dy;
        const float sx = static_cast<float>(pw - 1 + kj) + dx;
        const Corners cn = corners_at(sy, sx, H, W);
        // u = W_k^T gy, this thread's channels
        float u[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) u[c] = 0.f;
#pragma unroll
        for (int co = 0; co < C; ++co) {
          const float gv = gys[co * kStride + pix];
          const float4* w4 = reinterpret_cast<const float4*>(ws + co * C + c0);
#pragma unroll
          for (int c4 = 0; c4 < kCh / 4; ++c4) {
            const float4 w = w4[c4];
            u[4 * c4] = fmaf(w.x, gv, u[4 * c4]);
            u[4 * c4 + 1] = fmaf(w.y, gv, u[4 * c4 + 1]);
            u[4 * c4 + 2] = fmaf(w.z, gv, u[4 * c4 + 2]);
            u[4 * c4 + 3] = fmaf(w.w, gv, u[4 * c4 + 3]);
          }
        }
        // the entry's bin: its top-left tap's place in the window (the
        // float tests keep far-outside or NaN coordinates out)
        const float by = floorf(sy) - static_cast<float>(ty - kR);
        const float bx = floorf(sx) - static_cast<float>(tx - kR);
        const bool binned = by >= 0.f && by <= static_cast<float>(L::kDH - 2)
                            && bx >= 0.f && bx <= static_cast<float>(kBW - 1);
        // the tap weights' derivatives by sy and sx (order y0x0, y0x1,
        // y1x0, y1x1, as corners_at's)
        const float fy = cn.fy, fx = cn.fx;
        const float dby[4] = {-(1.f - fx), -fx, 1.f - fx, fx};
        const float dbx[4] = {-(1.f - fy), 1.f - fy, -fy, fy};
        const T* src = x + n * H * W * C + c0;
        float* gsrc = gx + n * H * W * C + c0;
        float s[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c) s[c] = 0.f;
        float ddy = 0.f, ddx = 0.f, dm = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool in = cn.in[t];
          float v[kCh];
          load_row<T, kCh>(src + static_cast<int64_t>(cn.q[t]) * C, v);
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            s[c] = fmaf(v[c], cn.w[t], s[c]);
            dot = fmaf(u[c], v[c], dot);
          }
          if (!in) dot = 0.f;
          ddy = fmaf(dby[t], dot, ddy);
          ddx = fmaf(dbx[t], dot, ddx);
          dm = fmaf(cn.w[t], dot, dm);
          if (first_slice) shares += in;
          if (in && !binned) {   // the spill: a share's global float4 atomics
            if (first_slice) ++spilled;
            const float mw = m * cn.w[t];
            float4* dst = reinterpret_cast<float4*>(
                gsrc + static_cast<int64_t>(cn.q[t]) * C);
#pragma unroll
            for (int c4 = 0; c4 < kCh / 4; ++c4) {
              atomicAdd(dst + c4,
                        make_float4(mw * u[4 * c4], mw * u[4 * c4 + 1],
                                    mw * u[4 * c4 + 2], mw * u[4 * c4 + 3]));
            }
          }
        }
        // the pixel's kS partial sums (its threads read o above)
#pragma unroll
        for (int off = kS / 2; off > 0; off /= 2) {
          ddy += __shfl_xor_sync(lanes, ddy, off);
          ddx += __shfl_xor_sync(lanes, ddx, off);
          dm += __shfl_xor_sync(lanes, dm, off);
        }
#pragma unroll
        for (int c = 0; c < kCh; ++c) col[(c0 + c) * kStride + pix] = m * s[c];
        if (binned) {
          bin = static_cast<int>(by) * kBW + static_cast<int>(bx);
          float4* ur = reinterpret_cast<float4*>(us + pix * C + c0);
#pragma unroll
          for (int c4 = 0; c4 < kCh / 4; ++c4) {
            ur[c4] = make_float4(u[4 * c4], u[4 * c4 + 1], u[4 * c4 + 2],
                                 u[4 * c4 + 3]);
          }
        }
        if (first_slice) {
          o[2 * k] = from_float<T>(m * ddy);
          o[2 * k + 1] = from_float<T>(m * ddx);
          o[18 + k] = from_float<T>(dm * m * (1.f - m));
          if (binned) {
            pf[pix] = make_float4(fy, fx, m, 0.f);
            next[pix] = atomicExch(head + bin, pix);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) col[(c0 + c) * kStride + pix] = 0.f;
      }
      __syncthreads();

      // --- dW_k += the tile's outer products: this thread's (co, ci)
      // block over its part's quads of pixels
      {
        float dw[kCo][kCi];
#pragma unroll
        for (int j = 0; j < kCo; ++j) {
#pragma unroll
          for (int i = 0; i < kCi; ++i) dw[j][i] = 0.f;
        }
#pragma unroll 2
        for (int pp = 4 * part; pp < kP; pp += 4 * kParts) {
          float4 a[kCo], b[kCi];
#pragma unroll
          for (int j = 0; j < kCo; ++j) {
            a[j] = *reinterpret_cast<const float4*>(
                gys + (co0 + j * (C / kCo)) * kStride + pp);
          }
#pragma unroll
          for (int i = 0; i < kCi; ++i) {
            b[i] = *reinterpret_cast<const float4*>(
                col + (ci0 + i * (C / kCi)) * kStride + pp);
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
        // the parts' sums by halving: a shuffle step sends half of the sums
        // a thread still holds and keeps the other half, down to kOut sums
        // a thread (flattened from base), then plain steps
        constexpr int kNv = kCo * kCi;
        constexpr int kOut = kNv > kParts ? kNv / kParts : 1;
        float v[kNv];
#pragma unroll
        for (int q = 0; q < kNv; ++q) v[q] = dw[q / kCi][q % kCi];
        int base = 0;
#pragma unroll
        for (int off = kParts / 2, n = kNv; off > 0; off /= 2) {
          const bool hi = part & off;
          if (n > 1) {
            n /= 2;
#pragma unroll
            for (int q = 0; q < kNv / 2; ++q) {
              if (q < n) {
                const float send = hi ? v[q] : v[q + n];
                const float keep = hi ? v[q + n] : v[q];
                v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
              }
            }
            if (hi) base += n;
          } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
          }
        }
        if (part % (kParts / (kNv < kParts ? kNv : kParts)) == 0) {
#pragma unroll
          for (int q = 0; q < kOut; ++q) {
            const int j = (base + q) / kCi, i = (base + q) % kCi;
            const int co = co0 + j * (C / kCo), ci = ci0 + i * (C / kCi);
            dws[(k * C + co) * C + ci] += v[q];
          }
        }
      }
      // --- the bins' sums: the threads of a bin's head pixel walk its list
      // once, summing its entries' shares to each pixel t of the 2 x 2
      // block (sum[t], their kCh channels) in registers
      const bool leader = bin >= 0 && head[bin] == pix;
      float sum[4][kCh];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) sum[t][c] = 0.f;
      }
      if (leader) {
#pragma unroll 1
        for (int e = pix; e >= 0; e = next[e]) {
          const float4 f = pf[e];   // (fy, fx, m): corners_at's weights
          const float wy0 = 1.f - f.x, wx0 = 1.f - f.y;
          const float mw[4] = {f.z * (wy0 * wx0), f.z * (wy0 * f.y),
                               f.z * (f.x * wx0), f.z * (f.x * f.y)};
          const float4* ur = reinterpret_cast<const float4*>(us + e * C + c0);
#pragma unroll
          for (int c4 = 0; c4 < kCh / 4; ++c4) {
            const float4 uv = ur[c4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              sum[t][4 * c4] = fmaf(mw[t], uv.x, sum[t][4 * c4]);
              sum[t][4 * c4 + 1] = fmaf(mw[t], uv.y, sum[t][4 * c4 + 1]);
              sum[t][4 * c4 + 2] = fmaf(mw[t], uv.z, sum[t][4 * c4 + 2]);
              sum[t][4 * c4 + 3] = fmaf(mw[t], uv.w, sum[t][4 * c4 + 3]);
            }
          }
        }
      }
      // the next tap's bins empty (their last readers were the last tap's),
      // and its weights
      int* other = heads + ((k + 1) & 1) * kBins;
      for (int i = tid; i < kBins; i += kThreads) other[i] = -1;
      if (k + 1 < kTaps) {
        for (int i = tid; i < C * C; i += kThreads) {
          ws[i] = to_float(weight[i * kTaps + k + 1]);
        }
      }
      // sum[t] into the window's sum of pixel t of the block, t by t: the
      // bins' pixels t are distinct, so no two threads add to one sum
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t > 0) __syncthreads();
        if (leader) {
          const int br = bin / kBW, bc = bin - br * kBW;
          float4* ar = reinterpret_cast<float4*>(
              acc + ((br + (t >> 1)) * kDW + bc + (t & 1)) * C + c0);
#pragma unroll
          for (int c4 = 0; c4 < kCh / 4; ++c4) {
            float4 v = ar[c4];
            v.x += sum[t][4 * c4];
            v.y += sum[t][4 * c4 + 1];
            v.z += sum[t][4 * c4 + 2];
            v.w += sum[t][4 * c4 + 3];
            ar[c4] = v;
          }
        }
      }
      __syncthreads();
    }

    // the tile's offset and mask gradients, one coalesced store
    for (int i = tid; i < kTH * kTW * kOm; i += kThreads) {
      const int r = i / (kTW * kOm), j = i - r * (kTW * kOm);
      if (r < rows && j < row_len) {
        gom[((img + ty + r) * W + tx) * kOm + j] = oms[i];
      }
    }
    // the window's sums into dx: a float4 atomic a destination and 4
    // channels, for destinations inside the image that got a share
    for (int i = tid; i < kDests * kS; i += kThreads) {
      const int d = i / kS, dc0 = (i % kS) * kCh;
      const int dr = d / kDW, dc = d - dr * kDW;
      const int gh = ty - kR + dr, gwc = tx - kR + dc;
      if (gh < 0 || gh >= H || gwc < 0 || gwc >= W) continue;
      const float4* ar = reinterpret_cast<const float4*>(acc + d * C + dc0);
      bool nonzero = false;
#pragma unroll
      for (int c4 = 0; c4 < kCh / 4; ++c4) {
        const float4 v = ar[c4];
        nonzero |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      }
      if (!nonzero) continue;
      adds += kCh;
      float4* dst = reinterpret_cast<float4*>(
          gx + ((img + gh) * W + gwc) * C + dc0);
#pragma unroll
      for (int c4 = 0; c4 < kCh / 4; ++c4) atomicAdd(dst + c4, ar[c4]);
    }
  }

  // dW and the counters, once a block
  __syncthreads();
  for (int i = tid; i < kTaps * C * C; i += kThreads) {
    const int k = i / (C * C), cc = i - k * (C * C);
    atomicAdd(gw + cc * kTaps + k, dws[i]);
  }
  const unsigned v[3] = {__reduce_add_sync(0xffffffffu, spilled),
                         __reduce_add_sync(0xffffffffu, shares),
                         __reduce_add_sync(0xffffffffu, adds)};
  if (tid % 32 == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(block_counts + i, static_cast<unsigned long long>(v[i]));
    }
  }
  __syncthreads();
  if (tid < 3) atomicAdd(counts + tid, block_counts[tid]);
}

template <typename T, int C>
int launch_bwd(const void* x, const void* om, const void* weight,
               const void* gy, void* gx, void* gom, void* gw, void* counts,
               int N, int H, int W, cudaStream_t st) {
  using L = BwdLayout<T, C>;
  const auto kernel = deform_conv_bwd_kernel<T, C>;
  const int64_t tiles_y = (H + L::kTH - 1) / L::kTH;
  const int64_t tiles_x = (W + L::kTW - 1) / L::kTW;
  const int64_t tiles = static_cast<int64_t>(N) * tiles_y * tiles_x;
  if (tiles_x > 0x7fffffff) return kBadShape;
  // the shared memory above 48 KB, once a device; a grid that fills the
  // card once: every SM holds per_sm blocks, each walking its tiles
  constexpr int kDevices = 64;
  static bool ready[kDevices] = {};
  static int per_sm = 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev >= kDevices || !ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) ready[dev] = true;
  }
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  L::kThreads, L::kBytes);
    if (per_sm < 1) per_sm = 1;
  }
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t fill = static_cast<int64_t>(per_sm) * sms;
  const int64_t blocks = tiles < fill ? tiles : fill;
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(om),
      static_cast<const T*>(weight), static_cast<const T*>(gy),
      static_cast<float*>(gx), static_cast<T*>(gom), static_cast<float*>(gw),
      static_cast<unsigned long long*>(counts), H, W,
      static_cast<int>(tiles_x), tiles_y * tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward. x, om, weight as the forward's; gy (N, H, W, C) the
// gradient of its output, of their dtype; gx (N, H, W, C) and gw (C, C, 3,
// 3) float32, zeroed by the caller, into which the gradients of x and the
// weight are added; gom (N, H, W, 27) of the dtype, which receives the
// gradient of om; counts (3,) int64, to which the launch adds the shares
// it spilled to global atomics, all its shares (the taps inside the image,
// 4 at most a pixel and tap; a share is C floats) and the floats that the
// windows' sums added to gx by atomics. All contiguous, x, gy and gx
// 16-byte aligned; C in {8, 16, 32}; dtype 0 float32, 1 bfloat16. Returns
// 0, a cudaError_t from the launch, or a negative code of sampling.cuh.
static int deform_conv_bwd_typed(const void* x, const void* om,
                                 const void* weight, const void* gy, void* gx,
                                 void* gom, void* gw, void* counts, int N,
                                 int H, int W, int C, int dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    return launch_bwd<T, decltype(c)::value>(x, om, weight, gy, gx, gom, gw,
                                             counts, N, H, W, st);
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
