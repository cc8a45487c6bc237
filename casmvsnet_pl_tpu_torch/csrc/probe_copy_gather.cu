// Copy and gather probes for Hopper (sm_90a): the lane-prefix copy and the
// row and lane gathers, each the card's answer to a TPU probe's question.
//
// Replaces, on the TPU side:
//   scripts/probe_epi3.py::make_copy.<fn> (pallas_call at :88, body
//   copy_kernel at :80), TPU kernel #11: out = rows[..., :C] for rows of
//   4C lanes, the probe of Mosaic's DMA rate and per-grid-step cost, swept
//   by its tile T in {1024, 8192};
//   scripts/probe_gather.py::try_kernel (pallas_call at :18), TPU kernel
//   #13: which in-kernel gather forms Mosaic takes. Its take,
//   take_along_axis, advanced-index, one-hot-matmul and dynamic-slice-loop
//   kernels all compute the row gather out[i, :] = table[idx[i], :]; its
//   lane kernel computes out[r, j] = featT[r, idx[j]].
//
// What the kernels compute, on raw bytes (any dtype; f32 and bf16 here):
//   lane_prefix_copy: out[r, :P] = rows[r, :P] for rows of 4P bytes, P = C
//     times the element size, a multiple of 16;
//   row_gather_*:     out[i, :] = table[idx[i], :], idx int64, rows of R
//     bytes, R a multiple of 16;
//   lane_gather:      out[r, j] = featT[r, idx[j]], 2- or 4-byte elements.
// Plain versions: casmvsnet_pl_tpu_torch/probes/epi3.py::plain_lane_prefix_copy
// and probes/gather.py::plain_row_gather / plain_lane_gather.
//
// What bounds them on the card: bytes; they compute nothing. The copy
// must read P of every 4P bytes: a warp's 16-byte loads of neighbouring
// rows' prefixes touch one 32-byte sector in four (bf16 C=16: P = 32 B of
// a 128-byte row), so where the card lands between the needed-bytes bound
// and the whole-row bound says what it fetches per sector. Each thread
// moves one 16-byte vector with one load and one store; a block walks
// kRows rows, the counterpart of the probe's tile T (two values, as there).
//
// The three row-gather forms are Hopper's ways to move a row that an index
// names:
//   (a) ldg:      one thread per 16-byte vector of the output, the vectors
//                 of a row on neighbouring lanes, read with __ldg;
//   (b) cp_async: 16-byte cp.async.cg copies into shared memory, two stages
//                 (the next tile's copies in flight while this tile is
//                 stored), then coalesced 16-byte stores. Each thread stores
//                 only what it copied itself, so it waits on its own copy
//                 groups and no block barrier is needed;
//   (c) bulk:     one cp.async.bulk (the TMA's non-tensor copy) per row into
//                 shared memory, completing on an mbarrier, then one bulk
//                 store of the whole tile: Hopper's form of the probe's
//                 "one DMA per row" (scripts/probe_gather.py:85-92).
// Hopper's TMA has no gather mode: a tensor map copies boxes, and its
// gather of rows (.tile::gather4) is sm_100, so it has no form here. The
// lane gather reads 2- or 4-byte elements at random columns of a row and
// writes them coalesced, one thread per output element.
//
// An index outside the table traps (a device-side fault, as index_select's
// device assert), so no form reads outside its table.
#include "sampling.cuh"

namespace {

using namespace cv;

constexpr int kCopyThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kStageVec = 4;          // (b): 16-byte vectors a thread copies per tile
constexpr int kBulkTileBytes = 8192;  // (c): shared-memory tile of a block

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t checked_row(const int64_t* __restrict__ idx,
                                               int64_t i, int64_t n_rows) {
  const int64_t row = __ldg(idx + i);
  if (row < 0 || row >= n_rows) __trap();
  return row;
}

// ---------------------------------------------------------------------------
// #11: lane-prefix copy
// ---------------------------------------------------------------------------

// Block b copies the prefixes of rows [b * kRows, (b + 1) * kRows): vec
// 16-byte vectors of each row of 4 * vec vectors.
template <int kRows>
__global__ void __launch_bounds__(kCopyThreads)
    lane_prefix_copy_kernel(const uint4* __restrict__ rows,
                            uint4* __restrict__ out, int64_t n_rows,
                            int vec) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int here = static_cast<int>(min64(kRows, n_rows - row0));
  const int n = here * vec;
  for (int t = threadIdx.x; t < n; t += kCopyThreads) {
    const int64_t r = row0 + t / vec;
    const int v = t % vec;
    out[r * vec + v] = __ldg(rows + r * 4 * vec + v);
  }
}

template <int kRows>
int launch_copy(const void* rows, void* out, int64_t n_rows, int vec,
                cudaStream_t stream) {
  const int64_t blocks = (n_rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return kBadShape;
  lane_prefix_copy_kernel<kRows><<<static_cast<unsigned>(blocks),
                                   kCopyThreads, 0, stream>>>(
      static_cast<const uint4*>(rows), static_cast<uint4*>(out), n_rows, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// #13 (a): row gather through __ldg
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kGatherThreads)
    row_gather_ldg_kernel(const uint4* __restrict__ table,
                          const int64_t* __restrict__ idx,
                          uint4* __restrict__ out, int64_t n_table,
                          int64_t n_vec, int vec) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kGatherThreads +
                    threadIdx.x;
  if (t >= n_vec) return;
  const int64_t i = t / vec;
  const int v = static_cast<int>(t - i * vec);
  out[t] = __ldg(table + checked_row(idx, i, n_table) * vec + v);
}

// ---------------------------------------------------------------------------
// #13 (b): row gather through cp.async, two stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one of this thread's copy groups is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr int64_t kTileVec = static_cast<int64_t>(kStageVec) * kGatherThreads;

// Issues this thread's copies of tile `tile` into its slots of one stage.
__device__ __forceinline__ void issue_tile(
    uint4 (*stage)[kGatherThreads], const uint4* __restrict__ table,
    const int64_t* __restrict__ idx, int64_t n_table, int64_t n_vec, int vec,
    int64_t tile) {
#pragma unroll
  for (int k = 0; k < kStageVec; ++k) {
    const int64_t t = tile * kTileVec + k * kGatherThreads + threadIdx.x;
    if (t < n_vec) {
      const int64_t i = t / vec;
      const int v = static_cast<int>(t - i * vec);
      cp_async16(&stage[k][threadIdx.x],
                 table + checked_row(idx, i, n_table) * vec + v);
    }
  }
}

// A tile is kTileVec consecutive vectors of the output; thread x copies
// vectors x, x + kGatherThreads, ... of it. Blocks walk the tiles with a
// stride of the grid.
__global__ void __launch_bounds__(kGatherThreads)
    row_gather_cp_async_kernel(const uint4* __restrict__ table,
                               const int64_t* __restrict__ idx,
                               uint4* __restrict__ out, int64_t n_table,
                               int64_t n_vec, int vec) {
  __shared__ uint4 stage[2][kStageVec][kGatherThreads];
  const int64_t n_tiles = (n_vec + kTileVec - 1) / kTileVec;
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) issue_tile(stage[0], table, idx, n_table, n_vec, vec, tile);
  cp_async_commit();
  for (int s = 0; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) {
      issue_tile(stage[s ^ 1], table, idx, n_table, n_vec, vec, next);
    }
    cp_async_commit();   // an empty group keeps the count of groups uniform
    cp_async_wait_one();  // this tile's copies have landed
#pragma unroll
    for (int k = 0; k < kStageVec; ++k) {
      const int64_t t = tile * kTileVec + k * kGatherThreads + threadIdx.x;
      if (t < n_vec) out[t] = stage[s][k][threadIdx.x];
    }
  }
}

// ---------------------------------------------------------------------------
// #13 (c): row gather through bulk copies (TMA, no tensor map)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One warp per block: block b gathers output rows [b * per_tile, ...) into
// its shared tile, one bulk copy per row, all completing on one mbarrier,
// then writes the tile to the output with one bulk store.
__global__ void __launch_bounds__(32)
    row_gather_bulk_kernel(const char* __restrict__ table,
                           const int64_t* __restrict__ idx,
                           char* __restrict__ out, int64_t n_table,
                           int64_t n_out, int row_bytes, int per_tile) {
  __shared__ alignas(128) char tile[kBulkTileBytes];
  __shared__ alignas(8) uint64_t bar;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_tile;
  const int n = static_cast<int>(min64(per_tile, n_out - r0));
  const unsigned bytes = static_cast<unsigned>(n) * row_bytes;
  const unsigned bar_s = smem_addr(&bar);
  const unsigned tile_s = smem_addr(tile);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the one arrival, with the bytes the copies will bring
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_s),
        "r"(bytes)
        : "memory");
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += 32) {
    const int64_t row = checked_row(idx, r0 + i, n_table);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(tile_s + i * row_bytes),
        "l"(table + row * row_bytes), "r"(row_bytes), "r"(bar_s)
        : "memory");
  }
  mbar_wait(bar_s, 0);
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            out + r0 * row_bytes),
        "r"(tile_s), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the tile must outlive the store's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// #13: lane gather
// ---------------------------------------------------------------------------

template <typename E>
__global__ void __launch_bounds__(kGatherThreads)
    lane_gather_kernel(const E* __restrict__ featT,
                       const int64_t* __restrict__ idx, E* __restrict__ out,
                       int64_t n_out, int L, int J) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kGatherThreads +
                    threadIdx.x;
  if (t >= n_out) return;
  const int64_t r = t / J;
  const int j = static_cast<int>(t - r * J);
  out[t] = featT[r * L + checked_row(idx, j, L)];
}

int grid_for(int64_t threads, unsigned* blocks) {
  const int64_t b = (threads + kGatherThreads - 1) / kGatherThreads;
  if (b > 0x7fffffff) return kBadShape;
  *blocks = static_cast<unsigned>(b);
  return 0;
}

}  // namespace

// rows (n_rows, 4 * prefix_bytes) bytes, out (n_rows, prefix_bytes); both
// 16-byte aligned, prefix_bytes a multiple of 16; rows_per_block 1024 or
// 8192. Returns 0, a cudaError_t or a negative code of sampling.cuh.
static int lane_prefix_copy_fwd_typed(const void* rows, void* out,
                                      int64_t n_rows, int prefix_bytes,
                                      int rows_per_block, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prefix_bytes <= 0 || prefix_bytes % 16) return kUnsupported;
  const int vec = prefix_bytes / 16;
  if (rows_per_block == 1024) return launch_copy<1024>(rows, out, n_rows, vec, st);
  if (rows_per_block == 8192) return launch_copy<8192>(rows, out, n_rows, vec, st);
  return kUnsupported;
}

// lane_prefix_copy_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int lane_prefix_copy_fwd(const int64_t* args) {
  return cv::call_packed(lane_prefix_copy_fwd_typed, args);
}

// table (n_table, row_bytes), idx (n_out,) int64, out (n_out, row_bytes);
// 16-byte aligned, row_bytes a multiple of 16 (at most kBulkTileBytes for
// the bulk form). form 0: ldg, 1: cp_async, 2: bulk.
static int row_gather_fwd_typed(const void* table, const void* idx, void* out,
                                int64_t n_table, int64_t n_out, int row_bytes,
                                int form, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes <= 0 || row_bytes % 16) return kUnsupported;
  const int vec = row_bytes / 16;
  const auto* t16 = static_cast<const uint4*>(table);
  const auto* ix = static_cast<const int64_t*>(idx);
  const int64_t n_vec = n_out * vec;
  unsigned blocks = 0;
  if (form == 0) {
    if (const int err = grid_for(n_vec, &blocks)) return err;
    row_gather_ldg_kernel<<<blocks, kGatherThreads, 0, st>>>(
        t16, ix, static_cast<uint4*>(out), n_table, n_vec, vec);
  } else if (form == 1) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // 8 blocks of 256 threads (32 KB of stages each) fill an SM
    const int64_t tiles = (n_vec + kTileVec - 1) / kTileVec;
    const int64_t fill = static_cast<int64_t>(8) * sms;
    blocks = static_cast<unsigned>(tiles < fill ? tiles : fill);
    if (blocks == 0) return 0;
    row_gather_cp_async_kernel<<<blocks, kGatherThreads, 0, st>>>(
        t16, ix, static_cast<uint4*>(out), n_table, n_vec, vec);
  } else if (form == 2) {
    if (row_bytes > kBulkTileBytes) return kUnsupported;
    const int per_tile = kBulkTileBytes / row_bytes;
    const int64_t b = (n_out + per_tile - 1) / per_tile;
    if (b > 0x7fffffff) return kBadShape;
    row_gather_bulk_kernel<<<static_cast<unsigned>(b), 32, 0, st>>>(
        static_cast<const char*>(table), ix, static_cast<char*>(out), n_table,
        n_out, row_bytes, per_tile);
  } else {
    return kUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}

// row_gather_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int row_gather_fwd(const int64_t* args) {
  return cv::call_packed(row_gather_fwd_typed, args);
}

// featT (R, L), idx (J,) int64, out (R, J); elements of elem_bytes 2 or 4.
static int lane_gather_fwd_typed(const void* featT, const void* idx, void* out,
                                 int64_t R, int L, int J, int elem_bytes,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_out = R * J;
  unsigned blocks = 0;
  if (const int err = grid_for(n_out, &blocks)) return err;
  const auto* ix = static_cast<const int64_t*>(idx);
  if (elem_bytes == 4) {
    lane_gather_kernel<uint32_t><<<blocks, kGatherThreads, 0, st>>>(
        static_cast<const uint32_t*>(featT), ix, static_cast<uint32_t*>(out),
        n_out, L, J);
  } else if (elem_bytes == 2) {
    lane_gather_kernel<uint16_t><<<blocks, kGatherThreads, 0, st>>>(
        static_cast<const uint16_t*>(featT), ix, static_cast<uint16_t*>(out),
        n_out, L, J);
  } else {
    return kUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}

// lane_gather_fwd_typed's arguments packed as int64 (sampling.cuh).
extern "C" int lane_gather_fwd(const int64_t* args) {
  return cv::call_packed(lane_gather_fwd_typed, args);
}
