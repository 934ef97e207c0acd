// Basket expansion + count scatter for the dense fused window, for Hopper.
//
// Replaces the Pallas TPU kernel `_expand_kernel`
// (tpu_cooccurrence/ops/pallas_score.py), as called by
// `pallas_expand_baskets`, together with the XLA scatter-add that consumes
// its lanes (`_fused_apply_baskets`, tpu_cooccurrence/ops/device_scorer.py).
// The TPU kernel wrote [N, 2W] COO lanes to device memory because Mosaic
// cannot scatter to arbitrary rows; here the expansion scatters straight
// into C and the row sums, and no lane is materialised.
//
// Input: one packed [n, W + 4] int32 block, row i = basket[i, 0:W] then
// new, len, skip, sign. For each j < min(len, W) with j != skip and
// p = basket[i, j]:
//   C[new, p] += sign, C[p, new] += sign, row_sums[p] += sign,
// and row_sums[new] += sign once per such j. Cells at j >= len hold
// unspecified bytes: the mask is applied before a cell is read, so they
// are never used as an address. A cell id (or new item) outside [0, I)
// adds nothing: the caller guarantees the range, and the kernel never
// writes out of bounds. Cell offsets are 64-bit (I^2 passes 2^31 at the
// int16 vocabulary ceiling). Counts are modular at int32 and int16 (the
// reference's Java ints and shorts); modular sums do not depend on
// order, so every regrouping below is exact.
//
// Bound on this card: bytes. The block is read once (4 n (W + 4) bytes),
// and each distinct 32-byte sector of C and of the row sums that the
// launch touches is read and written once (64 bytes).
//
// What held the first design (a warp an op, three atomics a cell) far
// from that bound, and what this one does about it:
//
// (a) Idle lanes. Work per warp followed len, which a Zipf stream makes
//     very uneven, and a warp on a one-cell op left 31 lanes idle.
//     Here a block walks tiles of ops (grid-stride, so a block may take
//     several). Per tile it loads each op's meta into shared
//     memory, counts the op's valid cells (min(len, W), less one where
//     0 <= skip < min(len, W); none for a new item outside [0, I)) and
//     takes their exclusive prefix sum. Its threads then walk the tile's
//     flattened cell list: cell f belongs to the op o with
//     pre[o] <= f < pre[o + 1] (a binary search in shared memory), at
//     k = f - pre[o] and column j = k + (k >= skip). Every thread has a
//     cell whatever W and len are, and neighbouring threads read
//     neighbouring columns.
// (b) Hot row sums. Zipf gives the hottest items the lowest ids, so their
//     row sums share one or two 32-byte sectors, and nearly every op's
//     basket holds them: their atomics queued at one L2 slice. Here the
//     row sums go through a table in shared memory (direct-mapped,
//     kTable slots; a slot is claimed once by atomicCAS, and an item
//     that finds its slot taken by another adds to device memory
//     directly), flushed once when the block has walked all its tiles:
//     a hot item costs one device atomic a block instead of one an op.
//     row_sums[new] is first summed over the warp's lanes with the same
//     new item (__match_any_sync, __reduce_add_sync). C's adds are not
//     combined: on the bench stream nearly every one hits its own
//     32-byte sector, and summing a warp's equal cells first cost more
//     than it saved on one-cell ops with random partners (tune_expand.py,
//     PERF.md).
// (c) int16 without a retry loop. CUDA has no 16-bit atomicAdd, and a
//     16-bit atomicCAS loop retries under contention. Here a cell is
//     added with a 32-bit atomicAdd on the aligned word that holds it.
//     High half: add v << 16; the carry out of bit 31 is dropped. Low
//     half: add (uint16)v; if the old low half plus it carries out of
//     bit 15, subtract 1 << 16 again. Each low add's carry is undone by
//     its own correction whatever order the atomics land in, so each
//     half ends exact modulo 2^16. A cell whose word would reach outside
//     C (the first cell of a C that does not start 4-byte aligned, the
//     last of an odd-sized C) keeps the 16-bit atomicCAS loop, which
//     touches the cell's own two bytes only.
//
// (d) Geometry (tune_expand.py's variants, PERF.md): 1024 threads a
//     block, a 4,096-slot table, tiles of about kTileCells = 8,192 cells
//     (kTileCells / W ops, 1 to kMaxTileOps) and at most kBlocksPerSm = 2
//     blocks an SM. Fewer, larger blocks read faster on the main path's
//     launches: each block flushes its table once, and the walk's latency
//     hides behind 32 warps.
//
// What bounds it now: the C atomics. Each valid cell adds to two cells
// of C, and on the bench stream nearly every add lands in its own 32-byte
// sector of a 1.6 GB C, a random read-modify-write at the HBM. PyTorch's
// index_add_ of the same expanded cells, with no expansion and no row
// sums, takes most of the kernel's time (chip_smoke.py phase 9).
//
// int32 C and the row sums use the native atomicAdd (also modular).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Ops a tile holds at most. The prefix sum takes one op a thread; 512
// (not 1024) leaves room in 48 KB of static shared memory for the table.
constexpr int kMaxTileOps = 512;
static_assert(kMaxTileOps <= kThreads, "one op a thread in the prefix sum");
// Basket cells a tile holds at most (unless one op is wider), and blocks
// an SM at most; the grid is no larger than the launch's tiles.
constexpr int kTileCells = 8192;
constexpr int kBlocksPerSm = 2;
constexpr int kTableBits = 12;
constexpr int kTable = 1 << kTableBits;
constexpr int kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  int pre[kMaxTileOps + 1];     // exclusive prefix of the valid counts
  int new_item[kMaxTileOps];
  int sign[kMaxTileOps];
  int skip[kMaxTileOps];        // the skipped column, or min(len, W)
  int warp_sum[kWarps];
  int key[kTable];              // row-sum table: item, or kEmpty
  unsigned val[kTable];         // its summed delta, modulo 2^32
};

__device__ __forceinline__ void add_count(int32_t* C, size_t off, size_t,
                                          unsigned v) {
  if (v != 0) atomicAdd(reinterpret_cast<unsigned*>(C) + off, v);
}

__device__ __forceinline__ void add_count(int16_t* C, size_t off,
                                          size_t n_cells, unsigned v) {
  const unsigned a = v & 0xffffu;
  if (a == 0) return;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(C + off);
  const uintptr_t word = addr & ~static_cast<uintptr_t>(3);
  if (word < reinterpret_cast<uintptr_t>(C) ||
      word + 4 > reinterpret_cast<uintptr_t>(C + n_cells)) {
    unsigned short* cell = reinterpret_cast<unsigned short*>(C + off);
    unsigned short old = *cell;
    unsigned short assumed;
    do {
      assumed = old;
      old = atomicCAS(cell, assumed,
                      static_cast<unsigned short>(assumed + a));
    } while (assumed != old);
    return;
  }
  unsigned* w = reinterpret_cast<unsigned*>(word);
  if (addr & 2) {  // little-endian: the cell at the higher address
    atomicAdd(w, a << 16);
  } else {
    const unsigned old = atomicAdd(w, a);
    if ((old & 0xffffu) + a > 0xffffu) atomicSub(w, 0x10000u);
  }
}

__device__ __forceinline__ void add_row_sum(Shared& s, int32_t* row_sums,
                                            int item, unsigned v) {
  if (v == 0) return;
  const int slot = static_cast<int>(
      (static_cast<unsigned>(item) * 2654435761u) >> (32 - kTableBits));
  int k = *reinterpret_cast<volatile int*>(&s.key[slot]);
  if (k == kEmpty) {
    k = atomicCAS(&s.key[slot], kEmpty, item);
    if (k == kEmpty) k = item;
  }
  if (k == item) {
    atomicAdd(&s.val[slot], v);
  } else {
    atomicAdd(reinterpret_cast<unsigned*>(row_sums) + item, v);
  }
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
expand_scatter_kernel(const int32_t* __restrict__ block, int n_ops, int width,
                      int tile_ops,
                      CountT* __restrict__ C, int32_t* __restrict__ row_sums,
                      int num_items) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < kTable; i += kThreads) {
    s.key[i] = kEmpty;
    s.val[i] = 0;
  }
  const size_t stride = static_cast<size_t>(width) + 4;
  const size_t n_cells = static_cast<size_t>(num_items) * num_items;
  const int n_tiles = (n_ops + tile_ops - 1) / tile_ops;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int op0 = tile * tile_ops;
    const int tn = min(tile_ops, n_ops - op0);
    __syncthreads();  // the table is set and the last tile's reads are done

    int count = 0;
    if (tid < tn) {
      const int32_t* meta = block + (op0 + tid) * stride + width;
      const int nw = meta[0];
      const int end = max(0, min(meta[1], width));
      const int skip = meta[2];
      const bool skips = skip >= 0 && skip < end;
      count = (nw >= 0 && nw < num_items) ? end - (skips ? 1 : 0) : 0;
      s.new_item[tid] = nw;
      s.sign[tid] = meta[3];
      s.skip[tid] = skips ? skip : end;
    }
    // Exclusive prefix sum of the counts over the block.
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s.warp_sum[tid >> 5] = incl;
    __syncthreads();
    if (tid < 32) {
      const int w = tid < kWarps ? s.warp_sum[tid] : 0;
      int x = w;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (tid < kWarps) s.warp_sum[tid] = x - w;
    }
    __syncthreads();
    const int excl = incl - count + s.warp_sum[tid >> 5];
    if (tid < tn) s.pre[tid] = excl;
    if (tid == tn - 1) s.pre[tn] = excl + count;
    __syncthreads();

    const int total = s.pre[tn];
    for (int base = 0; base < total; base += kThreads) {
      const int f = base + tid;
      int nw = -1;
      int p = -1;
      unsigned v = 0;
      if (f < total) {
        int lo = 0, hi = tn;  // s.pre[lo] <= f < s.pre[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s.pre[mid] <= f) lo = mid; else hi = mid;
        }
        const int k = f - s.pre[lo];
        const int j = k + (k >= s.skip[lo] ? 1 : 0);  // j < min(len, W)
        p = block[(op0 + lo) * stride + j];
        nw = s.new_item[lo];
        if (p >= 0 && p < num_items) {
          v = static_cast<unsigned>(s.sign[lo]);
        } else {
          p = -1;
        }
      }
      // row_sums[new]: one add per distinct new item of the warp.
      const unsigned g = __match_any_sync(kFull, nw);
      const unsigned new_sum = __reduce_add_sync(g, v);
      if (nw >= 0 && lane == __ffs(g) - 1) {
        add_row_sum(s, row_sums, nw, new_sum);
      }
      if (p >= 0) {
        add_row_sum(s, row_sums, p, v);
        add_count(C, static_cast<size_t>(nw) * num_items + p, n_cells, v);
        add_count(C, static_cast<size_t>(p) * num_items + nw, n_cells, v);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < kTable; i += kThreads) {
    const int item = s.key[i];
    const unsigned v = s.val[i];
    if (item != kEmpty && v != 0) {
      atomicAdd(reinterpret_cast<unsigned*>(row_sums) + item, v);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for the `n_ops` ops of `block`
// ([n_ops, width + 4] int32); `count_bytes` is the width of C's cells
// (4 = int32, 2 = int16). Returns the CUDA error code of the launch
// (0 = launched).
int expand_scatter_launch(const int32_t* block, int n_ops, int width,
                          void* C, int count_bytes, int32_t* row_sums,
                          int num_items, void* stream) {
  if (n_ops < 0 || width < 0 || num_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ops == 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tile_ops =
      std::min(kMaxTileOps, std::max(1, kTileCells / std::max(width, 1)));
  const long long n_tiles =
      (static_cast<long long>(n_ops) + tile_ops - 1) / tile_ops;
  const unsigned int grid = static_cast<unsigned int>(
      n_tiles < static_cast<long long>(sms) * kBlocksPerSm
          ? n_tiles : static_cast<long long>(sms) * kBlocksPerSm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 4) {
    expand_scatter_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        block, n_ops, width, tile_ops, static_cast<int32_t*>(C),
        row_sums, num_items);
  } else if (count_bytes == 2) {
    expand_scatter_kernel<int16_t><<<grid, kThreads, 0, st>>>(
        block, n_ops, width, tile_ops, static_cast<int16_t*>(C),
        row_sums, num_items);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* expand_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
