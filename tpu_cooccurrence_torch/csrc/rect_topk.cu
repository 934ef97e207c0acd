// Fused LLR scoring + streaming top-K over the slab cells of sparse rows,
// for Hopper.
//
// Replaces the Pallas TPU kernel `_rect_topk_kernel`
// (tpu_cooccurrence/ops/pallas_score.py), as called by `pallas_score_rect`
// from the sparse backend's scorers. Each scored row s owns the slab
// region [starts[s], starts[s] + lens[s]); for every cell c there
//   k11 = cnt[c], rsj = row_sums[dst[c]], rsi = row_sums[rows[s]],
//   k12 = rsi - k11, k21 = rsj - k11, k22 = observed + k11 - k12 - k21
// is scored with the stable log1p LLR (topk_block.cuh), a zero (cancelled)
// cell scores -inf, and the row keeps its top K by (score desc, slab
// position asc): lax.top_k's rule on the slot-ordered rectangle, so the
// earliest-inserted cell wins a tie. Output: [S, K] f32 scores and [S, K]
// int32 partner ids (dst of the chosen cell); lanes past a row's live
// cells are (-inf, 0).
//
// The TPU form's workarounds are dropped: the kernel reads cnt, dst and
// row_sums[dst] itself from (rows, starts, lens) (no [S, R] pre-gather
// into padded rectangles), carries int32 ids (no float32-id 2^24
// vocabulary cap) and takes every row length (no lane gate, no bucket
// widths).
//
// Design: two size classes. The caller passes rows in ascending length
// buckets and the number of rows, `n_short`, of the prefix that holds no
// row over 1,024 cells (ops/rect_topk.py short_rows, host arithmetic on
// the lengths it already holds, so no device sync):
// - short rows (the prefix): one warp a row, eight rows a block, no block
//   barrier on a row's path;
// - long rows (the suffix): one block a row, its eight warps on
//   interleaved cells, their lists merged once at the end.
// Blocks of long rows come first in the grid, last row (longest bucket)
// first, then the short rows, likewise. Both classes take any length, so
// any n_short is exact; the classes change the work, never the result.
// Both select with the per-warp queue, threshold, buffer and merge of
// topk_block.cuh.
//
// Cells: `cnt` holds the slab's cell type, int32, int16 or int8 (the
// sparse backend's --cell-dtype; a narrow cell is widened to int in
// registers, exactly as the plain version casts it), one kernel a type.
//
// Bound on this card: 12 bytes per live cell at int32 cells (cnt, dst,
// row_sums[dst]; 10 at int16, 9 at int8) plus the per-row meta and
// outputs, against about 8 float32 operations per cell (4 log1pf, 4
// divisions) at the float32 rate; the bytes bound is the larger. Most
// rows of a Zipf stream are a few dozen cells, so per-row fixed work,
// not bytes, holds the kernel: the short class keeps that to one warp's.
// Build without fast math and with -fmad=false so every product and
// quotient rounds as in the plain PyTorch version.

#include "topk_block.cuh"

namespace {

using namespace topk_block;

constexpr int kCellsAhead = 4;  // cells a thread loads before queueing

// A scored row's slab region, or an empty row (all lanes (-inf, 0)) for a
// row id outside row_sums or a region outside the slab: never a read out
// of bounds.
template <typename CellT>
struct SlabRow {
  const CellT* crow;
  const int32_t* drow;
  int len;
  bool valid;
};

template <typename CellT>
__device__ __forceinline__ SlabRow<CellT> slab_row(
    const CellT* cnt, const int32_t* dst, const int32_t* rows,
    const int32_t* starts, const int32_t* lens, int s, int num_items,
    long long cap) {
  const int r = rows[s];
  const int start = starts[s];
  const int len = lens[s];
  const bool valid = r >= 0 && r < num_items && start >= 0 && len >= 0 &&
                     static_cast<long long>(start) + len <= cap;
  const int off = valid ? start : 0;
  return SlabRow<CellT>{cnt + off, dst + off, valid ? len : 0, valid};
}

// Queue the nonzero cells of a row, `stride` threads walking it with this
// thread at offset `t`; every lane of the warp calls.
template <typename CellT>
__device__ __forceinline__ void walk(WarpLists& w, Sel& sel,
                                     const SlabRow<CellT>& row, int t,
                                     int stride, const RowScorer& sc,
                                     int top_k) {
  const int hi = row.len;
  for (int base = 0; base < hi; base += stride * kCellsAhead) {
    int c[kCellsAhead], d[kCellsAhead];
#pragma unroll
    for (int u = 0; u < kCellsAhead; ++u) {
      const int j = base + u * stride + t;
      c[u] = j < hi ? static_cast<int>(__ldg(row.crow + j)) : 0;
      d[u] = j < hi ? __ldg(row.drow + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kCellsAhead; ++u) {
      const int j = base + u * stride + t;
      warp_push(w, sel, c[u] != 0, j, c[u], d[u], sc, top_k);
    }
  }
}

// Write a finished list: scores, and the partner id of each chosen slab
// position (0 for an empty lane).
template <typename CellT>
__device__ __forceinline__ void write_row(const float* lv, const int* lc,
                                          const SlabRow<CellT>& row, int s,
                                          int i0, int stride, int top_k,
                                          float* out_vals, int32_t* out_idx) {
  for (int i = i0; i < top_k; i += stride) {
    const size_t o = static_cast<size_t>(s) * top_k + i;
    out_vals[o] = lv[i];
    out_idx[o] = lc[i] == kNoKey ? 0 : row.drow[lc[i]];
  }
}

// Blocks [0, num_rows - n_short): one long row each; blocks after them:
// eight short rows each, one a warp.
template <typename CellT>
__global__ void __launch_bounds__(kThreads)
rect_topk_kernel(const CellT* __restrict__ cnt,
                 const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ row_sums,
                 const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ lens, int num_rows,
                 int num_items, long long cap, float observed, int top_k,
                 int n_short, float* __restrict__ out_vals,
                 int32_t* __restrict__ out_idx) {
  __shared__ BlockLists sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_long = num_rows - n_short;
  WarpLists& w = sm.w[warp];
  Sel sel;

  if (static_cast<int>(blockIdx.x) >= n_long) {  // short rows
    const int idx = (static_cast<int>(blockIdx.x) - n_long) * kWarps + warp;
    if (idx >= n_short) return;
    const int s = n_short - 1 - idx;
    warp_init(w, sel, top_k);
    const SlabRow<CellT> row = slab_row(cnt, dst, rows, starts, lens, s,
                                        num_items, cap);
    if (row.valid) {
      const RowScorer sc{static_cast<float>(row_sums[rows[s]]), observed,
                         row_sums, num_items};
      walk(w, sel, row, lane, 32, sc, top_k);
      warp_finish(w, sel, sc, top_k);
    }
    write_row(w.run_v[sel.cur], w.run_c[sel.cur], row, s, lane, 32, top_k,
              out_vals, out_idx);
    return;
  }

  const int s = num_rows - 1 - static_cast<int>(blockIdx.x);
  warp_init(w, sel, top_k);
  const SlabRow<CellT> row = slab_row(cnt, dst, rows, starts, lens, s,
                                      num_items, cap);
  if (row.valid) {
    const RowScorer sc{static_cast<float>(row_sums[rows[s]]), observed,
                       row_sums, num_items};
    walk(w, sel, row, tid, kThreads, sc, top_k);
    warp_finish(w, sel, sc, top_k);
  }
  const int cur = block_merge(sm, sel, top_k);
  write_row(sm.w[0].run_v[cur], sm.w[0].run_c[cur], row, s, tid, kThreads,
            top_k, out_vals, out_idx);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for `num_rows` rows of a slab of `cap`
// cells over `num_items` row sums, the first `n_short` of them one warp
// each; `cell_bytes` is the width of cnt's cells (4 = int32, 2 = int16,
// 1 = int8). Returns the CUDA error code of the launch (0 = launched).
int rect_topk_launch(const void* cnt, int cell_bytes, const int32_t* dst,
                     const int32_t* row_sums, const int32_t* rows,
                     const int32_t* starts, const int32_t* lens,
                     int num_rows, int num_items, long long cap,
                     float observed, int top_k, int n_short, float* out_vals,
                     int32_t* out_idx, void* stream) {
  if (top_k < 1 || top_k > kMaxK || num_rows < 0 || num_items < 0 ||
      cap < 0 || n_short < 0 || n_short > num_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  const int blocks = num_rows - n_short + (n_short + kWarps - 1) / kWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cell_bytes == 4) {
    rect_topk_kernel<int32_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(cnt), dst, row_sums, rows, starts, lens,
        num_rows, num_items, cap, observed, top_k, n_short, out_vals,
        out_idx);
  } else if (cell_bytes == 2) {
    rect_topk_kernel<int16_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const int16_t*>(cnt), dst, row_sums, rows, starts, lens,
        num_rows, num_items, cap, observed, top_k, n_short, out_vals,
        out_idx);
  } else if (cell_bytes == 1) {
    rect_topk_kernel<int8_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const int8_t*>(cnt), dst, row_sums, rows, starts, lens,
        num_rows, num_items, cap, observed, top_k, n_short, out_vals,
        out_idx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rect_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
