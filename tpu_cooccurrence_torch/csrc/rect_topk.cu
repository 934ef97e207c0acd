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
// Design: one block of 256 threads per row, walking the row in tiles of
// 2048 cells (8 per thread, neighbouring threads on neighbouring cells),
// each tile folded into the running top K by topk_block::merge_tile
// (threshold skip, bitonic sort, merge by rank). Block b scores row
// S - 1 - b: callers pass rows in ascending length buckets, so the
// longest rows start first. Rows shorter than a tile leave most of the
// block idle; most rows of a Zipf stream are that short.
//
// Bound on this card: 12 bytes per live cell (cnt, dst, row_sums[dst])
// plus the per-row meta and outputs, against about 8 float32 operations
// per cell (4 log1pf, 4 divisions) at the float32 rate; the bytes bound
// is the larger. Build without fast math and with -fmad=false so every
// product and quotient rounds as in the plain PyTorch version.

#include "topk_block.cuh"

namespace {

using namespace topk_block;

__global__ void __launch_bounds__(kThreads)
rect_topk_kernel(const int32_t* __restrict__ cnt,
                 const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ row_sums,
                 const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ lens, int num_rows,
                 int num_items, long long cap, float observed, int top_k,
                 float* __restrict__ out_vals,
                 int32_t* __restrict__ out_idx) {
  __shared__ Shared sm;

  const int s = num_rows - 1 - static_cast<int>(blockIdx.x);
  const int tid = threadIdx.x;
  const int r = rows[s];
  const int start = starts[s];
  const int len = lens[s];
  // A row id outside row_sums or a region outside the slab yields an
  // empty row (all lanes (-inf, 0)), never a read out of bounds.
  const bool valid_row = r >= 0 && r < num_items && start >= 0 && len >= 0 &&
                         static_cast<long long>(start) + len <= cap;
  const int32_t* crow = cnt + (valid_row ? start : 0);
  const int32_t* drow = dst + (valid_row ? start : 0);
  init(sm);

  if (valid_row) {
    const float rsi = static_cast<float>(row_sums[r]);
    for (int base = 0; base < len; base += kTile) {
      float v[kPerThread];
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        const int j = base + p * kThreads + tid;
        float sc = -INFINITY;
        if (j < len) {
          const int32_t k11 = crow[j];
          if (k11 != 0) {
            const int32_t d = drow[j];
            const int32_t rsj = (d >= 0 && d < num_items) ? row_sums[d] : 0;
            sc = cell_score(static_cast<float>(k11), rsi,
                            static_cast<float>(rsj), observed);
          }
        }
        v[p] = sc;
      }
      merge_tile(sm, v, base, top_k);
    }
  }

  for (int i = tid; i < top_k; i += kThreads) {
    const size_t o = static_cast<size_t>(s) * top_k + i;
    const int key = sm.run_c[i];
    out_vals[o] = sm.run_v[i];
    out_idx[o] = key == kNoKey ? 0 : drow[key];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for `num_rows` rows of a slab of `cap`
// cells over `num_items` row sums. Returns the CUDA error code of the
// launch (0 = launched).
int rect_topk_launch(const int32_t* cnt, const int32_t* dst,
                     const int32_t* row_sums, const int32_t* rows,
                     const int32_t* starts, const int32_t* lens,
                     int num_rows, int num_items, long long cap,
                     float observed, int top_k, float* out_vals,
                     int32_t* out_idx, void* stream) {
  if (top_k < 1 || top_k > kMaxK || num_rows < 0 || num_items < 0 ||
      cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  rect_topk_kernel<<<num_rows, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      cnt, dst, row_sums, rows, starts, lens, num_rows, num_items, cap,
      observed, top_k, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}

const char* rect_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
