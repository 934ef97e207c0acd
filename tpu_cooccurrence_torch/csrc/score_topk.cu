// Fused LLR scoring + streaming top-K over dense count rows, for Hopper.
//
// Replaces the Pallas TPU kernel `_score_topk_kernel`
// (tpu_cooccurrence/ops/pallas_score.py), as called by `pallas_score_topk`.
// For each of S scored rows r it builds, per column j, the f32 contingency
//   k11 = C[r, j], k12 = rs[r] - k11, k21 = rs[j] - k11,
//   k22 = observed + k11 - k12 - k21
// scores it with the stable log1p form of the LLR (ops/llr.py, term for
// term), masks zero counts to -inf, and keeps the row's top K, scores
// descending, the lowest column winning among equal scores (lax.top_k's
// rule).
//
// Design: one block per scored row, reading row rows[s] of C itself (no
// pre-gathered [S, I] copy) and carrying column ids as int32 (no f32-id
// vocabulary cap). The block walks the row in tiles of 2048 columns; each
// thread scores 8 columns into registers, and topk_block::merge_tile
// folds the tile into the running top K in shared memory (threshold
// skip, bitonic sort, merge by rank; topk_block.cuh).
//
// Bound on this card: the bytes of the S rows of C (each read once);
// in practice the four IEEE log1pf and four IEEE divisions per cell
// dominate. Build without fast math and with -fmad=false so every
// product and quotient rounds as in the plain PyTorch version.

#include "topk_block.cuh"

namespace {

using namespace topk_block;

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
score_topk_kernel(const CountT* __restrict__ C,
                  const int32_t* __restrict__ row_sums,
                  const int32_t* __restrict__ rows, int num_items,
                  float observed, int top_k, float* __restrict__ out_vals,
                  int32_t* __restrict__ out_idx) {
  __shared__ Shared sm;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = rows[s];
  // A row id outside C yields an empty row (all lanes -inf), never a
  // read out of bounds.
  const bool valid_row = r >= 0 && r < num_items;
  init(sm);

  if (valid_row) {
    const CountT* crow = C + static_cast<size_t>(r) * num_items;
    const float rsi = static_cast<float>(row_sums[r]);
    for (int base = 0; base < num_items; base += kTile) {
      float v[kPerThread];
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        const int j = base + p * kThreads + tid;
        float sc = -INFINITY;
        if (j < num_items) {
          const CountT cnt = crow[j];
          if (cnt != 0) {
            sc = cell_score(static_cast<float>(cnt), rsi,
                            static_cast<float>(row_sums[j]), observed);
          }
        }
        v[p] = sc;
      }
      merge_tile(sm, v, base, top_k);
    }
  }

  for (int i = tid; i < top_k; i += kThreads) {
    const size_t o = static_cast<size_t>(s) * top_k + i;
    out_vals[o] = sm.run_v[i];
    out_idx[o] = sm.run_c[i] == kNoKey ? 0 : sm.run_c[i];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for `num_rows` rows; `count_bytes` is
// the width of C's cells (4 = int32, 2 = int16). Returns the CUDA error
// code of the launch (0 = launched).
int score_topk_launch(const void* C, int count_bytes,
                      const int32_t* row_sums, const int32_t* rows,
                      int num_rows, int num_items, float observed, int top_k,
                      float* out_vals, int32_t* out_idx, void* stream) {
  if (top_k < 1 || top_k > kMaxK || num_rows < 0 || num_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 4) {
    score_topk_kernel<int32_t><<<num_rows, kThreads, 0, st>>>(
        static_cast<const int32_t*>(C), row_sums, rows, num_items, observed,
        top_k, out_vals, out_idx);
  } else if (count_bytes == 2) {
    score_topk_kernel<int16_t><<<num_rows, kThreads, 0, st>>>(
        static_cast<const int16_t*>(C), row_sums, rows, num_items, observed,
        top_k, out_vals, out_idx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* score_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
