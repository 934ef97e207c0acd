// Fused LLR scoring + streaming top-K over dense count rows, for Hopper.
//
// Replaces the Pallas TPU kernel `_score_topk_kernel`
// (tpu_cooccurrence/ops/pallas_score.py), as called by `pallas_score_topk`
// (the whole C) and by `pallas_score_topk_local` (the sharded backend: a
// local row block of C at offset `row_lo`, against the global row sums).
// For each of S scored rows r it builds, per column j, the f32 contingency
//   k11 = C[r, j], k12 = rs[r] - k11, k21 = rs[j] - k11,
//   k22 = observed + k11 - k12 - k21
// scores it with the stable log1p form of the LLR (ops/llr.py, term for
// term), masks zero counts to -inf, and keeps the row's top K, scores
// descending, the lowest column winning among equal scores (lax.top_k's
// rule).
//
// Design: one block of eight warps per scored row, reading row rows[s] of
// C itself (no pre-gathered [S, I] copy) and carrying column ids as int32
// (no f32-id vocabulary cap). C holds the local rows [row_lo, row_lo +
// local_rows) of the I x I matrix (the whole matrix: row_lo 0, local_rows
// I); a global row r reads C at (r - row_lo) * I and its own sum at
// row_sums[r], and a row outside the block is an empty row.
// - Loads: the row's 16-byte-aligned body is read as int4 (4 int32 or
//   8 int16 cells a load), neighbouring threads on neighbouring vectors,
//   and each thread loads its next vector before it scores the current
//   one, so loads stay in flight while the warps select. The unaligned
//   head and tail (under 16 bytes each) are read one cell a lane by
//   warp 0.
// - Work: only nonzero cells are scored. Each warp queues them with a
//   ballot and scores 32 at a time, one a lane (no lane computes the LLR
//   of a zero cell), reading row_sums[j] (80 KB at I = 20,000, hot in L1
//   and L2) for the queued cells only.
// - Selection: each warp keeps its own running top K behind a register
//   threshold on (score, column) and merges a candidate buffer into it
//   by rank; the eight lists are merged once per row (topk_block.cuh).
//   No block barrier runs while the row is read.
//
// Bound on this card: the bytes of the S rows of C (each read once); the
// four IEEE log1pf and four IEEE divisions per nonzero cell cost far more
// instructions than the 8 operations the bound charges, so a row with
// many nonzero cells is held by them. Build without fast math and with
// -fmad=false so every product and quotient rounds as in the plain
// PyTorch version.

#include "topk_block.cuh"

namespace {

using namespace topk_block;

// Cell q of a 16-byte vector of CountT cells (little-endian).
template <typename CountT>
__device__ __forceinline__ int cell_at(const int4& v, int q) {
  const int word = sizeof(CountT) == 4 ? q : q >> 1;
  const int x = word == 0 ? v.x : word == 1 ? v.y : word == 2 ? v.z : v.w;
  if (sizeof(CountT) == 4) return x;
  return (q & 1) ? (x >> 16) : static_cast<int>(static_cast<int16_t>(x));
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
score_topk_kernel(const CountT* __restrict__ C,
                  const int32_t* __restrict__ row_sums,
                  const int32_t* __restrict__ rows, int num_items,
                  int row_lo, int local_rows, float observed, int top_k,
                  float* __restrict__ out_vals,
                  int32_t* __restrict__ out_idx) {
  __shared__ BlockLists sm;
  constexpr int kVec = 16 / sizeof(CountT);  // cells per int4

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  WarpLists& w = sm.w[warp];
  Sel sel;
  warp_init(w, sel, top_k);
  const int r = rows[s];
  const int lr = r - row_lo;  // the row in the local block
  // A row id outside the block yields an empty row (all lanes -inf),
  // never a read out of bounds.
  if (r >= 0 && r < num_items && lr >= 0 && lr < local_rows) {
    const CountT* crow = C + static_cast<size_t>(lr) * num_items;
    const RowScorer sc{static_cast<float>(row_sums[r]), observed, row_sums,
                       num_items};
    const int mis = static_cast<int>(
        (reinterpret_cast<uintptr_t>(crow) & 15) / sizeof(CountT));
    const int head = min(mis ? kVec - mis : 0, num_items);
    const int nvec = (num_items - head) / kVec;
    const int body_end = head + nvec * kVec;
    if (warp == 0) {  // head and tail: fewer than 2 * kVec cells
      const int n_edge = head + (num_items - body_end);
      const int j = lane < head ? lane : body_end + (lane - head);
      const int cnt = lane < n_edge ? static_cast<int>(crow[j]) : 0;
      warp_push(w, sel, cnt != 0, j, cnt, j, sc, top_k);
    }
    const int4* body = reinterpret_cast<const int4*>(crow + head);
    int4 next = tid < nvec ? __ldcs(body + tid) : make_int4(0, 0, 0, 0);
    for (int b = 0; b < nvec; b += kThreads) {
      const int4 cur = next;
      const int t = b + kThreads + tid;
      next = t < nvec ? __ldcs(body + t) : make_int4(0, 0, 0, 0);
      const int j0 = head + (b + tid) * kVec;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const int cnt = cell_at<CountT>(cur, q);
        // Lanes past the body hold zeros and queue nothing.
        warp_push(w, sel, cnt != 0, j0 + q, cnt, j0 + q, sc, top_k);
      }
    }
    warp_finish(w, sel, sc, top_k);
  }

  const int cur = block_merge(sm, sel, top_k);
  const float* fv = sm.w[0].run_v[cur];
  const int* fc = sm.w[0].run_c[cur];
  for (int i = tid; i < top_k; i += kThreads) {
    const size_t o = static_cast<size_t>(s) * top_k + i;
    out_vals[o] = fv[i];
    out_idx[o] = fc[i] == kNoKey ? 0 : fc[i];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for `num_rows` rows; `count_bytes` is
// the width of C's cells (4 = int32, 2 = int16); C holds the
// `local_rows` rows of the I x I matrix that start at global row
// `row_lo`. Returns the CUDA error code of the launch (0 = launched).
int score_topk_launch(const void* C, int count_bytes,
                      const int32_t* row_sums, const int32_t* rows,
                      int num_rows, int num_items, int row_lo,
                      int local_rows, float observed, int top_k,
                      float* out_vals, int32_t* out_idx, void* stream) {
  if (top_k < 1 || top_k > kMaxK || num_rows < 0 || num_items < 0 ||
      row_lo < 0 || local_rows < 0 || row_lo > num_items - local_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 4) {
    score_topk_kernel<int32_t><<<num_rows, kThreads, 0, st>>>(
        static_cast<const int32_t*>(C), row_sums, rows, num_items, row_lo,
        local_rows, observed, top_k, out_vals, out_idx);
  } else if (count_bytes == 2) {
    score_topk_kernel<int16_t><<<num_rows, kThreads, 0, st>>>(
        static_cast<const int16_t*>(C), row_sums, rows, num_items, row_lo,
        local_rows, observed, top_k, out_vals, out_idx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* score_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
