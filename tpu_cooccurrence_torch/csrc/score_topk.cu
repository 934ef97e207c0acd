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
// thread scores 8 columns into registers. A tile is merged into the
// running top K (in shared memory) only when its max beats the running
// K-th score — the threshold skip of the TPU kernel. The merge keeps only
// candidates strictly above that score (an equal score from a later
// column always loses to the earlier one), sorts them bitonically by
// (score desc, column asc), and merges the two sorted lists by rank.
//
// Bound on this card: the bytes of the S rows of C (each read once);
// in practice the four IEEE log1pf and four IEEE divisions per cell
// dominate. Build without fast math and with -fmad=false so every
// product and quotient rounds as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // columns per tile
constexpr int kMaxK = 128;                    // largest top_k carried
constexpr int kNoCol = 0x7fffffff;            // id of an empty lane

// (av, ac) ranks ahead of (bv, bc): higher score, then lower column.
__device__ __forceinline__ bool beats(float av, int ac, float bv, int bc) {
  return av > bv || (av == bv && ac < bc);
}

// k * log1p(sign * det / rc) where k > 0 and rc > 0, else 0. The floor
// -1 + 1e-38 is -1.0f in float32, exactly as in the reference.
__device__ __forceinline__ float llr_term(float k, float rc, float det,
                                          float sign) {
  const float safe_rc = rc > 0.0f ? rc : 1.0f;
  const float x = (sign * det) / safe_rc;
  const float lg = log1pf(fmaxf(x, -1.0f + 1e-38f));
  return (k > 0.0f && rc > 0.0f) ? k * lg : 0.0f;
}

__device__ __forceinline__ float cell_score(float k11, float rsi, float rsj,
                                            float observed) {
  const float k12 = rsi - k11;
  const float k21 = rsj - k11;
  const float k22 = observed + k11 - k12 - k21;
  const float r1 = k11 + k12;
  const float r2 = k21 + k22;
  const float c1 = k11 + k21;
  const float c2 = k12 + k22;
  const float det = k11 * k22 - k12 * k21;
  const float out = 2.0f * (llr_term(k11, r1 * c1, det, 1.0f) +
                            llr_term(k12, r1 * c2, det, -1.0f) +
                            llr_term(k21, r2 * c1, det, -1.0f) +
                            llr_term(k22, r2 * c2, det, 1.0f));
  return out < 0.0f ? 0.0f : out;  // NaN passes through, as jnp.maximum
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
score_topk_kernel(const CountT* __restrict__ C,
                  const int32_t* __restrict__ row_sums,
                  const int32_t* __restrict__ rows, int num_items,
                  float observed, int top_k, float* __restrict__ out_vals,
                  int32_t* __restrict__ out_idx) {
  __shared__ float cand_v[kTile];
  __shared__ int cand_c[kTile];
  __shared__ float run_v[kMaxK];
  __shared__ int run_c[kMaxK];
  __shared__ float new_v[kMaxK];
  __shared__ int new_c[kMaxK];
  __shared__ float warp_max[kThreads / 32];
  __shared__ int n_cand;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = rows[s];
  // A row id outside C yields an empty row (all lanes -inf), never a
  // read out of bounds.
  const bool valid_row = r >= 0 && r < num_items;
  for (int k = tid; k < kMaxK; k += kThreads) {
    run_v[k] = -INFINITY;
    run_c[k] = kNoCol;
  }
  __syncthreads();

  if (valid_row) {
    const CountT* crow = C + static_cast<size_t>(r) * num_items;
    const float rsi = static_cast<float>(row_sums[r]);
    for (int base = 0; base < num_items; base += kTile) {
      float v[kPerThread];
      float local_max = -INFINITY;
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
        local_max = fmaxf(local_max, sc);
      }
      for (int off = 16; off > 0; off >>= 1) {
        local_max = fmaxf(local_max,
                          __shfl_xor_sync(0xffffffffu, local_max, off));
      }
      if ((tid & 31) == 0) warp_max[tid >> 5] = local_max;
      if (tid == 0) n_cand = 0;
      __syncthreads();
      float tile_max = warp_max[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) {
        tile_max = fmaxf(tile_max, warp_max[w]);
      }
      const float thresh = run_v[top_k - 1];
      if (!(tile_max > thresh)) {  // block-uniform: skip the merge
        __syncthreads();
        continue;
      }

      // Compact the candidates that can enter the top K.
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        if (v[p] > thresh) {
          const int pos = atomicAdd(&n_cand, 1);
          cand_v[pos] = v[p];
          cand_c[pos] = base + p * kThreads + tid;
        }
      }
      __syncthreads();
      const int n = n_cand;
      int span = 1;
      while (span < n) span <<= 1;
      for (int i = n + tid; i < span; i += kThreads) {
        cand_v[i] = -INFINITY;
        cand_c[i] = kNoCol;
      }
      __syncthreads();

      // Bitonic sort of cand[0, span) into rank order (best first).
      for (int k = 2; k <= span; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = tid; i < span; i += kThreads) {
            const int ixj = i ^ j;
            if (ixj > i) {
              const float av = cand_v[i], bv = cand_v[ixj];
              const int ac = cand_c[i], bc = cand_c[ixj];
              const bool best_first = (i & k) == 0;
              if (best_first ? beats(bv, bc, av, ac) : beats(av, ac, bv, bc)) {
                cand_v[i] = bv;
                cand_c[i] = bc;
                cand_v[ixj] = av;
                cand_c[ixj] = ac;
              }
            }
          }
          __syncthreads();
        }
      }

      // Merge the two sorted lists by rank: an element's place in the
      // union is its own index plus the number of elements of the other
      // list that beat it. Keys never tie across the lists (candidate
      // columns are new; empty running lanes hold -inf).
      const int m = n < top_k ? n : top_k;
      for (int i = tid; i < top_k; i += kThreads) {
        const float rv = run_v[i];
        const int rc = run_c[i];
        int lo = 0, hi = m;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (beats(cand_v[mid], cand_c[mid], rv, rc)) lo = mid + 1;
          else hi = mid;
        }
        if (i + lo < top_k) {
          new_v[i + lo] = rv;
          new_c[i + lo] = rc;
        }
      }
      for (int j = tid; j < m; j += kThreads) {
        const float cv = cand_v[j];
        const int cc = cand_c[j];
        int lo = 0, hi = top_k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (beats(run_v[mid], run_c[mid], cv, cc)) lo = mid + 1;
          else hi = mid;
        }
        if (j + lo < top_k) {
          new_v[j + lo] = cv;
          new_c[j + lo] = cc;
        }
      }
      __syncthreads();
      for (int i = tid; i < top_k; i += kThreads) {
        run_v[i] = new_v[i];
        run_c[i] = new_c[i];
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < top_k; i += kThreads) {
    const size_t o = static_cast<size_t>(s) * top_k + i;
    out_vals[o] = run_v[i];
    out_idx[o] = run_c[i] == kNoCol ? 0 : run_c[i];
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
