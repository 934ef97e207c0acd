// Shared device code of the port's LLR + streaming top-K kernels
// (score_topk.cu, rect_topk.cu): the float32 LLR of one contingency cell
// and the block-wide merge of one tile of scores into a running top K.
//
// The LLR is the stable log1p form of ops/llr.py, term for term. Build
// without fast math and with -fmad=false so every product and quotient
// rounds as in the plain PyTorch versions.
//
// The running top K lives in shared memory, ordered by (score desc,
// key asc): a key is a column (dense kernel) or a slab position (rect
// kernel), so the lowest key wins among equal scores, as lax.top_k keeps
// the lowest index. A tile is merged only when its max beats the running
// K-th score (the TPU kernels' threshold skip); the merge keeps only
// candidates strictly above that score (an equal score from a later key
// always loses to the earlier one), sorts them bitonically, and merges
// the two sorted lists by rank.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk_block {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // keys per tile
constexpr int kMaxK = 128;                    // largest top_k carried
constexpr int kNoKey = 0x7fffffff;            // key of an empty lane

// (av, ac) ranks ahead of (bv, bc): higher score, then lower key.
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

// LLR of the cell with count k11 in a row of sum rsi whose partner row
// has sum rsj, out of `observed` co-occurrences.
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

struct Shared {
  float cand_v[kTile];
  int cand_c[kTile];
  float run_v[kMaxK];
  int run_c[kMaxK];
  float new_v[kMaxK];
  int new_c[kMaxK];
  float warp_max[kThreads / 32];
  int n_cand;
};

// Empty running top K: every lane (-inf, kNoKey).
__device__ __forceinline__ void init(Shared& sm) {
  for (int k = threadIdx.x; k < kMaxK; k += kThreads) {
    sm.run_v[k] = -INFINITY;
    sm.run_c[k] = kNoKey;
  }
  __syncthreads();
}

// Merge one tile into the running top K. Thread `tid` holds in v[p] the
// score of key base + p * kThreads + tid (-inf for no candidate). Every
// thread of the block calls it. Inlined, so v stays in registers.
__device__ __forceinline__ void merge_tile(Shared& sm, const float (&v)[kPerThread],
                           int base, int top_k) {
  const int tid = threadIdx.x;
  float local_max = -INFINITY;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) local_max = fmaxf(local_max, v[p]);
  for (int off = 16; off > 0; off >>= 1) {
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  }
  if ((tid & 31) == 0) sm.warp_max[tid >> 5] = local_max;
  if (tid == 0) sm.n_cand = 0;
  __syncthreads();
  float tile_max = sm.warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    tile_max = fmaxf(tile_max, sm.warp_max[w]);
  }
  const float thresh = sm.run_v[top_k - 1];
  if (!(tile_max > thresh)) {  // block-uniform: skip the merge
    __syncthreads();
    return;
  }

  // Compact the candidates that can enter the top K.
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    if (v[p] > thresh) {
      const int pos = atomicAdd(&sm.n_cand, 1);
      sm.cand_v[pos] = v[p];
      sm.cand_c[pos] = base + p * kThreads + tid;
    }
  }
  __syncthreads();
  const int n = sm.n_cand;
  int span = 1;
  while (span < n) span <<= 1;
  for (int i = n + tid; i < span; i += kThreads) {
    sm.cand_v[i] = -INFINITY;
    sm.cand_c[i] = kNoKey;
  }
  __syncthreads();

  // Bitonic sort of cand[0, span) into rank order (best first).
  for (int k = 2; k <= span; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < span; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const float av = sm.cand_v[i], bv = sm.cand_v[ixj];
          const int ac = sm.cand_c[i], bc = sm.cand_c[ixj];
          const bool best_first = (i & k) == 0;
          if (best_first ? beats(bv, bc, av, ac) : beats(av, ac, bv, bc)) {
            sm.cand_v[i] = bv;
            sm.cand_c[i] = bc;
            sm.cand_v[ixj] = av;
            sm.cand_c[ixj] = ac;
          }
        }
      }
      __syncthreads();
    }
  }

  // Merge the two sorted lists by rank: an element's place in the union
  // is its own index plus the number of elements of the other list that
  // beat it. Keys never tie across the lists (candidate keys are new;
  // empty running lanes hold -inf).
  const int m = n < top_k ? n : top_k;
  for (int i = tid; i < top_k; i += kThreads) {
    const float rv = sm.run_v[i];
    const int rc = sm.run_c[i];
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (beats(sm.cand_v[mid], sm.cand_c[mid], rv, rc)) lo = mid + 1;
      else hi = mid;
    }
    if (i + lo < top_k) {
      sm.new_v[i + lo] = rv;
      sm.new_c[i + lo] = rc;
    }
  }
  for (int j = tid; j < m; j += kThreads) {
    const float cv = sm.cand_v[j];
    const int cc = sm.cand_c[j];
    int lo = 0, hi = top_k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (beats(sm.run_v[mid], sm.run_c[mid], cv, cc)) lo = mid + 1;
      else hi = mid;
    }
    if (j + lo < top_k) {
      sm.new_v[j + lo] = cv;
      sm.new_c[j + lo] = cc;
    }
  }
  __syncthreads();
  for (int i = tid; i < top_k; i += kThreads) {
    sm.run_v[i] = sm.new_v[i];
    sm.run_c[i] = sm.new_c[i];
  }
  __syncthreads();
}

}  // namespace topk_block
