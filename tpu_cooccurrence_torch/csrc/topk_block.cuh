// Shared device code of the port's LLR + streaming top-K kernels
// (score_topk.cu, rect_topk.cu): the float32 LLR of one contingency cell
// and warp-level top-K selection.
//
// The LLR is the stable log1p form of ops/llr.py, term for term. Build
// without fast math and with -fmad=false so every product and quotient
// rounds as in the plain PyTorch versions.
//
// Selection order: (score desc, key asc), where a key is a column (dense
// kernel) or a slab position (rect kernel), so the lowest key wins among
// equal scores, as lax.top_k keeps the lowest index. A cell enters only
// when its score is above -inf (zero counts score -inf; NaN never
// enters) and it beats the running K-th entry on (score, key): warps see
// keys in no common order, so an equal score with a lower key must still
// enter. Any exact selection under this total order gives the plain
// version's lanes bit for bit.
//
// Each warp keeps its own running top K (K <= kMaxK) in shared memory,
// with no block barrier on its path:
// - nonzero cells are appended to a per-warp queue with __ballot_sync /
//   __popc and scored 32 at a time, one a lane, so no lane computes an
//   LLR for a zero cell (warp_push, warp_drain);
// - each score is filtered against the warp-uniform K-th entry held in
//   registers; survivors are appended to a per-warp candidate buffer the
//   same way (warp_offer);
// - when 32 or more wait, the warp sorts the buffer (rank by counting)
//   and merges it into the running list by rank (binary searches), into
//   the other half of a ping-pong pair (warp_flush). This is the
//   WarpSelect shape.
// A block that scores one row with all its warps merges their lists once
// at the end, pairwise in three levels (block_merge).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk_block {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;          // largest top_k carried
constexpr int kNoKey = 0x7fffffff;  // key of an empty lane
constexpr int kBuf = 64;            // candidate buffer, flushed at 32
constexpr int kQueue = 64;          // nonzero cells waiting, scored at 32

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

// What a cell's score needs besides its count and partner.
struct RowScorer {
  float rsi;            // the scored row's own sum
  float observed;
  const int32_t* row_sums;
  int num_items;
};

// One warp's running top K (two halves, ping-pong), candidate buffer,
// sorted-buffer scratch and queue of nonzero cells.
struct WarpLists {
  float run_v[2][kMaxK];
  int run_c[2][kMaxK];
  float buf_v[kBuf];
  int buf_c[kBuf];
  float srt_v[kBuf];
  int srt_c[kBuf];
  int q_key[kQueue];
  int q_cnt[kQueue];
  int q_dst[kQueue];
};

// A block's eight warps' lists, and which half holds each running list
// while block_merge runs.
struct BlockLists {
  WarpLists w[kWarps];
  int cur[kWarps];
};

// A warp's selection state, in registers, the same in every lane.
struct Sel {
  int cur;      // half of run_* holding the running top K
  int n;        // candidates in buf
  int q;        // cells in the queue
  float thr_v;  // the running K-th entry
  int thr_c;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Empty running top K: every lane (-inf, kNoKey).
__device__ __forceinline__ void warp_init(WarpLists& w, Sel& s, int top_k) {
  for (int i = lane_id(); i < top_k; i += 32) {
    w.run_v[0][i] = -INFINITY;
    w.run_c[0][i] = kNoKey;
  }
  s.cur = 0;
  s.n = 0;
  s.q = 0;
  s.thr_v = -INFINITY;
  s.thr_c = kNoKey;
  __syncwarp();
}

// May (v, key) enter the running top K? Above -inf (NaN is not), and
// ahead of the K-th entry on (score, key).
__device__ __forceinline__ bool enters(const Sel& s, float v, int key) {
  return v > -INFINITY && beats(v, key, s.thr_v, s.thr_c);
}

// How many of the first n entries of a sorted list beat (v, c).
__device__ __forceinline__ int rank_in(const float* lv, const int* lc, int n,
                                       float v, int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (beats(lv[mid], lc[mid], v, c)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge the candidate buffer into the running top K. Keys are distinct
// across buffer and list, except the empty lanes' (-inf, kNoKey), which
// every candidate beats; so the ranks are a permutation of the union.
__device__ __noinline__ Sel warp_flush(WarpLists& w, Sel s, int top_k) {
  __syncwarp();
  const int lane = lane_id();
  const int m = s.n;
  const float* rv = w.run_v[s.cur];
  const int* rc = w.run_c[s.cur];
  float* nv = w.run_v[s.cur ^ 1];
  int* nc = w.run_c[s.cur ^ 1];
  float bv[2];
  int bc[2], br[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    br[h] = top_k;
    bv[h] = -INFINITY;
    bc[h] = kNoKey;
    if (i < m) {
      bv[h] = w.buf_v[i];
      bc[h] = w.buf_c[i];
      int r = 0;
      for (int t = 0; t < m; ++t) {
        r += beats(w.buf_v[t], w.buf_c[t], bv[h], bc[h]) ? 1 : 0;
      }
      w.srt_v[r] = bv[h];
      w.srt_c[r] = bc[h];
      br[h] = r + rank_in(rv, rc, top_k, bv[h], bc[h]);
    }
  }
  __syncwarp();
  for (int i = lane; i < top_k; i += 32) {
    const float v = rv[i];
    const int c = rc[i];
    const int r = i + rank_in(w.srt_v, w.srt_c, m, v, c);
    if (r < top_k) {
      nv[r] = v;
      nc[r] = c;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (br[h] < top_k) {
      nv[br[h]] = bv[h];
      nc[br[h]] = bc[h];
    }
  }
  __syncwarp();
  s.cur ^= 1;
  s.n = 0;
  s.thr_v = nv[top_k - 1];
  s.thr_c = nc[top_k - 1];
  return s;
}

// Every lane calls: the lanes with `want` append (v, key) to the
// candidate buffer; 32 or more waiting are merged.
__device__ __forceinline__ void warp_offer(WarpLists& w, Sel& s, bool want,
                                           float v, int key, int top_k) {
  const unsigned mask = __ballot_sync(0xffffffffu, want);
  if (want) {
    const int pos = s.n + __popc(mask & ((1u << lane_id()) - 1u));
    w.buf_v[pos] = v;
    w.buf_c[pos] = key;
  }
  s.n += __popc(mask);
  if (s.n >= 32) s = warp_flush(w, s, top_k);
}

// Score the first n (<= 32) queued cells, one a lane, offer them, and
// move the rest of the queue to its front.
__device__ __forceinline__ void warp_drain(WarpLists& w, Sel& s, int n,
                                           const RowScorer& sc, int top_k) {
  __syncwarp();
  const int lane = lane_id();
  float v = -INFINITY;
  int key = kNoKey;
  if (lane < n) {
    key = w.q_key[lane];
    const int d = w.q_dst[lane];
    const int32_t rsj =
        (d >= 0 && d < sc.num_items) ? __ldg(sc.row_sums + d) : 0;
    v = cell_score(static_cast<float>(w.q_cnt[lane]), sc.rsi,
                   static_cast<float>(rsj), sc.observed);
  }
  const int rest = s.q - n;
  int mk = 0, mc = 0, md = 0;
  if (lane < rest) {
    mk = w.q_key[n + lane];
    mc = w.q_cnt[n + lane];
    md = w.q_dst[n + lane];
  }
  __syncwarp();
  if (lane < rest) {
    w.q_key[lane] = mk;
    w.q_cnt[lane] = mc;
    w.q_dst[lane] = md;
  }
  s.q = rest;
  warp_offer(w, s, lane < n && enters(s, v, key), v, key, top_k);
}

// Every lane calls: the lanes with `want` queue their cell (key, count,
// partner id); 32 or more waiting are scored.
__device__ __forceinline__ void warp_push(WarpLists& w, Sel& s, bool want,
                                          int key, int cnt, int dst,
                                          const RowScorer& sc, int top_k) {
  const unsigned mask = __ballot_sync(0xffffffffu, want);
  if (want) {
    const int pos = s.q + __popc(mask & ((1u << lane_id()) - 1u));
    w.q_key[pos] = key;
    w.q_cnt[pos] = cnt;
    w.q_dst[pos] = dst;
  }
  s.q += __popc(mask);
  if (s.q >= 32) warp_drain(w, s, 32, sc, top_k);
}

// Score what is queued and merge what is buffered: the warp's running
// top K is then final.
__device__ __forceinline__ void warp_finish(WarpLists& w, Sel& s,
                                           const RowScorer& sc, int top_k) {
  if (s.q > 0) warp_drain(w, s, s.q, sc, top_k);
  if (s.n > 0) s = warp_flush(w, s, top_k);
}

// Every thread of the block calls, after each warp's warp_finish: merge
// the eight warps' lists pairwise (three levels, one barrier each) into
// warp 0's. Returns the half of sm.w[0].run_* that holds the result.
// Keys are distinct across warps except the empty lanes, whose equal
// (-inf, kNoKey) entries may land on one slot with the same bytes.
__device__ __forceinline__ int block_merge(BlockLists& sm, const Sel& s,
                                           int top_k) {
  const int warp = threadIdx.x >> 5;
  const int lane = lane_id();
  if (lane == 0) sm.cur[warp] = s.cur;
  __syncthreads();
  for (int step = 1; step < kWarps; step <<= 1) {
    if ((warp & (2 * step - 1)) == 0) {
      const int ca = sm.cur[warp];
      const int cb = sm.cur[warp + step];
      const float* av = sm.w[warp].run_v[ca];
      const int* ac = sm.w[warp].run_c[ca];
      const float* bv = sm.w[warp + step].run_v[cb];
      const int* bc = sm.w[warp + step].run_c[cb];
      float* ov = sm.w[warp].run_v[ca ^ 1];
      int* oc = sm.w[warp].run_c[ca ^ 1];
      for (int i = lane; i < top_k; i += 32) {
        const int ra = i + rank_in(bv, bc, top_k, av[i], ac[i]);
        if (ra < top_k) {
          ov[ra] = av[i];
          oc[ra] = ac[i];
        }
        const int rb = i + rank_in(av, ac, top_k, bv[i], bc[i]);
        if (rb < top_k) {
          ov[rb] = bv[i];
          oc[rb] = bc[i];
        }
      }
      __syncwarp();
      if (lane == 0) sm.cur[warp] = ca ^ 1;
    }
    __syncthreads();
  }
  return sm.cur[0];
}

}  // namespace topk_block
