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
// int16 vocabulary ceiling).
//
// int16 C: CUDA has no 16-bit integer atomicAdd, so a 16-bit add is a loop
// on the 16-bit atomicCAS (sm_70 and later), which touches the cell's own
// two bytes only, modulo 2^16: counts wrap like the reference's Java
// shorts, and since modular addition is order-free the result is exact
// whatever order the atomics land in. int32 C and the row sums use the
// native atomicAdd (also modular).
//
// Design: one warp per op, eight ops per 256-thread block. The warp's
// lanes walk the basket row with neighbouring lanes on neighbouring cells
// (coalesced reads); each valid cell costs three atomics (two C cells, one
// row sum); row_sums[new] is reduced across the warp to one atomic per op,
// because Zipf makes a few new items recur in many ops.
//
// Bound on this card: bytes. The block is read once (4 n (W + 4) bytes),
// and each distinct 32-byte sector of C and of the row sums that the
// launch touches is read and written once (64 bytes); repeated adds to a
// sector can stay in L2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ void add_count(int32_t* C, size_t off, int v) {
  atomicAdd(C + off, v);
}

__device__ __forceinline__ void add_count(int16_t* C, size_t off, int v) {
  unsigned short* cell = reinterpret_cast<unsigned short*>(C + off);
  const unsigned short add = static_cast<unsigned short>(v);
  unsigned short old = *cell;
  unsigned short assumed;
  do {
    assumed = old;
    old = atomicCAS(cell, assumed,
                    static_cast<unsigned short>(assumed + add));
  } while (assumed != old);
}

template <typename CountT>
__global__ void __launch_bounds__(kThreads)
expand_scatter_kernel(const int32_t* __restrict__ block, int n_ops, int width,
                      CountT* __restrict__ C, int32_t* __restrict__ row_sums,
                      int num_items) {
  const int lane = threadIdx.x & 31;
  const int op = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (op >= n_ops) return;  // whole warps only: op is uniform in a warp

  const int32_t* row = block + static_cast<size_t>(op) * (width + 4);
  const int32_t nw = row[width];
  const int32_t len = row[width + 1];
  const int32_t skip = row[width + 2];
  const int32_t sign = row[width + 3];
  const int end = min(len, width);

  int count = 0;
  if (nw >= 0 && nw < num_items) {
    const size_t new_row = static_cast<size_t>(nw) * num_items;
    for (int j = lane; j < end; j += 32) {
      if (j == skip) continue;
      const int32_t p = row[j];  // j < len: a specified cell
      if (p < 0 || p >= num_items) continue;
      add_count(C, new_row + p, sign);
      add_count(C, static_cast<size_t>(p) * num_items + nw, sign);
      atomicAdd(row_sums + p, sign);
      ++count;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  if (lane == 0 && count != 0) {
    // sign * count modulo 2^32, as count separate int32 adds would be.
    const unsigned int total =
        static_cast<unsigned int>(sign) * static_cast<unsigned int>(count);
    atomicAdd(row_sums + nw, static_cast<int>(total));
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for the `n_ops` ops of `block`
// ([n_ops, width + 4] int32); `count_bytes` is the width of C's cells
// (4 = int32, 2 = int16). Returns the
// CUDA error code of the launch (0 = launched).
int expand_scatter_launch(const int32_t* block, int n_ops, int width,
                          void* C, int count_bytes, int32_t* row_sums,
                          int num_items, void* stream) {
  if (n_ops < 0 || width < 0 || num_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ops == 0) return 0;
  const unsigned int grid = static_cast<unsigned int>(
      (static_cast<long long>(n_ops) + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 4) {
    expand_scatter_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        block, n_ops, width, static_cast<int32_t*>(C), row_sums, num_items);
  } else if (count_bytes == 2) {
    expand_scatter_kernel<int16_t><<<grid, kThreads, 0, st>>>(
        block, n_ops, width, static_cast<int16_t*>(C), row_sums, num_items);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* expand_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
