// Membership counts kernel (K3): the aggregates of the dense sweep, read off the
// int8 membership M^T (captures x lines) in place.
//
// Replaces no TPU kernel: the JAX package takes these sums with XLA reductions
// (rdfind_tpu/models/allatonce.py:_stage_membership, ops/cooc.py:
// _stage_block_counts, models/small_to_large.py:_union_line_counts).  A torch
// reduction with a wider dtype first casts its whole input, so the port's
// plain sums made an int32 copy of M^T, four times its bytes, several times a
// job; here nothing wider than the int32 outputs is ever written.  The plain
// PyTorch versions it is held against are rdfind_tpu_torch/ops/kernels.py:
// membership_row_counts_plain and membership_line_counts_plain.
//
// Two kernels, one read of M^T each:
//   * membership_counts_rows_kernel: dep_count[c] = sum of row c (a capture's
//     lines), and block_counts[b][t] = sum of the entries of line block b
//     (kl lines) in the rows of dep tile t (tile rows): the record the sweep's
//     block-skip schedule is built from;
//   * membership_counts_lines_kernel: lens[l] = sum of column l over the rows
//     whose mask byte is set (the frequent captures), reading only those rows.
//
// What bounds it on an H100 SXM: bytes.  Each kernel reads every byte of the
// rows it sums once (int8) and does a few integer operations per byte, far
// below the card's ridge, so device-memory bandwidth (3.35 TB/s) bounds both.
//
// Design:
//   * Rows kernel: a CTA of 8 warps takes 128 rows (16 a warp), which lie in one
//     dep tile, and a run of consecutive line blocks.  For each line block a
//     lane loads 16 bytes of each of its warp's 16 rows (16 loads in flight),
//     sums each with four dp4a, and keeps a running total per row; the warp's
//     block sum is reduced with shuffles and added to block_counts with one
//     atomic, and each row's total with one atomic at the end of the run.
//   * Lines kernel: a thread owns 16 consecutive lines and walks down a group
//     of rows, 8 rows in flight, skipping masked-out rows (a uniform branch:
//     every thread reads the same mask byte), and adds its 16 column sums with
//     atomics.  A warp reads 512 contiguous bytes of a row per load.
//   * Row offsets are 64-bit: M^T may hold more than 2^31 entries.
//
// Layout contract (checked by the Python wrapper): m int8 (n_rows, n_lines),
// row stride ld bytes; base address and ld multiples of 16; n_lines a multiple
// of 16; rows kernel: kl a multiple of 16 dividing n_lines, tile a multiple of
// 128 dividing n_rows.  dep_count (n_rows,), block_counts (n_lines / kl,
// n_rows / tile) and lens (n_lines,) int32, zeroed by the caller; mask
// (n_rows,) int8, non-zero for a row that lens counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 16;
constexpr int ROWS_PER_CTA = WARPS * ROWS_PER_WARP;  // 128
constexpr int LINES_PER_THREAD = 16;
constexpr int LINES_PER_CTA = THREADS * LINES_PER_THREAD;  // 4,096
constexpr int ROWS_IN_FLIGHT = 8;
// CTAs a launch aims for: several waves of the card's 132 SMs, so that the
// last wave's idle SMs are a small share of the launch.
constexpr int TARGET_CTAS = 132 * 16;

constexpr int ERR_SHAPE = -3;

__device__ __forceinline__ int4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// Sum of the 16 signed bytes of v.
__device__ __forceinline__ int sum16(int4 v) {
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[q + j] += signed byte j of word w, for j in [0, 4).
__device__ __forceinline__ void add_word(int (&acc)[LINES_PER_THREAD], int q,
                                         int w) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc[q + j] += static_cast<int>(static_cast<int8_t>(w >> (8 * j)));
}

// acc[k] += signed byte k of v, for k in [0, 16).
__device__ __forceinline__ void add_bytes(int (&acc)[LINES_PER_THREAD],
                                          int4 v) {
  add_word(acc, 0, v.x);
  add_word(acc, 4, v.y);
  add_word(acc, 8, v.z);
  add_word(acc, 12, v.w);
}

__global__ void __launch_bounds__(THREADS)
membership_counts_rows_kernel(const int8_t* __restrict__ m, long long ld,
                              int n_rows, int kl, int n_blocks,
                              int blocks_per_cta, int tile, int n_tiles,
                              int* __restrict__ dep_count,
                              int* __restrict__ block_counts) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cta_row0 = blockIdx.y * ROWS_PER_CTA;
  const int row0 = cta_row0 + warp * ROWS_PER_WARP;
  const int t = cta_row0 / tile;  // the CTA's rows lie in one dep tile
  const int b0 = blockIdx.x * blocks_per_cta;
  const int b1 = min(b0 + blocks_per_cta, n_blocks);
  const int8_t* base = m + static_cast<long long>(row0) * ld;
  int tot[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) tot[i] = 0;
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) live[i] = row0 + i < n_rows;

  for (int b = b0; b < b1; ++b) {
    int blk = 0;
    const long long line0 = static_cast<long long>(b) * kl;
    for (int off = 16 * lane; off < kl; off += 16 * 32) {
      int4 v[ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
        v[i] = live[i] ? load16(base + i * ld + line0 + off)
                       : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int s = sum16(v[i]);
        tot[i] += s;
        blk += s;
      }
    }
    blk = warp_sum(blk);
    if (lane == 0 && blk != 0)
      atomicAdd(block_counts + static_cast<long long>(b) * n_tiles + t, blk);
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int s = warp_sum(tot[i]);
    if (lane == 0 && live[i] && s != 0) atomicAdd(dep_count + row0 + i, s);
  }
}

__global__ void __launch_bounds__(THREADS)
membership_counts_lines_kernel(const int8_t* __restrict__ m, long long ld,
                               int n_rows, int n_lines, int rows_per_cta,
                               const int8_t* __restrict__ mask,
                               int* __restrict__ lens) {
  const long long line =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) *
      LINES_PER_THREAD;
  if (line >= n_lines) return;
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(r0 + rows_per_cta, n_rows);
  int acc[LINES_PER_THREAD];
#pragma unroll
  for (int k = 0; k < LINES_PER_THREAD; ++k) acc[k] = 0;
  const int8_t* p = m + static_cast<long long>(r0) * ld + line;
  int r = r0;
  for (; r + ROWS_IN_FLIGHT <= r1; r += ROWS_IN_FLIGHT) {
    int4 v[ROWS_IN_FLIGHT];
#pragma unroll
    for (int j = 0; j < ROWS_IN_FLIGHT; ++j)
      v[j] = mask[r + j] ? load16(p + j * ld) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < ROWS_IN_FLIGHT; ++j) add_bytes(acc, v[j]);
    p += ROWS_IN_FLIGHT * ld;
  }
  for (; r < r1; ++r, p += ld)
    if (mask[r]) add_bytes(acc, load16(p));
#pragma unroll
  for (int k = 0; k < LINES_PER_THREAD; ++k)
    if (acc[k] != 0) atomicAdd(lens + line + k, acc[k]);
}

}  // namespace

extern "C" int membership_rows_launch(const void* m, long long ld, int n_rows,
                                      int n_lines, int kl, int tile,
                                      void* dep_count, void* block_counts,
                                      void* stream) {
  if (n_rows < 0 || n_lines < 0 || ld % 16 || n_lines % 16 || kl <= 0 ||
      kl % 16 || n_lines % kl || tile <= 0 || tile % ROWS_PER_CTA ||
      n_rows % tile || reinterpret_cast<uintptr_t>(m) % 16)
    return ERR_SHAPE;
  if (n_rows == 0 || n_lines == 0) return 0;
  const int n_blocks = n_lines / kl;
  const int row_ctas = n_rows / ROWS_PER_CTA;
  const int spans = std::max(1, std::min(n_blocks, TARGET_CTAS / row_ctas));
  const int blocks_per_cta = (n_blocks + spans - 1) / spans;
  const dim3 grid((n_blocks + blocks_per_cta - 1) / blocks_per_cta, row_ctas);
  membership_counts_rows_kernel<<<grid, THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m), ld, n_rows, kl, n_blocks, blocks_per_cta,
      tile, n_rows / tile, static_cast<int*>(dep_count),
      static_cast<int*>(block_counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int membership_lines_launch(const void* m, long long ld, int n_rows,
                                       int n_lines, const void* mask,
                                       void* lens, void* stream) {
  if (n_rows < 0 || n_lines < 0 || ld % 16 || n_lines % 16 ||
      reinterpret_cast<uintptr_t>(m) % 16)
    return ERR_SHAPE;
  if (n_rows == 0 || n_lines == 0) return 0;
  const int line_ctas = (n_lines + LINES_PER_CTA - 1) / LINES_PER_CTA;
  const int groups =
      std::max(1, std::min((n_rows + ROWS_IN_FLIGHT - 1) / ROWS_IN_FLIGHT,
                           TARGET_CTAS / line_ctas));
  const int rows_per_cta = (n_rows + groups - 1) / groups;
  const dim3 grid(line_ctas, (n_rows + rows_per_cta - 1) / rows_per_cta);
  membership_counts_lines_kernel<<<grid, THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m), ld, n_rows, n_lines, rows_per_cta,
      static_cast<const int8_t*>(mask), static_cast<int*>(lens));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* membership_error_string(int code) {
  if (code == ERR_SHAPE) return "membership launch: shape or alignment refused";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
