// Packed Bloom-containment kernel (K2) and the two probes that check the
// library it is built into (P1, P2).
//
// K2 replaces rdfind_tpu/ops/pallas_kernels.py:packed_contains_matrix (grid body
// _contains_kernel, emit-pipeline body _contains_kernel_emit).  For packed dep
// sketches s (D, W) and packed ref bit sets r (R, W) it writes
//     out[d][r] = (sum_w popc(s[d][w] & r[r][w]) == popc[r])  as uint8,
// i.e. 1 iff every hash bit of ref r is set in sketch d.  The count is compared
// with popc (and not tested as (s & r) == r) so that a padded ref, whose popc is
// -1, never matches.  The plain PyTorch version it is held against is
// rdfind_tpu_torch/ops/kernels.py:packed_contains_matrix_plain.
//
// Formulation: the TPU's, an exact product of 0/1 planes on the tensor cores.
// The count is the (D x 32 W) by (32 W x R) product of the bit planes; the packed
// words already lie along the contraction, so both operands are K-major as they
// are stored.  Hopper's binary tensor-core product,
// mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc, computes exactly
// sum popc(a & b) over 256 bits, and its fragment registers are the packed words
// themselves: no unpacking.  (Widening each nibble to four 0/1 bytes for the int8
// product, (nib * 0x00204081) & 0x01010101, was bit-exact too but slower on an
// H100: integer widening instructions beside every product.)  What bounds
// it on an H100 SXM: counted as the TPU kernel does it, 2 D R 32 W int8
// operations at 1,979 TOPS against (D + R) W 4 bytes read and D R bytes written;
// at the main path's tiles (D 128-256, R 7,424-10,112, W 64) that is ~4,000
// operations per byte, past the ridge of 590: operations bound it.
//
// Design: a CTA computes a 64 x 64 (dep x ref) tile with 4 warps, each a 32 x 32
// block of m16n8 products (8 int32 accumulator fragments per thread); eight
// words are one k256 step.  The words are staged with cp.async, double-buffered,
// in chunks of up to WC words (W up to 2,048 and beyond), with a row stride of
// LD words so that the 32 words a warp reads for one fragment sit in 32 banks.
// The epilogue compares each count with popc[r] and writes two adjacent uint8
// verdicts per store.
//
// Layout contract (checked by the Python wrapper): sketch (D, W) and ref (R, W)
// uint32 row-major, popc (R,) int32, out (D, R) uint8 row-major; D and R multiples
// of 64; W a power of two; sketch and ref 16-byte aligned when W >= 4 (the rows
// are staged with 16-byte copies).
//
// P1 repeat_probe: out[j] = in[j % n], the word order the staging loop reads;
// the counterpart of the TPU lane-order probe _repeat_is_tile.
// P2 pipeline_probe: blocks of 8 x 128 floats streamed through shared memory with
// cp.async (double-buffered, cp.async.wait_group) and summed; the counterpart of
// the TPU pipeline probe emit_pipeline_supported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_D = 64;  // dep rows per CTA
constexpr int BLOCK_R = 64;  // ref rows per CTA (equal to BLOCK_D: one staging loop)
constexpr int THREADS = 128;  // 4 warps, 2 x 2 over the tile, 32 x 32 each
constexpr int WC = 32;        // words per staged chunk (fewer when W is smaller)
constexpr int LD = 36;        // staged row stride in words: 16-byte aligned rows,
                              // and rows 4 banks apart
constexpr int K_WORDS = 8;    // words per k256 step of the binary product

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// c += popc(A & B) over 256 bits: A rows g, g + 8 hold words q and q + 4 of
// the step in a0..a3, B column g the same words of the ref in b0, b1.
__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage words [k0, k0 + wc) of the CTA's dep and ref rows into one buffer.
__device__ __forceinline__ void stage_chunk(uint32_t* s_buf, uint32_t* r_buf,
                                            const uint32_t* sketch,
                                            const uint32_t* ref, size_t d0,
                                            size_t r0, int w, int k0, int wc) {
  if (wc >= 4) {
    const int pieces = wc >> 2;  // 16-byte pieces per row
    for (int e = threadIdx.x; e < BLOCK_D * pieces; e += THREADS) {
      const int row = e / pieces;
      const int col = (e - row * pieces) * 4;
      cp_async16(s_buf + row * LD + col, sketch + (d0 + row) * w + k0 + col);
      cp_async16(r_buf + row * LD + col, ref + (r0 + row) * w + k0 + col);
    }
  } else {
    for (int e = threadIdx.x; e < BLOCK_D * wc; e += THREADS) {
      const int row = e / wc;
      const int col = e - row * wc;
      cp_async4(s_buf + row * LD + col, sketch + (d0 + row) * w + k0 + col);
      cp_async4(r_buf + row * LD + col, ref + (r0 + row) * w + k0 + col);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
contains_kernel(const uint32_t* __restrict__ sketch,
                const uint32_t* __restrict__ ref, const int* __restrict__ popc,
                uint8_t* __restrict__ out, int r_total, int w) {
  __shared__ __align__(16) uint32_t s_tile[2][BLOCK_D * LD];
  __shared__ __align__(16) uint32_t r_tile[2][BLOCK_R * LD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wy = (warp >> 1) * 32;  // dep rows [wy, wy + 32) of the CTA
  const int wx = (warp & 1) * 32;   // ref rows [wx, wx + 32)
  const size_t d0 = static_cast<size_t>(blockIdx.y) * BLOCK_D;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * BLOCK_R;
  const int wc = w < WC ? w : WC;  // w is a power of two, so wc divides it
  const int n_chunks = w / wc;

  if (wc < K_WORDS) {
    // A k256 step reads 8 words: the ones past W stay zero.
    for (int e = threadIdx.x; e < 2 * BLOCK_D * LD; e += THREADS) {
      (&s_tile[0][0])[e] = 0u;
      (&r_tile[0][0])[e] = 0u;
    }
    __syncthreads();
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  stage_chunk(s_tile[0], r_tile[0], sketch, ref, d0, r0, w, 0, wc);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks)
      stage_chunk(s_tile[(c + 1) & 1], r_tile[(c + 1) & 1], sketch, ref, d0, r0,
                  w, (c + 1) * wc, wc);
    // One group per chunk (empty on the last), so "all but the newest group
    // done" means chunk c has landed while chunk c + 1 is in flight.
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const uint32_t* sa = s_tile[c & 1] + (wy + g) * LD;
    const uint32_t* sb = r_tile[c & 1] + (wx + g) * LD;
    for (int k = 0; k < wc; k += K_WORDS) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = sa[(16 * i) * LD + k + q];
        a[i][1] = sa[(16 * i + 8) * LD + k + q];
        a[i][2] = sa[(16 * i) * LD + k + q + 4];
        a[i][3] = sa[(16 * i + 8) * LD + k + q + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = sb[(8 * j) * LD + k + q];
        b[j][1] = sb[(8 * j) * LD + k + q + 4];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_b1(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                 b[j][1]);
    }
    __syncthreads();  // chunk c's buffer is refilled at step c + 1
  }

  // acc[i][j]: rows wy + 16 i + g (+ 8 for e >= 2), columns wx + 8 j + 2 q (+ 1
  // for odd e).
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t r = r0 + wx + 8 * j + 2 * q;
    const int want0 = popc[r];
    const int want1 = popc[r + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t d = d0 + wy + 16 * i + g + 8 * h;
        const unsigned v = static_cast<unsigned>(acc[i][j][2 * h] == want0) |
                           (static_cast<unsigned>(acc[i][j][2 * h + 1] == want1)
                            << 8);
        *reinterpret_cast<uint16_t*>(out + d * r_total + r) =
            static_cast<uint16_t>(v);
      }
    }
  }
}

__global__ void repeat_probe_kernel(const int* __restrict__ in,
                                    int* __restrict__ out, int n, int total) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < total) out[j] = in[j % n];
}

constexpr int PIPE_ELEMS = 8 * 128;  // one (8, 128) float block
constexpr int PIPE_THREADS = PIPE_ELEMS / 4;  // 16 bytes per thread per block

__global__ void __launch_bounds__(PIPE_THREADS)
pipeline_probe_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int n_blocks) {
  __shared__ __align__(16) float buf[2][PIPE_ELEMS];
  const int t = 4 * threadIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  cp_async16(&buf[0][t], in + t);
  cp_async_commit();
  for (int k = 0; k < n_blocks; ++k) {
    if (k + 1 < n_blocks)
      cp_async16(&buf[(k + 1) & 1][t],
                 in + static_cast<size_t>(k + 1) * PIPE_ELEMS + t);
    // One group per step (empty on the last), so "all but the newest group
    // done" always means block k has landed while block k + 1 is in flight.
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += buf[k & 1][t + q];
    __syncthreads();  // block k's buffer is refilled at step k + 1
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[t + q] = acc[q];
}

}  // namespace

extern "C" int contains_launch(const void* sketch, const void* ref,
                               const void* popc, void* out, int d, int r,
                               int w, void* stream) {
  if (d % BLOCK_D || r % BLOCK_R || w <= 0 || (w & (w - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 0 || r == 0) return 0;
  const dim3 grid(r / BLOCK_R, d / BLOCK_D);
  contains_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sketch), static_cast<const uint32_t*>(ref),
      static_cast<const int*>(popc), static_cast<uint8_t*>(out), r, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repeat_probe_launch(const void* in, void* out, int n, int reps,
                                   void* stream) {
  const int total = n * reps;
  if (n <= 0 || reps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repeat_probe_kernel<<<(total + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out), n, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pipeline_probe_launch(const void* in, void* out, int n_blocks,
                                     void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pipeline_probe_kernel<<<1, PIPE_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* contains_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
