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
// Formulation: the TPU kernel unpacks both sides to 0/1 planes, because its matrix
// unit contracts planes.  Here the packed AND and __popc over W words are the
// direct form and use no tensor cores.  What bounds it on an H100 SXM: D * R * W
// AND + POPC pairs on the integer pipes (POPC issues at 16 per SM per clock on
// sm_90), against (D + R) * W * 4 bytes read and D * R bytes written.  At the main
// path's tiles (D 128-256, R 7,424-10,112, W 64) that is 20-30 popcounts per
// byte, against a ridge of ~1 (3.6e12 POPC/s over 3.35e12 B/s): the POPC rate
// bounds it.  The design reads
// each packed operand word from device memory once per CTA tile and reuses it
// from shared memory 16 times per thread (a 4 x 4 micro-tile of counts kept in
// registers), and the W axis is walked in chunks of up to 32 words so that wide
// sketches (W up to 2,048) fit.  It is the simple version: single-buffered
// staging, no cp.async pipeline, no use of the refs' sparsity (<= num_hashes set
// bits each).
//
// Layout contract (checked by the Python wrapper): sketch (D, W) and ref (R, W)
// uint32 row-major, popc (R,) int32, out (D, R) uint8 row-major; D and R multiples
// of 64; W a power of two.
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
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx) owns deps ty + 16 i and
constexpr int MICRO = 4;      // refs tx + 16 j, i, j < MICRO
constexpr int WC = 32;        // words per staged chunk (fewer when W is smaller)
constexpr int LD = WC + 1;    // padded row stride: the 16 refs a warp reads sit in
                              // 16 different banks

__global__ void __launch_bounds__(THREADS)
contains_kernel(const uint32_t* __restrict__ sketch,
                const uint32_t* __restrict__ ref, const int* __restrict__ popc,
                uint8_t* __restrict__ out, int r_total, int w) {
  __shared__ uint32_t s_tile[BLOCK_D * LD];
  __shared__ uint32_t r_tile[BLOCK_R * LD];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t d0 = static_cast<size_t>(blockIdx.y) * BLOCK_D;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * BLOCK_R;
  const int wc = w < WC ? w : WC;  // w is a power of two, so wc divides it

  int acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += wc) {
    // Neighbouring threads load neighbouring words of one row: coalesced.
    for (int e = threadIdx.x; e < BLOCK_D * wc; e += THREADS) {
      const int row = e / wc;
      const int col = e - row * wc;
      s_tile[row * LD + col] = sketch[(d0 + row) * w + k0 + col];
      r_tile[row * LD + col] = ref[(r0 + row) * w + k0 + col];
    }
    __syncthreads();
    for (int k = 0; k < wc; ++k) {
      uint32_t a[MICRO], b[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) a[i] = s_tile[(ty + 16 * i) * LD + k];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) b[j] = r_tile[(tx + 16 * j) * LD + k];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) acc[i][j] += __popc(a[i] & b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MICRO; ++j) {
    const size_t r = r0 + tx + 16 * j;
    const int want = popc[r];
#pragma unroll
    for (int i = 0; i < MICRO; ++i)
      out[(d0 + ty + 16 * i) * r_total + r] =
          static_cast<uint8_t>(acc[i][j] == want);
  }
}

__global__ void repeat_probe_kernel(const int* __restrict__ in,
                                    int* __restrict__ out, int n, int total) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < total) out[j] = in[j % n];
}

constexpr int PIPE_ELEMS = 8 * 128;  // one (8, 128) float block
constexpr int PIPE_THREADS = PIPE_ELEMS / 4;  // 16 bytes per thread per block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

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
