// Fused CIND verdict kernel: one block of the dense sweep, cooc = M_dep^T M_ref
// accumulated over a list of non-empty line blocks, with the CIND verdict applied
// in the epilogue and packed to 32-bit words.
//
// Replaces rdfind_tpu/ops/pallas_kernels.py:fused_cind_blocks (kernel body
// _fused_cind_kernel).  The plain PyTorch version it is held against is
// rdfind_tpu_torch/ops/kernels.py:fused_cind_blocks_plain.
//
// What bounds it on an H100 SXM: the product does 2 * tile * ref_chunk * K int8
// operations (K = scheduled lines) against (tile + ref_chunk) * K bytes of M, i.e.
// 2 * tile * ref_chunk / (tile + ref_chunk) operations per byte.  At the main
// path's launch shapes (tile 1,024-2,048, ref_chunk 7,296-10,240) that is
// 1,800-3,400, above the card's ridge of 1,979 TOPS / 3.35 TB/s = 590 ops/byte, so
// the kernel is bound by int8 tensor-core operations; the verdict and the packed
// output are small next to M.  The design keeps the int32 count matrix out of
// device memory altogether (it lives in registers and is consumed by the
// epilogue), reads only the line blocks that the block-skip schedule names, and
// writes one bit per (dep, ref) pair.  It is the simple version: WMMA m16n16k16
// int8 products from single-buffered shared-memory tiles; wgmma, TMA and a
// persistent schedule are later work.
//
// Layout contract (checked by the Python wrapper):
//   m_dep  int8 (l_pad, tile), row stride ld_dep; m int8 (l_pad, c_pad), row stride
//   ld_m; both 16-byte aligned with 16-byte-multiple strides.
//   dep columns (tile,) int32: support, ok (support >= min_support), global id,
//   code, v1, v2.  ref rows (c_pad,) int32: global id, code, v1.
//   block_ids (nk,) int32 line-block ids, n_real (1,) int32: only the first n_real
//   entries are visited.  A line block is kl rows.
//   packed (tile, ref_chunk / 32) uint32: bit r of word w in row d is the verdict
//   for ref column ref_lo + 32 w + r.  Every word is written.
//   popc (tile,) int32, zeroed by the caller: per-dep count of set verdict bits.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BLOCK_D = 128;  // dep rows per CTA
constexpr int BLOCK_R = 128;  // ref columns per CTA
constexpr int KC = 128;       // lines staged in shared memory per step
constexpr int PANELS = 8;     // 16-column panels per operand tile
constexpr int THREADS = 256;  // 8 warps: 4 along dep x 2 along ref
constexpr int WARP_D = 32;
constexpr int WARP_R = 64;
// One panel holds KC lines x 16 columns, row after row, so a 16 x 16 WMMA
// fragment is 256 contiguous bytes (32-byte aligned, ldm 16).  The 32 bytes of
// padding between panels spread the staging stores over the banks.
constexpr int PANEL_BYTES = KC * 16 + 32;
constexpr int TILE_BYTES = PANELS * PANEL_BYTES;

__device__ __forceinline__ bool trivially_implied(int dcode, int dv1, int dv2,
                                                  int rcode, int rv1) {
  // conditions.is_subcode(rcode, dcode) and the value match on
  // conditions.first_subcapture(dcode), equal-code quirk included.
  const bool sub = (rcode & dcode) == rcode;
  const int low = dcode & 7;
  const int first = (dcode & ~7) | (low & -low);
  return sub && (first == rcode ? rv1 == dv1 : rv1 == dv2);
}

__global__ void __launch_bounds__(THREADS)
fused_cind_kernel(const int8_t* __restrict__ m_dep, long long ld_dep,
                  const int8_t* __restrict__ m, long long ld_m,
                  const int* __restrict__ sup, const int* __restrict__ ok,
                  const int* __restrict__ gid, const int* __restrict__ dcode,
                  const int* __restrict__ dv1, const int* __restrict__ dv2,
                  const int* __restrict__ ridx, const int* __restrict__ rcode,
                  const int* __restrict__ rv1,
                  const int* __restrict__ block_ids,
                  const int* __restrict__ n_real, int kl, int ref_lo,
                  int words_per_row, unsigned* __restrict__ packed,
                  int* __restrict__ popc) {
  __shared__ __align__(128) int8_t smem[2 * TILE_BYTES];
  int8_t* a_tile = smem;
  int8_t* b_tile = smem + TILE_BYTES;

  const int rb = blockIdx.x;  // ref block within the chunk
  const int db = blockIdx.y;  // dep block within the tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wd = warp >> 1;  // warp row: dep rows [32 wd, 32 wd + 32)
  const int wr = warp & 1;   // warp col: ref cols [64 wr, 64 wr + 64)

  const int8_t* a_src = m_dep + (long long)db * BLOCK_D;
  const int8_t* b_src = m + ref_lo + (long long)rb * BLOCK_R;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nr = n_real[0];
  for (int kk = 0; kk < nr; ++kk) {
    const long long row_lo = (long long)block_ids[kk] * kl;
    for (int s = 0; s < kl; s += KC) {
      __syncthreads();  // the previous step's fragment loads are done
      // Stage KC lines x 128 columns of each operand as 16-byte chunks; eight
      // consecutive threads read one line's 128 contiguous bytes.
      for (int c = tid; c < KC * PANELS; c += THREADS) {
        const int line = c >> 3;
        const int panel = c & 7;
        uint4 va = make_uint4(0, 0, 0, 0);
        uint4 vb = va;
        if (s + line < kl) {
          const long long row = row_lo + s + line;
          va = *reinterpret_cast<const uint4*>(a_src + row * ld_dep + panel * 16);
          vb = *reinterpret_cast<const uint4*>(b_src + row * ld_m + panel * 16);
        }
        *reinterpret_cast<uint4*>(a_tile + panel * PANEL_BYTES + line * 16) = va;
        *reinterpret_cast<uint4*>(b_tile + panel * PANEL_BYTES + line * 16) = vb;
      }
      __syncthreads();
      // A = M_dep^T is (dep x line): a panel stored line-major is A in column-major
      // order.  B = M_ref is (line x ref): a panel stored line-major is row-major.
#pragma unroll 2
      for (int k = 0; k < KC; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], a_tile + (wd * 2 + i) * PANEL_BYTES + k * 16, 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(
              fb[j], b_tile + (wr * 4 + j) * PANEL_BYTES + k * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  }

  // Epilogue: each warp writes two 16 x 16 count fragments side by side into its
  // own 16 x 32 scratch (reusing the staging bytes), so lane c holds column c of
  // a 32-column word; the verdict of a row is one ballot.
  __syncthreads();
  int* scratch = reinterpret_cast<int*>(smem) + warp * 16 * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      wmma::store_matrix_sync(scratch, acc[i][2 * jp], 32, wmma::mem_row_major);
      wmma::store_matrix_sync(scratch + 16, acc[i][2 * jp + 1], 32,
                              wmma::mem_row_major);
      __syncwarp();
      const int rcol = rb * BLOCK_R + wr * WARP_R + jp * 32 + lane;
      const int rg = ref_lo + rcol;
      const int r_code = rcode[rg];
      const int r_v1 = rv1[rg];
      const int r_id = ridx[rg];
      for (int t = 0; t < 16; ++t) {
        const int d = db * BLOCK_D + wd * WARP_D + i * 16 + t;
        const int cooc = scratch[t * 32 + lane];
        const bool v = cooc == sup[d] && ok[d] != 0 && gid[d] != r_id &&
                       !trivially_implied(dcode[d], dv1[d], dv2[d], r_code, r_v1);
        const unsigned word = __ballot_sync(0xffffffffu, v);
        if (lane == 0) {
          packed[(long long)d * words_per_row + (rcol >> 5)] = word;
          if (word) atomicAdd(popc + d, __popc(word));
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int fused_cind_launch(const void* m_dep, long long ld_dep,
                                 const void* m, long long ld_m,
                                 const void* sup, const void* ok,
                                 const void* gid, const void* dcode,
                                 const void* dv1, const void* dv2,
                                 const void* ridx, const void* rcode,
                                 const void* rv1, const void* block_ids,
                                 const void* n_real, int tile, int ref_chunk,
                                 int kl, int ref_lo, void* packed, void* popc,
                                 void* stream) {
  const dim3 grid(ref_chunk / BLOCK_R, tile / BLOCK_D);
  fused_cind_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m_dep), ld_dep, static_cast<const int8_t*>(m),
      ld_m, static_cast<const int*>(sup), static_cast<const int*>(ok),
      static_cast<const int*>(gid), static_cast<const int*>(dcode),
      static_cast<const int*>(dv1), static_cast<const int*>(dv2),
      static_cast<const int*>(ridx), static_cast<const int*>(rcode),
      static_cast<const int*>(rv1), static_cast<const int*>(block_ids),
      static_cast<const int*>(n_real), kl, ref_lo, ref_chunk / 32,
      static_cast<unsigned*>(packed), static_cast<int*>(popc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_cind_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
