// Fused CIND verdict kernel (K1): one block of the dense sweep, cooc = M_dep M_ref^T
// over the K-major membership matrix M^T (captures x lines), accumulated over a
// list of non-empty line blocks, with the CIND verdict applied in the epilogue and
// packed to 32-bit words.
//
// Replaces rdfind_tpu/ops/pallas_kernels.py:fused_cind_blocks (kernel body
// _fused_cind_kernel).  The plain PyTorch version it is held against is
// rdfind_tpu_torch/ops/kernels.py:fused_cind_blocks_plain.
//
// What bounds it on an H100 SXM: a CTA multiplies 128 dep x 256 ref rows, 8.4e6
// int8 operations a 128-line stage, for 48 KB of M^T loaded into shared memory:
// 175 operations a byte, so 132 CTAs at the card's 1,979 TOPS would pull some
// 11 TB/s through L2, about twice what it delivers.  CTAs that visit the same
// line blocks at about the same time share their loads in L2; even then a CTA
// takes 5.0-5.4 us a line block of 512 lines on one H100 (40-45 % of the int8
// peak), and CTAs that skip different blocks share less.  The lever is the
// operations: a CTA multiplies only the line blocks where both its dep rows and
// its ref rows have members, which the data decides (on LUBM(100), a fifth of
// what the launch schedules give it).
//
// Design (Hopper):
//   * Operands are K-major: row c of M^T holds capture c's membership over the
//     lines, so both the dep tile (rows [lo, lo + tile)) and the ref rows are
//     contiguous along the contraction, the only layout Hopper's int8 tensor-core
//     instructions take.
//   * Two-sided block skip: the launch's schedule (block_ids, n_real) is the
//     union of its dep tiles' non-empty line blocks.  A CTA (128 dep x 256 ref
//     rows) visits a scheduled block only where the block counts (K3's, one
//     int32 per line block and plan tile) are non-zero for the plan tile of its
//     dep rows and for one of the plan tiles its ref rows span.  A skipped block
//     adds zero to every count of the CTA, so the verdicts are those of the
//     whole schedule, bit for bit.
//   * Heavy output tiles split across a thread-block cluster: the `split` CTAs
//     of one cluster share an output tile, and each multiplies every split-th
//     block that qualifies.  Their int32 counts are summed through distributed
//     shared memory into the cluster's first CTA, which alone runs the
//     epilogue.  The stage ring holds the counts meanwhile: no device memory.
//   * One producer warp reads 128 schedule entries at a time, judges them with
//     one ballot per 32, and turns its CTA's share into TMA 2-D loads of
//     128-line x 128-row (dep) and 128-line x 256-row (ref) tiles with the
//     128-byte swizzle, into a ring of STAGES stages tracked by full and empty
//     mbarriers.  Each stage carries a tag: after the last load the producer
//     hands over one stage tagged as the end, so producer and consumers agree
//     on the step count without counting the blocks first.  TMA zero-fills
//     rows past the ref chunk (ragged last block).
//   * Two consumer warpgroups (64 dep rows each) issue wgmma.m64n256k32.s32.s8.s8
//     straight from the swizzled shared-memory tiles, four per stage, and keep one
//     wgmma group in flight while the next stage arrives.
//   * The grid runs a cluster's CTAs fastest, then dep blocks: a wave of CTAs
//     covers every dep block of the launch against a band of ref blocks, so the
//     CTAs that visit a ref tile's line block at about the same time share it
//     in L2, and the dep rows stay there.
//   * Epilogue in registers: a thread holds two rows x 2 consecutive columns of
//     every n8 group; the quad of lanes sharing a row ORs its shifted bits with two
//     shuffles into the row's 32-bit word.  Per-dep and per-ref values are staged
//     in shared memory once per CTA; popc takes one atomicAdd per row and CTA.
//   * Each CTA adds the number of line blocks it multiplied to `visited` (one
//     atomicAdd), so the caller can read how often the skip engages.
//
// Layout contract (checked by the Python wrapper):
//   m_dep int8 (dep_rows, l_pad), row stride ld_dep; m int8 (c_pad, l_pad), row
//   stride ld_m; base addresses and strides multiples of 16 bytes; ref rows
//   [ref_lo, ref_lo + ref_chunk) of m are the ref side; m_dep holds rows
//   [dep_lo, dep_lo + dep_rows) of m.
//   dep_rows a multiple of 128, ref_chunk and ref_lo multiples of 128, kl (lines
//   per block) a multiple of 128.
//   dep columns (dep_rows,) int32: support, ok (support >= min_support), global
//   id, code, v1, v2.  ref rows (c_pad,) int32: global id, code, v1.
//   block_ids (nk,) int32 line-block ids, n_real (1,) int32: only the first n_real
//   entries are scheduled.  The schedule lives on the device and is not read by
//   the host, so the kernel checks it: n_real outside [0, nk] or a scheduled id
//   outside [0, n_blocks) traps, and the launch fails instead of counting the
//   wrong lines (TMA would zero-fill a block past the lines without a fault).
//   block_counts (n_blocks, n_count_tiles) int32, row-major: the members of line
//   block b in capture rows [t count_tile, (t + 1) count_tile), count_tile a
//   multiple of 128.
//   packed (dep_rows, ref_chunk / 32) uint32: bit r of word w in row d is the
//   verdict for ref column ref_lo + 32 w + r.  Every word is written.
//   popc (dep_rows,) int32, zeroed by the caller: per-dep count of set verdict
//   bits.  visited (1,) int32 or null: the blocks multiplied are added to it.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // dep rows per CTA (two consumer warpgroups of 64)
constexpr int BN = 256;  // ref rows per CTA (one wgmma n256 per warpgroup)
constexpr int BK = 128;  // lines per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;  // warpgroup 0: producer; 1 and 2: consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int N_COLS = 6;  // per-dep values staged in shared memory
constexpr int N_ROWS = 3;  // per-ref values
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + STAGES * STAGE_BYTES +
                           4 * (N_COLS * BM + N_ROWS * BN) + 16 * STAGES +
                           4 * STAGES /* stage tags */;
constexpr int MAX_SPLIT = 8;  // the portable cluster size
constexpr int SCAN = 4;       // schedule entries per producer lane and pass
// A consumer thread's 128 counts, as int4, fit the ring for the cluster sum.
static_assert(CONSUMER_WARPS * 32 * 128 * 4 <= STAGES * STAGE_BYTES,
              "the stage ring must hold one CTA's counts");

// Error codes of the launcher beside cudaError_t's (which are >= 0).
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_ENCODE = -2;
constexpr int ERR_SHAPE = -3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with parity `parity` has completed.  A pipeline
// that never completes (a fault in the schedule) traps after ~20 s of clocks, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a K-major tile written by TMA with
// the 128-byte swizzle: rows of 128 bytes, 8-row core groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, K-major, shared) * B (256 x 32, K-major, shared)^T in int32.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, 1;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ bool trivially_implied(int dcode, int dv1, int dv2,
                                                  int rcode, int rv1) {
  // conditions.is_subcode(rcode, dcode) and the value match on
  // conditions.first_subcapture(dcode), equal-code quirk included.
  const bool sub = (rcode & dcode) == rcode;
  const int low = dcode & 7;
  const int first = (dcode & ~7) | (low & -low);
  return sub && (first == rcode ? rv1 == dv1 : rv1 == dv2);
}

// Whether the CTA with dep plan tile `td` and ref plan tiles tr0..tr1 (at most
// two) multiplies line block `block`: both sides have members there.
__device__ __forceinline__ bool block_qualifies(const int* __restrict__ counts,
                                                int n_count_tiles, int block,
                                                int td, int tr0, int tr1) {
  const int* row = counts + static_cast<long long>(block) * n_count_tiles;
  return __ldg(row + td) != 0 && (__ldg(row + tr0) != 0 || __ldg(row + tr1) != 0);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_cind_kernel(const __grid_constant__ CUtensorMap map_dep,
                  const __grid_constant__ CUtensorMap map_ref,
                  const int* __restrict__ sup, const int* __restrict__ ok,
                  const int* __restrict__ gid, const int* __restrict__ dcode,
                  const int* __restrict__ dv1, const int* __restrict__ dv2,
                  const int* __restrict__ ridx, const int* __restrict__ rcode,
                  const int* __restrict__ rv1,
                  const int* __restrict__ block_ids,
                  const int* __restrict__ n_real, int nk, int n_blocks,
                  int kl, int ref_lo, int ref_chunk,
                  const int* __restrict__ block_counts, int count_tile,
                  int n_count_tiles, int dep_lo, int split,
                  unsigned* __restrict__ packed, int* __restrict__ popc,
                  int* __restrict__ visited) {
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1,024 bytes: tiles start on that grain.
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* s_cols = reinterpret_cast<int*>(tiles + STAGES * STAGE_BYTES);
  int* s_rows = s_cols + N_COLS * BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_rows + N_ROWS * BN);
  uint64_t* empty = full + STAGES;
  // Tag of each stage: 1 holds tiles, 0 marks the end of the CTA's schedule.
  volatile int* tag = reinterpret_cast<volatile int*>(empty + STAGES);

  const int tid = threadIdx.x;
  // The `split` CTAs of a cluster share one output tile (blockIdx.x / split).
  // Dep blocks vary fastest, so the CTAs of one wave share few ref tiles: a
  // wave streams its ref rows from device memory once, not once per dep block.
  const int rank = blockIdx.x % split;
  const int d0 = (blockIdx.x / split) * BM;  // dep rows of this CTA
  const int r0 = blockIdx.y * BN;            // ref rows within the chunk

  for (int i = tid; i < BM; i += THREADS) {
    const int d = d0 + i;
    s_cols[i] = sup[d];
    s_cols[BM + i] = ok[d];
    s_cols[2 * BM + i] = gid[d];
    s_cols[3 * BM + i] = dcode[d];
    s_cols[4 * BM + i] = dv1[d];
    s_cols[5 * BM + i] = dv2[d];
  }
  for (int i = tid; i < BN; i += THREADS) {
    const bool in = r0 + i < ref_chunk;
    const int rg = ref_lo + r0 + i;
    s_rows[i] = in ? ridx[rg] : 0;
    s_rows[BN + i] = in ? rcode[rg] : 0;
    s_rows[2 * BN + i] = in ? rv1[rg] : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_sched = n_real[0];
  if (n_sched < 0 || n_sched > nk) __trap();
  const int steps_per_block = kl / BK;
  const int wg = tid >> 7;
  const int lane = tid & 31;

  int d[128];
  if (wg == 0) {
    if (tid < 32) {
      // Producer warp: judge SCAN x 32 schedule entries a pass (one ballot per
      // 32), take every split-th block that qualifies, and keep STAGES loads
      // in flight from one lane.
      const int td = (dep_lo + d0) / count_tile;
      const int tr0 = (ref_lo + r0) / count_tile;
      const int tr1 = (ref_lo + min(r0 + BN, ref_chunk) - 1) / count_tile;
      int it = 0, seen = 0, mine = 0;
      for (int base = 0; base < n_sched; base += SCAN * 32) {
        int block[SCAN];
        bool take[SCAN];
#pragma unroll
        for (int j = 0; j < SCAN; ++j) {
          const int k = base + 32 * j + lane;
          block[j] = k < n_sched ? block_ids[k] : 0;
          if (block[j] < 0 || block[j] >= n_blocks) __trap();
        }
#pragma unroll
        for (int j = 0; j < SCAN; ++j)
          take[j] = base + 32 * j + lane < n_sched &&
                    block_qualifies(block_counts, n_count_tiles, block[j], td,
                                    tr0, tr1);
#pragma unroll
        for (int j = 0; j < SCAN; ++j) {
          unsigned mask = __ballot_sync(0xffffffffu, take[j]);
          while (mask) {  // uniform over the warp
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const int b = __shfl_sync(0xffffffffu, block[j], src);
            if (seen++ % split != rank) continue;
            ++mine;
            if (lane == 0) {
              for (int sub = 0; sub < steps_per_block; ++sub, ++it) {
                const int s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                const int line = b * kl + sub * BK;
                uint8_t* stage = tiles + s * STAGE_BYTES;
                tag[s] = 1;
                mbar_expect_tx(&full[s], STAGE_BYTES);
                tma_load_2d(stage, &map_dep, &full[s], line, d0);
                tma_load_2d(stage + A_BYTES, &map_ref, &full[s], line, r0);
              }
            }
          }
        }
      }
      if (lane == 0) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        tag[s] = 0;
        mbar_arrive(&full[s]);
        if (visited != nullptr && mine) atomicAdd(visited, mine);
      }
    }
  } else {
    const int cw = wg - 1;  // dep rows [64 cw, 64 cw + 64) of the CTA
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    for (int it = 0;; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      if (tag[s] == 0) break;  // the producer's end mark
      const uint8_t* a = tiles + s * STAGE_BYTES + cw * 64 * BK;
      const uint8_t* b = tiles + s * STAGE_BYTES + A_BYTES;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)
        wgmma_m64n256k32(d, smem_desc(a + 32 * k), smem_desc(b + 32 * k));
      wgmma_commit();
      fence_acc(d);
      // The products of step it - 1 are done: its stage may be refilled.
      wgmma_wait<1>();
      fence_acc(d);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(d);
  }

  if (split > 1) {
    // Sum the cluster's counts into its first CTA through distributed shared
    // memory.  Every product has landed and been consumed, so the ring is
    // free; thread t's 128 counts go to int4 slots [j * 256 + t], j < 32.
    cg::cluster_group cluster = cg::this_cluster();
    int4* ring = reinterpret_cast<int4*>(tiles);
    const int ct = tid - 128;  // consumer thread
    __syncthreads();
    if (rank != 0 && wg > 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        ring[j * 256 + ct] = make_int4(d[4 * j], d[4 * j + 1], d[4 * j + 2],
                                       d[4 * j + 3]);
    }
    cluster.sync();
    if (rank == 0 && wg > 0) {
      for (int p = 1; p < split; ++p) {
        const int4* peer = cluster.map_shared_rank(ring, p);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int4 v = peer[j * 256 + ct];
          d[4 * j] += v.x;
          d[4 * j + 1] += v.y;
          d[4 * j + 2] += v.z;
          d[4 * j + 3] += v.w;
        }
      }
    }
    cluster.sync();  // no CTA leaves while its counts may still be read
  }
  if (wg == 0 || rank != 0) return;

  // Epilogue.  Thread (warp w of the warpgroup, lane = 4 g + q) holds, for n8
  // group J, d[4 J + 2 h + c] = count of dep row 16 w + g + 8 h, ref column
  // 8 J + 2 q + c.  A 32-column word gathers groups 4 jj .. 4 jj + 3.
  const int cw = wg - 1;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int row0 = cw * 64 + ((tid & 127) >> 5) * 16 + g;
  int c_sup[2], c_ok[2], c_gid[2], c_code[2], c_v1[2], c_v2[2], cnt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    c_sup[h] = s_cols[r];
    c_ok[h] = s_cols[BM + r];
    c_gid[h] = s_cols[2 * BM + r];
    c_code[h] = s_cols[3 * BM + r];
    c_v1[h] = s_cols[4 * BM + r];
    c_v2[h] = s_cols[5 * BM + r];
    cnt[h] = 0;
  }
  const int words_per_row = ref_chunk >> 5;
#pragma unroll
  for (int jj = 0; jj < BN / 32; ++jj) {
    if (r0 + 32 * jj < ref_chunk) {  // uniform over the CTA
      unsigned bits[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 32 * jj + 8 * j + 2 * q + c;
          const int r_id = s_rows[col];
          const int r_code = s_rows[BN + col];
          const int r_v1 = s_rows[2 * BN + col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool v = d[4 * (4 * jj + j) + 2 * h + c] == c_sup[h] &&
                           c_ok[h] != 0 && c_gid[h] != r_id &&
                           !trivially_implied(c_code[h], c_v1[h], c_v2[h],
                                              r_code, r_v1);
            bits[h] |= static_cast<unsigned>(v) << (8 * j + 2 * q + c);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bits[h] |= __shfl_xor_sync(0xffffffffu, bits[h], 1);
        bits[h] |= __shfl_xor_sync(0xffffffffu, bits[h], 2);
        if (q == (jj & 3)) {
          packed[static_cast<long long>(d0 + row0 + 8 * h) * words_per_row +
                 ((r0 >> 5) + jj)] = bits[h];
          cnt[h] += __popc(bits[h]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 1);
    cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 2);
    if (q == 0 && cnt[h]) atomicAdd(popc + d0 + row0 + 8 * h, cnt[h]);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that the
// library needs no -lcuda.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D map over `rows` K-major rows of `lines` int8 values, `ld` bytes apart,
// loaded as (box_rows x BK) tiles with the 128-byte swizzle.
int encode_rows(CUtensorMap* map, const void* base, long long lines,
                long long rows, long long ld, int box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(lines),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

}  // namespace

extern "C" int fused_cind_launch(const void* m_dep, long long ld_dep,
                                 const void* m, long long ld_m, long long l_pad,
                                 const void* sup, const void* ok,
                                 const void* gid, const void* dcode,
                                 const void* dv1, const void* dv2,
                                 const void* ridx, const void* rcode,
                                 const void* rv1, const void* block_ids,
                                 const void* n_real, int dep_rows,
                                 int ref_chunk, int kl, int ref_lo, int nk,
                                 const void* block_counts, int count_tile,
                                 int n_count_tiles, int dep_lo, int split,
                                 void* packed, void* popc, void* visited,
                                 void* stream) {
  if (dep_rows <= 0 || dep_rows % BM || ref_chunk <= 0 || ref_chunk % 128 ||
      ref_lo % 128 || kl <= 0 || kl % BK || l_pad % kl || nk < 0 ||
      count_tile <= 0 || count_tile % BM || n_count_tiles <= 0 ||
      dep_lo < 0 || dep_lo % BM || split < 1 || split > MAX_SPLIT ||
      block_counts == nullptr ||
      static_cast<long long>(dep_lo) + dep_rows >
          static_cast<long long>(count_tile) * n_count_tiles ||
      static_cast<long long>(ref_lo) + ref_chunk >
          static_cast<long long>(count_tile) * n_count_tiles)
    return ERR_SHAPE;
  CUtensorMap map_dep, map_ref;
  int err = encode_rows(&map_dep, m_dep, l_pad, dep_rows, ld_dep, BM);
  if (err) return err;
  err = encode_rows(&map_ref, static_cast<const int8_t*>(m) + ref_lo * ld_m,
                    l_pad, ref_chunk, ld_m, BN);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      fused_cind_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * (dep_rows / BM), (ref_chunk + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, fused_cind_kernel, map_dep, map_ref, static_cast<const int*>(sup),
      static_cast<const int*>(ok), static_cast<const int*>(gid),
      static_cast<const int*>(dcode), static_cast<const int*>(dv1),
      static_cast<const int*>(dv2), static_cast<const int*>(ridx),
      static_cast<const int*>(rcode), static_cast<const int*>(rv1),
      static_cast<const int*>(block_ids), static_cast<const int*>(n_real), nk,
      static_cast<int>(l_pad / kl), kl, ref_lo, ref_chunk,
      static_cast<const int*>(block_counts), count_tile, n_count_tiles, dep_lo,
      split, static_cast<unsigned*>(packed), static_cast<int*>(popc),
      static_cast<int*>(visited));
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one CTA (ptxas reports only static shared memory).
extern "C" int fused_cind_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* fused_cind_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled not found in the CUDA driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused the membership layout";
    case ERR_SHAPE:
      return "fused_cind_launch: shape not block-aligned";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
