// The bf16 attention core on Hopper's warpgroup tensor-core path (the bf16
// entries of K1 and K5): wgmma.mma_async for both products, K/V tiles by
// TMA (cp.async.bulk.tensor) into a ring of shared-memory stages on
// mbarriers.
//
// The contract is the JAX package's bf16 kernels
// (sam6d_tpu/kernels/flash_attention.py: _qkv_kernel, and _fused_kernel
// through flash_attention_relpos's augmented product), as in
// bf16_attention.cuh: q, k and v bf16; scores, running max, softmax sum l
// and the output accumulator fp32; p = exp(s - m) rounded to bf16 as the A
// operand of P V, l summed from that rounded p; the output O / max(l,
// 1e-30) rounded to bf16. exp is ex2.approx of the score scaled by log2(e)
// (folded into the score scale and the max, one FMA a score).
//
// Blocks and warpgroups. A block is kWarpgroups warpgroups of 128 threads;
// each owns a tile of 64 query rows (wgmma's M) and walks over every key
// tile, so a K/V tile read into shared memory serves 64 * kWarpgroups rows.
// Thread 0 issues the TMA loads: all of them up front when a (sample,
// head)'s keys fit the ring ("resident": K5's 257 keys, K1's 196-key
// windows), and the block's warpgroups then loop over several row tiles on
// K/V loaded once, one stage a key tile; otherwise (K1's 4096-key global
// blocks) two stages stream, each refilled once every warpgroup has
// released it (an empty mbarrier a stage). A warpgroup runs a key tile as
// S = Q K^T, wait, softmax in registers, O += P V, wait; a last tile of at
// most 8 keys runs as one 8-key block (m64n8k16) instead of 64 padded keys.
// At most 128 registers and 113 KB of shared memory let two blocks share
// an SM, which measured faster than one block of 255 registers; running
// the softmax of tile i beside the P V of tile i - 1 measured slower
// (PERF.md).
//
// Shared-memory layout. A 64-row tile (q, K or V) is stored in "parts" of
// whole rows, each in a swizzled canonical layout of wgmma whose swizzle
// width is the part's row: hd 16 one part of 32-byte rows (32-byte
// swizzle), hd 32 of 64-byte rows (64-byte), hd 64 of 128-byte rows
// (128-byte); hd 80, which is no swizzle width (160-byte rows), a part of
// its first 64 channels (128-byte swizzle) and one of its last 16 (32-byte
// swizzle). Each part of a K or V tile is one 2-D TMA box of the qkv
// matrix ({part's channels, 64 rows}) with the TMA swizzle of its width,
// which lands it in that layout; q is written by the warpgroup's threads
// with the same XOR of 16-byte chunks (chunk ^= row bits above the row
// width, as the hardware swizzles address bits 4-6 by bits 7-9). Unswizzled
// tiles need TMA boxes of 16-byte rows: so stored, K5 measured 0.037-0.038
// ms against 0.032-0.033 (hd 64); at hd 80 the second part costs a second
// P V wgmma a k-step, and the unswizzled first version of K1 measured ~5%
// faster before the later changes (PERF.md). For S = Q K^T both operands are
// K-major: a k16 step starts 32 bytes further along the row, SBO (between
// 8-row groups) is 8 rows. For O += P V, P is the A operand in registers
// (the S accumulator's fragments packed to bf16 pairs are its register
// layout, with no shuffle) and V the MN-major B operand (transposed): a
// k16 step starts 16 rows further, SBO (between 8-key groups) is 8 rows,
// and hd 80 takes an n64 product on its first part and an n16 on its
// second.
//
// Accumulator fragments (wgmma m64nN f32): warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (lane = 4 g + t); d[4 j + e] is column
// 8 j + 2 t + (e & 1) of row g (e < 2) or g + 8: per 8-column block the
// C layout of mma.sync m16n8, so quad_max / quad_sum and K1's bias code
// carry over from the mma.sync cores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>
#include <type_traits>

#include "bf16_attention.cuh"  // pack2, lo_of, hi_of; tf32x3.cuh: quad_max, quad_sum

namespace sam6d {
namespace wgattn {

using bf16 = __nv_bfloat16;
using bf16attn::hi_of;
using bf16attn::lo_of;
using bf16attn::pack2;

constexpr int kRowsWG = 64;      // query rows of a warpgroup's tile (wgmma M)
constexpr int kTileKeys = 64;    // keys of a K/V tile (N of Q K^T, K extent of P V)
constexpr int kWarpgroups = 2;   // consumer warpgroups of a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr float kLog2e = 1.4426950408889634f;

// Ring stages: a (sample, head) of up to max_resident * 64 keys (320 at hd
// <= 64, 256 at hd 80) is held whole, one stage a key tile; longer ones
// stream through kStreamStages.
template <int HD>
__host__ __device__ constexpr int max_resident() { return HD > 64 ? 4 : 5; }
constexpr int kStreamStages = 2;
template <int HD>
__host__ __device__ constexpr int ring_stages(int n) {
  return (n + kTileKeys - 1) / kTileKeys <= max_resident<HD>() ? (n + kTileKeys - 1) / kTileKeys
                                                                : kStreamStages;
}
template <int HD>
__host__ __device__ constexpr int tile_bytes() { return kTileKeys * HD * 2; }
template <int HD>
__host__ __device__ constexpr int q_tile_bytes() { return kRowsWG * HD * 2; }
// the parts of a tile (see the layout above): channels, row bytes, offset
template <int HD>
__host__ __device__ constexpr int n_parts() { return HD == 80 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int part_cols(int p) { return HD == 80 ? (p == 0 ? 64 : 16) : HD; }
template <int HD>
__host__ __device__ constexpr int part_width(int p) { return 2 * part_cols<HD>(p); }
__host__ __device__ constexpr int part_offset(int p) { return p * kRowsWG * 128; }
// byte offset in a tile of 16-byte chunk c (channels 8c..8c+7) of row r
template <int HD>
__device__ __forceinline__ int chunk_offset(int r, int c) {
  const int p = HD == 80 ? c / 8 : 0;
  const int w = part_width<HD>(p);
  const int off = r * w + (c - 8 * p) * 16;
  return part_offset(p) + (off ^ (((off >> 7) & (w / 16 - 1)) << 4));
}
// the ring of a sequence of n keys, the warpgroups' q tiles and the
// barriers; a bias's shared memory follows
template <int HD>
__host__ __device__ constexpr size_t core_smem_bytes(int n) {
  return ring_stages<HD>(n) * (2 * tile_bytes<HD>() + 2 * sizeof(uint64_t)) +
         kWarpgroups * q_tile_bytes<HD>();
}

// Row tiles of 64 a block takes: all of a (sample, head)'s when its keys
// fit the ring (K/V read once), else one a warpgroup.
template <int HD>
inline int row_tiles_per_block(int n) {
  const int key_tiles = (n + kTileKeys - 1) / kTileKeys;
  const int row_tiles = (n + kRowsWG - 1) / kRowsWG;
  return key_tiles <= max_resident<HD>() ? row_tiles : kWarpgroups;
}

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 2-D tensor map (column, row) into shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// barrier of one warpgroup (ids 1.. ; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving a register's uses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// matrix descriptor of an operand at `p` in a part of W-byte swizzled rows
// (its swizzle atom 1024-byte aligned): start address, LBO 16 bytes (not
// read for these layouts), SBO 8 rows, layout type 1 (128-byte), 2 (64) or
// 3 (32), all in 16-byte units
template <int W>
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  constexpr uint64_t type = W == 128 ? 1 : W == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * W / 16) << 32) | (type << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64 fp32) (+)= A (64 x 16, K-major, shared) x B (16 x 64, K-major, shared);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]),
        "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]),
        "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]),
        "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same with B 16 x 8: a tail tile of at most 8 keys
__device__ __forceinline__ void wgmma_ss(float (&d)[1][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N fp32) += A (64 x 16 bf16, registers) x B (16 x N, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so the library links against cudart alone
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The (rows, c3) bf16 qkv matrix (rows = b * n tokens, c3 = 3 C channels,
// 16-byte aligned) as 2-D tensor maps, one for each part of an hd-channel
// tile: box {part's channels, 64 rows} with the swizzle of the part's row
// width. Box (col, row) is that part of the tile of 64 rows from `row`;
// rows past the matrix read as zeros. Returns 0 or a CUDA error code.
template <int HD>
int encode_kv_maps(CUtensorMap (&maps)[2], const void* qkv, long long rows, long long c3) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  for (int p = 0; p < 2; ++p) {
    const int pp = p < n_parts<HD>() ? p : 0;  // an unused second map repeats the first
    const int w = part_width<HD>(pp);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c3), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c3) * 2};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(part_cols<HD>(pp)), kTileKeys};
    const cuuint32_t elem[2] = {1, 1};
    const CUtensorMapSwizzle swizzle = w == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : w == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult r = fn(&maps[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(qkv),
                          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// ------------------------------------------------------------ the core

// One (sample, head): its q rows and output rows, and where its K and V
// lie in the kv map.
struct Tiles {
  const bf16* q;       // row 0 of this (sample, head)'s q
  bf16* out;           // row 0 of its output
  long long sq, so;    // row strides in elements
  int n;               // query rows = keys
  int kv_row;          // the sample's first row in the kv maps
  int k_col, v_col;    // first channel of the head's k and v in the kv maps
};

// A bias has kPrescale (q enters the product as bf16(q * qscale): K1's
// q_aug), prepare(qs, q0, n), which a warpgroup's 128 threads call on their
// unscaled q tile (in shared memory, 16-byte chunk c of row r at
// chunk_offset<HD>(r, c)), and
// add(s, k0, nk, t) on a lane's score fragments (rows g (e 0, 1) and g + 8
// (e 2, 3), key k0 + 8 nt + 2 t + (e & 1)).
struct NoBias {
  static constexpr bool kPrescale = false;
  __device__ __forceinline__ void prepare(const unsigned char*, int, int) const {}
  template <int NT>
  __device__ __forceinline__ void add(float (&)[NT][4], int, int, int) const {}
};

// The swizzle atoms need 1024-byte aligned tiles. The kernels declare their
// dynamic shared memory __align__(1024) and keep no 1 KB slack to realign
// it (the registers of two blocks an SM do not allow the offset math): on
// sm_90 a kernel with no static shared memory has it start right after the
// block's 1 KB reserved area, so 1024-byte aligned. A base that is not
// traps rather than let the tiles be read in a wrong layout.
__device__ __forceinline__ unsigned char* checked_base(unsigned char* p) {
  if (smem_u32(p) & 1023) __trap();
  return p;
}

// Softmax attention of row tiles [rt0, rt0 + n_rt) (64 rows each) of one
// (sample, head), all threads of the block. p = ex2(s * score_scale - m *
// score_scale) with s the fp32 score before any scale (K5: score_scale =
// scale * log2 e, the product scaled as _qkv_kernel scales it; K1: log2 e,
// the scale already in q). `smem` is 1024-byte aligned, core_smem_bytes(n)
// of it.
template <int HD, class Bias>
__device__ __forceinline__ void attend(const CUtensorMap* kv0, const CUtensorMap* kv1,
                                       const Tiles& op,
                                       unsigned char* smem, int rt0, int n_rt, float qscale,
                                       float score_scale, const Bias& bias) {
  static_assert(HD % 16 == 0 && HD <= 80, "head dim: 16, 32, 64 or 80");
  constexpr int TB = tile_bytes<HD>();
  constexpr int CH = HD / 8;          // 8-channel chunks of a row
  constexpr int KS = HD / 16;         // k16 steps of Q K^T
  constexpr int NT = kTileKeys / 8;   // 8-key blocks of a score tile
  constexpr int QV = HD / 16;         // 16-byte q chunks a thread loads (64 CH / 128)
  constexpr int NA = part_cols<HD>(0);                 // hd columns of part 0
  constexpr int W0 = part_width<HD>(0), W1 = part_width<HD>(1);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n = op.n;
  const int n_kt = (n + kTileKeys - 1) / kTileKeys;
  const int S = ring_stages<HD>(n);
  const bool resident = n_kt <= S;

  unsigned char* ring = smem;  // [S][K tile, V tile]
  unsigned char* qtiles = ring + S * 2 * TB;  // [kWarpgroups][q tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(qtiles + kWarpgroups * q_tile_bytes<HD>());
  uint64_t* empty = full + S;
  const int live = min(kWarpgroups, n_rt);

  auto load = [&](int tile, int stage) {
    unsigned char* dst = ring + stage * 2 * TB;
    const int row = op.kv_row + tile * kTileKeys;
    mbar_expect_tx(&full[stage], 2 * TB);
    tma_load_2d(dst, kv0, &full[stage], op.k_col, row);
    tma_load_2d(dst + TB, kv0, &full[stage], op.v_col, row);
    if constexpr (n_parts<HD>() == 2) {
      tma_load_2d(dst + part_offset(1), kv1, &full[stage], op.k_col + NA, row);
      tma_load_2d(dst + TB + part_offset(1), kv1, &full[stage], op.v_col + NA, row);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], live);
    }
    mbar_fence_init();
    for (int s = 0; s < min(S, n_kt); ++s) load(s, s);
  }
  __syncthreads();
  if (wg >= live) return;

  unsigned char* qs = qtiles + wg * q_tile_bytes<HD>();
  const int bar = 1 + wg;
  for (int rt = rt0 + wg; rt < rt0 + n_rt; rt += kWarpgroups) {
    const int q0 = rt * kRowsWG;
    // the q tile, 16-byte chunks read along rows, stored swizzled
    wg_sync(bar);  // the previous row tile's reads of qs and the bias are done
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int e = tid + 128 * i;
      const int r = e / CH, c = e - r * CH;
      *reinterpret_cast<uint4*>(qs + chunk_offset<HD>(r, c)) =
          q0 + r < n ? *reinterpret_cast<const uint4*>(op.q + (q0 + r) * op.sq + 8 * c)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (Bias::kPrescale) {
      wg_sync(bar);
      bias.prepare(qs, q0, n);
      wg_sync(bar);
#pragma unroll
      for (int i = 0; i < QV; ++i) {
        const int e = tid + 128 * i;
        uint4* chunk = reinterpret_cast<uint4*>(qs + chunk_offset<HD>(e / CH, e % CH));
        const uint4 v = *chunk;
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = pack2(lo_of(w[j]) * qscale, hi_of(w[j]) * qscale);
        *chunk = make_uint4(x[0], x[1], x[2], x[3]);
      }
    }
    fence_async_shared();
    wg_sync(bar);

    float o[NA / 2];  // output columns 0..NA-1
    float o1[8];      // hd 80: columns 64..79
#pragma unroll
    for (int i = 0; i < NA / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) o1[i] = 0.f;
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // running max of rows g, g + 8
    float l_lo = 0.f, l_hi = 0.f;                      // this lane's partial sums

    // One key tile of NTT 8-key blocks: a full tile, or a last tile of at
    // most 8 keys (K5's 257th, K1's windows' last 4 of 196), whose product,
    // softmax and P V shrink to one block instead of running 64 padded keys.
    auto tile_step = [&](auto ntt, int kt, const unsigned char* kt_s,
                         const unsigned char* vt_s) {
      constexpr int NTT = decltype(ntt)::value;
      constexpr int KTT = (NTT + 1) / 2;  // k16 steps of P V
      float sf[NTT][4];  // the score tile's fragments (the first k-step overwrites them)

      // S = Q K^T (fp32)
      fence_regs(sf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < NA / 16)
          wgmma_ss(sf, make_desc<W0>(qs + 32 * kk), make_desc<W0>(kt_s + 32 * kk), kk > 0);
        else  // hd 80's last 16 channels
          wgmma_ss(sf, make_desc<W1>(qs + part_offset(1)), make_desc<W1>(kt_s + part_offset(1)),
                   1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sf);

      const int k0 = kt * kTileKeys, nk = min(kTileKeys, n - k0);
      bias.add(sf, k0, nk, t);
      if (nk < 8 * NTT) {  // keys past n
#pragma unroll
        for (int nt = 0; nt < NTT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * nt + 2 * t + (e & 1) >= nk) sf[nt][e] = -CUDART_INF_F;
      }
      float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NTT; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(sf[nt][0], sf[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sf[nt][2], sf[nt][3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float corr_lo = ex2((m_lo - mn_lo) * score_scale);  // 0 at the first tile
      const float corr_hi = ex2((m_hi - mn_hi) * score_scale);
      m_lo = mn_lo;
      m_hi = mn_hi;
      const float nb_lo = -mn_lo * score_scale, nb_hi = -mn_hi * score_scale;

      // p rounded to bf16 pairs: the A fragments of P V (keys past the last
      // block zero); l sums the rounded p
      uint32_t pa[KTT][4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int kk = 0; kk < KTT; ++kk) {
        const float(&x)[4] = sf[2 * kk];
        pa[kk][0] = pack2(ex2(fmaf(x[0], score_scale, nb_lo)), ex2(fmaf(x[1], score_scale, nb_lo)));
        pa[kk][1] = pack2(ex2(fmaf(x[2], score_scale, nb_hi)), ex2(fmaf(x[3], score_scale, nb_hi)));
        sum_lo += lo_of(pa[kk][0]) + hi_of(pa[kk][0]);
        sum_hi += lo_of(pa[kk][1]) + hi_of(pa[kk][1]);
        if (2 * kk + 1 < NTT) {
          const float(&y)[4] = sf[2 * kk + 1 < NTT ? 2 * kk + 1 : 0];
          pa[kk][2] = pack2(ex2(fmaf(y[0], score_scale, nb_lo)), ex2(fmaf(y[1], score_scale, nb_lo)));
          pa[kk][3] = pack2(ex2(fmaf(y[2], score_scale, nb_hi)), ex2(fmaf(y[3], score_scale, nb_hi)));
          sum_lo += lo_of(pa[kk][2]) + hi_of(pa[kk][2]);
          sum_hi += lo_of(pa[kk][3]) + hi_of(pa[kk][3]);
        } else {
          pa[kk][2] = pa[kk][3] = 0u;
        }
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
      // rescale O where a row's max moved (a factor of exactly 1 elsewhere,
      // so skipping it changes nothing)
      if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
        for (int j = 0; j < NA / 8; ++j) {
          o[4 * j] *= corr_lo;
          o[4 * j + 1] *= corr_lo;
          o[4 * j + 2] *= corr_hi;
          o[4 * j + 3] *= corr_hi;
        }
        if constexpr (n_parts<HD>() == 2) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            o1[4 * j] *= corr_lo;
            o1[4 * j + 1] *= corr_lo;
            o1[4 * j + 2] *= corr_hi;
            o1[4 * j + 3] *= corr_hi;
          }
        }
      }

      // O += P V
      fence_regs(o);
      fence_regs(o1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KTT; ++kk) {
        wgmma_rs(o, pa[kk], make_desc<W0>(vt_s + kk * 16 * W0));
        if constexpr (n_parts<HD>() == 2)
          wgmma_rs(o1, pa[kk], make_desc<W1>(vt_s + part_offset(1) + kk * 16 * W1));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      fence_regs(o1);
      fence_regs(pa);
    };

    for (int kt = 0; kt < n_kt; ++kt) {
      const int stage = kt % S;
      if (!resident && threadIdx.x == 0 && kt > 0 && kt - 1 + S < n_kt) {
        // refill the stage tile kt - 1 used once every warpgroup released it
        const int ps = (kt - 1) % S;
        mbar_wait(&empty[ps], ((kt - 1) / S) & 1);
        load(kt - 1 + S, ps);
      }
      __syncwarp();
      mbar_wait(&full[stage], resident ? 0 : (kt / S) & 1);
      const unsigned char* kt_s = ring + stage * 2 * TB;
      if (n - kt * kTileKeys <= 8)
        tile_step(std::integral_constant<int, 1>{}, kt, kt_s, kt_s + TB);
      else
        tile_step(std::integral_constant<int, NT>{}, kt, kt_s, kt_s + TB);
      if (!resident && tid == 0) mbar_arrive(&empty[stage]);
    }

    // the row maximum contributes bf16(exp(0)) = 1 to l, so l >= 1 and the
    // clamp (the TPU kernels') never acts
    const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
    const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
    const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
    auto store = [&](float a, float b, float c, float d, int col) {
      if (r_lo < n)
        *reinterpret_cast<uint32_t*>(op.out + r_lo * op.so + col) = pack2(a * inv_lo, b * inv_lo);
      if (r_hi < n)
        *reinterpret_cast<uint32_t*>(op.out + r_hi * op.so + col) = pack2(c * inv_hi, d * inv_hi);
    };
#pragma unroll
    for (int j = 0; j < NA / 8; ++j)
      store(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3], 8 * j + 2 * t);
    if constexpr (n_parts<HD>() == 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        store(o1[4 * j], o1[4 * j + 1], o1[4 * j + 2], o1[4 * j + 3], NA + 8 * j + 2 * t);
    }
  }
}

}  // namespace wgattn
}  // namespace sam6d
