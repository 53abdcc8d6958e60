// Three-pass TF32 on Hopper's warpgroup tensor-core path (K1's fp32 entry):
// wgmma.mma_async m64nNk8 .tf32 with fp32 accumulation, A in registers and B
// in shared memory, the split of
// tf32x3.cuh (big = rna_tf32(x), small = rna_tf32(x - big); a product is
// small*big + big*small + big*big, small terms first), operands by TMA
// bulk copies on the mbarriers of bf16_wgmma.cuh.
//
// For .tf32 both wgmma operands are K-major (the transpose flags exist only
// for f16/bf16): A is M x K with K contiguous, B is N rows of K contiguous.
// Every operand tile here is stored in "parts" of 8 K-elements (32 bytes, one
// k8 step) by its rows, each part in wgmma's 32-byte swizzled K-major layout:
// row r of a part at 32 r bytes, its 16-byte chunk c at chunk c ^ ((r >> 2)
// & 1) (address bit 4 XOR bit 7; swizzle atoms of 8 rows, 256-byte aligned).
// A k8 step's descriptor is its part's base (LBO unused, SBO 256 bytes, 32-byte
// swizzle), so any multiple of 8 rows and of 8 K-elements is one layout, and
// the 8 16-byte chunks a core matrix reads fall in 8 distinct bank groups.
//
// Fragments: the accumulator of m64nNk8 .f32 is that of the bf16 core (warp
// w of the warpgroup holds rows 16 w + g and 16 w + g + 8, lane = 4 g + t;
// d[4 j + e] is column 8 j + 2 t + (e & 1) of row g (e < 2) or g + 8), and A
// in registers is mma.sync m16n8k8's tf32 A per warp: a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4). So a score tile's fragments are the A
// fragments of P V as they stand if the K order inside each 8-key step is
// permuted on the V side: k = t is key 2 t and k = t + 4 is key 2 t + 1, a0..a3
// = c0, c2, c1, c3 (tf32x3.cuh's trick); V^T stores its keys in that order.
#pragma once

#include <cstdint>

#include "bf16_wgmma.cuh"  // mbarriers, bulk copies, wgmma fences, make_desc
#include "tf32x3.cuh"      // to_tf32, split_tf32, quad_max, quad_sum

namespace sam6d {
namespace tf32wg {

// byte offset of element (row r, K index k) of an operand tile of `rows` rows
// stored in 32-byte swizzled parts of 8 K-elements
__host__ __device__ constexpr int part32_offset(int r, int k, int rows) {
  return (k / 8) * rows * 32 + r * 32 + 16 * (((k % 8) / 4) ^ ((r >> 2) & 1)) + 4 * (k % 4);
}

// V^T's K order: slot s of an 8-key step holds key 2 s (s < 4) or 2 (s - 4) + 1,
// and key o of the step sits in slot o / 2 + 4 (o & 1)
__host__ __device__ constexpr int vt_slot(int o) { return o / 2 + 4 * (o & 1); }

// descriptor of a part at `p` (256-byte aligned)
__device__ __forceinline__ uint64_t part_desc(const void* p) {
  return wgattn::make_desc<32>(p);
}

// four floats split into their big and small tf32 halves
__device__ __forceinline__ void split4(const float4& x, uint4& big, uint4& small) {
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
}

// d (64 x 32 fp32) (+)= A (64 x 8 tf32, registers) x B (8 x 32, K-major, shared);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 40 fp32) (+)= A (64 x 8 tf32, registers) x B (8 x 40, K-major, shared);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[5][4], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 16 fp32) (+)= A (64 x 8 tf32, registers) x B (8 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 32 fp32) (+)= A (64 x 8 tf32, registers) x B (8 x 32, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) (+)= A (64 x 8 tf32, registers) x B (8 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 80 fp32) (+)= A (64 x 8 tf32, registers) x B (8 x 80, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace tf32wg
}  // namespace sam6d
