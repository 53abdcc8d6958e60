// One-pass bf16 tensor-core helpers shared by the bf16 entries of K2-K4
// (factored_bf16.cu) and the wgmma attention core (bf16_wgmma.cuh):
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with fp32
// accumulation (989 TFLOP/s dense bf16 on an H100 SXM, where the fp32
// entries' three-pass TF32 stops at 495/3), ldmatrix of transposed B
// fragments, and packing of fp32 pairs to bf16 words.
//
// The contract of the JAX package's bf16 kernels
// (sam6d_tpu/kernels/flash_attention.py: _fused_kernel, _small_kernel,
// _qkv_kernel; factored_t2i.py): q, k and v are bf16; the scores, the
// running max, the softmax sum l and the output accumulator are fp32; p =
// exp(s - m) is rounded to bf16 as the A operand of P V, and l sums that
// rounded p, so the numerator and the denominator see the same
// probabilities; the output is O / max(l, 1e-30) rounded to bf16.
//
// Fragments of m16n8k16 (PTX ISA), lane = 4 g + t, each register two bf16
// with the lower column in the low half:
//   A (16x16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8, fp32):  c0, c1 (g, 2t, 2t+1)  c2, c3 (g+8, 2t, 2t+1)
// So the C fragments of two neighbouring 8-key score tiles are, packed to
// bf16 pairs, the A fragment of P over those 16 keys as they stand, with no
// shuffle, and ldmatrix.trans reads the B fragment of P V out of row-major
// V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "tf32x3.cuh"  // cp.async, quad_max, quad_sum

namespace sam6d {
namespace bf16attn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragment of P V for 16 keys and 8 head-dim columns from row-major V in
// shared memory: lanes 0-15 give the addresses of the 16 key rows (lanes
// 16-31 repeat them), each row's 8 columns 16 bytes.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2], const bf16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// Two floats rounded to nearest even as a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_of(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_of(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace bf16attn
}  // namespace sam6d
