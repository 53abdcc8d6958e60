// Three-pass TF32 on Hopper's tensor cores, and the attention core built on
// it: fp32-accurate products at up to 495/3 = 165 TFLOP/s (H100 SXM dense
// TF32 over three passes), where the fp32 FMA units stop at 67 TFLOP/s.
//
// Each fp32 operand x is split as big = rna_tf32(x) and small =
// rna_tf32(x - big) (the rounding of cvt.rna.tf32.f32: to nearest, ties
// away, 10 mantissa bits); a product accumulates small*big + big*small +
// big*big into the fp32 accumulator, small terms first, and drops
// small*small. What is lost is below 2^-21 of each product, close to fp32's
// own rounding; one pass of TF32 alone keeps about three decimal digits
// (tests/test_torch_port_kernels.py emulates both in numpy against
// float64).
//
// The products are mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. In a
// warp, lane = 4 g + t (g = groupID 0..7, t = thread in group 0..3):
//   A (16x8, row-major):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8x8, "col"):       b0 (k=t, n=g)   b1 (k=t+4, n=g)
//   C (16x8):             c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace sam6d {

// cvt.rna.tf32.f32 done in integer arithmetic: adding half of the 13 dropped
// bits' weight to the bit pattern and clearing them rounds the magnitude to
// nearest, ties away, carrying into the exponent where it must; for finite
// x the bits equal cvt.rna's. ptxas lowers cvt.rna.tf32.f32 to a longer
// sequence with NaN handling (a compare and a select per element), and the
// split runs for every fragment element: on an H100 that made K5 a quarter
// slower (PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in three passes, small terms first.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

__device__ __forceinline__ void split_a(const float (&x)[4], uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}

// B fragment of M^T for a row-major M (e.g. K, [n][k] with row stride ld):
// b0 = M[g][t], b1 = M[g][t + 4]. With ld = 4 (mod 16) the warp's 32 reads
// fall in 32 different banks.
__device__ __forceinline__ void load_b_nk(const float* m, int ld, int g, int t,
                                          uint32_t (&big)[2], uint32_t (&small)[2]) {
  split_tf32(m[g * ld + t], big[0], small[0]);
  split_tf32(m[g * ld + t + 4], big[1], small[1]);
}

// B fragment of a row-major [k][n] M (e.g. V) with the k index permuted so
// that the C fragment of a score tile is its A fragment as it stands: k = t
// is row 2t and k = t + 4 is row 2t + 1, so b0 = M[2t][g], b1 = M[2t+1][g],
// and P's a0..a3 are its c0, c2, c1, c3. Conflict-free for ld = 4 (mod 16).
__device__ __forceinline__ void load_b_kn_paired(const float* m, int ld, int g, int t,
                                                 uint32_t (&big)[2], uint32_t (&small)[2]) {
  split_tf32(m[(2 * t) * ld + g], big[0], small[0]);
  split_tf32(m[(2 * t + 1) * ld + g], big[1], small[1]);
}

// 16-byte cp.async; src_bytes 0 fills the destination with zeros (the
// source address must still be a valid one).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Max and sum over the 4 lanes of a quad (the lanes that share a C row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- the core
//
// Attention straight off a fused (B, N, 3C) qkv projection ([q | k | v] on
// the channel axis, heads contiguous), one (sample, head, 16 * WARPS query
// rows) per block, each warp owning 16 rows:
//  - the block's q rows sit in shared memory, pre-scaled, and each warp
//    reads its 16 as A fragments (q in registers would hold 40 of them at hd
//    80 and leave K1 short of registers for three blocks an SM);
//  - K and V tiles of BK keys stream through two shared stages with
//    cp.async, read straight from the strided qkv (rows past N are zero
//    filled), rows padded to HD + 4 floats so that both B-fragment reads are
//    conflict-free;
//  - S = q K^T by three-pass TF32 into C fragments in registers; the bias
//    functor adds its term there, keys past N get -inf;
//  - online softmax in registers: row max and sum by quad shuffles, the
//    running max per row, each lane's partial sum, the rescale applied to
//    the output fragments; scores never reach shared memory;
//  - O += P V by three-pass TF32, P's C fragments reused as A fragments
//    (the key order inside each 8-key step permuted on the V side);
//  - out = O / max(l, 1e-30), written at the head's channel offset.
// N-tiles and key steps wholly past N are skipped, and a warp whose rows
// all lie past N only helps load.
template <int HD>
__host__ __device__ constexpr int smem_row() { return HD + 4; }

// The block's q rows (16 per warp), then two stages of K and V tiles of BK
// keys.
template <int HD, int WARPS, int BK>
__host__ __device__ constexpr size_t core_smem_bytes() {
  return sizeof(float) * (16 * WARPS + 2 * 2 * BK) * smem_row<HD>();
}

// A bias functor has prepare(), which the whole block calls once with the
// unscaled q rows in shared memory (row stride ld, first row q0 of n), and
// add(), which a lane calls on its score fragments s[nt][e]: rows g (e 0,
// 1) and g + 8 (e 2, 3), key k0 + 8 nt + 2 t + (e & 1), nk keys in the tile.
struct NoBias {
  __device__ __forceinline__ void prepare(const float*, int, int, int) const {}
  template <int NT>
  __device__ __forceinline__ void add(float (&)[NT][4], int, int, int) const {}
};

template <int HD, int WARPS, int BK, class Bias>
__device__ __forceinline__ void attention_rows(const float* __restrict__ qkv,
                                               float* __restrict__ out, float* smem,
                                               int n, int c, int h, int q0, float scale,
                                               const Bias& bias) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BK % 8 == 0, "key tile must be a multiple of 8");
  constexpr int kTileKeys = BK;
  constexpr int LD = smem_row<HD>();
  constexpr int KS = HD / 8;          // k8 steps of q k^T, n8 tiles of P V
  constexpr int NT = kTileKeys / 8;   // n8 tiles of q k^T, k8 steps of P V
  constexpr int kThreads = WARPS * 32;
  constexpr int kChunks = kTileKeys * HD / 4;  // 16-byte chunks of K (or V) a tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t rs = 3 * static_cast<size_t>(c);
  const float* qb = qkv + h * HD;
  const float* kb = qkv + c + h * HD;
  const float* vb = qkv + 2 * c + h * HD;
  const int r0 = q0 + warp * 16;      // the warp's first row
  const bool live = r0 < n;

  float* qs = smem;                         // [16 WARPS][LD]
  float* ks = smem + 16 * WARPS * LD;       // [2][kTileKeys][LD]
  float* vs = ks + 2 * kTileKeys * LD;      // [2][kTileKeys][LD]
  auto load_tile = [&](int k0, int stage) {
    float* kd = ks + stage * kTileKeys * LD;
    float* vd = vs + stage * kTileKeys * LD;
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
      const bool ok = k0 + j < n;
      const size_t off = static_cast<size_t>(ok ? k0 + j : 0) * rs + d;
      cp_async16(kd + j * LD + d, kb + off, ok);
      cp_async16(vd + j * LD + d, vb + off, ok);
    }
  };

  const int n_tiles = (n + kTileKeys - 1) / kTileKeys;
  load_tile(0, 0);
  cp_async_commit();

  // The block's q rows go to shared memory as they are (rows past N as
  // zeros); the bias may read them there (the rel-pos tables take the
  // unscaled q); then they are scaled in place, the same fp32 product
  // q * scale the plain version forms, and read per k8 step as A fragments:
  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
  for (int e = threadIdx.x; e < 16 * WARPS * (HD / 4); e += kThreads) {
    const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n) x = *reinterpret_cast<const float4*>(qb + (q0 + r) * rs + d);
    *reinterpret_cast<float4*>(qs + r * LD + d) = x;
  }
  __syncthreads();
  bias.prepare(qs, LD, q0, n);
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * WARPS * (HD / 4); e += kThreads) {
    float4* x = reinterpret_cast<float4*>(qs + (e / (HD / 4)) * LD + 4 * (e % (HD / 4)));
    *x = make_float4(x->x * scale, x->y * scale, x->z * scale, x->w * scale);
  }
  const float* qw = qs + warp * 16 * LD;
  float o[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // running max, rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;                      // this lane's partial sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTileKeys;
    if (tile + 1 < n_tiles) load_tile(k0 + kTileKeys, (tile + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (live) {
      const float* kt = ks + (tile & 1) * kTileKeys * LD;
      const float* vt = vs + (tile & 1) * kTileKeys * LD;
      const int nk = min(kTileKeys, n - k0);

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4];
        const float x[4] = {qw[g * LD + 8 * kk + t], qw[(g + 8) * LD + 8 * kk + t],
                            qw[g * LD + 8 * kk + t + 4], qw[(g + 8) * LD + 8 * kk + t + 4]};
        split_a(x, ab, as);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt < nk) {
            uint32_t bb[2], bs[2];
            load_b_nk(kt + 8 * nt * LD + 8 * kk, LD, g, t, bb, bs);
            mma_tf32x3(s[nt], ab, as, bb, bs);
          }
        }
      }
      bias.add(s, k0, nk, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * nt + 2 * t + (e & 1) >= nk) s[nt][e] = -CUDART_INF_F;

      float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);  // 0 at first
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = expf(s[nt][0] - mn_lo);
        s[nt][1] = expf(s[nt][1] - mn_lo);
        s[nt][2] = expf(s[nt][2] - mn_hi);
        s[nt][3] = expf(s[nt][3] - mn_hi);
        sum_lo += s[nt][0] + s[nt][1];
        sum_hi += s[nt][2] + s[nt][3];
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;

      // P as A fragments; this tile's P V is summed from zero and added to O
      // on the fp32 units, so the tensor cores' accumulation (which does
      // not round to nearest) runs over one tile, not over all N keys
      uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float pa[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
        split_a(pa, pb[nt], ps[nt]);
      }
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt < nk) {
            uint32_t bb[2], bs[2];
            load_b_kn_paired(vt + 8 * nt * LD + 8 * nd, LD, g, t, bb, bs);
            mma_tf32x3(acc, pb[nt], ps[nt], bb, bs);
          }
        }
        o[nd][0] = fmaf(o[nd][0], corr_lo, acc[0]);
        o[nd][1] = fmaf(o[nd][1], corr_lo, acc[1]);
        o[nd][2] = fmaf(o[nd][2], corr_hi, acc[2]);
        o[nd][3] = fmaf(o[nd][3], corr_hi, acc[3]);
      }
    }
    __syncthreads();  // the stage just read is refilled next iteration
  }

  if (!live) return;
  const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
  float* ob = out + h * HD + 2 * t;
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
    if (r0 + g < n)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(r0 + g) * c + 8 * nd) =
          make_float2(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    if (r0 + g + 8 < n)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(r0 + g + 8) * c + 8 * nd) =
          make_float2(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
  }
}

}  // namespace sam6d
