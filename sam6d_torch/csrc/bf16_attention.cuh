// The bf16 attention core on Hopper's bf16 tensor cores (the bf16 entries
// of K8 and K9; K1's and K5's run on bf16_wgmma.cuh):
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// with fp32 accumulation, one pass (989 TFLOP/s dense bf16 on an H100 SXM,
// where the fp32 entries' three-pass TF32 stops at 495/3).
//
// The contract is the JAX package's bf16 kernels
// (sam6d_tpu/kernels/flash_attention.py: _fused_kernel, _small_kernel,
// _qkv_kernel): q, k and v are bf16; the scores, the running max, the
// softmax sum l and the output accumulator are fp32; p = exp(s - m) is
// rounded to bf16 as the A operand of P V, and l sums that rounded p, so the
// numerator and the denominator see the same probabilities; the output is
// O / max(l, 1e-30) rounded to bf16.
//
// Fragments of m16n8k16 (PTX ISA), lane = 4 g + t, each register two bf16
// with the lower column in the low half:
//   A (16x16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8, fp32):  c0, c1 (g, 2t, 2t+1)  c2, c3 (g+8, 2t, 2t+1)
// So the C fragments of two neighbouring 8-key score tiles are, packed to
// bf16 pairs, the A fragment of P over those 16 keys as they stand, with no
// shuffle; a K row holds its B fragment of q K^T as two 32-bit words, and
// ldmatrix.trans reads the B fragment of P V out of row-major V.
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

struct Operands {
  const bf16* q;             // the (sample, head)'s row 0 of q, k, v and out
  const bf16* k;
  const bf16* v;
  bf16* out;
  long long sq, sk, sv, so;  // row strides in elements
  int nq, nk;                // query rows, keys
  int hd;                    // true head dim: a multiple of 8, <= the core's HD
};

// shared-memory row of a K or V tile: HD + 8 bf16 (an odd number of 16-byte
// units, so the 32-bit K-fragment reads and the ldmatrix rows are
// conflict-free)
template <int HD>
__host__ __device__ constexpr int row_elems() { return HD + 8; }

// two stages of a K tile and a V tile of BK keys
template <int HD, int BK>
__host__ __device__ constexpr size_t core_smem_bytes() {
  return sizeof(bf16) * 2 * 2 * BK * row_elems<HD>();
}

// A bias has prepare(op, q0), which the whole block calls once before the
// key loop (it may fill shared memory), and add(s, k0, nk, t) on a lane's
// score fragments, in the C layout above: rows g (e 0, 1) and g + 8 (e 2,
// 3), key k0 + 8 nt + 2 t + (e & 1).
struct NoBias {
  __device__ __forceinline__ void prepare(const Operands&, int) const {}
  template <int NT>
  __device__ __forceinline__ void add(float (&)[NT][4], int, int, int) const {}
};

// Softmax attention of one (sample, head) block of 16 * WARPS query rows,
// each warp owning 16 rows, K and V tiles of BK keys double-buffered in
// shared memory by 16-byte cp.async straight from the strided operands
// (rows past nk and columns past hd zero-filled). kPrescale: q enters the
// product as bf16(q * scale), the scaled operand of JAX's _fused_kernel (K1,
// K8; the caller passes scale already rounded to bf16, as JAX scales by a
// bf16 constant); otherwise the fp32 product is scaled (K5, K9: _qkv_kernel,
// _small_kernel). Needs 16-byte aligned rows of k and v and 4-byte aligned
// rows of q and out.
template <int HD, int WARPS, int BK, bool kPrescale, class Bias>
__device__ __forceinline__ void attention_rows(const Operands& op, bf16* smem, int q0,
                                               float scale, const Bias& bias) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BK % 16 == 0, "key tile must be a multiple of 16");
  constexpr int LD = row_elems<HD>();
  constexpr int KS = HD / 16;  // k16 steps of q k^T
  constexpr int ND = HD / 8;   // n8 tiles of P V
  constexpr int NT = BK / 8;   // n8 tiles of q k^T
  constexpr int KT = BK / 16;  // k16 steps of P V
  constexpr int kThreads = WARPS * 32;
  constexpr int kChunks = BK * (HD / 8);  // 16-byte chunks of a K (or V) tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = op.nq, nk_all = op.nk, hd = op.hd;
  const int r0 = q0 + warp * 16;
  const bool live = r0 < nq;
  const int n_tiles = (nk_all + BK - 1) / BK;

  bf16* ks = smem;                 // [2][BK][LD]
  bf16* vs = smem + 2 * BK * LD;   // [2][BK][LD]

  auto load_tile = [&](int k0, int stage) {
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int j = e / (HD / 8), d = 8 * (e % (HD / 8));
      const bool ok = k0 + j < nk_all && d < hd;
      const long long r = ok ? k0 + j : 0;
      const int dd = ok ? d : 0;
      cp_async16(ks + (stage * BK + j) * LD + d, op.k + r * op.sk + dd, ok);
      cp_async16(vs + (stage * BK + j) * LD + d, op.v + r * op.sv + dd, ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // the warp's q rows as A fragments, once (zeros past nq and hd)
  uint32_t qa[KS][4];
  auto qword = [&](int row, int col) -> uint32_t {
    if (row >= nq || col >= hd) return 0u;
    uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(op.q + row * op.sq + col));
    if constexpr (kPrescale) w = pack2(lo_of(w) * scale, hi_of(w) * scale);
    return w;
  };
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = qword(r0 + g, 16 * kk + 2 * t);
    qa[kk][1] = qword(r0 + g + 8, 16 * kk + 2 * t);
    qa[kk][2] = qword(r0 + g, 16 * kk + 8 + 2 * t);
    qa[kk][3] = qword(r0 + g + 8, 16 * kk + 8 + 2 * t);
  }
  bias.prepare(op, q0);
  __syncthreads();

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // running max, rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;                      // this lane's partial sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_tile(k0 + BK, (tile + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (live) {
      const int nk = min(BK, nk_all - k0);
      const bf16* kt_ = ks + stage * BK * LD;
      const bf16* vt_ = vs + stage * BK * LD;

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt < nk) {
            const bf16* kr = kt_ + (8 * nt + g) * LD + 16 * kk + 2 * t;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                   *reinterpret_cast<const uint32_t*>(kr + 8)};
            mma_bf16(s[nt], qa[kk], b);
          }
        }
      }
      if constexpr (!kPrescale) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
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

      // p rounded to bf16 pairs: the A fragments of P V; l sums the
      // rounded values
      uint32_t pa[KT][4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const float(&x)[4] = s[2 * kt];
        const float(&y)[4] = s[2 * kt + 1];
        pa[kt][0] = pack2(expf(x[0] - mn_lo), expf(x[1] - mn_lo));
        pa[kt][1] = pack2(expf(x[2] - mn_hi), expf(x[3] - mn_hi));
        pa[kt][2] = pack2(expf(y[0] - mn_lo), expf(y[1] - mn_lo));
        pa[kt][3] = pack2(expf(y[2] - mn_hi), expf(y[3] - mn_hi));
        sum_lo += (lo_of(pa[kt][0]) + hi_of(pa[kt][0])) + (lo_of(pa[kt][2]) + hi_of(pa[kt][2]));
        sum_hi += (lo_of(pa[kt][1]) + hi_of(pa[kt][1])) + (lo_of(pa[kt][3]) + hi_of(pa[kt][3]));
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;

#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][0] *= corr_lo;
        o[nd][1] *= corr_lo;
        o[nd][2] *= corr_hi;
        o[nd][3] *= corr_hi;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          if (16 * kt < nk) {
            uint32_t b[2];
            ldmatrix_x2_trans(b, vt_ + (16 * kt + (lane & 15)) * LD + 8 * nd);
            mma_bf16(o[nd], pa[kt], b);
          }
        }
      }
    }
    __syncthreads();  // the stage just read is refilled next iteration
  }

  if (!live) return;
  // the row maximum contributes bf16(exp(0)) = 1 to l, so l >= 1 and the
  // clamp (the TPU kernels') never acts
  const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = 8 * nd + 2 * t;
    if (col >= hd) continue;
    if (r0 + g < nq)
      *reinterpret_cast<uint32_t*>(op.out + (r0 + g) * op.so + col) =
          pack2(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    if (r0 + g + 8 < nq)
      *reinterpret_cast<uint32_t*>(op.out + (r0 + g + 8) * op.so + col) =
          pack2(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
  }
}

}  // namespace bf16attn
}  // namespace sam6d
