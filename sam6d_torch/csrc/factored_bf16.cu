// The bf16 entries of the SAM AMG's three factored kernels, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replace the Pallas kernels of sam6d_tpu/kernels/factored_t2i.py as the
// JAX package runs them: only in bf16 (sam6d_tpu/pipelines/sam_amg.py
// takes the kernel branch for a bf16 TPU run). factored_ln_stats
// (_ln_stats_kernel, K2), factored_t2i_attention (_t2i_kernel, K3) and
// factored_i2t_scores (_i2t_kernel, K4), on the scaled-block factor state
// of csrc/factored.cu's header
//   x[b] = a[b] * S + P_eff[b]^T U[b],  P_eff = [Pd_i * s_i]_i (i < 4)
// with every operand bf16. Each product is bf16 x bf16 with fp32
// accumulation, which is what mma.sync.m16n8k16.bf16 does
// (bf16_attention.cuh), in one pass; the roundings are the JAX kernels':
//  - K4: t_i = bf16(U_Q,i k^T); fp32 scores (k QS^T) a + k QC^T +
//    sum_i (t_i Pd_i) s_i, each block's scale applied to its fp32 product;
//    fp32 softmax over each head's T tokens; bf16 out, a last row of ones;
//  - K3: t1 = bf16(q U_K^T); fp32 scores as K4's over the N positions; the
//    fp32 softmax normalised over all N, then pa = bf16(p a) times VS and
//    pc_i = bf16(p s_i) times Pd_i^T; t2 = bf16(the fp32 sums) times U_V;
//    bf16 out;
//  - K2: fp32 arithmetic on the bf16 values: tilde = Pd s (exact in fp32),
//    x_l = P_eff^T U, mu = a mS + mean(x_l), E[x^2] = a^2 qS +
//    2 a mean(S x_l) + mean(x_l^2) with the caller's bf16 mS, qS; fp32
//    (mu, 1/sigma) out.
//
// Shapes on the main path (ViT-H SAM, 128-prompt chunks): B = 128,
// N = 4096, C = 256, d = 128 as 8 heads of 16, T = 7 tokens, blocks of 57
// (softmax) and 2 (LayerNorm) rows: ranks 57 / 116 (K2), 59 / 118 (K3),
// 0 / 59 (K4).
//
// Designs (K4, K2: products m16n8k16 bf16; K3: wgmma and m16n8k16):
//  - K4 (i2t_bf16_kernel): one block per (prompt, 64 positions). The score
//    tile is M = the head's tokens (rows past T zero) x N = 8 positions:
//    the head-score terms are one k16 step over the head's 16 channels
//    each, the rank term k16 steps over the ranks, each block's rows
//    padded to 16 (`Steps`) so that a block's product ends on a step, with
//    t_i's A fragments formed once by mma (U_Q rows as B fragments) and
//    rounded to bf16 in registers. The tile's QS and QC rows and its P_eff
//    rows are staged once by cp.async (B fragments by 32-bit reads and by
//    ldmatrix.trans). The softmax over tokens is a reduction over the
//    lanes' g; the probabilities leave through shared memory as 16-byte
//    rows.
//  - K3: the normalised p is rounded (JAX's order), so it takes two
//    passes over the positions, one block of one warpgroup per (prompt,
//    chunk of position tiles) each, on wgmma (bf16_wgmma.cuh): the 8 heads'
//    token rows packed into wgmma's 64 rows (see the K3 section).
//    t2i_scores_wgmma_kernel forms each tile's fp32 scores (head terms on
//    mma.sync, the rank term on wgmma against the P_eff tile), stores them
//    in the accumulator's order to a workspace and keeps each row's max and
//    sum of exp over its chunk; t2i_wgmma_kernel merges the chunks'
//    statistics, reads each tile's scores back (one bulk copy), forms p =
//    exp(s - M) / L, and accumulates the value part (mma.sync) and T2 (wgmma
//    against the same P_eff tile read K-major); t2i_merge_bf16_kernel, one
//    block per prompt, sums the chunks' partials, rounds T2, adds T2 U_V and
//    writes the head-diagonal blocks (B, T, d) in bf16. Forming the scores
//    again in the second pass instead took 15-40% longer on an H100
//    (PERF.md); an online softmax in one pass rounds exp(s - m) before it is
//    normalised, and measured up to 4 output ulps off JAX's order at four
//    times the scores.
//  - K2 (ln_stats_bf16_kernel): one block of 8 warps per (prompt, 64
//    positions), the x_l tile (64 positions x 256 channels) on the tensor
//    cores: each tilde (16 significant bits) is split exactly into two
//    bf16, hi = bf16(tilde) and lo = bf16(tilde - hi), so x_l = hi^T U +
//    lo^T U in two one-pass products (one where a stage holds no scaled
//    block: lo is 0), U exact in bf16. Ranks go in stages of 16 through a
//    cp.async ring (U rows, raw P_eff rows and their scales); the thread
//    that copied a chunk splits it into hi and lo planes [rank][position]
//    (A fragments by ldmatrix.trans); the channel sums of x_l, S x_l and
//    x_l^2 are reduced over quads, then over the four channel warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>
#include <cstring>
#include <utility>

#include "bf16_attention.cuh"
#include "bf16_wgmma.cuh"  // K3: wgmma, TMA, mbarriers

namespace {

using sam6d::cp_async16;
using sam6d::cp_async_commit;
using sam6d::cp_async_wait;
using sam6d::quad_max;
using sam6d::quad_sum;
using sam6d::bf16attn::bf16;
using sam6d::bf16attn::hi_of;
using sam6d::bf16attn::ldmatrix_x2_trans;
using sam6d::bf16attn::lo_of;
using sam6d::bf16attn::mma_bf16;
using sam6d::bf16attn::pack2;
using sam6d::bf16attn::round_bf16;
namespace wg = sam6d::wgattn;

constexpr int kMaxBlocks = 4;
constexpr int kThreads = 256;
constexpr int kHeads = 8;             // K3 / K4: one warp per head
constexpr int kHd = 16;               // channels per head
constexpr int kD = kHeads * kHd;      // attention channels
constexpr int kRows = 8;              // tokens per head at most
constexpr int kMaxRank = 128;
// k16 steps of the ranks with each block's rows padded to 16: at most
// sum ceil(r_i / 16) <= (kMaxRank + 15 kMaxBlocks) / 16 = 11
constexpr int kMaxSteps = (kMaxRank + 15 * kMaxBlocks) / 16;
constexpr int kBN = 64;               // positions a tile (K3, K4)
constexpr int kLdp = kBN + 8;         // bf16 a staged P_eff row: ldmatrix rows conflict-free
constexpr int kLdv = kD + 8;          // bf16 a staged VS row

struct Blocks {
  const bf16* pd[kMaxBlocks];  // (B, r[i], N) raw factor rows
  const bf16* s[kMaxBlocks];   // (B, N) per-position scale, or null
  int r[kMaxBlocks];           // 0 past the last block
  int n;
};

// The rank steps of K3 / K4: step ks holds rows lr0..lr0 + rows - 1 of
// block blk (rank r0.. of the concatenation), at rows 16 ks.. of a staged
// P_eff tile; rows past `rows` are zero.
struct Steps {
  int n;
  int8_t blk[kMaxSteps];
  int8_t rows[kMaxSteps];
  int8_t last[kMaxSteps];  // the last step of its block
  int16_t lr0[kMaxSteps];
  int16_t r0[kMaxSteps];
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of m16n8k16 from a [k][m] bf16 array in shared memory (rows of
// k, m contiguous): the four 8x8 matrices at (m0, k0), (m0 + 8, k0),
// (m0, k0 + 8), (m0 + 8, k0 + 8), transposed as they load.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* km, int ld) {
  const int lane = threadIdx.x % 32, mat = lane / 8;
  const bf16* row = km + (lane % 8 + 8 * (mat / 2)) * ld + 8 * (mat % 2);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// ------------------------------------------------------ K3 / K4 pieces
//
// Warp h = head h, lane (g, t). A score tile is the m16n8 C fragment of
// M = token rows (g < T live; rows g + 8 are padding) x N = 8 positions:
// lane (g, t) holds token g at positions 2t, 2t + 1 in c0, c1.

// The head's token rows as an A fragment over its 16 channels: a0 (token
// g, channels 2t, 2t + 1), a2 (channels 2t + 8, 2t + 9); a1 = a3 = 0.
__device__ __forceinline__ void token_fragment(uint32_t (&qa)[2], const bf16* qh, int t_tok) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  qa[0] = qa[1] = 0u;
  if (g < t_tok) {
    qa[0] = ld32(qh + g * kD + 2 * t);
    qa[1] = ld32(qh + g * kD + 2 * t + 8);
  }
}

// T1 = bf16(token rows x U_h^T) as the A fragments of the rank term, one
// pair a step: t1[ks][0] (token g, the step's ranks 2t, 2t + 1), t1[ks][1]
// (ranks 2t + 8, 2t + 9). ub: the prompt's U rows at head h (row stride kD).
__device__ __forceinline__ void t1_fragments(uint32_t (&t1)[kMaxSteps][2],
                                             const uint32_t (&qa)[2], const bf16* ub,
                                             const Steps& st) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const uint32_t a[4] = {qa[0], 0u, qa[1], 0u};
#pragma unroll
  for (int ks = 0; ks < kMaxSteps; ++ks) {
    t1[ks][0] = t1[ks][1] = 0u;
    if (ks < st.n) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * u + g;
        uint32_t b[2] = {0u, 0u};
        if (j < st.rows[ks]) {
          const bf16* row = ub + static_cast<size_t>(st.r0[ks] + j) * kD + 2 * t;
          b[0] = ld32(row);
          b[1] = ld32(row + 8);
        }
        mma_bf16(c[u], a, b);
      }
      t1[ks][0] = pack2(c[0][0], c[0][1]);
      t1[ks][1] = pack2(c[1][0], c[1][1]);
    }
  }
}

// bl.pd[i] / bl.s[i] for a runtime i, without indexing the kernel
// parameter (which would copy the record to local memory)
__device__ __forceinline__ const bf16* pick(const bf16* const (&p)[kMaxBlocks], int i) {
  const bf16* v = p[0];
#pragma unroll
  for (int k = 1; k < kMaxBlocks; ++k)
    if (i == k) v = p[k];
  return v;
}
__device__ __forceinline__ int pick(const int (&r)[kMaxBlocks], int i) {
  int v = r[0];
#pragma unroll
  for (int k = 1; k < kMaxBlocks; ++k)
    if (i == k) v = r[k];
  return v;
}

// The tile's P_eff rows (16 a step, zero past a step's rows and past npos)
// into tile [16 ks + j][kLdp], by 16-byte cp.async (2-byte loads, stored
// as they arrive, when rows are not 16-byte aligned); threads < 128 copy
// one 16-byte chunk of each step. `fill`: any valid global address, the
// source of the zero-filled copies.
__device__ __forceinline__ void load_peff(bf16* tile, const Blocks& bl, const Steps& st, int b,
                                          int p0, int npos, const bf16* fill) {
  static_assert(16 * kBN / 8 <= kThreads, "one chunk a thread a step");
  if (threadIdx.x >= 16 * kBN / 8) return;
  const bool vec = (npos & 7) == 0;
  const int j = threadIdx.x / (kBN / 8), q = 8 * (threadIdx.x % (kBN / 8)), pos = p0 + q;
#pragma unroll
  for (int ks = 0; ks < kMaxSteps; ++ks) {
    if (ks < st.n) {
      const int blk = st.blk[ks];
      const bool ok = j < st.rows[ks] && pos < npos;
      const bf16* src = ok ? pick(bl.pd, blk) +
                                 (static_cast<size_t>(b) * pick(bl.r, blk) + st.lr0[ks] + j) *
                                     npos + pos
                           : fill;
      bf16* dst = tile + (16 * ks + j) * kLdp + q;
      if (vec) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          dst[k] = ok && pos + k < npos ? src[k] : __float2bfloat16(0.f);
      }
    }
  }
}

// a and the blocks' scales at the tile's positions as floats into
// as[(1 + kMaxBlocks)][kBN]: row 0 a (ones where a is null), row 1 + i block
// i's scale (ones where it has none); zeros past npos.
__device__ __forceinline__ void load_scales(float* as, const Blocks& bl, const bf16* a, int b,
                                            int p0, int npos) {
  for (int e = threadIdx.x; e < (1 + kMaxBlocks) * kBN; e += kThreads) {
    const int k = e / kBN, pos = p0 + e % kBN;
    const bf16* src = k == 0 ? a : (k - 1 < bl.n ? pick(bl.s, k - 1) : nullptr);
    float v = 0.f;
    if (pos < npos) v = src ? __bfloat162float(src[static_cast<size_t>(b) * npos + pos]) : 1.f;
    as[e] = v;
  }
}

// kBN rows of a shared (N, kD) projection from row p0 into rows [kBN][kLdv]
// by 16-byte cp.async, rows past npos zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int p0, int npos) {
  for (int e = threadIdx.x; e < kBN * (kD / 8); e += kThreads) {
    const int j = e / (kD / 8), c = 8 * (e % (kD / 8));
    const bool ok = p0 + j < npos;
    cp_async16(dst + j * kLdv + c, src + static_cast<size_t>(ok ? p0 + j : 0) * kD + c, ok);
  }
}

// The scores of token row g at positions 8 (nt0 + u) + 2t, + 1 of the
// tile, u < NT: (q sm^T) a + q cm^T, then each block's rank product times
// its scale, in block order. smt, cmt: the tile's rows of the shared
// projections ([kBN][kLdv], load_rows), read at head h as B fragments. The
// NT n8 tiles' products are issued side by side: their chains of mma are
// independent.
template <int NT>
__device__ __forceinline__ void tile_scores(float (&s)[NT][2], int nt0,
                                            const uint32_t (&qa)[2],
                                            const uint32_t (&t1)[kMaxSteps][2],
                                            const Steps& st, const bf16* ptile,
                                            const float* as, const bf16* smt, const bf16* cmt) {
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t a[4] = {qa[0], 0u, qa[1], 0u};
  float cs[NT][4], cc[NT][4], acc[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cs[u][e] = cc[u][e] = acc[u][e] = 0.f;
    const int o = (8 * (nt0 + u) + g) * kLdv + h * kHd + 2 * t;
    const uint32_t bs[2] = {lds32(smt + o), lds32(smt + o + 8)};
    const uint32_t bc[2] = {lds32(cmt + o), lds32(cmt + o + 8)};
    mma_bf16(cs[u], a, bs);
    mma_bf16(cc[u], a, bc);
  }
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int j = 8 * (nt0 + u) + 2 * t;
    s[u][0] = cs[u][0] * as[j] + cc[u][0];
    s[u][1] = cs[u][1] * as[j + 1] + cc[u][1];
  }
#pragma unroll
  for (int ks = 0; ks < kMaxSteps; ++ks) {
    if (ks < st.n) {
      uint32_t b[NT][2];
#pragma unroll
      for (int u = 0; u < NT; ++u)
        ldmatrix_x2_trans(b[u], ptile + (16 * ks + (lane & 15)) * kLdp + 8 * (nt0 + u));
      const uint32_t ar[4] = {t1[ks][0], 0u, t1[ks][1], 0u};
#pragma unroll
      for (int u = 0; u < NT; ++u) mma_bf16(acc[u], ar, b[u]);
      if (st.last[ks]) {
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const float* w = as + (1 + st.blk[ks]) * kBN + 8 * (nt0 + u) + 2 * t;
          s[u][0] += acc[u][0] * w[0];
          s[u][1] += acc[u][1] * w[1];
          acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- K4

// One block per (prompt, kBN positions), warp h = head h.
__global__ void __launch_bounds__(kThreads)
    i2t_bf16_kernel(const bf16* __restrict__ kt, const bf16* __restrict__ uq, Blocks bl,
                    Steps st, const bf16* __restrict__ a, const bf16* __restrict__ qs,
                    const bf16* __restrict__ qc, bf16* __restrict__ out, int t_tok, int npos,
                    int rtot) {
  extern __shared__ uint4 smem_u4[];
  bf16* qst = reinterpret_cast<bf16*>(smem_u4);                    // [2][kBN][kLdv] QS, QC
  bf16* ptile = qst + 2 * kBN * kLdv;                              // [16 st.n][kLdp]
  float* as = reinterpret_cast<float*>(ptile + 16 * st.n * kLdp);  // [1 + kMaxBlocks][kBN]
  bf16* ot = reinterpret_cast<bf16*>(as + (1 + kMaxBlocks) * kBN);  // [8 t_tok + 1][kLdp]

  const int h = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y, p0 = blockIdx.x * kBN;
  load_rows(qst, qs, p0, npos);
  load_rows(qst + kBN * kLdv, qc, p0, npos);
  load_peff(ptile, bl, st, b, p0, npos, qs);
  cp_async_commit();
  load_scales(as, bl, a, b, p0, npos);
  uint32_t qa[2];
  token_fragment(qa, kt + static_cast<size_t>(b) * t_tok * kD + h * kHd, t_tok);
  uint32_t t1[kMaxSteps][2];
  t1_fragments(t1, qa, uq ? uq + static_cast<size_t>(b) * rtot * kD + h * kHd : nullptr, st);
  cp_async_wait<0>();
  __syncthreads();

  const bool live = g < t_tok;
  constexpr int NT = 4;  // n8 tiles a step
  for (int nt0 = 0; nt0 < kBN / 8; nt0 += NT) {
    float s[NT][2];
    tile_scores<NT>(s, nt0, qa, t1, st, ptile, as, qst, qst + kBN * kLdv);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = live ? s[u][e] : -CUDART_INF_F;
        float m = x;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float ex = live ? __expf(x - m) : 0.f;  // token 0 is always live
        float sum = ex;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        p[e] = __fdividef(ex, sum);
      }
      if (live)
        *reinterpret_cast<uint32_t*>(ot + (h * t_tok + g) * kLdp + 8 * (nt0 + u) + 2 * t) =
            pack2(p[0], p[1]);
    }
  }
  const int ht = kHeads * t_tok;
  for (int j = threadIdx.x; j < kBN; j += kThreads) ot[ht * kLdp + j] = __float2bfloat16(1.f);
  __syncthreads();

  const bool vec = (npos & 7) == 0;
  bf16* ob = out + static_cast<size_t>(b) * (ht + 1) * npos;
  for (int e = threadIdx.x; e < (ht + 1) * (kBN / 8); e += kThreads) {
    const int row = e / (kBN / 8), q = 8 * (e % (kBN / 8)), pos = p0 + q;
    if (pos >= npos) continue;
    const bf16* src = ot + row * kLdp + q;
    bf16* dst = ob + static_cast<size_t>(row) * npos + pos;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && pos + k < npos; ++k) dst[k] = src[k];
    }
  }
}

// ----------------------------------------------------------------- K3
//
// Two passes over the positions, then the merge. A block is one warpgroup
// on one (prompt, chunk of position tiles). Its 64 rows are the 8 heads'
// token rows packed into wgmma's M: row 8h + tt, token tt < kRows of head h
// (tokens past T are dead rows, never stored), so warp w holds heads 2w
// (rows g) and 2w + 1 (rows g + 8) and lane (g, t) token g of both:
//  - head terms S = (q KS^T) a + q KC^T: per warp on mma.sync, its two
//    heads' channels of the KS and KC tiles (ldmatrix), the block-diagonal
//    q's zeros skipped (as wgmma over all 128 channels they cost 8x the
//    products and measured no faster);
//  - rank term, per block: T1_i Pd_i on wgmma over all 64 rows, A = T1 =
//    bf16(q U_K^T) in registers (formed once a block by mma.sync), B = the
//    P_eff tile [rank][position], MN-major (as the core's V); its fp32
//    product times the block's scale is added to S in block order;
//  - pass 2's T2_i = bf16(p s_i) Pd_i^T reads the same P_eff tile K-major
//    (positions as K), one m64n16 product a step of 16 ranks; the value part
//    bf16(p a) VS runs on mma.sync per warp over its two heads' 32
//    channels, B fragments by ldmatrix.trans from the swizzled VS tile.
// KS, KC and VS tiles (one box each: the two 64-channel parts as a third
// dim), P_eff (one box a block) and the scales arrive by TMA (128-byte
// swizzle; positions past N and ranks past a block read as zeros), each
// share issued by a lane of another warp, on one full mbarrier a stage;
// where N % 8 != 0 the P_eff rows and the scales are written by the
// threads instead (P_eff into the same swizzled layout). Pass 1 folds each
// tile into the rows' (max, sum of exp) once a tile (the tile's row max
// over the quad first) and stores the fp32 scores in the accumulator's own
// order, [tile][float4 v][thread], which pass 2 reads back with one bulk
// copy a tile into exactly the A fragments its threads take.
// Bound: each pass moves P_eff and the fp32 scores once (the bytes) but
// runs at about twice that on an H100: a warpgroup's chain of wgmma waits
// (one a block), exponentials and barriers is exposed with two blocks an
// SM (shared memory: two 53 KB stages; registers: 235-255), as clock64
// readings of each phase showed (PERF.md).

constexpr int kT2iChunks = 8;  // position chunks a prompt, one block each (as factored.cu)

struct T2iSplit {
  int chunks, per;  // chunks of `per` whole tiles, none empty
};
T2iSplit t2i_split(int npos) {
  const int tiles = (npos + kBN - 1) / kBN;
  const int per = (tiles + kT2iChunks - 1) / kT2iChunks;
  return {(tiles + per - 1) / per, per};
}

constexpr int kStatFloats = 2 * kHeads * kRows;  // a chunk's (m, l) of every token row
constexpr int kAccFloats = kHeads * kRows * kHd;  // a chunk's value part
// Floats of a (prompt, chunk) partial: the value part [(head, token)][kHd],
// then T2^T [head][padded rank][token].
__host__ __device__ constexpr int t2i_part_floats(int nsteps) {
  return kAccFloats + kHeads * 16 * nsteps * kRows;
}

// The positions of chunk blockIdx.x, and its tile count.
__device__ __forceinline__ int chunk_tiles(int npos, int per, int& c0) {
  c0 = blockIdx.x * per * kBN;
  const int c1 = min(npos, c0 + per * kBN);
  return (c1 - c0 + kBN - 1) / kBN;
}

constexpr int kWgThreads = 128;                // one warpgroup a block
constexpr int kRowBytes = kBN * 2;             // a P_eff row of a tile: one 128-byte swizzle row
constexpr int kTileBytes = kBN * kD * 2;       // a tile of KS, KC or VS: two 64-channel parts
constexpr int kStepBytes = 16 * kRowBytes;     // the 16 P_eff rows of a rank step
constexpr int kTileFloats = kHeads * kRows * kBN;  // a tile's stored scores
constexpr int kScaleElems = (1 + kMaxBlocks) * kBN;  // a tile's a and block scales, bf16
// Stages of the ring: two of 53 KB at rank 118 let two blocks share an SM
// (one block with four stages measured 1.5x slower)
constexpr int kStages = 2;

// The tensor maps of a call, in the 128-byte swizzle: KS, KC, VS (N, 128)
// with boxes of 64 positions x both 64-channel parts, P_eff block i (B, r_i,
// N) with boxes of 64 positions x its ranks padded to 16 (its rank steps);
// unswizzled, a (sc[0]) and block i's scale (sc[1 + i]), (B, N), with boxes
// of 64 positions. P_eff and the scales only where N % 8 == 0 (their rows
// 16-byte aligned); a null scale has no map.
struct T2iMaps {
  CUtensorMap ks, kc, vs;
  CUtensorMap pd[kMaxBlocks];
  CUtensorMap sc[1 + kMaxBlocks];
};

__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The P_eff rows of a tile by TMA, one box a block (its steps' rows),
// completing on bar.
__device__ __forceinline__ void peff_tma(unsigned char* dst, const T2iMaps& maps, const Blocks& bl,
                                         uint64_t* bar, int b, int p0) {
  int step = 0;
#pragma unroll
  for (int i = 0; i < kMaxBlocks; ++i) {
    if (i < bl.n && bl.r[i] > 0) {
      wg::tma_load_4d(dst + step * kStepBytes, &maps.pd[i], bar, p0, 0, b, 0);
      step += (bl.r[i] + 15) / 16;
    }
  }
}

// The same rows written by the threads where TMA cannot read them (N % 8 !=
// 0: rows not 16-byte aligned), by 2-byte loads, into TMA's swizzled layout
// (16-byte chunk c of row r at r * 128 + (c ^ r % 8) * 16); zeros past a
// step's rows and past npos. Thread (j, c) writes chunk c of row j of every
// step.
__device__ __forceinline__ void peff_threads(unsigned char* dst, const Blocks& bl, const Steps& st,
                                             int b, int p0, int npos) {
  static_assert(16 * (kBN / 8) == kWgThreads, "one chunk a thread a step");
  const int j = threadIdx.x / 8, c = threadIdx.x % 8, pos = p0 + 8 * c;
#pragma unroll
  for (int ks = 0; ks < kMaxSteps; ++ks) {
    if (ks < st.n) {
      const int blk = st.blk[ks];
      const bool ok = j < st.rows[ks];
      const auto* src = reinterpret_cast<const unsigned short*>(
          pick(bl.pd, blk) + (static_cast<size_t>(b) * pick(bl.r, blk) + st.lr0[ks] + j) * npos +
          pos);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = ok && pos + 2 * k < npos ? src[2 * k] : 0u;
        const uint32_t hi = ok && pos + 2 * k + 1 < npos ? src[2 * k + 1] : 0u;
        w[k] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(dst + ks * kStepBytes + j * kRowBytes + ((c ^ (j & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// a and the blocks' scales at a tile's positions, bf16 [1 + kMaxBlocks][kBN]:
// row 0 a, row 1 + i block i's scale; ones for a null one, zeros past npos.
__device__ __forceinline__ const bf16* scale_src(const Blocks& bl, const bf16* a, int k) {
  return k == 0 ? a : k - 1 < bl.n ? pick(bl.s, k - 1) : nullptr;
}
// The bytes of the rows that have a source (TMA loads them where N % 8 == 0).
__device__ __forceinline__ int scale_bytes(const Blocks& bl, const bf16* a) {
  int bytes = 0;
#pragma unroll
  for (int k = 0; k < 1 + kMaxBlocks; ++k)
    if (scale_src(bl, a, k)) bytes += kBN * 2;
  return bytes;
}
// Rows k0, k0 + dk, ... of them by TMA, completing on bar.
__device__ __forceinline__ void scales_tma(bf16* sc, const T2iMaps& maps, const Blocks& bl,
                                           const bf16* a, uint64_t* bar, int b, int p0, int k0,
                                           int dk) {
#pragma unroll
  for (int k = 0; k < 1 + kMaxBlocks; ++k)
    if ((k - k0) % dk == 0 && k >= k0 && scale_src(bl, a, k))
      wg::tma_load_4d(sc + k * kBN, &maps.sc[k], bar, p0, b, 0, 0);
}
// All threads: every row (TMA off), or only the ones of the null rows (once
// a stage, TMA on).
__device__ __forceinline__ void scales_threads(bf16* sc, const Blocks& bl, const bf16* a, int b,
                                               int p0, int npos, bool only_null) {
  for (int e = threadIdx.x; e < kScaleElems; e += kWgThreads) {
    const int k = e / kBN, pos = p0 + e % kBN;
    const bf16* src = scale_src(bl, a, k);
    if (src && only_null) continue;
    sc[e] = !src ? __float2bfloat16(1.f)
                 : pos < npos ? src[static_cast<size_t>(b) * npos + pos] : __float2bfloat16(0.f);
  }
}
// A scale row's values at positions pos, pos + 1 (pos even).
__device__ __forceinline__ float2 scale_pair(const bf16* row, int pos) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + pos);
  return make_float2(lo_of(w), hi_of(w));
}

// Warp w's words of q: token g of head 2w at its channels 2t, 2t + 8 (qf[0],
// qf[1]) and of head 2w + 1 (qf[2], qf[3]); zeros for a dead row.
__device__ __forceinline__ void head_pair_q(uint32_t (&qf)[4], const bf16* q, int b, int t_tok) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  qf[0] = qf[1] = qf[2] = qf[3] = 0u;
  if (g < t_tok) {
    const bf16* row = q + (static_cast<size_t>(b) * t_tok + g) * kD + 32 * warp + 2 * t;
#pragma unroll
    for (int k = 0; k < 4; ++k) qf[k] = ld32(row + 8 * k);
  }
}

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = q_h x^T for the warp's two heads over a staged 64-position tile x
// (KS or KC, [part][position][64 channels] swizzled) in the accumulator's
// order: per 8-position block j, one ldmatrix.x4 (the 8 positions' four
// 8-channel chunks of heads 2w, 2w + 1) and two m16n8k16, head 2w into rows
// g, head 2w + 1 into rows g + 8.
__device__ __forceinline__ void head_terms(float (&d)[32], const uint32_t (&qf)[4],
                                           const unsigned char* x) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r = lane % 8;
  const int c = 4 * warp + lane / 8;  // this lane's chunk
  const uint32_t alo[4] = {qf[0], 0u, qf[1], 0u}, ahi[4] = {0u, qf[2], 0u, qf[3]};
  // rows of a part are 64 channels, 128 bytes: the same width as a P_eff row
  const uint32_t base =
      wg::smem_u32(x + wg::part_offset(c / 8) + r * kRowBytes + (((c % 8) ^ r) << 4));
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    uint32_t v[4];
    ldmatrix_x4_at(v, base + j * 8 * kRowBytes);
    float(&c4)[4] = *reinterpret_cast<float(*)[4]>(d + 4 * j);
    c4[0] = c4[1] = c4[2] = c4[3] = 0.f;
    const uint32_t blo[2] = {v[0], v[1]}, bhi[2] = {v[2], v[3]};
    mma_bf16(c4, alo, blo);
    mma_bf16(c4, ahi, bhi);
  }
}

// T1 = bf16(q U_K^T) of the warp's two heads as the register A fragments of
// the rank term, one a step (16 ranks): two mma.sync a rank octet, head 2w's
// channels into rows g and head 2w + 1's into rows g + 8. ub: the prompt's
// U_K rows.
__device__ __forceinline__ void t1_pair_fragments(uint32_t (&t1)[kMaxSteps][4],
                                                  const uint32_t (&qf)[4], const bf16* ub,
                                                  const Steps& st) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const uint32_t alo[4] = {qf[0], 0u, qf[1], 0u}, ahi[4] = {0u, qf[2], 0u, qf[3]};
#pragma unroll
  for (int ks = 0; ks < kMaxSteps; ++ks) {
    t1[ks][0] = t1[ks][1] = t1[ks][2] = t1[ks][3] = 0u;
    if (ks < st.n) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * u + g;
        uint32_t b0[2] = {0u, 0u}, b1[2] = {0u, 0u};
        if (j < st.rows[ks]) {
          const bf16* row = ub + static_cast<size_t>(st.r0[ks] + j) * kD + 32 * warp + 2 * t;
          b0[0] = ld32(row);
          b0[1] = ld32(row + 8);
          b1[0] = ld32(row + 16);
          b1[1] = ld32(row + 24);
        }
        mma_bf16(c[u], alo, b0);
        mma_bf16(c[u], ahi, b1);
      }
      t1[ks][0] = pack2(c[0][0], c[0][1]);
      t1[ks][1] = pack2(c[0][2], c[0][3]);
      t1[ks][2] = pack2(c[1][0], c[1][1]);
      t1[ks][3] = pack2(c[1][2], c[1][3]);
    }
  }
}

// bf16(x * w) of a lane's 32 accumulator-ordered values (x[4j + e]: row g (e
// < 2) or g + 8, position 8j + 2t + (e & 1)) as the register A fragments of
// the four k16 steps over the tile's positions; w: the scale row, + 2t.
__device__ __forceinline__ void scaled_fragments(uint32_t (&f)[kBN / 16][4], const float (&x)[32],
                                                 const bf16* w) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const float2 w0 = scale_pair(w, 16 * kk), w1 = scale_pair(w, 16 * kk + 8);
    const float* v = x + 8 * kk;
    f[kk][0] = pack2(v[0] * w0.x, v[1] * w0.y);
    f[kk][1] = pack2(v[2] * w0.x, v[3] * w0.y);
    f[kk][2] = pack2(v[4] * w1.x, v[5] * w1.y);
    f[kk][3] = pack2(v[6] * w1.x, v[7] * w1.y);
  }
}

// A ring of kStages stages of stage_bytes (1 KB multiples), then their
// scales [kStages][kScaleElems] and one full mbarrier a stage.
size_t t2i_smem(size_t stage_bytes) {
  return kStages * (stage_bytes + sizeof(bf16) * kScaleElems + sizeof(uint64_t));
}

// Pass 1: each row's fp32 scores over the chunk, stored to the workspace,
// and the chunk's max and sum of exp of each row.
__global__ void __launch_bounds__(kWgThreads)
    t2i_scores_wgmma_kernel(const __grid_constant__ T2iMaps maps, const bf16* __restrict__ q,
                            const bf16* __restrict__ uk, Blocks bl, Steps st,
                            const bf16* __restrict__ a, float* __restrict__ scores,
                            float* __restrict__ stats, int t_tok, int npos, int rtot, int per,
                            int tma) {
  extern __shared__ __align__(1024) unsigned char t2i_smem_raw[];
  unsigned char* smem = wg::checked_base(t2i_smem_raw);
  const int stage_bytes = 2 * kTileBytes + st.n * kStepBytes;  // [KS | KC | P_eff]
  bf16* scl = reinterpret_cast<bf16*>(smem + kStages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(scl + kStages * kScaleElems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  int c0;
  const int ntiles = chunk_tiles(npos, per, c0);
  const bool live = g < t_tok;

  auto stage = [&](int it) {
    const int s = it % kStages, p0 = c0 + it * kBN;
    unsigned char* dst = smem + s * stage_bytes;
    // lane 0 of each warp issues a share of the loads: KS and KC; P_eff; the
    // scales, split over warps 2 and 3
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(&full[s], 2 * kTileBytes + (tma ? st.n * kStepBytes + scale_bytes(bl, a) : 0));
      wg::tma_load_4d(dst, &maps.ks, &full[s], 0, p0, 0, 0);
      wg::tma_load_4d(dst + kTileBytes, &maps.kc, &full[s], 0, p0, 0, 0);
    } else if (threadIdx.x == 32 && tma) {
      peff_tma(dst + 2 * kTileBytes, maps, bl, &full[s], b, p0);
    } else if (threadIdx.x % 32 == 0 && tma) {  // warps 2, 3
      scales_tma(scl + s * kScaleElems, maps, bl, a, &full[s], b, p0, threadIdx.x / 32 - 2, 2);
    }
    if (!tma) {
      peff_threads(dst + 2 * kTileBytes, bl, st, b, p0, npos);
      scales_threads(scl + s * kScaleElems, bl, a, b, p0, npos, false);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) wg::mbar_init(&full[s], 1);
    wg::mbar_fence_init();
  }
  if (tma)
    for (int s = 0; s < kStages; ++s) scales_threads(scl + s * kScaleElems, bl, a, b, 0, npos, true);
  __syncthreads();
  for (int it = 0; it < kStages - 1 && it < ntiles; ++it) stage(it);
  uint32_t qf[4];
  head_pair_q(qf, q, b, t_tok);
  uint32_t t1[kMaxSteps][4];
  t1_pair_fragments(t1, qf, uk + static_cast<size_t>(b) * rtot * kD, st);
  wg::fence_async_shared();
  __syncthreads();

  const int ntot = (npos + kBN - 1) / kBN;
  float* srec = scores + (static_cast<size_t>(b) * ntot + c0 / kBN) * kTileFloats + 4 * threadIdx.x;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    if (it + kStages - 1 < ntiles) stage(it + kStages - 1);
    const int s = it % kStages;
    const unsigned char* kst = smem + s * stage_bytes;
    const unsigned char* pt = kst + 2 * kTileBytes;
    const bf16* as = scl + s * kScaleElems + 2 * t;
    wg::mbar_wait(&full[s], (it / kStages) & 1);

    // head terms: S = (q KS^T) a + q KC^T on mma.sync, each warp its two
    // heads' channels (the block-diagonal q's other rows are zeros)
    float S[32], acc[32];
    head_terms(S, qf, kst);
    head_terms(acc, qf, kst + kTileBytes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 w = scale_pair(as, 8 * j);
      S[4 * j] = fmaf(S[4 * j], w.x, acc[4 * j]);
      S[4 * j + 1] = fmaf(S[4 * j + 1], w.y, acc[4 * j + 1]);
      S[4 * j + 2] = fmaf(S[4 * j + 2], w.x, acc[4 * j + 2]);
      S[4 * j + 3] = fmaf(S[4 * j + 3], w.y, acc[4 * j + 3]);
    }

    // rank term: each block's fp32 product times its scale, in block order
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kMaxSteps; ++ks) {
      if (ks < st.n) {  // a block's first step overwrites acc
        wg::wgmma_rs(acc, t1[ks], wg::make_desc<128>(pt + ks * kStepBytes), st.lr0[ks] > 0);
        if (st.last[ks]) {
          wg::wgmma_commit();
          wg::wgmma_wait0();
          wg::fence_regs(acc);
          const bf16* w = as + (1 + st.blk[ks]) * kBN;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 wv = scale_pair(w, 8 * j);
            S[4 * j] = fmaf(acc[4 * j], wv.x, S[4 * j]);
            S[4 * j + 1] = fmaf(acc[4 * j + 1], wv.y, S[4 * j + 1]);
            S[4 * j + 2] = fmaf(acc[4 * j + 2], wv.x, S[4 * j + 2]);
            S[4 * j + 3] = fmaf(acc[4 * j + 3], wv.y, S[4 * j + 3]);
          }
          wg::fence_regs(acc);
          wg::wgmma_fence();
        }
      }
    }

    // positions past npos out of the softmax; the live rows' scores stored
    const int nv = npos - (c0 + it * kBN);
    if (nv < kBN) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + 2 * t + (i & 1) >= nv) S[i] = -CUDART_INF_F;
    }
    if (live) {
      float4* dst = reinterpret_cast<float4*>(srec + static_cast<size_t>(it) * kTileFloats);
#pragma unroll
      for (int v = 0; v < 8; ++v)
        dst[v * kWgThreads] = make_float4(S[4 * v], S[4 * v + 1], S[4 * v + 2], S[4 * v + 3]);
    }
    // the rows' running max (over the quad, once a tile) and this lane's sum
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(S[4 * j], S[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(S[4 * j + 2], S[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum_lo += __expf(S[4 * j] - mn_lo) + __expf(S[4 * j + 1] - mn_lo);
      sum_hi += __expf(S[4 * j + 2] - mn_hi) + __expf(S[4 * j + 3] - mn_hi);
    }
    l_lo = l_lo * __expf(m_lo - mn_lo) + sum_lo;  // 0 at the first tile
    l_hi = l_hi * __expf(m_hi - mn_hi) + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
    wg::fence_async_shared();  // the threads' writes of a later stage, before the barrier
    __syncthreads();           // this stage is refilled next iteration
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  if (t == 0 && live) {
    float* dst = stats + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kStatFloats +
                 2 * (16 * warp + g);
    dst[0] = m_lo;
    dst[1] = l_lo;
    dst[2 * kRows] = m_hi;  // row 16w + 8 + g: head 2w + 1
    dst[2 * kRows + 1] = l_hi;
  }
}

// Pass 2: each row's max M and sum L over all positions from the chunks'
// statistics; per tile p = exp(s - M) / L from the stored scores (one bulk
// copy a tile), the value part bf16(p a) VS (per warp, its heads' channels)
// and T2_i += bf16(p s_i) Pd_i^T (wgmma, a step of 16 ranks at a time). The
// chunk's partial goes to part, in the layout t2i_merge_bf16_kernel reads.
__global__ void __launch_bounds__(kWgThreads)
    t2i_wgmma_kernel(const __grid_constant__ T2iMaps maps, const float* __restrict__ scores,
                     Blocks bl, Steps st, const bf16* __restrict__ a,
                     const float* __restrict__ stats, float* __restrict__ part, int t_tok,
                     int npos, int per, int tma) {
  extern __shared__ __align__(1024) unsigned char t2i_smem_raw[];
  unsigned char* smem = wg::checked_base(t2i_smem_raw);
  const int peff_bytes = st.n * kStepBytes;
  const int stage_bytes = kTileBytes + peff_bytes + kTileFloats * 4;  // [VS | P_eff | scores]
  bf16* scl = reinterpret_cast<bf16*>(smem + kStages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(scl + kStages * kScaleElems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  int c0;
  const int ntiles = chunk_tiles(npos, per, c0);
  const bool live = g < t_tok;
  const int ntot = (npos + kBN - 1) / kBN;
  const float* srec = scores + (static_cast<size_t>(b) * ntot + c0 / kBN) * kTileFloats;

  auto stage = [&](int it) {
    const int s = it % kStages, p0 = c0 + it * kBN;
    unsigned char* dst = smem + s * stage_bytes;
    // lane 0 of each warp issues a share of the loads: VS and the scores;
    // P_eff; the scales, split over warps 2 and 3
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(&full[s], kTileBytes + kTileFloats * 4 +
                                       (tma ? peff_bytes + scale_bytes(bl, a) : 0));
      wg::tma_load_4d(dst, &maps.vs, &full[s], 0, p0, 0, 0);
      wg::bulk_load(dst + kTileBytes + peff_bytes, srec + static_cast<size_t>(it) * kTileFloats,
                    kTileFloats * 4, &full[s]);
    } else if (threadIdx.x == 32 && tma) {
      peff_tma(dst + kTileBytes, maps, bl, &full[s], b, p0);
    } else if (threadIdx.x % 32 == 0 && tma) {  // warps 2, 3
      scales_tma(scl + s * kScaleElems, maps, bl, a, &full[s], b, p0, threadIdx.x / 32 - 2, 2);
    }
    if (!tma) {
      peff_threads(dst + kTileBytes, bl, st, b, p0, npos);
      scales_threads(scl + s * kScaleElems, bl, a, b, p0, npos, false);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) wg::mbar_init(&full[s], 1);
    wg::mbar_fence_init();
  }
  if (tma)
    for (int s = 0; s < kStages; ++s) scales_threads(scl + s * kScaleElems, bl, a, b, 0, npos, true);
  __syncthreads();
  for (int it = 0; it < kStages - 1 && it < ntiles; ++it) stage(it);

  // the rows' softmax over all N: M, L from the chunks' (m, l)
  float M_lo = 0.f, L_lo = 1.f, M_hi = 0.f, L_hi = 1.f;
  if (live) {
    const float* sr = stats + static_cast<size_t>(b) * gridDim.x * kStatFloats + 2 * (16 * warp + g);
    M_lo = M_hi = -CUDART_INF_F;
    for (int c = 0; c < gridDim.x; ++c) {
      M_lo = fmaxf(M_lo, sr[c * kStatFloats]);
      M_hi = fmaxf(M_hi, sr[c * kStatFloats + 2 * kRows]);
    }
    L_lo = L_hi = 0.f;
    for (int c = 0; c < gridDim.x; ++c) {
      L_lo += sr[c * kStatFloats + 1] * __expf(sr[c * kStatFloats] - M_lo);
      L_hi += sr[c * kStatFloats + 2 * kRows + 1] * __expf(sr[c * kStatFloats + 2 * kRows] - M_hi);
    }
  }
  // p = exp(s - M) / L as __fdividef computes it: exp times the approximate 1 / L
  const float R_lo = __fdividef(1.f, L_lo), R_hi = __fdividef(1.f, L_hi);
  wg::fence_async_shared();
  __syncthreads();

  float ov[4][4];  // the value part: n8 tiles of channels 32w + 8j (rows g: j < 2; g + 8: j >= 2)
#pragma unroll
  for (int j = 0; j < 4; ++j) ov[j][0] = ov[j][1] = ov[j][2] = ov[j][3] = 0.f;
  float t2[kMaxSteps][8];  // T2 of each rank step (m64n16)
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) t2[s][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + kStages - 1 < ntiles) stage(it + kStages - 1);
    const int s = it % kStages;
    const unsigned char* vt = smem + s * stage_bytes;
    const unsigned char* pt = vt + kTileBytes;
    const float4* sct = reinterpret_cast<const float4*>(pt + peff_bytes) + threadIdx.x;
    const bf16* as = scl + s * kScaleElems + 2 * t;
    wg::mbar_wait(&full[s], (it / kStages) & 1);
    float p[32];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float4 x = live ? sct[v * kWgThreads] : make_float4(0.f, 0.f, 0.f, 0.f);
      p[4 * v] = live ? __expf(x.x - M_lo) * R_lo : 0.f;
      p[4 * v + 1] = live ? __expf(x.y - M_lo) * R_lo : 0.f;
      p[4 * v + 2] = live ? __expf(x.z - M_hi) * R_hi : 0.f;
      p[4 * v + 3] = live ? __expf(x.w - M_hi) * R_hi : 0.f;
    }

    // value part: bf16(p a) x the VS tile at the warp's 32 channels
    uint32_t f[kBN / 16][4];
    scaled_fragments(f, p, as);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // matrices (positions 0-7, chunk c), (8-15, c), (0-7, c + 1), (8-15, c + 1)
        const int mat = lane / 8, r = lane % 8, c = 4 * warp + 2 * hh + (mat >> 1);
        const int pos = 16 * kk + 8 * (mat & 1) + r;
        uint32_t vb[4];
        ldmatrix_x4_trans_at(vb, wg::smem_u32(vt + wg::part_offset(c / 8) + pos * kRowBytes +
                                              (((c % 8) ^ r) << 4)));
        const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_bf16(ov[2 * hh], f[kk], b0);
        mma_bf16(ov[2 * hh + 1], f[kk], b1);
      }
    }

    // T2: pc_i = bf16(p s_i) against the P_eff tile read K-major
#pragma unroll
    for (int ks = 0; ks < kMaxSteps; ++ks) {
      if (ks < st.n) {
        if (st.lr0[ks] == 0) {  // a block's first step
          if (ks > 0) {          // the previous block's products read f
            wg::wgmma_commit();
            wg::wgmma_wait0();
          }
          scaled_fragments(f, p, as + (1 + st.blk[ks]) * kBN);
          wg::fence_regs(f);
          wg::wgmma_fence();
        }
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wg::wgmma_rs_kmajor(t2[ks], f[kk],
                              wg::make_desc<128>(pt + ks * kStepBytes + 32 * kk));
      }
    }
    wg::wgmma_commit();
    wg::wgmma_wait0();
#pragma unroll
    for (int s2 = 0; s2 < kMaxSteps; ++s2) wg::fence_regs(t2[s2]);
    wg::fence_regs(f);
    wg::fence_async_shared();
    __syncthreads();
  }

  float* rec = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * t2i_part_floats(st.n);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<float2*>(rec + (16 * warp + g) * kHd + 8 * j + 2 * t) =
        make_float2(ov[j][0], ov[j][1]);
    *reinterpret_cast<float2*>(rec + (16 * warp + 8 + g) * kHd + 8 * j + 2 * t) =
        make_float2(ov[2 + j][2], ov[2 + j][3]);
  }
  float* r2 = rec + kAccFloats;
#pragma unroll
  for (int ks = 0; ks < kMaxSteps; ++ks) {
    if (ks < st.n) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = 2 * warp + (e >> 1 & 1), rho = 16 * ks + 8 * (e >> 2) + 2 * t + (e & 1);
        r2[(h * 16 * st.n + rho) * kRows + g] = t2[ks][e];
      }
    }
  }
}

// One block per prompt: T2 = bf16(sum of the chunks' T2), out = bf16(sum
// of the chunks' value parts + T2 U_V) at the head-diagonal blocks.
__global__ void __launch_bounds__(kThreads)
    t2i_merge_bf16_kernel(const float* __restrict__ part, const bf16* __restrict__ uv, Steps st,
                          bf16* __restrict__ out, int t_tok, int rtot, int chunks) {
  extern __shared__ float4 smem_f4[];
  float* t2s = reinterpret_cast<float*>(smem_f4);  // [head][padded rank][token]
  const int b = blockIdx.x, rec = t2i_part_floats(st.n), n2 = kHeads * 16 * st.n * kRows;
  const float* pb = part + static_cast<size_t>(b) * chunks * rec;
  for (int e = threadIdx.x; e < n2; e += kThreads) {
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) sum += pb[c * rec + kAccFloats + e];
    t2s[e] = round_bf16(sum);
  }
  __syncthreads();
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my_t = lane / 4, my_c = 4 * (lane % 4), row = h * kRows + my_t;
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(pb + c * rec + row * kHd + my_c);
    o[0] += v.x;
    o[1] += v.y;
    o[2] += v.z;
    o[3] += v.w;
  }
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    for (int j = 0; s < st.n && j < st.rows[s]; ++j) {
      const float w = t2s[(h * 16 * st.n + 16 * s + j) * kRows + my_t];
      const uint2 u = *reinterpret_cast<const uint2*>(
          uv + (static_cast<size_t>(b) * rtot + st.r0[s] + j) * kD + h * kHd + my_c);
      o[0] = fmaf(w, lo_of(u.x), o[0]);
      o[1] = fmaf(w, hi_of(u.x), o[1]);
      o[2] = fmaf(w, lo_of(u.y), o[2]);
      o[3] = fmaf(w, hi_of(u.y), o[3]);
    }
  }
  if (my_t < t_tok)
    *reinterpret_cast<uint2*>(out + (static_cast<size_t>(b) * t_tok + my_t) * kD + h * kHd +
                              my_c) = make_uint2(pack2(o[0], o[1]), pack2(o[2], o[3]));
}

// ----------------------------------------------------------------- K2

constexpr int kLnC = 256;          // channels (the only C the kernel takes)
constexpr int kLnBM = 64;          // positions a block: 32 a warp row
constexpr int kLnThreads = 4 * kLnBM;  // warps: kLnBM / 32 along positions, four along channels
constexpr int kLnKC = 16;          // ranks a stage: one k16 step
constexpr int kLnStages = 3;       // stages of the cp.async ring
constexpr int kLnLdu = kLnC + 8;   // bf16 a staged U row
constexpr int kLnLdp = kLnBM + 8;  // bf16 a plane row
// The ring of U rows, raw P_eff rows and their scales, the hi / lo planes
// of two stages, and the cross-warp sums: 49 KB.
constexpr size_t kLnSmemBytes = sizeof(bf16) * kLnStages * kLnKC * (kLnLdu + 2 * kLnBM) +
                                sizeof(bf16) * 2 * 2 * kLnKC * kLnLdp +
                                sizeof(float) * 3 * 4 * kLnBM;
static_assert(kLnKC * kLnBM / 8 <= kLnThreads, "one P_eff chunk a thread a stage");

// One block per (prompt, kLnBM positions), warp (wm, wn) owns positions
// 32 wm.. (two m16 tiles) and channels 64 wn.. (eight n8 tiles).
__global__ void __launch_bounds__(kLnThreads, 512 / kLnThreads)
    ln_stats_bf16_kernel(Blocks bl, const bf16* __restrict__ uc, const bf16* __restrict__ smat,
                         const bf16* __restrict__ ms, const bf16* __restrict__ qs,
                         const bf16* __restrict__ a, float* __restrict__ out, int npos, int rtot,
                         float eps) {
  constexpr int NS = kLnStages, BM = kLnBM, KC = kLnKC;
  constexpr int kU = KC * kLnLdu, kP = KC * BM, kPlane = KC * kLnLdp;
  extern __shared__ uint4 smem_u4[];
  bf16* us = reinterpret_cast<bf16*>(smem_u4);  // [NS][KC][kLnLdu]
  bf16* pr = us + NS * kU;                      // [NS][KC][BM] raw rows
  bf16* sr = pr + NS * kP;                      // [NS][KC][BM] their scales
  bf16* planes = sr + NS * kP;                  // [2][hi, lo][KC][kLnLdp]
  float* red = reinterpret_cast<float*>(planes + 2 * 2 * kPlane);  // [4][BM][3]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
  const int b = blockIdx.y, n0 = blockIdx.x * BM;
  const int nst = (rtot + KC - 1) / KC;
  const bf16* ub = uc + static_cast<size_t>(b) * rtot * kLnC;

  // this thread's P_eff chunk (threads < KC * BM / 8): rank KC s + prr,
  // positions ppos..ppos + 7
  const bool owner = threadIdx.x < KC * BM / 8;
  const int prr = threadIdx.x / (BM / 8), pq = 8 * (threadIdx.x % (BM / 8));
  const int ppos = n0 + pq, chunk = prr * BM + pq;
  const bool vec = (npos & 7) == 0;
  auto issue = [&](int s) {
    bf16* ud = us + (s % NS) * kU;
    for (int e = threadIdx.x; e < KC * kLnC / 8; e += kLnThreads) {
      const int rr = e / (kLnC / 8), c = 8 * (e % (kLnC / 8)), r = KC * s + rr;
      cp_async16(ud + rr * kLnLdu + c, ub + static_cast<size_t>(r < rtot ? r : 0) * kLnC + c,
                 r < rtot);
    }
    if (!owner) return;
    const int r = KC * s + prr;
    const bf16* row = nullptr;
    const bf16* sc = nullptr;
    if (r < rtot && ppos < npos) {
      int off = 0;
#pragma unroll
      for (int i = 0; i < kMaxBlocks; ++i) {
        if (!row && i < bl.n && r < off + bl.r[i]) {
          row = bl.pd[i] + (static_cast<size_t>(b) * bl.r[i] + (r - off)) * npos + ppos;
          if (bl.s[i]) sc = bl.s[i] + static_cast<size_t>(b) * npos + ppos;
        }
        off += bl.r[i];
      }
    }
    bf16* pd = pr + (s % NS) * kP + chunk;
    bf16* sd = sr + (s % NS) * kP + chunk;
    if (vec) {
      cp_async16(pd, row ? row : ub, row != nullptr);
      if (sc)
        cp_async16(sd, sc, true);
      else
        *reinterpret_cast<uint4*>(sd) = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                                                   0x3f803f80u);  // bf16 ones
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = row && ppos + k < npos;
        pd[k] = ok ? row[k] : __float2bfloat16(0.f);
        sd[k] = ok && sc ? sc[k] : __float2bfloat16(1.f);
      }
    }
  };
  // the stage's chunk, landed: tilde = pd * s in fp32 (exact), split into
  // hi = bf16(tilde) and lo = bf16(tilde - hi) (exact: tilde has 16
  // significant bits)
  auto split = [&](int s) {
    if (!owner) return;
    const uint4 x = *reinterpret_cast<const uint4*>(pr + (s % NS) * kP + chunk);
    const uint4 w = *reinterpret_cast<const uint4*>(sr + (s % NS) * kP + chunk);
    const uint32_t xv[4] = {x.x, x.y, x.z, x.w}, wv[4] = {w.x, w.y, w.z, w.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t0 = lo_of(xv[k]) * lo_of(wv[k]), t1 = hi_of(xv[k]) * hi_of(wv[k]);
      hi[k] = pack2(t0, t1);
      lo[k] = pack2(t0 - lo_of(hi[k]), t1 - hi_of(hi[k]));
    }
    bf16* dst = planes + (s & 1) * 2 * kPlane + prr * kLnLdp + pq;
    *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + kPlane) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  };
  // whether stage s holds a row of a scaled block (else lo is 0)
  auto scaled = [&](int s) {
    bool any = false;
    int off = 0;
#pragma unroll
    for (int i = 0; i < kMaxBlocks; ++i) {
      if (i < bl.n && bl.s[i] && off < KC * (s + 1) && off + bl.r[i] > KC * s) any = true;
      off += bl.r[i];
    }
    return any;
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is computed
    split(s);
    if (s + NS - 1 < nst) issue(s + NS - 1);
    cp_async_commit();
    __syncthreads();  // the planes of stage s are in place
    const bf16* pl = planes + (s & 1) * 2 * kPlane;
    const bf16* ust = us + (s % NS) * kU;
    const bool two = scaled(s);
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4_trans(ah[mt], pl + 32 * wm + 16 * mt, kLnLdp);
      if (two) ldmatrix_x4_trans(al[mt], pl + kPlane + 32 * wm + 16 * mt, kLnLdp);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bb[2];
      ldmatrix_x2_trans(bb, ust + (lane & 15) * kLnLdu + 64 * wn + 8 * nt);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (two) mma_bf16(acc[mt][nt], al[mt], bb);
        mma_bf16(acc[mt][nt], ah[mt], bb);
      }
    }
  }

  // the channel sums of x_l, S x_l and x_l^2: quad shuffles, then across
  // the four channel warps in shared memory
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int lp = 32 * wm + 16 * mt + 8 * hh + g, pos = n0 + lp;
      float sum = 0.f, cross = 0.f, sq = 0.f;
      if (pos < npos) {
        const bf16* srow = smat + static_cast<size_t>(pos) * kLnC + 64 * wn + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t sw = ld32(srow + 8 * nt);
          const float x0 = acc[mt][nt][2 * hh], x1 = acc[mt][nt][2 * hh + 1];
          sum += x0 + x1;
          cross = fmaf(lo_of(sw), x0, fmaf(hi_of(sw), x1, cross));
          sq = fmaf(x0, x0, fmaf(x1, x1, sq));
        }
      }
      sum = quad_sum(sum);
      cross = quad_sum(cross);
      sq = quad_sum(sq);
      if (t == 0) {
        float* r = red + 3 * (wn * BM + lp);
        r[0] = sum;
        r[1] = cross;
        r[2] = sq;
      }
    }
  }
  __syncthreads();
  for (int lp = threadIdx.x; lp < BM; lp += kLnThreads) {
    const int pos = n0 + lp;
    if (pos >= npos) continue;
    float sum = 0.f, cross = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* r = red + 3 * (w * BM + lp);
      sum += r[0];
      cross += r[1];
      sq += r[2];
    }
    const float mu_d = sum / kLnC, cr = cross / kLnC, d2 = sq / kLnC;
    const float mS = __bfloat162float(ms[pos]), qS = __bfloat162float(qs[pos]);
    float mu, e2;
    if (a) {
      const float av = __bfloat162float(a[static_cast<size_t>(b) * npos + pos]);
      mu = av * mS + mu_d;
      e2 = av * av * qS + 2.f * av * cr + d2;
    } else {
      mu = mS + mu_d;
      e2 = qS + 2.f * cr + d2;
    }
    out[static_cast<size_t>(b) * 2 * npos + pos] = mu;
    out[(static_cast<size_t>(b) * 2 + 1) * npos + pos] = 1.f / sqrtf(e2 - mu * mu + eps);
  }
}

// ------------------------------------------------------------- host side

Blocks make_blocks(const void* const* pd, const void* const* s, const int* r, int nblocks) {
  Blocks bl;
  for (int i = 0; i < kMaxBlocks; ++i) {
    bl.pd[i] = i < nblocks ? static_cast<const bf16*>(pd[i]) : nullptr;
    bl.s[i] = i < nblocks ? static_cast<const bf16*>(s[i]) : nullptr;
    bl.r[i] = i < nblocks ? r[i] : 0;
  }
  bl.n = nblocks;
  return bl;
}

bool blocks_ok(const int* r, int nblocks, int rtot, int max_rank) {
  if (nblocks < 0 || nblocks > kMaxBlocks || rtot > max_rank) return false;
  int sum = 0;
  for (int i = 0; i < nblocks; ++i) {
    if (r[i] < 0) return false;
    sum += r[i];
  }
  return sum == rtot;
}

// Each block's rows in steps of 16; at most kMaxSteps for rtot <= kMaxRank.
Steps make_steps(const int* r, int nblocks) {
  Steps st{};
  int off = 0;
  for (int i = 0; i < nblocks; ++i) {
    for (int j0 = 0; j0 < r[i]; j0 += 16) {
      st.blk[st.n] = static_cast<int8_t>(i);
      st.rows[st.n] = static_cast<int8_t>(r[i] - j0 < 16 ? r[i] - j0 : 16);
      st.last[st.n] = j0 + 16 >= r[i];
      st.lr0[st.n] = static_cast<int16_t>(j0);
      st.r0[st.n] = static_cast<int16_t>(off + j0);
      ++st.n;
    }
    off += r[i];
  }
  return st;
}

size_t peff_tile_bytes(const Steps& st) { return sizeof(bf16) * 16 * st.n * kLdp; }
constexpr size_t kScaleBytes = sizeof(float) * (1 + kMaxBlocks) * kBN;
constexpr size_t kRowsBytes = sizeof(bf16) * kBN * kLdv;  // a tile of KS, KC, VS, QS or QC

// A bf16 array of dims {d0, d1, d2} (d0 contiguous; strides s1, s2 in
// bytes, in any order) as a 4-D tensor map (a last dim of 1) with boxes {b0,
// b1, b2, 1}, in the 128-byte swizzle (b0 * 2 bytes = 128) or unswizzled;
// elements past the dims read as zeros. TMA takes a 16-byte aligned base and
// strides: anything else, or a map cuTensorMapEncodeTiled refuses, returns
// cudaErrorInvalidValue.
int encode_map(CUtensorMap& map, const void* base, const cuuint64_t (&d)[3], cuuint64_t s1,
               cuuint64_t s2, const cuuint32_t (&box3)[3], bool swizzle = true) {
  const wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 || s1 % 16 || s2 % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {d[0], d[1], d[2], 1};
  const cuuint64_t strides[3] = {s1, s2, s1 * d[1] > s2 * d[2] ? s1 * d[1] : s2 * d[2]};
  const cuuint32_t box[4] = {box3[0], box3[1], box3[2], 1}, elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// The bf16 entry of factored_ln_stats. blocks: nblocks (<= 4)
// descriptors: pd[i] (b, r[i], n), s[i] (b, n) or null, sum(r) == rtot;
// uc: (b, rtot, c); smat: (n, c); ms, qs: (n,) the channel means of S and
// of bf16(S * S), rounded to bf16; a: (b, n) or null; all bf16. out: (b, 2,
// n) float32 = (mean, 1/sqrt(var + eps)) over the c channels of x = a * S +
// P_eff^T uc. c must be 256; every pointer 16-byte aligned.
int sam6d_factored_ln_stats_bf16(const void* const* pd, const void* const* s, const int* r,
                                 int nblocks, const void* uc, const void* smat, const void* ms,
                                 const void* qs, const void* a, float* out, int b, int n, int c,
                                 int rtot, float eps, cudaStream_t stream) {
  if (!blocks_ok(r, nblocks, rtot, 1 << 20) || nblocks < 1 || rtot < 1 || c != kLnC)
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl = make_blocks(pd, s, r, nblocks);
  const int err = set_smem(reinterpret_cast<const void*>(ln_stats_bf16_kernel), kLnSmemBytes);
  if (err) return err;
  const dim3 grid((n + kLnBM - 1) / kLnBM, b);
  ln_stats_bf16_kernel<<<grid, kLnThreads, kLnSmemBytes, stream>>>(
      bl, static_cast<const bf16*>(uc), static_cast<const bf16*>(smat),
      static_cast<const bf16*>(ms), static_cast<const bf16*>(qs), static_cast<const bf16*>(a),
      out, n, rtot, eps);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the workspace sam6d_factored_t2i_attention_bf16 takes for each
// prompt: the statistics and the partial of every position chunk, and the
// fp32 scores of every position tile (64 rows x 64 positions).
int sam6d_factored_t2i_bf16_workspace(const int* r, int nblocks, int n) {
  const Steps st = make_steps(r, nblocks);
  return t2i_split(n).chunks * (kStatFloats + t2i_part_floats(st.n)) +
         (n + kBN - 1) / kBN * kTileFloats;
}

// The bf16 entry of factored_t2i_attention. q: (b, t, 128) pre-scaled
// token queries, 8 heads of 16; uk, uv: (b, rtot, 128); a: (b, n); ks, kc,
// vs: (n, 128); all bf16. ws: b * sam6d_factored_t2i_bf16_workspace floats
// of scratch. out: (b, t, 128) bf16, head h's attention output at channels
// h*16 (the head-diagonal blocks), without the value bias. t <= 8,
// 1 <= rtot <= 128, every pointer 16-byte aligned. Three launches: the
// chunks' scores and softmax statistics, their partials, the merge.
int sam6d_factored_t2i_attention_bf16(const void* q, const void* uk, const void* uv,
                                      const void* const* pd, const void* const* s, const int* r,
                                      int nblocks, const void* a, const void* ks,
                                      const void* kc, const void* vs, float* ws, void* out,
                                      int b, int t, int n, int rtot, cudaStream_t stream) {
  if (!blocks_ok(r, nblocks, rtot, kMaxRank) || rtot < 1 || t < 1 || t > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl = make_blocks(pd, s, r, nblocks);
  const Steps st = make_steps(r, nblocks);
  const T2iSplit sp = t2i_split(n);
  T2iMaps maps;
  memset(&maps, 0, sizeof(maps));
  const cuuint64_t row = sizeof(bf16) * kD;
  int err = 0;
  // a tile's two 64-channel parts as a third dim: one box lands [part][row][64]
  for (auto [map, src] : {std::pair{&maps.ks, ks}, std::pair{&maps.kc, kc}, std::pair{&maps.vs, vs}})
    if ((err = encode_map(*map, src, {64, static_cast<cuuint64_t>(n), 2}, row, row / 2,
                          {64, kBN, 2})))
      return err;
  // P_eff and the scales by TMA where their rows are 16-byte aligned, else
  // by the threads
  const cuuint64_t prow = sizeof(bf16) * static_cast<cuuint64_t>(n);
  const void* srcs[1 + kMaxBlocks] = {a, nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < nblocks; ++i) srcs[1 + i] = s[i];
  bool tma = n % 8 == 0;
  for (int i = 0; i < nblocks; ++i) tma = tma && reinterpret_cast<uintptr_t>(pd[i]) % 16 == 0;
  for (const void* p : srcs) tma = tma && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; tma && i < nblocks; ++i)
    if (r[i] > 0 &&
        (err = encode_map(maps.pd[i], pd[i],
                          {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(r[i]),
                           static_cast<cuuint64_t>(b)},
                          prow, prow * r[i], {kBN, static_cast<cuuint32_t>(16 * ((r[i] + 15) / 16)), 1})))
      return err;
  for (int k = 0; tma && k < 1 + kMaxBlocks; ++k)
    if (srcs[k] && (err = encode_map(maps.sc[k], srcs[k],
                                     {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(b), 1},
                                     prow, prow * b, {kBN, 1, 1}, false)))
      return err;
  const auto* a16 = static_cast<const bf16*>(a);
  float* stats = ws;
  float* part = ws + static_cast<size_t>(b) * sp.chunks * kStatFloats;
  float* scores = part + static_cast<size_t>(b) * sp.chunks * t2i_part_floats(st.n);
  const dim3 grid(sp.chunks, b);

  const size_t stage1 = 2 * kTileBytes + st.n * kStepBytes;
  const size_t b1 = t2i_smem(stage1);
  if ((err = set_smem(reinterpret_cast<const void*>(t2i_scores_wgmma_kernel), b1))) return err;
  t2i_scores_wgmma_kernel<<<grid, kWgThreads, b1, stream>>>(
      maps, static_cast<const bf16*>(q), static_cast<const bf16*>(uk), bl, st, a16, scores, stats,
      t, n, rtot, sp.per, tma);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const size_t stage2 = kTileBytes + st.n * kStepBytes + sizeof(float) * kTileFloats;
  const size_t b2 = t2i_smem(stage2);
  if ((err = set_smem(reinterpret_cast<const void*>(t2i_wgmma_kernel), b2))) return err;
  t2i_wgmma_kernel<<<grid, kWgThreads, b2, stream>>>(maps, scores, bl, st, a16, stats, part, t, n,
                                                     sp.per, tma);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const size_t b3 = sizeof(float) * kHeads * 16 * st.n * kRows;
  t2i_merge_bf16_kernel<<<b, kThreads, b3, stream>>>(
      part, static_cast<const bf16*>(uv), st, static_cast<bf16*>(out), t, rtot, sp.chunks);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 entry of factored_i2t_scores. kt: (b, t, 128) token keys, 8
// heads of 16; uq: (b, rtot, 128) or null when rtot == 0; a: (b, n) or
// null; qs, qc: (n, 128); all bf16. out: (b, 8t + 1, n) bf16: row h*t + tt
// is the softmax over head h's t tokens at every position, the last row is
// ones. t <= 8, rtot <= 128, every pointer 16-byte aligned.
int sam6d_factored_i2t_scores_bf16(const void* kt, const void* uq, const void* const* pd,
                                   const void* const* s, const int* r, int nblocks,
                                   const void* a, const void* qs, const void* qc, void* out,
                                   int b, int t, int n, int rtot, cudaStream_t stream) {
  if (!blocks_ok(r, nblocks, rtot, kMaxRank) || t < 1 || t > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl = make_blocks(pd, s, r, nblocks);
  const Steps st = make_steps(r, nblocks);
  const size_t bytes = 2 * kRowsBytes + peff_tile_bytes(st) + kScaleBytes +
                       sizeof(bf16) * (kHeads * t + 1) * kLdp;
  const int err = set_smem(reinterpret_cast<const void*>(i2t_bf16_kernel), bytes);
  if (err) return err;
  const dim3 grid((n + kBN - 1) / kBN, b);
  i2t_bf16_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(kt), static_cast<const bf16*>(uq), bl, st,
      static_cast<const bf16*>(a), static_cast<const bf16*>(qs), static_cast<const bf16*>(qc),
      static_cast<bf16*>(out), t, n, rtot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
