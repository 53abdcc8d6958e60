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
// accumulation, which is what wgmma and mma.sync.m16n8k16 do with bf16
// operands, in one pass; the roundings are the JAX kernels':
//  - K4: t_i = bf16(U_Q,i k^T); fp32 scores (k QS^T) a + k QC^T +
//    sum_i (t_i Pd_i) s_i, each block's scale applied to its fp32 product;
//    fp32 softmax over each head's T tokens; bf16 out, a last row of ones;
//  - K3: t1 = bf16(q U_K^T); fp32 scores as K4's over the N positions; the
//    fp32 softmax normalised over all N, then pa = bf16(p a) times VS and
//    pc_i = bf16(p s_i) times Pd_i^T; t2 = bf16(the fp32 sums) times U_V;
//    bf16 out;
//  - K2: fp32 arithmetic on the bf16 values: x_l = sum_i s_i (Pd_i^T U_i)
//    (each block's fp32 product times its scale: JAX's statistics, which
//    it forms from U's gram matrix, in another fp32 order), mu = a mS + mean(x_l),
//    E[x^2] = a^2 qS + 2 a mean(S x_l) + mean(x_l^2) with the caller's bf16
//    mS, qS; fp32 (mu, 1/sigma) out.
//
// Shapes on the main path (ViT-H SAM, 128-prompt chunks): B = 128,
// N = 4096, C = 256, d = 128 as 8 heads of 16, T = 7 tokens, blocks of 57
// (softmax) and 2 (LayerNorm) rows: ranks 57 / 116 (K2), 59 / 118 (K3),
// 0 / 59 (K4).
//
// Designs (all on wgmma, bf16_wgmma.cuh, with operands by TMA where N % 8
// == 0; each section says more):
//  - K3 and K4 share one layout: one warpgroup per (prompt, chunk of 64-
//    position tiles), the 8 heads' token rows packed into wgmma's 64 rows
//    (row 8h + token). A tile's fp32 scores (`stage_scores`: head terms on
//    mma.sync, the rank term on wgmma against the P_eff tile) are the same
//    in both.
//  - K3: the normalised p is rounded (JAX's order), so it takes two passes
//    over the positions. t2i_scores_wgmma_kernel stores each tile's scores
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
//  - K4 (i2t_wgmma_kernel): K3's pass 1 whose tiles end in the softmax over
//    each head's tokens (through shared memory, one thread a head at four
//    positions) instead of a store of the scores; the bf16 probabilities
//    are staged in the output's row order and leave by one TMA store a
//    tile.
//  - K2 (ln_stats_wgmma_kernel): x_l = P_eff^T U, a 64-position x 256-
//    channel tile, on wgmma m64n256k16 with both operands MN-major from
//    shared memory: A the P_eff rows of a 16-rank step, B the prompt's U,
//    loaded once a block (or streamed with the P_eff rows where it does not
//    fit). The first scaled block's product is scaled per position after
//    the product instead of splitting its scaled rows into bf16 hi + lo
//    (one product a step, no split pass); the channel sums of x_l, S x_l
//    and x_l^2 come out of the accumulator against a TMA-staged S tile.
//    Producer warps keep the loads in flight; two consumer warpgroups take
//    alternate tiles, so one's epilogue runs beside the other's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>
#include <cstring>
#include <utility>

#include "bf16_attention.cuh"
#include "bf16_wgmma.cuh"  // wgmma, TMA, mbarriers

namespace {

using sam6d::quad_max;
using sam6d::quad_sum;
using sam6d::bf16attn::bf16;
using sam6d::bf16attn::hi_of;
using sam6d::bf16attn::lo_of;
using sam6d::bf16attn::mma_bf16;
using sam6d::bf16attn::pack2;
using sam6d::bf16attn::round_bf16;
namespace wg = sam6d::wgattn;

constexpr int kMaxBlocks = 4;
constexpr int kThreads = 256;
constexpr int kHeads = 8;             // K3 / K4: heads of kHd channels
constexpr int kHd = 16;               // channels per head
constexpr int kD = kHeads * kHd;      // attention channels
constexpr int kRows = 8;              // tokens per head at most
constexpr int kMaxRank = 128;
// k16 steps of the ranks with each block's rows padded to 16: at most
// sum ceil(r_i / 16) <= (kMaxRank + 15 kMaxBlocks) / 16 = 11
constexpr int kMaxSteps = (kMaxRank + 15 * kMaxBlocks) / 16;
constexpr int kBN = 64;               // positions a tile (K3, K4)

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

// The loads of stage `dst` of a pass-1 ring (K3's first pass, K4): the
// head-term tiles (KS and KC, or QS and QC) by TMA; P_eff and the scales by
// TMA or, where N % 8 != 0, by the threads, completing on `full`. Lane 0 of
// each warp issues a share: the two tiles; P_eff; the scales, split over
// warps 2 and 3.
__device__ __forceinline__ void scores_stage(unsigned char* dst, bf16* scl, uint64_t* full,
                                             const T2iMaps& maps, const Blocks& bl,
                                             const Steps& st, const bf16* a, int b, int p0,
                                             int npos, int tma) {
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(full, 2 * kTileBytes + (tma ? st.n * kStepBytes + scale_bytes(bl, a) : 0));
    wg::tma_load_4d(dst, &maps.ks, full, 0, p0, 0, 0);
    wg::tma_load_4d(dst + kTileBytes, &maps.kc, full, 0, p0, 0, 0);
  } else if (threadIdx.x == 32 && tma) {
    peff_tma(dst + 2 * kTileBytes, maps, bl, full, b, p0);
  } else if (threadIdx.x % 32 == 0 && tma) {  // warps 2, 3
    scales_tma(scl, maps, bl, a, full, b, p0, threadIdx.x / 32 - 2, 2);
  }
  if (!tma) {
    peff_threads(dst + 2 * kTileBytes, bl, st, b, p0, npos);
    scales_threads(scl, bl, a, b, p0, npos, false);
  }
}

// The fp32 scores of a landed pass-1 stage kst ([head-term tile 0 | tile 1
// | P_eff]) in the accumulator's layout: the head terms S = (q KS^T) a + q
// KC^T on mma.sync, each warp its two heads' channels (the block-diagonal
// q's other rows are zeros), then the rank term, each block's fp32 product
// on wgmma times its scale, in block order. as: the stage's scales + 2t.
__device__ __forceinline__ void stage_scores(float (&S)[32], const uint32_t (&qf)[4],
                                             const uint32_t (&t1)[kMaxSteps][4], const Steps& st,
                                             const unsigned char* kst, const bf16* as) {
  const unsigned char* pt = kst + 2 * kTileBytes;
  float acc[32];
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
    const int s = it % kStages;
    scores_stage(smem + s * stage_bytes, scl + s * kScaleElems, &full[s], maps, bl, st, a, b,
                 c0 + it * kBN, npos, tma);
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
    wg::mbar_wait(&full[s], (it / kStages) & 1);
    float S[32];
    stage_scores(S, qf, t1, st, smem + s * stage_bytes, scl + s * kScaleElems + 2 * t);

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

// ----------------------------------------------------------------- K4
//
// K3's first pass with another end to each tile: the same blocks (one
// warpgroup a (prompt, chunk of 64-position tiles)), rows (8h + token),
// ring and scores (`scores_stage`, `stage_scores`; QS and QC take KS's and
// KC's places, a null a reads as ones), then the fp32 softmax over each
// head's tokens at every position. The scores go through shared memory
// (over the stage's QS and QC tiles, once the products have read them), so
// that each thread takes one head at four positions (dead rows, tokens past
// T, never read). Done in the accumulator's layout instead, as shuffle
// reductions over the lanes g that hold a head's tokens, the softmax took
// 2.7x the time of the rest of the kernel, and as a shuffle transpose of
// each head's 8 x 8 (token, position) blocks it measured 12% slower than
// through shared memory (PERF.md). The bf16 probabilities are staged in the
// output's row order (row h T + token, one 128-byte row of 64 positions
// each, in the 128-byte swizzle; the last row ones, written once) and leave
// by one TMA store a tile (clipped at N), two staged tiles in turn so that a
// tile's store runs beside the next tile's products; where N % 8 != 0 the
// threads store them (2-byte stores). Rank 0 (layer 1: no blocks) runs the
// same pipeline with no rank term. Two prompts a block, sharing each
// stage's QS and QC tiles, measured no faster.

// The tensor maps of a call: K3's (QS, QC in the places of KS, KC; no VS)
// and the output (B, 8T + 1, N) with boxes of 64 positions x all its rows.
struct I2tMaps {
  T2iMaps in;
  CUtensorMap out;
};

// A row of a tile's fp32 scores staged for the softmax: 64 positions and a
// pad that keeps the warps' float2 stores and float4 loads at their fewest
// wavefronts.
constexpr int kSxLd = kBN + 8;
static_assert(kRows * kHeads * kSxLd * 4 <= 2 * kTileBytes, "the scores fit a stage's tiles");

// Bytes of a staged output tile of 8T + 1 rows, rounded to the 1 KB of the
// swizzle atom.
__host__ __device__ constexpr int i2t_out_tile_bytes(int t_tok) {
  return ((kHeads * t_tok + 1) * kRowBytes + 1023) & ~1023;
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(0), "r"(wg::smem_u32(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the bulk stores issued by this thread have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kWgThreads)
    i2t_wgmma_kernel(const __grid_constant__ I2tMaps maps, const bf16* __restrict__ kt,
                     const bf16* __restrict__ uq, Blocks bl, Steps st, const bf16* __restrict__ a,
                     bf16* __restrict__ out, int t_tok, int npos, int rtot, int per, int tma) {
  extern __shared__ __align__(1024) unsigned char t2i_smem_raw[];
  unsigned char* smem = wg::checked_base(t2i_smem_raw);
  const int stage_bytes = 2 * kTileBytes + st.n * kStepBytes;  // [QS | QC | P_eff]
  const int ht = kHeads * t_tok, ot_bytes = i2t_out_tile_bytes(t_tok);
  unsigned char* ot = smem + kStages * stage_bytes;  // [2][ht + 1 rows of 128 bytes]
  bf16* scl = reinterpret_cast<bf16*>(ot + 2 * ot_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(scl + kStages * kScaleElems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  int c0;
  const int ntiles = chunk_tiles(npos, per, c0);

  auto stage = [&](int it) {
    const int s = it % kStages;
    scores_stage(smem + s * stage_bytes, scl + s * kScaleElems, &full[s], maps.in, bl, st, a, b,
                 c0 + it * kBN, npos, tma);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) wg::mbar_init(&full[s], 1);
    wg::mbar_fence_init();
  }
  if (tma)
    for (int s = 0; s < kStages; ++s) scales_threads(scl + s * kScaleElems, bl, a, b, 0, npos, true);
  if (threadIdx.x < 2 * 8)  // the ones row of both staged tiles
    *reinterpret_cast<uint4*>(ot + threadIdx.x / 8 * ot_bytes + ht * kRowBytes +
                              16 * (threadIdx.x % 8)) =
        make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
  __syncthreads();
  for (int it = 0; it < kStages - 1 && it < ntiles; ++it) stage(it);
  uint32_t qf[4];
  head_pair_q(qf, kt, b, t_tok);
  uint32_t t1[kMaxSteps][4];
  t1_pair_fragments(t1, qf, uq + static_cast<size_t>(b) * rtot * kD, st);  // uq: null at rank 0
  wg::fence_async_shared();
  __syncthreads();

  bf16* ob = out + static_cast<size_t>(b) * (ht + 1) * npos;
  for (int it = 0; it < ntiles; ++it) {
    if (it + kStages - 1 < ntiles) stage(it + kStages - 1);
    const int s = it % kStages, p0 = c0 + it * kBN;
    wg::mbar_wait(&full[s], (it / kStages) & 1);
    float S[32];
    stage_scores(S, qf, t1, st, smem + s * stage_bytes, scl + s * kScaleElems + 2 * t);

    // the scores [row 8h + token][position] (fp32, rows of kSxLd floats)
    // over the stage's tiles, which the products have read
    __syncthreads();
    float* sx = reinterpret_cast<float*>(smem + s * stage_bytes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(sx + (16 * warp + g) * kSxLd + 8 * j + 2 * t) =
          make_float2(S[4 * j], S[4 * j + 1]);
      *reinterpret_cast<float2*>(sx + (16 * warp + 8 + g) * kSxLd + 8 * j + 2 * t) =
          make_float2(S[4 * j + 2], S[4 * j + 3]);
    }
    __syncthreads();
    // thread (h, q): the softmax over head h's tokens at positions 4q..4q +
    // 3, in three passes over its own scores (the max; exp(x - max) in place
    // and their sum; the probabilities, into the staged tile)
    unsigned char* o = ot + (it & 1) * ot_bytes;
    {
      const int h = threadIdx.x / 16, q = threadIdx.x % 16;
      float4* xh = reinterpret_cast<float4*>(sx + kRows * h * kSxLd + 4 * q);
      float4 m = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
#pragma unroll
      for (int tok = 0; tok < kRows; ++tok) {
        if (tok < t_tok) {
          const float4 x = xh[tok * kSxLd / 4];
          m = make_float4(fmaxf(m.x, x.x), fmaxf(m.y, x.y), fmaxf(m.z, x.z), fmaxf(m.w, x.w));
        }
      }
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int tok = 0; tok < kRows; ++tok) {
        if (tok < t_tok) {
          const float4 x = xh[tok * kSxLd / 4];
          const float4 e = make_float4(__expf(x.x - m.x), __expf(x.y - m.y), __expf(x.z - m.z),
                                       __expf(x.w - m.w));
          xh[tok * kSxLd / 4] = e;
          sum = make_float4(sum.x + e.x, sum.y + e.y, sum.z + e.z, sum.w + e.w);
        }
      }
#pragma unroll
      for (int tok = 0; tok < kRows; ++tok) {
        if (tok < t_tok) {
          const float4 e = xh[tok * kSxLd / 4];
          const int row = h * t_tok + tok;
          *reinterpret_cast<uint2*>(o + row * kRowBytes + (((q / 2) ^ (row & 7)) << 4) +
                                    8 * (q % 2)) =
              make_uint2(pack2(__fdividef(e.x, sum.x), __fdividef(e.y, sum.y)),
                         pack2(__fdividef(e.z, sum.z), __fdividef(e.w, sum.w)));
        }
      }
    }
    wg::fence_async_shared();  // the staged tile for the TMA store; the threads' writes of a stage
    if (threadIdx.x == 0) bulk_wait_read();  // the previous tile's store has read its tile
    __syncthreads();  // this stage is refilled next iteration; the other staged tile is free
    if (tma) {
      if (threadIdx.x == 0) tma_store_4d(&maps.out, o, p0, 0, b);
    } else {
      for (int e = threadIdx.x; e < (ht + 1) * kBN; e += kWgThreads) {
        const int row = e / kBN, q = e % kBN;
        if (p0 + q < npos)
          ob[static_cast<size_t>(row) * npos + p0 + q] = *reinterpret_cast<const bf16*>(
              o + row * kRowBytes + (((q / 8) ^ (row & 7)) << 4) + 2 * (q % 8));
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

// ----------------------------------------------------------------- K2
//
// x_l = P_eff^T U on wgmma: M = the 64 positions of a tile, N = the 256
// channels (one m64n256k16 a step), K = 16 ranks (a step). A is a step's raw
// P_eff rows [rank][position] and B its U rows [rank][channel], both
// MN-major from shared memory in the 128-byte swizzle, B in four parts of 64
// channels (the descriptor's LBO steps between them). Each block's rows are
// padded to whole steps (TMA reads the rows past it as zeros), so a block's
// product ends on a step. The blocks come in the host's order: a scaled
// block first, whose fp32 product is scaled per position in the accumulator
// (x_l = s_0 (Pd_0^T U_0)) before the other blocks' products add on (the
// iou pass's layer-2 call has just that one scaled block); where a further
// block is scaled (kSplit), every block past the first has its rows split
// exactly in place into bf16 hi + lo (tilde = Pd s has 16 significant bits;
// an unscaled block's scale row is ones) and takes two products a step.
//
// A block is one prompt and a chunk of its position tiles (K3's split) and
// has three producer warps, each with one job on full / empty mbarriers:
// warp 8 loads the prompt's U once (resident, a barrier a step, where it fits
// beside the rest; else each step's U rows come with its P_eff rows) and a
// step's P_eff rows into a slot of its warpgroup's half of the ring (each
// half filled and drained in order: a parity wait must never run two phases
// ahead of its slot); warp 9 loads each tile's S (64 rows, 4 parts of 64
// channels) into the buffer of the warpgroup that takes it; warp 10's
// threads write each tile's per-position rows (a, the blocks' scales, mS,
// qS) into one of four sets. Where N % 8 != 0 (P_eff's rows not 16-byte
// aligned) warp 8's threads write the P_eff rows into TMA's layout.
// Warpgroups 0 and 1 take alternate tiles, so one's epilogue (the channel
// sums of x_l, S x_l and x_l^2: the accumulator against S's words by
// ldmatrix, then over each quad) runs beside the other's products. What
// holds it back on an H100 (clock64 phases, PERF.md): the warpgroups wait
// for P_eff's rows about a third of the time, though the ring runs 16 steps
// ahead of each; the epilogue takes as long as a tile's products.

constexpr int kLnC = 256;                            // channels (the only C the kernel takes)
constexpr int kLnBM = 64;                            // positions a tile: wgmma's M
constexpr int kLnConsumers = 2;                      // warpgroups, alternate tiles
constexpr int kLnThreads = 128 * kLnConsumers + 96;  // and three producer warps
constexpr int kLnPStep = 16 * kLnBM * 2;             // a step's P_eff rows, [16][64]
constexpr int kLnUPart = 16 * 128;                   // a step's U rows at 64 channels
constexpr int kLnUStep = 4 * kLnUPart;               // a step's U rows, [4 parts][16][64]
constexpr int kLnSTile = kLnBM * kLnC * 2;           // an S tile, [4 parts][64][64]
// per-position rows of a tile: a, the blocks' scales, mS, qS
constexpr int kLnRowA = 0, kLnRowS = 1, kLnRowMS = 1 + kMaxBlocks, kLnRowQS = 2 + kMaxBlocks;
constexpr int kLnRowsN = 3 + kMaxBlocks;
constexpr int kLnRowSets = 2 * kLnConsumers;  // a tile's rows in set it % 4
constexpr int kLnMaxSlots = 32;     // resident U: as many as fit, at most 32
constexpr int kLnMinSlots = 4;      // ... and at least 4, else U streams
constexpr int kLnStreamSlots = 8;   // streamed U
constexpr int kLnMaxResident = 15;  // steps of a resident U: one full mbarrier each
constexpr size_t kLnMaxSmem = 232448;

// The tensor maps of a call, 128-byte swizzled: S (N, 256) with boxes of 64
// rows x its 4 parts; block i's U rows (B, r_i, 256) and P_eff rows (B,
// r_i, N) with boxes of a step's 16 rows (x 4 parts of U, x 64 positions of
// P_eff), P_eff's only where N % 8 == 0.
struct LnMaps {
  CUtensorMap s;
  CUtensorMap u[kMaxBlocks];
  CUtensorMap pd[kMaxBlocks];
};

// The shared memory of a call: [U, resident: nsteps x 8 KB][S tiles, one a
// warpgroup][ring: slots of a step's P_eff rows (+ its U rows, streamed)]
// [lo planes, one a warpgroup][rows, four sets][mbarriers]. Every tile and
// step starts 1 KB aligned, as the swizzle atoms need.
struct LnGeometry {
  int nsteps, slots, slot_bytes, resident;
  size_t smem;
};

LnGeometry ln_geometry(const int* r, int nblocks) {
  LnGeometry g{};
  for (int i = 0; i < nblocks; ++i) g.nsteps += (r[i] + 15) / 16;
  auto bytes = [&](size_t ures, int slots, int slot_bytes) {
    return ures + kLnConsumers * (kLnSTile + kLnPStep) +
           sizeof(bf16) * kLnRowSets * kLnRowsN * kLnBM + static_cast<size_t>(slots) * slot_bytes +
           sizeof(uint64_t) * (kLnMaxResident + 2 * kLnConsumers + 2 * kLnRowSets + 2 * kLnMaxSlots);
  };
  // U resident with the deepest ring that fits (up to 32 steps ahead), else
  // streamed with the P_eff rows
  const size_t ures = static_cast<size_t>(g.nsteps) * kLnUStep;
  for (int slots = kLnMaxSlots; g.nsteps <= kLnMaxResident && slots >= kLnMinSlots; slots -= 2)
    if (bytes(ures, slots, kLnPStep) <= kLnMaxSmem)
      return {g.nsteps, slots, kLnPStep, 1, bytes(ures, slots, kLnPStep)};
  return {g.nsteps, kLnStreamSlots, kLnPStep + kLnUStep, 0,
          bytes(0, kLnStreamSlots, kLnPStep + kLnUStep)};
}

// the source of per-position row k (null: ones)
__device__ __forceinline__ const bf16* ln_row_src(const Blocks& bl, const bf16* a, const bf16* ms,
                                                  const bf16* qs, int k) {
  return k == kLnRowA    ? a
         : k == kLnRowMS ? ms
         : k == kLnRowQS ? qs
         : k - kLnRowS < bl.n ? pick(bl.s, k - kLnRowS)
                              : nullptr;
}

// d (64 x 256 fp32) (+)= A (64 x 16, MN-major) x B (16 x 256, MN-major),
// both from shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ln(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F32(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12), F4(i + 16), F4(i + 20), F4(i + 24), F4(i + 28)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      " %128, %129, p, 1, 1, 1, 1;\n}\n"
      : F32(0), F32(32), F32(64), F32(96)
      : "l"(da), "l"(db), "r"(scale_d));
#undef F32
#undef F4
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// descriptor of an MN-major operand at p in the 128-byte swizzle whose
// 64-element column blocks lie lbo bytes apart (SBO 8 rows)
__device__ __forceinline__ uint64_t desc_mn128(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((wg::smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The producer warp's threads write a step's P_eff rows (block rows j0..j0
// + 15 of pd, r rows; zeros past r and npos) by 2-byte loads into TMA's
// swizzled layout: 16-byte chunk c of row j at j * 128 + (c ^ j % 8) * 16.
__device__ __forceinline__ void ln_peff_threads(unsigned char* dst, const bf16* pd, int r, int b,
                                                int j0, int p0, int npos) {
  for (int e = threadIdx.x % 32; e < 16 * (kLnBM / 8); e += 32) {
    const int j = e / 8, c = e % 8, pos = p0 + 8 * c;
    const bool ok = j0 + j < r;
    const auto* src = reinterpret_cast<const unsigned short*>(
        pd + (static_cast<size_t>(b) * r + j0 + j) * npos + pos);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = ok && pos + 2 * k < npos ? src[2 * k] : 0u;
      const uint32_t hi = ok && pos + 2 * k + 1 < npos ? src[2 * k + 1] : 0u;
      w[k] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(dst + j * 128 + ((c ^ (j & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A warp's threads write a tile's per-position rows (ones for a null row,
// zeros past npos): 16-byte loads where the rows are 16-byte aligned (vec),
// else 2-byte loads.
__device__ __forceinline__ void ln_rows_threads(bf16* rw, const Blocks& bl, const bf16* a,
                                                const bf16* ms, const bf16* qs, int b, int p0,
                                                int npos, bool vec) {
  for (int e = threadIdx.x % 32; e < kLnRowsN * kLnBM / 8; e += 32) {
    const int k = e / (kLnBM / 8), pos = p0 + 8 * (e % (kLnBM / 8));
    const bf16* src = ln_row_src(bl, a, ms, qs, k);
    const size_t base = k == kLnRowMS || k == kLnRowQS ? 0 : static_cast<size_t>(b) * npos;
    uint32_t w[4];
    if (!src) {
      w[0] = w[1] = w[2] = w[3] = 0x3f803f80u;  // bf16 ones
    } else if (vec && pos < npos) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + base + pos));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const auto* h = reinterpret_cast<const unsigned short*>(src + base + pos);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = (pos + 2 * q < npos ? h[2 * q] : 0u) | (pos + 2 * q + 1 < npos ? h[2 * q + 1] : 0u) << 16;
    }
    *reinterpret_cast<uint4*>(rw + 8 * e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A landed step's raw P_eff rows of a scaled block that is not the first,
// split in place: tilde = Pd s (exact in fp32) into hi = bf16(tilde) at ps
// and lo = bf16(tilde - hi) (exact) at lo; each thread of the warpgroup one
// 16-byte chunk (row tid / 8, physical chunk tid % 8). srow: the block's
// scale row.
__device__ __forceinline__ void ln_split_step(unsigned char* ps, unsigned char* lo,
                                              const bf16* srow) {
  const int tid = threadIdx.x % 128, j = tid / 8, c = (tid % 8) ^ (j & 7);
  uint4* hp = reinterpret_cast<uint4*>(ps + 16 * tid);
  const uint4 x = *hp, w = *reinterpret_cast<const uint4*>(srow + 8 * c);
  const uint32_t xv[4] = {x.x, x.y, x.z, x.w}, wv[4] = {w.x, w.y, w.z, w.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float t0 = lo_of(xv[k]) * lo_of(wv[k]), t1 = hi_of(xv[k]) * hi_of(wv[k]);
    h[k] = pack2(t0, t1);
    l[k] = pack2(t0 - lo_of(h[k]), t1 - hi_of(h[k]));
  }
  *hp = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + 16 * tid) = make_uint4(l[0], l[1], l[2], l[3]);
}

// kSplit: a scaled block past the first. Every block past the first then
// takes the split (an unscaled one with its row of ones: lo = 0), so that no
// wgmma sits on a branch the data decides: ptxas serializes every wgmma of a
// kernel that has one.
template <bool kSplit>
__global__ void __launch_bounds__(kLnThreads, 1)
    ln_stats_wgmma_kernel(const __grid_constant__ LnMaps maps, Blocks bl,
                          const bf16* __restrict__ ms, const bf16* __restrict__ qs,
                          const bf16* __restrict__ a, float* __restrict__ out, int npos, int per,
                          int nsteps, int slots, int slot_bytes, int resident, int tma,
                          float eps) {
  extern __shared__ __align__(1024) unsigned char ln_smem_raw[];
  unsigned char* ures = wg::checked_base(ln_smem_raw);
  unsigned char* stiles = ures + (resident ? nsteps * kLnUStep : 0);
  unsigned char* ring = stiles + kLnConsumers * kLnSTile;
  unsigned char* lo_planes = ring + slots * slot_bytes;
  bf16* rows = reinterpret_cast<bf16*>(lo_planes + kLnConsumers * kLnPStep);
  uint64_t* ufull = reinterpret_cast<uint64_t*>(rows + kLnRowSets * kLnRowsN * kLnBM);  // a U step
  uint64_t* sfull = ufull + kLnMaxResident;
  uint64_t* sempty = sfull + kLnConsumers;
  uint64_t* wfull = sempty + kLnConsumers;  // a rows set landed
  uint64_t* wempty = wfull + kLnRowSets;    // ... and was read
  uint64_t* rfull = wempty + kLnRowSets;
  uint64_t* rempty = rfull + kLnMaxSlots;

  const int b = blockIdx.y, lane = threadIdx.x % 32;
  // the ring: one half a warpgroup, each filled and drained in its tiles'
  // order (a parity wait must never run two phases ahead of its slot)
  const int half = slots / kLnConsumers;
  int c0;
  const int ntiles = chunk_tiles(npos, per, c0);
  if (threadIdx.x == 0) {
    // a slot's arrivals: lane 0's, or the whole P_eff producer warp's where
    // its threads write the P_eff rows
    const int arrivals = tma ? 1 : 32;
    for (int k = 0; k < kLnMaxResident; ++k) wg::mbar_init(&ufull[k], 1);
    for (int c = 0; c < kLnConsumers; ++c) {
      wg::mbar_init(&sfull[c], 1);
      wg::mbar_init(&sempty[c], 128);
    }
    for (int w = 0; w < kLnRowSets; ++w) {
      wg::mbar_init(&wfull[w], 32);  // the rows' writers: their producer warp
      wg::mbar_init(&wempty[w], 128);
    }
    for (int s = 0; s < slots; ++s) {
      wg::mbar_init(&rfull[s], arrivals);
      wg::mbar_init(&rempty[s], 1);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kLnConsumers + 64) {  // the producer of the rows
    for (int it = 0; it < ntiles; ++it) {  // into the set tile it - 4 read
      if (it >= kLnRowSets) wg::mbar_wait(&wempty[it % kLnRowSets], (it / kLnRowSets - 1) & 1);
      ln_rows_threads(rows + it % kLnRowSets * kLnRowsN * kLnBM, bl, a, ms, qs, b,
                      c0 + it * kLnBM, npos, tma);
      wg::mbar_arrive(&wfull[it % kLnRowSets]);
    }
    return;
  }
  if (threadIdx.x >= 128 * kLnConsumers + 32) {  // the producer of the S tiles
    for (int it = 0; it < ntiles; ++it) {
      const int c = it % kLnConsumers, p0 = c0 + it * kLnBM;
      if (it >= kLnConsumers) wg::mbar_wait(&sempty[c], (it / kLnConsumers - 1) & 1);
      if (lane == 0) {
        wg::mbar_expect_tx(&sfull[c], kLnSTile);
        wg::tma_load_4d(stiles + c * kLnSTile, &maps.s, &sfull[c], 0, p0, 0, 0);
      }
    }
    return;
  }
  if (threadIdx.x >= 128 * kLnConsumers) {  // the producer of U and the P_eff rows
    if (resident && lane == 0) {  // each step of U on its own barrier
      int k = 0;
#pragma unroll
      for (int i = 0; i < kMaxBlocks; ++i)
        if (i < bl.n)
          for (int j0 = 0; j0 < bl.r[i]; j0 += 16, ++k) {
            wg::mbar_expect_tx(&ufull[k], kLnUStep);
            wg::tma_load_4d(ures + k * kLnUStep, &maps.u[i], &ufull[k], 0, j0, 0, b);
          }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int p0 = c0 + it * kLnBM, c = it % kLnConsumers;
      int m = it / kLnConsumers * nsteps;  // the step's place in its warpgroup's ring
#pragma unroll
      for (int i = 0; i < kMaxBlocks; ++i) {
        if (i >= bl.n) break;
        for (int j0 = 0; j0 < bl.r[i]; j0 += 16, ++m) {
          const int slot = c * half + m % half;
          if (m >= half) wg::mbar_wait(&rempty[slot], (m / half - 1) & 1);
          unsigned char* dst = ring + slot * slot_bytes;
          if (!tma) {
            ln_peff_threads(dst, bl.pd[i], bl.r[i], b, j0, p0, npos);
            wg::fence_async_shared();  // the threads' rows, before wgmma reads them
          }
          if (lane == 0) {
            const int bytes = (tma ? kLnPStep : 0) + (resident ? 0 : kLnUStep);
            if (bytes)
              wg::mbar_expect_tx(&rfull[slot], bytes);
            else
              wg::mbar_arrive(&rfull[slot]);
            if (tma) wg::tma_load_4d(dst, &maps.pd[i], &rfull[slot], p0, j0, b, 0);
            if (!resident) wg::tma_load_4d(dst + kLnPStep, &maps.u[i], &rfull[slot], 0, j0, 0, b);
          } else if (!tma) {
            wg::mbar_arrive(&rfull[slot]);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tiles c, c + 2, ...; this thread's accumulator
  // rows are positions r_lo and r_lo + 8 of a tile
  // the warpgroup's index, uniform to the compiler
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = lane / 4, t = lane % 4, r_lo = 16 * warp + g;
  const unsigned char* sx = stiles + c * kLnSTile;
  unsigned char* lo = lo_planes + c * kLnPStep;
  float acc[128];
  for (int it = c; it < ntiles; it += kLnConsumers) {
    const int p0 = c0 + it * kLnBM, m0 = it / kLnConsumers * nsteps;
    const bf16* rw = rows + it % kLnRowSets * kLnRowsN * kLnBM;
    wg::mbar_wait(&wfull[it % kLnRowSets], (it / kLnRowSets) & 1);
    wg::fence_regs(acc);
    wg::wgmma_fence();
    int k = 0;  // the tile's step
#pragma unroll
    for (int i = 0; i < kMaxBlocks; ++i) {
      if (i >= bl.n) break;
      for (int j0 = 0; j0 < bl.r[i]; j0 += 16, ++k) {
        const int m = m0 + k, slot = c * half + m % half;
        unsigned char* ps = ring + slot * slot_bytes;
        const uint64_t db = desc_mn128(resident ? ures + k * kLnUStep : ps + kLnPStep, kLnUPart);
        if (resident && it < kLnConsumers) wg::mbar_wait(&ufull[k], 0);  // a block's first tile
        wg::mbar_wait(&rfull[slot], (m / half) & 1);
        if (kSplit && i > 0) {
          wg::wgmma_wait0();  // the previous step's products have read the lo plane
          ln_split_step(ps, lo, rw + (kLnRowS + i) * kLnBM);
          wg::fence_async_shared();
          wg::wg_sync(1 + c);
          wgmma_ln(acc, wg::make_desc<128>(ps), db, 1);
          wgmma_ln(acc, wg::make_desc<128>(lo), db, 1);
        } else {  // the tile's first step overwrites acc
          wgmma_ln(acc, wg::make_desc<128>(ps), db, k > 0);
        }
        wg::wgmma_commit();
        wgmma_wait1();  // the previous step's products are done: its slot is free
        if (k > 0 && tid == 0) wg::mbar_arrive(&rempty[c * half + (m - 1) % half]);
      }
      if (i == 0) {  // x_l = s_0 (Pd_0^T U_0) so far (s_0 = 1 for an unscaled block)
        wg::wgmma_wait0();
        wg::fence_regs(acc);
        const bool sc = bl.s[0] != nullptr;
        const float s_lo = sc ? __bfloat162float(rw[kLnRowS * kLnBM + r_lo]) : 1.f;
        const float s_hi = sc ? __bfloat162float(rw[kLnRowS * kLnBM + r_lo + 8]) : 1.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          acc[4 * j] *= s_lo;
          acc[4 * j + 1] *= s_lo;
          acc[4 * j + 2] *= s_hi;
          acc[4 * j + 3] *= s_hi;
        }
        wg::fence_regs(acc);
        wg::wgmma_fence();
      }
    }
    wg::wgmma_wait0();
    wg::fence_regs(acc);
    if (tid == 0) wg::mbar_arrive(&rempty[c * half + (m0 + nsteps - 1) % half]);

    // the channel sums of rows r_lo, r_lo + 8: this lane's 64 channels 8j +
    // 2t, + 1 (S's chunk j % 8 of part j / 8, swizzled by the row's g), then
    // the quad's
    wg::mbar_wait(&sfull[c], (it / kLnConsumers) & 1);
    // S's words by ldmatrix.x4: 8x8 matrices (rows r_lo - g + 8h, channels
    // 8j..8j + 7) of (j, h) = (j, 0), (j, 1), (j + 1, 0), (j + 1, 1), lane l
    // giving row l % 8 of matrix l / 8; two partial sums a value halve the
    // chains
    float sum[2][2] = {}, cross[2][2] = {}, sq[2][2] = {};
    const int lrow = 16 * warp + 8 * (lane / 8 % 2) + lane % 8, ljj = lane / 16;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int jj = j + ljj;
      uint32_t sw[4];
      ldmatrix_x4_at(sw, wg::smem_u32(sx + (jj / 8) * (kLnBM * 128) + lrow * 128 +
                                      (((jj % 8) ^ (lane % 8)) << 4)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, jq = j + (q >> 1), u = q >> 1;
        const float x0 = acc[4 * jq + 2 * h], x1 = acc[4 * jq + 2 * h + 1];
        sum[h][u] += x0 + x1;
        cross[h][u] = fmaf(lo_of(sw[q]), x0, fmaf(hi_of(sw[q]), x1, cross[h][u]));
        sq[h][u] = fmaf(x0, x0, fmaf(x1, x1, sq[h][u]));
      }
    }
    float sum_h[2], cross_h[2], sq_h[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum_h[h] = quad_sum(sum[h][0] + sum[h][1]);
      cross_h[h] = quad_sum(cross[h][0] + cross[h][1]);
      sq_h[h] = quad_sum(sq[h][0] + sq[h][1]);
    }
    if (t < 2) {  // lane t = h writes row r_lo + 8h
      const int r = r_lo + 8 * t, pos = p0 + r;
      if (pos < npos) {
        const float mu_d = (t ? sum_h[1] : sum_h[0]) / kLnC;
        const float cr = (t ? cross_h[1] : cross_h[0]) / kLnC, d2 = (t ? sq_h[1] : sq_h[0]) / kLnC;
        const float av = __bfloat162float(rw[kLnRowA * kLnBM + r]);
        const float mS = __bfloat162float(rw[kLnRowMS * kLnBM + r]);
        const float qS = __bfloat162float(rw[kLnRowQS * kLnBM + r]);
        const float mu = av * mS + mu_d;
        const float e2 = av * av * qS + 2.f * av * cr + d2;
        out[static_cast<size_t>(b) * 2 * npos + pos] = mu;
        out[(static_cast<size_t>(b) * 2 + 1) * npos + pos] = 1.f / sqrtf(e2 - mu * mu + eps);
      }
    }
    wg::mbar_arrive(&sempty[c]);  // this tile's S and rows are read
    wg::mbar_arrive(&wempty[it % kLnRowSets]);
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

// A bf16 array of dims {d0, d1, d2, d3} (d0 contiguous; strides s1..s3 in
// bytes, in any order) as a tensor map with boxes `box`, in the 128-byte
// swizzle (box[0] * 2 bytes = 128) or unswizzled; elements past the dims
// read as zeros. TMA takes a 16-byte aligned base and strides: anything
// else, or a map cuTensorMapEncodeTiled refuses, returns
// cudaErrorInvalidValue.
int encode_map4(CUtensorMap& map, const void* base, const cuuint64_t (&dims)[4],
                const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4], bool swizzle = true) {
  const wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 || strides[0] % 16 || strides[1] % 16 ||
      strides[2] % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The same of dims {d0, d1, d2} (strides s1, s2), a last dim of 1.
int encode_map(CUtensorMap& map, const void* base, const cuuint64_t (&d)[3], cuuint64_t s1,
               cuuint64_t s2, const cuuint32_t (&box3)[3], bool swizzle = true) {
  return encode_map4(map, base, {d[0], d[1], d[2], 1},
                     {s1, s2, s1 * d[1] > s2 * d[2] ? s1 * d[1] : s2 * d[2]},
                     {box3[0], box3[1], box3[2], 1}, swizzle);
}

// K3's and K4's maps of a call: two (N, 128) head-term operands (KS and KC,
// or QS and QC) and VS (if any) with their two 64-channel parts as a third
// dim (one box lands [part][row][64]); P_eff and the scales where N % 8 ==
// 0 and their rows are 16-byte aligned (tma = 1; else the threads load
// them, tma = 0). Returns 0 or a CUDA error code.
int encode_t2i_maps(T2iMaps& maps, int& tma, const void* ks, const void* kc, const void* vs,
                    const void* const* pd, const void* const* s, const int* r, int nblocks,
                    const void* a, int b, int n) {
  memset(&maps, 0, sizeof(maps));
  const cuuint64_t row = sizeof(bf16) * kD;
  int err = 0;
  for (auto [map, src] : {std::pair{&maps.ks, ks}, std::pair{&maps.kc, kc}, std::pair{&maps.vs, vs}})
    if (src && (err = encode_map(*map, src, {64, static_cast<cuuint64_t>(n), 2}, row, row / 2,
                                 {64, kBN, 2})))
      return err;
  const cuuint64_t prow = sizeof(bf16) * static_cast<cuuint64_t>(n);
  const void* srcs[1 + kMaxBlocks] = {a, nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < nblocks; ++i) srcs[1 + i] = s[i];
  bool on = n % 8 == 0;
  for (int i = 0; i < nblocks; ++i) on = on && reinterpret_cast<uintptr_t>(pd[i]) % 16 == 0;
  for (const void* p : srcs) on = on && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  tma = on;
  for (int i = 0; on && i < nblocks; ++i)
    if (r[i] > 0 &&
        (err = encode_map(maps.pd[i], pd[i],
                          {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(r[i]),
                           static_cast<cuuint64_t>(b)},
                          prow, prow * r[i], {kBN, static_cast<cuuint32_t>(16 * ((r[i] + 15) / 16)), 1})))
      return err;
  for (int k = 0; on && k < 1 + kMaxBlocks; ++k)
    if (srcs[k] && (err = encode_map(maps.sc[k], srcs[k],
                                     {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(b), 1},
                                     prow, prow * b, {kBN, 1, 1}, false)))
      return err;
  return 0;
}

// K4's dynamic shared memory: the ring, two staged output tiles, the ring's
// scales and barriers.
size_t i2t_smem(const Steps& st, int t) {
  return t2i_smem(2 * kTileBytes + st.n * kStepBytes) + 2 * i2t_out_tile_bytes(t);
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
  // the blocks in the kernel's order: those with rows, the first scaled one
  // first (U's rows stay where they are: each block's map starts at its own)
  int order[kMaxBlocks], m = 0, off[kMaxBlocks + 1] = {0}, first = -1;
  for (int i = 0; i < nblocks; ++i) {
    off[i + 1] = off[i] + r[i];
    if (first < 0 && r[i] > 0 && s[i]) first = i;
  }
  if (first >= 0) order[m++] = first;
  for (int i = 0; i < nblocks; ++i)
    if (r[i] > 0 && i != first) order[m++] = i;
  const void* pdo[kMaxBlocks];
  const void* so[kMaxBlocks];
  int ro[kMaxBlocks];
  for (int k = 0; k < m; ++k) {
    pdo[k] = pd[order[k]];
    so[k] = s[order[k]];
    ro[k] = r[order[k]];
  }
  const Blocks bl = make_blocks(pdo, so, ro, m);

  LnMaps maps;
  memset(&maps, 0, sizeof(maps));
  const cuuint64_t row = sizeof(bf16) * kLnC, prow = sizeof(bf16) * static_cast<cuuint64_t>(n);
  const auto nn = static_cast<cuuint64_t>(n), bb = static_cast<cuuint64_t>(b);
  // S and U with their four 64-channel parts as a dim: a box lands [part][row][64]
  int err = encode_map(maps.s, smat, {64, nn, 4}, row, row / 4, {64, kLnBM, 4});
  for (int k = 0; !err && k < m; ++k)
    err = encode_map4(maps.u[k], static_cast<const unsigned char*>(uc) + off[order[k]] * row,
                      {64, static_cast<cuuint64_t>(ro[k]), 4, bb},
                      {row, row / 4, row * static_cast<cuuint64_t>(rtot)}, {64, 16, 4, 1});
  if (err) return err;
  // P_eff and the rows by TMA where their rows are 16-byte aligned, else by
  // the producer's threads
  const void* rsrc[kLnRowsN] = {a, nullptr, nullptr, nullptr, nullptr, ms, qs};
  for (int k = 0; k < m; ++k) rsrc[kLnRowS + k] = so[k];
  bool tma = n % 8 == 0;
  for (int k = 0; k < m; ++k) tma = tma && reinterpret_cast<uintptr_t>(pdo[k]) % 16 == 0;
  for (const void* p : rsrc) tma = tma && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int k = 0; tma && !err && k < m; ++k)
    err = encode_map(maps.pd[k], pdo[k], {nn, static_cast<cuuint64_t>(ro[k]), bb}, prow,
                     prow * ro[k], {kLnBM, 16, 1});
  if (err) return err;

  const LnGeometry g = ln_geometry(ro, m);
  bool split = false;  // a scaled block past the first
  for (int k = 1; k < m; ++k) split = split || so[k] != nullptr;
  const auto kernel = split ? ln_stats_wgmma_kernel<true> : ln_stats_wgmma_kernel<false>;
  if ((err = set_smem(reinterpret_cast<const void*>(kernel), g.smem))) return err;
  const T2iSplit sp = t2i_split(n);
  kernel<<<dim3(sp.chunks, b), kLnThreads, g.smem, stream>>>(
      maps, bl, static_cast<const bf16*>(ms), static_cast<const bf16*>(qs),
      static_cast<const bf16*>(a), out, n, sp.per, g.nsteps, g.slots, g.slot_bytes, g.resident,
      tma, eps);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of sam6d_factored_ln_stats_bf16's kernel for
// blocks of ranks r, and whether the prompt's U stays resident in it (1) or
// streams with the P_eff rows (0).
int sam6d_factored_ln_stats_bf16_smem(const int* r, int nblocks, int* resident) {
  const LnGeometry g = ln_geometry(r, nblocks);
  *resident = g.resident;
  return static_cast<int>(g.smem);
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
  int tma = 0;
  int err = encode_t2i_maps(maps, tma, ks, kc, vs, pd, s, r, nblocks, a, b, n);
  if (err) return err;
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
  const T2iSplit sp = t2i_split(n);
  I2tMaps maps;
  int tma = 0;
  int err = encode_t2i_maps(maps.in, tma, qs, qc, nullptr, pd, s, r, nblocks, a, b, n);
  // the output by TMA stores where its rows are 16-byte aligned (as P_eff's)
  const cuuint64_t prow = sizeof(bf16) * static_cast<cuuint64_t>(n);
  const auto rows = static_cast<cuuint64_t>(kHeads * t + 1);
  tma = tma && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!err && tma)
    err = encode_map(maps.out, out, {static_cast<cuuint64_t>(n), rows, static_cast<cuuint64_t>(b)},
                     prow, prow * rows, {kBN, static_cast<cuuint32_t>(rows), 1});
  if (err) return err;
  const size_t bytes = i2t_smem(st, t);
  if ((err = set_smem(reinterpret_cast<const void*>(i2t_wgmma_kernel), bytes))) return err;
  i2t_wgmma_kernel<<<dim3(sp.chunks, b), kWgThreads, bytes, stream>>>(
      maps, static_cast<const bf16*>(kt), static_cast<const bf16*>(uq), bl, st,
      static_cast<const bf16*>(a), static_cast<bf16*>(out), t, n, rtot, sp.per, tma);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of sam6d_factored_i2t_scores_bf16's kernel.
int sam6d_factored_i2t_scores_bf16_smem(const int* r, int nblocks, int t) {
  return static_cast<int>(i2t_smem(make_steps(r, nblocks), t));
}

}  // extern "C"
