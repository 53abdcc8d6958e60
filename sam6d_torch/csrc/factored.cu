// The three kernels of the SAM AMG's exact iou-prefix pass, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replace the Pallas kernels of sam6d_tpu/kernels/factored_t2i.py:
// factored_ln_stats (_ln_stats_kernel), factored_t2i_attention
// (_t2i_kernel) and factored_i2t_scores (_i2t_kernel). In that pass the
// two-way transformer carries each prompt's image side as
//   x[b] = a[b] * S + P_eff[b]^T U[b]          (S: (N, C), shared)
// where P_eff is a list of up to four SCALED BLOCKS: raw factor rows
// Pd_i (B, R_i, N) times an optional per-position scale s_i (B, N). The
// blocks are passed as a small descriptor (pointers, ranks, scale pointers
// or null), never concatenated; row r of P_eff is row r - off_i of the
// block that holds it, times that block's scale.
//
// Shapes on the main path (ViT-H SAM, 128-prompt chunks): B = 128,
// N = 4096 image positions, C = 256 channels, d = 128 attention channels
// as 8 heads of 16, T = 7 tokens (HT = 56), ranks 57..118. Each kernel is
// launched twice per chunk.
//
// What bounds them (fp32, TF32 off, H100 SXM 67 TFLOP/s, 3.35 TB/s):
//  - ln_stats: 2*B*R*C*N FLOP for the low-rank part of x (31 GFLOP at
//    R = 116), compute-bound (~0.47 ms on the fp32 units; 0.197 ms with the
//    product in three-pass TF32 at 165 TFLOP/s); P_eff (243 MB at R = 116)
//    is read once (~0.08 ms);
//  - t2i: B*HT*N*(6 hd + 4R + 5) FLOP (17 GFLOP at R = 118), compute-bound
//    (~0.25 ms on the fp32 units); with the scores (8.8 GFLOP) in
//    three-pass TF32 and the value part, T2 and the softmax (8.0 GFLOP) on
//    the fp32 units, ~0.17 ms; P_eff is read once (~0.075 ms);
//  - i2t: writes B*(HT+1)*N floats (120 MB) and reads P_eff (126 MB at
//    R = 59), 2*B*HT*R*N FLOP (3.5 GFLOP at R = 59): bytes-bound once the
//    products run in three-pass TF32 (~0.076 ms at R = 59, ~0.037 at R = 0).
//
// Designs:
//  - ln_stats: one block of 8 warps per (prompt, 64 positions), two
//    blocks an SM, forms its tile of x (64 positions x 256 channels) on the
//    tensor cores as the three-pass TF32 product of the P_eff tile and U
//    (tf32x3.cuh), adds a * S on the fp32 units and reduces the channel sum
//    and sum of squares: mu = E[x], var = E[x^2] - mu^2 (the TPU kernel's
//    fast-variance form). This folds the TPU kernel's gram (R x R),
//    mean(U) and S-cross (R x N) terms into one product; none of them, and
//    no x, reaches memory. Each block reads its P_eff tile once with
//    16-byte cp.async and splits it once into shared memory; U, shared by
//    the 64 position tiles of a prompt, comes from L2 in fp32 and each warp
//    splits its B fragments: U split once per call into TF32 pairs (a
//    pre-pass) doubled the bytes every block pulls from L2, and measured
//    slower on an H100 (PERF.md). The chain on one accumulator is at most
//    3 ceil(R / 8) HMMAs (45 at R = 116), short enough that the tensor
//    cores' truncating accumulation stays far below the tolerance (the
//    U x 4 card test checks it).
//  - t2i: each prompt's 64-position tiles are cut into 8 chunks of whole
//    tiles, one block of 8 warps each (grid (8, B): 1024 blocks, two an SM,
//    ~4 waves on 132 SMs), warp h = head h (the query is block-diagonal
//    over heads, so head h needs only its 16 channels). A block forms T1 =
//    U_K q_h^T once, then keeps an online softmax over its chunk: each
//    tile's scores on the tensor cores as in i2t (the head-score term, then
//    the rank term with P_eff staged by PeffStage, every stage's planes
//    left resident), the softmax over positions on the C fragments, and on
//    the fp32 units the value part p (a VS) and T2 = p P_eff^T, read back
//    from the planes. Each chunk writes its unnormalised partial (m, l,
//    value part, T2); a merge kernel, one block per prompt, weighs them by
//    exp(m - max m), adds (sum w T2) U_V and writes only the head-diagonal
//    output blocks: (B, T, d).
//  - i2t: one block of 8 warps per (prompt, 64 positions), warp h = head
//    h, its score tile (64 positions x 8 token rows) on the tensor cores in
//    three-pass TF32: the head-score term (a QS + QC) k_h^T as 2 k8 steps,
//    then the rank term P_eff^T T1 (T1 = U_Q k_h^T, formed first on the fp32
//    units) with the P_eff tile staged by cp.async and split once into
//    shared memory (PeffStage, which t2i shares); the softmax over
//    each head's tokens is a quad reduction, and the (HT + 1) x 64
//    probability tile, with the trailing row of ones, leaves through shared
//    memory as whole rows.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tf32x3.cuh"

namespace {

using sam6d::cp_async16;
using sam6d::cp_async_commit;
using sam6d::cp_async_wait;
using sam6d::mma_tf32x3;
using sam6d::quad_max;
using sam6d::quad_sum;
using sam6d::split_tf32;

constexpr int kMaxBlocks = 4;
constexpr int kThreads = 256;
constexpr int kHeads = 8;            // t2i / i2t: one warp per head
constexpr int kHd = 16;              // channels per head
constexpr int kD = kHeads * kHd;     // attention channels
constexpr int kRows = 8;             // tokens per head, padded
constexpr int kMaxRank = 128;

struct Blocks {
  const float* pd[kMaxBlocks];  // (B, r[i], N) raw factor rows
  const float* s[kMaxBlocks];   // (B, N) per-position scale, or null
  int r[kMaxBlocks];            // 0 past the last block
  int n;
};

// ------------------------------------------------------------ ln_stats
//
// x tile = P_eff tile^T U by three-pass TF32 mma.sync m16n8k8 (tf32x3.cuh):
// M = positions, N = the 256 channels, K = the ranks zero-padded to 8.

constexpr int kLnC = 256;         // channels (the only C the kernel takes)
constexpr int kLnKC = 16;         // ranks a stage: two k8 steps
constexpr int kLnLdu = kLnC + 4;  // words a staged U row: B fragment reads conflict-free
constexpr int kLnWM = 2;          // warps along positions (four along channels)
constexpr int kLnStages = 3;      // stages of the cp.async rings

constexpr int kLnThreads = 128 * kLnWM;
constexpr int kLnBM = 32 * kLnWM;      // positions a block
constexpr int kLnLdp = kLnBM + 4;      // words a P plane row
// The rings of U rows, P_eff values and their scales, two P planes (big,
// small) for each of two stages, and the cross-warp row sums: 94 KB.
constexpr size_t kLnSmemBytes =
    sizeof(float) * kLnStages * kLnKC * (kLnLdu + 2 * kLnBM) +
    sizeof(uint32_t) * 2 * 2 * kLnKC * kLnLdp + sizeof(float2) * 4 * kLnBM;

// One block per (prompt, kLnBM positions); warp (wm, wn) owns positions
// 32 wm.. (two m16 tiles) and channels 64 wn.. (eight n8 tiles), 64 fp32
// accumulators a lane. Ranks go in stages of two k8 steps, their operands
// copied by cp.async kLnStages - 1 stages ahead (ranks past rtot
// zero-filled):
//  - U's fp32 rows; each warp splits its B fragments as it reads them;
//  - the P_eff tile, 16 ranks x kLnBM positions, one 16-byte chunk a
//    thread (a warp reads whole rows), and the chunk's scale; the thread
//    that copied a chunk scales it, splits it once and stores it as a big
//    and a small plane [rank][position] (rows of kLnBM + 4 words: the
//    stores and every A fragment read are conflict-free) while the block
//    still computes the stage before;
// then one barrier a stage. The epilogue stays on the fp32 units.
__global__ void __launch_bounds__(kLnThreads, 4 / kLnWM)
    ln_stats_tc_kernel(Blocks bl, const float* __restrict__ uc,
                       const float* __restrict__ smat, const float* __restrict__ a,
                       float* __restrict__ out, int npos, int rtot, float eps) {
  constexpr int T = kLnThreads, BM = kLnBM, LDP = kLnLdp, NS = kLnStages;
  constexpr int kStage = kLnKC * kLnLdu;  // words of U a stage
  constexpr int kTile = kLnKC * BM;       // words of P_eff (or scales) a stage
  constexpr int kPlane = kLnKC * LDP;     // words of one P plane
  extern __shared__ uint4 smem_u4[];
  float* us = reinterpret_cast<float*>(smem_u4);                 // [NS][kLnKC][kLnLdu]
  float* pr = us + NS * kStage;                                  // [NS][kLnKC][BM]
  float* sr = pr + NS * kTile;                                   // [NS][kLnKC][BM]
  uint32_t* ps = reinterpret_cast<uint32_t*>(sr + NS * kTile);   // [2][2][kLnKC][LDP]
  float2* red = reinterpret_cast<float2*>(ps + 2 * 2 * kPlane);  // [4][BM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int b = blockIdx.y, n0 = blockIdx.x * BM;
  const int steps = (rtot + 7) / 8;
  const int nst = (steps + 1) / 2;

  const float* ub = uc + static_cast<size_t>(b) * rtot * kLnC;
  auto issue_u = [&](int s) {  // stage s into ring slot s % NS
    float* dst = us + (s % NS) * kStage;
    for (int e = threadIdx.x; e < kLnKC * kLnC / 4; e += T) {
      const int rr = e / (kLnC / 4), c = 4 * (e % (kLnC / 4)), r = kLnKC * s + rr;
      cp_async16(dst + rr * kLnLdu + c, ub + static_cast<size_t>(r < rtot ? r : 0) * kLnC + c,
                 r < rtot);
    }
  };

  // this thread's P_eff chunk: rank 16 s + prr, positions ppos..ppos+3; the
  // scaled-block descriptor is resolved once a stage
  const int prr = threadIdx.x / (BM / 4), pq = threadIdx.x % (BM / 4);
  const int ppos = n0 + 4 * pq;
  const int chunk = prr * BM + 4 * pq;
  const bool vec = (npos & 3) == 0;  // rows and scales 16-byte aligned
  auto issue_p = [&](int s) {
    float* pd = pr + (s % NS) * kTile + chunk;
    float* sd = sr + (s % NS) * kTile + chunk;
    const int r = kLnKC * s + prr;
    const float* row = nullptr;
    const float* sc = nullptr;
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
    if (vec) {
      cp_async16(pd, row ? row : smat, row != nullptr);
      if (sc)
        cp_async16(sd, sc, true);
      else
        *reinterpret_cast<float4*>(sd) = make_float4(1.f, 1.f, 1.f, 1.f);
    } else {  // 4-byte loads, stored as they arrive
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row && ppos + j < npos;
        pd[j] = ok ? __ldg(row + j) : 0.f;
        sd[j] = ok && sc ? __ldg(sc + j) : 1.f;
      }
    }
  };
  // the chunk of stage s, landed: the scaled values (the fp32 product
  // pd * s), split once into the planes
  auto split_p = [&](int s) {
    const float4 x = *reinterpret_cast<const float4*>(pr + (s % NS) * kTile + chunk);
    const float4 w = *reinterpret_cast<const float4*>(sr + (s % NS) * kTile + chunk);
    uint32_t* dst = ps + (s & 1) * 2 * kPlane + prr * LDP + 4 * pq;
    uint4 big, small;
    split_tf32(x.x * w.x, big.x, small.x);
    split_tf32(x.y * w.y, big.y, small.y);
    split_tf32(x.z * w.z, big.z, small.z);
    split_tf32(x.w * w.w, big.w, small.w);
    *reinterpret_cast<uint4*>(dst) = big;
    *reinterpret_cast<uint4*>(dst + kPlane) = small;
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // k = t is rank 2t and k = t + 4 rank 2t + 1 in both fragments. A: rows
  // (positions) g, g + 8, from the planes; B: channel g, split here
  auto compute = [&](int s) {
    const uint32_t* pb = ps + (s & 1) * 2 * kPlane + 32 * wm + g;
    const float* ust = us + (s % NS) * kStage + 2 * t * kLnLdu + 64 * wn + g;
    const int nk = min(2, steps - 2 * s);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk < nk) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* p = pb + (8 * kk + 2 * t) * LDP + 16 * mt;
          ab[mt][0] = p[0];
          ab[mt][1] = p[8];
          ab[mt][2] = p[LDP];
          ab[mt][3] = p[LDP + 8];
          as[mt][0] = p[kPlane];
          as[mt][1] = p[kPlane + 8];
          as[mt][2] = p[kPlane + LDP];
          as[mt][3] = p[kPlane + LDP + 8];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* u = ust + 8 * kk * kLnLdu + 8 * nt;
          uint32_t bb[2], bs[2];
          split_tf32(u[0], bb[0], bs[0]);
          split_tf32(u[kLnLdu], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32x3(acc[mt][nt], ab[mt], as[mt], bb, bs);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nst) {
      issue_u(s);
      issue_p(s);
    }
    cp_async_commit();
  }
  if (nst > 0) {
    cp_async_wait<NS - 2>();
    split_p(0);
  }
  for (int s = 0; s < nst; ++s) {
    __syncthreads();  // stage s is in place; stage s - 1's slots are free
    if (s + NS - 1 < nst) {
      issue_u(s + NS - 1);
      issue_p(s + NS - 1);
    }
    cp_async_commit();
    compute(s);
    if (s + 1 < nst) {  // this thread's copies of stage s + 1 have landed
      cp_async_wait<NS - 2>();
      split_p(s + 1);
    }
  }

  // v = a S + x; the channel sum and sum of squares by quad shuffles, then
  // across the four channel warps in shared memory
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lp = 32 * wm + 16 * mt + 8 * h + g, pos = n0 + lp;
      float sum = 0.f, sq = 0.f;
      if (pos < npos) {
        const float av = a ? a[static_cast<size_t>(b) * npos + pos] : 1.f;
        const float* srow = smat + static_cast<size_t>(pos) * kLnC + 64 * wn + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 s2 = __ldg(reinterpret_cast<const float2*>(srow + 8 * nt));
          const float v0 = fmaf(av, s2.x, acc[mt][nt][2 * h]);
          const float v1 = fmaf(av, s2.y, acc[mt][nt][2 * h + 1]);
          sum += v0 + v1;
          sq = fmaf(v0, v0, sq);
          sq = fmaf(v1, v1, sq);
        }
      }
      sum = quad_sum(sum);
      sq = quad_sum(sq);
      if (t == 0) red[wn * BM + lp] = make_float2(sum, sq);
    }
  }
  __syncthreads();
  for (int lp = threadIdx.x; lp < BM; lp += T) {
    const int pos = n0 + lp;
    if (pos >= npos) continue;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sum += red[w * BM + lp].x;
      sq += red[w * BM + lp].y;
    }
    const float mu = sum / kLnC;
    const float var = sq / kLnC - mu * mu;
    out[static_cast<size_t>(b) * 2 * npos + pos] = mu;
    out[(static_cast<size_t>(b) * 2 + 1) * npos + pos] = 1.f / sqrtf(var + eps);
  }
}

// ------------------------------------------------------- P_eff staging
//
// One stage of a P_eff tile: KR ranks x W positions of prompt b, from rank
// r0 and position p0, through a ring slot of raw values and their scales
// into a pair of TF32 planes. A thread owns the same 16-byte chunks (4
// positions of one rank row) in both steps:
//  - issue: resolves the scaled-block descriptor once for the chunk's rank
//    row and copies the values, and that block's scales (ones where the
//    block has none), by cp.async; ranks past rtot and positions past npos
//    are zero-filled. With npos % 4 != 0 (rows not 16-byte aligned) it
//    takes 4-byte loads, stored as they arrive;
//  - split: once the stage has landed, scales the chunk (the fp32 product
//    value * scale), splits it into TF32 big/small and stores both into
//    planes [rank][W + 4 words]: a warp's 16-byte stores cover whole rows,
//    and the A-fragment reads of ranks (2t, 2t + 1) at positions g, g + 8
//    fall in 32 different banks.
template <int KR, int W, int T>
struct PeffStage {
  static constexpr int kLd = W + 4;        // words a plane row
  static constexpr int kWords = KR * W;    // words of a ring slot (values or scales)
  static constexpr int kPlane = KR * kLd;  // words of one plane
  static constexpr int kChunks = KR * W / 4;
  static constexpr int kPer = (kChunks + T - 1) / T;  // chunks a thread
  static_assert(W % 16 == 0 && (kChunks % T == 0 || kChunks < T), "whole chunks");

  // `fill`: any valid global address, the source of the zero-filled copies
  __device__ __forceinline__ static void issue(float* val, float* scl, const Blocks& bl,
                                               int b, int r0, int p0, int npos, int rtot,
                                               const float* fill) {
    const bool vec = (npos & 3) == 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * T;
      if (kChunks < T && c >= kChunks) break;
      const int rr = c / (W / 4), q = 4 * (c % (W / 4));
      const int r = r0 + rr, pos = p0 + q;
      const float* row = nullptr;
      const float* sc = nullptr;
      if (r < rtot && pos < npos) {
        int off = 0;
#pragma unroll
        for (int k = 0; k < kMaxBlocks; ++k) {
          if (!row && k < bl.n && r < off + bl.r[k]) {
            row = bl.pd[k] + (static_cast<size_t>(b) * bl.r[k] + (r - off)) * npos + pos;
            if (bl.s[k]) sc = bl.s[k] + static_cast<size_t>(b) * npos + pos;
          }
          off += bl.r[k];
        }
      }
      float* vd = val + rr * W + q;
      float* sd = scl + rr * W + q;
      if (vec) {
        cp_async16(vd, row ? row : fill, row != nullptr);
        if (sc)
          cp_async16(sd, sc, true);
        else
          *reinterpret_cast<float4*>(sd) = make_float4(1.f, 1.f, 1.f, 1.f);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = row && pos + j < npos;
          vd[j] = ok ? __ldg(row + j) : 0.f;
          sd[j] = ok && sc ? __ldg(sc + j) : 1.f;
        }
      }
    }
  }

  // this thread's chunks of a landed slot into the planes: big at `planes`,
  // small at planes + kPlane
  __device__ __forceinline__ static void split(const float* val, const float* scl,
                                               uint32_t* planes) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * T;
      if (kChunks < T && c >= kChunks) break;
      const int rr = c / (W / 4), q = 4 * (c % (W / 4));
      const float4 x = *reinterpret_cast<const float4*>(val + rr * W + q);
      const float4 w = *reinterpret_cast<const float4*>(scl + rr * W + q);
      uint4 big, small;
      split_tf32(x.x * w.x, big.x, small.x);
      split_tf32(x.y * w.y, big.y, small.y);
      split_tf32(x.z * w.z, big.z, small.z);
      split_tf32(x.w * w.w, big.w, small.w);
      *reinterpret_cast<uint4*>(planes + rr * kLd + q) = big;
      *reinterpret_cast<uint4*>(planes + kPlane + rr * kLd + q) = small;
    }
  }
};

// ------------------------------------------------------ score tiles (K3, K4)
//
// A tile's scores (positions x head h's 8 token rows) by three-pass TF32
// mma.sync m16n8k8: M = positions, N = tokens (rows past t zero), K = 16
// channels for the head-score term, then the ranks zero-padded to 8. Warp
// h, lane (g, t).

// T1_h = U_h k_h^T (ranks past rtot zero, up to nr) on the fp32 units into
// t1[(h, row)][ldt], rows < `rows`: lanes (rank g of 8, channels
// 4t..4t+3), so that a quad reads a U row's 64-byte head slice and every
// sector a float4 load touches is used; the partial dots are reduced and
// scattered over the quad. kh: head h's token rows (t_tok of them); ub:
// the prompt's U rows at head h (row stride kD).
__device__ __forceinline__ void t1_factor(float* t1, int rows, int ldt, const float* kh,
                                          const float* ub, int t_tok, int rtot, int nr) {
  const int h = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kv[kRows];
#pragma unroll
  for (int tt = 0; tt < kRows; ++tt)
    kv[tt] = tt < t_tok ? __ldg(reinterpret_cast<const float4*>(kh + tt * kD + 4 * t)) : zero4;
  ub += 4 * t;
  const bool hi = t & 2, lo = t & 1;
  for (int r0 = 0; r0 < nr; r0 += 8) {
    const int r = r0 + g;
    const float4 u = r < rtot ? __ldg(reinterpret_cast<const float4*>(ub + r * kD)) : zero4;
    float v[kRows];
#pragma unroll
    for (int tt = 0; tt < kRows; ++tt)
      v[tt] = fmaf(u.w, kv[tt].w, fmaf(u.z, kv[tt].z, fmaf(u.y, kv[tt].y, u.x * kv[tt].x)));
    // over the quad: lanes t ^ 2 swap halves, then t ^ 1 quarters; lane t
    // ends with tokens 2t, 2t + 1
    float w[4], z[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (hi ? v[4 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, hi ? v[i] : v[4 + i], 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      z[i] = (lo ? w[2 + i] : w[i]) + __shfl_xor_sync(0xffffffffu, lo ? w[i] : w[2 + i], 1);
    if (2 * t < rows) t1[(h * rows + 2 * t) * ldt + r] = z[0];
    if (2 * t + 1 < rows) t1[(h * rows + 2 * t + 1) * ldt + r] = z[1];
  }
}

// acc += (a S + C)_h k_h^T for the tile's MT m16 tiles from position n0, as
// 2 k8 steps: each lane reads its positions' 16-byte S and C slices (a
// quad covers a 64-byte row slice; every element is used by one lane once,
// so it is not staged), forms fmaf(a, S, C) and splits it; k = t is channel
// 4t + 2kk and k = t + 4 channel 4t + 2kk + 1, so the B fragment is one
// float4 of k_h. Positions past npos score 0 here; a may be null (ones).
template <int MT>
__device__ __forceinline__ void head_score_term(float (&acc)[MT][4], const float* kh,
                                                const float* sm, const float* cm,
                                                const float* a, int b, int n0, int npos,
                                                int t_tok) {
  const int h = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 kg =
      g < t_tok ? __ldg(reinterpret_cast<const float4*>(kh + g * kD + 4 * t)) : zero4;
  uint32_t kb[2][2], ksm[2][2];
  split_tf32(kg.x, kb[0][0], ksm[0][0]);
  split_tf32(kg.y, kb[0][1], ksm[0][1]);
  split_tf32(kg.z, kb[1][0], ksm[1][0]);
  split_tf32(kg.w, kb[1][1], ksm[1][1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float x[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pos = n0 + 16 * mt + 8 * hh + g;
      float4 q4 = zero4, c4 = zero4;
      float av = 1.f;
      if (pos < npos) {
        const size_t o = static_cast<size_t>(pos) * kD + h * kHd + 4 * t;
        q4 = __ldg(reinterpret_cast<const float4*>(sm + o));
        c4 = __ldg(reinterpret_cast<const float4*>(cm + o));
        if (a) av = __ldg(a + static_cast<size_t>(b) * npos + pos);
      }
      x[hh][0] = fmaf(av, q4.x, c4.x);
      x[hh][1] = fmaf(av, q4.y, c4.y);
      x[hh][2] = fmaf(av, q4.z, c4.z);
      x[hh][3] = fmaf(av, q4.w, c4.w);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float af[4] = {x[0][2 * kk], x[1][2 * kk], x[0][2 * kk + 1], x[1][2 * kk + 1]};
      uint32_t ab[4], as[4];
      sam6d::split_a(af, ab, as);
      mma_tf32x3(acc[mt], ab, as, kb[kk], ksm[kk]);
    }
  }
}

// ----------------------------------------------------------------- i2t

constexpr int kI2tBN = 64;           // positions a block: 4 m16 tiles a warp
constexpr int kI2tKR = 8;            // ranks a stage: one k8 step
constexpr int kI2tStages = 3;        // stages of the cp.async ring
constexpr int kI2tMinBlocks = 4;     // blocks an SM: at most 64 registers a thread
constexpr int kI2tLdo = kI2tBN + 4;  // words a probability row
using I2tStage = PeffStage<kI2tKR, kI2tBN, kThreads>;
// The ring of values and scales and two plane pairs, which the probability
// tile replaces after the loop (20.5 KB), then T1 [head][token][ldt] (18 KB
// at rank 59)
constexpr size_t kI2tLoopBytes =
    sizeof(float) * (2 * kI2tStages * I2tStage::kWords + 2 * 2 * I2tStage::kPlane);
constexpr size_t kI2tOutBytes = sizeof(float) * kHeads * kRows * kI2tLdo;
constexpr size_t kI2tTileBytes = kI2tLoopBytes > kI2tOutBytes ? kI2tLoopBytes : kI2tOutBytes;

// Words a T1 row: the ranks padded to a stage, then to 32, plus 8, so the
// float2 B-fragment reads are conflict-free; 0 without ranks.
int i2t_t1_ld(int rtot) {
  const int rp = (rtot + kI2tKR - 1) / kI2tKR * kI2tKR;
  return rp == 0 ? 0 : (rp + 31) / 32 * 32 + 8;
}

// One block per (prompt, kI2tBN positions), warp h = head h, four blocks an
// SM. Each warp owns the n8 tile of its head's tokens and the block's
// positions as 4 m16 tiles: 16 fp32 accumulators a lane. (128 positions in
// 8 m16 tiles, 118 registers and two blocks an SM, measured 0.17 / 0.35 ms
// against 0.12 / 0.32 at ranks 0 / 59 on an H100: PERF.md.)
//  - T1_h = UQ_h k_h^T (R x 8) into shared memory (t1_factor);
//  - the head-score term (a QS + QC)_h k_h^T (head_score_term);
//  - the rank term P_eff^T T1 in stages of one k8 step (k = t is rank 2t, k =
//    t + 4 rank 2t + 1), P_eff staged by PeffStage kI2tStages - 1 stages
//    ahead, T1's B fragment one float2 a step, split as read;
//  - the softmax over the head's tokens per position: each lane holds tokens
//    2t, 2t + 1 of positions g, g + 8, so it is a quad reduction, tokens
//    past t at -inf (__expf, one reciprocal a position). The probabilities
//    go into a tile [(h, token)][position] over the ring, and every row,
//    then the row of ones, is written as 256-byte runs of float4.
__global__ void __launch_bounds__(kThreads, kI2tMinBlocks)
    i2t_tc_kernel(const float* __restrict__ kt, const float* __restrict__ uq, Blocks bl,
                  const float* __restrict__ a, const float* __restrict__ qs,
                  const float* __restrict__ qc, float* __restrict__ out, int t_tok,
                  int npos, int rtot, int ldt) {
  using St = I2tStage;
  constexpr int NS = kI2tStages, BN = kI2tBN, KR = kI2tKR, LDO = kI2tLdo;
  constexpr int LD = St::kLd, MT = BN / 16;
  static_assert(KR == 8, "one k8 step a stage");
  extern __shared__ uint4 smem_u4[];
  float* vr = reinterpret_cast<float*>(smem_u4);                     // [NS][KR][BN]
  float* sr = vr + NS * St::kWords;                                  // [NS][KR][BN]
  uint32_t* ps = reinterpret_cast<uint32_t*>(sr + NS * St::kWords);  // [2][2][KR][LD]
  float* ot = vr;                                                    // [(h, token)][LDO]
  float* t1 = vr + kI2tTileBytes / sizeof(float);                    // [head][token][ldt]

  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y, n0 = blockIdx.x * BN;
  const int nst = (rtot + KR - 1) / KR;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nst)
      St::issue(vr + s * St::kWords, sr + s * St::kWords, bl, b, KR * s, n0, npos, rtot, qs);
    cp_async_commit();
  }

  const float* kh = kt + static_cast<size_t>(b) * t_tok * kD + h * kHd;
  if (nst > 0)
    t1_factor(t1, kRows, ldt, kh, uq + static_cast<size_t>(b) * rtot * kD + h * kHd, t_tok,
              rtot, KR * nst);

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  head_score_term(acc, kh, qs, qc, a, b, n0, npos, t_tok);

  // the rank term
  if (nst > 0) {
    cp_async_wait<NS - 2>();
    St::split(vr, sr, ps);
  }
  for (int s = 0; s < nst; ++s) {
    __syncthreads();  // stage s is in place (and T1); stage s - 1's slots are free
    if (s + NS - 1 < nst) {
      const int slot = (s + NS - 1) % NS;
      St::issue(vr + slot * St::kWords, sr + slot * St::kWords, bl, b, KR * (s + NS - 1),
                n0, npos, rtot, qs);
    }
    cp_async_commit();
    const float2 tv =
        *reinterpret_cast<const float2*>(t1 + (h * kRows + g) * ldt + KR * s + 2 * t);
    uint32_t bb[2], bs[2];
    split_tf32(tv.x, bb[0], bs[0]);
    split_tf32(tv.y, bb[1], bs[1]);
    const uint32_t* pb = ps + (s & 1) * 2 * St::kPlane + 2 * t * LD + g;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* p = pb + 16 * mt;
      const uint32_t ab[4] = {p[0], p[8], p[LD], p[LD + 8]};
      const uint32_t as[4] = {p[St::kPlane], p[St::kPlane + 8], p[St::kPlane + LD],
                              p[St::kPlane + LD + 8]};
      mma_tf32x3(acc[mt], ab, as, bb, bs);
    }
    if (s + 1 < nst) {  // this thread's copies of stage s + 1 have landed
      cp_async_wait<NS - 2>();
      const int slot = (s + 1) % NS;
      St::split(vr + slot * St::kWords, sr + slot * St::kWords,
                ps + ((s + 1) & 1) * 2 * St::kPlane);
    }
  }

  // softmax over the head's tokens: c0/c1 (position g, tokens 2t, 2t + 1),
  // c2/c3 (position g + 8)
  const bool v0 = 2 * t < t_tok, v1 = 2 * t + 1 < t_tok;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float x0 = v0 ? acc[mt][2 * hh] : -CUDART_INF_F;
      const float x1 = v1 ? acc[mt][2 * hh + 1] : -CUDART_INF_F;
      const float mx = quad_max(fmaxf(x0, x1));  // token 0 is always there
      const float e0 = v0 ? __expf(x0 - mx) : 0.f;
      const float e1 = v1 ? __expf(x1 - mx) : 0.f;
      const float inv = 1.f / quad_sum(e0 + e1);
      acc[mt][2 * hh] = e0 * inv;
      acc[mt][2 * hh + 1] = e1 * inv;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring and the planes
  float* orow = ot + (h * t_tok + 2 * t) * LDO + g;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (v0) orow[16 * mt + 8 * hh] = acc[mt][2 * hh];
      if (v1) orow[LDO + 16 * mt + 8 * hh] = acc[mt][2 * hh + 1];
    }
  }
  __syncthreads();
  const int ht = kHeads * t_tok;
  const bool vec = (npos & 3) == 0;
  float* ob = out + static_cast<size_t>(b) * (ht + 1) * npos + n0;
  for (int e = threadIdx.x; e < (ht + 1) * (BN / 4); e += kThreads) {
    const int row = e / (BN / 4), q = 4 * (e % (BN / 4)), pos = n0 + q;
    const float4 v = row < ht ? *reinterpret_cast<const float4*>(ot + row * LDO + q)
                              : make_float4(1.f, 1.f, 1.f, 1.f);
    float* dst = ob + static_cast<size_t>(row) * npos + q;
    if (vec) {
      if (pos < npos) *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (pos + j < npos) dst[j] = vv[j];
    }
  }
}

// ----------------------------------------------------------------- t2i

constexpr int kT2iBN = 64;  // positions a tile: 4 m16 tiles a warp (32: slower, PERF.md)
// Position chunks a prompt, one block each: 8 x 128 prompts = 1024 blocks,
// ~4 waves of two blocks on each of 132 SMs. Each chunk forms T1 again and
// adds a partial to merge, so more chunks add work, and fewer leave the
// SMs fewer blocks to hide latency with (4 and 16 measured level or slower
// on an H100, PERF.md).
constexpr int kT2iChunks = 8;

// A prompt's position tiles are cut into `chunks` chunks of `per` whole
// tiles, none empty.
struct T2iSplit {
  int chunks, per;
};
T2iSplit t2i_split(int npos) {
  const int tiles = (npos + kT2iBN - 1) / kT2iBN;
  const int per = (tiles + kT2iChunks - 1) / kT2iChunks;
  return {(tiles + per - 1) / per, per};
}

// Floats of one (prompt, chunk) partial: m [(head, row)], l [(head, row)],
// the value part [(head, row)][channel], T2 [head][rank][row].
__host__ __device__ constexpr int t2i_record(int rtot) {
  return kHeads * kRows * (2 + kHd + rtot);
}
constexpr int kRecAcc = 2 * kHeads * kRows;
constexpr int kRecT2 = kRecAcc + kHeads * kRows * kHd;

constexpr int kT2iStages = 3;         // stages of the cp.async ring
using T2iStage = PeffStage<kI2tKR, kT2iBN, kThreads>;
// The ring of values and scales, which the probability tile [head][position]
// [row] replaces after the score loop (16 KB)
constexpr int kT2iTileWords = 2 * kT2iStages * T2iStage::kWords > kHeads * kT2iBN * kRows
                                  ? 2 * kT2iStages * T2iStage::kWords
                                  : kHeads * kT2iBN * kRows;

// The P_eff tile's planes, one (big, small) pair a stage, all resident
// (65 KB at rank 118), the ring / probability tile, T1 [head][token][ldt]
// (30 KB at rank 118, 7 tokens), a and the tile's rescale factors: 110 KB
// at rank 118, two blocks an SM.
size_t t2i_smem_bytes(int t_tok, int rtot, int ldt) {
  const int nst = (rtot + kI2tKR - 1) / kI2tKR;
  return sizeof(float) * (nst * 2 * T2iStage::kPlane + kT2iTileWords + kHeads * t_tok * ldt +
                          kT2iBN + kHeads * kRows);
}

// One block per (prompt, chunk of `per` position tiles), warp h = head h,
// each warp keeping the online softmax of its head's 8 token rows over the
// chunk. T1 = UK_h q_h^T is formed once a block (t1_factor). A tile's
// scores as in i2t (4 m16 tiles x the n8 token tile, 16 accumulators a
// lane): the head-score term (a KS + KC)_h q_h^T (head_score_term), then
// the rank term P_eff^T T1 with P_eff staged by PeffStage two stages
// ahead; each stage's planes stay resident, for T2 to read back. Then, per
// tile:
//  - the softmax over positions on the C fragments: lane (g, t) holds
//    tokens 2t, 2t + 1 at 8 positions; the row max and sum are reduced in
//    the lane, then over g (xor 4, 8, 16); positions past npos score -inf;
//  - the probabilities leave through shared memory [head][position][row];
//  - on the fp32 units, the value part p (a VS_h) (lane: token, 4 channels;
//    VS rows read as 64-byte head slices) and T2 = p P_eff^T (lane: ranks
//    lane + 32 qq, 4 positions a step as 16-byte plane reads, big + small).
// The chunk's partial (m, l, value part, T2), unnormalised, goes to ws.
__global__ void __launch_bounds__(kThreads, 2)
    t2i_tc_kernel(const float* __restrict__ q, const float* __restrict__ uk, Blocks bl,
                  const float* __restrict__ a, const float* __restrict__ ks,
                  const float* __restrict__ kc, const float* __restrict__ vs,
                  float* __restrict__ ws, int t_tok, int npos, int rtot, int ldt, int per) {
  using St = T2iStage;
  constexpr int NS = kT2iStages, BN = kT2iBN, KR = kI2tKR;
  constexpr int LD = St::kLd, MT = BN / 16, kPair = 2 * St::kPlane;
  extern __shared__ uint4 smem_u4[];
  const int nst = (rtot + KR - 1) / KR;
  uint32_t* ps = reinterpret_cast<uint32_t*>(smem_u4);  // [nst][big, small][KR][LD]
  float* vr = reinterpret_cast<float*>(ps + nst * kPair);  // [NS][KR][BN]
  float* sr = vr + NS * St::kWords;                         // [NS][KR][BN]
  float* psm = vr;                                          // [head][position][row]
  float* t1 = vr + kT2iTileWords;                           // [head][token][ldt]
  float* at = t1 + kHeads * t_tok * ldt;                    // [position] a
  float* csm = at + BN;                                     // [head][row] rescale

  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * per * BN, c1 = min(npos, c0 + per * BN);

  // T1_h = UK_h q_h^T
  const float* qh = q + static_cast<size_t>(b) * t_tok * kD + h * kHd;
  t1_factor(t1, t_tok, ldt, qh, uk + static_cast<size_t>(b) * rtot * kD + h * kHd, t_tok, rtot,
            KR * nst);

  // the running max and sum of tokens 2t, 2t + 1 (the same in all 8 g
  // lanes); T2 of ranks lane + 32 qq; the value part of (token lane / 4,
  // channels 4 (lane % 4)..)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float t2[kRows][4], accv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int tt = 0; tt < kRows; ++tt)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) t2[tt][qq] = 0.f;
  const int my_t = lane / 4, my_c = (lane % 4) * 4;

  for (int n0 = c0; n0 < c1; n0 += BN) {
    __syncthreads();  // T1 is written; the previous tile's probabilities and planes are read
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < nst)
        St::issue(vr + s * St::kWords, sr + s * St::kWords, bl, b, KR * s, n0, npos, rtot, ks);
      cp_async_commit();
    }
    if (threadIdx.x < BN)
      at[threadIdx.x] = n0 + threadIdx.x < npos
                            ? __ldg(a + static_cast<size_t>(b) * npos + n0 + threadIdx.x) : 0.f;

    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

    head_score_term(acc, qh, ks, kc, a, b, n0, npos, t_tok);

    // the rank term; stage s's planes stay at ps + s kPair
    cp_async_wait<NS - 2>();
    St::split(vr, sr, ps);
    for (int s = 0; s < nst; ++s) {
      __syncthreads();  // stage s is in place; stage s - 1's ring slots are free
      if (s + NS - 1 < nst) {
        const int slot = (s + NS - 1) % NS;
        St::issue(vr + slot * St::kWords, sr + slot * St::kWords, bl, b, KR * (s + NS - 1),
                  n0, npos, rtot, ks);
      }
      cp_async_commit();
      const float2 tv =
          g < t_tok ? *reinterpret_cast<const float2*>(t1 + (h * t_tok + g) * ldt + KR * s + 2 * t)
                    : make_float2(0.f, 0.f);
      uint32_t bb[2], bs[2];
      split_tf32(tv.x, bb[0], bs[0]);
      split_tf32(tv.y, bb[1], bs[1]);
      const uint32_t* pb = ps + s * kPair + 2 * t * LD + g;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* p = pb + 16 * mt;
        const uint32_t ab[4] = {p[0], p[8], p[LD], p[LD + 8]};
        const uint32_t as[4] = {p[St::kPlane], p[St::kPlane + 8], p[St::kPlane + LD],
                                p[St::kPlane + LD + 8]};
        mma_tf32x3(acc[mt], ab, as, bb, bs);
      }
      if (s + 1 < nst) {  // this thread's copies of stage s + 1 have landed
        cp_async_wait<NS - 2>();
        const int slot = (s + 1) % NS;
        St::split(vr + slot * St::kWords, sr + slot * St::kWords, ps + (s + 1) * kPair);
      }
    }

    // the online softmax over positions: c0/c1 (position g, tokens 2t,
    // 2t + 1), c2/c3 (position g + 8) of each m16 tile
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (n0 + 16 * mt + 8 * hh + g >= npos) acc[mt][2 * hh] = acc[mt][2 * hh + 1] = -CUDART_INF_F;
        mx[0] = fmaxf(mx[0], acc[mt][2 * hh]);
        mx[1] = fmaxf(mx[1], acc[mt][2 * hh + 1]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
      mx[i] = fmaxf(m[i], mx[i]);       // every tile holds a position below npos
      corr[i] = __expf(m[i] - mx[i]);   // 0 on the first tile
      m[i] = mx[i];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][e] = __expf(acc[mt][e] - m[e & 1]);
        sum[e & 1] += acc[mt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
      l[i] = fmaf(l[i], corr[i], sum[i]);
    }

    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
    float* prow = psm + h * BN * kRows + 2 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(prow + (16 * mt + 8 * hh + g) * kRows) =
            make_float2(acc[mt][2 * hh], acc[mt][2 * hh + 1]);
    if (g == 0) *reinterpret_cast<float2*>(csm + h * kRows + 2 * t) = make_float2(corr[0], corr[1]);
    __syncwarp();  // the head's probabilities and factors are read by its own warp only

    const float4 ca = *reinterpret_cast<const float4*>(csm + h * kRows);
    const float4 cb = *reinterpret_cast<const float4*>(csm + h * kRows + 4);
    const float cr[kRows] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    float my_corr = cr[0];
#pragma unroll
    for (int tt = 1; tt < kRows; ++tt)
      if (tt == my_t) my_corr = cr[tt];
#pragma unroll
    for (int e = 0; e < 4; ++e) accv[e] *= my_corr;
#pragma unroll
    for (int tt = 0; tt < kRows; ++tt)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) t2[tt][qq] *= cr[tt];

    // positions past npos have p = 0 and zero planes
    const int nj = min(BN, npos - n0);
    const float* ph = psm + h * BN * kRows;
    for (int j = 0; j < nj; ++j) {
      const float pa = ph[j * kRows + my_t] * at[j];
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(
          vs + static_cast<size_t>(n0 + j) * kD + h * kHd + my_c));
      accv[0] = fmaf(pa, v4.x, accv[0]);
      accv[1] = fmaf(pa, v4.y, accv[1]);
      accv[2] = fmaf(pa, v4.z, accv[2]);
      accv[3] = fmaf(pa, v4.w, accv[3]);
    }
    for (int j = 0; j < nj; j += 4) {
      float pv[4][kRows];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 pa = *reinterpret_cast<const float4*>(ph + (j + jj) * kRows);
        const float4 pb = *reinterpret_cast<const float4*>(ph + (j + jj) * kRows + 4);
        pv[jj][0] = pa.x; pv[jj][1] = pa.y; pv[jj][2] = pa.z; pv[jj][3] = pa.w;
        pv[jj][4] = pb.x; pv[jj][5] = pb.y; pv[jj][6] = pb.z; pv[jj][7] = pb.w;
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int r = lane + 32 * qq;
        if (r < rtot) {
          const uint32_t* pr = ps + (r / KR) * kPair + (r % KR) * LD + j;
          const uint4 bg = *reinterpret_cast<const uint4*>(pr);
          const uint4 sm = *reinterpret_cast<const uint4*>(pr + St::kPlane);
          const float pe[4] = {__uint_as_float(bg.x) + __uint_as_float(sm.x),
                               __uint_as_float(bg.y) + __uint_as_float(sm.y),
                               __uint_as_float(bg.z) + __uint_as_float(sm.z),
                               __uint_as_float(bg.w) + __uint_as_float(sm.w)};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int tt = 0; tt < kRows; ++tt) t2[tt][qq] = fmaf(pv[jj][tt], pe[jj], t2[tt][qq]);
        }
      }
    }
  }

  // the chunk's partial, unnormalised
  float* rec = ws + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * t2i_record(rtot);
  if (g == 0) {
    *reinterpret_cast<float2*>(rec + h * kRows + 2 * t) = make_float2(m[0], m[1]);
    *reinterpret_cast<float2*>(rec + kHeads * kRows + h * kRows + 2 * t) =
        make_float2(l[0], l[1]);
  }
  *reinterpret_cast<float4*>(rec + kRecAcc + (h * kRows + my_t) * kHd + my_c) =
      make_float4(accv[0], accv[1], accv[2], accv[3]);
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    const int r = lane + 32 * qq;
    if (r < rtot) {
      float* dst = rec + kRecT2 + (h * rtot + r) * kRows;
      *reinterpret_cast<float4*>(dst) = make_float4(t2[0][qq], t2[1][qq], t2[2][qq], t2[3][qq]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(t2[4][qq], t2[5][qq], t2[6][qq], t2[7][qq]);
    }
  }
}

// One block per prompt: the chunks' partials per (head, token row),
// weighted by w = exp(m - M) (0 for m = -inf), M the largest m:
// out = (sum w acc + (sum w T2) UV_h) / sum w l. Only the head-diagonal
// output blocks are written: (B, T, d).
__global__ void __launch_bounds__(kThreads)
    t2i_merge_kernel(const float* __restrict__ ws, const float* __restrict__ uv,
                     float* __restrict__ out, int t_tok, int rtot, int chunks) {
  __shared__ float wt[kHeads * kRows][kT2iChunks];
  __shared__ float linv[kHeads * kRows];
  extern __shared__ float4 smem4[];
  float* t2s = reinterpret_cast<float*>(smem4);  // [head][rank][row]: sum w T2
  const int b = blockIdx.x, rec = t2i_record(rtot);
  const float* wb = ws + static_cast<size_t>(b) * chunks * rec;

  if (threadIdx.x < kHeads * kRows) {
    const int row = threadIdx.x;
    float big = -CUDART_INF_F;
    for (int c = 0; c < chunks; ++c) big = fmaxf(big, wb[c * rec + row]);
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float mc = wb[c * rec + row];
      const float w = mc == -CUDART_INF_F ? 0.f : __expf(mc - big);
      wt[row][c] = w;
      sum = fmaf(w, wb[c * rec + kHeads * kRows + row], sum);
    }
    linv[row] = __fdividef(1.f, sum);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kHeads * rtot * kRows; e += kThreads) {
    const int row = e / (rtot * kRows) * kRows + e % kRows;
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) sum = fmaf(wt[row][c], wb[c * rec + kRecT2 + e], sum);
    t2s[e] = sum;
  }
  __syncthreads();
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my_t = lane / 4, my_c = (lane % 4) * 4, row = h * kRows + my_t;
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    const float w = wt[row][c];
    const float4 v = *reinterpret_cast<const float4*>(wb + c * rec + kRecAcc + row * kHd + my_c);
    o[0] = fmaf(w, v.x, o[0]);
    o[1] = fmaf(w, v.y, o[1]);
    o[2] = fmaf(w, v.z, o[2]);
    o[3] = fmaf(w, v.w, o[3]);
  }
  for (int r = 0; r < rtot; ++r) {
    const float w = t2s[(h * rtot + r) * kRows + my_t];
    const float4 u4 = *reinterpret_cast<const float4*>(
        uv + (static_cast<size_t>(b) * rtot + r) * kD + h * kHd + my_c);
    o[0] = fmaf(w, u4.x, o[0]);
    o[1] = fmaf(w, u4.y, o[1]);
    o[2] = fmaf(w, u4.z, o[2]);
    o[3] = fmaf(w, u4.w, o[3]);
  }
  if (my_t < t_tok) {
    const float inv = linv[row];
    float* orow = out + (static_cast<size_t>(b) * t_tok + my_t) * kD + h * kHd + my_c;
    *reinterpret_cast<float4*>(orow) = make_float4(o[0] * inv, o[1] * inv, o[2] * inv, o[3] * inv);
  }
}

Blocks make_blocks(const float* const* pd, const float* const* s, const int* r,
                   int nblocks) {
  Blocks bl;
  for (int i = 0; i < kMaxBlocks; ++i) {
    bl.pd[i] = i < nblocks ? pd[i] : nullptr;
    bl.s[i] = i < nblocks ? s[i] : nullptr;
    bl.r[i] = i < nblocks ? r[i] : 0;
  }
  bl.n = nblocks;
  return bl;
}

bool blocks_ok(const int* r, int nblocks, int rtot, int max_rank) {
  if (nblocks < 0 || nblocks > kMaxBlocks || rtot > max_rank) return false;
  int sum = 0;
  for (int i = 0; i < nblocks; ++i) sum += r[i];
  return sum == rtot;
}

}  // namespace

extern "C" {

// blocks: nblocks (<= 4) descriptors: pd[i] (b, r[i], n), s[i] (b, n) or
// null, sum(r) == rtot. uc: (b, rtot, c); smat: (n, c); a: (b, n) or null;
// out: (b, 2, n) = (mean, 1/sqrt(var + eps)) over the c channels of
// x = a * S + P_eff^T uc. c must be 256; every pointer 16-byte aligned.
int sam6d_factored_ln_stats(const float* const* pd, const float* const* s,
                            const int* r, int nblocks, const float* uc,
                            const float* smat, const float* a, float* out, int b,
                            int n, int c, int rtot, float eps,
                            cudaStream_t stream) {
  if (!blocks_ok(r, nblocks, rtot, 1 << 20) || c != kLnC)
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl = make_blocks(pd, s, r, nblocks);
  const cudaError_t err =
      cudaFuncSetAttribute(ln_stats_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kLnSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kLnBM - 1) / kLnBM, b);
  ln_stats_tc_kernel<<<grid, kLnThreads, kLnSmemBytes, stream>>>(bl, uc, smat, a, out, n,
                                                                 rtot, eps);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the workspace sam6d_factored_t2i_attention takes for each
// prompt: one partial per position chunk.
int sam6d_factored_t2i_workspace(int n, int rtot) {
  return t2i_split(n).chunks * t2i_record(rtot);
}

// q: (b, t, 128) pre-scaled token queries, 8 heads of 16; uk, uv: (b, rtot,
// 128); a: (b, n); ks, kc, vs: (n, 128); ws: b *
// sam6d_factored_t2i_workspace(n, rtot) floats of scratch. out: (b, t,
// 128), head h's attention output at channels h*16 (the head-diagonal
// blocks), without the value bias. t <= 8, 1 <= rtot <= 128, every pointer
// 16-byte aligned. Two launches: the chunks' partials, then their merge.
int sam6d_factored_t2i_attention(const float* q, const float* uk, const float* uv,
                                 const float* const* pd, const float* const* s,
                                 const int* r, int nblocks, const float* a,
                                 const float* ks, const float* kc, const float* vs,
                                 float* ws, float* out, int b, int t, int n, int rtot,
                                 cudaStream_t stream) {
  if (!blocks_ok(r, nblocks, rtot, kMaxRank) || rtot < 1 || t < 1 || t > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl = make_blocks(pd, s, r, nblocks);
  const T2iSplit sp = t2i_split(n);
  const int ldt = i2t_t1_ld(rtot);
  const size_t bytes = t2i_smem_bytes(t, rtot, ldt);
  cudaError_t err = cudaFuncSetAttribute(
      t2i_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  t2i_tc_kernel<<<dim3(sp.chunks, b), kThreads, bytes, stream>>>(q, uk, bl, a, ks, kc, vs, ws,
                                                                 t, n, rtot, ldt, sp.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  t2i_merge_kernel<<<b, kThreads, sizeof(float) * kHeads * rtot * kRows, stream>>>(
      ws, uv, out, t, rtot, sp.chunks);
  return static_cast<int>(cudaGetLastError());
}

// kt: (b, t, 128) token keys, 8 heads of 16; uq: (b, rtot, 128) or null
// when rtot == 0; a: (b, n) or null; qs, qc: (n, 128). out: (b, 8t + 1, n):
// row h*t + tt is the softmax over head h's t tokens at every position, the
// last row is ones. t <= 8, rtot <= 128, every pointer 16-byte aligned.
int sam6d_factored_i2t_scores(const float* kt, const float* uq,
                              const float* const* pd, const float* const* s,
                              const int* r, int nblocks, const float* a,
                              const float* qs, const float* qc, float* out, int b,
                              int t, int n, int rtot, cudaStream_t stream) {
  if (!blocks_ok(r, nblocks, rtot, kMaxRank) || t < 1 || t > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Blocks bl = make_blocks(pd, s, r, nblocks);
  const int ldt = i2t_t1_ld(rtot);
  const size_t bytes = kI2tTileBytes + sizeof(float) * kHeads * kRows * ldt;
  const cudaError_t err = cudaFuncSetAttribute(
      i2t_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kI2tBN - 1) / kI2tBN, b);
  i2t_tc_kernel<<<grid, kThreads, bytes, stream>>>(kt, uq, bl, a, qs, qc, out, t, n, rtot,
                                                   ldt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
