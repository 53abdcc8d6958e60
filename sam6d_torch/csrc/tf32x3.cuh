// Three-pass TF32 on Hopper's tensor cores, and the attention core built on
// it (K5, K8, K9; K1's fp32 entry runs on tf32_wgmma.cuh): fp32-accurate
// products at up to 495/3 = 165 TFLOP/s (H100 SXM dense TF32 over three
// passes), where the fp32 FMA units stop at 67 TFLOP/s.
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
#include <type_traits>

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
// Softmax attention of one (sample, head) block of 16 * WARPS query rows,
// each warp owning 16 rows. Each kernel builds an Operands record for its
// (sample, head): the q/k/v/out base pointers, their row strides (the head
// dim contiguous), nq, nk and the true head dim, so one core serves a fused
// (B, N, 3C) qkv (K5: all three at row stride 3C, out at C) and
// head-major (B, H, N, hd) operands of any strides (K8, K9).
//  - S = q K^T by three-pass TF32 into C fragments in registers; keys
//    past nk get -inf;
//  - online softmax in registers: row max and sum by quad shuffles, the
//    running max per row, each lane's partial sum, the rescale applied to
//    the output fragments; scores never reach shared memory;
//  - O += P V by three-pass TF32, P's C fragments reused as A fragments
//    (the key order inside each 8-key step permuted on the V side); each
//    tile's P V is summed from zero on the tensor cores and added to O on
//    the fp32 units;
//  - out = O / max(l, 1e-30). Key tiles wholly past nk are skipped, and a
//    warp whose rows all lie past nq only helps load.
// Two ways to stage q, K and V in shared memory (the Staging option):
//  - kSplitPerFragment (K5): fp32 tiles. K and V tiles of BK keys
//    stream through two stages with 16-byte cp.async (rows past nk zero
//    filled), rows padded to HD + 4 floats so that both B-fragment reads
//    are conflict-free; the block's q rows sit there pre-scaled; every warp
//    splits every fragment element it reads, on every tile. Needs hd == HD
//    and 16-byte aligned rows.
//  - kSplitOnce (K8, K9): TF32 big/small pairs, each element's big and
//    small side by side. The block's q rows are loaded, scaled and split
//    once; each K/V tile is split once by the threads that load it: the
//    next tile's ld.global into registers while the current one computes,
//    then a barrier, the split and st.shared of the pairs, a barrier. V is
//    stored transposed (V^T, a row per head-dim column). With the k index
//    of every 8-wide step of q K^T taken as (2t, 2t + 1) for (t, t + 4), a
//    q A fragment is two 16-byte loads, and every K or V B fragment one
//    16-byte load, with no arithmetic; rows of 2X + 16 words keep the 8
//    lanes of each quarter-warp on 8 distinct 16-byte bank groups. P is
//    still split in registers, 16 elements a lane a tile at BK 32. Takes
//    any hd <= HD (zero-padded columns, never written) and any alignment
//    (4-byte loads and stores where 16 or 8 bytes do not fit). The pair
//    layout is the one a three-pass wgmma would read, since wgmma cannot
//    split on the fly.
// On an H100 the two stagings run about level at one shape (PERF.md: split
// once 3-4% faster at 1025 tokens, 6-14% slower at 257, where its 128-row
// blocks leave a one-row block per head): at 16 warps an SM both wait on
// dependent HMMAs and barriers more than on the split's ALU work, and
// splitting once doubles the shared bytes each fragment read moves.
enum class Staging { kSplitPerFragment, kSplitOnce };

struct Operands {
  const float* q;            // the (sample, head)'s row 0 of q, k, v and out
  const float* k;
  const float* v;
  float* out;
  long long sq, sk, sv, so;  // row strides in elements
  int nq, nk;                // query rows, keys
  int hd;                    // true head dim, <= the core's HD
};

// fp32 row of kSplitPerFragment: HD + 4 floats
template <int HD>
__host__ __device__ constexpr int smem_row() { return HD + 4; }

// pair row of kSplitOnce: X elements as 2X words and 16 words of padding,
// 16 (mod 32) words, so a 16-byte unit index is 4 (mod 8) per row
template <int X>
__host__ __device__ constexpr int pair_row() { return 2 * X + 16; }

// kSplitPerFragment: the block's q rows, then two stages of K and V tiles.
// kSplitOnce: the block's q pairs, one K pair tile, one V^T pair tile.
template <int HD, int WARPS, int BK, Staging S = Staging::kSplitPerFragment>
__host__ __device__ constexpr size_t core_smem_bytes() {
  return S == Staging::kSplitPerFragment
             ? sizeof(float) * (16 * WARPS + 2 * 2 * BK) * smem_row<HD>()
             : sizeof(uint32_t) * ((16 * WARPS + BK) * pair_row<HD>() + HD * pair_row<BK>());
}

// Two elements as {big, small, big, small}.
__device__ __forceinline__ uint4 split_pair2(float a, float b) {
  uint4 w;
  split_tf32(a, w.x, w.y);
  split_tf32(b, w.z, w.w);
  return w;
}

template <int HD, int WARPS, int BK, Staging S>
__device__ __forceinline__ void attention_rows(const Operands& op, float* smem, int q0,
                                               float scale) {
  constexpr bool kOnce = S == Staging::kSplitOnce;
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(BK % 8 == 0, "key tile must be a multiple of 8");
  static_assert(!kOnce || BK % 16 == 0, "split-once key tiles are multiples of 16");
  constexpr int LD = smem_row<HD>();
  constexpr int LDP = pair_row<HD>();  // words a q or K pair row
  constexpr int LDV = pair_row<BK>();  // words a V^T pair row
  constexpr int KS = HD / 8;           // k8 steps of q k^T, n8 tiles of P V
  constexpr int NT = BK / 8;           // n8 tiles of q k^T, k8 steps of P V
  constexpr int kThreads = WARPS * 32;
  constexpr int kRows = 16 * WARPS;
  constexpr int kChunks = BK * HD / 4;  // 16-byte chunks of K (or V) a tile
  constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = op.nq, nk_all = op.nk, hd = op.hd;
  const int r0 = q0 + warp * 16;      // the warp's first row
  const bool live = r0 < nq;
  const int n_tiles = (nk_all + BK - 1) / BK;

  float* qs = smem;                         // [kRows][LD]
  float* ks = smem + kRows * LD;            // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;             // [2][BK][LD]
  uint32_t* qp = reinterpret_cast<uint32_t*>(smem);  // [kRows][LDP]
  uint32_t* kp = qp + kRows * LDP;                   // [BK][LDP]
  uint32_t* vp = kp + BK * LDP;                      // [HD][LDV], V^T

  // kSplitPerFragment: K and V tile k0 into a stage with cp.async
  auto load_tile = [&](int k0, int stage) {
    float* kd = ks + stage * BK * LD;
    float* vd = vs + stage * BK * LD;
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
      const bool ok = k0 + j < nk_all;
      const long long r = ok ? k0 + j : 0;
      cp_async16(kd + j * LD + d, op.k + r * op.sk + d, ok);
      cp_async16(vd + j * LD + d, op.v + r * op.sv + d, ok);
    }
  };

  // kSplitOnce: 4 columns d.. of row r (zeros past hd and for rows past n),
  // one 16-byte load where the operand's alignment allows it
  const bool vec = ((reinterpret_cast<uintptr_t>(op.q) | reinterpret_cast<uintptr_t>(op.k) |
                     reinterpret_cast<uintptr_t>(op.v)) & 15) == 0 &&
                   ((op.sq | op.sk | op.sv) & 3) == 0;
  auto load4 = [&](const float* base, long long stride, int r, int n, int d) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) {
      const float* p = base + r * stride + d;
      if (vec && d + 4 <= hd) {
        x = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        if (d < hd) x.x = __ldg(p);
        if (d + 1 < hd) x.y = __ldg(p + 1);
        if (d + 2 < hd) x.z = __ldg(p + 2);
        if (d + 3 < hd) x.w = __ldg(p + 3);
      }
    }
    return x;
  };
  // the next tile in registers: K chunk e is key e / (HD/4), columns 4 (e %
  // (HD/4)).. (a warp reads whole rows); V chunk e is key e % BK, columns
  // 4 (e / BK).. (a half-warp's 16 keys make conflict-free V^T stores)
  float4 kr[kPerThread], vr[kPerThread];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kChunks) {
        kr[i] = load4(op.k, op.sk, k0 + e / (HD / 4), nk_all, 4 * (e % (HD / 4)));
        vr[i] = load4(op.v, op.sv, k0 + e % BK, nk_all, 4 * (e / BK));
      }
    }
  };
  auto store_pairs = [&]() {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kChunks) {
        uint4* kd = reinterpret_cast<uint4*>(kp + (e / (HD / 4)) * LDP + 8 * (e % (HD / 4)));
        kd[0] = split_pair2(kr[i].x, kr[i].y);
        kd[1] = split_pair2(kr[i].z, kr[i].w);
        uint32_t* vd = vp + 4 * (e / BK) * LDV + 2 * (e % BK);
        const float x[4] = {vr[i].x, vr[i].y, vr[i].z, vr[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint2 w;
          split_tf32(x[c], w.x, w.y);
          *reinterpret_cast<uint2*>(vd + c * LDV) = w;
        }
      }
    }
  };

  if constexpr (kOnce) {
    fetch(0);
    // the block's q rows, scaled (the fp32 product q * scale the plain
    // version forms) and split; rows past nq as zeros
    for (int e = threadIdx.x; e < kRows * (HD / 4); e += kThreads) {
      const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
      const float4 x = load4(op.q, op.sq, q0 + r, nq, d);
      uint4* qd = reinterpret_cast<uint4*>(qp + r * LDP + 2 * d);
      qd[0] = split_pair2(x.x * scale, x.y * scale);
      qd[1] = split_pair2(x.z * scale, x.w * scale);
    }
    store_pairs();
    __syncthreads();
  } else {
    load_tile(0, 0);
    cp_async_commit();
    // The block's q rows go to shared memory scaled (rows past nq as
    // zeros), the same fp32 product q * scale the plain version forms, and
    // are read per k8 step as A fragments: a0 (g, t), a1 (g+8, t), a2 (g,
    // t+4), a3 (g+8, t+4).
    for (int e = threadIdx.x; e < kRows * (HD / 4); e += kThreads) {
      const int r = e / (HD / 4), d = 4 * (e % (HD / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < nq)
        x = *reinterpret_cast<const float4*>(op.q + (q0 + r) * op.sq + d);
      *reinterpret_cast<float4*>(qs + r * LD + d) =
          make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }

  // A fragment of the warp's q rows for k8 step kk
  auto q_frag = [&](int kk, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    if constexpr (kOnce) {
      const uint32_t* qw = qp + (warp * 16 + g) * LDP + 16 * kk + 4 * t;
      const uint4 lo = *reinterpret_cast<const uint4*>(qw);
      const uint4 hi = *reinterpret_cast<const uint4*>(qw + 8 * LDP);
      ab[0] = lo.x; ab[1] = hi.x; ab[2] = lo.z; ab[3] = hi.z;
      as[0] = lo.y; as[1] = hi.y; as[2] = lo.w; as[3] = hi.w;
    } else {
      const float* qw = qs + warp * 16 * LD;
      const float x[4] = {qw[g * LD + 8 * kk + t], qw[(g + 8) * LD + 8 * kk + t],
                          qw[g * LD + 8 * kk + t + 4], qw[(g + 8) * LD + 8 * kk + t + 4]};
      split_a(x, ab, as);
    }
  };
  // B fragment of K^T for n8 tile nt, k8 step kk
  auto k_frag = [&](int stage, int nt, int kk, uint32_t (&bb)[2], uint32_t (&bs)[2]) {
    if constexpr (kOnce) {
      const uint4 w = *reinterpret_cast<const uint4*>(kp + (8 * nt + g) * LDP + 16 * kk + 4 * t);
      bb[0] = w.x; bs[0] = w.y; bb[1] = w.z; bs[1] = w.w;
    } else {
      load_b_nk(ks + stage * BK * LD + 8 * nt * LD + 8 * kk, LD, g, t, bb, bs);
    }
  };
  // B fragment of V for k8 step nt, n8 tile nd (keys 2t, 2t + 1)
  auto v_frag = [&](int stage, int nt, int nd, uint32_t (&bb)[2], uint32_t (&bs)[2]) {
    if constexpr (kOnce) {
      const uint4 w = *reinterpret_cast<const uint4*>(vp + (8 * nd + g) * LDV + 16 * nt + 4 * t);
      bb[0] = w.x; bs[0] = w.y; bb[1] = w.z; bs[1] = w.w;
    } else {
      load_b_kn_paired(vs + stage * BK * LD + 8 * nt * LD + 8 * nd, LD, g, t, bb, bs);
    }
  };

  float o[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // running max, rows g, g+8
  float l_lo = 0.f, l_hi = 0.f;                      // this lane's partial sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const int stage = kOnce ? 0 : tile & 1;
    if constexpr (kOnce) {
      if (tile + 1 < n_tiles) fetch(k0 + BK);  // lands while this tile computes
    } else {
      if (tile + 1 < n_tiles) load_tile(k0 + BK, (tile + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }

    if (live) {
      const int nk = min(BK, nk_all - k0);

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4];
        q_frag(kk, ab, as);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt < nk) {
            uint32_t bb[2], bs[2];
            k_frag(stage, nt, kk, bb, bs);
            mma_tf32x3(s[nt], ab, as, bb, bs);
          }
        }
      }
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
      // not round to nearest) runs over one tile, not over all nk keys
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
            v_frag(stage, nt, nd, bb, bs);
            mma_tf32x3(acc, pb[nt], ps[nt], bb, bs);
          }
        }
        o[nd][0] = fmaf(o[nd][0], corr_lo, acc[0]);
        o[nd][1] = fmaf(o[nd][1], corr_lo, acc[1]);
        o[nd][2] = fmaf(o[nd][2], corr_hi, acc[2]);
        o[nd][3] = fmaf(o[nd][3], corr_hi, acc[3]);
      }
    }
    if constexpr (kOnce) {
      if (tile + 1 < n_tiles) {
        __syncthreads();  // the pairs just read are replaced by the next tile's
        store_pairs();
        __syncthreads();
      }
    } else {
      __syncthreads();  // the stage just read is refilled next iteration
    }
  }

  if (!live) return;
  // the row maximum contributes exp(0) = 1 to l, so l >= 1 for every row
  // and the clamp (the K5 and K8 TPU kernels') never acts where the plain
  // sum is the contract (K9's)
  const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
  if constexpr (!kOnce) {
    float* ob = op.out + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      if (r0 + g < nq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(r0 + g) * op.so + 8 * nd) =
            make_float2(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
      if (r0 + g + 8 < nq)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(r0 + g + 8) * op.so + 8 * nd) =
            make_float2(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
    }
  } else {
    // 8-byte stores where the output allows them; columns past hd are
    // never written
    const bool pair_ok = ((reinterpret_cast<uintptr_t>(op.out) | (op.so * 4)) & 7) == 0;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      const int col = 8 * nd + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= nq) continue;
        const float inv = half ? inv_hi : inv_lo;
        float* p = op.out + row * op.so + col;
        const float x0 = o[nd][2 * half] * inv, x1 = o[nd][2 * half + 1] * inv;
        if (pair_ok && col + 1 < hd) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          if (col < hd) p[0] = x0;
          if (col + 1 < hd) p[1] = x1;
        }
      }
    }
  }
}

}  // namespace sam6d
