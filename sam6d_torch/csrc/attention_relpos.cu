// SAM ViTDet attention with the decomposed relative-position bias, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel
// sam6d_tpu/kernels/flash_attention.py::flash_attention_relpos (through
// _fused_attention / _fused_kernel). qkv is (B, N, 3C) laid out
// [q | k | v] on the channel axis with heads contiguous; N = gh * gw tokens
// in row-major order. For head h of sample b the kernel computes
//   out[n] = sum_m softmax_m(scale q[n].k[m] + (rel_h[n, m / gw]
//                            + rel_w[n, m % gw])) v[m]
// with rel_h[n, kh] = q[n] . rel_pos_h[row(n) - kh + gh - 1] and rel_w[n,
// kw] = q[n] . rel_pos_w[col(n) - kw + gw - 1] (unscaled q; reference
// add_decomposed_rel_pos), the thin decomposed-bias tables, which the
// kernel forms itself for its rows. The output (B, N, C) holds head h at
// channels h*HD. Scores, the running max and sum, and the accumulator are
// fp32; the denominator is clamped at 1e-30 as in the TPU kernel. Every
// token attends to every key of its window, zero pad tokens included (the
// reference does not mask them); only keys past N are masked.
//
// What bounds it on an H100 SXM: a global block (B=1, 16 heads, N=4096, hd
// 80) is 4*16*4096^2*80 = 85.9 GFLOP on 84 MB (qkv in, output out), a
// windowed block (25 windows of 196 tokens) 4.9 GFLOP on 100 MB. On the fp32
// FMA units (67 TFLOP/s) that is 1.28 ms and 73 us, operations; on the
// tensor cores in three-pass TF32 (495/3 = 165 TFLOP/s) 0.52 ms and 30 us,
// where the windowed block's bytes take 30 us too (3.35 TB/s).
//
// Design of the fp32 entry (sam6d_flash_attention_relpos): three-pass TF32
// on wgmma (tf32_wgmma.cuh). A pre-pass splits K (times the scale), V and
// the rel-pos rows once into big/small tf32 planes in a workspace, V
// transposed (tf32 wgmma takes both operands K-major); the attention kernel
// streams their tiles by TMA bulk copies through a ring in shared memory to
// two consumer warpgroups of 64 query rows each, which split their q rows
// once into registers and form their rows of the two tables as q R^T on the
// tensor cores into shared memory, so no table reaches global memory
// (namespace tf32 below).
//
// The bf16 entry (sam6d_flash_attention_relpos_bf16) is the wgmma core of
// bf16_wgmma.cuh (wgmma.mma_async for Q K^T and P V with fp32
// accumulation, K/V tiles by TMA on mbarriers; fp32 scores and softmax, p
// rounded to bf16) with the same tables, formed in fp32 from the bf16 q
// rows and rel-pos rows and rounded to bf16 as the TPU wrapper's cast does
// (RelPosBiasBf16 below); q enters as bf16(q * bf16(scale)), the TPU
// kernel's q_aug. On an H100 SXM's dense bf16 rate (989 TFLOP/s) a global
// block's products take 0.087 ms and its bytes (42 MB) 0.013 ms:
// operations; its tables are 671 M fp32 FMAs more (~23 us on the FMA
// units). A block is two warpgroups of 64 rows: a windowed (window, head)'s
// 196 keys stay resident in the ring and one block takes all four row
// tiles (attention_relpos_window_kernel, its own design below); a global
// one's 4096 stream through two stages, one block a 128 rows
// (attention_relpos_wgmma_kernel on the core's attend(), tables by
// RelPosBiasBf16); 100-115 KB of shared memory and at most 128 registers
// let two blocks share an SM.
#include "bf16_wgmma.cuh"
#include "tf32_wgmma.cuh"
#include "tf32x3.cuh"

namespace {

// shared memory a block of the bf16 entry may take (an H100's 227 KB)
constexpr size_t kMaxSmemBf16 = 232448;

// The bf16 entry's tables: each entry the fp32 dot product of a bf16 q row
// (unscaled) and a bf16 rel-pos row, rounded to bf16, as the TPU wrapper
// casts its einsum's tables to the compute dtype before they enter the
// augmented product (flash_attention.py:337-372); they are added to the
// fp32 scores. Each entry sums the even channels in one fp32 chain and the
// odd ones in another, channel by channel, as bf16_rel_pos_tables mirrors.
// A warpgroup forms the rows of its 64-row tile from its unscaled q tile
// while the first K/V tiles are in flight: warps 0-1 rel_h, warps 2-3
// rel_w, a lane a q row (in registers as bf16 pairs). A warp walks the
// rel-pos rows m its lanes need, two a step, all lanes on the same m: a few
// lanes unpack rows m and m + 1 to fp32 into the warp's scratch (loaded a
// step ahead), every lane reads them back as 16-byte broadcasts and runs
// the two entries' four FMA chains side by side, and each lane whose row
// uses m adds its entry j = (its grid row or column) - m + g - 1. (Lanes
// on consecutive rows of one table column read 32 rows of rel_pos_w an
// instruction at the global shape and unpack both operands of every
// product: the tables took ~168 of that kernel's ~445 us; with one staged
// row a step, ~130 of ~415; PERF.md.) The tables hold bf16
// (each entry is a bf16 value); rel_h rows are padded by one entry, rel_w
// rows by two, so a lane's pair of neighbouring rel_w entries is one
// aligned 32-bit word; a block's two warpgroups of the global shape take
// 33 KB, and two blocks share an SM.
template <int HD>
struct RelPosBiasBf16 {
  static constexpr bool kPrescale = true;
  // the warpgroup's rows, in shared memory (mutable: RelPosBiasBf16Global
  // points them at the current row tile's rows in global memory)
  mutable __nv_bfloat16* tab_h;  // [64][gh + 1]
  mutable __nv_bfloat16* tab_w;  // [64][gw + 2]
  int gh, gw;
  int row;               // the lane's row g in the warpgroup's tile
  const __nv_bfloat16* pos_h;  // rel_pos_h (2 gh - 1, HD)
  const __nv_bfloat16* pos_w;  // rel_pos_w (2 gw - 1, HD)
  float* scratch;              // [4 warps][2][HD]: the warpgroup's staged rel-pos rows

  __device__ __forceinline__ void prepare(const unsigned char* qs, int q0, int n) const {
    namespace wa = sam6d::wgattn;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const bool is_w = tid >= 64;
    const int r = tid % 64, tok = q0 + r;
    const bool live = tok < n;
    const int g = is_w ? gw : gh;
    const int pos = is_w ? tok % gw : tok / gw;  // the row's grid column or row
    const __nv_bfloat16* rel = is_w ? pos_w : pos_h;
    __nv_bfloat16* tab = is_w ? tab_w + r * (gw + 2) : tab_h + r * (gh + 1);
    float* rows_f = scratch + (tid / 32) * 2 * HD;  // the warp's rel-pos rows m, m + 1 in fp32
    uint32_t qw[HD / 2];  // the lane's q row as bf16 pairs
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const uint4 a = *reinterpret_cast<const uint4*>(qs + wa::chunk_offset<HD>(r, c));
      qw[4 * c] = a.x;
      qw[4 * c + 1] = a.y;
      qw[4 * c + 2] = a.z;
      qw[4 * c + 3] = a.w;
    }
    // entry j of the row uses rel-pos row m = pos - j + g - 1: m in [pos, pos + g)
    const int m_lo = __reduce_min_sync(0xffffffffu, live ? pos : 1 << 30);
    const int m_hi = __reduce_max_sync(0xffffffffu, live ? pos + g - 1 : -1);
    // stager lanes: 8 channels (chunk sc) of row m + sr
    const bool stager = lane < HD / 4;
    const int sr = lane / (HD / 8), sc = lane % (HD / 8);
    auto fetch = [&](int m) {
      return m <= m_hi ? __ldg(reinterpret_cast<const uint4*>(rel + m * HD) + sc)
                       : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 next = stager ? fetch(m_lo + sr) : make_uint4(0u, 0u, 0u, 0u);
    for (int m = m_lo; m <= m_hi; m += 2) {
      if (stager) {
        float* dst = rows_f + sr * HD + 8 * sc;
        *reinterpret_cast<float4*>(dst) =
            make_float4(wa::lo_of(next.x), wa::hi_of(next.x), wa::lo_of(next.y), wa::hi_of(next.y));
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(wa::lo_of(next.z), wa::hi_of(next.z), wa::lo_of(next.w), wa::hi_of(next.w));
        next = fetch(m + 2 + sr);
      }
      __syncwarp();
      float2 p0 = make_float2(0.f, 0.f), p1 = make_float2(0.f, 0.f);
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(rows_f + d);
        const float4 b = *reinterpret_cast<const float4*>(rows_f + HD + d);
        const float x0 = wa::lo_of(qw[d / 2]), x1 = wa::hi_of(qw[d / 2]);
        const float x2 = wa::lo_of(qw[d / 2 + 1]), x3 = wa::hi_of(qw[d / 2 + 1]);
        p0.x = fmaf(x0, a.x, p0.x);
        p0.y = fmaf(x1, a.y, p0.y);
        p1.x = fmaf(x0, b.x, p1.x);
        p1.y = fmaf(x1, b.y, p1.y);
        p0.x = fmaf(x2, a.z, p0.x);
        p0.y = fmaf(x3, a.w, p0.y);
        p1.x = fmaf(x2, b.z, p1.x);
        p1.y = fmaf(x3, b.w, p1.y);
      }
      __syncwarp();  // the rows are rewritten next step
      const int j = pos - m + g - 1;  // row m's entry; row m + 1's is j - 1
      if (live && j >= 0 && j < g) tab[j] = __float2bfloat16_rn(p0.x + p0.y);
      if (live && m + 1 <= m_hi && j >= 1 && j - 1 < g) tab[j - 1] = __float2bfloat16_rn(p1.x + p1.y);
    }
    if (!live)  // rows past n: finite entries, never read into an output
      for (int j = 0; j < g; ++j) tab[j] = __float2bfloat16_rn(0.f);
  }

  template <int NT>
  __device__ __forceinline__ void add(float (&s)[NT][4], int k0, int nk, int t) const {
    const __nv_bfloat16* rh_lo = tab_h + row * (gh + 1);
    const __nv_bfloat16* rh_hi = rh_lo + 8 * (gh + 1);
    const __nv_bfloat16* rw_lo = tab_w + row * (gw + 2);
    const __nv_bfloat16* rw_hi = rw_lo + 8 * (gw + 2);
    if (NT == 8 && gw == sam6d::wgattn::kTileKeys) {
      // a key tile is one grid row (SAM's global blocks): rel_h is one entry
      // a row, and the lane's rel_w entries (keys 8 nt + 2 t, + 1) one word
      const float h_lo = __bfloat162float(rh_lo[k0 / gw]), h_hi = __bfloat162float(rh_hi[k0 / gw]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t w_lo = *reinterpret_cast<const uint32_t*>(rw_lo + 8 * nt + 2 * t);
        const uint32_t w_hi = *reinterpret_cast<const uint32_t*>(rw_hi + 8 * nt + 2 * t);
        s[nt][0] += h_lo + sam6d::wgattn::lo_of(w_lo);
        s[nt][1] += h_lo + sam6d::wgattn::hi_of(w_lo);
        s[nt][2] += h_hi + sam6d::wgattn::lo_of(w_hi);
        s[nt][3] += h_hi + sam6d::wgattn::hi_of(w_hi);
      }
      return;
    }
    int kr = (k0 + 2 * t) / gw;
    int kc = (k0 + 2 * t) - kr * gw;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = 8 * nt + 2 * t;  // this lane's first key in the tile
      int kr1 = kr, kc1 = kc + 1;
      if (kc1 == gw) {
        kc1 = 0;
        ++kr1;
      }
      if (j < nk) {
        s[nt][0] += __bfloat162float(rh_lo[kr]) + __bfloat162float(rw_lo[kc]);
        s[nt][2] += __bfloat162float(rh_hi[kr]) + __bfloat162float(rw_hi[kc]);
      }
      if (j + 1 < nk) {
        s[nt][1] += __bfloat162float(rh_lo[kr1]) + __bfloat162float(rw_lo[kc1]);
        s[nt][3] += __bfloat162float(rh_hi[kr1]) + __bfloat162float(rw_hi[kc1]);
      }
      kc += 8;
      while (kc >= gw) {
        kc -= gw;
        ++kr;
      }
    }
  }
};

// ------------------------------------------------- the fp32 entry (tf32 wgmma)
//
// Two launches. split_kv_kernel splits K (times the softmax scale) and V
// once into big/small tf32 planes in a workspace, already in the
// shared-memory image the attention kernel reads (tf32_wgmma.cuh's 32-byte
// swizzled parts): a tile of BK = 40 keys (SAM's 196-key windows take 5
// tiles, its 4096-key grids 103) is [K big][K small][V^T big][V^T small], K
// as its keys' rows of HD, V transposed (HD rows of its keys, in the
// permuted order of P's fragments), keys past n zero; after every (sample,
// head)'s tiles, rel_pos_h's and rel_pos_w's rows split the same way, BK
// rows a tile. A thread issues all its loads before
// its first store. attention_kernel then takes two consumer warpgroups of 64
// query rows of one (sample, head) and a producer warpgroup, one thread of
// which streams the rel-pos tiles and then the K and V^T tiles in turn
// through a ring of operand buffers (4 deep where shared memory allows, else
// 3 or 2), one bulk copy (cp.async.bulk, TMA) a tile on full/empty
// mbarriers; the producer gives its registers to the consumers (setmaxnreg
// 24 / 240). A consumer warpgroup:
//  - loads its q rows (fp32) as wgmma A fragments and splits them once into
//    big and small fragments, which stay in registers;
//  - forms its rows of both tables on the tensor cores: G = q R^T over the
//    rel-pos rows in three passes, each of its entries stored where the table
//    takes it (rel_h[r][j] = q_r . rel_pos_h[row(r) - j + gh - 1], rel_w
//    likewise), fp32, in shared memory;
//  - per key tile: S = Q K^T in three passes of m64n{BK}k8 (q small x K big,
//    q big x K small, q big x K big, HD / 8 k-steps each, q from registers,
//    K from the ring); the bias (rel_h + rel_w) added to
//    the fragments, keys past n masked; the online softmax in fp32 (ex2 of
//    the score times log2 e); P split into big and small A fragments in
//    registers; the tile's P V summed from zero in three passes of
//    m64n{HD}k8 (its first wgmma with scale-d 0) and added to O on the fp32
//    units as O * alpha + O_tile, so the tensor cores' truncating
//    accumulation never runs across tiles;
//  - out = O / max(l, 1e-30). A warp with no row below n skips its softmax
//    (p = 0).
// What bounds it on an H100 SXM: three-pass TF32 (495 / 3 TFLOP/s) puts a
// global block's 85.9 GFLOP at 0.52 ms. At SAM's global grid a block holds
// the ring (4 x 20 KB at hd 80) and its fp32 tables (65 KB), one block an
// SM. An m64n32k8 pass with both operands in shared memory reads 3 KB for
// 16 cycles of tensor work, past the 128 bytes a cycle shared memory gives;
// with q from registers it reads 1 KB.
// The tables took a quarter of the global launch and 43% of the windowed
// one as dot products on the fp32 units (bound by their loads), a few per
// cent as products on the tensor cores. Giving the producer's registers to
// the consumers removed the spills that q's fragments caused at 168
// registers; taking turns on the tensor cores (named barriers) and issuing
// the next tile's Q K^T before this tile's P V measured no faster (PERF.md).
namespace tf32 {
namespace wa = sam6d::wgattn;
namespace tw = sam6d::tf32wg;

constexpr int kRows = 64;                        // query rows of a warpgroup's tile
constexpr int kConsumers = 2;                    // consumer warpgroups of a block
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
// registers a thread: the producer warpgroup gives up what the consumers take
// (setmaxnreg; the launch allots 65536 / 384 = 168)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr size_t kMaxSmem = 232448;              // an H100's 227 KB a block

// keys of a K/V tile (and rel-pos rows of a rel-pos tile): 40 keys pad SAM's
// 196-key windows to 200 and its 4096-key grids to 4120, and measured no
// slower than 32 at either (faster at 4096: fewer tiles' softmax and waits;
// PERF.md)
constexpr int BK = 40;
__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
// tiles of a table's 2 g - 1 rel-pos rows
__host__ __device__ constexpr int rel_tiles(int g) { return (2 * g - 1 + BK - 1) / BK; }
// bytes of a tile (two planes of BK rows of HD floats; a K/V tile is two)
template <int HD>
__host__ __device__ constexpr size_t tile_bytes() { return 8ull * BK * HD; }
// workspace bytes of one (sample, head): its K and V tiles
template <int HD>
__host__ __device__ constexpr size_t head_bytes(int n) {
  return 2 * tile_bytes<HD>() * (round_up(n, BK) / BK);
}
template <int HD>
__host__ __device__ constexpr size_t workspace_bytes(int b, int n, int heads, int gh, int gw) {
  return head_bytes<HD>(n) * b * heads +
         tile_bytes<HD>() * (rel_tiles(gh) + rel_tiles(gw));
}

// The attention kernel's shared memory: the ring (nbuf tiles: a rel-pos, K
// or V^T tile's big plane then its small one), each warpgroup's table rows
// (rel_h [64][gh + 1], rel_w [64][gw + 1], fp32), the full and empty
// barriers.
template <int HD>
struct Layout {
  size_t tabs, bars, total;
  __host__ __device__ Layout(int nbuf, int gh, int gw) {
    tabs = static_cast<size_t>(nbuf) * tile_bytes<HD>();
    bars = (tabs + sizeof(float) * kConsumers * kRows * (gh + gw + 2) + 15) / 16 * 16;
    total = bars + 2 * sizeof(uint64_t) * nbuf;
  }
};
// the deepest ring (4, 3 or 2 tiles) that fits a block's shared memory; 0 if none
template <int HD>
int ring_depth(int gh, int gw) {
  for (int d = 4; d >= 2; --d)
    if (Layout<HD>(d, gh, gw).total <= kMaxSmem) return d;
  return 0;
}

// Row r (of `rows`) of a tile's two planes from 8 floats: part p's 32-byte row
__device__ __forceinline__ void store_split_row(unsigned char* big, int plane, int r, int p,
                                                int rows, const float4& lo, const float4& hi) {
  uint4 b0, s0, b1, s1;
  tw::split4(lo, b0, s0);
  tw::split4(hi, b1, s1);
  const int o0 = tw::part32_offset(r, 8 * p, rows), o1 = tw::part32_offset(r, 8 * p + 4, rows);
  *reinterpret_cast<uint4*>(big + o0) = b0;
  *reinterpret_cast<uint4*>(big + o1) = b1;
  *reinterpret_cast<uint4*>(big + plane + o0) = s0;
  *reinterpret_cast<uint4*>(big + plane + o1) = s1;
}

// Block (key tile, head, sample): K's rows times `scale` split into the
// tile's two K planes, V's split and transposed into its two V^T planes, a
// 32-byte row (8 floats) a thread, consecutive threads on consecutive rows.
// Blocks past the key tiles of head 0, sample 0 split the rel-pos tiles.
template <int HD>
__global__ void __launch_bounds__(256)
    split_kv_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_pos_h,
                    const float* __restrict__ rel_pos_w, unsigned char* __restrict__ ws, int b_all,
                    int n, int heads, int gh, int gw, float scale) {
  constexpr int PLANE = 4 * BK * HD;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_kt = (n + BK - 1) / BK;
  if (kt >= n_kt) {  // rel-pos tile kt - n_kt: rel_pos_h's, then rel_pos_w's
    if (h != 0 || b != 0) return;
    const int t = kt - n_kt, is_w = t >= rel_tiles(gh);
    const int m0 = BK * (is_w ? t - rel_tiles(gh) : t), rows = 2 * (is_w ? gw : gh) - 1;
    const float* rel = is_w ? rel_pos_w : rel_pos_h;
    unsigned char* tile = ws + head_bytes<HD>(n) * b_all * heads + tile_bytes<HD>() * t;
    for (int e = threadIdx.x; e < BK * HD / 8; e += 256) {
      const int p = e / BK, r = e - p * BK;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (m0 + r < rows) {
        lo = __ldg(reinterpret_cast<const float4*>(rel + (m0 + r) * HD + 8 * p));
        hi = __ldg(reinterpret_cast<const float4*>(rel + (m0 + r) * HD + 8 * p + 4));
      }
      store_split_row(tile, PLANE, r, p, BK, lo, hi);
    }
    return;
  }
  const int k0 = BK * kt;
  const long long c = static_cast<long long>(heads) * HD;
  const float* kb = qkv + static_cast<size_t>(b) * n * 3 * c + c + h * HD;  // key 0's K row
  const float* vb = kb + c;
  unsigned char* tile = ws + (static_cast<size_t>(b) * heads + h) * head_bytes<HD>(n) +
                        2 * tile_bytes<HD>() * kt;
  // a thread's 32-byte rows: K's (key r, channels 8p..8p+7), then V^T's
  // (channel d, keys 8p..8p+7); every load issued before the first store
  constexpr int UK = BK * HD / 8, UT = (2 * UK + 255) / 256;
  float4 lo[UT], hi[UT];
#pragma unroll
  for (int u = 0; u < UT; ++u) {
    const int e = threadIdx.x + 256 * u;
    lo[u] = hi[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < UK) {
      const int p = e / BK, r = e - p * BK;
      if (k0 + r < n) {
        const float4* src = reinterpret_cast<const float4*>(kb + (k0 + r) * 3 * c + 8 * p);
        const float4 a = __ldg(src), z = __ldg(src + 1);
        lo[u] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
        hi[u] = make_float4(z.x * scale, z.y * scale, z.z * scale, z.w * scale);
      }
    } else if (e < 2 * UK) {
      const int p = (e - UK) / HD, d = (e - UK) - p * HD;
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int key = k0 + 8 * p + o;
        v[tw::vt_slot(o)] = key < n ? __ldg(vb + key * 3 * c + d) : 0.f;
      }
      lo[u] = make_float4(v[0], v[1], v[2], v[3]);
      hi[u] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
#pragma unroll
  for (int u = 0; u < UT; ++u) {
    const int e = threadIdx.x + 256 * u;
    if (e < UK) {
      const int p = e / BK;
      store_split_row(tile, PLANE, e - p * BK, p, BK, lo[u], hi[u]);
    } else if (e < 2 * UK) {
      const int p = (e - UK) / HD;
      store_split_row(tile + 2 * PLANE, PLANE, (e - UK) - p * HD, p, HD, lo[u], hi[u]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const unsigned char* __restrict__ ws, const float* __restrict__ qkv,
                     float* __restrict__ out, int b_all, int n, int heads, int gh, int gw,
                     int nbuf) {
  constexpr int KS = HD / 8;                   // k8 steps of Q K^T: the parts of a q or K row
  constexpr int NK = BK / 8;                   // 8-key steps of a tile
  constexpr int BUF = tile_bytes<HD>();        // bytes of a ring buffer (two planes)
  constexpr int PLANE = BUF / 2;
  constexpr float kL2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wa::checked_base(smem_raw);
  const Layout<HD> L(nbuf, gh, gw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nbuf;
  const int b = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_kt = (n + BK - 1) / BK;
  const int nth = rel_tiles(gh), n_rel = nth + rel_tiles(gw);
  const int rt0 = blockIdx.x * kConsumers;
  const int live = min(kConsumers, (n + kRows - 1) / kRows - rt0);  // warpgroups with rows
  if (threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) {
      wa::mbar_init(&full[s], 1);
      wa::mbar_init(&empty[s], live);
    }
    wa::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: the rel-pos tiles, then each key tile's K and
                           // V^T, ring slot i % nbuf, issued by one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      const unsigned char* src =
          ws + head_bytes<HD>(n) * b_all * heads;  // the rel-pos tiles
      const unsigned char* head = ws + (static_cast<size_t>(b) * heads + h) * head_bytes<HD>(n);
      for (int i = 0; i < n_rel + 2 * n_kt; ++i) {
        const int buf = i % nbuf;
        if (i == n_rel) src = head;
        if (i >= nbuf) wa::mbar_wait(&empty[buf], (i / nbuf - 1) & 1);
        wa::mbar_expect_tx(&full[buf], BUF);
        wa::bulk_load(smem + static_cast<size_t>(buf) * BUF, src, BUF, &full[buf]);
        src += BUF;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  if (wg >= live) return;

  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int q0 = (rt0 + wg) * kRows;
  const long long c = static_cast<long long>(heads) * HD;
  float* tab_h = reinterpret_cast<float*>(smem + L.tabs) + wg * kRows * (gh + gw + 2);
  float* tab_w = tab_h + kRows * (gh + 1);
  const int bar = 1 + wg;
  const int row = 16 * warp + lane / 4;  // the lane's row g in the tile

  // q (unscaled: the scale is in K's planes) as A fragments in registers,
  // split once into big and small: rows g, g + 8 and columns t, t + 4 of
  // each k8 step (zeros past n); Q K^T then reads only its ring tile from
  // shared memory
  uint32_t qa[KS][4], qs[KS][4];
  {
    const float* qsrc = qkv + (static_cast<size_t>(b) * n + q0 + row) * 3 * c + h * HD + t;
    const bool lo = q0 + row < n, hi = q0 + row + 8 < n;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float x[4] = {lo ? __ldg(qsrc + 8 * kk) : 0.f, hi ? __ldg(qsrc + 8 * 3 * c + 8 * kk) : 0.f,
                          lo ? __ldg(qsrc + 8 * kk + 4) : 0.f,
                          hi ? __ldg(qsrc + 8 * 3 * c + 8 * kk + 4) : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) sam6d::split_tf32(x[e], qa[kk][e], qs[kk][e]);
    }
  }

  // the ring tile of load i, once it has landed
  auto ring_tile = [&](int i) {
    __syncwarp();
    wa::mbar_wait(&full[i % nbuf], (i / nbuf) & 1);
    return static_cast<const unsigned char*>(smem + static_cast<size_t>(i % nbuf) * BUF);
  };
  auto release = [&](int i) {
    if (tid == 0) wa::mbar_arrive(&empty[i % nbuf]);
  };
  // issues s (64 x BK) = q B^T in three passes, small terms first, B the big
  // and small planes of a ring tile; one wgmma group
  auto issue_qk = [&](float (&s)[NK][4], const unsigned char* bt) {
    wa::fence_regs(s);
    wa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qs[kk], tw::part_desc(bt + kk * BK * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qa[kk], tw::part_desc(bt + PLANE + kk * BK * 32), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qa[kk], tw::part_desc(bt + kk * BK * 32), 1);
    wa::wgmma_commit();
  };

  float s[NK][4];
  // the tables: G = q R^T a rel-pos tile at a time, entry (r, m) stored as
  // table entry j = pos(r) - m + g - 1 where that lies in [0, g) (pos: the
  // row's grid row for rel_h, its column for rel_w; rows past n take row n -
  // 1's pattern on q = 0, so every entry is written)
  for (int i = 0; i < n_rel; ++i) {
    issue_qk(s, ring_tile(i));
    wa::wgmma_wait0();
    wa::fence_regs(s);
    release(i);
    const bool is_w = i >= nth;
    const int g = is_w ? gw : gh, m0 = BK * (is_w ? i - nth : i);
    float* tab = is_w ? tab_w : tab_h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half, tok = min(q0 + r, n - 1);
      const int base = (is_w ? tok % gw : tok / gw) + g - 1 - m0;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = base - (8 * j + 2 * t + e);
          if (k >= 0 && k < g) tab[r * (g + 1) + k] = s[j][2 * half + e];
        }
    }
  }
  wa::wg_sync(bar);  // every table entry written

  const float* th_lo = tab_h + row * (gh + 1);
  const float* th_hi = th_lo + 8 * (gh + 1);
  const float* tw_lo = tab_w + row * (gw + 1);
  const float* tw_hi = tw_lo + 8 * (gw + 1);
  const bool warp_live = q0 + 16 * warp < n;
  const float inv_gw = 1.f / gw;
  float o[HD / 2], ot[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // running max of rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;                      // this lane's partial sums

  // s (tile kt's scores) turned into p in place: bias, mask, online softmax;
  // (a_lo, a_hi) the rescale of O for this tile
  auto softmax = [&](int kt, float& a_lo, float& a_hi) {
    if (!warp_live) {  // no row of this warp is below n: p = 0
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      a_lo = a_hi = 1.f;
      return;
    }
    const int k0 = kt * BK;
    if (gw % 2 == 0) {  // keys 2i, 2i + 1 share a grid row
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int k = min(k0 + 8 * j + 2 * t, n - 2);  // keys past n read n - 2's; masked below
        const int kr = static_cast<int>((k + 0.5f) * inv_gw), kc = k - kr * gw;
        const float h_lo = th_lo[kr], h_hi = th_hi[kr];
        s[j][0] += h_lo + tw_lo[kc];
        s[j][1] += h_lo + tw_lo[kc + 1];
        s[j][2] += h_hi + tw_hi[kc];
        s[j][3] += h_hi + tw_hi[kc + 1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = min(k0 + 8 * j + 2 * t + e, n - 1);
          const int kr = static_cast<int>((k + 0.5f) * inv_gw), kc = k - kr * gw;
          s[j][e] += th_lo[kr] + tw_lo[kc];
          s[j][e + 2] += th_hi[kr] + tw_hi[kc];
        }
    }
    if (k0 + BK > n) {  // keys past n
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= n) s[j][e] = -CUDART_INF_F;
    }
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_lo = fmaxf(m_lo, sam6d::quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, sam6d::quad_max(mx_hi));
    a_lo = wa::ex2((m_lo - mn_lo) * kL2e);  // 0 at the first tile
    a_hi = wa::ex2((m_hi - mn_hi) * kL2e);
    m_lo = mn_lo;
    m_hi = mn_hi;
    // p = 2^(s log2 e - m log2 e): the rounding of m log2 e is one factor a
    // row, which the division by l takes out
    const float nb_lo = -mn_lo * kL2e, nb_hi = -mn_hi * kL2e;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = wa::ex2(fmaf(s[j][0], kL2e, nb_lo));
      s[j][1] = wa::ex2(fmaf(s[j][1], kL2e, nb_lo));
      s[j][2] = wa::ex2(fmaf(s[j][2], kL2e, nb_hi));
      s[j][3] = wa::ex2(fmaf(s[j][3], kL2e, nb_hi));
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
  };

  // P's A fragments (a0..a3 = c0, c2, c1, c3), big and small, from p in s
  uint32_t pb[NK][4], ps[NK][4];
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) sam6d::split_tf32(p[e], pb[j][e], ps[j][e]);
    }
  };
  // a tile's P V from zero, small terms first, as one wgmma group
  auto issue_pv = [&](const unsigned char* vt) {
    wa::fence_regs(ot);
    wa::wgmma_fence();
#pragma unroll
    for (int j = 0; j < NK; ++j) tw::wgmma_tf32_rs(ot, ps[j], tw::part_desc(vt + j * HD * 32), j > 0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
      tw::wgmma_tf32_rs(ot, pb[j], tw::part_desc(vt + PLANE + j * HD * 32), 1);
#pragma unroll
    for (int j = 0; j < NK; ++j) tw::wgmma_tf32_rs(ot, pb[j], tw::part_desc(vt + j * HD * 32), 1);
    wa::wgmma_commit();
  };
  // once tile kt's P V is done: O = O * alpha + O_tile
  auto finish_pv = [&](int kt, float a_lo, float a_hi) {
    wa::wgmma_wait0();
    wa::fence_regs(ot);
    wa::fence_regs(pb);
    wa::fence_regs(ps);
    release(n_rel + 2 * kt + 1);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = fmaf(o[i], (i & 2) ? a_hi : a_lo, ot[i]);
  };

  for (int kt = 0; kt < n_kt; ++kt) {
    const int ik = n_rel + 2 * kt;  // tile kt's K load; its V is ik + 1
    issue_qk(s, ring_tile(ik));
    wa::wgmma_wait0();
    wa::fence_regs(s);
    release(ik);
    float a_lo, a_hi;
    softmax(kt, a_lo, a_hi);
    split_p();
    issue_pv(ring_tile(ik + 1));
    finish_pv(kt, a_lo, a_hi);
  }

  // the row maximum contributes exp(0) = 1 to l, so l >= 1 on live rows
  const float inv_lo = 1.f / fmaxf(sam6d::quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(sam6d::quad_sum(l_hi), 1e-30f);
  float* orow = out + static_cast<size_t>(b) * n * c + h * HD + 2 * t;
  const int r_lo = q0 + row, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r_lo < n)
      *reinterpret_cast<float2*>(orow + r_lo * c + 8 * j) =
          make_float2(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (r_hi < n)
      *reinterpret_cast<float2*>(orow + r_hi * c + 8 * j) =
          make_float2(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
}

template <int HD>
int launch_split(const float* qkv, const float* rel_pos_h, const float* rel_pos_w, void* ws, int b,
                 int n, int heads, int gh, int gw, float scale, cudaStream_t stream) {
  const int blocks = (n + BK - 1) / BK + rel_tiles(gh) + rel_tiles(gw);
  split_kv_kernel<HD><<<dim3(blocks, heads, b), 256, 0, stream>>>(
      qkv, rel_pos_h, rel_pos_w, static_cast<unsigned char*>(ws), b, n, heads, gh, gw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_attention(const float* qkv, const float* rel_pos_h, const float* rel_pos_w, void* ws,
                     float* out, int b, int n, int heads, int gh, int gw, float scale,
                     cudaStream_t stream) {
  const int nbuf = ring_depth<HD>(gh, gw);
  if (nbuf == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Layout<HD>(nbuf, gh, gw).total;
  int err = static_cast<int>(cudaFuncSetAttribute(attention_kernel<HD>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(bytes)));
  if (err != 0) return err;
  err = launch_split<HD>(qkv, rel_pos_h, rel_pos_w, ws, b, n, heads, gh, gw, scale, stream);
  if (err != 0) return err;
  const int blocks = ((n + kRows - 1) / kRows + kConsumers - 1) / kConsumers;
  attention_kernel<HD><<<dim3(blocks, heads, b), kThreads, bytes, stream>>>(
      static_cast<const unsigned char*>(ws), qkv, out, b, n, heads, gh, gw, nbuf);
  return static_cast<int>(cudaGetLastError());
}

// the entry's launches (split = true: the pre-pass alone)
template <int HD>
int launch(const float* qkv, const float* rel_pos_h, const float* rel_pos_w, void* ws, float* out,
           int b, int n, int heads, int gh, int gw, float scale, bool split, cudaStream_t stream) {
  return split ? launch_split<HD>(qkv, rel_pos_h, rel_pos_w, ws, b, n, heads, gh, gw, scale, stream)
               : launch_attention<HD>(qkv, rel_pos_h, rel_pos_w, ws, out, b, n, heads, gh, gw,
                                      scale, stream);
}

template <int HD>
size_t smem_bytes(int gh, int gw) {
  const int d = ring_depth<HD>(gh, gw);
  return Layout<HD>(d ? d : 2, gh, gw).total;
}

}  // namespace tf32

// the bf16 entry: the wgmma core's shared memory, then each warpgroup's
// 64 rows of the two bf16 tables, then each warp's staged rel-pos row
__host__ __device__ constexpr size_t tables_bytes_bf16(int gh, int gw) {
  return 2 * sam6d::wgattn::kWarpgroups * sam6d::wgattn::kRowsWG * (gh + gw + 3);
}
template <int HD>
size_t smem_bytes_bf16(int n, int gh, int gw) {
  return sam6d::wgattn::core_smem_bytes<HD>(n) + tables_bytes_bf16(gh, gw) +
         sizeof(float) * sam6d::wgattn::kThreads / 32 * 2 * HD;
}

// Where a grid's table rows do not fit shared memory beside the ring (1 x
// 1000 at hd 16 needs 330 KB), the tables come from global memory: a
// pre-pass (relpos_tables_bf16_kernel) forms every query's rows, each entry
// in the same two FMA chains as RelPosBiasBf16::prepare, into a workspace
// of rows padded like the shared ones ([n rounded up to 64][gh + 1] and
// [..][gw + 2] a (sample, head)), and the attention kernel's bias points
// its rows at the current row tile's rows there: add() then reads them
// from global memory (L2) instead of shared memory.
template <int HD>
struct RelPosBiasBf16Global : RelPosBiasBf16<HD> {
  const __nv_bfloat16* rows_h;  // the (sample, head)'s rel_h rows
  const __nv_bfloat16* rows_w;  // its rel_w rows

  __device__ __forceinline__ void prepare(const unsigned char*, int q0, int) const {
    this->tab_h = const_cast<__nv_bfloat16*>(rows_h) + q0 * (this->gh + 1);
    this->tab_w = const_cast<__nv_bfloat16*>(rows_w) + q0 * (this->gw + 2);
  }
};

__host__ __device__ constexpr int padded_rows(int n) {
  return (n + sam6d::wgattn::kRowsWG - 1) / sam6d::wgattn::kRowsWG * sam6d::wgattn::kRowsWG;
}

// the global tables of one (sample, head): rel_h rows then rel_w rows
__host__ __device__ constexpr size_t table_entries(int n, int gh, int gw) {
  return static_cast<size_t>(padded_rows(n)) * (gh + 1 + gw + 2);
}

template <int HD>
__global__ void __launch_bounds__(256)
    relpos_tables_bf16_kernel(const sam6d::wgattn::bf16* __restrict__ qkv,
                              const sam6d::wgattn::bf16* __restrict__ rel_pos_h,
                              const sam6d::wgattn::bf16* __restrict__ rel_pos_w,
                              sam6d::wgattn::bf16* __restrict__ tables, int n, int heads,
                              int gh, int gw) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int per_row = gh + gw;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int tok = e / per_row, j = e - tok * per_row;
  if (tok >= padded_rows(n)) return;
  __nv_bfloat16* rows = tables + (static_cast<size_t>(b) * heads + h) * table_entries(n, gh, gw);
  const bool is_w = j >= gh;
  __nv_bfloat16* dst = is_w ? rows + static_cast<size_t>(padded_rows(n)) * (gh + 1) +
                                  static_cast<size_t>(tok) * (gw + 2) + (j - gh)
                            : rows + static_cast<size_t>(tok) * (gh + 1) + j;
  if (tok >= n) {  // rows past n: finite entries, never read into an output
    *dst = __float2bfloat16_rn(0.f);
    return;
  }
  const int c = heads * HD;
  const __nv_bfloat16* q = qkv + (static_cast<size_t>(b) * n + tok) * 3 * c + h * HD;
  const __nv_bfloat16* rel = is_w ? rel_pos_w + (tok % gw - (j - gh) + gw - 1) * HD
                                  : rel_pos_h + (tok / gw - j + gh - 1) * HD;
  float even = 0.f, odd = 0.f;  // RelPosBiasBf16::prepare's two chains
#pragma unroll
  for (int d = 0; d < HD; d += 2) {
    even = fmaf(__bfloat162float(q[d]), __bfloat162float(rel[d]), even);
    odd = fmaf(__bfloat162float(q[d + 1]), __bfloat162float(rel[d + 1]), odd);
  }
  *dst = __float2bfloat16_rn(even + odd);
}

template <int HD>
__global__ void __launch_bounds__(sam6d::wgattn::kThreads, 2)
    attention_relpos_wgmma_global_kernel(const __grid_constant__ sam6d::wgattn::KVMaps maps,
                                         const sam6d::wgattn::bf16* __restrict__ qkv,
                                         const sam6d::wgattn::bf16* __restrict__ tables,
                                         sam6d::wgattn::bf16* __restrict__ out, int n,
                                         int heads, int gh, int gw, int row_tiles,
                                         float scale) {
  namespace wa = sam6d::wgattn;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wa::checked_base(smem_raw);
  const int c = heads * HD;
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* rows = tables + (static_cast<size_t>(b) * heads + h) *
                                           table_entries(n, gh, gw);
  RelPosBiasBf16Global<HD> bias;
  bias.gh = gh;
  bias.gw = gw;
  bias.row = static_cast<int>(threadIdx.x % 128 / 32) * 16 + lane / 4;
  bias.rows_h = rows;
  bias.rows_w = rows + static_cast<size_t>(padded_rows(n)) * (gh + 1);
  const wa::Tiles op{qkv + static_cast<size_t>(b) * n * 3 * c + h * HD,
                     out + static_cast<size_t>(b) * n * c + h * HD,
                     3LL * c, c, n, n, HD, h, b};
  const int rt0 = blockIdx.x * row_tiles;
  wa::attend<HD>(maps, op, smem, rt0, min(row_tiles, (n + wa::kRowsWG - 1) / wa::kRowsWG - rt0),
                 scale, wa::kLog2e, bias);
}

template <int HD>
int launch_bf16_global(const void* qkv, const void* rel_pos_h, const void* rel_pos_w,
                       void* tables, void* out, int b, int n, int heads, int gh, int gw,
                       float scale, cudaStream_t stream) {
  namespace wa = sam6d::wgattn;
  const size_t bytes = wa::core_smem_bytes<HD>(n);
  if (bytes > kMaxSmemBf16) return static_cast<int>(cudaErrorInvalidValue);
  wa::KVMaps maps;
  int err = wa::encode_qkv_maps<HD>(maps, qkv, b, n, heads);
  if (err != 0) return err;
  err = static_cast<int>(cudaFuncSetAttribute(attention_relpos_wgmma_global_kernel<HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(bytes)));
  if (err != 0) return err;
  const long long entries = static_cast<long long>(padded_rows(n)) * (gh + gw);
  const dim3 pre((entries + 255) / 256, heads, b);
  relpos_tables_bf16_kernel<HD><<<pre, 256, 0, stream>>>(
      static_cast<const wa::bf16*>(qkv), static_cast<const wa::bf16*>(rel_pos_h),
      static_cast<const wa::bf16*>(rel_pos_w), static_cast<wa::bf16*>(tables), n, heads, gh, gw);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int row_tiles = wa::row_tiles_per_block<HD>(n, n);
  const dim3 grid(((n + wa::kRowsWG - 1) / wa::kRowsWG + row_tiles - 1) / row_tiles, heads, b);
  attention_relpos_wgmma_global_kernel<HD><<<grid, wa::kThreads, bytes, stream>>>(
      maps, static_cast<const wa::bf16*>(qkv), static_cast<const wa::bf16*>(tables),
      static_cast<wa::bf16*>(out), n, heads, gh, gw, row_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- the windowed (resident) launch
//
// Grids whose keys fit the ring (<= 256 at hd 80, <= 320 below: SAM's 14 x
// 14 windows) take attention_relpos_window_kernel: two 64-row tiles of one
// (sample, head) a block, one a warpgroup, its q tiles and every K/V tile
// loaded by TMA up front. A phase split of the
// previous kernel (clock64 stamps, PERF.md) put nearly half of a windowed
// row tile in forming its table rows and four fifths of each key tile in
// the bias add, so:
//  - the table pass gives lane i of a warp the tile's rows 2i and 2i + 1,
//    whose grid positions are equal or one apart, and walks the rel-pos
//    rows once for both (entry u - s of one row and u of the other read the
//    same rel-pos row), so each staged value feeds two rows' FMAs, in the
//    FMA order of bf16_rel_pos_tables; the two warps of a table split the
//    walk; the rows are staged once a block as bf16 (rel_w's even rows
//    before its odd ones, so the rows a warp reads at once sit in distinct
//    bank groups), and the walk has no branches. A 16-byte shared load a
//    lane costs the SM 4 cycles a warp (2.2 where a quarter warp reads one
//    address), against 0.25 for an FMA, so the pass is bound by its loads;
//  - the bias add finds a key's grid row by a multiply, and on an even grid
//    width a lane's two keys share one rel_h entry and one rel_w word;
//  - a last tile of at most 16 keys takes a 16-key ring stage (its own
//    tensor maps; keys past n read as zeros) and runs as m64n8 or m64n16,
//    which leaves room at two blocks an SM (106 064 B at 14 x 14, hd 80);
//  - a warp with no row below n (rows 192-195 of a window live in warp 0
//    of the last tile) skips its bias add and softmax; its p stays 0;
//  - two row tiles a block rather than all four: 800 blocks of one
//    tile-time for SAM's 400 (window, head)s on the 264 two-an-SM slots,
//    where 400 of two tile-times left the card two-thirds idle in a second
//    round (K/V is read twice, from L2).
namespace window {
namespace wa = sam6d::wgattn;
using wa::bf16;

constexpr int kU = 8;          // rel-pos rows a thread walks at a time
constexpr int kTailKeys = 16;  // keys of the short last ring stage

// 32-bit words (bf16 pairs) a staged rel-pos row: 4 or 12 past HD / 2 (mod
// 32), so 8 consecutive rows start in 8 different bank groups
template <int HD>
__host__ __device__ constexpr int rel_stride() { return HD / 2 + 4; }
__host__ __device__ constexpr int rh_stride(int gh) { return gh + 1; }
// rel_w rows: an even number of entries (a lane's pair of neighbouring
// entries is one aligned word) and an odd number of words (no two of a
// lane quad's eight rows in one bank)
__host__ __device__ constexpr int rw_stride(int gw) {
  return (gw + 2) / 2 * 2 + ((gw + 2) / 2 % 2 ? 0 : 2);
}
// bytes of one operand's tile in the short stage, 1024-aligned for the
// 128-byte swizzle atoms of the next one
template <int HD>
__host__ __device__ constexpr int tail_tile_bytes() {
  return (kTailKeys * HD * 2 + 1023) / 1024 * 1024;
}

// The block's shared memory: the ring (full stages, then the last one),
// the warpgroups' q tiles, the staged rel-pos rows, the full barriers and
// the warpgroups' table rows.
template <int HD>
struct Layout {
  int n_kt;          // key tiles
  bool short_tail;   // the last one takes a 16-key stage
  size_t q, rel, bars, tabs, total;
  __host__ __device__ Layout(int n, int gh, int gw) {
    n_kt = (n + wa::kTileKeys - 1) / wa::kTileKeys;
    short_tail = n - wa::kTileKeys * (n_kt - 1) <= kTailKeys;
    q = (n_kt - short_tail) * 2 * static_cast<size_t>(wa::tile_bytes<HD>()) +
        (short_tail ? 2 * tail_tile_bytes<HD>() : 0);
    rel = q + wa::kWarpgroups * wa::q_tile_bytes<HD>();
    bars = rel + sizeof(uint32_t) * rel_stride<HD>() * (2 * gh - 1 + 2 * gw - 1);
    tabs = bars + (sizeof(uint64_t) * (n_kt + wa::kWarpgroups) + 15) / 16 * 16;
    total = tabs + sizeof(bf16) * wa::kWarpgroups * wa::kRowsWG * (rh_stride(gh) + rw_stride(gw));
  }
};

// Where a staged rel-pos row m lies among its table's rows: rel_h's in
// order; rel_w's even rows first, then its odd ones, so that the rows m, m +
// 2, m + 4, ... that a rel_w warp's lanes read at once (their row pairs'
// columns step by 2) are consecutive rows, each in its own bank group.
__device__ __forceinline__ int staged_row(int m, bool is_w, int gw) {
  return is_w ? ((m & 1) ? gw + (m >> 1) : (m >> 1)) : m;
}

// rel_pos_h's 2 gh - 1 rows then rel_pos_w's 2 gw - 1 (bf16), by `nthreads`
// threads
template <int HD>
__device__ __forceinline__ void stage_rel_rows(uint32_t* rel_s, const bf16* __restrict__ rel_pos_h,
                                               const bf16* __restrict__ rel_pos_w, int gh, int gw,
                                               int nthreads) {
  const int rows_h = 2 * gh - 1, chunks = (rows_h + 2 * gw - 1) * (HD / 8);
  for (int e = threadIdx.x; e < chunks; e += nthreads) {
    const int row = e / (HD / 8), c = e - row * (HD / 8);
    const bf16* src = row < rows_h ? rel_pos_h + row * HD : rel_pos_w + (row - rows_h) * HD;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + c);
    const int at = row < rows_h ? row : rows_h + staged_row(row - rows_h, true, gw);
    *reinterpret_cast<uint4*>(rel_s + at * rel_stride<HD>() + 4 * c) = x;
  }
}

// q rows q0.. of one (sample, head) (row stride sq, 16-byte aligned) into a
// warpgroup's swizzled tile, zeros past n; the warpgroup's 128 threads
template <int HD>
__device__ __forceinline__ void load_q_tile(unsigned char* qs, const bf16* q, long long sq, int q0,
                                            int n) {
  constexpr int CH = HD / 8;
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {
    const int e = tid + 128 * i;
    const int r = e / CH, c = e - r * CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n) x = *reinterpret_cast<const uint4*>(q + (q0 + r) * sq + 8 * c);
    *reinterpret_cast<uint4*>(qs + wa::chunk_offset<HD>(r, c)) = x;
  }
}

// The table rows of the 64-row tile from q0 of a gh x gw grid, from its
// unscaled q tile `qs` and the staged rel-pos rows: rel_h[r][j] (stride
// rh_stride) and rel_w[r][j] (stride rw_stride), bf16. Entry j of a row at
// grid position p (its grid row for rel_h, its column for rel_w) is q .
// rel[p - j + g - 1], the exact fp32 products of its even channels summed in
// one chain and of its odd ones in another, channel by channel, the two sums
// added and rounded to bf16 once (bf16_rel_pos_tables). Rows past n hold
// zeros. The warpgroup's 128 threads: warps 0-1 rel_h, 2-3 rel_w; lane i of
// a warp takes rows 2i and 2i + 1, whose positions are equal or consecutive
// except where a row wraps, so both rows' entries come from one walk over
// the rel-pos rows (entry u - s of the first row and u of the second use
// the same row, s the step in position), each staged value feeding two rows'
// products; the two warps of a table split the walk, kU rows at a time.
template <int HD>
__device__ __forceinline__ void form_tables(const unsigned char* qs, const uint32_t* rel_s,
                                            bf16* tab_h, bf16* tab_w, int q0, int n, int gh,
                                            int gw) {
  constexpr int RS = rel_stride<HD>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool is_w = warp >= 2, second = warp & 1;
  const int g = is_w ? gw : gh;
  const uint32_t* rows = rel_s + (is_w ? (2 * gh - 1) * RS : 0);
  const int r0 = 2 * lane, r1 = r0 + 1;
  const bool live0 = q0 + r0 < n, live1 = q0 + r1 < n;
  const int t0 = min(q0 + r0, n - 1), t1 = min(q0 + r1, n - 1);
  const int p0 = is_w ? t0 % gw : t0 / gw, p1 = is_w ? t1 % gw : t1 / gw;
  bf16* d0 = is_w ? tab_w + r0 * rw_stride(gw) : tab_h + r0 * rh_stride(gh);
  bf16* d1 = is_w ? tab_w + r1 * rw_stride(gw) : tab_h + r1 * rh_stride(gh);

  // rows ra and rb (tile rows; positions pa and pa + s, s 0 or 1) into da,
  // db. Rows u0 + i of a group are reached from the group's first two rows
  // at fixed offsets (kStep words between rows two apart), and every group
  // runs all kU of them (rows past the walk's end feed only sums that are
  // not stored), so the loop has no branches.
  auto walk = [&](auto step, int ra, int rb, int pa, int s, bf16* da, bf16* db) {
    constexpr int kStep = decltype(step)::value;
    const int U = g + s, mid = (U + 1) / 2;
    const int ub = second ? mid : 0, ue = second ? U : mid;
    const int mtop = pa + s + g - 1;  // the row of u = 0
    for (int u0 = ub; u0 < ue; u0 += kU) {
      float e0[kU], o0[kU], e1[kU], o1[kU];
#pragma unroll
      for (int i = 0; i < kU; ++i) e0[i] = o0[i] = e1[i] = o1[i] = 0.f;
      const uint32_t* pe = rows + staged_row(mtop - u0, is_w, gw) * RS;      // row of u0
      const uint32_t* po = rows + staged_row(mtop - u0 - 1, is_w, gw) * RS;  // row of u0 + 1
#pragma unroll 1
      for (int c = 0; c < HD / 8; ++c) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(qs + wa::chunk_offset<HD>(ra, c));
        const uint4 b4 = *reinterpret_cast<const uint4*>(qs + wa::chunk_offset<HD>(rb, c));
        const float x[8] = {wa::lo_of(a4.x), wa::hi_of(a4.x), wa::lo_of(a4.y), wa::hi_of(a4.y),
                            wa::lo_of(a4.z), wa::hi_of(a4.z), wa::lo_of(a4.w), wa::hi_of(a4.w)};
        const float y[8] = {wa::lo_of(b4.x), wa::hi_of(b4.x), wa::lo_of(b4.y), wa::hi_of(b4.y),
                            wa::lo_of(b4.z), wa::hi_of(b4.z), wa::lo_of(b4.w), wa::hi_of(b4.w)};
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          const uint4 w = *reinterpret_cast<const uint4*>((i & 1 ? po : pe) - (i >> 1) * kStep +
                                                          4 * c);
          const float r[8] = {wa::lo_of(w.x), wa::hi_of(w.x), wa::lo_of(w.y), wa::hi_of(w.y),
                              wa::lo_of(w.z), wa::hi_of(w.z), wa::lo_of(w.w), wa::hi_of(w.w)};
#pragma unroll
          for (int d = 0; d < 8; d += 2) {
            e0[i] = fmaf(x[d], r[d], e0[i]);
            o0[i] = fmaf(x[d + 1], r[d + 1], o0[i]);
            e1[i] = fmaf(y[d], r[d], e1[i]);
            o1[i] = fmaf(y[d + 1], r[d + 1], o1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const int u = u0 + i;
        if (u < ue && u - s >= 0 && u - s < g) da[u - s] = __float2bfloat16_rn(e0[i] + o0[i]);
        if (u < ue && u < g) db[u] = __float2bfloat16_rn(e1[i] + o1[i]);
      }
    }
  };
  // rel_h rows two apart are 2 rows apart in the staging, rel_w's 1
  auto pair = [&](int ra, int rb, int pa, int s, bf16* da, bf16* db) {
    if (is_w)
      walk(std::integral_constant<int, RS>{}, ra, rb, pa, s, da, db);
    else
      walk(std::integral_constant<int, 2 * RS>{}, ra, rb, pa, s, da, db);
  };
  if (__any_sync(0xffffffffu, live0)) {
    if (p1 - p0 == 0 || p1 - p0 == 1) {
      pair(r0, r1, p0, p1 - p0, d0, d1);
    } else {  // the pair wraps to the next grid row (odd gw): each row alone
      pair(r0, r0, p0, 0, d0, d0);
      pair(r1, r1, p1, 0, d1, d1);
    }
  }
  for (int j = 0; j < g; ++j) {  // rows past n: finite entries, never read into an output
    if (!live0) d0[j] = __float2bfloat16_rn(0.f);
    if (!live1) d1[j] = __float2bfloat16_rn(0.f);
  }
}

// rel_h + rel_w added to a lane's score fragments (rows g and g + 8 of its
// warp, whose entries rh/rw and rh8/rw8 point at; keys k0 + 8 nt + 2 t and
// the next), each bias summed in fp32 before it meets the score. A key's
// grid row is (key + 0.5) * (1 / gw) truncated, exact for these key counts;
// keys past n (a last tile) read key n - 1's (or n - 2's) entries, which the
// caller masks.
template <int NTT>
__device__ __forceinline__ void add_bias(float (&s)[NTT][4], const bf16* rh, const bf16* rh8,
                                         const bf16* rw, const bf16* rw8, int gw, float inv_gw,
                                         int k0, int n, int t) {
  if (gw % 2 == 0) {  // keys 2i and 2i + 1 share a grid row: one rel_h entry, one rel_w word
#pragma unroll
    for (int nt = 0; nt < NTT; ++nt) {
      const int k = min(k0 + 8 * nt + 2 * t, n - 2);
      const int kr = static_cast<int>((k + 0.5f) * inv_gw), kc = k - kr * gw;
      const float h_lo = __bfloat162float(rh[kr]), h_hi = __bfloat162float(rh8[kr]);
      const uint32_t w_lo = *reinterpret_cast<const uint32_t*>(rw + kc);
      const uint32_t w_hi = *reinterpret_cast<const uint32_t*>(rw8 + kc);
      s[nt][0] += h_lo + wa::lo_of(w_lo);
      s[nt][1] += h_lo + wa::hi_of(w_lo);
      s[nt][2] += h_hi + wa::lo_of(w_hi);
      s[nt][3] += h_hi + wa::hi_of(w_hi);
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NTT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = min(k0 + 8 * nt + 2 * t + e, n - 1);
      const int kr = static_cast<int>((k + 0.5f) * inv_gw), kc = k - kr * gw;
      s[nt][e] += __bfloat162float(rh[kr]) + __bfloat162float(rw[kc]);
      s[nt][e + 2] += __bfloat162float(rh8[kr]) + __bfloat162float(rw8[kc]);
    }
  }
}

// the tensor maps of K and V (64-key boxes, and 16-key ones for a short
// last stage) and of q (64-row boxes, the K tile's layout)
struct Maps {
  wa::KVMaps full, tail;
  CUtensorMap q[2];
};

template <int HD>
__global__ void __launch_bounds__(wa::kThreads, 2)
    attention_relpos_window_kernel(const __grid_constant__ Maps maps,
                                   const bf16* __restrict__ rel_pos_h,
                                   const bf16* __restrict__ rel_pos_w, bf16* __restrict__ out,
                                   int n, int heads, int gh, int gw, float qscale) {
  constexpr int TB = wa::tile_bytes<HD>(), TT = tail_tile_bytes<HD>();
  constexpr int KS = HD / 16;                      // k16 steps of Q K^T
  constexpr int NA = wa::part_cols<HD>(0);         // hd columns of part 0
  constexpr int NB = wa::n_parts<HD>() == 2 ? wa::part_cols<HD>(1) : 16;
  constexpr int W0 = wa::part_width<HD>(0), W1 = wa::part_width<HD>(1);
  constexpr float kScore = wa::kLog2e;             // the scale is already in q
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wa::checked_base(smem_raw);
  const Layout<HD> L(n, gh, gw);
  const int c = heads * HD, b = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint32_t* rel_s = reinterpret_cast<uint32_t*>(smem + L.rel);

  uint64_t* q_full = full + L.n_kt;  // a warpgroup's q tile landed
  unsigned char* qs = smem + L.q + wg * wa::q_tile_bytes<HD>();
  // the block's row tiles: one a warpgroup
  const int n_rt = (n + wa::kRowsWG - 1) / wa::kRowsWG, rt0 = blockIdx.x * wa::kWarpgroups;
  if (threadIdx.x == 0) {  // the q tiles (unscaled; rows past n read as zeros), then every key tile
    for (int s = 0; s < L.n_kt + wa::kWarpgroups; ++s) wa::mbar_init(&full[s], 1);
    wa::mbar_fence_init();
    for (int w = 0; w < min(wa::kWarpgroups, n_rt - rt0); ++w) {
      wa::mbar_expect_tx(&q_full[w], TB);
#pragma unroll
      for (int p = 0; p < wa::n_parts<HD>(); ++p)
        wa::tma_load_4d(smem + L.q + w * wa::q_tile_bytes<HD>() + wa::part_offset(p), &maps.q[p],
                        &q_full[w], 64 * p, (rt0 + w) * wa::kRowsWG, h, b);
    }
    for (int kt = 0; kt < L.n_kt; ++kt) {
      const bool tail = L.short_tail && kt == L.n_kt - 1;
      const wa::KVMaps& m = tail ? maps.tail : maps.full;
      const int rows = tail ? kTailKeys : wa::kTileKeys;
      unsigned char* dst = smem + static_cast<size_t>(kt) * 2 * TB;
      wa::mbar_expect_tx(&full[kt], 2 * rows * HD * 2);
#pragma unroll
      for (int p = 0; p < wa::n_parts<HD>(); ++p) {
        wa::tma_load_4d(dst + p * rows * 128, &m.k[p], &full[kt], 64 * p, kt * wa::kTileKeys, h, b);
        wa::tma_load_4d(dst + (tail ? TT : TB) + p * rows * 128, &m.v[p], &full[kt], 64 * p,
                        kt * wa::kTileKeys, h, b);
      }
    }
  }
  stage_rel_rows<HD>(rel_s, rel_pos_h, rel_pos_w, gh, gw, wa::kThreads);
  __syncthreads();
  if (rt0 + wg >= n_rt) return;
  bf16* tab_h = reinterpret_cast<bf16*>(smem + L.tabs) +
                wg * wa::kRowsWG * (rh_stride(gh) + rw_stride(gw));
  bf16* tab_w = tab_h + wa::kRowsWG * rh_stride(gh);

  bf16* o_rows = out + static_cast<size_t>(b) * n * c + h * HD;
  const int row = 16 * warp + lane / 4;  // the lane's row g in the tile
  const float inv_gw = 1.f / gw;
  const int bar = 1 + wg;
  const int q0 = (rt0 + wg) * wa::kRowsWG;
  const bool warp_live = q0 + 16 * warp < n;
  __syncwarp();
  wa::mbar_wait(&q_full[wg], 0);
  form_tables<HD>(qs, rel_s, tab_h, tab_w, q0, n, gh, gw);
  wa::wg_sync(bar);
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {  // q as bf16(q * bf16(scale)), the TPU kernel's q_aug
    const int e = tid + 128 * i;
    uint4* chunk = reinterpret_cast<uint4*>(qs + wa::chunk_offset<HD>(e / (HD / 8), e % (HD / 8)));
    const uint4 v = *chunk;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = wa::pack2(wa::lo_of(w[j]) * qscale, wa::hi_of(w[j]) * qscale);
    *chunk = make_uint4(x[0], x[1], x[2], x[3]);
  }
  wa::fence_async_shared();
  wa::wg_sync(bar);
  const bf16* rh_lo = tab_h + row * rh_stride(gh);  // the lane's rows g, g + 8
  const bf16* rh_hi = rh_lo + 8 * rh_stride(gh);
  const bf16* rw_lo = tab_w + row * rw_stride(gw);
  const bf16* rw_hi = rw_lo + 8 * rw_stride(gw);

  float o[NA / 2];   // output columns 0..NA-1
  float o1[NB / 2];  // hd 80: columns NA..HD-1
#pragma unroll
  for (int i = 0; i < NA / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) o1[i] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;  // running max of rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;                      // this lane's partial sums

  // one key tile of NTT 8-key blocks whose K part 1 starts p1 bytes into
  // its K tile and whose V tile starts vb bytes into the stage; `full`: 64
  // keys below n
  auto tile_step = [&](auto ntt, auto full, int kt, int p1, int vb) {
    constexpr int NTT = decltype(ntt)::value;
    constexpr bool kFull = decltype(full)::value;
    constexpr int KTT = (NTT + 1) / 2;  // k16 steps of P V
    const unsigned char* kt_s = smem + static_cast<size_t>(kt) * 2 * TB;
    const unsigned char* vt_s = kt_s + vb;
    float sf[NTT][4];

    wa::fence_regs(sf);
    wa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < NA / 16)
        wa::wgmma_ss(sf, wa::make_desc<W0>(qs + 32 * kk), wa::make_desc<W0>(kt_s + 32 * kk), kk > 0);
      else  // part 1 (hd 80)
        wa::wgmma_ss(sf, wa::make_desc<W1>(qs + wa::part_offset(1) + 32 * (kk - NA / 16)),
                     wa::make_desc<W1>(kt_s + p1 + 32 * (kk - NA / 16)), 1);
    }
    wa::wgmma_commit();
    wa::wgmma_wait0();
    wa::fence_regs(sf);

    uint32_t pa[KTT][4];
    if (warp_live) {
      const int k0 = kt * wa::kTileKeys, nk = min(wa::kTileKeys, n - k0);
      add_bias(sf, rh_lo, rh_hi, rw_lo, rw_hi, gw, inv_gw, k0, n, t);
      if (!kFull) {  // keys past n
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
      const float mn_lo = fmaxf(m_lo, sam6d::quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, sam6d::quad_max(mx_hi));
      const float corr_lo = wa::ex2((m_lo - mn_lo) * kScore);  // 0 at the first tile
      const float corr_hi = wa::ex2((m_hi - mn_hi) * kScore);
      m_lo = mn_lo;
      m_hi = mn_hi;
      const float nb_lo = -mn_lo * kScore, nb_hi = -mn_hi * kScore;
      // p rounded to bf16 pairs, the A fragments of P V; l sums the rounded p
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int kk = 0; kk < KTT; ++kk) {
        const float(&x)[4] = sf[2 * kk];
        pa[kk][0] = wa::pack2(wa::ex2(fmaf(x[0], kScore, nb_lo)), wa::ex2(fmaf(x[1], kScore, nb_lo)));
        pa[kk][1] = wa::pack2(wa::ex2(fmaf(x[2], kScore, nb_hi)), wa::ex2(fmaf(x[3], kScore, nb_hi)));
        sum_lo += wa::lo_of(pa[kk][0]) + wa::hi_of(pa[kk][0]);
        sum_hi += wa::lo_of(pa[kk][1]) + wa::hi_of(pa[kk][1]);
        if (2 * kk + 1 < NTT) {
          const float(&y)[4] = sf[2 * kk + 1 < NTT ? 2 * kk + 1 : 0];
          pa[kk][2] = wa::pack2(wa::ex2(fmaf(y[0], kScore, nb_lo)), wa::ex2(fmaf(y[1], kScore, nb_lo)));
          pa[kk][3] = wa::pack2(wa::ex2(fmaf(y[2], kScore, nb_hi)), wa::ex2(fmaf(y[3], kScore, nb_hi)));
          sum_lo += wa::lo_of(pa[kk][2]) + wa::hi_of(pa[kk][2]);
          sum_hi += wa::lo_of(pa[kk][3]) + wa::hi_of(pa[kk][3]);
        } else {
          pa[kk][2] = pa[kk][3] = 0u;
        }
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
      // rescale O where a row's max moved (a factor of exactly 1 elsewhere)
      if (__any_sync(0xffffffffu, corr_lo != 1.f || corr_hi != 1.f)) {
#pragma unroll
        for (int j = 0; j < NA / 8; ++j) {
          o[4 * j] *= corr_lo;
          o[4 * j + 1] *= corr_lo;
          o[4 * j + 2] *= corr_hi;
          o[4 * j + 3] *= corr_hi;
        }
        if constexpr (wa::n_parts<HD>() == 2) {
#pragma unroll
          for (int j = 0; j < NB / 8; ++j) {
            o1[4 * j] *= corr_lo;
            o1[4 * j + 1] *= corr_lo;
            o1[4 * j + 2] *= corr_hi;
            o1[4 * j + 3] *= corr_hi;
          }
        }
      }
    } else {  // no row of this warp is below n: p = 0 leaves its O rows alone
#pragma unroll
      for (int kk = 0; kk < KTT; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    }

    // O += P V
    wa::fence_regs(o);
    wa::fence_regs(o1);
    wa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KTT; ++kk) {
      wa::wgmma_rs(o, pa[kk], wa::make_desc<W0>(vt_s + kk * 16 * W0));
      if constexpr (wa::n_parts<HD>() == 2)
        wa::wgmma_rs(o1, pa[kk], wa::make_desc<W1>(vt_s + p1 + kk * 16 * W1));
    }
    wa::wgmma_commit();
    wa::wgmma_wait0();
    wa::fence_regs(o);
    wa::fence_regs(o1);
    wa::fence_regs(pa);
  };

  const int last = n - wa::kTileKeys * (L.n_kt - 1);  // keys of the last tile
  for (int kt = 0; kt < L.n_kt; ++kt) {
    __syncwarp();
    wa::mbar_wait(&full[kt], 0);
    if (kt < L.n_kt - 1 || last == wa::kTileKeys)
      tile_step(std::integral_constant<int, 8>{}, std::true_type{}, kt, wa::part_offset(1), TB);
    else if (last > kTailKeys)
      tile_step(std::integral_constant<int, 8>{}, std::false_type{}, kt, wa::part_offset(1), TB);
    else if (last > 8)
      tile_step(std::integral_constant<int, 2>{}, std::false_type{}, kt, kTailKeys * 128, TT);
    else
      tile_step(std::integral_constant<int, 1>{}, std::false_type{}, kt, kTailKeys * 128, TT);
  }

  // the row maximum contributes bf16(exp(0)) = 1 to l, so l >= 1 on live rows
  const float inv_lo = 1.f / fmaxf(sam6d::quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(sam6d::quad_sum(l_hi), 1e-30f);
  const int r_lo = q0 + row, r_hi = r_lo + 8;
  auto store = [&](float x0, float x1, float x2, float x3, int col) {
    if (r_lo < n)
      *reinterpret_cast<uint32_t*>(o_rows + static_cast<size_t>(r_lo) * c + col) =
          wa::pack2(x0 * inv_lo, x1 * inv_lo);
    if (r_hi < n)
      *reinterpret_cast<uint32_t*>(o_rows + static_cast<size_t>(r_hi) * c + col) =
          wa::pack2(x2 * inv_hi, x3 * inv_hi);
  };
#pragma unroll
  for (int j = 0; j < NA / 8; ++j) store(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3], 8 * j + 2 * t);
  if constexpr (wa::n_parts<HD>() == 2) {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
      store(o1[4 * j], o1[4 * j + 1], o1[4 * j + 2], o1[4 * j + 3], NA + 8 * j + 2 * t);
  }
}

// The table stage alone (a test entry): one 64-row tile a block of one
// warpgroup, formed as the attention kernel forms it, written to tables (b,
// heads, n, gh + gw) bf16, rel_h's gh entries then rel_w's gw, so a test can
// hold the stage to bf16_rel_pos_tables exactly.
template <int HD>
__global__ void __launch_bounds__(128, 1)
    relpos_window_tables_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ rel_pos_h,
                                const bf16* __restrict__ rel_pos_w, bf16* __restrict__ tables,
                                int n, int heads, int gh, int gw) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int c = heads * HD, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * wa::kRowsWG;
  unsigned char* qs = smem_raw;
  uint32_t* rel_s = reinterpret_cast<uint32_t*>(smem_raw + wa::q_tile_bytes<HD>());
  bf16* tab_h = reinterpret_cast<bf16*>(rel_s + rel_stride<HD>() * (2 * gh - 1 + 2 * gw - 1));
  bf16* tab_w = tab_h + wa::kRowsWG * rh_stride(gh);
  stage_rel_rows<HD>(rel_s, rel_pos_h, rel_pos_w, gh, gw, 128);
  load_q_tile<HD>(qs, qkv + static_cast<size_t>(b) * n * 3 * c + h * HD, 3LL * c, q0, n);
  __syncthreads();
  form_tables<HD>(qs, rel_s, tab_h, tab_w, q0, n, gh, gw);
  __syncthreads();
  const int w = gh + gw;
  bf16* dst = tables + ((static_cast<size_t>(b) * heads + h) * n + q0) * w;
  for (int e = threadIdx.x; e < wa::kRowsWG * w; e += 128) {
    const int r = e / w, j = e - r * w;
    if (q0 + r < n) dst[e] = j < gh ? tab_h[r * rh_stride(gh) + j] : tab_w[r * rw_stride(gw) + j - gh];
  }
}

template <int HD>
size_t smem_bytes(int n, int gh, int gw) { return Layout<HD>(n, gh, gw).total; }

template <int HD>
int launch(const void* qkv, const void* rel_pos_h, const void* rel_pos_w, void* out, int b, int n,
           int heads, int gh, int gw, float scale, cudaStream_t stream) {
  const Layout<HD> L(n, gh, gw);
  if (L.total > kMaxSmemBf16) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps{};
  const long long c = static_cast<long long>(heads) * HD;
  const long long strides[3] = {n * 3 * c, HD, 3 * c};  // q's head-major view of qkv
  int err = wa::encode_operand_maps<HD>(maps.q, qkv, strides, b, heads, n, HD);
  if (err == 0) err = wa::encode_qkv_maps<HD>(maps.full, qkv, b, n, heads);
  if (err == 0 && L.short_tail) err = wa::encode_qkv_maps<HD>(maps.tail, qkv, b, n, heads, kTailKeys);
  if (err != 0) return err;
  err = static_cast<int>(cudaFuncSetAttribute(attention_relpos_window_kernel<HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(L.total)));
  if (err != 0) return err;
  // two row tiles a block (see the design notes above)
  const int blocks = ((n + wa::kRowsWG - 1) / wa::kRowsWG + wa::kWarpgroups - 1) / wa::kWarpgroups;
  attention_relpos_window_kernel<HD><<<dim3(blocks, heads, b), wa::kThreads, L.total, stream>>>(
      maps, static_cast<const bf16*>(rel_pos_h), static_cast<const bf16*>(rel_pos_w),
      static_cast<bf16*>(out), n, heads, gh, gw, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tables(const void* qkv, const void* rel_pos_h, const void* rel_pos_w, void* tables, int b,
                  int n, int heads, int gh, int gw, cudaStream_t stream) {
  const size_t bytes = wa::q_tile_bytes<HD>() +
                       sizeof(uint32_t) * rel_stride<HD>() * (2 * gh - 1 + 2 * gw - 1) +
                       sizeof(bf16) * wa::kRowsWG * (rh_stride(gh) + rw_stride(gw));
  if (bytes > kMaxSmemBf16) return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaFuncSetAttribute(relpos_window_tables_kernel<HD>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(bytes)));
  if (err != 0) return err;
  relpos_window_tables_kernel<HD><<<dim3((n + wa::kRowsWG - 1) / wa::kRowsWG, heads, b), 128, bytes,
                                    stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_pos_h),
      static_cast<const bf16*>(rel_pos_w), static_cast<bf16*>(tables), n, heads, gh, gw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace window

// The streaming launch: grids longer than the ring (SAM's 64 x 64 global
// blocks), two row tiles a block, K/V through two stages.
template <int HD>
__global__ void __launch_bounds__(sam6d::wgattn::kThreads, 2)
    attention_relpos_wgmma_kernel(const __grid_constant__ sam6d::wgattn::KVMaps maps,
                                  const sam6d::wgattn::bf16* __restrict__ qkv,
                                  const sam6d::wgattn::bf16* __restrict__ rel_pos_h,
                                  const sam6d::wgattn::bf16* __restrict__ rel_pos_w,
                                  sam6d::wgattn::bf16* __restrict__ out, int n, int heads,
                                  int gh, int gw, int row_tiles, float scale) {
  namespace wa = sam6d::wgattn;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wa::checked_base(smem_raw);
  const int c = heads * HD;
  const int b = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x / 128;
  unsigned char* bias_smem = smem + wa::core_smem_bytes<HD>(n);
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(bias_smem) + wg * wa::kRowsWG * (gh + gw + 3);
  float* scratch = reinterpret_cast<float*>(bias_smem + tables_bytes_bf16(gh, gw)) + wg * 4 * 2 * HD;
  const int lane = threadIdx.x % 32;
  const RelPosBiasBf16<HD> bias{tab, tab + wa::kRowsWG * (gh + 1), gh, gw,
                          static_cast<int>(threadIdx.x % 128 / 32) * 16 + lane / 4,
                          rel_pos_h, rel_pos_w, scratch};
  const wa::Tiles op{qkv + static_cast<size_t>(b) * n * 3 * c + h * HD,
                     out + static_cast<size_t>(b) * n * c + h * HD,
                     3LL * c, c, n, n, HD, h, b};
  const int rt0 = blockIdx.x * row_tiles;
  wa::attend<HD>(maps, op, smem, rt0, min(row_tiles, (n + wa::kRowsWG - 1) / wa::kRowsWG - rt0),
                 scale, wa::kLog2e, bias);
}

template <int HD>
int launch_bf16(const void* qkv, const void* rel_pos_h, const void* rel_pos_w, void* out,
                int b, int n, int heads, int gh, int gw, float scale, cudaStream_t stream) {
  namespace wa = sam6d::wgattn;
  const size_t bytes = smem_bytes_bf16<HD>(n, gh, gw);
  if (bytes > kMaxSmemBf16) return static_cast<int>(cudaErrorInvalidValue);
  wa::KVMaps maps;
  int err = wa::encode_qkv_maps<HD>(maps, qkv, b, n, heads);
  if (err != 0) return err;
  err = static_cast<int>(cudaFuncSetAttribute(attention_relpos_wgmma_kernel<HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(bytes)));
  if (err != 0) return err;
  const int row_tiles = wa::row_tiles_per_block<HD>(n, n);
  const dim3 grid(((n + wa::kRowsWG - 1) / wa::kRowsWG + row_tiles - 1) / row_tiles, heads, b);
  attention_relpos_wgmma_kernel<HD><<<grid, wa::kThreads, bytes, stream>>>(
      maps, static_cast<const wa::bf16*>(qkv), static_cast<const wa::bf16*>(rel_pos_h),
      static_cast<const wa::bf16*>(rel_pos_w), static_cast<wa::bf16*>(out), n, heads, gh, gw,
      row_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// keys that fit the ring: the windowed launch; longer ones stream
template <int HD>
bool resident(int n) {
  return (n + sam6d::wgattn::kTileKeys - 1) / sam6d::wgattn::kTileKeys <=
         sam6d::wgattn::max_resident<HD>();
}

template <int HD>
int launch_bf16_any(const void* qkv, const void* rel_pos_h, const void* rel_pos_w, void* out,
                    int b, int n, int heads, int gh, int gw, float scale, cudaStream_t stream) {
  return resident<HD>(n) ? window::launch<HD>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw,
                                              scale, stream)
                         : launch_bf16<HD>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw,
                                           scale, stream);
}

template <int HD>
size_t smem_bytes_bf16_any(int n, int gh, int gw) {
  return resident<HD>(n) ? window::smem_bytes<HD>(n, gh, gw) : smem_bytes_bf16<HD>(n, gh, gw);
}

}  // namespace

extern "C" {

// qkv: (b, n, 3 * heads * hd) float32; rel_pos_h: (2 gh - 1, hd);
// rel_pos_w: (2 gw - 1, hd), all three 16-byte aligned; workspace:
// sam6d_flash_attention_relpos_workspace_bytes bytes, 16-byte aligned (the
// split K and V planes); out: (b, n, heads * hd). n == gh * gw; hd one of 16,
// 32, 64, 80. Two launches on `stream`. Returns the CUDA error code of the
// launch (0 on success; cudaErrorInvalidValue for an unsupported hd, or a grid
// whose table rows leave no room for a ring of two tiles in 227 KB).
int sam6d_flash_attention_relpos(const float* qkv, const float* rel_pos_h,
                                 const float* rel_pos_w, void* workspace, float* out, int b,
                                 int n, int heads, int hd, int gh, int gw, float scale,
                                 cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return tf32::launch<16>(qkv, rel_pos_h, rel_pos_w, workspace, out, b, n, heads, gh, gw, scale, false, stream);
    case 32: return tf32::launch<32>(qkv, rel_pos_h, rel_pos_w, workspace, out, b, n, heads, gh, gw, scale, false, stream);
    case 64: return tf32::launch<64>(qkv, rel_pos_h, rel_pos_w, workspace, out, b, n, heads, gh, gw, scale, false, stream);
    case 80: return tf32::launch<80>(qkv, rel_pos_h, rel_pos_w, workspace, out, b, n, heads, gh, gw, scale, false, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of the fp32 entry's workspace: per (sample, head) 16 * hd bytes a
// key of n rounded up to the key tile (sam6d_flash_attention_relpos_key_tile),
// then 8 * hd * key tile bytes for each key tile's worth of rows of the two
// rel-pos tables; -1 for an hd it does not take.
long long sam6d_flash_attention_relpos_workspace_bytes(int b, int n, int heads, int hd, int gh,
                                                      int gw) {
  switch (hd) {
    case 16: return static_cast<long long>(tf32::workspace_bytes<16>(b, n, heads, gh, gw));
    case 32: return static_cast<long long>(tf32::workspace_bytes<32>(b, n, heads, gh, gw));
    case 64: return static_cast<long long>(tf32::workspace_bytes<64>(b, n, heads, gh, gw));
    case 80: return static_cast<long long>(tf32::workspace_bytes<80>(b, n, heads, gh, gw));
    default: return -1;
  }
}

// Keys of the fp32 entry's K/V tiles (and rel-pos rows of its rel-pos tiles).
int sam6d_flash_attention_relpos_key_tile() { return tf32::BK; }

// The fp32 entry's pre-pass alone (a test entry): K (times `scale`), V and
// the rel-pos rows split into `workspace` as the attention kernel reads
// them. Same operands as sam6d_flash_attention_relpos. Returns the CUDA
// error code.
int sam6d_flash_attention_relpos_split_kv(const float* qkv, const float* rel_pos_h,
                                          const float* rel_pos_w, void* workspace, int b, int n,
                                          int heads, int hd, int gh, int gw, float scale,
                                          cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return tf32::launch<16>(qkv, rel_pos_h, rel_pos_w, workspace, nullptr, b, n, heads, gh, gw, scale, true, stream);
    case 32: return tf32::launch<32>(qkv, rel_pos_h, rel_pos_w, workspace, nullptr, b, n, heads, gh, gw, scale, true, stream);
    case 64: return tf32::launch<64>(qkv, rel_pos_h, rel_pos_w, workspace, nullptr, b, n, heads, gh, gw, scale, true, stream);
    case 80: return tf32::launch<80>(qkv, rel_pos_h, rel_pos_w, workspace, nullptr, b, n, heads, gh, gw, scale, true, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory, bytes, of a block of the fp32 entry's attention
// kernel on a gh x gw grid (n == gh * gw keys) at head dim hd, as its launch
// sizes it (a ring of 4 tiles, else 3 or 2; above 227 KB where not even 2
// fit: the launch refuses it); -1 for an hd it does not take.
int sam6d_flash_attention_relpos_smem(int n, int hd, int gh, int gw) {
  switch (hd) {
    case 16: return static_cast<int>(tf32::smem_bytes<16>(gh, gw));
    case 32: return static_cast<int>(tf32::smem_bytes<32>(gh, gw));
    case 64: return static_cast<int>(tf32::smem_bytes<64>(gh, gw));
    case 80: return static_cast<int>(tf32::smem_bytes<80>(gh, gw));
    default: return -1;
  }
}

// The bf16 entry: qkv (b, n, 3 * heads * hd), rel_pos_h (2 gh - 1, hd),
// rel_pos_w (2 gw - 1, hd) and out (b, n, heads * hd), all bfloat16, qkv
// and the tables 16-byte aligned. `scale` is hd^-0.5 rounded to
// bf16: q enters the product as bf16(q * scale). n == gh * gw; hd one of
// 16, 32, 64, 80. Keys that fit the ring take the windowed kernel, longer
// sequences the streaming one. Returns the CUDA error code of the launch
// (cudaErrorInvalidValue where the block's shared memory would pass 227 KB:
// sam6d_flash_attention_relpos_bf16_tables_bytes is then > 0).
int sam6d_flash_attention_relpos_bf16(const void* qkv, const void* rel_pos_h,
                                      const void* rel_pos_w, void* out, int b, int n,
                                      int heads, int hd, int gh, int gw, float scale,
                                      cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_bf16_any<16>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 32: return launch_bf16_any<32>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 64: return launch_bf16_any<64>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 80: return launch_bf16_any<80>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 entry for a grid whose tables do not fit shared memory beside the
// ring: the same contract, the tables formed by a pre-pass into `tables`
// (sam6d_flash_attention_relpos_bf16_tables_bytes bytes, 16-byte aligned)
// and read from there. Two launches on `stream`.
int sam6d_flash_attention_relpos_bf16_global(const void* qkv, const void* rel_pos_h,
                                             const void* rel_pos_w, void* tables, void* out,
                                             int b, int n, int heads, int hd, int gh, int gw,
                                             float scale, cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_bf16_global<16>(qkv, rel_pos_h, rel_pos_w, tables, out, b, n, heads, gh, gw, scale, stream);
    case 32: return launch_bf16_global<32>(qkv, rel_pos_h, rel_pos_w, tables, out, b, n, heads, gh, gw, scale, stream);
    case 64: return launch_bf16_global<64>(qkv, rel_pos_h, rel_pos_w, tables, out, b, n, heads, gh, gw, scale, stream);
    case 80: return launch_bf16_global<80>(qkv, rel_pos_h, rel_pos_w, tables, out, b, n, heads, gh, gw, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory, bytes, of a block of the bf16 entry on a gh x gw
// grid (n == gh * gw keys) at head dim hd, as its launch sizes it; -1 for an
// hd it does not take. The launch refuses a size above 227 KB.
int sam6d_flash_attention_relpos_bf16_smem(int n, int hd, int gh, int gw) {
  switch (hd) {
    case 16: return static_cast<int>(smem_bytes_bf16_any<16>(n, gh, gw));
    case 32: return static_cast<int>(smem_bytes_bf16_any<32>(n, gh, gw));
    case 64: return static_cast<int>(smem_bytes_bf16_any<64>(n, gh, gw));
    case 80: return static_cast<int>(smem_bytes_bf16_any<80>(n, gh, gw));
    default: return -1;
  }
}

// The windowed launch's table stage alone (a test entry): tables (b, heads,
// n, gh + gw) bfloat16 receives each query's rel_h entries then its rel_w
// ones, formed as the attention kernel forms them. Same operands as
// sam6d_flash_attention_relpos_bf16. Returns the CUDA error code.
int sam6d_flash_attention_relpos_bf16_window_tables(const void* qkv, const void* rel_pos_h,
                                                    const void* rel_pos_w, void* tables, int b,
                                                    int n, int heads, int hd, int gh, int gw,
                                                    cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return window::launch_tables<16>(qkv, rel_pos_h, rel_pos_w, tables, b, n, heads, gh, gw, stream);
    case 32: return window::launch_tables<32>(qkv, rel_pos_h, rel_pos_w, tables, b, n, heads, gh, gw, stream);
    case 64: return window::launch_tables<64>(qkv, rel_pos_h, rel_pos_w, tables, b, n, heads, gh, gw, stream);
    case 80: return window::launch_tables<80>(qkv, rel_pos_h, rel_pos_w, tables, b, n, heads, gh, gw, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of the global tables the bf16 entry needs on a gh x gw grid at head
// dim hd: 0 where its tables fit shared memory beside the ring (the launch
// of sam6d_flash_attention_relpos_bf16), else the workspace of
// sam6d_flash_attention_relpos_bf16_global; -1 for an hd it does not take.
long long sam6d_flash_attention_relpos_bf16_tables_bytes(int b, int n, int heads, int hd,
                                                         int gh, int gw) {
  const int smem = sam6d_flash_attention_relpos_bf16_smem(n, hd, gh, gw);
  if (smem < 0) return -1;
  if (static_cast<size_t>(smem) <= kMaxSmemBf16) return 0;
  return static_cast<long long>(sizeof(__nv_bfloat16)) * b * heads * table_entries(n, gh, gw);
}

}  // extern "C"
