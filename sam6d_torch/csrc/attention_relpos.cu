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
// Design: the three-pass TF32 attention core of tf32x3.cuh (q rows in
// shared memory, K/V tiles double-buffered with cp.async straight from the
// strided qkv, online softmax in registers), 4 warps of 16 query rows per
// block, with this bias:
//  - prepare(): the block forms its rows of both tables from the unscaled q
//    rows in shared memory and rel_pos_h / rel_pos_w (read through L1), on
//    the fp32 units (gh + gw dot products of HD a row: 1.6% of the
//    products' operations at the global shape, 7% at the windowed one), so
//    no table reaches memory; two einsums outside take longer than the
//    windowed kernel itself (PERF.md);
//  - add(): each lane adds rel_h + rel_w from shared memory to its score
//    fragments (rows g, g+8; keys 2t, 2t+1 of each 8-key tile), with
//    key / gw and key % gw stepped once per tile, not divided per element.
// 16-key tiles keep the block's shared memory (q, two K/V stages, tables:
// 75 KB at the global shape) within three blocks an SM. At the windowed
// shape (N = 196) the fourth row block holds one live warp, and the last
// key tile (4 keys) runs one n8 tile of its two.
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
// 196 keys stay resident in the ring (one block takes all four row tiles),
// a global one's 4096 stream through two stages (one block a 128 rows);
// 98-116 KB of shared memory and at most 128 registers let two blocks
// share an SM.
#include "bf16_wgmma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;
constexpr int kMinBlocks = 3;   // resident blocks per SM the registers must allow
constexpr int kTileKeys = 16;   // keys per K/V tile

// shared memory a block of the bf16 entry may take (an H100's 227 KB)
constexpr size_t kMaxSmemBf16 = 232448;

template <int HD>
size_t smem_bytes(int gh, int gw) {
  return sam6d::core_smem_bytes<HD, kWarps, kTileKeys>() + sizeof(float) * kRows * (gh + gw + 2);
}


// the lane's row g in the block
__device__ __forceinline__ int lane_row() {
  return static_cast<int>(threadIdx.x / 32) * 16 + static_cast<int>(threadIdx.x % 32) / 4;
}

// The block's rows of the two tables in shared memory, and their add to a
// lane's score fragments; the C fragment layout of the fp32 core's m16n8k8
// and of the bf16 core's m16n8k16 is the same.
struct RelPosAdd {
  float* tab_h;          // [kRows][gh + 1] in shared memory
  float* tab_w;          // [kRows][gw + 1]
  int gh, gw;
  int row;               // the lane's row g in the block

  template <int NT>
  __device__ __forceinline__ void add(float (&s)[NT][4], int k0, int nk, int t) const {
    const float* rh_lo = tab_h + row * (gh + 1);
    const float* rh_hi = rh_lo + 8 * (gh + 1);
    const float* rw_lo = tab_w + row * (gw + 1);
    const float* rw_hi = rw_lo + 8 * (gw + 1);
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
        s[nt][0] += rh_lo[kr] + rw_lo[kc];
        s[nt][2] += rh_hi[kr] + rw_hi[kc];
      }
      if (j + 1 < nk) {
        s[nt][1] += rh_lo[kr1] + rw_lo[kc1];
        s[nt][3] += rh_hi[kr1] + rw_hi[kc1];
      }
      kc += 8;
      while (kc >= gw) {
        kc -= gw;
        ++kr;
      }
    }
  }

  // entry e of the block's kRows x (gh + gw) table entries: column j, row r
  __device__ __forceinline__ void store(int j, int r, float x) const {
    if (j < gh)
      tab_h[r * (gh + 1) + j] = x;
    else
      tab_w[r * (gw + 1) + j - gh] = x;
  }
};

template <int HD>
struct RelPosBias : RelPosAdd {
  const float* pos_h;    // rel_pos_h (2 gh - 1, HD)
  const float* pos_w;    // rel_pos_w (2 gw - 1, HD)

  // Consecutive threads take consecutive rows of one table column j, so a
  // warp's rel_pos_h reads fall on one row (a broadcast) and its rel_pos_w
  // reads on neighbouring rows. Lanes on different rel_pos rows would each
  // fetch their own row from L2 (L1 is mostly shared memory here), and at
  // the global shape that traffic cost more than the products' time it is
  // meant to save. Table rows are padded by one float so these stores do
  // not conflict.
  __device__ __forceinline__ void prepare(const float* qs, int ld, int q0, int n) const {
    const int w = gh + gw;
    for (int e = threadIdx.x; e < kRows * w; e += kWarps * 32) {
      const int j = e / kRows, r = e - j * kRows;
      const int tok = q0 + r;
      float acc = 0.f;
      if (tok < n) {
        const float* rp = j < gh ? pos_h + (tok / gw - j + gh - 1) * HD
                                 : pos_w + (tok % gw - (j - gh) + gw - 1) * HD;
        const float* qr = qs + r * ld;
        float4 part = make_float4(0.f, 0.f, 0.f, 0.f);  // four short FMA chains
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 b = __ldg(reinterpret_cast<const float4*>(rp + d));
          part.x = fmaf(a.x, b.x, part.x);
          part.y = fmaf(a.y, b.y, part.y);
          part.z = fmaf(a.z, b.z, part.z);
          part.w = fmaf(a.w, b.w, part.w);
        }
        acc = (part.x + part.y) + (part.z + part.w);
      }
      store(j, r, acc);
    }
  }
};

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
  __nv_bfloat16* tab_h;  // [64][gh + 1]: the warpgroup's rows, in shared memory
  __nv_bfloat16* tab_w;  // [64][gw + 2]
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

template <int HD>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    attention_relpos_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ rel_pos_h,
                            const float* __restrict__ rel_pos_w,
                            float* __restrict__ out, int n, int heads, int gh,
                            int gw, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tab_h = smem + sam6d::core_smem_bytes<HD, kWarps, kTileKeys>() / sizeof(float);
  const int c = heads * HD;
  const float* q = qkv + static_cast<size_t>(blockIdx.z) * n * 3 * c + blockIdx.y * HD;
  const long long rs = 3LL * c;
  const sam6d::Operands op{q, q + c, q + 2 * c,
                           out + static_cast<size_t>(blockIdx.z) * n * c + blockIdx.y * HD,
                           rs, rs, rs, c, n, n, HD};
  const RelPosBias<HD> bias{{tab_h, tab_h + kRows * (gh + 1), gh, gw, lane_row()}, rel_pos_h,
                            rel_pos_w};
  sam6d::attention_rows<HD, kWarps, kTileKeys, sam6d::Staging::kSplitPerFragment>(
      op, smem, blockIdx.x * kRows, scale, bias);
}

template <int HD>
int launch(const float* qkv, const float* rel_pos_h, const float* rel_pos_w, float* out,
           int b, int n, int heads, int gh, int gw, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>(gh, gw);
  cudaError_t err = cudaFuncSetAttribute(
      attention_relpos_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, heads, b);
  attention_relpos_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      qkv, rel_pos_h, rel_pos_w, out, n, heads, gh, gw, scale);
  return static_cast<int>(cudaGetLastError());
}

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

template <int HD>
__global__ void __launch_bounds__(sam6d::wgattn::kThreads, 2)
    attention_relpos_wgmma_kernel(const __grid_constant__ CUtensorMap kv0,
                                  const __grid_constant__ CUtensorMap kv1,
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
                     3LL * c, c, n, b * n, c + h * HD, 2 * c + h * HD};
  const int rt0 = blockIdx.x * row_tiles;
  wa::attend<HD>(&kv0, &kv1, op, smem, rt0, min(row_tiles, (n + wa::kRowsWG - 1) / wa::kRowsWG - rt0),
                 scale, wa::kLog2e, bias);
}

template <int HD>
int launch_bf16(const void* qkv, const void* rel_pos_h, const void* rel_pos_w, void* out,
                int b, int n, int heads, int gh, int gw, float scale, cudaStream_t stream) {
  namespace wa = sam6d::wgattn;
  const size_t bytes = smem_bytes_bf16<HD>(n, gh, gw);
  if (bytes > kMaxSmemBf16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kv[2];
  int err = wa::encode_kv_maps<HD>(kv, qkv, static_cast<long long>(b) * n, 3LL * heads * HD);
  if (err != 0) return err;
  err = static_cast<int>(cudaFuncSetAttribute(attention_relpos_wgmma_kernel<HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(bytes)));
  if (err != 0) return err;
  const int row_tiles = wa::row_tiles_per_block<HD>(n);
  const dim3 grid(((n + wa::kRowsWG - 1) / wa::kRowsWG + row_tiles - 1) / row_tiles, heads, b);
  attention_relpos_wgmma_kernel<HD><<<grid, wa::kThreads, bytes, stream>>>(
      kv[0], kv[1], static_cast<const wa::bf16*>(qkv), static_cast<const wa::bf16*>(rel_pos_h),
      static_cast<const wa::bf16*>(rel_pos_w), static_cast<wa::bf16*>(out), n, heads, gh, gw,
      row_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: (b, n, 3 * heads * hd) float32; rel_pos_h: (2 gh - 1, hd);
// rel_pos_w: (2 gw - 1, hd), all three 16-byte aligned; out: (b, n, heads *
// hd). n == gh * gw; hd one of 16, 32, 64, 80. Returns the CUDA error code
// of the launch (0 on success; cudaErrorInvalidValue for an unsupported hd).
int sam6d_flash_attention_relpos(const float* qkv, const float* rel_pos_h,
                                 const float* rel_pos_w, float* out, int b, int n,
                                 int heads, int hd, int gh, int gw, float scale,
                                 cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch<16>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 32: return launch<32>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 64: return launch<64>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 80: return launch<80>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 entry: qkv (b, n, 3 * heads * hd), rel_pos_h (2 gh - 1, hd),
// rel_pos_w (2 gw - 1, hd) and out (b, n, heads * hd), all bfloat16, qkv
// and the tables 16-byte aligned. `scale` is hd^-0.5 rounded to
// bf16: q enters the product as bf16(q * scale). n == gh * gw; hd one of
// 16, 32, 64, 80. Returns the CUDA error code of the launch.
int sam6d_flash_attention_relpos_bf16(const void* qkv, const void* rel_pos_h,
                                      const void* rel_pos_w, void* out, int b, int n,
                                      int heads, int hd, int gh, int gw, float scale,
                                      cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_bf16<16>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 32: return launch_bf16<32>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 64: return launch_bf16<64>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    case 80: return launch_bf16<80>(qkv, rel_pos_h, rel_pos_w, out, b, n, heads, gh, gw, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory, bytes, of a block of the bf16 entry on a gh x gw
// grid (n == gh * gw keys) at head dim hd, as its launch sizes it; -1 for an
// hd it does not take. The launch refuses a size above 227 KB.
int sam6d_flash_attention_relpos_bf16_smem(int n, int hd, int gh, int gw) {
  switch (hd) {
    case 16: return static_cast<int>(smem_bytes_bf16<16>(n, gh, gw));
    case 32: return static_cast<int>(smem_bytes_bf16<32>(n, gh, gw));
    case 64: return static_cast<int>(smem_bytes_bf16<64>(n, gh, gw));
    case 80: return static_cast<int>(smem_bytes_bf16<80>(n, gh, gw));
    default: return -1;
  }
}

}  // extern "C"
