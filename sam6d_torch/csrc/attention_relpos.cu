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
// The bf16 entry (sam6d_flash_attention_relpos_bf16) is the bf16 core of
// bf16_attention.cuh (one-pass bf16 mma.sync m16n8k16, fp32 scores and
// softmax, p rounded to bf16) with the same tables, formed in fp32 from the
// bf16 q rows and rel-pos rows and rounded to bf16 as the TPU wrapper's
// cast does; q enters as bf16(q * bf16(scale)), the TPU kernel's q_aug. On
// an H100 SXM's dense bf16 rate (989 TFLOP/s) a global block's products
// take 0.087 ms and its bytes (42 MB) 0.013 ms: operations. 4 warps, 32-key
// tiles, q fragments in registers; 66 KB of shared memory at the global
// shape (two K/V stages, the tables, the block's q rows staged for them).
#include "bf16_attention.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;
constexpr int kMinBlocks = 3;   // resident blocks per SM the registers must allow
constexpr int kTileKeys = 16;   // keys per K/V tile

constexpr int kTileKeysBf16 = 32;  // keys per K/V tile of the bf16 entry

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
// fp32 scores. The block's q rows are staged in shared memory first, rows
// of HD / 2 + 1 words (an odd pitch, so a warp's 32 rows read one word
// each without a conflict): read from global memory a row a lane, they
// made a first version of this entry as slow as the fp32 one. Rel-pos rows
// are read 16 bytes a load.
template <int HD>
__host__ __device__ constexpr int staged_q_words() { return HD / 2 + 1; }

template <int HD>
struct RelPosBiasBf16 : RelPosAdd {
  const sam6d::bf16attn::bf16* pos_h;
  const sam6d::bf16attn::bf16* pos_w;
  uint32_t* qs;          // [kRows][staged_q_words] in shared memory

  __device__ __forceinline__ void prepare(const sam6d::bf16attn::Operands& op, int q0) const {
    using sam6d::bf16attn::hi_of;
    using sam6d::bf16attn::lo_of;
    constexpr int QW = staged_q_words<HD>();
    for (int e = threadIdx.x; e < kRows * (HD / 2); e += kWarps * 32) {
      const int r = e / (HD / 2), wd = e - r * (HD / 2);
      const int tok = q0 + r;
      qs[r * QW + wd] =
          tok < op.nq ? __ldg(reinterpret_cast<const unsigned int*>(op.q + tok * op.sq) + wd)
                      : 0u;
    }
    __syncthreads();
    const int w = gh + gw;
    for (int e = threadIdx.x; e < kRows * w; e += kWarps * 32) {
      const int j = e / kRows, r = e - j * kRows;
      const int tok = q0 + r;
      float acc = 0.f;
      if (tok < op.nq) {
        const auto* rp = j < gh ? pos_h + (tok / gw - j + gh - 1) * HD
                                : pos_w + (tok % gw - (j - gh) + gw - 1) * HD;
        const uint32_t* qr = qs + r * QW;
        float2 part = make_float2(0.f, 0.f);
#pragma unroll
        for (int d = 0; d < HD; d += 8) {
          const uint4 b = __ldg(reinterpret_cast<const uint4*>(rp + d));
          const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t a = qr[d / 2 + i];
            part.x = fmaf(lo_of(a), lo_of(bw[i]), part.x);
            part.y = fmaf(hi_of(a), hi_of(bw[i]), part.y);
          }
        }
        acc = sam6d::bf16attn::round_bf16(part.x + part.y);
      }
      store(j, r, acc);
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

// the bf16 entry: two K/V stages, the tables, the staged q rows
template <int HD>
size_t smem_bytes_bf16(int gh, int gw) {
  return sam6d::bf16attn::core_smem_bytes<HD, kTileKeysBf16>() +
         sizeof(float) * kRows * (gh + gw + 2) + sizeof(uint32_t) * kRows * staged_q_words<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attention_relpos_bf16_kernel(const sam6d::bf16attn::bf16* __restrict__ qkv,
                                 const sam6d::bf16attn::bf16* __restrict__ rel_pos_h,
                                 const sam6d::bf16attn::bf16* __restrict__ rel_pos_w,
                                 sam6d::bf16attn::bf16* __restrict__ out, int n, int heads,
                                 int gh, int gw, float scale) {
  namespace b16 = sam6d::bf16attn;
  extern __shared__ float4 smem4[];
  float* tab_h = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                          b16::core_smem_bytes<HD, kTileKeysBf16>());
  const int c = heads * HD;
  const b16::bf16* q = qkv + static_cast<size_t>(blockIdx.z) * n * 3 * c + blockIdx.y * HD;
  const long long rs = 3LL * c;
  const b16::Operands op{q, q + c, q + 2 * c,
                         out + static_cast<size_t>(blockIdx.z) * n * c + blockIdx.y * HD,
                         rs, rs, rs, c, n, n, HD};
  uint32_t* qs = reinterpret_cast<uint32_t*>(tab_h + kRows * (gh + gw + 2));
  const RelPosBiasBf16<HD> bias{{tab_h, tab_h + kRows * (gh + 1), gh, gw, lane_row()},
                                rel_pos_h, rel_pos_w, qs};
  b16::attention_rows<HD, kWarps, kTileKeysBf16, true>(
      op, reinterpret_cast<b16::bf16*>(smem4), blockIdx.x * kRows, scale, bias);
}

template <int HD>
int launch_bf16(const void* qkv, const void* rel_pos_h, const void* rel_pos_w, void* out,
                int b, int n, int heads, int gh, int gw, float scale, cudaStream_t stream) {
  using sam6d::bf16attn::bf16;
  const size_t bytes = smem_bytes_bf16<HD>(gh, gw);
  cudaError_t err = cudaFuncSetAttribute(
      attention_relpos_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, heads, b);
  attention_relpos_bf16_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_pos_h),
      static_cast<const bf16*>(rel_pos_w), static_cast<bf16*>(out), n, heads, gh, gw, scale);
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

}  // extern "C"
