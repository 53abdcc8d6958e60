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
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;
constexpr int kMinBlocks = 3;   // resident blocks per SM the registers must allow
constexpr int kTileKeys = 16;   // keys per K/V tile

template <int HD>
size_t smem_bytes(int gh, int gw) {
  return sam6d::core_smem_bytes<HD, kWarps, kTileKeys>() + sizeof(float) * kRows * (gh + gw + 2);
}

template <int HD>
struct RelPosBias {
  float* tab_h;          // [kRows][gh + 1] in shared memory
  float* tab_w;          // [kRows][gw + 1]
  const float* pos_h;    // rel_pos_h (2 gh - 1, HD)
  const float* pos_w;    // rel_pos_w (2 gw - 1, HD)
  int gh, gw;
  int row;               // the lane's row g in the block

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
      if (j < gh)
        tab_h[r * (gh + 1) + j] = acc;
      else
        tab_w[r * (gw + 1) + j - gh] = acc;
    }
  }

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
  const RelPosBias<HD> bias{tab_h, tab_h + kRows * (gh + 1), rel_pos_h, rel_pos_w, gh, gw,
                            static_cast<int>(threadIdx.x / 32) * 16 + static_cast<int>(threadIdx.x % 32) / 4};
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

}  // extern "C"
