// Plain softmax attention on head-major (B, H, N, hd) operands, for Hopper
// (sm_90a), plain C interface for ctypes. One kernel serves two entries:
//
// K8 replaces the Pallas kernel
// sam6d_tpu/kernels/flash_attention.py::fused_attention (through
// _fused_attention / _fused_kernel): out = softmax(q k^T * scale) v for any
// Nq and Nk (self- or cross-attention) and any hd up to 128. q, k, v and out
// are addressed through (batch, head, row) element strides with the head
// dim contiguous, so the (B, H, N, hd) views of a fused qkv projection are
// read as they lie and the output can be written straight into a (B, N, C)
// tensor. On the main path it serves the DINOv2 attentions with N > 1024
// (the ISM describe at img_size 448: 16 crops x 16 heads x 1025 x 64).
//
// K9 replaces sam6d_tpu/kernels/flash_attention.py::fused_attention_small
// (_small_kernel): the same function for short self-attention sequences,
// hd 16, 32 or 64, output (B, H, N, hd) contiguous.
//
// Scores, the running max and sum, and the accumulator are fp32. q is
// scaled before the product (the fp32 q * scale, as K8's TPU kernel and K5
// do; K9's TPU kernel scales the product instead, a difference well inside
// ATTENTION_ATOL). K8 clamps the denominator at 1e-30 as _fused_kernel
// does; K9's contract is the plain sum, which the clamp never changes (the
// row maximum contributes exp(0) = 1).
//
// What bounds them on an H100 SXM: 4*B*H*Nq*Nk*hd operations. K8 at
// 16x16x1025^2x64 is 68.9 GFLOP: 1.03 ms on the fp32 FMA units (67
// TFLOP/s), 0.417 ms on the tensor cores in three-pass TF32 (495/3 = 165
// TFLOP/s); K9 at 16x16x257^2x64 is 4.33 GFLOP: 0.065 ms and 0.026 ms. The
// bytes (q, k, v read once, out written once) take a few percent of that.
//
// Design: the three-pass TF32 core of tf32x3.cuh with split-once staging:
// 8 warps of 16 query rows per block (128 rows per K/V read), the block's q
// rows scaled and split once into TF32 big/small pairs in shared memory,
// each K/V tile (32 keys at HDP <= 64, 16 above) fetched into registers
// while the previous one computes and split once by the threads that load
// it, so B fragments are one 16-byte shared load and no arithmetic; only P
// is split per fragment. hd is padded to HDP, the next multiple of 16, by
// masked loads (zero columns add nothing to a score and are never
// written); rows that are not 16-byte aligned (hd % 4 != 0, offset views)
// take 4-byte loads. Shared memory: 110 KB at HDP 64 (two blocks, 16 warps
// an SM, at 128 registers a thread), 177 KB at HDP 128 (one block).
// Measured on an H100 (PERF.md): one block of 8 warps an SM, 4-warp
// blocks, 16-key tiles at hd 64 and two 16-row tiles a warp were all
// slower; a cp.async raw stage (the other way to split once) would add
// 16.5 KB and leave one block an SM.
//
// The bf16 entries (sam6d_fused_attention_bf16, _small_bf16) are the bf16
// core of bf16_attention.cuh: one-pass bf16 mma.sync m16n8k16 with fp32
// accumulation, fp32 scores and softmax, p rounded to bf16 and l summed
// from the rounded p. K8's q enters as bf16(q * bf16(scale)), the q_aug of
// _fused_kernel; K9 scales the fp32 product, as _small_kernel does. They
// take hd a multiple of 8 (padded to HDP with zero columns), k and v rows
// 16-byte aligned, q and out rows 4-byte aligned. K8 at 16x16x1025^2x64 is
// 68.9 GFLOP: 0.070 ms at the dense bf16 rate (989 TFLOP/s), its bytes
// (33.6 MB) 0.010 ms: operations. 4 warps of 16 rows, 64-key tiles at HDP
// <= 64, 32 above.
#include "bf16_attention.cuh"
#include "tf32x3.cuh"

namespace {

// element strides of a (B, H, N, hd) operand; the hd axis has stride 1
struct Strides {
  long long b, h, n;
};

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // query rows per block

// Keys per K/V tile and resident blocks per SM the registers must allow:
// 32 keys and two blocks at HDP <= 64 (128 registers a thread); above, the
// output fragments take twice as many registers and shared memory allows
// one block anyway, and 16-key tiles halve the prefetched tile's registers
// (32-key tiles spilled 40 bytes at HDP 128).
template <int HDP>
__host__ __device__ constexpr int tile_keys() { return HDP <= 64 ? 32 : 16; }
template <int HDP>
__host__ __device__ constexpr int min_blocks() { return HDP <= 64 ? 2 : 1; }

template <int HDP>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<HDP>())
    head_major_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out,
                                Strides sq, Strides sk, Strides sv, Strides so, int nq,
                                int nk, int hd, float scale) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.y, b = blockIdx.z;
  const sam6d::Operands op{q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
                           v + b * sv.b + h * sv.h, out + b * so.b + h * so.h,
                           sq.n, sk.n, sv.n, so.n, nq, nk, hd};
  sam6d::attention_rows<HDP, kWarps, tile_keys<HDP>(), sam6d::Staging::kSplitOnce>(
      op, reinterpret_cast<float*>(smem4), blockIdx.x * kRows, scale, sam6d::NoBias{});
}

template <int HDP>
int launch(const float* q, const float* k, const float* v, float* out, Strides sq,
           Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk, int hd,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes =
      sam6d::core_smem_bytes<HDP, kWarps, tile_keys<HDP>(), sam6d::Staging::kSplitOnce>();
  cudaError_t err = cudaFuncSetAttribute(head_major_attention_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kRows - 1) / kRows, heads, b);
  head_major_attention_kernel<HDP><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, nq, nk, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_padded(const float* q, const float* k, const float* v, float* out, Strides sq,
                  Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk,
                  int hd, float scale, cudaStream_t stream) {
  if (hd < 1 || nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 2: return launch<32>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 3: return launch<48>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 4: return launch<64>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 5: return launch<80>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 6: return launch<96>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 7: return launch<112>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 8: return launch<128>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HDP>
__host__ __device__ constexpr int tile_keys_bf16() { return HDP <= 64 ? 64 : 32; }
constexpr int kWarpsBf16 = 4;
constexpr int kRowsBf16 = 16 * kWarpsBf16;

template <int HDP>
__global__ void __launch_bounds__(kWarpsBf16 * 32)
    head_major_attention_bf16_kernel(const sam6d::bf16attn::bf16* __restrict__ q,
                                     const sam6d::bf16attn::bf16* __restrict__ k,
                                     const sam6d::bf16attn::bf16* __restrict__ v,
                                     sam6d::bf16attn::bf16* __restrict__ out, Strides sq,
                                     Strides sk, Strides sv, Strides so, int nq, int nk,
                                     int hd, float scale, bool prescale) {
  namespace b16 = sam6d::bf16attn;
  extern __shared__ float4 smem4[];
  const int h = blockIdx.y, b = blockIdx.z;
  const b16::Operands op{q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
                         v + b * sv.b + h * sv.h, out + b * so.b + h * so.h,
                         sq.n, sk.n, sv.n, so.n, nq, nk, hd};
  b16::bf16* smem = reinterpret_cast<b16::bf16*>(smem4);
  if (prescale)
    b16::attention_rows<HDP, kWarpsBf16, tile_keys_bf16<HDP>(), true>(
        op, smem, blockIdx.x * kRowsBf16, scale, b16::NoBias{});
  else
    b16::attention_rows<HDP, kWarpsBf16, tile_keys_bf16<HDP>(), false>(
        op, smem, blockIdx.x * kRowsBf16, scale, b16::NoBias{});
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk, int hd,
                float scale, bool prescale, cudaStream_t stream) {
  using sam6d::bf16attn::bf16;
  constexpr size_t bytes = sam6d::bf16attn::core_smem_bytes<HDP, tile_keys_bf16<HDP>()>();
  cudaError_t err = cudaFuncSetAttribute(head_major_attention_bf16_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kRowsBf16 - 1) / kRowsBf16, heads, b);
  head_major_attention_bf16_kernel<HDP><<<grid, kWarpsBf16 * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, sk, sv, so, nq, nk, hd, scale, prescale);
  return static_cast<int>(cudaGetLastError());
}

int launch_padded_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                       Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk,
                       int hd, float scale, bool prescale, cudaStream_t stream) {
  if (hd < 8 || hd % 8 || nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SAM6D_BF16_CASE(P)                                                                 \
  return launch_bf16<P>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, prescale, \
                        stream)
  switch ((hd + 15) / 16) {
    case 1: SAM6D_BF16_CASE(16);
    case 2: SAM6D_BF16_CASE(32);
    case 3: SAM6D_BF16_CASE(48);
    case 4: SAM6D_BF16_CASE(64);
    case 5: SAM6D_BF16_CASE(80);
    case 6: SAM6D_BF16_CASE(96);
    case 7: SAM6D_BF16_CASE(112);
    case 8: SAM6D_BF16_CASE(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SAM6D_BF16_CASE
}

}  // namespace

extern "C" {

// q: (b, heads, nq, hd), k and v: (b, heads, nk, hd), out: (b, heads, nq,
// hd), all float32 with the hd axis contiguous; each `s*` array holds the
// (batch, head, row) element strides of its tensor. 1 <= hd <= 128.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for an unsupported hd).
int sam6d_fused_attention(const float* q, const float* k, const float* v,
                          float* out, const long long* sq, const long long* sk,
                          const long long* sv, const long long* so, int b,
                          int heads, int nq, int nk, int hd, float scale,
                          cudaStream_t stream) {
  return launch_padded(q, k, v, out, Strides{sq[0], sq[1], sq[2]}, Strides{sk[0], sk[1], sk[2]},
                       Strides{sv[0], sv[1], sv[2]}, Strides{so[0], so[1], so[2]}, b, heads,
                       nq, nk, hd, scale, stream);
}

// q, k, v: (b, heads, n, hd) float32, hd contiguous, 16-byte aligned rows
// (strides multiples of 4 elements); out: (b, heads, n, hd) contiguous. hd
// must be 16, 32 or 64. Returns the CUDA error code of the launch.
int sam6d_fused_attention_small(const float* q, const float* k, const float* v,
                                float* out, const long long* sq,
                                const long long* sk, const long long* sv, int b,
                                int heads, int n, int hd, float scale,
                                cudaStream_t stream) {
  if (hd != 16 && hd != 32 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n) * hd;
  return launch_padded(q, k, v, out, Strides{sq[0], sq[1], sq[2]}, Strides{sk[0], sk[1], sk[2]},
                       Strides{sv[0], sv[1], sv[2]}, Strides{heads * rows, rows, hd}, b, heads,
                       n, n, hd, scale, stream);
}

// The bf16 entries. K8: q (b, heads, nq, hd), k and v (b, heads, nk, hd),
// out (b, heads, nq, hd), bfloat16, strides as sam6d_fused_attention's;
// `scale` is hd^-0.5 rounded to bf16 (q enters as bf16(q * scale)). K9:
// self-attention, out contiguous, the fp32 product scaled by `scale`. hd a
// multiple of 8 up to 128 (K9: 16, 32 or 64); k and v rows 16-byte
// aligned, q and out rows 4-byte aligned. Return the CUDA error code of the
// launch.
int sam6d_fused_attention_bf16(const void* q, const void* k, const void* v, void* out,
                               const long long* sq, const long long* sk,
                               const long long* sv, const long long* so, int b,
                               int heads, int nq, int nk, int hd, float scale,
                               cudaStream_t stream) {
  return launch_padded_bf16(q, k, v, out, Strides{sq[0], sq[1], sq[2]},
                            Strides{sk[0], sk[1], sk[2]}, Strides{sv[0], sv[1], sv[2]},
                            Strides{so[0], so[1], so[2]}, b, heads, nq, nk, hd, scale, true,
                            stream);
}

int sam6d_fused_attention_small_bf16(const void* q, const void* k, const void* v, void* out,
                                     const long long* sq, const long long* sk,
                                     const long long* sv, int b, int heads, int n, int hd,
                                     float scale, cudaStream_t stream) {
  if (hd != 16 && hd != 32 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n) * hd;
  return launch_padded_bf16(q, k, v, out, Strides{sq[0], sq[1], sq[2]},
                            Strides{sk[0], sk[1], sk[2]}, Strides{sv[0], sv[1], sv[2]},
                            Strides{heads * rows, rows, hd}, b, heads, n, n, hd, scale, false,
                            stream);
}

}  // extern "C"
