// Multi-head attention straight off a fused qkv projection, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel
// sam6d_tpu/kernels/flash_attention.py::fused_attention_qkv (body
// _qkv_kernel). qkv is (B, N, 3C) laid out [q | k | v] on the channel axis,
// heads contiguous in each third: head h's q is at channels h*hd, its k at
// C + h*hd and its v at 2C + h*hd. The output (B, N, C) holds
// softmax(q k^T * scale) v of head h at channels h*hd, ready for the output
// projection. Scores, the running max and sum, and the accumulator are fp32;
// the denominator is clamped at 1e-30, as in the TPU kernel.
//
// What bounds it on an H100 SXM: at the DINOv2-L shape (B=16 crops, N=257,
// 16 heads of hd 64) one call does 4*B*H*N^2*hd = 4.33 GFLOP on 67.4 MB
// (qkv read once, output written once): operations. On the fp32 FMA units
// (67 TFLOP/s) that is 65 us, on the tensor cores in three-pass TF32
// (495/3 = 165 TFLOP/s) 26 us; the bytes alone take 20 us.
//
// Design: the three-pass TF32 attention core of tf32x3.cuh with no bias:
// 4 warps of 16 query rows per block, the block's q rows in shared memory,
// K/V tiles of 32 keys double-buffered with cp.async straight from the
// strided qkv, online softmax in registers by quad shuffles. 52 KB of shared
// memory and at most 128 registers a thread let four blocks share an SM.
// N = 257 is one row and one key past a multiple of 16 and 32: the fifth
// row block has one live warp (the others only help load), rows past N
// load zeros and are not stored, and the last key tile runs one n8 tile of
// its four with keys past N at -inf.
//
// The bf16 entry (sam6d_fused_attention_qkv_bf16) is the bf16 core of
// bf16_attention.cuh (one-pass bf16 mma.sync m16n8k16 with fp32
// accumulation, fp32 scores and softmax, p rounded to bf16, l summed from
// the rounded p: _qkv_kernel's bf16 contract), the fp32 product scaled as
// _qkv_kernel scales it. At the DINOv2-L shape it is 4.33 GFLOP on 33.7 MB:
// 4.4 us of dense bf16 tensor time (989 TFLOP/s) against 10 us of bytes, so
// on an H100 the bf16 entry is bound by its bytes. 4 warps, 64-key tiles.
#include "bf16_attention.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;
constexpr int kMinBlocks = 4;   // resident blocks per SM the registers must allow
constexpr int kTileKeys = 32;   // keys per K/V tile

template <int HD>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    attention_qkv_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         int n, int c, float scale) {
  extern __shared__ float4 smem4[];
  const float* q = qkv + static_cast<size_t>(blockIdx.z) * n * 3 * c + blockIdx.y * HD;
  const long long rs = 3LL * c;
  const sam6d::Operands op{q, q + c, q + 2 * c,
                           out + static_cast<size_t>(blockIdx.z) * n * c + blockIdx.y * HD,
                           rs, rs, rs, c, n, n, HD};
  sam6d::attention_rows<HD, kWarps, kTileKeys, sam6d::Staging::kSplitPerFragment>(
      op, reinterpret_cast<float*>(smem4), blockIdx.x * kRows, scale, sam6d::NoBias{});
}

template <int HD>
int launch(const float* qkv, float* out, int b, int n, int heads,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = sam6d::core_smem_bytes<HD, kWarps, kTileKeys>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, heads, b);
  attention_qkv_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      qkv, out, n, heads * HD, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTileKeysBf16 = 64;  // keys per K/V tile of the bf16 entry

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attention_qkv_bf16_kernel(const sam6d::bf16attn::bf16* __restrict__ qkv,
                              sam6d::bf16attn::bf16* __restrict__ out, int n, int c,
                              float scale) {
  namespace b16 = sam6d::bf16attn;
  extern __shared__ float4 smem4[];
  const b16::bf16* q = qkv + static_cast<size_t>(blockIdx.z) * n * 3 * c + blockIdx.y * HD;
  const long long rs = 3LL * c;
  const b16::Operands op{q, q + c, q + 2 * c,
                         out + static_cast<size_t>(blockIdx.z) * n * c + blockIdx.y * HD,
                         rs, rs, rs, c, n, n, HD};
  b16::attention_rows<HD, kWarps, kTileKeysBf16, false>(
      op, reinterpret_cast<b16::bf16*>(smem4), blockIdx.x * kRows, scale, b16::NoBias{});
}

template <int HD>
int launch_bf16(const void* qkv, void* out, int b, int n, int heads, float scale,
                cudaStream_t stream) {
  using sam6d::bf16attn::bf16;
  constexpr size_t bytes = sam6d::bf16attn::core_smem_bytes<HD, kTileKeysBf16>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, heads, b);
  attention_qkv_bf16_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads * HD, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: (b, n, 3 * heads * hd) float32, 16-byte aligned; out: (b, n, heads *
// hd). hd must be 32 or 64. Returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidValue for an unsupported hd).
int sam6d_fused_attention_qkv(const float* qkv, float* out, int b, int n,
                              int heads, int hd, float scale,
                              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(qkv, out, b, n, heads, scale, stream);
    case 64: return launch<64>(qkv, out, b, n, heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 entry: qkv (b, n, 3 * heads * hd) and out (b, n, heads * hd)
// bfloat16, qkv 16-byte aligned; hd 32 or 64. Returns the CUDA error code of
// the launch.
int sam6d_fused_attention_qkv_bf16(const void* qkv, void* out, int b, int n, int heads,
                                   int hd, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_bf16<32>(qkv, out, b, n, heads, scale, stream);
    case 64: return launch_bf16<64>(qkv, out, b, n, heads, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
