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
// The bf16 entry (sam6d_fused_attention_qkv_bf16) is the wgmma core of
// bf16_wgmma.cuh (wgmma.mma_async for Q K^T and P V with fp32
// accumulation, K/V tiles by TMA on mbarriers; fp32 scores and softmax, p
// rounded to bf16, l summed from the rounded p: _qkv_kernel's bf16
// contract), the fp32 product scaled as _qkv_kernel scales it. At the
// DINOv2-L shape it is 4.33 GFLOP on 33.7 MB: 4.4 us of dense bf16 tensor
// time (989 TFLOP/s) against 10 us of bytes, so on an H100 the bf16 entry
// is bound by its bytes. A (crop, head)'s 257 keys fit the ring, so one
// block of two warpgroups takes all of its five 64-row tiles on K/V read
// once (128-byte swizzled rows at hd 64).
#include "bf16_wgmma.cuh"
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
      op, reinterpret_cast<float*>(smem4), blockIdx.x * kRows, scale);
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

// The bf16 entry: the wgmma core of bf16_wgmma.cuh, one block a (sample,
// head) when its keys fit the ring (the DINOv2-L describe's 257), else one a
// 128 rows; the fp32 product scaled as _qkv_kernel scales it.
template <int HD>
__global__ void __launch_bounds__(sam6d::wgattn::kThreads, 2)
    attention_qkv_wgmma_kernel(const __grid_constant__ sam6d::wgattn::KVMaps maps,
                               const sam6d::wgattn::bf16* __restrict__ qkv,
                               sam6d::wgattn::bf16* __restrict__ out, int n, int c,
                               int row_tiles, float score_scale) {
  namespace wa = sam6d::wgattn;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int b = blockIdx.z, h = blockIdx.y;
  const wa::Tiles op{qkv + static_cast<size_t>(b) * n * 3 * c + h * HD,
                     out + static_cast<size_t>(b) * n * c + h * HD,
                     3LL * c, c, n, n, HD, h, b};
  const int rt0 = blockIdx.x * row_tiles;
  wa::attend<HD>(maps, op, wa::checked_base(smem_raw), rt0,
                 min(row_tiles, (n + wa::kRowsWG - 1) / wa::kRowsWG - rt0), 1.f, score_scale,
                 wa::NoBias{});
}

template <int HD>
int launch_bf16(const void* qkv, void* out, int b, int n, int heads, float scale,
                cudaStream_t stream) {
  namespace wa = sam6d::wgattn;
  const int c = heads * HD;
  wa::KVMaps maps;
  int err = wa::encode_qkv_maps<HD>(maps, qkv, b, n, heads);
  if (err != 0) return err;
  const size_t bytes = wa::core_smem_bytes<HD>(n);
  err = static_cast<int>(cudaFuncSetAttribute(attention_qkv_wgmma_kernel<HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(bytes)));
  if (err != 0) return err;
  const int row_tiles = wa::row_tiles_per_block<HD>(n, n);
  const dim3 grid(((n + wa::kRowsWG - 1) / wa::kRowsWG + row_tiles - 1) / row_tiles, heads, b);
  attention_qkv_wgmma_kernel<HD><<<grid, wa::kThreads, bytes, stream>>>(
      maps, static_cast<const wa::bf16*>(qkv), static_cast<wa::bf16*>(out), n, c, row_tiles,
      scale * wa::kLog2e);
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

// Dynamic shared memory, bytes, of a block of the bf16 entry over n keys at
// head dim hd, as its launch sizes it; -1 for an hd it does not take.
int sam6d_fused_attention_qkv_bf16_smem(int n, int hd) {
  switch (hd) {
    case 32: return static_cast<int>(sam6d::wgattn::core_smem_bytes<32>(n));
    case 64: return static_cast<int>(sam6d::wgattn::core_smem_bytes<64>(n));
    default: return -1;
  }
}

}  // extern "C"
