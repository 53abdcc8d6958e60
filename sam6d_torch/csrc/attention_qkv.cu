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
// What bounds it: at the DINOv2-L shapes (B=16 crops, N=257, 16 heads of
// hd 64) one call does 4*B*H*N^2*hd = 4.33 GFLOP on 67.4 MB (qkv read once,
// output written once), so it is compute-bound: with TF32 off the products
// run on the fp32 FMA units (67 TFLOP/s, H100 SXM), about 65 us.
//
// Design (simple and right first; wgmma/TMA/TF32 are later work):
//  - one block per (sample, head, tile of kRowsPerBlock query rows), one
//    thread per query row holding its q row and its output accumulator in
//    registers;
//  - q, k and v are read straight from the strided qkv tensor, so no
//    (B, H, N, hd) copy is made and the head axis never reaches memory,
//    which was the TPU kernel's point;
//  - K and V tiles of kKeysPerTile keys are staged in shared memory; every
//    thread of the block reads the same key row, so the shared reads are
//    broadcasts (float4, four FMAs per load);
//  - an online softmax: per tile, the thread's scores go to registers, the
//    running max moves once and the accumulator is rescaled once;
//  - the ragged edge (N = 257 is not a multiple of either tile) is masked:
//    keys past N are never scored, rows past N only help load tiles.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowsPerBlock = 64;
constexpr int kKeysPerTile = 32;

template <int HD>
__global__ void __launch_bounds__(kRowsPerBlock)
    attention_qkv_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         int n, int c, float scale) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  __shared__ float4 ks[kKeysPerTile][HD / 4];
  __shared__ float4 vs[kKeysPerTile][HD / 4];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const bool live = row < n;
  const size_t row_stride = 3 * static_cast<size_t>(c);
  const float* base = qkv + static_cast<size_t>(b) * n * row_stride;
  const float* kbase = base + c + h * HD;
  const float* vbase = base + 2 * c + h * HD;

  float4 q[HD / 4];
  float4 acc[HD / 4];
  const float4* qrow = reinterpret_cast<const float4*>(
      base + (live ? row : 0) * row_stride + h * HD);
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) {
    q[d] = qrow[d];
    acc[d] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -CUDART_INF_F;  // running max of the scaled scores
  float l = 0.f;        // running sum of exp(s - m)

  for (int k0 = 0; k0 < n; k0 += kKeysPerTile) {
    const int nk = min(kKeysPerTile, n - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kKeysPerTile * (HD / 4); e += kRowsPerBlock) {
      const int j = e / (HD / 4);
      const int d = e % (HD / 4);
      if (j < nk) {
        const size_t off = (k0 + j) * row_stride;
        ks[j][d] = reinterpret_cast<const float4*>(kbase + off)[d];
        vs[j][d] = reinterpret_cast<const float4*>(vbase + off)[d];
      }
    }
    __syncthreads();
    if (!live) continue;

    float s[kKeysPerTile];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      if (j < nk) {
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int d = 0; d < HD / 4; ++d) {
          const float4 kk = ks[j][d];
          p0 = fmaf(q[d].x, kk.x, p0);
          p1 = fmaf(q[d].y, kk.y, p1);
          p2 = fmaf(q[d].z, kk.z, p2);
          p3 = fmaf(q[d].w, kk.w, p3);
        }
        s[j] = ((p0 + p1) + (p2 + p3)) * scale;
        tile_max = fmaxf(tile_max, s[j]);
      }
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      acc[d].x *= corr;
      acc[d].y *= corr;
      acc[d].z *= corr;
      acc[d].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < HD / 4; ++d) {
          const float4 vv = vs[j][d];
          acc[d].x = fmaf(p, vv.x, acc[d].x);
          acc[d].y = fmaf(p, vv.y, acc[d].y);
          acc[d].z = fmaf(p, vv.z, acc[d].z);
          acc[d].w = fmaf(p, vv.w, acc[d].w);
        }
      }
    }
    m = m_new;
  }
  if (!live) return;

  const float inv = 1.f / fmaxf(l, 1e-30f);
  float4* orow = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(b) * n + row) * c + h * HD);
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) {
    orow[d] = make_float4(acc[d].x * inv, acc[d].y * inv, acc[d].z * inv,
                          acc[d].w * inv);
  }
}

template <int HD>
int launch(const float* qkv, float* out, int b, int n, int heads,
           float scale, cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  attention_qkv_kernel<HD><<<grid, kRowsPerBlock, 0, stream>>>(
      qkv, out, n, heads * HD, scale);
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

}  // extern "C"
