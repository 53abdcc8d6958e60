// SAM ViTDet attention with the decomposed relative-position bias, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel
// sam6d_tpu/kernels/flash_attention.py::flash_attention_relpos (through
// _fused_attention / _fused_kernel). qkv is (B, N, 3C) laid out
// [q | k | v] on the channel axis with heads contiguous; N = gh * gw tokens
// in row-major order. For head h of sample b the kernel computes
//   out[n] = sum_m softmax_m(scale q[n].k[m] + rel_h[n, m / gw]
//                            + rel_w[n, m % gw]) v[m]
// where rel_h (B, heads, N, gh) and rel_w (B, heads, N, gw) are the thin
// decomposed-bias tables the wrapper computes with two small einsums. The
// output (B, N, C) holds head h at channels h*HD. Scores, the running max
// and sum, and the accumulator are fp32; the denominator is clamped at
// 1e-30 as in the TPU kernel. Every token attends to every key of its
// window, zero pad tokens included (the reference does not mask them);
// only keys past N (tile padding) are masked.
//
// What bounds it: a global block (B=1, 16 heads, N=4096, hd 80) is
// 4*16*4096^2*80 = 85.9 GFLOP on ~105 MB moved, compute-bound on the fp32
// FMA units with TF32 off (67 TFLOP/s on an H100 SXM: 1.28 ms).
//
// Design (simple and right first; wgmma/TMA are later work). The TPU folded
// the bias into an augmented contraction; here it is added inside the
// score tile, which keeps K at hd columns. hd 80 does not fit one thread
// per query row (q plus its accumulator would be 160 registers), so the
// tiles are computed cooperatively in shared memory:
//  - one block of 256 threads per (sample, head, 64 query rows); the q tile
//    (pre-scaled) and the block's rows of both tables stay in shared memory;
//  - per 64-key tile: K is staged transposed and each thread computes a 4x4
//    score micro-tile (two float4 shared loads per 16 FMAs), adds the bias,
//    and stores the scores key-major; the V tile then reuses K's buffer;
//  - an online softmax with each row's 64 scores split over 4 threads
//    (partial max and sum reduced through shared memory); the running max,
//    sum and this tile's rescale factor live in shared memory;
//  - P.V: each thread owns 4 rows x HD/16 output columns in registers;
//  - q, k and v are read straight from the strided qkv tensor: no
//    (B, H, N, hd) copy and no (B, H, N, N) tensor reaches memory.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;
constexpr int kPStride = kBQ + 4;   // row stride of the key-major score tile

size_t smem_bytes(int hd, int gh, int gw) {
  return sizeof(float) * (static_cast<size_t>(hd) * kBQ + hd * kBK +
                          kBK * kPStride + kBQ * (gh + gw) + 7 * kBQ);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_relpos_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ rel_h,
                            const float* __restrict__ rel_w,
                            float* __restrict__ out, int n, int heads, int gh,
                            int gw, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DPT = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [HD][kBQ] scaled q, transposed
  float* kv = qs + HD * kBQ;                    // [HD][kBK] k^T, then [kBK][HD] v
  float* ps = kv + HD * kBK;                    // [kBK][kPStride] scores -> probs
  float* rh = ps + kBK * kPStride;              // [kBQ][gh]
  float* rw = rh + kBQ * gh;                    // [kBQ][gw]
  float* red = rw + kBQ * gw;                   // [4][kBQ] partial max / sum
  float* row_m = red + 4 * kBQ;                 // [kBQ] running max
  float* row_l = row_m + kBQ;                   // [kBQ] running sum
  float* row_c = row_l + kBQ;                   // [kBQ] this tile's rescale

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int c = heads * HD;
  const size_t rs = 3 * static_cast<size_t>(c);
  const float* base = qkv + static_cast<size_t>(b) * n * rs + h * HD;
  const size_t tab = (static_cast<size_t>(b) * heads + h) * n;
  const float* rhb = rel_h + tab * gh;
  const float* rwb = rel_w + tab * gw;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    qs[d * kBQ + r] = q0 + r < n ? base[(q0 + r) * rs + d] * scale : 0.f;
  }
  for (int e = tid; e < kBQ * gh; e += kThreads) {
    const int r = e / gh;
    rh[e] = q0 + r < n ? rhb[static_cast<size_t>(q0) * gh + e] : 0.f;
  }
  for (int e = tid; e < kBQ * gw; e += kThreads) {
    const int r = e / gw;
    rw[e] = q0 + r < n ? rwb[static_cast<size_t>(q0) * gw + e] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -CUDART_INF_F;
    row_l[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty*4.., keys tx*4 / cols tx*DPT
  const int sr = tid % kBQ, sq = tid / kBQ;  // softmax: row sr, keys sq*16..
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int nk = min(kBK, n - k0);
    __syncthreads();  // the previous tile's v and probabilities are read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      kv[d * kBK + j] = j < nk ? base[(k0 + j) * rs + c + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[d * kBQ + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&kv[d * kBK + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kk[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx * 4 + j;
      float v4[4];
      if (key < nk) {
        const int kr = (k0 + key) / gw, kc = (k0 + key) % gw;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          v4[i] = s[i][j] + rh[r * gh + kr] + rw[r * gw + kc];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v4[i] = -CUDART_INF_F;
      }
      *reinterpret_cast<float4*>(&ps[key * kPStride + ty * 4]) =
          make_float4(v4[0], v4[1], v4[2], v4[3]);
    }
    __syncthreads();  // scores stored; the K tile is no longer read

    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD;
      kv[e] = j < nk ? base[(k0 + j) * rs + 2 * c + (e % HD)] : 0.f;
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, ps[(sq * 16 + j) * kPStride + sr]);
    red[sq * kBQ + sr] = mx;
    __syncthreads();
    const float m_old = row_m[sr];
    const float m_new = fmaxf(m_old, fmaxf(fmaxf(red[sr], red[kBQ + sr]),
                                           fmaxf(red[2 * kBQ + sr], red[3 * kBQ + sr])));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float* p = &ps[(sq * 16 + j) * kPStride + sr];
      const float e = expf(*p - m_new);
      *p = e;
      sum += e;
    }
    __syncthreads();  // every partial max is read
    red[sq * kBQ + sr] = sum;
    __syncthreads();
    if (sq == 0) {
      const float corr = expf(m_old - m_new);  // 0 on the first tile
      row_l[sr] = row_l[sr] * corr + ((red[sr] + red[kBQ + sr]) +
                                      (red[2 * kBQ + sr] + red[3 * kBQ + sr]));
      row_m[sr] = m_new;
      row_c[sr] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    for (int j = 0; j < nk; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[j * kPStride + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = kv[j * HD + tx * DPT + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= n) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(b) * n + q0 + r) * c + h * HD + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) orow[e] = acc[i][e] * inv;
  }
}

template <int HD>
int launch(const float* qkv, const float* rel_h, const float* rel_w, float* out,
           int b, int n, int heads, int gh, int gw, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD, gh, gw);
  cudaError_t err = cudaFuncSetAttribute(
      attention_relpos_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBQ - 1) / kBQ, heads, b);
  attention_relpos_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      qkv, rel_h, rel_w, out, n, heads, gh, gw, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: (b, n, 3 * heads * hd) float32; rel_h: (b, heads, n, gh); rel_w:
// (b, heads, n, gw); out: (b, n, heads * hd). n == gh * gw; hd one of 16,
// 32, 64, 80. Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for an unsupported hd).
int sam6d_flash_attention_relpos(const float* qkv, const float* rel_h,
                                 const float* rel_w, float* out, int b, int n,
                                 int heads, int hd, int gh, int gw, float scale,
                                 cudaStream_t stream) {
  if (gh * gw != n) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch<16>(qkv, rel_h, rel_w, out, b, n, heads, gh, gw, scale, stream);
    case 32: return launch<32>(qkv, rel_h, rel_w, out, b, n, heads, gh, gw, scale, stream);
    case 64: return launch<64>(qkv, rel_h, rel_w, out, b, n, heads, gh, gw, scale, stream);
    case 80: return launch<80>(qkv, rel_h, rel_w, out, b, n, heads, gh, gw, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
