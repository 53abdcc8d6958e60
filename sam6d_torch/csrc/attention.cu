// Plain softmax attention on head-major (B, H, N, hd) operands, for Hopper
// (sm_90a), plain C interface for ctypes. Two kernels:
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
// Scores, the running max and sum, and the accumulator are fp32. K8 clamps
// the denominator at 1e-30 as _fused_kernel does; K9 divides by the plain
// sum as _small_kernel does, and sums the same probabilities that multiply
// V (the TPU kernel's rule for its value-dtype cast, trivially kept here).
//
// What bounds them: 4*B*H*Nq*Nk*hd operations on the fp32 FMA units (TF32
// off, 67 TFLOP/s on an H100 SXM): K8 at 16x16x1025^2x64 is 68.9 GFLOP,
// 1.03 ms; K9 at 16x16x257^2x64 is 4.33 GFLOP, 0.065 ms. The bytes (q, k, v
// read once, out written once) are a few percent of that time.
//
// Design (simple and right first; wgmma/TMA are later work).
//  - K8 is K1's structure (attention_relpos.cu) without the bias: one block
//    of 256 threads per (64 query rows, head, sample); the q tile
//    (pre-scaled) transposed in shared memory; per 64-key tile, K staged
//    transposed, a 4x4 score micro-tile per thread (two float4 shared loads
//    per 16 FMAs), keys past Nk set to -inf in the tile (no padded copy in
//    memory), an online softmax with each row split over 4 threads, the V
//    tile reusing K's buffer, and 4 rows x HDP/16 output columns per thread.
//    hd is padded to HDP, the next multiple of 16, by masked loads (zero
//    columns add nothing to a score and are never written).
//  - K9 is K5's body (attention_qkv.cu) with three base pointers: one
//    thread per query row holding its q row and accumulator in registers,
//    K and V tiles of 32 keys in shared memory read as float4 broadcasts,
//    an online softmax per tile; the ragged tail is masked.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// element strides of a (B, H, N, hd) operand; the hd axis has stride 1
struct Strides {
  long long b, h, n;
};

// ------------------------------------------------------------------ K8

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;
constexpr int kPStride = kBQ + 4;   // row stride of the key-major score tile

size_t fused_smem_bytes(int hdp) {
  return sizeof(float) * (static_cast<size_t>(hdp) * kBQ + hdp * kBK +
                          kBK * kPStride + 7 * kBQ);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
    fused_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int nq, int nk_total, int hd, float scale) {
  static_assert(HDP % 16 == 0, "padded head dim must be a multiple of 16");
  constexpr int DPT = HDP / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [HDP][kBQ] scaled q, transposed
  float* kv = qs + HDP * kBQ;                   // [HDP][kBK] k^T, then [kBK][HDP] v
  float* ps = kv + HDP * kBK;                   // [kBK][kPStride] scores -> probs
  float* red = ps + kBK * kPStride;             // [4][kBQ] partial max / sum
  float* row_m = red + 4 * kBQ;                 // [kBQ] running max
  float* row_l = row_m + kBQ;                   // [kBQ] running sum
  float* row_c = row_l + kBQ;                   // [kBQ] this tile's rescale

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int e = tid; e < kBQ * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    qs[d * kBQ + r] = (q0 + r < nq && d < hd) ? qb[(q0 + r) * sq.n + d] * scale : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -CUDART_INF_F;
    row_l[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty*4.., keys tx*4 / cols tx*DPT
  const int sr = tid % kBQ, sq4 = tid / kBQ;  // softmax: row sr, keys sq4*16..
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < nk_total; k0 += kBK) {
    const int nk = min(kBK, nk_total - k0);
    __syncthreads();  // the previous tile's v and probabilities are read
    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int j = e / HDP, d = e % HDP;
      kv[d * kBK + j] = (j < nk && d < hd) ? kb[(k0 + j) * sk.n + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
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
      const bool live = key < nk;
      *reinterpret_cast<float4*>(&ps[key * kPStride + ty * 4]) =
          make_float4(live ? s[0][j] : -CUDART_INF_F, live ? s[1][j] : -CUDART_INF_F,
                      live ? s[2][j] : -CUDART_INF_F, live ? s[3][j] : -CUDART_INF_F);
    }
    __syncthreads();  // scores stored; the K tile is no longer read

    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int j = e / HDP, d = e % HDP;
      kv[e] = (j < nk && d < hd) ? vb[(k0 + j) * sv.n + d] : 0.f;
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, ps[(sq4 * 16 + j) * kPStride + sr]);
    red[sq4 * kBQ + sr] = mx;
    __syncthreads();
    const float m_old = row_m[sr];
    const float m_new = fmaxf(m_old, fmaxf(fmaxf(red[sr], red[kBQ + sr]),
                                           fmaxf(red[2 * kBQ + sr], red[3 * kBQ + sr])));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float* p = &ps[(sq4 * 16 + j) * kPStride + sr];
      const float e = expf(*p - m_new);
      *p = e;
      sum += e;
    }
    __syncthreads();  // every partial max is read
    red[sq4 * kBQ + sr] = sum;
    __syncthreads();
    if (sq4 == 0) {
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
      for (int e = 0; e < DPT; ++e) vv[e] = kv[j * HDP + tx * DPT + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= nq) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    float* orow = ob + (q0 + r) * so.n;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = tx * DPT + e;
      if (d < hd) orow[d] = acc[i][e] * inv;
    }
  }
}

template <int HDP>
int launch_fused(const float* q, const float* k, const float* v, float* out,
                 Strides sq, Strides sk, Strides sv, Strides so, int b, int heads,
                 int nq, int nk, int hd, float scale, cudaStream_t stream) {
  const size_t bytes = fused_smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, b);
  fused_attention_kernel<HDP><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, nq, nk, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K9

constexpr int kRowsPerBlock = 64;
constexpr int kKeysPerTile = 32;

template <int HD>
__global__ void __launch_bounds__(kRowsPerBlock)
    fused_attention_small_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, Strides sq, Strides sk,
                                 Strides sv, int heads, int n, float scale) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  __shared__ float4 ks[kKeysPerTile][HD / 4];
  __shared__ float4 vs[kKeysPerTile][HD / 4];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const bool live = row < n;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float4 qr[HD / 4];
  float4 acc[HD / 4];
  const float4* qrow = reinterpret_cast<const float4*>(
      q + b * sq.b + h * sq.h + (live ? row : 0) * sq.n);
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) {
    qr[d] = qrow[d];
    acc[d] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -CUDART_INF_F;  // running max of the scaled scores
  float l = 0.f;            // running sum of exp(s - m)

  for (int k0 = 0; k0 < n; k0 += kKeysPerTile) {
    const int nk = min(kKeysPerTile, n - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kKeysPerTile * (HD / 4); e += kRowsPerBlock) {
      const int j = e / (HD / 4);
      const int d = e % (HD / 4);
      if (j < nk) {
        ks[j][d] = reinterpret_cast<const float4*>(kb + (k0 + j) * sk.n)[d];
        vs[j][d] = reinterpret_cast<const float4*>(vb + (k0 + j) * sv.n)[d];
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
          p0 = fmaf(qr[d].x, kk.x, p0);
          p1 = fmaf(qr[d].y, kk.y, p1);
          p2 = fmaf(qr[d].z, kk.z, p2);
          p3 = fmaf(qr[d].w, kk.w, p3);
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
        const float p = expf(s[j] - m_new);  // summed and applied alike
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

  const float inv = 1.f / l;
  float4* orow = reinterpret_cast<float4*>(
      out + ((static_cast<size_t>(b) * heads + h) * n + row) * HD);
#pragma unroll
  for (int d = 0; d < HD / 4; ++d) {
    orow[d] = make_float4(acc[d].x * inv, acc[d].y * inv, acc[d].z * inv,
                          acc[d].w * inv);
  }
}

template <int HD>
int launch_small(const float* q, const float* k, const float* v, float* out,
                 Strides sq, Strides sk, Strides sv, int b, int heads, int n,
                 float scale, cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  fused_attention_small_kernel<HD><<<grid, kRowsPerBlock, 0, stream>>>(
      q, k, v, out, sq, sk, sv, heads, n, scale);
  return static_cast<int>(cudaGetLastError());
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
  const Strides tq{sq[0], sq[1], sq[2]}, tk{sk[0], sk[1], sk[2]},
      tv{sv[0], sv[1], sv[2]}, to{so[0], so[1], so[2]};
  if (hd < 1 || nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((hd + 15) / 16) {
    case 1: return launch_fused<16>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 2: return launch_fused<32>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 3: return launch_fused<48>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 4: return launch_fused<64>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 5: return launch_fused<80>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 6: return launch_fused<96>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 7: return launch_fused<112>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    case 8: return launch_fused<128>(q, k, v, out, tq, tk, tv, to, b, heads, nq, nk, hd, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v: (b, heads, n, hd) float32, hd contiguous, 16-byte aligned rows
// (strides multiples of 4 elements); out: (b, heads, n, hd) contiguous. hd
// must be 16, 32 or 64. Returns the CUDA error code of the launch.
int sam6d_fused_attention_small(const float* q, const float* k, const float* v,
                                float* out, const long long* sq,
                                const long long* sk, const long long* sv, int b,
                                int heads, int n, int hd, float scale,
                                cudaStream_t stream) {
  const Strides tq{sq[0], sq[1], sq[2]}, tk{sk[0], sk[1], sk[2]},
      tv{sv[0], sv[1], sv[2]};
  switch (hd) {
    case 16: return launch_small<16>(q, k, v, out, tq, tk, tv, b, heads, n, scale, stream);
    case 32: return launch_small<32>(q, k, v, out, tq, tk, tv, b, heads, n, scale, stream);
    case 64: return launch_small<64>(q, k, v, out, tq, tk, tv, b, heads, n, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
