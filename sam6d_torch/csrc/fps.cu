// Farthest-point sampling for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel sam6d_tpu/kernels/fps.py::farthest_point_sample_pallas
// (and its XLA twin sam6d_tpu/ops/sampling.py::farthest_point_sample).
// Semantics: the first pick is the first valid index; every step updates the
// running min-distance to the last pick and takes the argmax of it over valid
// points (invalid points score -1), ties to the LOWEST index. The distance is
// dx*dx + dy*dy + dz*dz in that order with no FMA contraction, so picks are
// bit-identical to the plain PyTorch version.
//
// Two paths (the wrapper in sam6d_torch/kernels/fps.py chooses):
//  * single block per cloud (N <= kSingleMaxN): points, running min-distance
//    and valid flags live in shared memory for all M-1 dependent steps; each
//    step is one sweep plus a block argmax (warp shuffles + one smem round).
//  * multi block (large N, e.g. 42 views x 5000 template points at
//    onboarding): one launch per step. Each block owns a contiguous chunk,
//    first reduces the previous step's per-block partial argmaxes (so every
//    block agrees on the last pick without atomics or a grid barrier),
//    updates its chunk of the min-distance in global memory (L2-resident) and
//    writes its own partial. Partials are double-buffered by step parity;
//    launches on one stream are ordered, so no step reads a buffer being
//    written.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kSingleThreads = 1024;
constexpr int kMultiThreads = 256;

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float lx, float ly, float lz) {
  const float dx = __fsub_rn(px, lx);
  const float dy = __fsub_rn(py, ly);
  const float dz = __fsub_rn(pz, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Larger value wins; equal values go to the lower index.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

// Block-wide argmax; every thread returns the block's winner.
template <int THREADS>
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -FLT_MAX;
    i = lane < kWarps ? si[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      sv[32] = v;
      si[32] = i;
    }
  }
  __syncthreads();
  v = sv[32];
  i = si[32];
  __syncthreads();  // the next call overwrites sv/si
}

// First valid index of the cloud (0 if none is valid), like argmax(valid).
template <int THREADS>
__device__ int first_valid(const unsigned char* vb, int n, float* sv,
                           int* si) {
  float v = -FLT_MAX;
  int i = INT_MAX;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const float s = vb[k] ? 1.0f : 0.0f;
    if (s > v) {
      v = s;
      i = k;
    }
  }
  block_argmax<THREADS>(v, i, sv, si);
  return i;
}

// pts: (B, 3, N) planar; valid: (B, N) 0/1 bytes; out: (B, M) int32.
__global__ void __launch_bounds__(kSingleThreads)
    fps_single_block_kernel(const float* __restrict__ pts,
                            const unsigned char* __restrict__ valid, int n,
                            int m, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* x = smem;
  float* y = x + n;
  float* z = y + n;
  float* md = z + n;
  unsigned char* vv = reinterpret_cast<unsigned char*>(md + n);
  __shared__ float sv[33];
  __shared__ int si[33];

  const int b = blockIdx.x;
  const float* p = pts + static_cast<size_t>(b) * 3 * n;
  const unsigned char* vb = valid + static_cast<size_t>(b) * n;
  for (int k = threadIdx.x; k < n; k += kSingleThreads) {
    x[k] = p[k];
    y[k] = p[n + k];
    z[k] = p[2 * n + k];
    md[k] = 1e10f;
    vv[k] = vb[k];
  }
  __syncthreads();

  int last = first_valid<kSingleThreads>(vv, n, sv, si);
  int* ob = out + static_cast<size_t>(b) * m;
  if (threadIdx.x == 0) ob[0] = last;
  for (int s = 1; s < m; ++s) {
    const float lx = x[last], ly = y[last], lz = z[last];
    float bv = -FLT_MAX;
    int bi = INT_MAX;
    for (int k = threadIdx.x; k < n; k += kSingleThreads) {
      const float d = fminf(md[k], sq_dist(x[k], y[k], z[k], lx, ly, lz));
      md[k] = d;
      const float sc = vv[k] ? d : -1.0f;
      if (sc > bv) {
        bv = sc;
        bi = k;
      }
    }
    block_argmax<kSingleThreads>(bv, bi, sv, si);
    last = bi;
    if (threadIdx.x == 0) ob[s] = last;
  }
}

__global__ void __launch_bounds__(kMultiThreads)
    fps_first_kernel(const unsigned char* __restrict__ valid, int n, int m,
                     int* __restrict__ out) {
  __shared__ float sv[33];
  __shared__ int si[33];
  const int b = blockIdx.x;
  const int i = first_valid<kMultiThreads>(valid + static_cast<size_t>(b) * n,
                                           n, sv, si);
  if (threadIdx.x == 0) out[static_cast<size_t>(b) * m] = i;
}

// Reduce the per-block partials of one step; every thread gets the winner.
__device__ int reduce_partials(const float* pv, const int* pi, int nblk,
                               float* sv, int* si) {
  float v = -FLT_MAX;
  int i = INT_MAX;
  for (int k = threadIdx.x; k < nblk; k += kMultiThreads) {
    argmax_merge(v, i, pv[k], pi[k]);
  }
  block_argmax<kMultiThreads>(v, i, sv, si);
  return i;
}

// One FPS step s (1 <= s < M) over grid (nblk, B). md: (B, N) running
// min-distance; part_v/part_i: (2, B, nblk) partial argmaxes by step parity.
__global__ void __launch_bounds__(kMultiThreads)
    fps_multi_step_kernel(const float* __restrict__ pts,
                          const unsigned char* __restrict__ valid, int n,
                          int m, int chunk, int s, float* __restrict__ md,
                          float* __restrict__ part_v, int* __restrict__ part_i,
                          int* __restrict__ out) {
  __shared__ float sv[33];
  __shared__ int si[33];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int nb = gridDim.y;
  int* ob = out + static_cast<size_t>(b) * m;

  int last;
  if (s == 1) {
    last = ob[0];
  } else {
    const size_t off = (static_cast<size_t>((s - 1) & 1) * nb + b) * nblk;
    last = reduce_partials(part_v + off, part_i + off, nblk, sv, si);
    if (blk == 0 && threadIdx.x == 0) ob[s - 1] = last;
  }

  const float* p = pts + static_cast<size_t>(b) * 3 * n;
  const unsigned char* vb = valid + static_cast<size_t>(b) * n;
  float* mb = md + static_cast<size_t>(b) * n;
  const float lx = p[last], ly = p[n + last], lz = p[2 * n + last];
  const int lo = blk * chunk;
  const int hi = min(n, lo + chunk);
  float bv = -FLT_MAX;
  int bi = INT_MAX;
  for (int k = lo + threadIdx.x; k < hi; k += kMultiThreads) {
    const float d = fminf(mb[k], sq_dist(p[k], p[n + k], p[2 * n + k], lx, ly, lz));
    mb[k] = d;
    const float sc = vb[k] ? d : -1.0f;
    if (sc > bv) {
      bv = sc;
      bi = k;
    }
  }
  block_argmax<kMultiThreads>(bv, bi, sv, si);
  if (threadIdx.x == 0) {
    const size_t off = (static_cast<size_t>(s & 1) * nb + b) * nblk + blk;
    part_v[off] = bv;
    part_i[off] = bi;
  }
}

// Publishes the last step's pick: grid (B).
__global__ void __launch_bounds__(kMultiThreads)
    fps_multi_final_kernel(const float* __restrict__ part_v,
                           const int* __restrict__ part_i, int nblk, int m,
                           int* __restrict__ out) {
  __shared__ float sv[33];
  __shared__ int si[33];
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const size_t off = (static_cast<size_t>((m - 1) & 1) * nb + b) * nblk;
  const int last = reduce_partials(part_v + off, part_i + off, nblk, sv, si);
  if (threadIdx.x == 0) out[static_cast<size_t>(b) * m + m - 1] = last;
}

}  // namespace

extern "C" {

int sam6d_fps_single_block_threads() { return kSingleThreads; }

// Returns the CUDA error code of the launch (0 on success).
int sam6d_fps_single_block(const float* pts, const unsigned char* valid, int b,
                           int n, int m, int* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * (4 * sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fps_single_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_single_block_kernel<<<b, kSingleThreads, smem, stream>>>(pts, valid, n,
                                                              m, out);
  return static_cast<int>(cudaGetLastError());
}

// md: (B, N) filled with 1e10 by the caller; part_v/part_i: (2, B, nblk)
// scratch with nblk = ceil(N / chunk).
int sam6d_fps_multi_block(const float* pts, const unsigned char* valid, int b,
                          int n, int m, int chunk, float* md, float* part_v,
                          int* part_i, int* out, cudaStream_t stream) {
  const int nblk = (n + chunk - 1) / chunk;
  fps_first_kernel<<<b, kMultiThreads, 0, stream>>>(valid, n, m, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nblk, b);
  for (int s = 1; s < m; ++s) {
    fps_multi_step_kernel<<<grid, kMultiThreads, 0, stream>>>(
        pts, valid, n, m, chunk, s, md, part_v, part_i, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m > 1) {
    fps_multi_final_kernel<<<b, kMultiThreads, 0, stream>>>(part_v, part_i,
                                                           nblk, m, out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
