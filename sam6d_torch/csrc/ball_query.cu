// Two-scale ball query for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel
// sam6d_tpu/kernels/ball_query.py::two_scale_ball_query_pallas (XLA twin:
// sam6d_tpu/ops/ball_query.py::two_scale_ball_query). For every query it
// returns the first s1 point indices with d2 < r1^2 and the first s2 with
// d2 < r2^2, in index order; empty slots repeat the first hit, or 0 if there
// is none (the reference ball_query_gpu.cu rule).
//
// What bounds it: on clouds where the quotas rarely fill, nearly every
// (query, candidate) pair is scanned (~67 M per frame), so the instructions
// a pair costs and the candidate reads set the time. Two paths (the wrapper
// in sam6d_torch/kernels/ball_query.py chooses from the shape):
//  * lanes (enough queries to give every multiprocessor a block, e.g. the
//    frame's 16 x 2048): a block of one warp owns 32 queries of one cloud,
//    one a lane, and stages the cloud's candidates into shared memory once,
//    kChunk at a time, as (x, y, z, |x|^2) (16 B a point); the walk is in
//    index order, so chunks compose. Each lane tests kGroup staged
//    candidates at a time against its query into two hit masks (one
//    broadcast read feeds all 32 lanes), then writes the masks' hits to its
//    query's next slots in index order until the quota is full: no sort, no
//    ballot a candidate, no (B, M, N) distance matrix. The warp stops after
//    the group that fills every quota it holds.
//  * warps (fewer queries, e.g. one cloud at onboarding, where 32 queries a
//    block would leave multiprocessors idle): one warp a query walks the
//    candidates in 32-wide slices from global memory (L1-resident);
//    __ballot_sync gives the slice's hit masks and __popc of the lanes
//    below gives each hit its slot; it stops when both quotas are full.
// Distances use the expanded |q|^2 - 2 q.x + |x|^2 form of
// pairwise_sq_distance, clamped at 0, so radius decisions match the plain
// version except for pairs within float rounding of r^2.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 1024;  // candidates staged at a time: 16 KB
constexpr int kGroup = 32;    // candidates walked between exit checks
constexpr int kStage = 8;     // candidates a thread loads at once when staging
constexpr int kWarpsPerBlock = 8;  // warps path

// xyz: (B, 3, N) planar candidates; q: (B, 3, M) planar queries;
// out1: (B, M, s1), out2: (B, M, s2) int32. Grid (ceil(M / 32), B), 32
// threads.
__global__ void __launch_bounds__(32)
    ball_query_lanes_kernel(const float* __restrict__ xyz,
                            const float* __restrict__ q, int n, int m,
                            float r1sq, int s1, float r2sq, int s2,
                            int* __restrict__ out1, int* __restrict__ out2) {
  __shared__ float4 cand[kChunk];
  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * 32 + lane;
  const bool live = qi < m;
  const float* px = xyz + static_cast<size_t>(b) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* qb = q + static_cast<size_t>(b) * 3 * m;
  const float qx = live ? qb[qi] : 0.0f;
  const float qy = live ? qb[m + qi] : 0.0f;
  const float qz = live ? qb[2 * m + qi] : 0.0f;
  const float q2 = qx * qx + qy * qy + qz * qz;
  int* o1 = out1 + (static_cast<size_t>(b) * m + (live ? qi : 0)) * s1;
  int* o2 = out2 + (static_cast<size_t>(b) * m + (live ? qi : 0)) * s2;
  // hits so far (a query past M starts full) and first hit (0 if none)
  int c1 = live ? 0 : s1, c2 = live ? 0 : s2;
  int f1 = 0, f2 = 0;

  for (int base = 0; base < n; base += kChunk) {
    // also keeps the previous chunk's readers ahead of the next staging
    if (__syncthreads_and(c1 >= s1 && c2 >= s2)) break;
    const int cnt = min(kChunk, n - base);
    for (int k0 = lane; k0 < cnt; k0 += 32 * kStage) {
      float x[kStage], y[kStage], z[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int k = min(k0 + u * 32, cnt - 1);
        x[u] = px[base + k];
        y[u] = py[base + k];
        z[u] = pz[base + k];
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int k = k0 + u * 32;
        if (k < cnt) {
          cand[k] = make_float4(x[u], y[u], z[u],
                                x[u] * x[u] + y[u] * y[u] + z[u] * z[u]);
        }
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < cnt && __any_sync(kFull, c1 < s1 || c2 < s2); k0 += kGroup) {
      unsigned m1 = 0u, m2 = 0u;  // bit u: candidate k0 + u
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 c = cand[min(k0 + u, cnt - 1)];
        const float xy = qx * c.x + qy * c.y + qz * c.z;
        const float d = fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, xy)), c.w), 0.0f);
        m1 |= (d < r1sq ? 1u : 0u) << u;
        m2 |= (d < r2sq ? 1u : 0u) << u;
      }
      if (cnt - k0 < kGroup) {  // the chunk's ragged end
        m1 &= (1u << (cnt - k0)) - 1u;
        m2 &= (1u << (cnt - k0)) - 1u;
      }
      const int at = base + k0;
      if (c1 == 0 && m1) f1 = at + __ffs(m1) - 1;
      if (c2 == 0 && m2) f2 = at + __ffs(m2) - 1;
      for (unsigned h = m1; h && c1 < s1; h &= h - 1u) o1[c1++] = at + __ffs(h) - 1;
      for (unsigned h = m2; h && c2 < s2; h &= h - 1u) o2[c2++] = at + __ffs(h) - 1;
    }
  }
  if (!live) return;
  for (int k = c1; k < s1; ++k) o1[k] = f1;
  for (int k = c2; k < s2; ++k) o2[k] = f2;
}

// Same contract; grid (ceil(M / kWarpsPerBlock), B), one warp a query.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ball_query_warps_kernel(const float* __restrict__ xyz,
                            const float* __restrict__ q, int n, int m,
                            float r1sq, int s1, float r2sq, int s2,
                            int* __restrict__ out1, int* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (qi >= m) return;  // warp-uniform

  const float* px = xyz + static_cast<size_t>(b) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* qb = q + static_cast<size_t>(b) * 3 * m;
  const float qx = qb[qi], qy = qb[m + qi], qz = qb[2 * m + qi];
  const float q2 = qx * qx + qy * qy + qz * qz;
  int* o1 = out1 + (static_cast<size_t>(b) * m + qi) * s1;
  int* o2 = out2 + (static_cast<size_t>(b) * m + qi) * s2;
  const unsigned below = (1u << lane) - 1u;

  int c1 = 0, c2 = 0;    // hits so far (warp-uniform)
  int f1 = -1, f2 = -1;  // first hit index (warp-uniform)
  for (int base = 0; base < n && (c1 < s1 || c2 < s2); base += 32) {
    const int j = base + lane;
    bool h1 = false, h2 = false;
    if (j < n) {
      const float x = px[j], y = py[j], z = pz[j];
      const float xy = qx * x + qy * y + qz * z;
      const float p2 = x * x + y * y + z * z;
      const float d = fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, xy)), p2), 0.0f);
      h1 = d < r1sq;
      h2 = d < r2sq;
    }
    const unsigned b1 = __ballot_sync(kFull, h1);
    const unsigned b2 = __ballot_sync(kFull, h2);
    if (h1) {
      const int pos = c1 + __popc(b1 & below);
      if (pos < s1) o1[pos] = j;
    }
    if (h2) {
      const int pos = c2 + __popc(b2 & below);
      if (pos < s2) o2[pos] = j;
    }
    if (f1 < 0 && b1) f1 = base + __ffs(b1) - 1;
    if (f2 < 0 && b2) f2 = base + __ffs(b2) - 1;
    c1 += __popc(b1);
    c2 += __popc(b2);
  }
  const int fill1 = f1 < 0 ? 0 : f1;
  const int fill2 = f2 < 0 ? 0 : f2;
  for (int k = min(c1, s1) + lane; k < s1; k += 32) o1[k] = fill1;
  for (int k = min(c2, s2) + lane; k < s2; k += 32) o2[k] = fill2;
}

}  // namespace

extern "C" {

// lanes: 1 for the lanes path (one lane a query), 0 for the warps path.
// Returns the CUDA error code of the launch (0 on success).
int sam6d_two_scale_ball_query(const float* xyz, const float* q, int b, int n,
                               int m, float r1sq, int s1, float r2sq, int s2,
                               int lanes, int* out1, int* out2,
                               cudaStream_t stream) {
  if (lanes) {
    ball_query_lanes_kernel<<<dim3((m + 31) / 32, b), 32, 0, stream>>>(
        xyz, q, n, m, r1sq, s1, r2sq, s2, out1, out2);
  } else {
    const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
    ball_query_warps_kernel<<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        xyz, q, n, m, r1sq, s1, r2sq, s2, out1, out2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
