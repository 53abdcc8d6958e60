// Two-scale ball query for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel
// sam6d_tpu/kernels/ball_query.py::two_scale_ball_query_pallas (XLA twin:
// sam6d_tpu/ops/ball_query.py::two_scale_ball_query). For every query it
// returns the first s1 point indices with d2 < r1^2 and the first s2 with
// d2 < r2^2, in index order; empty slots repeat the first hit, or 0 if there
// is none (the reference ball_query_gpu.cu rule).
//
// Design: one warp per query walks the N candidates in 32-wide slices. Each
// lane tests one candidate against both radii; __ballot_sync gives the
// slice's hit masks and __popc of the lanes below gives each hit its slot, so
// hits are written in index order with no sort and no (B, M, N) distance
// matrix in memory. The walk stops as soon as both quotas are full, which
// bounds the work by the neighbourhood density rather than by N. Distances
// use the expanded |q|^2 - 2 q.x + |x|^2 form of pairwise_sq_distance, so
// radius decisions match the plain version except for pairs within float
// rounding of r^2.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// xyz: (B, 3, N) planar candidates; q: (B, 3, M) planar queries;
// out1: (B, M, s1), out2: (B, M, s2) int32.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    two_scale_ball_query_kernel(const float* __restrict__ xyz,
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
    const unsigned b1 = __ballot_sync(0xffffffffu, h1);
    const unsigned b2 = __ballot_sync(0xffffffffu, h2);
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

// Returns the CUDA error code of the launch (0 on success).
int sam6d_two_scale_ball_query(const float* xyz, const float* q, int b, int n,
                               int m, float r1sq, int s1, float r2sq, int s2,
                               int* out1, int* out2, cudaStream_t stream) {
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
  two_scale_ball_query_kernel<<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, q, n, m, r1sq, s1, r2sq, s2, out1, out2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
