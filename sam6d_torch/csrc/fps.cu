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
// What bounds it: M strictly dependent steps, each a sweep over N points and
// an argmax, so the latency of a step, not the card's rate, sets the time.
// Invalid points carry min-distance -1 from the start (fminf(-1, d) = -1,
// so the score is the min-distance itself) and padding slots -2. A score
// becomes a 32-bit key whose unsigned order is the float order; a warp takes
// the largest key and the lowest index holding it with two redux.sync.
// The first pick needs no special case: over the initial scores (1e10
// valid, -1 invalid) the argmax is the first valid index, or 0.
//
// Three paths (the wrapper in sam6d_torch/kernels/fps.py chooses from N):
//  * block (N <= kBlockThreads * 16): one block a cloud, each thread holding
//    its points and running min-distances in registers; a shared copy of
//    x/y/z gives the winner's coordinates. One step = one sweep, a warp
//    reduction into a slot double-buffered by step parity, ONE barrier, and
//    every warp reducing all the slots itself.
//  * cluster (N <= kClusterBlocks * 896 * 16, e.g. 42 views x 5000 template
//    points at onboarding): one thread block cluster of 16 blocks a cloud,
//    one launch for all steps. Each block owns a contiguous chunk (x/y/z in
//    its shared memory, min-distances in registers) and sends its winner
//    (key, index, coordinates) into a parity slot of every block's mailbox
//    with st.async through distributed shared memory, which counts the
//    bytes on that block's mbarrier; each block waits for its 16 winners and
//    every warp reduces the 16 slots: no atomics, no global scratch, no host
//    loop, no cluster-wide barrier a step.
//  * multi (larger N): one launch per step. Each block owns a contiguous
//    chunk, first reduces the previous step's per-block partial argmaxes
//    (so every block agrees on the last pick without atomics or a grid
//    barrier), updates its chunk of the min-distance in global memory and
//    writes its own partial, double-buffered by step parity.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 256;
constexpr int kClusterBlocks = 16;
constexpr int kClusterMaxThreads = 896;  // 72 registers a thread
constexpr int kMaxPoints = 16;  // points a thread holds, both paths
constexpr int kMultiThreads = 256;
constexpr float kInvalid = -1.0f;
constexpr float kPadding = -2.0f;

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float lx, float ly, float lz) {
  const float dx = __fsub_rn(px, lx);
  const float dy = __fsub_rn(py, ly);
  const float dz = __fsub_rn(pz, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Unsigned order of the key = float order of the score (-2 < -1 < 0 < ...).
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Pick {
  unsigned key;
  unsigned idx;
};

// The warp's largest key and the lowest index among the lanes holding it.
__device__ __forceinline__ Pick warp_pick(unsigned key, unsigned idx) {
  const unsigned kmax = __reduce_max_sync(kFull, key);
  const unsigned imin = __reduce_min_sync(kFull, key == kmax ? idx : 0xffffffffu);
  return {kmax, imin};
}

// The block's pick: each warp's pick goes into slots[parity][warp]; after
// one barrier every warp reduces all the slots itself, so every thread
// returns the same pick. A slot of parity p is rewritten two steps later,
// after the next step's barrier, which every warp passes only once it has
// read this step's slots.
__device__ __forceinline__ Pick block_pick(unsigned key, unsigned idx,
                                           uint2* slots, int parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Pick w = warp_pick(key, idx);
  if (lane == 0) slots[parity * 32 + warp] = make_uint2(w.key, w.idx);
  __syncthreads();
  const uint2 s = lane < static_cast<int>(blockDim.x >> 5)
                      ? slots[parity * 32 + lane]
                      : make_uint2(0u, 0xffffffffu);
  return warp_pick(s.x, s.y);
}

// ---- thread block clusters and mbarriers (PTX: sm_90)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives and waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// The shared::cluster address of this block's shared address `local` in
// block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Asynchronous stores into another block's shared memory that count their
// bytes on that block's mbarrier: the data and its signal travel together,
// with no fence.
__device__ __forceinline__ void st_async_v4(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async_b32(unsigned addr, unsigned v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// A block's winner as every block of its cluster receives it.
struct Winner {
  unsigned key;
  unsigned idx;
  float x, y, z;
};

// Each block's mailbox: for each step parity, one mbarrier and one slot per
// sending block, (key, index, x, y) in the first word and z in the second.
struct Mailbox {
  unsigned long long bar[2];
  uint4 slot[2][kClusterBlocks][2];
};

constexpr unsigned kMailBytes = kClusterBlocks * 20;  // a step's bytes in

// Arms both barriers (one arrival each: the block's own expect_tx); the
// cluster barrier after it keeps every remote store behind the
// initialisation.
__device__ __forceinline__ void mailbox_init(Mailbox* mb) {
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(&mb->bar[p])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
}

// The cluster's pick at step s: thread 0 expects the step's 16 x 20 bytes
// on the block's parity barrier; lanes 0-15 of warp 0 store the block's
// winner `w` into slot [s & 1][this block] of block `lane`'s mailbox with
// st.async, which counts the bytes on that block's barrier; every thread
// waits for its own barrier's phase and every warp reduces the 16 local
// slots. A slot of parity p is rewritten at step s + 2 only by a block that
// has received every block's step s + 1 winner, which each block sends
// after its step s + 1 barrier, once all its warps have read the step s
// slots; bytes that land before the expect_tx leave the phase open until
// it comes.
__device__ __forceinline__ Winner cluster_pick(Mailbox* mb, const Winner& w,
                                               unsigned rank, int s) {
  const int p = s & 1;
  const unsigned lane = threadIdx.x & 31;
  const unsigned bar = smem_addr(&mb->bar[p]);
  if (threadIdx.x == 0) mbar_expect_tx(bar, kMailBytes);
  if (threadIdx.x < static_cast<unsigned>(kClusterBlocks)) {
    const unsigned slot = map_rank(smem_addr(&mb->slot[p][rank][0]), lane);
    const unsigned rbar = map_rank(bar, lane);
    st_async_v4(slot, make_uint4(w.key, w.idx, __float_as_uint(w.x),
                                 __float_as_uint(w.y)), rbar);
    st_async_b32(slot + 16, __float_as_uint(w.z), rbar);
  }
  while (!mbar_try_wait(bar, (s >> 1) & 1)) {
  }
  uint4 a = make_uint4(0u, 0xffffffffu, 0u, 0u);
  unsigned z = 0u;
  if (lane < static_cast<unsigned>(kClusterBlocks)) {
    a = mb->slot[p][lane][0];
    z = mb->slot[p][lane][1].x;
  }
  const Pick g = warp_pick(a.x, a.y);
  const int src = __ffs(__ballot_sync(kFull, a.x == g.key && a.y == g.idx)) - 1;
  return {g.key, g.idx, __uint_as_float(__shfl_sync(kFull, a.z, src)),
          __uint_as_float(__shfl_sync(kFull, a.w, src)),
          __uint_as_float(__shfl_sync(kFull, z, src))};
}

// pts: (B, 3, N) planar; valid: (B, N) 0/1 bytes; out: (B, M) int32.
// Thread t holds points t + j * kBlockThreads, j < PPT.
template <int PPT>
__global__ void __launch_bounds__(kBlockThreads)
    fps_block_kernel(const float* __restrict__ pts,
                     const unsigned char* __restrict__ valid, int n, int m,
                     int* __restrict__ out) {
  extern __shared__ float sxyz[];  // x[n], y[n], z[n]
  __shared__ uint2 slots[2 * 32];
  float* sx = sxyz;
  float* sy = sx + n;
  float* sz = sy + n;
  const int b = blockIdx.x;
  const float* p = pts + static_cast<size_t>(b) * 3 * n;
  const unsigned char* vb = valid + static_cast<size_t>(b) * n;
  float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int k = threadIdx.x + j * kBlockThreads;
    if (k < n) {
      x[j] = p[k];
      y[j] = p[n + k];
      z[j] = p[2 * n + k];
      md[j] = vb[k] ? 1e10f : kInvalid;
      sx[k] = x[j];
      sy[k] = y[j];
      sz[k] = z[j];
    } else {
      x[j] = y[j] = z[j] = 0.0f;
      md[j] = kPadding;
    }
  }
  // the shared copy is read only after step 0's barrier
  int* ob = out + static_cast<size_t>(b) * m;
  float best = md[0];
  int bj = 0;
#pragma unroll
  for (int j = 1; j < PPT; ++j) {
    if (md[j] > best) {
      best = md[j];
      bj = j;
    }
  }
  for (int s = 0;; ++s) {
    const Pick w = block_pick(score_key(best), threadIdx.x + bj * kBlockThreads,
                              slots, s & 1);
    if (threadIdx.x == 0) ob[s] = static_cast<int>(w.idx);
    if (s + 1 == m) break;
    const float lx = sx[w.idx], ly = sy[w.idx], lz = sz[w.idx];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float d = fminf(md[j], sq_dist(x[j], y[j], z[j], lx, ly, lz));
      md[j] = d;
      if (j == 0 || d > best) {
        best = d;
        bj = j;
      }
    }
  }
}

// Grid (kClusterBlocks, B) in clusters of kClusterBlocks along x: block
// rank r of cloud b owns points [r * chunk, r * chunk + chunk). x/y/z sit in
// shared memory planes of blockDim.x * PPT (zero past the chunk), read two
// points at a time as float2; the min-distances stay in registers.
template <int PPT>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
    fps_cluster_kernel(const float* __restrict__ pts,
                       const unsigned char* __restrict__ valid, int n, int m,
                       int chunk, int* __restrict__ out) {
  extern __shared__ float sxyz[];
  __shared__ uint2 slots[2 * 32];
  __shared__ Mailbox mailbox;
  const int T = blockDim.x;
  const int cap = T * PPT;
  float* sx = sxyz;
  float* sy = sx + cap;
  float* sz = sy + cap;
  const int b = blockIdx.y;
  const unsigned rank = cluster_rank();
  const int lo = static_cast<int>(rank) * chunk;
  const int cnt = max(0, min(chunk, n - lo));
  const float* p = pts + static_cast<size_t>(b) * 3 * n;
  const unsigned char* vb = valid + static_cast<size_t>(b) * n;
  float md[PPT];
  // register j holds point 2 * (t + (j / 2) * T) + j % 2: pairs read as float2
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int k = 2 * (threadIdx.x + (j >> 1) * T) + (j & 1);
    if (k < cnt) {
      sx[k] = p[lo + k];
      sy[k] = p[n + lo + k];
      sz[k] = p[2 * n + lo + k];
      md[j] = vb[lo + k] ? 1e10f : kInvalid;
    } else {
      sx[k] = sy[k] = sz[k] = 0.0f;
      md[j] = kPadding;
    }
  }
  mailbox_init(&mailbox);
  float best = md[0];
  int bj = 0;
#pragma unroll
  for (int j = 1; j < PPT; ++j) {
    if (md[j] > best) {
      best = md[j];
      bj = j;
    }
  }
  const float2* sx2 = reinterpret_cast<const float2*>(sx);
  const float2* sy2 = reinterpret_cast<const float2*>(sy);
  const float2* sz2 = reinterpret_cast<const float2*>(sz);
  for (int s = 0;; ++s) {
    const Pick w = block_pick(score_key(best),
                              lo + 2 * (threadIdx.x + (bj >> 1) * T) + (bj & 1),
                              slots, s & 1);
    const int k = static_cast<int>(w.idx) - lo;
    const Winner g =
        cluster_pick(&mailbox, Winner{w.key, w.idx, sx[k], sy[k], sz[k]}, rank, s);
    if (lo == 0 && threadIdx.x == T - 1) {  // off warp 0's mailbox path
      out[static_cast<size_t>(b) * m + s] = static_cast<int>(g.idx);
    }
    if (s + 1 == m) break;
#pragma unroll
    for (int j2 = 0; j2 < PPT / 2; ++j2) {
      const int k2 = threadIdx.x + j2 * T;
      const float2 px = sx2[k2], py = sy2[k2], pz = sz2[k2];
      const float d0 = fminf(md[2 * j2], sq_dist(px.x, py.x, pz.x, g.x, g.y, g.z));
      const float d1 = fminf(md[2 * j2 + 1], sq_dist(px.y, py.y, pz.y, g.x, g.y, g.z));
      md[2 * j2] = d0;
      md[2 * j2 + 1] = d1;
      if (j2 == 0 || d0 > best) {
        best = d0;
        bj = 2 * j2;
      }
      if (d1 > best) {
        best = d1;
        bj = 2 * j2 + 1;
      }
    }
  }
  cluster_sync();  // no block leaves while another may still write to it
}

// The least latency of one step's synchronisation, no sweep: `steps`
// chained block_pick (redux pair, slot, barrier, redux pair) and, with
// `cluster`, cluster_pick after each (the winner sent to the 16 mailboxes
// by st.async through DSMEM, the mbarrier wait, the 16-slot reduction).
template <bool kCluster>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
    fps_latency_kernel(int steps, int* __restrict__ out) {
  __shared__ uint2 slots[2 * 32];
  __shared__ Mailbox mailbox;
  const unsigned rank = kCluster ? cluster_rank() : 0u;
  if (kCluster) mailbox_init(&mailbox);
  const unsigned key = threadIdx.x * 2654435761u;
  unsigned last = 0;
  for (int s = 0; s < steps; ++s) {
    const Pick w = block_pick(key ^ last, threadIdx.x, slots, s & 1);
    last = w.idx;
    if (kCluster) {
      last = cluster_pick(&mailbox, Winner{w.key, w.idx, 0.0f, 0.0f, 0.0f}, rank, s).idx;
    }
  }
  if (kCluster) cluster_sync();
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<int>(last);
}

// ---- multi-launch path (N above the cluster's capacity)

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
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
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

// ---- host side

template <int PPT>
cudaError_t launch_block(const float* pts, const unsigned char* valid, int b,
                         int n, int m, int* out, cudaStream_t stream) {
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(n);
  const cudaError_t err = cudaFuncSetAttribute(
      fps_block_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_block_kernel<PPT><<<b, kBlockThreads, smem, stream>>>(pts, valid, n, m, out);
  return cudaGetLastError();
}

// The cluster path's shape for N: points a thread (the fewest of 4, 8, 16
// that fit a kClusterMaxThreads block, so that most threads sweep), threads a
// block (a multiple of 32) and dynamic shared memory a block.
struct ClusterShape {
  int ppt, chunk, threads;
  size_t smem;
};

bool cluster_shape(int n, ClusterShape* cs) {
  cs->chunk = (n + kClusterBlocks - 1) / kClusterBlocks;
  for (int ppt = 4; ppt <= kMaxPoints; ppt *= 2) {
    const int threads = ((cs->chunk + ppt - 1) / ppt + 31) / 32 * 32;
    if (threads <= kClusterMaxThreads) {
      cs->ppt = ppt;
      cs->threads = threads;
      cs->smem = 3 * sizeof(float) * static_cast<size_t>(threads) * ppt;
      return true;
    }
  }
  return false;
}

// Sets the kernel's attributes and fills the launch configuration.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int b, int threads, size_t smem,
                           cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kClusterBlocks, b);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int PPT>
cudaError_t launch_cluster(const float* pts, const unsigned char* valid, int b,
                           int n, int m, const ClusterShape& cs, int* out,
                           cudaStream_t stream, int* max_clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(fps_cluster_kernel<PPT>, b, cs.threads,
                                   cs.smem, stream, &attr, &cfg);
  if (err != cudaSuccess) return err;
  if (max_clusters != nullptr) {
    return cudaOccupancyMaxActiveClusters(max_clusters, fps_cluster_kernel<PPT>, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PPT>, pts, valid, n, m,
                           cs.chunk, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the cluster path, or with max_clusters set only reports
// cudaOccupancyMaxActiveClusters for N's shape.
int cluster_entry(const float* pts, const unsigned char* valid, int b, int n,
                  int m, int* out, cudaStream_t stream, int* max_clusters) {
  ClusterShape cs;
  if (!cluster_shape(n, &cs)) return static_cast<int>(cudaErrorInvalidValue);
  switch (cs.ppt) {
    case 4:
      return static_cast<int>(launch_cluster<4>(pts, valid, b, n, m, cs, out,
                                                stream, max_clusters));
    case 8:
      return static_cast<int>(launch_cluster<8>(pts, valid, b, n, m, cs, out,
                                                stream, max_clusters));
    default:
      return static_cast<int>(launch_cluster<16>(pts, valid, b, n, m, cs, out,
                                                 stream, max_clusters));
  }
}

}  // namespace

extern "C" {

// Each entry returns the CUDA error code of the launch (0 on success).

// N <= kBlockThreads * kMaxPoints.
int sam6d_fps_block(const float* pts, const unsigned char* valid, int b, int n,
                    int m, int* out, cudaStream_t stream) {
  const int ppt = (n + kBlockThreads - 1) / kBlockThreads;
  if (ppt <= 1) return static_cast<int>(launch_block<1>(pts, valid, b, n, m, out, stream));
  if (ppt <= 2) return static_cast<int>(launch_block<2>(pts, valid, b, n, m, out, stream));
  if (ppt <= 4) return static_cast<int>(launch_block<4>(pts, valid, b, n, m, out, stream));
  if (ppt <= 8) return static_cast<int>(launch_block<8>(pts, valid, b, n, m, out, stream));
  if (ppt <= kMaxPoints) {
    return static_cast<int>(launch_block<kMaxPoints>(pts, valid, b, n, m, out, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// N <= kClusterBlocks * kClusterMaxThreads * kMaxPoints.
int sam6d_fps_cluster(const float* pts, const unsigned char* valid, int b,
                      int n, int m, int* out, cudaStream_t stream) {
  return cluster_entry(pts, valid, b, n, m, out, stream, nullptr);
}

// How many clusters of the cluster path's shape for N can be resident at
// once (cudaOccupancyMaxActiveClusters), with that shape's threads and
// dynamic shared memory a block.
int sam6d_fps_cluster_occupancy(int n, int* max_clusters, int* threads,
                                int* smem) {
  ClusterShape cs;
  if (!cluster_shape(n, &cs)) return static_cast<int>(cudaErrorInvalidValue);
  *threads = cs.threads;
  *smem = static_cast<int>(cs.smem);
  return cluster_entry(nullptr, nullptr, 1, n, 1, nullptr, nullptr, max_clusters);
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

// The synchronisation of `steps` FPS steps alone: one block of the block
// path's threads (cluster = 0), or one 16-block cluster of the cluster
// path's threads for N (cluster = 1). out: 16 int32 of scratch.
int sam6d_fps_latency(int cluster, int n, int steps, int* out,
                      cudaStream_t stream) {
  if (!cluster) {
    fps_latency_kernel<false><<<1, kBlockThreads, 0, stream>>>(steps, out);
    return static_cast<int>(cudaGetLastError());
  }
  ClusterShape cs;
  if (!cluster_shape(n, &cs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(fps_latency_kernel<true>, 1, cs.threads, 0,
                                   stream, &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fps_latency_kernel<true>, steps, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
