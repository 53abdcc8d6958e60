// Greedy NMS over a fixed-capacity set, run to its fixed point in one block,
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package's NMS is an XLA while_loop
// (sam6d_tpu/ops/masks.py:143 nms_masked), which runs on the device with no
// host read. The port's plain version (kernels/nms.py, the loop of
// ops/masks.nms_masked_rounds) reads its undecided flag on the host every
// round; this kernel runs the same rounds between __syncthreads, so the
// frame chain queues NMS and goes on.
//
// Input: the (n, n) overlap-and-precedence matrix O as bytes (0 / 1),
// O[i, j] = 1 where j ranks above i (score, then the lower index) and the
// two overlap above the threshold in one group, as ops/masks forms it, and
// the (n,) valid flags. Each round decides every undecided candidate whose
// higher-ranked overlapping candidates are decided: KEPT if none of them is
// kept or undecided, SUPPRESSED if one of them is kept; invalid slots start
// suppressed. The loop ends when no candidate is undecided. Outputs: the
// keep flags (n,) and the number of rounds, both on the device.
//
// What bounds it on an H100 SXM: the function reads O once (9.4 MB at the
// AMG's n = 3072, 16 KB at the ISM's 128): 2.8 us of HBM at n = 3072. The
// rounds are a chain, each decided only after the one before, so they run
// in one block (one SM) and take the SM's latency and L2 bandwidth, not the
// card's.
//
// Design: one block of 1024 threads. O is packed once into 32-bit words
// (row i, word w: bit b = O[i, 32 w + b]), 16 bytes a load where n % 16 ==
// 0 (n = 3072: 1.18 MB, which stays in L2; the caller's workspace), or into
// shared memory where the words fit it (n <= 1280). The kept and suppressed
// sets are bit sets in shared memory. A round gives each warp the
// undecided rows i = warp, warp + 32, ...: its lanes AND row i's words with
// ~suppressed (any higher-ranked candidate kept or undecided) and with kept
// (any kept), two warp votes, and lane 0 sets i's bit in the round's new
// sets; after a barrier the new sets merge and __syncthreads_or says
// whether any candidate is still undecided.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// shared memory above the bit sets that may hold the packed words
constexpr size_t kMaxSmemWords = 200 * 1024;

__host__ __device__ inline int words_per_row(int n) { return (n + 31) / 32; }

__host__ inline size_t packed_bytes(int n) {
  return sizeof(uint32_t) * static_cast<size_t>(n) * words_per_row(n);
}

// 16 bytes of 0/1 flags -> 16 bits, byte b to bit b
__device__ __forceinline__ uint32_t bits16(uint4 v) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // each byte to 0 or 1, then the four bytes' ones gathered into bits 24-27
    const uint32_t ones = __vcmpne4(x[k], 0u) & 0x01010101u;
    out |= ((ones * 0x01020408u) >> 24) << (4 * k);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads, 1)
    nms_fixed_point_kernel(const uint8_t* __restrict__ overlap,
                           const uint8_t* __restrict__ valid, uint32_t* workspace, int n,
                           int words_in_smem, uint8_t* __restrict__ keep,
                           int* __restrict__ rounds_out) {
  extern __shared__ uint32_t smem[];
  const int W = words_per_row(n);
  uint32_t* kept = smem;            // [W] bit sets
  uint32_t* supp = kept + W;
  uint32_t* new_kept = supp + W;
  uint32_t* new_supp = new_kept + W;
  uint32_t* words = words_in_smem ? new_supp + W : workspace;  // [n][W]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // the sets: invalid slots and the bits past n start suppressed
  bool undecided = false;
  for (int w = tid; w < W; w += kThreads) {
    uint32_t v = 0;
    for (int b = 0; b < 32 && 32 * w + b < n; ++b) v |= (valid[32 * w + b] != 0 ? 1u : 0u) << b;
    kept[w] = 0u;
    supp[w] = ~v;
    new_kept[w] = 0u;
    new_supp[w] = 0u;
    undecided |= v != 0u;
  }
  // O packed once, a word a thread in turn
  const bool wide = n % 16 == 0 && (reinterpret_cast<uintptr_t>(overlap) & 15) == 0;
  const int total = n * W;
  for (int e = tid; e < total; e += kThreads) {
    const int r = e / W, w = e - r * W;
    const uint8_t* src = overlap + static_cast<size_t>(r) * n + 32 * w;
    const int cnt = min(32, n - 32 * w);
    uint32_t bits = 0;
    if (wide && cnt == 32) {
      bits = bits16(__ldg(reinterpret_cast<const uint4*>(src))) |
             (bits16(__ldg(reinterpret_cast<const uint4*>(src) + 1)) << 16);
    } else if (wide) {  // n % 32 == 16: the row's last 16 flags
      bits = bits16(__ldg(reinterpret_cast<const uint4*>(src)));
    } else {
      for (int b = 0; b < cnt; ++b) bits |= (src[b] != 0 ? 1u : 0u) << b;
    }
    words[e] = bits;
  }
  int rounds = 0;
  bool any = __syncthreads_or(undecided);
  while (any) {
    for (int i = warp; i < n; i += kWarps) {
      const uint32_t bit = 1u << (i & 31);
      if ((kept[i >> 5] | supp[i >> 5]) & bit) continue;  // decided
      const uint32_t* row = words + static_cast<size_t>(i) * W;
      bool above_unsupp = false, above_kept = false;
      for (int w = lane; w < W; w += 32) {
        const uint32_t o = row[w];
        above_unsupp |= (o & ~supp[w]) != 0u;
        above_kept |= (o & kept[w]) != 0u;
      }
      above_unsupp = __any_sync(0xffffffffu, above_unsupp);
      above_kept = __any_sync(0xffffffffu, above_kept);
      if (lane == 0) {
        if (!above_unsupp) atomicOr(&new_kept[i >> 5], bit);
        if (above_kept) atomicOr(&new_supp[i >> 5], bit);
      }
    }
    __syncthreads();  // every row of the round read the old sets
    undecided = false;
    for (int w = tid; w < W; w += kThreads) {
      kept[w] |= new_kept[w];
      supp[w] |= new_supp[w];
      new_kept[w] = 0u;
      new_supp[w] = 0u;
      undecided |= ~(kept[w] | supp[w]) != 0u;
    }
    ++rounds;
    any = __syncthreads_or(undecided);
  }
  for (int i = tid; i < n; i += kThreads) keep[i] = (kept[i >> 5] >> (i & 31)) & 1u;
  if (tid == 0) *rounds_out = rounds;
}

bool words_fit_smem(int n) { return packed_bytes(n) <= kMaxSmemWords; }

}  // namespace

extern "C" {

// Bytes of device workspace the launch needs for the packed matrix: 0 when
// it fits the block's shared memory.
int sam6d_nms_workspace_bytes(int n) {
  return words_fit_smem(n) ? 0 : static_cast<int>(packed_bytes(n));
}

// overlap: (n, n) bytes, 0 / 1; valid: (n,) bytes; workspace:
// sam6d_nms_workspace_bytes(n) bytes (may be null when that is 0); keep:
// (n,) bytes out; rounds: one int32 out. One block on `stream`. Returns the
// CUDA error code of the launch.
int sam6d_nms_fixed_point(const void* overlap, const void* valid, void* workspace, int n,
                          void* keep, void* rounds, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = words_fit_smem(n);
  if (!in_smem && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(uint32_t) * 4 * words_per_row(n) + (in_smem ? packed_bytes(n) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      nms_fixed_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fixed_point_kernel<<<1, kThreads, bytes, stream>>>(
      static_cast<const uint8_t*>(overlap), static_cast<const uint8_t*>(valid),
      static_cast<uint32_t*>(workspace), n, in_smem ? 1 : 0, static_cast<uint8_t*>(keep),
      static_cast<int*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
