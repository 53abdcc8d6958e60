// Plain softmax attention on head-major (B, H, N, hd) operands, for Hopper
// (sm_90a), plain C interface for ctypes. One kernel serves two entries:
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
// Scores, the running max and sum, and the accumulator are fp32. q is
// scaled before the product (the fp32 q * scale, as K8's TPU kernel and K5
// do; K9's TPU kernel scales the product instead, a difference well inside
// ATTENTION_ATOL). K8 clamps the denominator at 1e-30 as _fused_kernel
// does; K9's contract is the plain sum, which the clamp never changes (the
// row maximum contributes exp(0) = 1).
//
// What bounds them on an H100 SXM: 4*B*H*Nq*Nk*hd operations. K8 at
// 16x16x1025^2x64 is 68.9 GFLOP: 1.03 ms on the fp32 FMA units (67
// TFLOP/s), 0.417 ms on the tensor cores in three-pass TF32 (495/3 = 165
// TFLOP/s); K9 at 16x16x257^2x64 is 4.33 GFLOP: 0.065 ms and 0.026 ms. The
// bytes (q, k, v read once, out written once) take a few percent of that.
//
// Design: the three-pass TF32 core of tf32x3.cuh with split-once staging:
// 8 warps of 16 query rows per block (128 rows per K/V read), the block's q
// rows scaled and split once into TF32 big/small pairs in shared memory,
// each K/V tile (32 keys at HDP <= 64, 16 above) fetched into registers
// while the previous one computes and split once by the threads that load
// it, so B fragments are one 16-byte shared load and no arithmetic; only P
// is split per fragment. hd is padded to HDP, the next multiple of 16, by
// masked loads (zero columns add nothing to a score and are never
// written); rows that are not 16-byte aligned (hd % 4 != 0, offset views)
// take 4-byte loads. Shared memory: 110 KB at HDP 64 (two blocks, 16 warps
// an SM, at 128 registers a thread), 177 KB at HDP 128 (one block).
// Measured on an H100 (PERF.md): one block of 8 warps an SM, 4-warp
// blocks, 16-key tiles at hd 64 and two 16-row tiles a warp were all
// slower; a cp.async raw stage (the other way to split once) would add
// 16.5 KB and leave one block an SM.
//
// The bf16 entries (sam6d_fused_attention_bf16, _small_bf16) run one
// kernel, head_major_attention_wgmma_kernel, on the wgmma core of
// bf16_wgmma.cuh (the one K1's and K5's bf16 entries run): wgmma.mma_async
// for Q K^T and P V with fp32 accumulation, fp32 scores and softmax, p
// rounded to bf16 and l summed from the rounded p. K8's q enters as bf16(q
// * bf16(scale)), the q_aug of _fused_kernel; K9 scales the fp32 product,
// as _small_kernel does. They take hd a multiple of 8 up to 128, run
// padded to 16, 32, 64, 80 or 128 channels (TMA fills the columns past hd
// with zeros), k and v rows 16-byte aligned (their strides and bases are
// what TMA takes; the launch refuses others), q and out rows 4-byte aligned
// (q is read by the threads, 16 bytes at a time where its rows allow). K
// and V each get a 4-D tensor map of their own view ({hd, keys, heads,
// samples} with the view's strides), so the (B, H, N, hd) views of a fused
// qkv projection are read in place. Query rows and keys are separate:
// up to 320 keys (256 above hd 64) stay resident in the ring and one block
// takes all of a (sample, head)'s row tiles (K9 at 257, like K5); longer
// sequences stream through two stages, one block a 128 rows (K8 at 1025:
// 9 row blocks x 16 heads x 16 crops). Two blocks an SM at hd <= 80, one
// at 128. K8 at 16x16x1025^2x64 is 68.9 GFLOP: 0.070 ms at the dense bf16
// rate (989 TFLOP/s), its bytes (33.6 MB) 0.010 ms: operations.
#include "bf16_wgmma.cuh"
#include "tf32x3.cuh"

namespace {

// element strides of a (B, H, N, hd) operand; the hd axis has stride 1
struct Strides {
  long long b, h, n;
};

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // query rows per block

// Keys per K/V tile and resident blocks per SM the registers must allow:
// 32 keys and two blocks at HDP <= 64 (128 registers a thread); above, the
// output fragments take twice as many registers and shared memory allows
// one block anyway, and 16-key tiles halve the prefetched tile's registers
// (32-key tiles spilled 40 bytes at HDP 128).
template <int HDP>
__host__ __device__ constexpr int tile_keys() { return HDP <= 64 ? 32 : 16; }
template <int HDP>
__host__ __device__ constexpr int min_blocks() { return HDP <= 64 ? 2 : 1; }

template <int HDP>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<HDP>())
    head_major_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out,
                                Strides sq, Strides sk, Strides sv, Strides so, int nq,
                                int nk, int hd, float scale) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.y, b = blockIdx.z;
  const sam6d::Operands op{q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
                           v + b * sv.b + h * sv.h, out + b * so.b + h * so.h,
                           sq.n, sk.n, sv.n, so.n, nq, nk, hd};
  sam6d::attention_rows<HDP, kWarps, tile_keys<HDP>(), sam6d::Staging::kSplitOnce>(
      op, reinterpret_cast<float*>(smem4), blockIdx.x * kRows, scale);
}

template <int HDP>
int launch(const float* q, const float* k, const float* v, float* out, Strides sq,
           Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk, int hd,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes =
      sam6d::core_smem_bytes<HDP, kWarps, tile_keys<HDP>(), sam6d::Staging::kSplitOnce>();
  cudaError_t err = cudaFuncSetAttribute(head_major_attention_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kRows - 1) / kRows, heads, b);
  head_major_attention_kernel<HDP><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, out, sq, sk, sv, so, nq, nk, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_padded(const float* q, const float* k, const float* v, float* out, Strides sq,
                  Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk,
                  int hd, float scale, cudaStream_t stream) {
  if (hd < 1 || nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 2: return launch<32>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 3: return launch<48>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 4: return launch<64>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 5: return launch<80>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 6: return launch<96>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 7: return launch<112>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    case 8: return launch<128>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 entries on the wgmma core. kPrescale: K8 (q enters as bf16(q *
// scale)); otherwise K9 (the fp32 product scaled).
template <int HD, bool kPrescale>
__global__ void __launch_bounds__(sam6d::wgattn::kThreads, sam6d::wgattn::min_blocks<HD>())
    head_major_attention_wgmma_kernel(const __grid_constant__ sam6d::wgattn::KVMaps maps,
                                      const sam6d::wgattn::bf16* __restrict__ q,
                                      sam6d::wgattn::bf16* __restrict__ out, Strides sq,
                                      Strides so, int nq, int nk, int hd, int row_tiles,
                                      float scale) {
  namespace wa = sam6d::wgattn;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const wa::Tiles op{q + b * sq.b + h * sq.h, out + b * so.b + h * so.h, sq.n, so.n, nq, nk,
                     hd, h, b};
  const int rt0 = blockIdx.x * row_tiles;
  const int n_rt = min(row_tiles, (nq + wa::kRowsWG - 1) / wa::kRowsWG - rt0);
  if constexpr (kPrescale)
    wa::attend<HD>(maps, op, wa::checked_base(smem_raw), rt0, n_rt, scale, wa::kLog2e,
                   wa::PrescaledQ{});
  else
    wa::attend<HD>(maps, op, wa::checked_base(smem_raw), rt0, n_rt, 1.f, scale * wa::kLog2e,
                   wa::NoBias{});
}

// (b, h, row) element strides as the encoder takes them
inline void as_array(long long (&a)[3], const Strides& s) {
  a[0] = s.b;
  a[1] = s.h;
  a[2] = s.n;
}

template <int HD, bool kPrescale>
int launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
                Strides sv, Strides so, int b, int heads, int nq, int nk, int hd, float scale,
                cudaStream_t stream) {
  namespace wa = sam6d::wgattn;
  wa::KVMaps maps;
  long long s[3];
  as_array(s, sk);
  int err = wa::encode_operand_maps<HD>(maps.k, k, s, b, heads, nk, hd);
  if (err != 0) return err;
  as_array(s, sv);
  err = wa::encode_operand_maps<HD>(maps.v, v, s, b, heads, nk, hd);
  if (err != 0) return err;
  const size_t bytes = wa::core_smem_bytes<HD>(nk);
  err = static_cast<int>(cudaFuncSetAttribute(head_major_attention_wgmma_kernel<HD, kPrescale>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(bytes)));
  if (err != 0) return err;
  const int row_tiles = wa::row_tiles_per_block<HD>(nq, nk);
  const dim3 grid(((nq + wa::kRowsWG - 1) / wa::kRowsWG + row_tiles - 1) / row_tiles, heads, b);
  head_major_attention_wgmma_kernel<HD, kPrescale><<<grid, wa::kThreads, bytes, stream>>>(
      maps, static_cast<const wa::bf16*>(q), static_cast<wa::bf16*>(out), sq, so, nq, nk, hd,
      row_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// the padded head dim of the wgmma core that takes hd (a multiple of 8 up
// to 128); 0 for any other
inline int padded_hd(int hd) {
  if (hd < 8 || hd > 128 || hd % 8) return 0;
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 80 ? 80 : 128;
}

// q and out rows 4-byte aligned (k and v are the encoder's to check)
inline bool rows_4_byte_aligned(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && s.b % 2 == 0 && s.h % 2 == 0 && s.n % 2 == 0;
}

template <bool kPrescale>
int launch_padded_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                       Strides sk, Strides sv, Strides so, int b, int heads, int nq, int nk,
                       int hd, float scale, cudaStream_t stream) {
  if (nq < 1 || nk < 1 || !rows_4_byte_aligned(q, sq) || !rows_4_byte_aligned(out, so))
    return static_cast<int>(cudaErrorInvalidValue);
#define SAM6D_BF16_CASE(P)                                                                  \
  return launch_bf16<P, kPrescale>(q, k, v, out, sq, sk, sv, so, b, heads, nq, nk, hd, scale, \
                                   stream)
  switch (padded_hd(hd)) {
    case 16: SAM6D_BF16_CASE(16);
    case 32: SAM6D_BF16_CASE(32);
    case 64: SAM6D_BF16_CASE(64);
    case 80:
      if constexpr (kPrescale) SAM6D_BF16_CASE(80);
      return static_cast<int>(cudaErrorInvalidValue);
    case 128:
      if constexpr (kPrescale) SAM6D_BF16_CASE(128);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SAM6D_BF16_CASE
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
  return launch_padded(q, k, v, out, Strides{sq[0], sq[1], sq[2]}, Strides{sk[0], sk[1], sk[2]},
                       Strides{sv[0], sv[1], sv[2]}, Strides{so[0], so[1], so[2]}, b, heads,
                       nq, nk, hd, scale, stream);
}

// q, k, v: (b, heads, n, hd) float32, hd contiguous, 16-byte aligned rows
// (strides multiples of 4 elements); out: (b, heads, n, hd) contiguous. hd
// must be 16, 32 or 64. Returns the CUDA error code of the launch.
int sam6d_fused_attention_small(const float* q, const float* k, const float* v,
                                float* out, const long long* sq,
                                const long long* sk, const long long* sv, int b,
                                int heads, int n, int hd, float scale,
                                cudaStream_t stream) {
  if (hd != 16 && hd != 32 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n) * hd;
  return launch_padded(q, k, v, out, Strides{sq[0], sq[1], sq[2]}, Strides{sk[0], sk[1], sk[2]},
                       Strides{sv[0], sv[1], sv[2]}, Strides{heads * rows, rows, hd}, b, heads,
                       n, n, hd, scale, stream);
}

// The bf16 entries. K8: q (b, heads, nq, hd), k and v (b, heads, nk, hd),
// out (b, heads, nq, hd), bfloat16, strides as sam6d_fused_attention's;
// `scale` is hd^-0.5 rounded to bf16 (q enters as bf16(q * scale)). K9:
// self-attention, out contiguous, the fp32 product scaled by `scale`. hd a
// multiple of 8 up to 128 (K9: 16, 32 or 64); k and v 16-byte aligned
// with strides of whole 16 bytes, q and out rows 4-byte aligned (anything
// else: cudaErrorInvalidValue). Return the CUDA error code of the launch.
int sam6d_fused_attention_bf16(const void* q, const void* k, const void* v, void* out,
                               const long long* sq, const long long* sk,
                               const long long* sv, const long long* so, int b,
                               int heads, int nq, int nk, int hd, float scale,
                               cudaStream_t stream) {
  return launch_padded_bf16<true>(q, k, v, out, Strides{sq[0], sq[1], sq[2]},
                                  Strides{sk[0], sk[1], sk[2]}, Strides{sv[0], sv[1], sv[2]},
                                  Strides{so[0], so[1], so[2]}, b, heads, nq, nk, hd, scale,
                                  stream);
}

int sam6d_fused_attention_small_bf16(const void* q, const void* k, const void* v, void* out,
                                     const long long* sq, const long long* sk,
                                     const long long* sv, int b, int heads, int n, int hd,
                                     float scale, cudaStream_t stream) {
  if (hd != 16 && hd != 32 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n) * hd;
  return launch_padded_bf16<false>(q, k, v, out, Strides{sq[0], sq[1], sq[2]},
                                   Strides{sk[0], sk[1], sk[2]}, Strides{sv[0], sv[1], sv[2]},
                                   Strides{heads * rows, rows, hd}, b, heads, n, n, hd, scale,
                                   stream);
}

// Dynamic shared memory, bytes, of a block of the bf16 entries over nq query
// rows and nk keys at head dim hd, as their launch sizes it (a block's size
// depends on the keys alone); -1 for an hd they do not take.
int sam6d_fused_attention_bf16_smem(int nq, int nk, int hd) {
  (void)nq;
  switch (padded_hd(hd)) {
    case 16: return static_cast<int>(sam6d::wgattn::core_smem_bytes<16>(nk));
    case 32: return static_cast<int>(sam6d::wgattn::core_smem_bytes<32>(nk));
    case 64: return static_cast<int>(sam6d::wgattn::core_smem_bytes<64>(nk));
    case 80: return static_cast<int>(sam6d::wgattn::core_smem_bytes<80>(nk));
    case 128: return static_cast<int>(sam6d::wgattn::core_smem_bytes<128>(nk));
    default: return -1;
  }
}

}  // extern "C"
