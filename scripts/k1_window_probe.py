"""Probes of K1's bf16 windowed launch on one GPU (SAM's windowed block: 25
windows of 14x14 tokens, 16 heads of 80, rel-pos std 0.1), each on a copy
of `sam6d_torch/csrc/`, so that the shipped source carries no probe:

    python3 scripts/k1_window_probe.py --split CSRC
        puts clock64 phase stamps into a copy of CSRC: into its windowed
        kernel (`attention_relpos_window_kernel`), or, on a source without
        one, into the core's attend() that ran the windows before; each
        phase's cycles are summed by atomics from window 0's 16 (sample,
        head)s only. Builds the copy's attention_relpos.cu alone, checks it
        against the plain version, and prints the cycles a warp spends in
        each phase of a full row tile and of the tail tile (rows 192-195).
    python3 scripts/k1_window_probe.py CSRC [CSRC ...]
        builds each directory's attention_relpos.cu alone (one nvcc each, in
        parallel) and times its windowed launch in turns: runs of 10
        launches (CUDA events) and the card alone (torch.profiler, 10
        calls), each held to the plain bf16 version, with its table stage
        alone where the source has one (held to bf16_rel_pos_tables).
    python3 scripts/k1_window_probe.py --smem
        the SM cycles a warp-wide 16-byte shared-memory load costs under a
        saturating load, by address pattern.

Copies are built under `sam6d_torch/_build/probe/` (git-ignored). Every
line starts with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WORK = ROOT / "sam6d_torch" / "_build" / "probe"

# the phase accumulators and stamps, put at the top of the stamped namespace
STAMPS = """
__device__ unsigned long long g_split[64];
__device__ __forceinline__ long long stamp() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
  return c;
}
// window 0's blocks only: the other windows run unstamped beside them
__device__ __forceinline__ void put(int slot, long long dt) {
  if ((threadIdx.x & 31) == 0 && blockIdx.z == 0) {
    atomicAdd(&g_split[slot], static_cast<unsigned long long>(dt));
    atomicAdd(&g_split[32 + slot], 1ull);
  }
}
"""
READ = """
extern "C" int sam6d_probe_split(void* dst, int clear) {
  if (clear) {
    unsigned long long z[64] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(%s::g_split, z, sizeof(z)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(dst, %s::g_split, 64 * 8));
}
"""
PHASES = ["q load / wait", "table pass, rel_h warps", "table pass, rel_w warps",
          "prescale + barriers", "Q K^T + wait (64-key tile)", "bias add (64-key tile)",
          "softmax (64-key tile)", "P V + wait (64-key tile)", "last key tile (all)",
          "full-barrier wait", "epilogue", "row tile", "block", "block start to staged"]

# (file, [(old, new), ...]) for the windowed kernel; slot T + i, T = 16 on the tail tile
WINDOW_STAMPS = ("attention_relpos.cu", [
    ("namespace window {\n", "namespace window {\n" + STAMPS),
    ("  if (threadIdx.x == 0) {  // the q tiles",
     "  const long long t_block = stamp();\n  if (threadIdx.x == 0) {  // the q tiles"),
    ("  __syncthreads();\n  if (rt0 + wg >= n_rt) return;",
     "  __syncthreads();\n  put(13, stamp() - t_block);\n  if (rt0 + wg >= n_rt) return;"),
    ("  __syncwarp();\n  wa::mbar_wait(&q_full[wg], 0);\n  form_tables<HD>(qs, rel_s, tab_h, tab_w, q0, n, gh, gw);\n",
     "  const int T = (q0 + 64 > n) ? 16 : 0;\n  long long t_rt = stamp(), t_p = t_rt;\n"
     "  __syncwarp();\n  wa::mbar_wait(&q_full[wg], 0);\n"
     "  { long long tt = stamp(); put(T + 0, tt - t_p); t_p = tt; }\n"
     "  form_tables<HD>(qs, rel_s, tab_h, tab_w, q0, n, gh, gw);\n"
     "  { long long tt = stamp(); put(T + (warp < 2 ? 1 : 2), tt - t_p); t_p = tt; }\n"),
    ("  wa::fence_async_shared();\n  wa::wg_sync(bar);\n  const bf16* rh_lo",
     "  wa::fence_async_shared();\n  wa::wg_sync(bar);\n"
     "  { long long tt = stamp(); put(T + 3, tt - t_p); t_p = tt; }\n  const bf16* rh_lo"),
    ("    float sf[NTT][4];\n\n    wa::fence_regs(sf);",
     "    float sf[NTT][4];\n    long long ts = stamp();\n\n    wa::fence_regs(sf);"),
    ("    wa::wgmma_wait0();\n    wa::fence_regs(sf);\n\n    uint32_t pa[KTT][4];",
     "    wa::wgmma_wait0();\n    wa::fence_regs(sf);\n"
     "    { long long t2 = stamp(); if (kFull) put(T + 4, t2 - ts); ts = t2; }\n\n"
     "    uint32_t pa[KTT][4];"),
    ("      add_bias(sf, rh_lo, rh_hi, rw_lo, rw_hi, gw, inv_gw, k0, n, t);",
     "      add_bias(sf, rh_lo, rh_hi, rw_lo, rw_hi, gw, inv_gw, k0, n, t);\n"
     "      wa::fence_regs(sf);\n"
     "      { long long t2 = stamp(); if (kFull) put(T + 5, t2 - ts); ts = t2; }"),
    ("    // O += P V\n    wa::fence_regs(o);",
     "    wa::fence_regs(pa);\n    { long long t2 = stamp(); if (kFull) put(T + 6, t2 - ts); ts = t2; }\n"
     "    // O += P V\n    wa::fence_regs(o);"),
    ("    wa::fence_regs(pa);\n  };",
     "    wa::fence_regs(pa);\n    { long long t2 = stamp(); if (kFull) put(T + 7, t2 - ts); ts = t2; }\n  };"),
    ("    __syncwarp();\n    wa::mbar_wait(&full[kt], 0);\n",
     "    __syncwarp();\n"
     "    { long long tw = stamp(); wa::mbar_wait(&full[kt], 0); put(T + 9, stamp() - tw); }\n"
     "    long long tl = stamp();\n"),
    ("      tile_step(std::integral_constant<int, 1>{}, std::false_type{}, kt, kTailKeys * 128, TT);\n  }\n",
     "      tile_step(std::integral_constant<int, 1>{}, std::false_type{}, kt, kTailKeys * 128, TT);\n"
     "    if (kt == L.n_kt - 1) put(T + 8, stamp() - tl);\n  }\n  long long te = stamp();\n"),
    ("NA + 8 * j + 2 * t);\n  }\n}",
     "NA + 8 * j + 2 * t);\n  }\n"
     "  { long long t2 = stamp(); put(T + 10, t2 - te); put(T + 11, t2 - t_rt); "
     "put(12, t2 - t_block); }\n}"),
], "window")

# the same phases in the core's attend(), which ran the windows before the
# windowed kernel (the block total is stamped in attention_relpos_wgmma_kernel)
ATTEND_STAMPS = ("bf16_wgmma.cuh", [
    ("namespace sam6d {\nnamespace wgattn {\n", "namespace sam6d {\nnamespace wgattn {\n" + STAMPS),
    ("    const int q0 = rt * kRowsWG;\n",
     "    const int q0 = rt * kRowsWG;\n    const int T = (q0 + kRowsWG > nq) ? 16 : 0;\n"
     "    long long t_rt = stamp(), t_p = t_rt;\n"),
    ("      wg_sync(bar);\n      bias.prepare(qs, q0, nq);\n",
     "      wg_sync(bar);\n      { long long t = stamp(); put(T + 0, t - t_p); t_p = t; }\n"
     "      bias.prepare(qs, q0, nq);\n"
     "      { long long t = stamp(); put(T + ((warp < 2) ? 1 : 2), t - t_p); t_p = t; }\n"),
    ("    fence_async_shared();\n    wg_sync(bar);\n\n    float o[NA / 2];",
     "    fence_async_shared();\n    wg_sync(bar);\n"
     "    { long long t = stamp(); put(T + 3, t - t_p); t_p = t; }\n\n    float o[NA / 2];"),
    ("      // S = Q K^T (fp32)\n      fence_regs(sf);",
     "      long long ts = stamp();\n      const int F = NTT == 1 ? 8 : 0;\n"
     "      // S = Q K^T (fp32)\n      fence_regs(sf);"),
    ("      wgmma_wait0();\n      fence_regs(sf);\n\n      const int k0 = kt * kTileKeys, nk = min(kTileKeys, nk_all - k0);\n"
     "      bias.add(sf, k0, nk, t);\n",
     "      wgmma_wait0();\n      fence_regs(sf);\n"
     "      { long long t2 = stamp(); if (!F) put(T + 4, t2 - ts); ts = t2; }\n\n"
     "      const int k0 = kt * kTileKeys, nk = min(kTileKeys, nk_all - k0);\n"
     "      bias.add(sf, k0, nk, t);\n      fence_regs(sf);\n"
     "      { long long t2 = stamp(); if (!F) put(T + 5, t2 - ts); ts = t2; }\n"),
    ("      // O += P V\n      fence_regs(o);",
     "      fence_regs(o);\n      fence_regs(pa);\n"
     "      { long long t2 = stamp(); if (!F) put(T + 6, t2 - ts); ts = t2; }\n"
     "      // O += P V\n      fence_regs(o);"),
    ("      fence_regs(pa);\n    };",
     "      fence_regs(pa);\n      { long long t2 = stamp(); if (!F) put(T + 7, t2 - ts); ts = t2; }\n    };"),
    ("      mbar_wait(&full[stage], resident ? 0 : (kt / S) & 1);\n",
     "      { long long tw = stamp();\n      mbar_wait(&full[stage], resident ? 0 : (kt / S) & 1);\n"
     "      put(T + 9, stamp() - tw); }\n"),
    ("      if (nk_all - kt * kTileKeys <= 8)\n        tile_step(std::integral_constant<int, 1>{}, kt, kt_s, kt_s + TB);\n",
     "      if (nk_all - kt * kTileKeys <= 8) {\n        long long tt = stamp();\n"
     "        tile_step(std::integral_constant<int, 1>{}, kt, kt_s, kt_s + TB);\n"
     "        put(T + 8, stamp() - tt);\n      } else\n"),
    ("      else\n        tile_step(std::integral_constant<int, NT>{}, kt, kt_s, kt_s + TB);\n",
     "        tile_step(std::integral_constant<int, NT>{}, kt, kt_s, kt_s + TB);\n"),
    ("    const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);",
     "    long long te = stamp();\n    const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);"),
    ("        store(o1[4 * j], o1[4 * j + 1], o1[4 * j + 2], o1[4 * j + 3], NA + 8 * j + 2 * t);\n    }\n  }\n}",
     "        store(o1[4 * j], o1[4 * j + 1], o1[4 * j + 2], o1[4 * j + 3], NA + 8 * j + 2 * t);\n    }\n"
     "    { long long t2 = stamp(); put(T + 10, t2 - te); put(T + 11, t2 - t_rt); }\n  }\n}"),
], "sam6d::wgattn")


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def build(src: Path, name: str):
    """nvcc of src/attention_relpos.cu alone into WORK/name.so (a Popen)."""
    from sam6d_torch.kernels import _build
    return subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                             "-o", str(WORK / f"{name}.so"), str(src / "attention_relpos.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(name: str):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(WORK / f"{name}.so"))
    lib.sam6d_flash_attention_relpos_bf16.argtypes = [P, P, P, P, I, I, I, I, I, I, F, P]
    if hasattr(lib, "sam6d_flash_attention_relpos_bf16_window_tables"):
        lib.sam6d_flash_attention_relpos_bf16_window_tables.argtypes = [P, P, P, P, I, I, I, I, I,
                                                                        I, P]
    if hasattr(lib, "sam6d_probe_split"):
        lib.sam6d_probe_split.argtypes = [P, I]
    return lib


def window_case():
    """The windowed block's operands on the card and its plain outputs."""
    import numpy as np
    import torch
    from sam6d_torch.kernels import attention_relpos as rp
    rng = np.random.RandomState(0)

    def bf(shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * np.float32(scale)).cuda().to(
            torch.bfloat16)

    qkv = bf((25, 196, 3 * 1280))
    with torch.no_grad():
        qkv[..., :2560] *= 0.5
    rh, rw = bf((27, 80), 0.1), bf((27, 80), 0.1)
    want = rp.flash_attention_relpos_bf16_plain(qkv, rh, rw, (14, 14), 16)
    tables = torch.cat(rp.bf16_rel_pos_tables(qkv, rh, rw, (14, 14), 16), -1).to(torch.bfloat16)
    return qkv, rh, rw, want, tables


def launcher(lib, qkv, rh, rw, out):
    import torch
    from sam6d_torch.kernels.attention import bf16_scale
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.sam6d_flash_attention_relpos_bf16(qkv.data_ptr(), rh.data_ptr(), rw.data_ptr(),
                                                    out.data_ptr(), 25, 196, 16, 80, 14, 14,
                                                    bf16_scale(80 ** -0.5), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
    return run


def card_alone(fn, calls=10):
    """The device time a call of fn() queues, ms, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return sum(us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / calls


def split(csrc: Path) -> int:
    import torch
    dst = WORK / "split"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    text = (dst / "attention_relpos.cu").read_text()
    fname, edits, ns = WINDOW_STAMPS if "attention_relpos_window_kernel" in text else ATTEND_STAMPS
    path = dst / fname
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{fname}: the stamp site {old[:60]!r} is not unique in {csrc}")
        src = src.replace(old, new)
    path.write_text(src)
    if fname != "attention_relpos.cu":  # the block total, in the kernel that calls attend()
        for site in ("  const int wg = threadIdx.x / 128;\n  unsigned char* bias_smem",
                     "                 scale, wa::kLog2e, bias);\n}\n\ntemplate <int HD>\nint launch_bf16("):
            if text.count(site) != 1:
                raise SystemExit(f"attention_relpos.cu: the stamp site {site[:60]!r} is not unique")
        text = text.replace(
            "  extern __shared__ __align__(1024) unsigned char smem_raw[];\n"
            "  unsigned char* smem = wa::checked_base(smem_raw);\n"
            "  const int c = heads * HD;\n  const int b = blockIdx.z, h = blockIdx.y;\n"
            "  const int wg = threadIdx.x / 128;",
            "  const long long t_block = wa::stamp();\n"
            "  extern __shared__ __align__(1024) unsigned char smem_raw[];\n"
            "  unsigned char* smem = wa::checked_base(smem_raw);\n"
            "  const int c = heads * HD;\n  const int b = blockIdx.z, h = blockIdx.y;\n"
            "  const int wg = threadIdx.x / 128;")
        text = text.replace(
            "                 scale, wa::kLog2e, bias);\n}\n\ntemplate <int HD>\nint launch_bf16(",
            "                 scale, wa::kLog2e, bias);\n  wa::put(12, wa::stamp() - t_block);\n}\n\n"
            "template <int HD>\nint launch_bf16(")
    else:
        text = src
    (dst / "attention_relpos.cu").write_text(text + READ % (ns, ns))
    proc = build(dst, "split")
    out = proc.communicate()[0]
    if proc.returncode:
        print(out[-4000:])
        return 1
    lib = bind("split")
    qkv, rh, rw, want, _ = window_case()
    got = torch.empty_like(want)
    run = launcher(lib, qkv, rh, rw, got)
    run()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    lib.sam6d_probe_split(None, 1)
    calls = 10
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    if lib.sam6d_probe_split(ctypes.cast(buf, ctypes.c_void_p), 0):
        raise RuntimeError("reading the phase sums failed")
    total, count = list(buf[:32]), list(buf[32:])
    print(f"{smi()}: {csrc}, stamped {fname}; max |diff| {err:.2e} from the plain version; "
          f"cycles a warp (occurrences a window-0 (sample, head) a launch):", flush=True)
    for label, off in (("full row tiles", 0), ("tail row tile", 16)):
        print(f"  {label}: " + "; ".join(
            f"{name} {total[off + i] / count[off + i]:.0f} (x{count[off + i] / calls / 16:.2f})"
            for i, name in enumerate(PHASES) if off + i < 32 and count[off + i]), flush=True)
    return 0 if err <= 8e-3 else 1


def variants(dirs) -> int:
    import torch
    import chip_smoke as cs
    WORK.mkdir(parents=True, exist_ok=True)
    names = [f"v{i}" for i in range(len(dirs))]
    for d, name, proc in [(d, n, build(d, n)) for d, n in zip(dirs, names)]:
        out = proc.communicate()[0]
        if proc.returncode:
            print(f"{d}: build failed\n{out[-4000:]}")
            return 1
        at = out.find("window_kernelILi80E")
        rec = re.search(r"(\d+) bytes spill stores.*?Used (\d+) registers", out[at:at + 600],
                        re.S) if at >= 0 else None
        print(f"{d}: windowed kernel <80>: " + (f"{rec[2]} registers, {rec[1]} bytes spilled"
                                               if rec else "none"), flush=True)
    qkv, rh, rw, want, tables = window_case()
    got = torch.empty_like(want)
    got_tables = torch.empty_like(tables)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {n: [] for n in names}
    for order in (names, names[::-1]):
        for d, n in ((dirs[names.index(n)], n) for n in order):
            lib = bind(n)
            run = launcher(lib, qkv, rh, rw, got)
            run()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            line = (f"runs of 10 {cs.cuda_ms(run, reps=10, launches=10):.4f} ms, card alone "
                    f"{card_alone(run):.4f} ms, max |diff| {err:.2e}")
            if hasattr(lib, "sam6d_flash_attention_relpos_bf16_window_tables"):
                def tab():
                    lib.sam6d_flash_attention_relpos_bf16_window_tables(
                        qkv.data_ptr(), rh.data_ptr(), rw.data_ptr(), got_tables.data_ptr(), 25,
                        196, 16, 80, 14, 14, stream)
                tab()
                torch.cuda.synchronize()
                line += (f", table stage alone {card_alone(tab):.4f} ms "
                         f"({'exact' if torch.equal(got_tables, tables) else 'DIFFERS'})")
            rows[n].append(line)
    for d, n in zip(dirs, names):
        print(f"{smi()}: {d}: " + " | ".join(rows[n]), flush=True)
    return 0


SMEM_SOURCE = r"""
#include <cuda_runtime.h>
// 16-byte loads by every lane of 32 warps an SM, in a loop, by pattern
template <int MODE>
__global__ void __launch_bounds__(1024) smem_kernel(float* out, long long* cyc, int iters) {
  __shared__ __align__(16) float sm[12288];
  for (int i = threadIdx.x; i < 12288; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int base = MODE == 0 ? 0 : MODE == 1 ? (lane / 16) * 84 : MODE == 2 ? (lane / 8) * 84
           : MODE == 3 ? (lane % 4) * 84 : MODE == 4 ? lane * 84 : lane * 4;
  base += (warp % 4) * 2688;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(sm + base + (it & 15) * 4 + u * 168);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  if (acc.x == 12345.f) out[threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}
extern "C" int run(int mode, float* out, long long* cyc, int blocks, int iters) {
  switch (mode) {
    case 0: smem_kernel<0><<<blocks, 1024>>>(out, cyc, iters); break;
    case 1: smem_kernel<1><<<blocks, 1024>>>(out, cyc, iters); break;
    case 2: smem_kernel<2><<<blocks, 1024>>>(out, cyc, iters); break;
    case 3: smem_kernel<3><<<blocks, 1024>>>(out, cyc, iters); break;
    case 4: smem_kernel<4><<<blocks, 1024>>>(out, cyc, iters); break;
    default: smem_kernel<5><<<blocks, 1024>>>(out, cyc, iters); break;
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def smem() -> int:
    import torch
    from sam6d_torch.kernels import _build
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "smem.cu").write_text(SMEM_SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(WORK / "smem.so"),
                    str(WORK / "smem.cu")], check=True)
    lib = ctypes.CDLL(str(WORK / "smem.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [I, P, P, I, I]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1024, device="cuda")
    cyc = torch.zeros(sms, dtype=torch.int64, device="cuda")
    iters = 2000
    labels = ["one address a warp", "two rows, one a half warp", "four rows, one a quarter warp",
              "four rows in every quarter warp", "32 rows 84 words apart", "32 consecutive 16-byte chunks"]
    fields = []
    for mode, label in enumerate(labels):
        lib.run(mode, out.data_ptr(), cyc.data_ptr(), sms, 200)
        if lib.run(mode, out.data_ptr(), cyc.data_ptr(), sms, iters):
            raise RuntimeError("the shared-memory probe failed")
        fields.append(f"{label} {float(cyc.float().median()) / (iters * 8 * 32):.2f}")
    print(f"{smi()}: SM cycles a warp-wide 16-byte shared load (32 warps an SM): "
          + "; ".join(fields), flush=True)
    return 0


def main(argv):
    WORK.mkdir(parents=True, exist_ok=True)
    if argv[:1] == ["--smem"]:
        return smem()
    if argv[:1] == ["--split"] and len(argv) == 2:
        return split(Path(argv[1]).resolve())
    if argv and not argv[0].startswith("--"):
        return variants([Path(a).resolve() for a in argv])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
