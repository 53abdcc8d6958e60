"""Ablations of K1's fp32 entry (`sam6d_flash_attention_relpos`: the K/V
pre-pass `split_kv_kernel` and `attention_kernel`, namespace tf32 of
`attention_relpos.cu`) on one GPU, at SAM's global (1 x 64x64) and windowed
(25 x 14x14) shapes, 16 heads of 80, rel-pos std 0.1:

    python3 scripts/k1_fp32_probe.py [CSRC]

copies CSRC (default `sam6d_torch/csrc`) once a variant, each with one part
of the attention kernel's work taken out or one choice forced, so that the
shipped source carries no probe:

    base       unchanged
    nobias     the rel-pos bias add of each score tile skipped
    nosoftmax  the bias add, the mask, the running max and the exponentials
               skipped (p = s, no rescale)
    s1pass     Q K^T (and the table products q R^T) in one TF32 pass, not three
    pv1pass    P V in one TF32 pass, not three
    bk32       32-key tiles (base: 40)
    notables   the table products q R^T skipped (tables of zeros); the ring
               tile is still awaited, and the warpgroup meets at a named
               barrier before its slot is released, which the products'
               wgmma did for it (without that barrier one warp can free a slot
               its warpgroup's other warps have not yet seen land, and the
               ring's parities alias)

builds each copy's attention_relpos.cu alone (one nvcc each, in parallel,
under `sam6d_torch/_build/probe/`, git-ignored), and times each variant in
turns, forward then reversed: runs of 10 launches (CUDA events) and the card
alone (torch.profiler, 10 calls; the attention kernel and the pre-pass
apart), with its max |diff| from the plain version (base and bk32 are
meant to agree). What a variant saves is what that part costs on the card.
Every summary line starts with the card's name and power limit.

The variants are text edits of this tree's attention_relpos.cu: the script
stops, naming the variant, where an edit site no longer occurs exactly once.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WORK = ROOT / "sam6d_torch" / "_build" / "probe"
BUILD_S = 420   # seconds the builds may take together

QK_THREE_PASSES = """    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qs[kk], tw::part_desc(bt + kk * BK * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qa[kk], tw::part_desc(bt + PLANE + kk * BK * 32), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qa[kk], tw::part_desc(bt + kk * BK * 32), 1);"""
PV_THREE_PASSES = """    for (int j = 0; j < NK; ++j) tw::wgmma_tf32_rs(ot, ps[j], tw::part_desc(vt + j * HD * 32), j > 0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
      tw::wgmma_tf32_rs(ot, pb[j], tw::part_desc(vt + PLANE + j * HD * 32), 1);
#pragma unroll
    for (int j = 0; j < NK; ++j) tw::wgmma_tf32_rs(ot, pb[j], tw::part_desc(vt + j * HD * 32), 1);"""

KEY_TILE = "constexpr int BK = 40;"

# name -> [(old, new), ...] on attention_relpos.cu; each old text occurs once
VARIANTS = {
    "base": [],
    "nobias": [   # the bias add under a condition that never holds
        ("    if (gw % 2 == 0) {  // keys 2i, 2i + 1 share a grid row",
         "    if (n < 0) {\n    if (gw % 2 == 0) {  // keys 2i, 2i + 1 share a grid row"),
        ("    if (k0 + BK > n) {  // keys past n", "    }\n    if (k0 + BK > n) {  // keys past n"),
    ],
    "nosoftmax": [
        ("    if (!warp_live) {  // no row of this warp is below n: p = 0",
         "    a_lo = a_hi = 1.f;\n    if (kt >= 0) return;\n"
         "    if (!warp_live) {  // no row of this warp is below n: p = 0"),
    ],
    "s1pass": [
        (QK_THREE_PASSES, """    for (int kk = 0; kk < KS; ++kk)
      tw::wgmma_tf32_rs(s, qa[kk], tw::part_desc(bt + kk * BK * 32), kk > 0);"""),
    ],
    "pv1pass": [
        (PV_THREE_PASSES,
         "    for (int j = 0; j < NK; ++j) tw::wgmma_tf32_rs(ot, pb[j], tw::part_desc(vt + j * HD * 32), j > 0);"),
    ],
    "bk32": [(KEY_TILE, "constexpr int BK = 32;")],
    "notables": [
        ("""    issue_qk(s, ring_tile(i));
    wa::wgmma_wait0();
    wa::fence_regs(s);
    release(i);""", """    ring_tile(i);
    wa::wg_sync(bar);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    release(i);"""),
    ],
}
SHAPES = (("global", 1, (64, 64)), ("windowed", 25, (14, 14)))


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def make_copy(csrc: Path, name: str) -> Path:
    dst = WORK / f"fp32_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst, ignore=shutil.ignore_patterns("_build"))
    path = dst / "attention_relpos.cu"
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit site {old[:60]!r} is not unique in {csrc}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def build(src: Path, name: str):
    """nvcc of src/attention_relpos.cu alone into WORK/fp32_name.so (a Popen)."""
    from sam6d_torch.kernels import _build
    return subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                             "-o", str(WORK / f"fp32_{name}.so"),
                             str(src / "attention_relpos.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(name: str):
    from sam6d_torch.kernels import _build
    lib = ctypes.CDLL(str(WORK / f"fp32_{name}.so"))
    for entry in ("sam6d_flash_attention_relpos", "sam6d_flash_attention_relpos_workspace_bytes"):
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
    lib.sam6d_flash_attention_relpos_workspace_bytes.restype = ctypes.c_longlong
    return lib


def cases():
    """Each shape's operands on the card, a workspace, an output and the plain output."""
    import numpy as np
    import torch
    from sam6d_torch.kernels import attention_relpos as rp
    rng = np.random.RandomState(0)
    out = []
    for label, B, (H, W) in SHAPES:
        qkv = torch.from_numpy(rng.randn(B, H * W, 3 * 1280).astype(np.float32)).cuda()
        rh, rw = (torch.from_numpy(rng.randn(2 * g - 1, 80).astype(np.float32) * 0.1).cuda()
                  for g in (H, W))
        want = rp.flash_attention_relpos_plain(qkv, rh, rw, (H, W), 16)
        out.append((label, B, (H, W), qkv, rh, rw, want))
    return out


def launcher(lib, B, hw, qkv, rh, rw, got):
    import torch
    H, W = hw
    ws = torch.empty(lib.sam6d_flash_attention_relpos_workspace_bytes(B, H * W, 16, 80, H, W),
                     dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.sam6d_flash_attention_relpos(qkv.data_ptr(), rh.data_ptr(), rw.data_ptr(),
                                               ws.data_ptr(), got.data_ptr(), B, H * W, 16, 80,
                                               H, W, float(80 ** -0.5), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
    return run


def card_alone(fn, calls=10):
    """(ms of device time a call of fn() queues, {kernel: ms}) under torch.profiler."""
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
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and us(e) > 0]
    parts = {re.sub(r"^.*tf32::(\w+).*$", r"\1", e.key): us(e) / 1e3 / calls for e in ops}
    return sum(parts.values()), parts


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    if argv[:1] in (["-h"], ["--help"]):
        print(__doc__)
        return 0
    csrc = Path(argv[0]).resolve() if argv else ROOT / "sam6d_torch" / "csrc"
    WORK.mkdir(parents=True, exist_ok=True)
    names = list(VARIANTS)
    t0 = time.time()
    procs = [(n, build(make_copy(csrc, n), n)) for n in names]
    for n, proc in procs:
        try:
            out = proc.communicate(timeout=max(1.0, BUILD_S - (time.time() - t0)))[0]
        except subprocess.TimeoutExpired:
            for _, other in procs:
                other.kill()
            print(f"{n}: not built in {BUILD_S} s", flush=True)
            return 1
        if proc.returncode:
            print(f"{n}: build failed\n{out[-4000:]}")
            return 1
        regs = re.search(r"attention_kernelILi80E.*?Used (\d+) registers", out, re.S)
        print(f"{n}: built at {time.time() - t0:.0f} s; attention_kernel<80> registers "
              f"{regs[1] if regs else '?'}", flush=True)
    shapes = cases()
    rows = {(n, s[0]): [] for n in names for s in shapes}
    for order in (names, names[::-1]):
        for n in order:
            lib = bind(n)
            for label, B, hw, qkv, rh, rw, want in shapes:
                got = torch.empty_like(want)
                run = launcher(lib, B, hw, qkv, rh, rw, got)
                run()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                alone, parts = card_alone(run)
                rows[(n, label)].append(
                    f"runs of 10 {cs.cuda_ms(run, reps=10, launches=10):.4f} ms, card alone "
                    f"{alone:.4f} (" + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                    + f"), max |diff| {err:.2e}")
                print(f"  {n} {label}: {rows[(n, label)][-1]}", flush=True)
    for n in names:
        for label, *_ in shapes:
            print(f"{smi()}: {n} {label}: " + " | ".join(rows[(n, label)]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
