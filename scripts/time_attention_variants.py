"""Time the head-major attention kernel (K8, K9) built from a given copy of
`sam6d_torch/csrc/`, beside K5 on the same qkv projection, on one GPU.

Used to compare kernel variants: copy `sam6d_torch/csrc/` to a directory,
edit the copy, and run

    python3 scripts/time_attention_variants.py DIR [DIR ...]

Each directory is built into `DIR/_build/` and timed in its own process (the
library is bound once a process), in the order given; pass the unedited
sources first and last to see the drift of one call, or a parent commit's
`csrc/` beside this one (parent, change, change, parent). One line a
directory: its ptxas registers and spills, K8 at 16x16x1025x64 and K9 at
16x16x257x64 on the (B, H, N, hd) views of a qkv projection (CUDA-event
medians of 20 runs, `chip_smoke.cuda_ms`), K5 on the same qkv at both
lengths, K1 at SAM's global (1x4096) and windowed (25x196) shapes, 16
heads of 80, and each kernel's max |diff| from its plain version.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def time_one(csrc: Path) -> str:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from sam6d_torch.kernels import _build
    _build.CSRC_DIR = csrc
    _build.BUILD_DIR = csrc / "_build"
    import chip_smoke as cs
    from sam6d_torch.kernels import attention as att
    from sam6d_torch.kernels import attention_qkv
    from sam6d_torch.kernels import attention_relpos as relpos

    _, out = _build.build(verbose=True)
    _build.load_library()
    ptxas, entry, spill = {}, None, 0
    for line in out.splitlines():
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        u = re.search(r"Used (\d+) registers", line)
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif s:
            spill = int(s[1]) + int(s[2])
        elif u and entry:
            ptxas[entry] = (int(u[1]), spill)

    def regs(kernel, hd):
        return [rec for name, rec in ptxas.items() if kernel in name and f"ILi{hd}E" in name]

    rng = np.random.RandomState(0)
    fields = [f"head-major<64> {regs('head_major_attention_kernel', 64)}",
              f"<128> {regs('head_major_attention_kernel', 128)}",
              f"K5<64> {regs('attention_qkv_kernel', 64)}",
              f"K1<80> {regs('attention_relpos_kernel', 80)}"]
    for name, fn, plain, n in (
            ("K8", att.fused_attention_cuda, att.fused_attention_plain, 1025),
            ("K9", att.fused_attention_small_cuda, att.fused_attention_small_plain, 257)):
        qkv = torch.from_numpy(rng.randn(16, n, 3 * 1024).astype(np.float32)).cuda()
        q, k, v = qkv.view(16, n, 3, 16, 64).permute(2, 0, 3, 1, 4)
        err = float((fn(q, k, v, 0.125) - plain(q, k, v, 0.125)).abs().max())
        ms = cs.cuda_ms(lambda: fn(q, k, v, 0.125), reps=20)
        k5 = cs.cuda_ms(lambda: attention_qkv.fused_attention_qkv_cuda(qkv, 16, 0.125), reps=20)
        fields.append(f"{name} {ms:.4f} ms (K5 {k5:.4f}), max |diff| {err:.2e}")
    for name, B, (H, W) in (("K1 global", 1, (64, 64)), ("K1 windowed", 25, (14, 14))):
        N = H * W
        qkv = torch.from_numpy(rng.randn(B, N, 3 * 1280).astype(np.float32)).cuda()
        rh, rw = (torch.from_numpy(rng.randn(2 * n - 1, 80).astype(np.float32) * 0.1).cuda()
                  for n in (H, W))
        args = (qkv, rh, rw, (H, W), 16)
        err = float((relpos.flash_attention_relpos_cuda(*args)
                     - relpos.flash_attention_relpos_plain(*args)).abs().max())
        ms = cs.cuda_ms(lambda: relpos.flash_attention_relpos_cuda(*args), reps=20)
        fields.append(f"{name} {ms:.4f} ms, max |diff| {err:.2e}")
    return f"{csrc.name}: " + "; ".join(fields)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        print(time_one(Path(argv[1]).resolve()), flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rc = 0
    for d in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", d]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
