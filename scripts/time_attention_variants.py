"""Time the head-major attention kernel (K8, K9) built from a given copy of
`sam6d_torch/csrc/`, beside K5 on the same qkv projection, K1, and the
factored LayerNorm statistics (K2) beside K3 and K4, on one GPU.

Used to compare kernel variants: copy `sam6d_torch/csrc/` to a directory,
edit the copy, and run

    python3 scripts/time_attention_variants.py [--sam] [--factored] [--bf16] DIR [DIR ...]
    python3 scripts/time_attention_variants.py --points ROOT [ROOT ...]

Each directory is built into `DIR/_build/` and timed in its own process (the
library is bound once a process), in the order given; pass the unedited
sources first and last to see the drift of one call, or a parent commit's
`csrc/` beside this one (parent, change, change, parent). One line a
directory: its ptxas registers and spills, K8 at 16x16x1025x64 and K9 at
16x16x257x64 on the (B, H, N, hd) views of a qkv projection (CUDA-event
medians of 20 runs, `chip_smoke.cuda_ms`), K5 on the same qkv at both
lengths, K1 at SAM's global (1x4096) and windowed (25x196) shapes, 16
heads of 80 (one launch, runs of 10 and on the card alone, each beside
SDPA in full fp32 with the bias as its mask; a `csrc/` from before K1's
fp32 workspace is called through its own C signature, `legacy_k1`), K2
at the iou pass's B=128, N=4096 and ranks 57 (layer 1) and 116 (layer 2;
in bf16 also with a second scaled block), K3 at ranks 59
and 118, K4 at ranks 0 (layer 1) and 59
(layer 2; also over runs of 10 launches, which hide the host's dispatch),
and each kernel's max |diff| from its plain version (K2: mu's,
and 1/sigma's relative), K3 beside its plain version's time (5 runs);
`--factored` keeps only K2-K4. With
`--bf16`, the bf16 entries of K8 (16x16x1025x64 on qkv views), K9
(16x16x257x64), K5 (16x257x3072) and K1 (global and windowed) are also
timed, one launch and runs of 10, beside SDPA in bf16 on the same
operands (K1's bias as a bf16 mask), each held to its plain bf16 version,
with the ptxas registers of their kernels (K1 global and windowed also on
the card alone: their kernels' device time under torch.profiler over 10
calls, beside SDPA's kernels, so that the host's dispatch cannot set the
number), and K2-K4 are their bf16 entries
on the same states rounded to bf16 (each held to its plain bf16 version;
one launch and runs of 10; each call's kernels by name on the card under
torch.profiler, which parts the card's time from the host's dispatch), and
`--sam` builds the segmentor in bf16. With `--points`, each argument is instead
the root of a checkout (a directory holding `sam6d_torch/`, e.g. a parent
commit unpacked with `git archive`, or a copy of the package with edited
`csrc/`), built and imported from there, and the line times its FPS (K7)
at 16x2048->196, 1x2048->196 and 1x210000->2048 and its two-scale ball
query (K6) at 16x2048x2048 and 1x2048x2048 on `chip_smoke.py`'s clouds
(CUDA-event medians of 20 one-launch runs, 5 at 210 000 points, and
below 2048 picks also over runs of 10 launches, which hide the host's
dispatch), each checked
against its plain version, with the ptxas registers, spills and shared
memory of those kernels, the FPS path each shape takes, and the latency of
one FPS step's synchronisation alone (`fps.step_sync_us`: a redux pair +
one block barrier; plus a cluster barrier and a 16-slot DSMEM read) where
the checkout has it. With `--sam`, also
the ViT-H SAM's iou pass and `generate_masks_device` on a random 480x640
frame (random weights, the load pinned as `chip_smoke.py` pins it;
CUDA-event medians of 3 runs), and the iou pass's and the whole frame's
kernel split on the card (one run under torch.profiler: the largest
kernels, and K1's, K2's, K3's position chunks and their merge, and K4's by
name).
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def time_one(csrc: Path, sam: bool, factored_only: bool, bf16: bool = False) -> str:
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

    so, out = _build.build(verbose=True)
    # an older csrc/ (a parent commit's) may lack entries added since
    lib = ctypes.CDLL(str(so))
    _build._SIGNATURES = {n: a for n, a in _build._SIGNATURES.items() if hasattr(lib, n)}
    if not hasattr(lib, "sam6d_flash_attention_relpos_workspace_bytes"):
        legacy_k1(_build, relpos)   # K1's fp32 entry before its split K/V workspace
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
              f"K1<80> {regs('attention_relpos_kernel', 80)}"
              f"{regs('tf3216attention_kernel', 80)} split {regs('tf3215split_kv_kernel', 80)}",
              f"K2 {[rec for name, rec in ptxas.items() if 'ln_stats' in name]}",
              f"K4 {[rec for name, rec in ptxas.items() if 'i2t' in name]}",
              "K3 " + ", ".join(f"{re.search(r't2i_\w*?kernel', name)[0]} {rec}"
                                for name, rec in ptxas.items() if "t2i" in name)]
    for name, fn, plain, n in () if factored_only else (
            ("K8", att.fused_attention_cuda, att.fused_attention_plain, 1025),
            ("K9", att.fused_attention_small_cuda, att.fused_attention_small_plain, 257)):
        qkv = torch.from_numpy(rng.randn(16, n, 3 * 1024).astype(np.float32)).cuda()
        q, k, v = qkv.view(16, n, 3, 16, 64).permute(2, 0, 3, 1, 4)
        err = float((fn(q, k, v, 0.125) - plain(q, k, v, 0.125)).abs().max())
        ms = cs.cuda_ms(lambda: fn(q, k, v, 0.125), reps=20)
        k5 = cs.cuda_ms(lambda: attention_qkv.fused_attention_qkv_cuda(qkv, 16, 0.125), reps=20)
        fields.append(f"{name} {ms:.4f} ms (K5 {k5:.4f}), max |diff| {err:.2e}")
    if not factored_only:
        fields += k1_fp32_fields(rng, cs)
    if bf16 and not factored_only:
        fields += attention_bf16_fields(rng, cs, ptxas)
    fields += (factored_bf16_fields if bf16 else factored_fields)(rng, cs)
    if sam:
        fields += sam_fields(cs, bf16)
    label = csrc.relative_to(ROOT) if csrc.is_relative_to(ROOT) else csrc
    return f"{label}: " + "; ".join(fields)


def legacy_k1(build, relpos):
    """Bind K1's fp32 C entry as a csrc/ from before its workspace declares
    it (qkv, rel_pos_h, rel_pos_w, out, b, n, heads, hd, gh, gw, scale,
    stream), and call it so: the wrapper of that commit."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    build._SIGNATURES["sam6d_flash_attention_relpos"] = [P, P, P, P, I, I, I, I, I, I, F, P]

    def flash_attention_relpos_cuda(qkv, rel_pos_h, rel_pos_w, hw, heads):
        import torch
        B, N, hd, rel_pos_h, rel_pos_w = relpos._fp32_operands(qkv, rel_pos_h, rel_pos_w, hw,
                                                               heads)
        out = torch.empty((B, N, heads * hd), dtype=torch.float32, device=qkv.device)
        err = build.load_library().sam6d_flash_attention_relpos(
            qkv.data_ptr(), rel_pos_h.data_ptr(), rel_pos_w.data_ptr(), out.data_ptr(), B, N,
            heads, hd, hw[0], hw[1], float(hd ** -0.5),
            torch.cuda.current_stream(qkv.device).cuda_stream)
        flash_attention_relpos_cuda.launches += 1
        build.check(err, "flash_attention_relpos_cuda")
        return out

    flash_attention_relpos_cuda.launches = 0
    relpos.flash_attention_relpos_cuda = flash_attention_relpos_cuda


def k1_fp32_fields(rng, cs):
    """K1's fp32 entry at SAM's global (1x4096) and windowed (25x196)
    shapes, 16 heads of 80: one launch (median of 20), runs of 10 launches,
    and on the card alone (its kernels' device time under torch.profiler
    over 10 calls), beside SDPA in full fp32 (TF32 off) with the bias as its
    mask in the same three ways, and its max |diff| from the plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sam6d_torch import use_strict_fp32
    from sam6d_torch.kernels import attention_relpos as relpos
    use_strict_fp32()
    fields = []
    for name, B, (H, W) in (("K1 global", 1, (64, 64)), ("K1 windowed", 25, (14, 14))):
        N = H * W
        qkv = torch.from_numpy(rng.randn(B, N, 3 * 1280).astype(np.float32)).cuda()
        rh, rw = (torch.from_numpy(rng.randn(2 * n - 1, 80).astype(np.float32) * 0.1).cuda()
                  for n in (H, W))
        args = (qkv, rh, rw, (H, W), 16)
        err = float((relpos.flash_attention_relpos_cuda(*args)
                     - relpos.flash_attention_relpos_plain(*args)).abs().max())
        q, k, v = qkv.view(B, N, 3, 16, 80).permute(2, 0, 3, 1, 4)
        rel_h, rel_w = relpos.rel_pos_tables(*args)
        mask = (rel_h.view(B, 16, N, H, 1) + rel_w.view(B, 16, N, 1, W)).reshape(B, 16, N, N)
        del rel_h, rel_w

        def fn():
            return relpos.flash_attention_relpos_cuda(*args)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=80 ** -0.5)

        ms, sd = cs.cuda_ms(fn, reps=20), cs.cuda_ms(sdpa, reps=20)
        runs = cs.cuda_ms(fn, reps=10, launches=10)
        sd_runs = cs.cuda_ms(sdpa, reps=10, launches=10)
        fields.append(f"{name} {ms:.4f} ms (SDPA fp32 {sd:.4f}; runs of 10 {runs:.4f}, SDPA "
                      f"{sd_runs:.4f}; on the card alone {device_split(fn, calls=10)}, SDPA "
                      f"{device_split(sdpa, calls=10)}), max |diff| {err:.2e}")
        del mask
    return fields


def time_points(root: Path) -> str:
    """K7 and K6 from the checkout at `root` (see the module docstring)."""
    import importlib.util
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from sam6d_torch.kernels import _build
    from sam6d_torch.kernels import ball_query as bq
    from sam6d_torch.kernels import fps
    from sam6d_torch.ops.geometry import pairwise_sq_distance
    if not Path(fps.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fps.__file__}, not the checkout at {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    _, out = _build.build(verbose=True)
    _build.load_library()
    fields, entry, spill = [], None, 0
    for line in out.splitlines():
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        u = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif s:
            spill = int(s[1]) + int(s[2])
        elif u and entry and ("fps_" in entry or "ball_query" in entry):
            name = re.search(r"\d+((?:fps|ball_query)\w*?_kernel)(?:IL[ib](\d+)E)?", entry)
            fields.append(f"{name[1] if name else entry}<{name[2] or '' if name else ''}> "
                          f"{u[1]} regs {spill} spilled "
                          f"{u[2]} B smem")

    rng = np.random.RandomState(0)
    frame = rng.randn(16, 2048, 3).astype(np.float32) * 0.3
    frame[:, 1000:1100] = frame[:, :100]
    base = rng.randn(60000, 3).astype(np.float32) * 0.05
    onb = base[rng.randint(0, len(base), 210000)][None]
    for name, pts, m, reps in (("16x2048->196", frame, 196, 20),
                               ("1x2048->196", frame[:1], 196, 20),
                               ("1x210000->2048", onb, 2048, 5)):
        p = torch.from_numpy(np.ascontiguousarray(pts)).cuda()
        exact = torch.equal(fps.farthest_point_sample_cuda(p, m),
                            fps.farthest_point_sample_plain(p, m))
        ms = cs.cuda_ms(lambda: fps.farthest_point_sample_cuda(p, m), reps=reps)
        runs = (cs.cuda_ms(lambda: fps.farthest_point_sample_cuda(p, m), reps=5, launches=10)
                if m < 2048 else ms)
        path = fps.fps_path(p.shape[1]) if hasattr(fps, "fps_path") else "-"
        fields.append(f"K7 {name} {ms:.4f} ms ({runs:.4f} over runs of 10; {path}, "
                      f"{'exact' if exact else 'DIFFERS'})")
    pts = torch.from_numpy(rng.randn(16, 2048, 3).astype(np.float32) * 0.3).cuda()
    args = (0.1, 32, 0.2, 64)
    d2 = pairwise_sq_distance(pts, pts)
    for name, x in (("16x2048x2048", pts), ("1x2048x2048", pts[:1].contiguous())):
        bad = 0
        for g, w, r in zip(bq.two_scale_ball_query_cuda(x, x, *args),
                           bq.two_scale_ball_query_plain(x, x, *args), (args[0], args[2])):
            near = ((d2[:len(x)] - float(np.float32(r * r))).abs() < cs.NEAR_R2).any(-1)
            bad += int(((g != w).any(-1) & ~near).sum())
        ms = cs.cuda_ms(lambda: bq.two_scale_ball_query_cuda(x, x, *args), reps=20)
        runs = cs.cuda_ms(lambda: bq.two_scale_ball_query_cuda(x, x, *args), reps=5,
                          launches=10)
        fields.append(f"K6 {name} {ms:.4f} ms ({runs:.4f} over runs of 10; "
                      f"{bad} rows differ unexplained)")
    if hasattr(fps, "step_sync_us"):
        fields.append(f"step sync block {fps.step_sync_us('block', 2048):.4f} us, "
                      f"cluster {fps.step_sync_us('cluster', 210000):.4f} us")
    return f"{root.name}: " + "; ".join(fields)


def attention_bf16_fields(rng, cs, ptxas):
    """The bf16 entries of K8 (16x16x1025x64 on the views of a qkv
    projection: the describe at 448), K9 (16x16x257x64), K5 (16x257x3072,
    the describe chunk) and K1 (a global 1x4096 and a windowed 25x196 ViT-H
    block, 16 heads of 80), each
    held to its plain bf16 version and timed (one launch, and runs of 10
    launches) beside SDPA in bf16 on the same operands (K1's bias as a bf16
    mask), with the registers and spill bytes ptxas gave the kernels of
    those entries."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sam6d_torch.kernels import attention_qkv
    from sam6d_torch.kernels import attention_relpos as relpos

    def bf(shape, scale=1.0):
        return (torch.from_numpy(rng.randn(*shape).astype(np.float32) * np.float32(scale))
                .cuda().to(torch.bfloat16))

    def timed(name, fn, plain, lib, alone=False):
        err = float((fn().float() - plain().float()).abs().max())
        one = cs.cuda_ms(fn, reps=20)
        runs = cs.cuda_ms(fn, reps=10, launches=10)
        lib_runs = cs.cuda_ms(lib, reps=10, launches=10)
        card = (f"; on the card alone {device_split(fn, calls=10)}, SDPA "
                f"{device_split(lib, calls=10)}" if alone else "")
        return (f"{name} bf16 {one:.4f} ms ({runs:.4f} over runs of 10; SDPA bf16 "
                f"{lib_runs:.4f}{card}), max |diff| {err:.2e}")

    kernels = [(m[1] + f"<{m[2]}>", rec) for name, rec in ptxas.items()
               if (m := re.search(r"((?:attention_(?:qkv|relpos)|head_major_attention)"
                                  r"_(?:bf16|wgmma|window)_kernel)ILi(\d+)E(?:Lb(\d)E)?", name))]
    fields = ["bf16 K1/K5/K8/K9 kernels (registers, spill bytes) "
              + ", ".join(f"{k} {rec}" for k, rec in kernels)]
    from sam6d_torch.kernels import attention as att
    for name, n, fn, plain in (
            ("K8 16x16x1025x64 qkv views", 1025, att.fused_attention_bf16_cuda,
             att.fused_attention_bf16_plain),
            ("K9 16x16x257x64", 257, att.fused_attention_small_bf16_cuda,
             att.fused_attention_small_bf16_plain)):
        qkv = bf((16, n, 3 * 1024))
        with torch.no_grad():
            qkv[..., :2048] *= 0.5
        q, k, v = qkv.view(16, n, 3, 16, 64).permute(2, 0, 3, 1, 4)
        if n == 257:   # K9 on contiguous operands, as chip_smoke.py times it
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fields.append(timed(name, lambda: fn(q, k, v, 0.125), lambda: plain(q, k, v, 0.125),
                            lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125)))
    qkv = bf((16, 257, 3 * 1024))
    with torch.no_grad():
        qkv[..., :2048] *= 0.5
    q, k, v = qkv.view(16, 257, 3, 16, 64).permute(2, 0, 3, 1, 4)
    fields.append(timed("K5 16x257x3072",
                        lambda: attention_qkv.fused_attention_qkv_bf16_cuda(qkv, 16, 0.125),
                        lambda: attention_qkv.fused_attention_qkv_bf16_plain(qkv, 16, 0.125),
                        lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125)))
    for name, B, (H, W) in (("K1 global 1x4096", 1, (64, 64)),
                            ("K1 windowed 25x196", 25, (14, 14))):
        N = H * W
        qkv = bf((B, N, 3 * 1280))
        with torch.no_grad():
            qkv[..., :2560] *= 0.5
        rh, rw = (bf((2 * n - 1, 80), 0.1) for n in (H, W))
        args = (qkv, rh, rw, (H, W), 16)
        q, k, v = qkv.view(B, N, 3, 16, 80).permute(2, 0, 3, 1, 4)
        rel_h, rel_w = relpos.bf16_rel_pos_tables(qkv, rh, rw, (H, W), 16)
        mask = (rel_h.view(B, 16, N, H, 1) + rel_w.view(B, 16, N, 1, W)
                ).reshape(B, 16, N, N).to(torch.bfloat16)
        del rel_h, rel_w
        fields.append(timed(name, lambda: relpos.flash_attention_relpos_bf16_cuda(*args),
                            lambda: relpos.flash_attention_relpos_bf16_plain(*args),
                            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                   scale=80 ** -0.5),
                            alone=True))
        del mask
    return fields


def sam_fields(cs, bf16=False):
    import numpy as np
    import torch
    from sam6d_torch import use_strict_fp32
    from sam6d_torch.core.config import SAMConfig
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    use_strict_fp32()
    seg = SAMSegmentor(SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                                 max_proposals=128), seed=0, device="cuda",
                       dtype=torch.bfloat16 if bf16 else torch.float32)
    rgb = (np.random.RandomState(1).rand(480, 640, 3) * 255).astype(np.uint8)
    resized, _, (hs, ws), (h_in, w_in) = seg.preprocess_frame_u8(rgb)
    _, _, pts = seg.frame_constants(hs, ws, h_in, w_in)
    with torch.inference_mode():
        emb = seg._encode_u8(torch.as_tensor(resized, device=seg.device))
        pe = seg.sam.prompt_encoder.dense_pe()
        iou = cs.cuda_ms(lambda: seg._iou_all_impl(emb, pe, pts), reps=3)
        split = device_split(lambda: seg._iou_all_impl(emb, pe, pts))
    dev = cs.cuda_ms(lambda: seg.generate_masks_device(rgb), reps=3)
    frame = device_split(lambda: seg.generate_masks_device(rgb))
    return [f"iou pass {iou:.2f} ms", f"iou pass on the card {split}",
            f"generate_masks_device {dev:.2f} ms", f"frame on the card {frame}"]


def device_split(fn, top=8, calls=1):
    """`calls` runs of fn() under torch.profiler: the card's summed kernel
    time a run and the kernels that took most of it, and K1's, K2's, K3's
    two and K4's kernels wherever they rank (name, launches, ms a run)."""
    keep = ("attention_relpos", "tf32::", "ln_stats", "t2i", "i2t")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops.sort(key=dev_us, reverse=True)
    shown = [(e.key.replace("(anonymous namespace)::", "").split("(")[0][:40], e)
             for i, e in enumerate(ops) if i < top or any(k in e.key for k in keep)]
    k1 = [e for e in ops if "attention_relpos" in e.key or "tf32::" in e.key]
    k1_total = (f" (K1's kernels x{sum(e.count for e in k1)} "
                f"{sum(map(dev_us, k1)) / 1e3 / calls:.4f} ms)" if k1 else "")
    return f"{sum(map(dev_us, ops)) / 1e3 / calls:.4f} ms{k1_total}: " + ", ".join(
        f"{n} x{e.count} {dev_us(e) / 1e3 / calls:.4f}" for n, e in shown)


def factored_state(rng, ranks, scaled, with_a, B=128, N=4096, C=256, d=128):
    """The iou pass's factor state at its main-path size: blocks of raw rows
    in [0, 1) with positive per-position scales, S, U, UK/UV, a and the
    token/position operands of K3 and K4, made on the card."""
    import torch

    def t(*shape, lo=0.0, scale=1.0, normal=True):
        x = torch.randn(*shape, device="cuda") if normal else torch.rand(*shape, device="cuda")
        return x * scale + lo

    torch.manual_seed(int(rng.randint(1 << 30)))
    blocks = tuple((t(B, r, N, normal=False), t(B, N, lo=0.5, normal=False) if s else None)
                   for r, s in zip(ranks, scaled))
    R = sum(ranks)
    return dict(blocks=blocks, S=t(N, C), U=t(B, R, C, scale=0.3), UK=t(B, R, d, scale=0.3),
                UV=t(B, R, d, scale=0.3),
                a=t(B, N, lo=0.5, normal=False) if with_a else None,
                q=t(B, 7, d, scale=0.25), KS=t(N, d, scale=0.25), KC=t(N, d, scale=0.25),
                VS=t(N, d))


def factored_fields(rng, cs):
    from sam6d_torch.kernels import factored as fk
    fields = []
    for ranks, scaled, with_a in (((57,), (False,), False), ((57, 2, 57), (True, True, False), True)):
        st = factored_state(rng, ranks, scaled, with_a)
        args = (st["blocks"], st["U"], st["S"], st["a"])
        mu, inv = fk.factored_ln_stats_cuda(*args)
        mu_p, inv_p = fk.factored_ln_stats_plain(*args)
        err = float((mu - mu_p).abs().max())
        rel = float(((inv - inv_p).abs() / inv_p.abs()).max())
        del mu, inv, mu_p, inv_p
        ms = cs.cuda_ms(lambda: fk.factored_ln_stats_cuda(*args), reps=20)
        fields.append(f"K2 rank {sum(ranks)} {ms:.4f} ms, mu |diff| {err:.2e}, "
                      f"1/sigma rel {rel:.2e}")
        del st, args
    for ranks, scaled in (((57, 2), (True, False)), ((57, 2, 57, 2), (True, True, True, False))):
        st = factored_state(rng, ranks, scaled, True)
        args = (st["q"], st["UK"], st["UV"], st["blocks"], st["a"], st["KS"], st["KC"],
                st["VS"], 8)
        err = float((fk.factored_t2i_attention_cuda(*args)
                     - fk.factored_t2i_attention_plain(*args)).abs().max())
        ms = cs.cuda_ms(lambda: fk.factored_t2i_attention_cuda(*args), reps=20)
        plain = cs.cuda_ms(lambda: fk.factored_t2i_attention_plain(*args), reps=5)
        fields.append(f"K3 rank {sum(ranks)} {ms:.4f} ms (plain {plain:.4f}), "
                      f"max |diff| {err:.2e}")
        if len(ranks) == 2:  # K4's two launches: layer 1 (rank 0, no a), layer 2
            for name, args in (
                    ("K4 rank 0", (st["q"], None, (), None, st["KS"], st["KC"], 8)),
                    ("K4 rank 59", (st["q"], st["UK"], st["blocks"], st["a"], st["KS"],
                                    st["KC"], 8))):
                err = float((fk.factored_i2t_scores_cuda(*args)
                             - fk.factored_i2t_scores_plain(*args)).abs().max())
                ms = cs.cuda_ms(lambda: fk.factored_i2t_scores_cuda(*args), reps=20)
                runs = cs.cuda_ms(lambda: fk.factored_i2t_scores_cuda(*args), reps=10,
                                  launches=10)
                fields.append(f"{name} {ms:.4f} ms ({runs:.4f} over runs of 10), "
                              f"max |diff| {err:.2e}")
        del st, args
    return fields


def factored_bf16_fields(rng, cs):
    """The bf16 entries of K2-K4 at the iou pass's shapes, on factored_state
    rounded to bf16."""
    import torch
    from sam6d_torch.kernels import factored as fk

    def bf(st):
        out = {k: None if v is None else v.to(torch.bfloat16)
               for k, v in st.items() if k != "blocks"}
        out["blocks"] = tuple((p.to(torch.bfloat16), None if s is None else s.to(torch.bfloat16))
                              for p, s in st["blocks"])
        return out

    def timed(name, fn, err):
        ms = cs.cuda_ms(fn, reps=20)
        runs = cs.cuda_ms(fn, reps=10, launches=10)
        return (f"{name} {ms:.4f} ms ({runs:.4f} over runs of 10; on the card "
                f"{device_split(fn, top=4)}), {err}")

    fields = []
    # layer 2's blocks as the iou pass carries them (the first scaled by
    # layer 1's 1/sigma), then with a second scaled block
    for ranks, scaled, with_a, note in (((57,), (False,), False, ""),
                                        ((57, 2, 57), (True, False, False), True, ""),
                                        ((57, 2, 57), (True, True, False), True, " 2 scaled")):
        st = bf(factored_state(rng, ranks, scaled, with_a))
        args = (st["blocks"], st["U"], st["S"], st["a"])
        mu, inv = fk.factored_ln_stats_bf16_cuda(*args)
        mu_p, inv_p = fk.factored_ln_stats_bf16_plain(*args)
        err = (f"mu |diff| {float((mu - mu_p).abs().max()):.2e}, 1/sigma rel "
               f"{float(((inv - inv_p).abs() / inv_p.abs()).max()):.2e}")
        del mu, inv, mu_p, inv_p
        fields.append(timed(f"K2 bf16 rank {sum(ranks)}{note}",
                            lambda: fk.factored_ln_stats_bf16_cuda(*args), err))
        del st, args
    for ranks, scaled in (((57, 2), (True, False)), ((57, 2, 57, 2), (True, True, True, False))):
        st = bf(factored_state(rng, ranks, scaled, True))
        args = (st["q"], st["UK"], st["UV"], st["blocks"], st["a"], st["KS"], st["KC"],
                st["VS"], 8)
        d = (fk.factored_t2i_attention_bf16_cuda(*args).float()
             - fk.factored_t2i_attention_bf16_plain(*args).float()).abs()
        fields.append(timed(f"K3 bf16 rank {sum(ranks)}",
                            lambda: fk.factored_t2i_attention_bf16_cuda(*args),
                            f"max |diff| {float(d.max()):.2e}"))
        if len(ranks) == 2:
            for name, a4 in (
                    ("K4 bf16 rank 0", (st["q"], None, (), None, st["KS"], st["KC"], 8)),
                    ("K4 bf16 rank 59", (st["q"], st["UK"], st["blocks"], st["a"], st["KS"],
                                         st["KC"], 8))):
                d = (fk.factored_i2t_scores_bf16_cuda(*a4).float()
                     - fk.factored_i2t_scores_bf16_plain(*a4).float()).abs()
                fields.append(timed(name, lambda a4=a4: fk.factored_i2t_scores_bf16_cuda(*a4),
                                    f"max |diff| {float(d.max()):.2e}"))
        del st, args
    return fields


def main(argv):
    if argv[:1] == ["--one"]:
        if "--points" in argv[2:]:
            print(time_points(Path(argv[1]).resolve()), flush=True)
        else:
            print(time_one(Path(argv[1]).resolve(), "--sam" in argv[2:],
                           "--factored" in argv[2:], "--bf16" in argv[2:]), flush=True)
        return 0
    flags = [a for a in argv if a in ("--sam", "--factored", "--points", "--bf16")]
    argv = [a for a in argv if a not in flags]
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rc = 0
    for d in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", d]
                             + flags).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
