"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device: CUDA with capability (9, 0); prints the card's name and power
     limit (nvidia-smi) and the torch / CUDA / nvcc versions;
  2. build: compiles the hand-written kernels in sam6d_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (indices exactly equal; ball-query rows may differ only
     where a pair lies within 1e-6 of r^2), timed with CUDA events beside
     its bound and, where one exists, one PyTorch call computing the same
     function: FPS (the frame's clouds on its block path, the onboarding
     cloud on its 16-block cluster path, each beside its bound and its
     latency floor from the measured step synchronisation), ball query
     (its lanes path per frame, its warps path at onboarding), with their
     ptxas registers and shared memory, the fused attentions (K5; K8 and K9 on
     head-major operands, K9 with no caller on any path), the SAM rel-pos
     attention (K1, a global and a windowed ViT-H block; the kernel forms
     its rel-pos tables itself, and the plain version's two table einsums
     are timed alone), K1 and K5 also at large scores, beside both bounds
     (fp32 units; three-pass TF32) and their ptxas registers and spills
     (none allowed), and the three factored kernels (K2-K4) on states
     captured from one 128-prompt chunk of the iou pass of the ViT-H SAM
     built first (K2, whose product runs in three-pass TF32, also beside
     that bound, with its registers and no spills);
  4. PEM slice: writes a synthetic RGB-D job (480x640 frame, box mesh, 42
     point-splatted template views, 16 detections), runs
     `sam6d_torch.cli.main pem` at the full-width PEM-base config with seeded
     random weights, checks the poses and that both PEM kernels launched,
     then answers three more frames through PEMPipeline.run_frame;
  5. ISM slice: DINOv2-L at full width with seeded random weights onboards
     the 42 templates of a synthetic job, then ISMPipeline.match_frame scores
     128 proposal slots (the first 48 valid) against them, the fused
     attention kernel launched 24 times per 16-crop chunk; the card is held
     to the port's plain CPU path on 2 proposals; detections_to_bop_json
     writes detection_ism.json and the `pem` CLI poses every record;
  6. SAM slice: ViT-H SAM at full width with seeded random weights (the AMG
     load pinned as bench.py pins it: pred-IoU -10, stability 0, capacity
     128) runs SAMSegmentor.generate_masks on the job's frame (K1 launched
     32 times, K2-K4 16 times each), logs the encoder / iou pass / decode /
     NMS / gather split and the card's busy share, holds the card to the
     port's plain CPU path on a depth-2 cut at 1024 prompts, then
     ISMPipeline(segmentor=...).match_frame(detections=None) scores the
     proposals with DINOv2-L and the `pem` CLI poses every record: a whole
     frame from RGB-D to poses;
  7. the frame through the entry points, at full width: the `render` CLI
     (42 views at 512^2 on the card, two views held to the plain CPU
     render), run_demo (render -> ISM -> PEM, every output file, K1-K7
     launched), MultiObjectStream with two objects over 4 frames,
     synchronous and pipelined, with equal poses, and the ISM describe at
     DINOv2 img_size 448 (1025 tokens: K8 launched 24 times, held to the
     plain attention on the card);
  8. BOP evaluation through the CLI, at full width: write_bop_job (lmo's
     layout: two boxes, 2 test frames at 480x640, a train_pbr scene, 16
     detections a frame), `render-bop` (2 objects x 42 views at 512^2),
     `bop-eval --stage ism --onboarding pbr` (ViT-H SAM, DINOv2-L: K1 32
     and K2-K4 16 times a frame, K5 at the onboarding and the describe),
     `bop-eval --stage pem` on the job's detections (PEM-base, 16 instances
     a frame: K6, K7, K7's cluster path at the onboarding); the files, the
     records and the rows checked, one PEM chunk held to the plain CPU path;
  9. SAMPredictor on the ViT-H segmentor: set_image on a BOP frame (K1 32
     times), a point, a box and a mask-fed prompt, each decode held to the
     CPU decode of the same embedding;
 10. PEM training through the CLI, at full width: write_megapose_job (a
     MegaPose-GSO tree of two boxes, 8 frames at 480x640), `render-training`
     (2 views an object at 512^2; files, masks, xyz in the unit NOCS ball),
     `train` at PEMConfig() and batch 28 for 4 steps with 2 loader threads
     (step wall ms, the StageTimer data / step split, peak memory, K7 3 and
     K6 2 launches a step, K7 once on its cluster path), the checkpoint
     loaded back equal, the busy share over one step, K7's cluster path at
     28x10000->2048 and K6 at 28x2048x2048 on the batch's clouds against
     their plain versions, and one card step at batch 2 against the same
     step on the plain CPU path (loss terms, metrics, every gradient,
     BatchNorm statistics), the CPU step taking the card's FPS picks,
     nearest neighbours and ball-query lists where they part from its own
     at a near-tie, on the last step's batch and on the first 3 batches
     each loader thread draws (the threads' race decides which one the
     last step gets);
 11. segmentation options, at full width: FastSAM-x (seeded random
     weights, each conv rescaled on the job's frame) through
     generate_masks_device at 640 (no kernel), held to the plain CPU run of
     the same weights (the same top-200 anchors and kept set, scores and
     boxes within tolerance, mask pixels differing only near the
     threshold), its CUDA-event split (network; decode, top-k and NMS;
     mask assembly) beside the fp32 bounds, busy share and NMS syncs;
     run_demo(segmentor='fastsam') on phase 7's templates (skip_render;
     the kept slots among the first 48 described, 16 records posed; every
     output file; K5, K6, K7 launched, K1-K4 not); ViT-H SAM's
     generate_masks with crop_n_layers=1 and min_mask_region_area=100
     (boxes inside the frame, invalid slots empty, K1-K4 launched as often
     as the crop boxes and per-layer grids predict);
 12. bf16: the ptxas record of the bf16 entries (registers, no spills);
     the bf16 entries of K1 (a global and a windowed ViT-H block), K5, K8
     and K9 against the plain versions of their bf16 contract within
     BF16_ATOL, timed beside their dense-bf16 bounds (`bf16_bound`) and SDPA
     in bf16 (K1: with its bias as a float mask); the nine stages of the
     bf16 budget at full width (`sam6d_torch.core.numerics`: the port in
     bf16 against the port in fp32 on the same fan-in-scaled weights and
     inputs, each at or under its budget; PEM on a posed frame with the
     conditioned draw of tests/torch_port_draw.py, its fp32 pose within
     POSED_FP32_DEG of the frame's); the bf16 main path:
     generate_masks (K1 bf16 32, K2-K4 bf16 16 each, no fp32 entry; the
     float32 segmentor's the reverse), the K2-K4 bf16 entries on that
     pass's captured chunk states against their plain bf16 versions (K2
     within FACTORED_ATOL / LN_INV_RTOL, K3 within BF16_ATOL x max(1,
     |out|), K4 within BF16_ATOL), timed beside the fp32 entries on the
     same values and their dense-bf16 bounds, no spills; a 48-valid
     match_frame (K5 bf16 72), PEM run_frame at B=16
     (K6, K7 as in fp32), the 448 describe (K8 bf16 24), each against the
     fp32 pipeline on CUDA events over three calls with the card's busy
     share; run_demo with Config(dtype="bfloat16") and a bf16
     MultiObjectStream frame;
 13. export, at full width: PEM-base inference at B=16 (fp32, on a prepared
     synthetic frame, the sampler's uniforms an input), the DINOv2-L
     describe at 16 crops (fp32 and bf16) and ViT-H's prompt decode at 16
     prompts (has_mask 0 and 1) exported with sam6d_torch.deploy, saved,
     loaded here and in a child interpreter that imports only sam6d_torch,
     each held to its direct call (EXPORT_ATOL fp32, BF16_ATOL bf16) with
     the same kernel launches (K7 and K6; K5 x24; K5 bf16 x24; none);
     export s, MB, load s, CUDA-event ms beside the direct call's; the
     host µs a call of torch.ops.sam6d.fused_attention_qkv beside its
     ctypes wrapper (medians of 1000 calls).

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; each kernel's record carries its launches on its own
path (`launches`), on phases 8-12 (`path_launches`) and in a training step
(`train_launches`; K6 and K7 also their times at the training shapes,
`train_ms` and the rest); the bf16 entries' records their launches on the
bf16 path of phase 12; every record its launches in each artifact of
phase 13 (`export_launches`). Prints the card's name and power limit, one JSON line of
kernel records (times, launches, errors, bounds), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NEAR_R2 = 1e-6
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores (TF32 is
# off for every library matmul), dense TF32 on the tensor cores over the
# three passes that keep fp32 accuracy (K1 and K5 run their products so),
# and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# dense bf16 on the tensor cores (the bf16 entries' one-pass products)
PEAK_BF16_FLOPS = 989e12
# fp32 scores and online softmax summed in another order than the plain
# matmul + softmax (the JAX package's own tolerance for its kernel)
ATTENTION_ATOL = 2e-5
# card vs the plain CPU path through 24 fp32 DINOv2-L blocks: GEMMs and
# reductions summed in another order on the two devices
ISM_ATOL = 1e-3
# the factored kernels (K2-K4) against their plain versions: sums over the
# channels, positions and factor rows in another order; K2 forms x where its
# plain version takes the gram quadratic, so 1/sigma carries the
# cancellation of E[x^2] - mu^2 (relative tolerance)
FACTORED_ATOL = 1e-4
LN_INV_RTOL = 1e-3
# card vs the plain CPU path through the cut SAM (two ViT-H blocks, the AMG
# tail at 1024 prompts): logits and IoU; a kept mask may differ only at
# pixels whose card logit is this close to 0
SAM_ATOL = 1e-3
# the bf16 entries against the plain versions of their bf16 contract: the
# same bf16 roundings of p, summed in another order and over an online
# softmax, and the bf16 output's own rounding (the JAX package's tolerance
# for its bf16 kernels)
BF16_ATOL = 8e-3


def log(msg):
    print(msg, flush=True)


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it) for `flops` fp32
    operations on `nbytes` moved."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tc_bound(product_flops, other_flops, nbytes):
    """Least ms the card could take when the products run in three-pass TF32
    on the tensor cores and the rest on the fp32 units."""
    return 1e3 * max(product_flops / PEAK_TF32X3_FLOPS + other_flops / PEAK_FP32_FLOPS,
                     nbytes / PEAK_BYTES)


def bf16_bound(product_flops, other_flops, nbytes):
    """Least ms the card could take when the products run in bf16 on the
    tensor cores and the rest on the fp32 units."""
    return 1e3 * max(product_flops / PEAK_BF16_FLOPS + other_flops / PEAK_FP32_FLOPS,
                     nbytes / PEAK_BYTES)


def cuda_ms(fn, reps=5, launches=1):
    """Median CUDA-event time of fn() in ms, after one warm-up call: the
    time between two events around `launches` calls in a row, over
    `launches`. With one call the time includes the host's dispatch of it
    (the stream is idle when the first event is recorded); a run of calls
    hides the dispatch behind the device's work."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def device_busy(fn, label):
    """Run fn() once under torch.profiler: log the card's busy share (the
    sum of device-side op times over the wall time; one stream, so they do
    not overlap) and the ops that took most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side entries only (kernels, copies, sets): the CPU ops that
    # launched them report the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    if busy == 0:
        log(f"{label}: device busy share not measured (the profiler saw no "
            f"device time); wall {wall:.1f} ms")
        return
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    log(f"{label}: card busy {busy:.1f} ms of {wall:.1f} ms wall under the "
        f"profiler ({100 * busy / wall:.0f}%), {sum(e.count for e in kernels)} "
        f"device ops; most time: " + "; ".join(
            f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.1f} ms" for e in top))


# ------------------------------------------------------------------ phase 1

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    smi_lines = subprocess.run(["nvidia-smi"], capture_output=True, text=True,
                               check=True).stdout.splitlines()
    header = next((ln.strip(" |") for ln in smi_lines if "CUDA Version" in ln), "")
    from sam6d_torch.kernels._build import find_nvcc
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"device: {torch.cuda.get_device_name(0)} capability {cap} ({header}); "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}, nvcc {nvcc}")
    return smi


# ------------------------------------------------------------------ phase 2

def phase_build():
    """Builds the kernels with `-Xptxas -v`; returns {mangled kernel name:
    (registers, spill store bytes + spill load bytes, static shared memory
    bytes)}."""
    from sam6d_torch.kernels import _build
    t0 = time.perf_counter()
    so, out = _build.build(verbose=True)
    _build.load_library()
    secs = time.perf_counter() - t0
    log(f"build: {so.name} in {secs:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    ptxas, entry, spills = {}, None, 0
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        used = re.search(r"Used (\d+) registers", line)
        smem = re.search(r"(\d+) bytes smem", line)
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif spill:
            spills = int(spill[1]) + int(spill[2])
        elif used and entry:
            ptxas[entry] = (int(used[1]), spills, int(smem[1]) if smem else 0)
    return ptxas


def ptxas_record(ptxas, kernel, hd=None):
    """(registers, spill bytes) of `kernel`<hd> (`kernel` alone: its one
    instantiation) from phase_build's table."""
    for name, rec in ptxas.items():
        if kernel in name and (hd is None or f"ILi{hd}E" in name):
            return rec[:2]
    raise AssertionError(f"ptxas reported nothing for {kernel}<{hd}>")


def ptxas_table(ptxas, kernels):
    """{kernel<template argument>: {registers, spill_bytes, smem_bytes}} of
    every instantiation of the named kernels (static shared memory; the FPS
    kernels add their x/y/z planes as dynamic shared memory)."""
    table = {}
    for name, (regs, spills, smem) in ptxas.items():
        for kernel in kernels:
            m = re.search(kernel + r"(?:IL[ib](\d+)E)?", name)
            if m and re.search(r"\d" + kernel, name):
                key = f"{kernel}<{m[1]}>" if m[1] else kernel
                table[key] = dict(registers=regs, spill_bytes=spills, smem_bytes=smem)
    return dict(sorted(table.items()))


# ------------------------------------------------------------------ phase 3

def _check_fps(name, pts, npoint, fps):
    import torch
    log(f"{name}: {fps.fps_path(pts.shape[1])} path")
    got = fps.farthest_point_sample_cuda(pts, npoint)
    want = fps.farthest_point_sample_plain(pts, npoint)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        bad = int((got != want).any(dim=1).sum())
        raise AssertionError(f"{name}: FPS kernel differs from plain in {bad} clouds")
    ms = cuda_ms(lambda: fps.farthest_point_sample_cuda(pts, npoint))
    plain_ms = cuda_ms(lambda: fps.farthest_point_sample_plain(pts, npoint), reps=3)
    log(f"{name}: exact; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


def _check_ball_query(name, pts, args, bq):
    import torch
    from sam6d_torch.ops.geometry import pairwise_sq_distance
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"{name}: {bq.ball_query_path(pts.shape[0], pts.shape[1], sms)} path")
    got = bq.two_scale_ball_query_cuda(pts, pts, *args)
    want = bq.two_scale_ball_query_plain(pts, pts, *args)
    d2 = pairwise_sq_distance(pts, pts)
    err = 0
    for k, (g, w, r) in enumerate(zip(got, want, (args[0], args[2]))):
        near = (d2 - float(np.float32(r * r))).abs() < NEAR_R2
        rows_diff = (g != w).any(dim=-1)
        unexplained = int((rows_diff & ~near.any(dim=-1)).sum())
        log(f"{name} scale {k + 1} (r={r}): {int(near.sum())} pairs within "
            f"{NEAR_R2} of r^2, {int(rows_diff.sum())} rows differ, "
            f"{unexplained} of them without such a pair")
        if unexplained:
            raise AssertionError(f"{name}: kernel differs from plain version")
        err = max(err, int((g.long() - w.long()).abs().max()))
    ms = cuda_ms(lambda: bq.two_scale_ball_query_cuda(pts, pts, *args))
    plain_ms = cuda_ms(lambda: bq.two_scale_ball_query_plain(pts, pts, *args))
    log(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    torch.cuda.synchronize()
    return err, ms, plain_ms


def phase_kernels(cfg, seg, ptxas):
    """Each kernel against its plain version at every shape the main path
    gives it. FPS: exact indices. Ball query: exact indices, except rows
    holding a pair within NEAR_R2 of r^2 (the two versions round the
    expanded distance differently). Fused and rel-pos attention: within
    ATTENTION_ATOL. The factored kernels on states captured from the
    segmentor `seg`: within FACTORED_ATOL (1/sigma: LN_INV_RTOL)."""
    import torch
    from sam6d_torch.kernels import ball_query as bq
    from sam6d_torch.kernels import fps

    rng = np.random.RandomState(SEED)
    dev = torch.device("cuda")
    n_obs, n_fine, n_coarse = (cfg.n_sample_observed_point, cfg.fine_npoint,
                               cfg.coarse_npoint)

    # per frame: 16 observed clouds (some points duplicated, as sampling
    # with replacement makes them) -> 196; at onboarding: the template
    # cloud -> 196 (trunk), and 42 views x 5000 points -> 2048 with heavy
    # duplication (views with few pixels sample with replacement)
    frame = rng.randn(16, n_obs, 3).astype(np.float32) * 0.3
    frame[:, 1000:1100] = frame[:, :100]
    f_err, f_ms, f_plain = _check_fps(
        f"fps[16x{n_obs}->{n_coarse}]", torch.from_numpy(frame).to(dev),
        n_coarse, fps)
    t_err, _, _ = _check_fps(
        f"fps[1x{n_fine}->{n_coarse}]", torch.from_numpy(frame[:1]).to(dev),
        n_coarse, fps)
    n_onb = cfg.n_template_view * cfg.n_sample_template_point
    base = rng.randn(60000, 3).astype(np.float32) * 0.05
    onb = base[rng.randint(0, len(base), n_onb)][None]
    o_err, o_ms, o_plain = _check_fps(
        f"fps[1x{n_onb}->{n_fine}]", torch.from_numpy(onb).to(dev), n_fine, fps)

    # ball query on radius-normalized clouds: 16 per frame, 1 at onboarding
    fm = cfg.fine
    args = (fm.pe_radius1, fm.pe_nsample1, fm.pe_radius2, fm.pe_nsample2)
    pts = torch.from_numpy(rng.randn(16, n_fine, 3).astype(np.float32) * 0.3).to(dev)
    b_err, b_ms, b_plain = _check_ball_query(
        f"ball_query[16x{n_fine}x{n_fine}]", pts, args, bq)
    b1_err, _, _ = _check_ball_query(
        f"ball_query[1x{n_fine}x{n_fine}]", pts[:1].contiguous(), args, bq)
    # bounds from this run's inputs. FPS: each of the M-1 steps updates N
    # running distances (3 sub, 3 mul, 2 add, min, argmax compare: 10 ops).
    # Its latency floor: M chained picks, each at least one step's
    # synchronisation (fps.step_sync_us, measured here). Ball query: the
    # candidates are walked until both quotas are full; each scanned pair
    # costs 15 ops (two dot products, the expanded distance, two compares).
    f_bound = bound(16 * (n_coarse - 1) * n_obs * 10,
                    4 * 16 * n_obs * 3 + 4 * 16 * n_coarse)
    o_bound = bound((n_fine - 1) * n_onb * 10, 4 * n_onb * 3 + 4 * n_fine)
    if fps.fps_path(n_onb) != "cluster":
        raise AssertionError(f"fps[1x{n_onb}] takes the {fps.fps_path(n_onb)} path")
    step_us = {path: fps.step_sync_us(path, n) for path, n in
               (("block", n_obs), ("cluster", n_onb))}
    log(f"fps step synchronisation alone: block {step_us['block']:.4f} us, "
        f"cluster {step_us['cluster']:.4f} us")
    b_bound = bound(15 * _ball_query_scanned_pairs(pts, args),
                    2 * 4 * 16 * n_fine * 3 + 4 * 16 * n_fine * (args[1] + args[3]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f_ptx = ptxas_table(ptxas, ("fps_block_kernel", "fps_cluster_kernel",
                                "fps_latency_kernel", "fps_multi_step_kernel"))
    b_ptx = ptxas_table(ptxas, ("ball_query_lanes_kernel", "ball_query_warps_kernel"))
    for k, rec in {**f_ptx, **b_ptx}.items():
        log(f"{k}: ptxas {rec['registers']} registers, {rec['spill_bytes']} bytes "
            f"spilled, {rec['smem_bytes']} bytes static shared memory")
    return [
        dict(name="farthest_point_sample_cuda", route="cuda",
             source="sam6d_torch/csrc/fps.cu",
             replaces="sam6d_tpu/kernels/fps.py:56",
             max_abs_err=max(f_err, t_err, o_err), tolerance="exact indices",
             ms=f_ms, plain_ms=f_plain, bound_ms=f_bound[0], bound_by=f_bound[1],
             library_ms=None, onboard_ms=o_ms, onboard_plain_ms=o_plain,
             onboard_bound_ms=o_bound[0], onboard_bound_by=o_bound[1],
             latency_floor_ms=n_coarse * step_us["block"] / 1e3,
             onboard_latency_floor_ms=n_fine * step_us["cluster"] / 1e3,
             step_sync_us=step_us,
             paths={f"16x{n_obs}->{n_coarse}": fps.fps_path(n_obs),
                    f"1x{n_fine}->{n_coarse}": fps.fps_path(n_fine),
                    f"1x{n_onb}->{n_fine}": fps.fps_path(n_onb)},
             ptxas=f_ptx,
             shapes=f"16x{n_obs}->{n_coarse} (ms); 1x{n_onb}->{n_fine} "
                    f"(onboard_ms); 1x{n_fine}->{n_coarse} checked"),
        dict(name="two_scale_ball_query_cuda", route="cuda",
             source="sam6d_torch/csrc/ball_query.cu",
             replaces="sam6d_tpu/kernels/ball_query.py:68",
             max_abs_err=max(b_err, b1_err),
             tolerance=f"exact indices except rows with a pair within "
                       f"{NEAR_R2} of r^2",
             ms=b_ms, plain_ms=b_plain, bound_ms=b_bound[0], bound_by=b_bound[1],
             library_ms=None,
             paths={f"16x{n_fine}x{n_fine}": bq.ball_query_path(16, n_fine, sms),
                    f"1x{n_fine}x{n_fine}": bq.ball_query_path(1, n_fine, sms)},
             ptxas=b_ptx,
             shapes=f"16x{n_fine}x{n_fine} (ms); 1x{n_fine}x{n_fine} checked; "
                    f"r {fm.pe_radius1}/{fm.pe_radius2}, "
                    f"s {fm.pe_nsample1}/{fm.pe_nsample2}"),
        _check_attention(rng, ptxas),
        *_check_head_major_attention(rng, ptxas),
        _check_relpos(rng, ptxas),
        *_check_factored(capture_factored(seg, rng), ptxas),
    ]


def _ball_query_scanned_pairs(pts, args):
    """(query, candidate) pairs the ball-query kernel's warps walk on `pts`:
    32-candidate slices until both quotas are full, or all N."""
    import torch
    from sam6d_torch.ops.geometry import pairwise_sq_distance
    r1, s1, r2, s2 = args
    d2 = pairwise_sq_distance(pts, pts)
    N = d2.shape[-1]
    full = ((d2 < r1 * r1).cumsum(-1) >= s1) & ((d2 < r2 * r2).cumsum(-1) >= s2)
    first = torch.where(full.any(-1), full.int().argmax(-1),
                        torch.full_like(full[..., 0], N - 1, dtype=torch.long))
    return int((torch.clamp((first // 32 + 1) * 32, max=N)).sum())


def _check_attention(rng, ptxas):
    """K5 against its plain version at the describe shape (16 crops of 257
    tokens, 16 heads of 64), a ragged batch, N a multiple of every tile, and
    a stress case (q and k x2: scores up to ~20); timed against its plain
    version and the library's SDPA on the same strided views, beside both
    bounds (fp32 units; three-pass TF32 on the tensor cores)."""
    import torch
    import torch.nn.functional as F
    from sam6d_torch.kernels import attention_qkv as att

    heads, hd = 16, 64
    scale = hd ** -0.5
    err = 0.0
    for B, N, qk in ((16, 257, 1.0), (3, 257, 1.0), (2, 256, 1.0), (16, 257, 2.0)):
        x = rng.randn(B, N, 3 * heads * hd).astype(np.float32)
        x[..., :2 * heads * hd] *= qk
        qkv = torch.from_numpy(x).cuda()
        got = att.fused_attention_qkv_cuda(qkv, heads, scale)
        want = att.fused_attention_qkv_plain(qkv, heads, scale)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        log(f"attention_qkv[{B}x{N}x{3 * heads * hd}, {heads} heads, q and k x{qk:g}]: "
            f"max |diff| {e:.2e} (atol {ATTENTION_ATOL})")
        if not e <= ATTENTION_ATOL:
            raise AssertionError("fused_attention_qkv kernel differs from plain")
        err = max(err, e)
    B, N, C = 16, 257, heads * hd
    qkv = torch.from_numpy(rng.randn(B, N, 3 * C).astype(np.float32)).cuda()
    q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    ms = cuda_ms(lambda: att.fused_attention_qkv_cuda(qkv, heads, scale), reps=20)
    plain_ms = cuda_ms(lambda: att.fused_attention_qkv_plain(qkv, heads, scale), reps=20)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                     reps=20)
    flops, nbytes = 4 * B * heads * N * N * hd, 4 * B * N * 3 * C + 4 * B * N * C
    b_ms, b_by = bound(flops, nbytes)
    tc_ms = tc_bound(flops, 0, nbytes)
    regs, spills = ptxas_record(ptxas, "attention_qkv_kernel", hd)
    if spills:
        raise AssertionError(f"fused_attention_qkv (hd {hd}) spills {spills} bytes")
    log(f"attention_qkv[16x257x3072]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {lib_ms:.4f} ms, kernel/SDPA {ms / lib_ms:.3f}; bound {b_ms:.4f} ms on the "
        f"fp32 units ({b_by}, {100 * b_ms / ms:.1f}% of it), {tc_ms:.4f} ms in three-pass "
        f"TF32 ({100 * tc_ms / ms:.1f}%); ptxas {regs} registers, {spills} bytes spilled")
    return dict(name="fused_attention_qkv_cuda", route="cuda",
                source="sam6d_torch/csrc/attention_qkv.cu",
                replaces="sam6d_tpu/kernels/flash_attention.py:280",
                max_abs_err=err, tolerance=f"atol {ATTENTION_ATOL}",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_ratio=ms / lib_ms, tc_bound_ms=tc_ms,
                ptxas_registers=regs, ptxas_spill_bytes=spills,
                shapes="16x257x3072, 16 heads of 64 (ms); 3x257, 2x256 and 16x257 with q "
                       "and k x2 checked")


def _check_head_major_attention(rng, ptxas):
    """K8 against its plain version at the 448 describe shape (16 crops x 16
    heads x 1025 tokens of hd 64, the (B, H, N, hd) views of a qkv
    projection, as models/vit.Attention passes them), at a stress case there
    (q and k x2: scores up to ~20), at a cross-attention case (61 queries x
    300 keys, hd 32) and at hd 80; K9 at the DINOv2-L class shape (16 x 16 x
    257 x 64) and its stress case. Each timed against its plain version and
    SDPA on the same operands over runs of 10 launches (and by one launch
    after a sync, the method of the other attention rows and of the earlier
    K8 and K9 times), beside both bounds (fp32 units; three-pass TF32 on
    the tensor cores). K9 at 257 tokens and K8 at 1025 are also
    timed against K5 on the same qkv projection (they on its views), in
    turns: one shape and one arithmetic, split-once staging against
    split-per-fragment. Fails on a spill in any instantiation of the
    head-major kernel."""
    import torch
    import torch.nn.functional as F
    from sam6d_torch.kernels import attention as att
    from sam6d_torch.kernels import attention_qkv

    def views(B, H, N, hd, qk=1.0):
        x = rng.randn(B, N, 3 * H * hd).astype(np.float32)
        x[..., :2 * H * hd] *= qk
        qkv = torch.from_numpy(x).cuda()
        return qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)

    def check(name, fn, plain, q, k, v):
        hd = q.shape[-1]
        got, want = fn(q, k, v, hd ** -0.5), plain(q, k, v, hd ** -0.5)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        log(f"{name}[q {tuple(q.shape)}, k {tuple(k.shape)}]: max |diff| {e:.2e} "
            f"(atol {ATTENTION_ATOL})")
        if not e <= ATTENTION_ATOL:
            raise AssertionError(f"{name} kernel differs from its plain version")
        return e

    def timed(name, fn, plain, q, k, v):
        B, H, Nq, hd = q.shape
        Nk = k.shape[2]
        s = hd ** -0.5
        ms = cuda_ms(lambda: fn(q, k, v, s), reps=10, launches=10)
        plain_ms = cuda_ms(lambda: plain(q, k, v, s), reps=5, launches=10)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=s), reps=10,
                         launches=10)
        one_ms = cuda_ms(lambda: fn(q, k, v, s), reps=10)
        flops, nbytes = 4 * B * H * Nq * Nk * hd, 4 * B * H * hd * (2 * Nq + 2 * Nk)
        b_ms, b_by = bound(flops, nbytes)
        tc_ms = tc_bound(flops, 0, nbytes)
        regs, spills = ptxas_record(ptxas, "head_major_attention_kernel", hd)
        log(f"{name}[{B}x{H}x{Nq}x{Nk}x{hd}]: runs of 10 launches: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, kernel/SDPA {ms / lib_ms:.3f}; one launch "
            f"after a sync (the other rows' method) {one_ms:.4f} ms; bound {b_ms:.4f} ms on the "
            f"fp32 units ({b_by}, {100 * b_ms / ms:.1f}% of it), {tc_ms:.4f} ms in three-pass "
            f"TF32 ({100 * tc_ms / ms:.1f}%); ptxas {regs} registers, {spills} bytes spilled")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_ratio=ms / lib_ms,
                    one_launch_ms=one_ms, bound_ms=b_ms, bound_by=b_by, tc_bound_ms=tc_ms,
                    ptxas_registers=regs, ptxas_spill_bytes=spills)

    for hdp in range(16, 129, 16):
        regs, spills = ptxas_record(ptxas, "head_major_attention_kernel", hdp)
        log(f"head_major_attention<{hdp}>: ptxas {regs} registers, {spills} bytes spilled")
        if spills:
            raise AssertionError(f"head_major_attention<{hdp}> spills {spills} bytes")

    k8_args = (att.fused_attention_cuda, att.fused_attention_plain)
    q, k, v = views(16, 16, 1025, 64)
    err = check("fused_attention", *k8_args, q, k, v)
    k8 = timed("fused_attention", *k8_args, q, k, v)
    del q, k, v
    err = max(err, check("fused_attention", *k8_args, *views(16, 16, 1025, 64, qk=2.0)))
    cross = [torch.from_numpy(rng.randn(2, 4, n, 32).astype(np.float32)).cuda()
             for n in (61, 300, 300)]
    err = max(err, check("fused_attention", *k8_args, *cross))
    err = max(err, check("fused_attention", *k8_args, *views(2, 16, 200, 80)))

    k9_args = (att.fused_attention_small_cuda, att.fused_attention_small_plain)
    small = [torch.from_numpy(rng.randn(16, 16, 257, 64).astype(np.float32)).cuda()
             for _ in range(3)]
    err9 = check("fused_attention_small", *k9_args, *small)
    k9 = timed("fused_attention_small", *k9_args, *small)
    del small
    err9 = max(err9, check("fused_attention_small", *k9_args, *views(16, 16, 257, 64, qk=2.0)))
    # split once (K9 at 257 tokens, K8 at 1025, on the views of one qkv)
    # against split per fragment (K5 on that qkv): one shape, one
    # arithmetic, timed in turns, runs of 10 launches
    for rec, name, fn, N in ((k9, "fused_attention_small", att.fused_attention_small_cuda, 257),
                             (k8, "fused_attention", att.fused_attention_cuda, 1025)):
        qkv = torch.from_numpy(rng.randn(16, N, 3 * 1024).astype(np.float32)).cuda()
        q, k, v = qkv.view(16, N, 3, 16, 64).permute(2, 0, 3, 1, 4)
        ab = {"K5": [], name: []}
        for who in ("K5", name, name, "K5"):
            ab[who].append(cuda_ms(
                (lambda: attention_qkv.fused_attention_qkv_cuda(qkv, 16, 0.125)) if who == "K5"
                else (lambda: fn(q, k, v, 0.125)), reps=10, launches=10))
        rec["same_call_k5_ms"] = statistics.mean(ab["K5"])
        rec["same_call_ms"] = statistics.mean(ab[name])
        log(f"{name} (split once) vs fused_attention_qkv (split per fragment) on one "
            f"16x{N}x3072 qkv, in turns: {name} {ab[name][0]:.4f}, {ab[name][1]:.4f} ms; "
            f"K5 {ab['K5'][0]:.4f}, {ab['K5'][1]:.4f} ms; ratio "
            f"{rec['same_call_ms'] / rec['same_call_k5_ms']:.3f}")
        del qkv, q, k, v
    return [
        dict(name="fused_attention_cuda", route="cuda",
             source="sam6d_torch/csrc/attention.cu",
             replaces="sam6d_tpu/kernels/flash_attention.py:133",
             max_abs_err=err, tolerance=f"atol {ATTENTION_ATOL}", **k8,
             shapes="16x16x1025x64 self-attention on qkv views (ms, plain_ms, library_ms: runs "
                    "of 10 launches; one_launch_ms: one launch after a sync); the same with q "
                    "and k x2, 2x4x61x300 hd 32 cross-attention and 2x16x200 hd 80 checked; "
                    "same_call_*: the kernel on the views of one 16x1025x3072 qkv and K5 on it, "
                    "in turns, runs of 10 launches"),
        dict(name="fused_attention_small_cuda", route="cuda",
             source="sam6d_torch/csrc/attention.cu",
             replaces="sam6d_tpu/kernels/flash_attention.py:203",
             max_abs_err=err9, tolerance=f"atol {ATTENTION_ATOL}", **k9,
             shapes="16x16x257x64 (ms, plain_ms, library_ms: runs of 10 launches; "
                    "one_launch_ms: one launch after a sync); the same on qkv views with q and "
                    "k x2 checked; same_call_*: the kernel on the views of one 16x257x3072 qkv "
                    "and K5 on it, in turns, runs of 10 launches",
             note="no caller in either package: held to its plain version only"),
    ]


def _check_relpos(rng, ptxas):
    """K1 against its plain version at the ViT-H shapes: a global block
    (1 x 64x64 tokens) and a windowed block (25 windows of 14x14), 16 heads
    of 80, and a stress case at the windowed shape (rel-pos parameters x3:
    scores up to ~20).
    Timed at both shapes: the kernel (which forms the rel-pos tables of its
    rows itself), the plain version's two table einsums alone, the plain
    version, and SDPA with the materialized bias as its mask, beside both
    bounds (fp32 units; three-pass TF32 on the tensor cores)."""
    import torch
    import torch.nn.functional as F
    from sam6d_torch.kernels import attention_relpos as rp

    heads, hd = 16, 80
    C = heads * hd
    rec = {}
    for name, B, (H, W), rel in (("global", 1, (64, 64), 1.0), ("windowed", 25, (14, 14), 1.0),
                                 ("stress", 25, (14, 14), 3.0)):
        N = H * W
        qkv = torch.from_numpy(rng.randn(B, N, 3 * C).astype(np.float32)).cuda()
        rh, rw = (torch.from_numpy(rng.randn(2 * s - 1, hd).astype(np.float32) * 0.1 * rel).cuda()
                  for s in (H, W))
        args = (qkv, rh, rw, (H, W), heads)
        got = rp.flash_attention_relpos_cuda(*args)
        want = rp.flash_attention_relpos_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        del got, want
        log(f"relpos_attention[{name} {B}x{N}x{3 * C}, rel-pos std {rel * 0.1:g}]: max |diff| "
            f"{err:.2e} (atol {ATTENTION_ATOL})")
        if not err <= ATTENTION_ATOL:
            raise AssertionError(f"flash_attention_relpos kernel differs from plain ({name})")
        if name == "stress":
            rec[name] = dict(err=err)
            continue
        rel_h, rel_w = rp.rel_pos_tables(*args)
        ms = cuda_ms(lambda: rp.flash_attention_relpos_cuda(*args), reps=10)
        tables_ms = cuda_ms(lambda: rp.rel_pos_tables(*args), reps=10)
        plain_ms = cuda_ms(lambda: rp.flash_attention_relpos_plain(*args), reps=5)
        q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        bias = (rel_h.view(B, heads, N, H, 1) + rel_w.view(B, heads, N, 1, W)
                ).reshape(B, heads, N, N)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=hd ** -0.5), reps=5)
        del bias, rel_h, rel_w
        # q k^T and p v; the bias adds and the tables' dot products
        products = 4 * B * heads * N * N * hd
        other = 2 * B * heads * N * N + 2 * B * heads * N * (H + W) * hd
        nbytes = 4 * (B * N * 3 * C + (2 * H + 2 * W - 2) * hd + B * N * C)
        b_ms, b_by = bound(products + other, nbytes)
        tc_ms = tc_bound(products, other, nbytes)
        rec[name] = dict(err=err, ms=ms, tables_ms=tables_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         b_ms=b_ms, b_by=b_by, tc_ms=tc_ms)
        log(f"relpos_attention[{name} {B}x{N}x{3 * C}, {heads} heads of {hd}]: kernel "
            f"{ms:.4f} ms (tables formed inside), the two table einsums alone "
            f"{tables_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA with the bias {lib_ms:.4f} ms, "
            f"kernel/SDPA {ms / lib_ms:.3f}; bound {b_ms:.4f} ms on the fp32 units ({b_by}, "
            f"{100 * b_ms / ms:.1f}% of it), {tc_ms:.4f} ms in three-pass TF32 "
            f"({100 * tc_ms / ms:.1f}%)")
    g, w = rec["global"], rec["windowed"]
    regs, spills = ptxas_record(ptxas, "attention_relpos_kernel", hd)
    if spills:
        raise AssertionError(f"flash_attention_relpos (hd {hd}) spills {spills} bytes")
    log(f"relpos_attention: ptxas {regs} registers, {spills} bytes spilled (hd {hd})")
    return dict(name="flash_attention_relpos_cuda", route="cuda",
                source="sam6d_torch/csrc/attention_relpos.cu",
                replaces="sam6d_tpu/kernels/flash_attention.py:316",
                max_abs_err=max(r["err"] for r in rec.values()),
                tolerance=f"atol {ATTENTION_ATOL}",
                ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["b_ms"],
                bound_by=g["b_by"], library_ms=g["lib_ms"], library_ratio=g["ms"] / g["lib_ms"],
                tc_bound_ms=g["tc_ms"], tables_einsum_ms=g["tables_ms"],
                windowed_ms=w["ms"], windowed_tables_einsum_ms=w["tables_ms"],
                windowed_plain_ms=w["plain_ms"], windowed_bound_ms=w["b_ms"],
                windowed_tc_bound_ms=w["tc_ms"], windowed_library_ms=w["lib_ms"],
                windowed_library_ratio=w["ms"] / w["lib_ms"],
                ptxas_registers=regs, ptxas_spill_bytes=spills,
                shapes="global 1x4096x3840, 16 heads of 80 (ms: the kernel, tables formed "
                       "inside; tables_einsum_ms: the plain version's two table einsums "
                       "alone); windowed 25x196x3840 (windowed_*); windowed with rel-pos x3 "
                       "checked")


FACTORED = ("factored_ln_stats", "factored_t2i_attention", "factored_i2t_scores")


def capture_factored(seg, rng):
    """The arguments of the three factored dispatches in one 128-prompt chunk
    of the iou pass, on the embedding of a random 480x640 frame: per
    dispatch, the layer-1 call and the layer-2 (K2, K4) or final-attention
    (K3) call."""
    import torch
    from sam6d_torch.models import sam as sam_mod

    calls = {n: [] for n in FACTORED}
    orig = {n: getattr(sam_mod, n) for n in FACTORED}

    def recorder(n):
        def f(*args):
            calls[n].append(args)
            return orig[n](*args)
        return f

    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    resized, _, (hs, ws), (h_in, w_in) = seg.preprocess_frame_u8(img)
    _, _, pts = seg.frame_constants(hs, ws, h_in, w_in)
    try:
        for n in FACTORED:
            setattr(sam_mod, n, recorder(n))
        with torch.inference_mode():
            emb = seg._encode_u8(torch.as_tensor(resized, device=seg.device))
            seg._decode_chunk(emb, seg.sam.prompt_encoder.dense_pe(),
                              pts[:seg.cfg.points_per_batch], iou_only=True)
    finally:
        for n in FACTORED:
            setattr(sam_mod, n, orig[n])
    torch.cuda.synchronize()
    return calls


def _blocks_bytes(blocks):
    return sum(pd.numel() * pd.element_size()
               + (0 if s is None else s.numel() * s.element_size()) for pd, s in blocks)


def _ln_stats_work(args):
    """(FLOP of the rank-R product that forms x, FLOP of a*S, the sum and
    the square, bytes) of one factored_ln_stats call: each operand at its
    own element size (2 in bf16, where the bf16 moments mS and qS are read
    too), the (mu, 1/sigma) output in fp32."""
    blocks, Uc, S, a, _ = args
    (B, R, C), N = Uc.shape, S.shape[0]
    e = S.element_size()
    nbytes = _blocks_bytes(blocks) + e * (Uc.numel() + S.numel()) + 4 * 2 * B * N \
        + (0 if a is None else e * a.numel()) + (2 * e * N if e == 2 else 0)
    return 2 * B * N * R * C, 4 * B * N * C, nbytes


def _i2t_work(args):
    """(FLOP of the products K4 runs on the tensor cores: the rank-R score
    term and the 16-channel head-score term; FLOP of a QS + QC, the low-rank
    factor T1 and the softmax; bytes, at the operands' element size, the
    output in theirs) of one factored_i2t_scores call."""
    kt, UQ, blocks, a, QS, QC, heads = args
    (B, T, d), N = kt.shape, QS.shape[0]
    R = 0 if UQ is None else UQ.shape[1]
    hd, HT = d // heads, heads * T
    e = kt.element_size()
    nbytes = _blocks_bytes(blocks) + e * (kt.numel() + (0 if UQ is None else UQ.numel())
                                          + (0 if a is None else a.numel())
                                          + 2 * QS.numel() + B * (HT + 1) * N)
    return (2 * B * HT * N * (R + hd), 2 * B * N * d + 2 * B * HT * R * hd + 5 * B * HT * N,
            nbytes)


def _t2i_work(args):
    """(FLOP of the products K3 runs on the tensor cores: the score terms,
    q against KS, KC and the rank-R factor, and in bf16 also the value part,
    T2 and the two low-rank factors T1 and T2 UV; FLOP of the rest on the
    fp32 units: in fp32 those four and the softmax, in bf16 the softmax;
    bytes, at the operands' element size) of one factored_t2i_attention
    call."""
    qp, UK, UV, blocks, a, KS, KC, VS, heads = args
    (B, T, d), R, N = qp.shape, UK.shape[1], KS.shape[0]
    hd, HT = d // heads, heads * T
    e = qp.element_size()
    nbytes = _blocks_bytes(blocks) + e * (2 * qp.numel() + UK.numel() + UV.numel()
                                          + a.numel() + 3 * KS.numel())
    scores, rest = B * HT * N * (4 * hd + 2 * R), B * HT * N * (2 * hd + 2 * R)
    factors, softmax = 4 * B * HT * R * hd, 5 * B * HT * N
    if e == 2:
        return scores + rest + factors, softmax, nbytes
    return scores, rest + softmax + factors, nbytes


def _factored_bound(name, args):
    """(least ms, bound_by) of one factored call on its own arguments."""
    if name == "factored_ln_stats":
        product, other, nbytes = _ln_stats_work(args)
        flops = product + other
    elif name == "factored_t2i_attention":
        # per (row, position): scores (KS, KC, the rank-R term), the value
        # part and the rank-R value factor; the two low-rank factors
        product, other, nbytes = _t2i_work(args)
        flops = product + other
    else:
        kt, UQ, _, _, QS, _, heads = args
        (B, T, d), N = kt.shape, QS.shape[0]
        R = 0 if UQ is None else UQ.shape[1]
        hd, HT = d // heads, heads * T
        flops = B * HT * N * (4 * hd + 2 * R + 5) + 2 * B * HT * R * hd
        nbytes = _i2t_work(args)[2]
    return bound(flops, nbytes)


def _check_factored(calls, ptxas):
    """K2-K4 against their plain versions on the captured chunk states;
    each record is timed at the larger (second) call, the first call's
    numbers kept beside it. All three run their products on the tensor
    cores: their records add the three-pass TF32 bound and the ptxas
    registers of their kernels (K3: the position chunks' kernel, then the
    merge kernel; a spill fails)."""
    import torch
    from sam6d_torch.kernels import factored as fk

    tc = {"factored_ln_stats": (("ln_stats_tc_kernel",), _ln_stats_work),
          "factored_t2i_attention": (("t2i_tc_kernel", "t2i_merge_kernel"), _t2i_work),
          "factored_i2t_scores": (("i2t_tc_kernel",), _i2t_work)}
    ptx = {}
    for n, (kernels, _) in tc.items():
        ptx[n] = [ptxas_record(ptxas, kernel) for kernel in kernels]
        for kernel, (regs, spills) in zip(kernels, ptx[n]):
            log(f"{n}: {kernel} ptxas {regs} registers, {spills} bytes spilled")
            if spills:
                raise AssertionError(f"{n}: {kernel} spills {spills} bytes")
    records = []
    for n, line in zip(FACTORED, (296, 350, 167)):
        cuda_fn, plain_fn = getattr(fk, n + "_cuda"), getattr(fk, n + "_plain")
        rows = []
        for args in calls[n]:
            with torch.inference_mode():
                got, want = cuda_fn(*args), plain_fn(*args)
                torch.cuda.synchronize()
                if n == "factored_ln_stats":
                    err = float((got[0] - want[0]).abs().max())
                    rel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
                    ok = err <= FACTORED_ATOL and rel <= LN_INV_RTOL
                    desc = f"mu max |diff| {err:.2e}, 1/sigma max rel diff {rel:.2e}"
                else:
                    err = float((got - want).abs().max())
                    ok = err <= FACTORED_ATOL
                    desc = f"max |diff| {err:.2e}"
                del got, want
                ms = cuda_ms(lambda: cuda_fn(*args), reps=10)
                plain_ms = cuda_ms(lambda: plain_fn(*args), reps=3)
            b_ms, b_by = _factored_bound(n, args)
            tc_ms = tc_bound(*tc[n][1](args))
            blocks = args[{"factored_ln_stats": 0, "factored_t2i_attention": 3,
                           "factored_i2t_scores": 2}[n]]
            ranks = "+".join(str(pd.shape[1]) for pd, _ in blocks) or "0"
            B = (args[1] if n == "factored_ln_stats" else args[0]).shape[0]
            log(f"{n}[B={B}, ranks {ranks}]: {desc}; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), three-pass TF32 "
                f"bound {tc_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"{n} kernel differs from its plain version")
            rows.append(dict(err=err if n != "factored_ln_stats" else max(err, rel), ms=ms,
                             plain_ms=plain_ms, b_ms=b_ms, b_by=b_by, tc_ms=tc_ms,
                             ranks=ranks))
        first, last = rows[0], rows[-1]
        extra = dict(tc_bound_ms=last["tc_ms"], first_call_tc_bound_ms=first["tc_ms"],
                     ptxas_registers=ptx[n][0][0], ptxas_spill_bytes=ptx[n][0][1])
        if len(ptx[n]) > 1:
            extra.update(merge_ptxas_registers=ptx[n][1][0],
                         merge_ptxas_spill_bytes=ptx[n][1][1])
        records.append(dict(
            name=n + "_cuda", route="cuda", source="sam6d_torch/csrc/factored.cu",
            replaces=f"sam6d_tpu/kernels/factored_t2i.py:{line}",
            max_abs_err=max(r["err"] for r in rows),
            tolerance=(f"mu atol {FACTORED_ATOL}, 1/sigma rtol {LN_INV_RTOL} (max_abs_err "
                       f"holds the larger)" if n == "factored_ln_stats"
                       else f"atol {FACTORED_ATOL}"),
            ms=last["ms"], plain_ms=last["plain_ms"], bound_ms=last["b_ms"],
            bound_by=last["b_by"], library_ms=None,
            first_call_ms=first["ms"], first_call_plain_ms=first["plain_ms"],
            first_call_bound_ms=first["b_ms"],
            shapes=f"B=128, N=4096, ranks {last['ranks']} (ms); ranks {first['ranks']} "
                   f"(first_call_ms); states captured from one chunk of the iou pass",
            **extra))
    return records


# ------------------------------------------------------------------ phase 4

def check_against_plain(pipe, inputs, n=2, atol=1e-3):
    """The first `n` instances of a frame through the port on the card
    (CUDA kernels) and through a CPU copy of the same network (the kernels'
    plain versions), the fine half started from the card's coarse pose. The
    tolerance covers float32 sums taken in another order on the two devices."""
    import copy
    import torch
    per_instance = ("rgb", "rgb_choose", "pts")
    cpu_net = copy.deepcopy(pipe.net).cpu()
    with torch.inference_mode():
        g_in = {k: torch.as_tensor(v[:n] if k in per_instance else v,
                                   device=pipe.device) for k, v in inputs.items()}
        tr, model_n, R0, t0 = pipe.net.infer_coarse(g_in, pipe._generator(0))
        got = pipe.net.infer_fine(tr, model_n, R0, t0, g_in.get("pe_o"))
        c_in = {k: v.cpu() for k, v in g_in.items()}
        tr_c = cpu_net._shared_trunk(c_in)
        want = cpu_net.infer_fine(
            tr_c, c_in["model"] / (tr_c["radius"][:, None, None] + 1e-6),
            R0.cpu(), t0.cpu(), c_in.get("pe_o"))
    errs = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    log(f"slice vs plain path on the CPU ({n} instances, fine half): max |diff| "
        f"R {errs[0]:.2e}, t {errs[1]:.2e}, score {errs[2]:.2e} (atol {atol})")
    if max(errs) > atol:
        raise AssertionError("card path disagrees with the plain CPU path")


def phase_slice(cfg):
    import torch
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.data.synthetic import K_CAM, write_pem_job
    from sam6d_torch.kernels import ball_query as bq
    from sam6d_torch.kernels import fps
    from sam6d_torch.kernels.attention_qkv import fused_attention_qkv_cuda
    from sam6d_torch.pipelines.pem import PEMPipeline, load_ply

    rng = np.random.RandomState(SEED)
    with tempfile.TemporaryDirectory() as job_dir:
        job = write_pem_job(job_dir, rng)
        argv = ["pem", "--output_dir", job_dir, "--cad_path", job["cad"],
                "--rgb_path", job["rgb"], "--depth_path", job["depth"],
                "--cam_path", job["cam"], "--seg_path", job["seg"],
                "--device", "cuda"]
        fps.farthest_point_sample_cuda.launches = 0
        bq.two_scale_ball_query_cuda.launches = 0
        fused_attention_qkv_cuda.launches = 0
        t0 = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {"farthest_point_sample_cuda": fps.farthest_point_sample_cuda.launches,
                    "two_scale_ball_query_cuda": bq.two_scale_ball_query_cuda.launches}
        log(f"slice: `pem` CLI run in {cli_s:.2f} s (cold: weights, onboarding, "
            f"frame); kernel launches {launches}")
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"{name} was not launched on the main path")

        with open(os.path.join(job_dir, "sam6d_results", "detection_pem.json")) as f:
            res = json.load(f)
        if len(res) != 16:
            raise AssertionError(f"expected 16 poses, got {len(res)}")
        for r in res:
            R = np.asarray(r["R"], np.float64)
            t = np.asarray(r["t"], np.float64)
            if R.shape != (3, 3) or not np.allclose(R @ R.T, np.eye(3), atol=1e-3):
                raise AssertionError(f"pose R is not a rotation: {R}")
            if t.shape != (3,) or not np.isfinite(t).all() or not np.isfinite(r["score"]):
                raise AssertionError(f"non-finite pose: t={t} score={r['score']}")
        log(f"slice: detection_pem.json holds {len(res)} poses, R R^T = I "
            f"(atol 1e-3), t and scores finite")

        pipe = PEMPipeline(cfg, seed=SEED, device="cuda")
        model_points = (load_ply(job["cad"]).sample(
            cfg.n_sample_model_point, np.random.RandomState(0)) / 1000.0
                        ).astype(np.float32)
        t0 = time.perf_counter()
        tem = pipe.load_template_views(os.path.join(job_dir, "templates"))
        t1 = time.perf_counter()
        templates = pipe.onboard_templates(tem)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"slice: onboarding {1e3 * (t2 - t1):.1f} ms on the card path "
            f"(+{1e3 * (t1 - t0):.1f} ms host template read)")
        frame_ms = []
        for k in range(3):
            t0 = time.perf_counter()
            out, _ = pipe.run_frame(job["rgb_arr"], job["depth_arr"], K_CAM, 1.0,
                                    job["dets"], model_points, templates,
                                    seed=k + 2)
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            if len(out) != 16 or not all(np.isfinite(r["t"]).all() for r in out):
                raise AssertionError("run_frame returned a bad result")
        log("slice: run_frame at B=16 fp32, wall ms: "
            + ", ".join(f"{m:.1f}" for m in frame_ms))
        # the same frame split into its host half and its card half
        t0 = time.perf_counter()
        inputs, _ = pipe.prepare_frame(job["rgb_arr"], job["depth_arr"], K_CAM,
                                       1.0, job["dets"], model_points, templates)
        host_ms = 1e3 * (time.perf_counter() - t0)
        device_ms = cuda_ms(lambda: pipe.infer_batch(inputs), reps=3)
        log(f"slice: host prepare_frame {host_ms:.1f} ms; infer_batch on the "
            f"card {device_ms:.1f} ms (CUDA events, median of 3, upload included)")
        device_busy(lambda: pipe.run_frame(
            job["rgb_arr"], job["depth_arr"], K_CAM, 1.0, job["dets"],
            model_points, templates, seed=2), "slice: run_frame B=16")
        check_against_plain(pipe, inputs)
    return launches, frame_ms


# ------------------------------------------------------------------ phase 5

def check_ism_against_plain(pipe, rgb, depth, props, cloud, n=2):
    """The first `n` proposals through the card and through a CPU copy of the
    pipeline (the kernels' plain versions), against the same reference data:
    cls and patch descriptors and the three scores within ISM_ATOL."""
    import copy
    import torch
    from sam6d_torch.data.synthetic import K_CAM
    cpu = copy.copy(pipe)
    cpu.device = torch.device("cpu")
    cpu.dinov2 = copy.deepcopy(pipe.dinov2).cpu()
    cpu.ref_data = {k: v.cpu() for k, v in pipe.ref_data.items()}
    dets = {k: v[:n] for k, v in props.items()}

    def describe(p):
        with torch.inference_mode():
            return p._describe_impl(
                torch.as_tensor(rgb, device=p.device).float() / 255.0,
                torch.as_tensor(dets["masks"], device=p.device).float(),
                torch.as_tensor(dets["boxes"], device=p.device).int(), n)

    errs = {name: float((g.cpu() - w).abs().max())
            for name, g, w in zip(("cls", "patch"), describe(pipe), describe(cpu))}
    kw = dict(detections=dets, apply_size_filters=False)
    got = pipe.match_frame(rgb, depth, K_CAM, 1.0, cloud, **kw)
    want = cpu.match_frame(rgb, depth, K_CAM, 1.0, cloud, **kw)
    for k in ("semantic_score", "appe_score", "geometric_score", "visible_ratio"):
        errs[k] = float(np.abs(got[k] - want[k]).max())
    same = all((got[k] == want[k]).all() for k in ("object_ids", "best_template", "valid"))
    log(f"ism: card vs plain path on the CPU ({n} proposals), max |diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (atol {ISM_ATOL}); object ids, templates, valid equal: {same}")
    if max(errs.values()) > ISM_ATOL or not same:
        raise AssertionError("ISM card path disagrees with the plain CPU path")


def phase_ism(kernels_mod, cfg, job_dir, job, device="cuda"):
    """The ISM matching slice at the width of `cfg` (DINOv2-L in the smoke)
    on the synthetic job `job` in `job_dir` (onboarding, three frames of 128
    slots with 48 valid, the plain-path check, detection json -> `pem`
    CLI). Returns (launches per kernel on the matching path, on the `pem`
    run of its detections)."""
    import dataclasses
    import torch
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM
    from sam6d_torch.pipelines.ism import ISMPipeline, detections_to_bop_json

    att, fps, bq = kernels_mod
    counters = {"fused_attention_qkv_cuda": att.fused_attention_qkv_cuda,
                "farthest_point_sample_cuda": fps.farthest_point_sample_cuda,
                "two_scale_ball_query_cuda": bq.two_scale_ball_query_cuda}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    d = cfg.dinov2
    props = job["proposals"]
    n_valid, n_slots = int(props["valid"].sum()), len(props["valid"])
    cloud = (load_ply(job["cad"]).sample(cfg.matching.pointcloud_sample_num,
                                         np.random.RandomState(0))
             / 1000.0).astype(np.float32)[None]
    t1 = time.perf_counter()
    pipe = ISMPipeline(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"ism: DINOv2 (C={d.embed_dim}, {d.depth} blocks, {d.num_heads} heads) "
        f"random weights on the card in {t2 - t1:.1f} s")

    onboard = []
    for _ in range(2):                    # cold, then warm
        t0 = time.perf_counter()
        pipe.onboard_templates_from_dir(os.path.join(job_dir, "templates"))
        torch.cuda.synchronize()
        onboard.append(1e3 * (time.perf_counter() - t0))
    tem_imgs = torch.rand(42, d.img_size, d.img_size, 3, device=device)
    tem_masks = torch.ones(42, d.img_size, d.img_size, device=device)
    with torch.inference_mode():
        describe_tem = cuda_ms(lambda: pipe._describe_templates_impl(
            tem_imgs, tem_masks), reps=3)
    log(f"ism: onboarding 42 templates, wall ms (PNG read included): cold "
        f"{onboard[0]:.1f}, warm {onboard[1]:.1f}; template describe "
        f"(42 -> 48 crops) {describe_tem:.1f} ms on CUDA events")

    args = (job["rgb_arr"], job["depth_arr"], K_CAM, 1.0, cloud)
    kw = dict(detections=props, apply_size_filters=False)
    reset()
    result = pipe.match_frame(*args, **kw)
    torch.cuda.synchronize()
    match_launches = read()
    want = d.depth * -(-n_valid // d.chunk_size)
    log(f"ism: match_frame ({n_slots} slots, {n_valid} valid) kernel "
        f"launches {match_launches}")
    if match_launches["fused_attention_qkv_cuda"] != want:
        raise AssertionError(f"expected {want} fused attention launches")
    sel = result["valid"]
    if int(sel.sum()) != n_valid or not sel[:n_valid].all():
        raise AssertionError(f"expected the {n_valid} valid slots selected")
    for k in ("scores", "semantic_score", "appe_score", "geometric_score",
              "visible_ratio"):
        if result[k].shape != (n_slots,) or not np.isfinite(result[k][sel]).all():
            raise AssertionError(f"bad {k}")

    frame_ms = []
    for _ in range(3):
        reset()
        t0 = time.perf_counter()
        pipe.match_frame(*args, **kw)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if read()["fused_attention_qkv_cuda"] != want:
            raise AssertionError("fused attention launch count changed")
    dev = torch.device(device)
    with torch.inference_mode():
        rgb01 = torch.as_tensor(job["rgb_arr"], device=dev).float() / 255.0
        masks = torch.as_tensor(props["masks"], device=dev).float()
        boxes = torch.as_tensor(props["boxes"], device=dev)
        describe = cuda_ms(lambda: pipe._describe_impl(
            rgb01, masks, boxes.int(), n_valid), reps=3)
        describe_cap = cuda_ms(lambda: pipe._describe_impl(
            rgb01, masks, boxes.int(), n_slots), reps=3)
        depth = torch.as_tensor(job["depth_arr"], device=dev)
        Kt = torch.as_tensor(K_CAM, device=dev)
        ds = torch.tensor(np.float32(1.0), device=dev)
        cl = torch.as_tensor(cloud, device=dev)
        valid = torch.as_tensor(props["valid"], device=dev)
        ref = pipe.ref_data
        score = cuda_ms(lambda: pipe._score_frame_impl(
            rgb01, masks, boxes, valid, depth, Kt, ds, ref["descriptors"],
            ref["appe_descriptors"], ref["poses_R"], cl, n_valid, False),
            reps=3)
        score_nms = cuda_ms(lambda: pipe._score_frame_impl(
            rgb01, masks, boxes, valid, depth, Kt, ds, ref["descriptors"],
            ref["appe_descriptors"], ref["poses_R"], cl, n_valid, True),
            reps=3)
    rounds = pipe.last_nms_rounds
    log("ism: match_frame wall ms: " + ", ".join(f"{m:.1f}" for m in frame_ms)
        + f"; on CUDA events: describe of {n_valid} valid {describe:.1f} ms "
        f"(capacity {n_slots}: {describe_cap:.1f}), describe + scores "
        f"{score:.1f} ms, with per-object NMS {score_nms:.1f} ms "
        f"({rounds} rounds, {rounds + 1} device->host syncs)")

    device_busy(lambda: pipe.match_frame(*args, **kw), "ism: match_frame")
    check_ism_against_plain(pipe, job["rgb_arr"], job["depth_arr"], props, cloud)

    records = detections_to_bop_json(result)
    if len(records) != n_valid or min(r["score"] for r in records) <= 0:
        raise AssertionError("expected one record of positive score per valid slot")
    out_dir = os.path.join(job_dir, "sam6d_results")
    os.makedirs(out_dir, exist_ok=True)
    seg = os.path.join(out_dir, "detection_ism.json")
    with open(seg, "w") as f:
        json.dump(records, f)
    reset()
    t0 = time.perf_counter()
    cli_main(["pem", "--output_dir", job_dir, "--cad_path", job["cad"],
              "--rgb_path", job["rgb"], "--depth_path", job["depth"],
              "--cam_path", job["cam"], "--seg_path", seg,
              "--det_score_thresh", "0", "--device", device])
    torch.cuda.synchronize()
    pem_launches = read()
    log(f"ism -> pem: `pem` CLI on detection_ism.json ({len(records)} records) "
        f"in {time.perf_counter() - t0:.2f} s; kernel launches {pem_launches}")
    with open(os.path.join(out_dir, "detection_pem.json")) as f:
        poses = json.load(f)
    if len(poses) != len(records):
        raise AssertionError(f"{len(poses)} poses for {len(records)} records")
    for r in poses:
        R = np.asarray(r["R"], np.float64)
        if not (np.allclose(R @ R.T, np.eye(3), atol=1e-3)
                and np.isfinite(r["t"]).all() and np.isfinite(r["score"])):
            raise AssertionError(f"bad pose {r}")
    for name in ("farthest_point_sample_cuda", "two_scale_ball_query_cuda"):
        if pem_launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the pem run")
    log(f"ism -> pem: {len(poses)} poses, one per record, R R^T = I (atol 1e-3)")
    return match_launches, pem_launches


# ------------------------------------------------------------------ phase 6

SAM_KERNELS = ("flash_attention_relpos_cuda",) + tuple(n + "_cuda" for n in FACTORED)


def sam_counters():
    from sam6d_torch.kernels import attention_qkv, attention_relpos, factored
    fns = {"fused_attention_qkv_cuda": attention_qkv.fused_attention_qkv_cuda,
           "flash_attention_relpos_cuda": attention_relpos.flash_attention_relpos_cuda}
    fns.update({n + "_cuda": getattr(factored, n + "_cuda") for n in FACTORED})
    return fns


def reset_counts(fns):
    for fn in fns.values():
        fn.launches = 0


def read_counts(fns):
    return {k: fn.launches for k, fn in fns.items()}


def check_proposals(out, H0, W0, K):
    """The host proposals of generate_masks: K slots of finite masks in
    [0, 1] at the frame's size, boxes inside the frame, `valid` a prefix
    (the kept proposals come first) whose predicted IoU does not increase."""
    masks, boxes, valid, iou = out["masks"], out["boxes"], out["valid"], out["iou_preds"]
    n = int(valid.sum())
    if masks.shape != (K, H0, W0) or not np.isfinite(masks).all() \
            or masks.min() < 0 or masks.max() > 1:
        raise AssertionError(f"bad masks {masks.shape}")
    if boxes.shape != (K, 4) or not np.isfinite(boxes).all() or (boxes < 0).any() \
            or (boxes[:, [0, 2]] > W0 - 1).any() or (boxes[:, [1, 3]] > H0 - 1).any() \
            or (boxes[:, 2] < boxes[:, 0]).any() or (boxes[:, 3] < boxes[:, 1]).any():
        raise AssertionError("boxes outside the frame or inverted")
    if n < 1 or not valid[:n].all() or (np.diff(iou[:n]) > 0).any():
        raise AssertionError(f"valid is not a non-empty, IoU-sorted prefix: {valid}")
    return n


def sam_stage_times(seg, rgb):
    """CUDA-event split of one frame's segmentation: the encoder (windowed
    vs global blocks), the iou pass, the full decode of the prefix, NMS and
    the mask gather + resize."""
    import torch
    from sam6d_torch.pipelines.sam_amg import SAM_PIXEL_MEAN, SAM_PIXEL_STD, resize_logits
    resized, _, (hs, ws), (h_in, w_in) = seg.preprocess_frame_u8(rgb)
    Ry, Rx, pts = seg.frame_constants(hs, ws, h_in, w_in)
    u8 = torch.as_tensor(resized, device=seg.device)
    enc = seg.sam.image_encoder
    t = {}
    with torch.inference_mode():
        t["encoder"] = cuda_ms(lambda: seg._encode_u8(u8), reps=3)
        S = seg.cfg.img_size
        x = torch.nn.functional.pad(
            (u8.float() - torch.as_tensor(SAM_PIXEL_MEAN, device=seg.device))
            / torch.as_tensor(SAM_PIXEL_STD, device=seg.device),
            (0, 0, 0, S - w_in, 0, S - h_in))[None]
        x = enc.patch_embed(x) + enc.pos_embed
        t["windowed_blocks"] = t["global_blocks"] = 0.0
        for blk in enc.blocks:
            key = "windowed_blocks" if blk.window_size else "global_blocks"
            t[key] += cuda_ms(lambda: blk(x), reps=2)
            x = blk(x)
        emb = seg._encode_u8(u8)
        pe = seg.sam.prompt_encoder.dense_pe()
        t["iou_pass"] = cuda_ms(lambda: seg._iou_all_impl(emb, pe, pts), reps=3)
        pref = seg._prefix_points(emb, pe, pts)
        t["full_decode"] = cuda_ms(lambda: seg._score_all_impl(emb, pe, pref, Ry, Rx), reps=3)
        t["select"] = cuda_ms(lambda: seg._select_impl(emb, pe, pref, Ry, Rx), reps=3)
        order = seg._select_impl(emb, pe, pref, Ry, Rx)[4]
        lows = seg._score_all_impl(emb, pe, pref, Ry, Rx)[3]
        t["gather_resize"] = cuda_ms(lambda: resize_logits(lows[order], Ry, Rx) > 0, reps=5)
    t["nms"] = t["select"] - t["full_decode"] - t["gather_resize"]
    return t, seg.last_nms_rounds, pref.shape[0]


def check_sam_against_plain(rgb, cfg, fns):
    """The card against the port's plain CPU path on a cut of the segmentor:
    ViT-H width at depth 2 (one windowed, one global block) on the full
    1024^2 canvas, then the AMG tail on that embedding at 1024 prompts. Both
    sides score the card's prefix points, so the tail compares one to one.
    K1 (both kinds) and K2-K4 lie on the compared card path."""
    import dataclasses
    import torch
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor, resize_logits, stable_top_k
    cut = dataclasses.replace(cfg, encoder_depth=2, encoder_global_attn_indexes=(1,))
    t0 = time.perf_counter()
    seg_g = SAMSegmentor(cut, seed=SEED + 2, device="cuda")
    seg_c = SAMSegmentor(cut, state_dict={k: v.cpu() for k, v in seg_g.sam.state_dict().items()},
                         device="cpu")
    resized, _, (hs, ws), (h_in, w_in) = seg_g.preprocess_frame_u8(rgb)
    out = {}
    for name, seg in (("card", seg_g), ("cpu", seg_c)):
        Ry, Rx, pts = seg.frame_constants(hs, ws, h_in, w_in)
        if name == "card":
            reset_counts(fns)
        with torch.inference_mode():
            emb = seg._encode_u8(torch.as_tensor(resized, device=seg.device))
            pe = seg.sam.prompt_encoder.dense_pe()
            key = seg._iou_all_impl(emb, pe, pts)
            if name == "card":
                top = stable_top_k(key.max(dim=1).values, seg.prefix_length(len(pts)))
            sel_pts = pts[top.to(seg.device)]
            cand = seg._score_all_impl(emb, pe, sel_pts, Ry, Rx)
            sel = seg._select_impl(emb, pe, sel_pts, Ry, Rx)
            if name == "card":
                torch.cuda.synchronize()
                launches = read_counts(fns)
            logits = resize_logits(cand[3], Ry, Rx)
        out[name] = dict(emb=emb.cpu(), key=key.cpu(), iou=cand[0].cpu(), lows=cand[3].cpu(),
                         logits=logits.cpu(), masks=sel[0].cpu(), boxes=sel[1].cpu(),
                         valid=sel[2].cpu(), order=sel[4].cpu(),
                         top=stable_top_k(key.max(dim=1).values, len(top)).cpu())
    g, c = out["card"], out["cpu"]
    errs = {k: float((g[k] - c[k]).abs().max()) for k in ("emb", "key", "iou", "lows")}
    same_prefix = set(g["top"].tolist()) == set(c["top"].tolist())
    same_sel = torch.equal(g["order"], c["order"]) and torch.equal(g["valid"], c["valid"])
    # a kept mask may differ only where the card's logit is within SAM_ATOL of 0
    near = g["logits"][g["order"]].abs() < SAM_ATOL
    unexplained = int(((g["masks"] != c["masks"]) & ~near).sum())
    box_diff = [k for k in range(len(g["order"]))
                if not torch.equal(g["boxes"][k], c["boxes"][k])
                and bool((g["masks"][k] != c["masks"][k]).any())]
    boxes_ok = all(torch.equal(g["boxes"][k], c["boxes"][k])
                   for k in range(len(g["order"])) if k not in box_diff)
    log(f"sam: card vs plain CPU path (depth-2 ViT-H, 1024 prompts, prefix "
        f"{len(top)}) in {time.perf_counter() - t0:.1f} s: max |diff| embedding "
        f"{errs['emb']:.2e}, iou pass {errs['key']:.2e}, candidate IoU {errs['iou']:.2e}, "
        f"low-res logits {errs['lows']:.2e} (atol {SAM_ATOL}); same prefix set: "
        f"{same_prefix}; same kept slots and order: {same_sel}; "
        f"{int(g['valid'].sum())} kept; mask pixels differing away from a near-zero "
        f"logit: {unexplained}; slots whose box moved with a near-tie pixel: {box_diff}; "
        f"card launches {launches}")
    if max(errs.values()) > SAM_ATOL or not (same_prefix and same_sel and boxes_ok) \
            or unexplained:
        raise AssertionError("SAM card path disagrees with the plain CPU path")
    for name in SAM_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} is not on the compared card path")
    if launches["flash_attention_relpos_cuda"] != 2:
        raise AssertionError("expected one windowed and one global K1 launch")


def phase_sam(seg, ism_cfg, job_dir, job):
    """The SAM slice: SAMSegmentor.generate_masks on the job's frame, then
    ISMPipeline(segmentor=...).match_frame(detections=None), its records
    through the `pem` CLI. Returns the launches of generate_masks."""
    import torch
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM
    from sam6d_torch.pipelines.ism import ISMPipeline, detections_to_bop_json

    fns = sam_counters()
    cfg = seg.cfg
    rgb, depth = job["rgb_arr"], job["depth_arr"]
    H0, W0 = rgb.shape[:2]
    chunks = cfg.points_per_side ** 2 // cfg.points_per_batch
    want = {"flash_attention_relpos_cuda": cfg.encoder_depth}
    want.update({n + "_cuda": 2 * chunks for n in FACTORED})

    reset_counts(fns)
    t0 = time.perf_counter()
    out = seg.generate_masks(rgb)
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0)
    seg_launches = read_counts(fns)
    n_kept = check_proposals(out, H0, W0, cfg.max_proposals)
    log(f"sam: generate_masks on the {H0}x{W0} frame (ViT-H, {cfg.points_per_side ** 2} "
        f"prompts, capacity {cfg.max_proposals}) cold {cold_ms:.1f} ms; {n_kept} proposals "
        f"kept, NMS {seg.last_nms_rounds} rounds ({seg.last_nms_rounds + 1} device->host "
        f"syncs); kernel launches {seg_launches}")
    for name, n in want.items():
        if seg_launches[name] != n:
            raise AssertionError(f"{name}: {seg_launches[name]} launches, expected {n}")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        seg.generate_masks(rgb)
        walls.append(1e3 * (time.perf_counter() - t0))
    dev_ms = cuda_ms(lambda: seg.generate_masks_device(rgb), reps=3)
    t, rounds, pref = sam_stage_times(seg, rgb)
    log("sam: generate_masks wall ms: " + ", ".join(f"{m:.1f}" for m in walls)
        + f"; generate_masks_device on CUDA events {dev_ms:.1f} ms; split on CUDA events: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in t.items())
        + f" (prefix {pref} points, NMS {rounds} rounds)")
    device_busy(lambda: seg.generate_masks_device(rgb), "sam: generate_masks_device")
    check_sam_against_plain(rgb, cfg, fns)

    t0 = time.perf_counter()
    pipe = ISMPipeline(ism_cfg, seed=SEED, device="cuda", segmentor=seg)
    pipe.onboard_templates_from_dir(os.path.join(job_dir, "templates"))
    torch.cuda.synchronize()
    log(f"sam -> ism: DINOv2-L pipeline with the segmentor, onboarded in "
        f"{time.perf_counter() - t0:.1f} s")
    cloud = (load_ply(job["cad"]).sample(ism_cfg.matching.pointcloud_sample_num,
                                         np.random.RandomState(0)) / 1000.0
             ).astype(np.float32)[None]
    args = (rgb, depth, K_CAM, 1.0, cloud)
    kw = dict(detections=None, apply_size_filters=False)
    reset_counts(fns)
    result = pipe.match_frame(*args, **kw)
    torch.cuda.synchronize()
    match_launches = read_counts(fns)
    n_valid = int(result["valid"].sum())
    d = ism_cfg.dinov2
    want_k5 = d.depth * -(-n_kept // d.chunk_size)
    log(f"sam -> ism: match_frame(detections=None): {n_valid} of {cfg.max_proposals} "
        f"slots valid; kernel launches {match_launches}")
    if match_launches["fused_attention_qkv_cuda"] != want_k5 or any(
            match_launches[k] != n for k, n in want.items()):
        raise AssertionError(f"unexpected launches on match_frame (K5: {want_k5})")
    if n_valid < 1:
        raise AssertionError("no valid detection from the segmentor")
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.match_frame(*args, **kw)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    log("sam -> ism: match_frame(detections=None) frame wall ms: "
        + ", ".join(f"{m:.1f}" for m in frame_ms))
    device_busy(lambda: pipe.match_frame(*args, **kw), "sam -> ism: match_frame")

    records = detections_to_bop_json(result)
    out_dir = os.path.join(job_dir, "sam6d_results")
    os.makedirs(out_dir, exist_ok=True)
    seg_path = os.path.join(out_dir, "detection_ism.json")
    with open(seg_path, "w") as f:
        json.dump(records, f)
    t0 = time.perf_counter()
    cli_main(["pem", "--output_dir", job_dir, "--cad_path", job["cad"],
              "--rgb_path", job["rgb"], "--depth_path", job["depth"],
              "--cam_path", job["cam"], "--seg_path", seg_path,
              "--det_score_thresh", "-2", "--device", "cuda"])
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, "detection_pem.json")) as f:
        poses = json.load(f)
    if len(poses) != len(records):
        raise AssertionError(f"{len(poses)} poses for {len(records)} records")
    for r in poses:
        R = np.asarray(r["R"], np.float64)
        if not (np.allclose(R @ R.T, np.eye(3), atol=1e-3)
                and np.isfinite(r["t"]).all() and np.isfinite(r["score"])):
            raise AssertionError(f"bad pose {r}")
    log(f"sam -> ism -> pem: {len(records)} records, the `pem` CLI posed every one "
        f"(R R^T = I within 1e-3) in {time.perf_counter() - t0:.2f} s")
    return seg_launches


# ------------------------------------------------------------------ phase 7

# card vs the plain CPU render: float32 barycentric sums rounded in another
# order on the two devices; relative to the attribute (rgb in [0, 1], xyz in
# mm)
RENDER_RTOL = 1e-4
# the card's DINOv2-L descriptors with K8 against the same pipeline's plain
# matmul + softmax (use_flash off), both on the card
DESCRIBE_ATOL = 1e-4


ALL_FRAME_KERNELS = ("farthest_point_sample_cuda", "two_scale_ball_query_cuda",
                     "fused_attention_qkv_cuda") + SAM_KERNELS


def frame_counters():
    from sam6d_torch.kernels import attention, ball_query, fps
    fns = sam_counters()
    fns.update(farthest_point_sample_cuda=fps.farthest_point_sample_cuda,
               two_scale_ball_query_cuda=ball_query.two_scale_ball_query_cuda,
               fused_attention_cuda=attention.fused_attention_cuda,
               fused_attention_small_cuda=attention.fused_attention_small_cuda)
    return fns


def check_pose_records(poses, what):
    for r in poses:
        R = np.asarray(r["R"], np.float64)
        if not (np.allclose(R @ R.T, np.eye(3), atol=1e-3)
                and np.isfinite(r["t"]).all() and np.isfinite(r["score"])):
            raise AssertionError(f"{what}: bad pose {r}")


def phase_render(job):
    """The `render` CLI on the card: 42 views at 512^2 of the job's box,
    every mask non-empty; two views held to the port's plain CPU render."""
    from PIL import Image
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.render.poses import template_cam_poses
    from sam6d_torch.render.templates import RENDER_SIZE, render_view
    out = os.path.join(job["dir"], "rendered")
    t0 = time.perf_counter()
    cli_main(["render", "--cad_path", job["cad"], "--output_dir", out, "--device", "cuda"])
    render_s = time.perf_counter() - t0
    tdir = os.path.join(out, "templates")
    cover = [int((np.array(Image.open(os.path.join(tdir, f"mask_{i}.png"))) == 255).sum())
             for i in range(42)]
    if min(cover) == 0:
        raise AssertionError(f"empty template masks: {[i for i, c in enumerate(cover) if not c]}")
    mesh = load_ply(job["cad"])
    poses = template_cam_poses(0, radius=4.0 * float(
        np.linalg.norm(mesh.vertices.astype(np.float64), axis=1).max()))
    for i in (0, 21):
        g_attr, g_mask, _ = render_view(mesh, poses[i], RENDER_SIZE, device="cuda")
        c_attr, c_mask, _ = render_view(mesh, poses[i], RENDER_SIZE, device="cpu")
        rel = (np.abs(g_attr - c_attr) / np.maximum(1.0, np.abs(c_attr))).max(-1)
        ties = int((rel > RENDER_RTOL).sum())
        log(f"render: view {i} card vs plain CPU render: masks equal "
            f"{bool((g_mask == c_mask).all())} ({int(g_mask.sum())} px), max rel |diff| "
            f"{rel.max():.2e}, {ties} pixels beyond {RENDER_RTOL} (tie pixels)")
        if not (g_mask == c_mask).all() or ties > 0.01 * g_mask.sum():
            raise AssertionError("the card's render disagrees with the plain CPU render")
    log(f"render: `render` CLI wrote 42 views at {RENDER_SIZE}^2 in {render_s:.2f} s "
        f"(cold), mask pixels {min(cover)}-{max(cover)}")
    return tdir


def phase_demo(job, fns):
    """run_demo at full width (ViT-H SAM, DINOv2-L, PEM-base; seeded random
    weights, the AMG load pinned as bench.py pins it) on the job's frame:
    render -> ISM -> PEM, every output file, K1-K7 launched."""
    import torch
    from sam6d_torch.core.config import (Config, ISMConfig, ISMMatchingConfig,
                                         SAMConfig)
    from sam6d_torch.pipelines.demo import run_demo
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    cfg = Config(ism=ISMConfig(sam=SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                                             max_proposals=128),
                               matching=ISMMatchingConfig(confidence_thresh=-1.0)))
    out = os.path.join(job["dir"], "demo")
    orig = SAMSegmentor.generate_masks_device
    seg_ms = []

    def timed(self, image):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(self, image)
        torch.cuda.synchronize()
        seg_ms.append(1e3 * (time.perf_counter() - t0))
        return res

    SAMSegmentor.generate_masks_device = timed
    try:
        reset_counts(fns)
        res = run_demo(cfg, job["cad"], job["rgb"], job["depth"], job["cam"], out,
                       det_score_thresh=-1.0, stability_score_thresh=0.0, device="cuda",
                       seed=SEED)
        torch.cuda.synchronize()
        launches = read_counts(fns)
    finally:
        SAMSegmentor.generate_masks_device = orig
    files = ["templates/rgb_41.png", "sam6d_results/detection_ism.json",
             "sam6d_results/vis_ism.png", "sam6d_results/detection_pem.json"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    if missing or not res["pem"]:
        raise AssertionError(f"run_demo: missing {missing} or no pose")
    check_pose_records(res["pem"], "run_demo")
    split = dict(res["split_ms"])
    split["segmentation_ms"] = seg_ms[0]
    split["match_ms"] = split["ism_frame_ms"] - seg_ms[0]
    log(f"demo: run_demo wrote {files} (+vis_pem.png: "
        f"{os.path.exists(os.path.join(out, 'sam6d_results', 'vis_pem.png'))}); "
        f"{len(res['ism'])} ISM records, {len(res['pem'])} poses (R R^T = I within 1e-3); "
        f"split (wall ms, cold): " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; kernel launches {launches}")
    for name in ALL_FRAME_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on run_demo")
    return os.path.join(out, "templates")


def phase_stream(seg, ism_cfg, job, tdir, fns):
    """MultiObjectStream with two onboarded objects (the job's box and a
    second box of other extents) over 4 frames (the job's frame and 3 with
    the objects moved): synchronous process_frame on one stream, then
    process_stream(depth_in_flight=1) on a fresh one; the poses must agree."""
    import torch
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM, write_stream_frames
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMConfig, PEMPipeline
    from sam6d_torch.pipelines.streaming import MultiObjectStream
    from sam6d_torch.render.templates import render_templates
    cad2, _, frames = write_stream_frames(job["dir"], np.random.RandomState(SEED + 3))
    tdir2 = render_templates(load_ply(cad2), os.path.join(job["dir"], "obj2"), device="cuda")
    ism = ISMPipeline(ism_cfg, seed=SEED, device="cuda", segmentor=seg)
    pem_cfg = PEMConfig()
    pem = PEMPipeline(pem_cfg, seed=SEED, device="cuda")
    items = [(rgb, depth, K_CAM, 1.0) for rgb, depth in frames]

    def run(pipelined):
        stream = MultiObjectStream(ism, pem, det_score_thresh=-1.0)
        rng = np.random.RandomState(0)
        t0 = time.perf_counter()
        for i, (d, cad) in enumerate(((tdir, job["cad"]), (tdir2, cad2))):
            mesh = load_ply(cad)
            stream.onboard_object(
                i + 1, d, mesh.sample(pem_cfg.n_sample_model_point, rng) / 1000.0,
                ism_points=mesh.sample(ism_cfg.matching.pointcloud_sample_num, rng) / 1000.0)
        torch.cuda.synchronize()
        onboard_s = time.perf_counter() - t0
        reset_counts(fns)
        out = (list(stream.process_stream(iter(items), depth_in_flight=1)) if pipelined
               else [stream.process_frame(*it) for it in items])
        torch.cuda.synchronize()
        tp = stream.throughput()
        log(f"stream ({'pipelined, 1 in flight' if pipelined else 'synchronous'}): onboarding "
            f"2 objects {onboard_s:.2f} s; {len(out)} frames, poses per frame "
            f"{[len(r['poses']) for r in out]}; throughput {tp}; last frame host split "
            + ", ".join(f"{k} {v:.1f}" for k, v in stream.last_timing.items())
            + f"; kernel launches {read_counts(fns)}")
        return out, tp

    sync, tp_sync = run(False)
    pipe, tp_pipe = run(True)
    n_poses = 0
    for a, b in zip(pipe, sync):
        if len(a["poses"]) != len(b["poses"]):
            raise AssertionError("pipelined and synchronous streams posed different detections")
        for pa, pb in zip(a["poses"], b["poses"]):
            if not (pa["object_id"] == pb["object_id"]
                    and np.allclose(pa["R"], pb["R"], atol=1e-5, rtol=0)
                    and np.allclose(pa["t"], pb["t"], atol=1e-3, rtol=0)):
                raise AssertionError(f"pipelined pose differs: {pa} vs {pb}")
        check_pose_records(a["poses"], "stream")
        n_poses += len(a["poses"])
    if len(pipe) != len(items) or n_poses < 1:
        raise AssertionError("the stream posed nothing")
    log(f"stream: pipelined poses equal the synchronous ones over {len(items)} frames, "
        f"{n_poses} poses (R atol 1e-5, t atol 1e-3 mm); ms per frame synchronous "
        f"{tp_sync['ms_per_frame']} vs pipelined {tp_pipe['ms_per_frame']}")


def phase_describe_448(job, fns):
    """ISM at DINOv2Config(img_size=448), full DINOv2-L width: one 16-crop
    describe chunk, every attention of 1025 tokens through K8 (24
    launches), held to the same pipeline with use_flash off on the card."""
    import torch
    from sam6d_torch.core.config import DINOv2Config, ISMConfig
    from sam6d_torch.pipelines.ism import ISMPipeline
    pipe = ISMPipeline(ISMConfig(dinov2=DINOv2Config(img_size=448)), seed=SEED, device="cuda")
    props = job["proposals"]
    n = pipe.cfg.dinov2.chunk_size
    with torch.inference_mode():
        rgb01 = torch.as_tensor(job["rgb_arr"], device="cuda").float() / 255.0
        masks = torch.as_tensor(props["masks"][:n], device="cuda").float()
        boxes = torch.as_tensor(props["boxes"][:n], device="cuda").int()
        reset_counts(fns)
        cls, patch = pipe._describe_impl(rgb01, masks, boxes, n)
        torch.cuda.synchronize()
        launches = read_counts(fns)
        ms = cuda_ms(lambda: pipe._describe_impl(rgb01, masks, boxes, n), reps=3)
        for blk in pipe.dinov2.blocks:
            blk.attn.use_flash = False
        try:
            cls_p, patch_p = pipe._describe_impl(rgb01, masks, boxes, n)
            plain_ms = cuda_ms(lambda: pipe._describe_impl(rgb01, masks, boxes, n), reps=3)
        finally:
            for blk in pipe.dinov2.blocks:
                blk.attn.use_flash = True
    err = max(float((cls - cls_p).abs().max()), float((patch - patch_p).abs().max()))
    log(f"describe 448: {n} crops of 1025 tokens, kernel launches {launches}; descriptors "
        f"vs use_flash off on the card: max |diff| {err:.2e} (atol {DESCRIBE_ATOL}); "
        f"describe {ms:.1f} ms with K8, {plain_ms:.1f} ms with the plain attention "
        f"(CUDA events)")
    if launches["fused_attention_cuda"] != pipe.cfg.dinov2.depth \
            or launches["fused_attention_qkv_cuda"] != 0:
        raise AssertionError("expected one K8 launch per DINOv2 block and no K5")
    if not err <= DESCRIBE_ATOL:
        raise AssertionError("the 448 describe disagrees with its plain attention")
    return launches


def phase_frame(seg, ism_cfg, job):
    """Phase 7: the frame through the port's entry points, at full width.
    Returns the launches of the 448 describe."""
    import torch
    fns = frame_counters()
    tdir = phase_render(job)
    torch.cuda.empty_cache()
    phase_demo(job, fns)
    torch.cuda.empty_cache()
    phase_stream(seg, ism_cfg, job, tdir, fns)
    torch.cuda.empty_cache()
    return phase_describe_448(job, fns)


# ------------------------------------------------------------------ phase 8

BOP_DATASET = "lmo"
BOP_FRAMES = 2


class timed_calls:
    """Within the block, every call of `cls.name` (a method, or a function of
    a module) is timed (wall ms, the card synchronized before and after)
    into `self.ms`, with the launch counts of `fns` it made into
    `self.launches`; `self.calls` holds (first argument, other arguments)
    of each."""

    def __init__(self, cls, name, fns=None, device="cuda"):
        self.cls, self.name, self.fns, self.device = cls, name, fns or {}, device
        self.ms, self.launches, self.calls = [], [], []

    def _sync(self):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)
        rec = self

        def wrapper(inst, *args, **kwargs):
            rec._sync()
            before = read_counts(rec.fns)
            t0 = time.perf_counter()
            out = orig(inst, *args, **kwargs)
            rec._sync()
            rec.ms.append(1e3 * (time.perf_counter() - t0))
            after = read_counts(rec.fns)
            rec.launches.append({k: after[k] - before[k] for k in after})
            rec.calls.append((inst, args))
            return out

        setattr(self.cls, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def bop_config():
    """default_config() with the AMG and ISM loads pinned as bench.py pins
    them (random weights make SAM's predicted IoU and the semantic scores
    meaningless): ViT-H SAM, DINOv2-L, PEM-base at full width."""
    from sam6d_torch.core.config import (Config, ISMConfig, ISMMatchingConfig,
                                         SAMConfig)
    return Config(ism=ISMConfig(sam=SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                                              max_proposals=128),
                                matching=ISMMatchingConfig(confidence_thresh=-1.0)))


def check_bop_launches(ism_frames, ism_total, pem_total, paths):
    """K1 32 and K2-K4 16 times a BOP frame, K5 on the ISM stage, K6 and K7
    on the PEM stage, K7's cluster path at the PEM onboarding."""
    for i, per in enumerate(ism_frames):
        want = {"flash_attention_relpos_cuda": 32, "factored_ln_stats_cuda": 16,
                "factored_t2i_attention_cuda": 16, "factored_i2t_scores_cuda": 16}
        bad = {k: per[k] for k, n in want.items() if per[k] != n}
        if bad or per["fused_attention_qkv_cuda"] < 1:
            raise AssertionError(f"bop-eval ISM frame {i}: launches {per}, expected {want} "
                                 "and K5 > 0")
    if ism_total["fused_attention_qkv_cuda"] <= sum(
            f["fused_attention_qkv_cuda"] for f in ism_frames):
        raise AssertionError("K5 was not launched at the PBR onboarding")
    for k in ("farthest_point_sample_cuda", "two_scale_ball_query_cuda"):
        if pem_total[k] < 1:
            raise AssertionError(f"{k} was not launched on the bop-eval PEM stage")
    if "cluster" not in paths:
        raise AssertionError(f"K7's cluster path was not taken at onboarding: {paths}")


def check_bop_outputs(job, troot, out, frames):
    """The files exist; the ISM records parse (BOP-23: ids, xywh box, RLE at
    the frame's size, finite score); the BOP19 rows parse, R orthonormal
    and t.z inside the frame's depth range widened by the largest object
    radius (an object's centre lies at most that far behind its visible
    surface). Returns (records, rows)."""
    from sam6d_torch.data.rle import rle_decode_coco
    for oid in job["obj_ids"]:
        d = os.path.join(troot, BOP_DATASET, f"obj_{oid:06d}")
        names = set(os.listdir(d))
        want = {f"{n}_{i}.{e}" for i in range(42) for n, e in (("rgb", "png"),
                                                               ("mask", "png"), ("xyz", "npy"))}
        if names != want:
            raise AssertionError(f"render-bop wrote {sorted(names - want)} and missed "
                                 f"{sorted(want - names)} in {d}")
    paths = [os.path.join(out, n) for n in (f"ism_{BOP_DATASET}.json", "descriptors_pbr.npz",
                                            f"sam6dtpu_{BOP_DATASET}-test.csv")]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"bop-eval did not write {missing}")
    with open(paths[0]) as f:
        records = json.load(f)
    H, W = frames[0]["depth"].shape
    for r in records:
        m = rle_decode_coco(r["segmentation"])
        if not (r["scene_id"] == 1 and r["image_id"] in range(BOP_FRAMES)
                and r["category_id"] in job["obj_ids"] and len(r["bbox"]) == 4
                and np.isfinite(r["score"]) and m.shape == (H, W) and m.any()):
            raise AssertionError(f"bad ISM record {dict(r, segmentation='...')}")
    if not records:
        raise AssertionError("bop-eval ISM wrote no record")
    with open(paths[2]) as f:
        lines = f.read().splitlines()
    if lines[0] != "scene_id,im_id,obj_id,score,R,t,time":
        raise AssertionError(f"bad BOP19 header {lines[0]}")
    r_mm = max(0.5 * float(v) for v in job["diameters"])
    rows = []
    for line in lines[1:]:
        scene, im, obj, score, R, t, secs = line.split(",")
        R = np.array(R.split(), float).reshape(3, 3)
        t = np.array(t.split(), float)
        depth = frames[int(im)]["depth"]
        lo, hi = depth[depth > 0].min() - r_mm, depth.max() + r_mm
        if not (int(scene) == 1 and int(obj) in job["obj_ids"]
                and np.allclose(R @ R.T, np.eye(3), atol=1e-3) and np.isfinite(float(score))
                and t.shape == (3,) and lo <= t[2] <= hi and float(secs) >= 0):
            raise AssertionError(f"bad BOP19 row {line} (t.z range {lo:.0f}-{hi:.0f} mm)")
        rows.append(line)
    return records, rows


def phase_bop(job_root, device="cuda"):
    """Phase 8: the BOP evaluation path through the CLI at full width on a
    write_bop_job tree (lmo's layout, two boxes, 2 test frames at 480x640,
    a train_pbr scene, 16 detections a frame): `render-bop` (2 objects x 42
    views at 512^2), `bop-eval --stage ism --onboarding pbr` (ViT-H SAM,
    DINOv2-L), `bop-eval --stage pem` on the job's detections (PEM-base, 16
    instances a frame); launches read around each stage, one PEM chunk held
    to the plain CPU path. Returns {kernel: launches} of the two stages."""
    import torch
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.core import config as port_config
    from sam6d_torch.data.bop import discover_test_scenes
    from sam6d_torch.data.synthetic import write_bop_job
    from sam6d_torch.kernels import fps
    import sam6d_torch.pipelines.bop_eval as bop_eval
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMPipeline

    root = os.path.join(job_root, "bop")
    t0 = time.perf_counter()
    job = write_bop_job(root, np.random.RandomState(SEED + 5), n_test_frames=BOP_FRAMES)
    with open(os.path.join(root, "models", "models_info.json")) as f:
        job["diameters"] = [v["diameter"] for v in json.load(f).values()]
    frames = [discover_test_scenes(root)[0].load_frame(i) for i in range(BOP_FRAMES)]
    log(f"bop: write_bop_job ({len(job['obj_ids'])} objects, {BOP_FRAMES} test frames at "
        f"{frames[0]['depth'].shape}, {len(job['dets'])} detections) in "
        f"{time.perf_counter() - t0:.1f} s")
    fns = frame_counters()
    troot, out = os.path.join(root, "templates"), os.path.join(root, "out")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    reset_counts(fns)
    t0 = time.perf_counter()
    cli_main(["render-bop", "--dataset_dir", root, "--dataset_name", BOP_DATASET,
              "--output_dir", troot, "--device", device])
    sync()
    render_s = time.perf_counter() - t0

    common = ["bop-eval", "--dataset_dir", root, "--dataset_name", BOP_DATASET,
              "--template_dir", troot, "--output_dir", out, "--device", device]
    orig_cfg = port_config.default_config
    port_config.default_config = bop_config
    paths = []
    orig_path = fps.fps_path

    def recorded_path(n):
        paths.append(orig_path(n))
        return paths[-1]

    try:
        reset_counts(fns)
        t0 = time.perf_counter()
        with timed_calls(ISMPipeline, "onboard_bop_objects_pbr", fns, device) as onb, \
                timed_calls(ISMPipeline, "match_frame", fns, device) as frm, \
                timed_calls(bop_eval, "run_ism_bop_eval", device=device) as ism_drv:
            cli_main(common + ["--stage", "ism", "--onboarding", "pbr",
                               "--max_frames", str(BOP_FRAMES)])
        sync()
        ism_s = time.perf_counter() - t0
        ism_total = read_counts(fns)

        reset_counts(fns)
        fps.fps_path = recorded_path
        t0 = time.perf_counter()
        with timed_calls(PEMPipeline, "onboard_templates", fns, device) as pon, \
                timed_calls(PEMPipeline, "infer_batch", fns, device) as inf, \
                timed_calls(bop_eval, "run_pem_bop_eval", device=device) as pem_drv:
            cli_main(common + ["--stage", "pem", "--seg_path", job["seg_path"]])
        sync()
        pem_s = time.perf_counter() - t0
        pem_total = read_counts(fns)
    finally:
        port_config.default_config = orig_cfg
        fps.fps_path = orig_path

    records, rows = check_bop_outputs(job, troot, out, frames)
    n_obj = len(job["obj_ids"])
    log(f"bop: `render-bop` CLI, {n_obj} objects x 42 views at 512^2 in {render_s:.2f} s "
        f"({1e3 * render_s / n_obj:.0f} ms an object, cold)")
    log(f"bop: `bop-eval --stage ism --onboarding pbr` in {ism_s:.2f} s (cold: ViT-H + "
        f"DINOv2-L set-up), run_ism_bop_eval {ism_drv.ms[0]:.1f} ms; PBR onboarding {onb.ms[0]:.1f} ms ({onb.ms[0] / n_obj:.1f} ms an "
        f"object); ISM frame wall ms {', '.join(f'{m:.1f}' for m in frm.ms)}; "
        f"{len(records)} records; launches per frame {frm.launches}; stage {ism_total}")
    csv_s = [float(r.rsplit(",", 1)[1]) for r in rows]
    per_frame = [max(s for s, r in zip(csv_s, rows) if int(r.split(",")[1]) == i)
                 for i in range(BOP_FRAMES)]
    log(f"bop: `bop-eval --stage pem` in {pem_s:.2f} s (cold: PEM-base set-up), "
        f"run_pem_bop_eval {pem_drv.ms[0]:.1f} ms; onboarding "
        f"ms an object {', '.join(f'{m:.1f}' for m in pon.ms)}; infer_batch wall ms "
        f"{', '.join(f'{m:.1f}' for m in inf.ms)} at B={[int(c[1][0]['rgb'].shape[0]) for c in inf.calls]}; "
        f"BOP19 time column a frame (s) {', '.join(f'{s:.4f}' for s in per_frame)}; {len(rows)} rows "
        f"(R R^T = I within 1e-3, t.z inside the depth range); launches {pem_total}; "
        f"FPS paths {sorted(set(paths))}")
    check_bop_launches(frm.launches, ism_total, pem_total, paths)
    if len(rows) != len(job["dets"]):
        raise AssertionError(f"{len(rows)} BOP19 rows for {len(job['dets'])} detections")
    pem, (inputs, *_) = inf.calls[0]
    check_against_plain(pem, {k: v[:2] for k, v in inputs.items()})
    return dict(ism_frame=frm.launches[0], ism_stage=ism_total, pem_stage=pem_total), \
        frames[0]["rgb"], job


# ------------------------------------------------------------------ phase 9

# card vs the plain CPU decode of one prompt from the same embedding: the
# two-way transformer and the upscaling summed in another order
PREDICTOR_ATOL = 1e-3

def phase_predictor(seg, rgb, job, device="cuda"):
    """Phase 9: SAMPredictor on the ViT-H segmentor: set_image on a BOP frame
    (K1 32 times), a point, a box and a mask-fed prompt, each decode held
    to the CPU decode of the same embedding. Returns set_image's launches."""
    import copy
    import types
    import torch
    from sam6d_torch.pipelines.predictor import SAMPredictor, decode_prompts
    fns = frame_counters()
    pred = SAMPredictor(seg)
    reset_counts(fns)
    t0 = time.perf_counter()
    pred.set_image(rgb)
    if device == "cuda":
        torch.cuda.synchronize()
    set_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(fns)
    det = job["dets"][0]
    x, y, w, h = det["bbox"]
    point = dict(point_coords=np.array([[x + w / 2.0, y + h / 2.0]]), point_labels=np.array([1]))
    box = dict(box=np.array([x, y, x + w, y + h], np.float32))
    first = pred.predict(**point, multimask_output=False)
    prompts = [("point", point), ("box", box),
               ("point + mask input", dict(point, mask_input=first[2],
                                           multimask_output=False))]
    cpu_sam = types.SimpleNamespace(
        prompt_encoder=copy.deepcopy(seg.sam.prompt_encoder).cpu(),
        mask_decoder=copy.deepcopy(seg.sam.mask_decoder).cpu())
    emb_cpu = pred.embedding.cpu()
    report = []
    for name, kw in prompts:
        t0 = time.perf_counter()
        masks, iou, low = pred.predict(**kw)
        ms = 1e3 * (time.perf_counter() - t0)
        args = {k: v for k, v in kw.items() if k != "multimask_output"}
        tens = pred.prompt_tensors(**args)
        got = decode_prompts(seg.sam, pred.embedding, **tens)
        want = decode_prompts(cpu_sam, emb_cpu, **{k: None if v is None else v.cpu()
                                                   for k, v in tens.items()})
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        report.append(f"{name}: {ms:.1f} ms, masks {tuple(masks.shape)} ({int(masks.sum())} px), "
                      f"iou {np.round(iou, 3).tolist()}, card vs CPU decode max |diff| {err:.2e}")
        if not (np.isfinite(iou).all() and np.isfinite(low).all() and err <= PREDICTOR_ATOL):
            raise AssertionError(f"predictor {name}: card decode disagrees with the CPU "
                                 f"decode ({err:.2e} > {PREDICTOR_ATOL}) or is not finite")
    log(f"predictor: set_image {set_ms:.1f} ms (wall, the ViT-H embedding), launches "
        f"{launches}; " + "; ".join(report) + f" (atol {PREDICTOR_ATOL})")
    if launches["flash_attention_relpos_cuda"] != 32:
        raise AssertionError("set_image did not launch K1 32 times")
    return launches


# ----------------------------------------------------------------- phase 10

TRAIN_STEPS = 4
TRAIN_LOADER_THREADS = 2
TRAIN_CHECK_BATCH = 2
# card vs the plain CPU path through one PEM-base training step at batch 2,
# from the same weights, batch and pose-noise draws: the loss terms and the
# BatchNorm running statistics within TRAIN_ATOL (as the other card-vs-CPU
# checks); each gradient within TRAIN_GRAD_REL of its tensor's largest |g|
# (the backward through 12 ViT-B and 3 + 3 matching blocks sums in another
# order on the two devices; the tiny CPU parity test against JAX sees 1.6e-4
# of scale at 1 + 1 blocks), plus TRAIN_GRAD_FLOOR for gradients that are 0
# in exact arithmetic (a key bias under the softmax). An argmax metric
# (accuracy, foreground count and distance) may move only through rows
# whose two best similarities lie within NEAR_TIE on the CPU.
TRAIN_ATOL = 1e-3
TRAIN_GRAD_REL = 1e-2
TRAIN_GRAD_FLOOR = 1e-6
NEAR_TIE = 1e-3
# The step's clouds differ between the card and the CPU in their last bits
# (the template cloud is divided by a radius, the observed one posed by a
# matmul), so the discrete picks on them may break a near-tie differently:
# an FPS step (the sampled cloud then holds the same points in another
# order, every similarity column moves with its point and the argmax
# indices differ where the predictions do not), a structure-embedding
# neighbour (a whole row of the embedding changes, and with it proj_a's
# gradient), a ball-query candidate at the radius. The CPU step therefore
# takes the card's picks (replayed_picks), each held first against the
# CPU's own input: FPS may part from the CPU's picks only at a step whose
# two candidates' squared distances to the common prefix lie within
# REPLAY_TIE of the cloud's largest |p|^2; a neighbour list or a ball-query
# list may hold, or lack, only points whose squared distance lies that
# close to the k-th nearest one's or to r^2 (fp32 rounding of inputs that
# differ in their last bits; a wrong pick is off by orders of magnitude
# more). The clouds themselves must agree within REPLAY_TIE of their
# largest |p|.
REPLAY_TIE = 1e-5


def train_config():
    """default_config() with a log line at every step: PEM-base, the
    reference batch (28), remat off."""
    from sam6d_torch.core.config import Config, TrainConfig
    return Config(train=TrainConfig(log_every=1))


def check_training_templates(root, gso_ids):
    """render-training's two views an object: the files, non-empty masks,
    xyz inside the unit NOCS ball on the mask and 0 off it."""
    from PIL import Image
    for gso_id in gso_ids:
        d = os.path.join(root, "MegaPose-GSO", "templates", gso_id)
        want = {f"{n}_{i}.{e}" for i in range(2)
                for n, e in (("rgb", "png"), ("mask", "png"), ("xyz", "npy"))}
        if set(os.listdir(d)) != want:
            raise AssertionError(f"render-training wrote {sorted(os.listdir(d))} in {d}")
        for i in range(2):
            m = np.array(Image.open(os.path.join(d, f"mask_{i}.png"))) == 255
            xyz = np.load(os.path.join(d, f"xyz_{i}.npy")).astype(np.float32)
            r = np.linalg.norm(xyz, axis=-1)
            if m.sum() < 1000 or r[m].max() > 1.0 + 1e-3 or np.abs(xyz[~m]).max() > 0:
                raise AssertionError(f"{d} view {i}: {int(m.sum())} mask pixels, |xyz| up to "
                                     f"{r[m].max():.4f} on the mask")


class recorded_losses:
    """Within the block, the attentions the trainer hands
    compute_correspondence_loss are kept (detached) by prefix."""

    def __enter__(self):
        import sam6d_torch.train.trainer as trainer_mod
        self.mod, self.orig = trainer_mod, trainer_mod.compute_correspondence_loss
        self.attens = {}

        sig = inspect.signature(self.orig)

        def wrapper(attens, *args, **kwargs):
            bound_args = sig.bind(attens, *args, **kwargs)
            bound_args.apply_defaults()
            self.attens[bound_args.arguments["prefix"]] = [a.detach() for a in attens]
            return self.orig(attens, *args, **kwargs)

        trainer_mod.compute_correspondence_loss = wrapper
        return self

    def __exit__(self, *exc):
        self.mod.compute_correspondence_loss = self.orig


def _cloud_scale(pts):
    """The largest |p|^2 of a (N, 3) float64 cloud: the unit of REPLAY_TIE."""
    return float((pts * pts).sum(-1).max())


def _check_fps_replay(pts, valid, card, own):
    """pts (B, N, 3) float64, valid (B, N) bool or None, card / own
    (B, npoint) picks. Where the card's picks part from the CPU's own, the
    first step that parts must be a near-tie on the CPU's cloud: the two
    candidates' squared distances to the common prefix within REPLAY_TIE of
    the cloud's scale. Returns the gaps found, in that unit."""
    import torch
    gaps = []
    for b in range(pts.shape[0]):
        diff = (card[b] != own[b]).nonzero()
        if not len(diff):
            continue
        k = int(diff[0])
        md = torch.cdist(pts[b], pts[b, own[b, :k].long()]).amin(dim=1) ** 2
        if valid is not None:
            md = torch.where(valid[b], md, torch.full_like(md, -1.0))
        scale = _cloud_scale(pts[b])
        gap = abs(float(md[int(card[b, k])] - md[int(own[b, k])])) / scale
        if gap > REPLAY_TIE:
            raise AssertionError(f"training step: the card's FPS picks point {int(card[b, k])} "
                                 f"at step {k} of cloud {b} where the CPU picks "
                                 f"{int(own[b, k])}; their distances differ by {gap:.2e} of "
                                 f"the cloud's |p|^2, above {REPLAY_TIE}")
        gaps.append(gap)
    return gaps


def _check_ball_query_replay(xyz, new_xyz, radius, card, own):
    """xyz (B, N, 3) and new_xyz (B, M, 3) float64, card / own (B, M, S)
    lists of one scale. A row whose lists differ must hold every CPU hit
    (|d^2 - r^2| above REPLAY_TIE of the cloud's scale) below its last index
    and no candidate outside the radius by that margin. Returns the rows
    that differ."""
    import torch
    rows = (card != own).any(dim=2).nonzero().tolist()
    N, S = xyz.shape[1], card.shape[2]
    for b, q in rows:
        tol = REPLAY_TIE * _cloud_scale(torch.cat([xyz[b], new_xyz[b]]))
        d2 = ((xyz[b] - new_xyz[b, q]) ** 2).sum(-1) - radius * radius
        hits = torch.unique(card[b, q].long())
        cut = int(hits.max()) + 1 if len(hits) == S else N
        inside = (d2[:cut] < -tol).nonzero()[:, 0]
        if bool((d2[hits] > tol).any()) or not bool(torch.isin(inside, hits).all()):
            raise AssertionError(f"training step: the card's ball query (r {radius}) for query "
                                 f"{q} of cloud {b} differs from the CPU's beyond a near-tie "
                                 f"at the radius: {card[b, q].tolist()} vs {own[b, q].tolist()}")
    return len(rows)


def _check_knn_replay(pts, card, own):
    """pts (B, N, 3) float64, card / own (B, N, k + 1) nearest-neighbour
    lists. A row whose lists differ must hold every point nearer than the
    (k + 1)-th nearest by more than REPLAY_TIE of the cloud's scale and none
    farther by that margin. Returns the rows that differ."""
    import torch
    rows = (card != own).any(dim=2).nonzero().tolist()
    for b, i in rows:
        tol = REPLAY_TIE * _cloud_scale(pts[b])
        d2 = ((pts[b] - pts[b, i]) ** 2).sum(-1)
        last = d2.sort().values[card.shape[2] - 1]
        sel = card[b, i].long()
        if bool((d2[sel] > last + tol).any()) or \
                not bool(torch.isin((d2 < last - tol).nonzero()[:, 0], sel).all()):
            raise AssertionError(f"training step: the card's nearest neighbours of point {i} "
                                 f"of cloud {b} differ from the CPU's beyond a near-tie: "
                                 f"{card[b, i].tolist()} vs {own[b, i].tolist()}")
    return len(rows)


class replayed_picks:
    """Within the block, FPS, the structure embedding's nearest neighbours
    and the fine stage's ball query record their inputs and picks (mode
    "record") or, on the CPU (mode "replay"), compute their own picks, hold
    the recorded ones against them (_check_fps_replay, _check_knn_replay,
    _check_ball_query_replay) and return the recorded ones. `report` counts
    what parted."""

    def __init__(self, mode, calls=None):
        self.mode, self.calls = mode, [] if calls is None else calls
        self.report = dict(fps_calls_parted=0, fps_gaps=[], knn_rows_parted=0,
                           ball_query_rows_parted=0)

    def __enter__(self):
        import torch
        from sam6d_torch.models import fine_matching, geo_transformer
        from sam6d_torch.ops import sampling
        self.patched = [(sampling, "farthest_point_sample", sampling.farthest_point_sample),
                        (fine_matching, "two_scale_ball_query",
                         fine_matching.two_scale_ball_query),
                        (geo_transformer, "nearest_neighbours",
                         geo_transformer.nearest_neighbours)]
        orig_fps, orig_bq, orig_knn = (orig for _, _, orig in self.patched)
        it = iter(self.calls)

        def keep(kind, clouds, picks):
            """Records the card's call (mode "record"); else returns the
            card's picks after holding its clouds to the CPU's."""
            clouds = tuple(c.detach().double().cpu() for c in clouds)
            if self.mode == "record":
                self.calls.append((kind, clouds, picks))
                return None, clouds
            card_kind, card_clouds, card = next(it)
            scale = max(_cloud_scale(c.reshape(-1, 3)) for c in clouds) ** 0.5
            if card_kind != kind or any(float((a - b).abs().max()) > REPLAY_TIE * scale
                                        for a, b in zip(card_clouds, clouds)):
                raise AssertionError(f"training step: {kind} on the CPU got other clouds "
                                     f"than on the card")
            return card, clouds

        def fps(points, npoint, valid_mask=None):
            own = orig_fps(points, npoint, valid_mask)
            card, (pts,) = keep("FPS", (points,), own.cpu())
            if card is None:
                return own
            gaps = _check_fps_replay(pts, None if valid_mask is None
                                     else valid_mask.to(torch.bool), card, own)
            self.report["fps_calls_parted"] += bool(gaps)
            self.report["fps_gaps"] += gaps
            return card

        def knn(points, k):
            own = orig_knn(points, k)
            card, (pts,) = keep("nearest neighbours", (points,), own.cpu())
            if card is None:
                return own
            self.report["knn_rows_parted"] += _check_knn_replay(pts, card, own)
            return card

        def bq(xyz, new_xyz, r1, s1, r2, s2):
            own = orig_bq(xyz, new_xyz, r1, s1, r2, s2)
            card, (x, nx) = keep("ball query", (xyz, new_xyz), [o.cpu() for o in own])
            if card is None:
                return own
            for radius, c, o in zip((r1, r2), card, own):
                self.report["ball_query_rows_parted"] += _check_ball_query_replay(
                    x, nx, radius, c, o)
            return tuple(card)

        sampling.farthest_point_sample, fine_matching.two_scale_ball_query = fps, bq
        geo_transformer.nearest_neighbours = knn
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.patched:
            setattr(mod, name, orig)


def check_step_against_plain(cfg, batch):
    """One training step on the card against the same step on the plain CPU
    path (the kernels' plain versions, CPU GEMMs) at batch
    TRAIN_CHECK_BATCH: the same seeded weights, batch and pose-noise draws,
    the CPU taking the card's FPS picks, nearest neighbours and ball-query
    lists where they part from its own at a near-tie (replayed_picks). Compares the loss terms,
    the argmax metrics, every gradient and the BatchNorm running statistics
    after the step; returns a report."""
    import torch
    from sam6d_torch.train.trainer import PEMTrainer, draw_pose_noise
    b = {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()}
    noise = draw_pose_noise(TRAIN_CHECK_BATCH, torch.Generator().manual_seed(SEED))
    runs, picks = {}, []
    for dev in ("cuda", "cpu"):
        trainer = PEMTrainer(cfg, seed=SEED, device=dev)
        state = trainer.init_state()
        t0 = time.perf_counter()
        with recorded_losses() as rec, \
                replayed_picks("record" if dev == "cuda" else "replay", picks) as rep:
            state, metrics = trainer.step(state, {k: v.to(dev) for k, v in b.items()},
                                          noise=noise)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = dict(state=state, metrics={k: float(v) for k, v in metrics.items()},
                         attens={k: [a.cpu() for a in v] for k, v in rec.attens.items()},
                         s=time.perf_counter() - t0)
    card, cpu = runs["cuda"], runs["cpu"]
    loss_err = max(abs(card["metrics"][k] - cpu["metrics"][k])
                   for k in cpu["metrics"] if "loss" in k)
    if loss_err > TRAIN_ATOL:
        raise AssertionError(f"training step: card loss terms differ from the CPU's by "
                             f"{loss_err:.2e} > {TRAIN_ATOL}: {card['metrics']} vs {cpu['metrics']}")
    flips, metric_err = {}, 0.0
    for prefix, atts in cpu["attens"].items():
        last_cpu, last_card = atts[-1][:, 1:, :], card["attens"][prefix][-1][:, 1:, :]
        diff = last_cpu.argmax(dim=2) != last_card.argmax(dim=2)
        top2 = last_cpu.topk(2, dim=2).values
        gap = top2[..., 0] - top2[..., 1]
        if (diff & (gap >= NEAR_TIE)).any():
            raise AssertionError(f"training step: {prefix} predictions differ from the CPU's "
                                 f"at rows whose best two similarities are {NEAR_TIE} apart")
        flips[prefix] = int(diff.sum())
        if not flips[prefix]:
            for k in (f"{prefix}_acc", f"{prefix}_fg_num", f"{prefix}_dis"):
                metric_err = max(metric_err, abs(card["metrics"][k] - cpu["metrics"][k]))
    if metric_err > TRAIN_ATOL:
        raise AssertionError(f"training step: argmax metrics differ by {metric_err:.2e}")
    grad_rel, worst, tiny = 0.0, "", []
    cpu_params = dict(cpu["state"].net.named_parameters())
    for n, p in card["state"].net.named_parameters():
        g, w = p.grad.detach().cpu().double(), cpu_params[n].grad.detach().double()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        if err > TRAIN_GRAD_REL * scale + TRAIN_GRAD_FLOOR:
            raise AssertionError(f"training step: gradient of {n} differs from the CPU's by "
                                 f"{err:.2e} (its largest |g| {scale:.2e})")
        if scale < 100 * TRAIN_GRAD_FLOOR:
            tiny.append(scale)
        elif err / scale > grad_rel:
            grad_rel, worst = err / scale, n
    cpu_bufs = dict(cpu["state"].net.named_buffers())
    stats_err = max(float((buf.cpu() - cpu_bufs[n]).abs().max())
                    for n, buf in card["state"].net.named_buffers() if "running" in n)
    if stats_err > TRAIN_ATOL:
        raise AssertionError(f"training step: BatchNorm statistics differ by {stats_err:.2e}")
    return (f"card vs CPU step at B={TRAIN_CHECK_BATCH}: loss terms {loss_err:.2e}, argmax "
            f"metrics {metric_err:.2e} (rows flipped at near-ties {flips}), gradients up to "
            f"{grad_rel:.2e} of their scale ({worst}; besides, {len(tiny)} tensors of largest "
            f"|g| under {100 * TRAIN_GRAD_FLOOR:.0e}, up to {max(tiny, default=0):.1e}, most of "
            f"them 0 in exact arithmetic: key and position biases under the softmax), "
            f"BatchNorm statistics {stats_err:.2e}; replayed on the CPU: "
            f"{rep.report['fps_calls_parted']} FPS calls parted at near-ties (gaps "
            f"{', '.join(f'{g:.1e}' for g in rep.report['fps_gaps']) or 'none'} of |p|^2 max), "
            f"{rep.report['knn_rows_parted']} nearest-neighbour rows, "
            f"{rep.report['ball_query_rows_parted']} ball-query rows; "
            f"CPU step {cpu['s']:.1f} s, loss {cpu['metrics']['loss']:.4f}")


def check_checkpoint(trainer, state, ckpt_dir):
    """latest_checkpoint -> load_train_state into a fresh state equals the
    trained one: model (BatchNorm buffers included), Adam state, schedule,
    step."""
    import torch
    from sam6d_torch.core.checkpoint import latest_checkpoint, load_train_state
    path = latest_checkpoint(ckpt_dir)
    if os.path.basename(path) != f"step_{TRAIN_STEPS:08d}.pt":
        raise AssertionError(f"latest checkpoint is {path}")
    fresh = load_train_state(path, trainer.init_state())
    sd, fsd = state.net.state_dict(), fresh.net.state_dict()
    bad = [k for k in sd if not torch.equal(sd[k], fsd[k])]
    for p, q in zip(state.net.parameters(), fresh.net.parameters()):
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        bad += [k for k in a if not torch.equal(torch.as_tensor(a[k]).cpu(),
                                                torch.as_tensor(b[k]).cpu())]
    if bad or fresh.step != TRAIN_STEPS or state.step != TRAIN_STEPS or \
            fresh.scheduler.state_dict() != state.scheduler.state_dict():
        raise AssertionError(f"checkpoint round trip: {len(bad)} entries differ, step "
                             f"{fresh.step} vs {state.step}")
    return path


def phase_train(job_root, device="cuda"):
    """Phase 10: PEM training through the CLI at full width on a
    write_megapose_job tree (two boxes, 8 frames at 480x640): `render-training`
    (2 objects x 2 views at 512^2), `train` at PEMConfig() and batch 28 for
    TRAIN_STEPS steps with TRAIN_LOADER_THREADS loader threads and a
    checkpoint at the end; the step split, peak memory and busy share; K6
    and K7 per step; K7's cluster path and K6 at the training shapes against
    their plain versions; a card step against the CPU step on the last
    step's batch and on every batch the threads could have handed it; the
    checkpoint round trip. Returns (per-step
    launches, the K6 / K7 records at the training shapes)."""
    import torch
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.core import config as port_config
    from sam6d_torch.core.profiling import StageTimer
    from sam6d_torch.data.megapose import MegaPoseDataset
    from sam6d_torch.data.prefetch import PrefetchLoader
    from sam6d_torch.data.synthetic import write_megapose_job
    from sam6d_torch.kernels import ball_query as bq
    from sam6d_torch.kernels import fps
    from sam6d_torch.models import fine_matching
    from sam6d_torch.ops import sampling
    from sam6d_torch.train.trainer import PEMTrainer, batch_to_device

    root = os.path.join(job_root, "megapose")
    t0 = time.perf_counter()
    job = write_megapose_job(root, np.random.RandomState(SEED + 7), n_samples=8)
    log(f"train: write_megapose_job ({len(job['gso_ids'])} objects, {len(job['keys'])} "
        f"frames at 480x640) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_main(["render-training", "--data_dir", root, "--source", "gso", "--device", device])
    torch.cuda.synchronize()
    check_training_templates(root, job["gso_ids"])
    log(f"train: `render-training` CLI, {len(job['gso_ids'])} objects x 2 views at 512^2 in "
        f"{time.perf_counter() - t0:.2f} s; masks non-empty, |xyz| <= 1 on them, 0 off them")

    cfg = train_config()
    fns = frame_counters()
    ckpt = os.path.join(root, "ckpt")
    log(f"train: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated on the card "
        f"before the run")
    paths = []
    orig_path, orig_cfg = fps.fps_path, port_config.default_config

    def recorded_path(n):
        paths.append(orig_path(n))
        return paths[-1]

    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    port_config.default_config = train_config
    fps.fps_path = recorded_path
    try:
        t0 = time.perf_counter()
        with timed_calls(PEMTrainer, "step", fns, device) as stp, \
                timed_calls(PrefetchLoader, "get", device=device) as dat, \
                timed_calls(MegaPoseDataset, "sample_batch", device="cpu") as asm, \
                timed_calls(StageTimer, "summary", device=device) as tim:
            cli_main(["train", "--data_dir", root, "--ckpt_dir", ckpt, "--iters",
                      str(TRAIN_STEPS), "--data_workers", str(TRAIN_LOADER_THREADS),
                      "--device", device])
        cli_s = time.perf_counter() - t0
    finally:
        port_config.default_config = orig_cfg
        fps.fps_path = orig_path
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    split = tim.calls[0][0].summary()
    later = stp.ms[1:]
    log(f"train: `train` CLI, {TRAIN_STEPS} steps at PEMConfig(), batch "
        f"{cfg.train.batch_size}, remat {cfg.pem.vit.remat}, {TRAIN_LOADER_THREADS} loader "
        f"threads, in {cli_s:.2f} s "
        f"(cold: weights, first batch); step wall ms {', '.join(f'{m:.1f}' for m in stp.ms)} "
        f"(after the first: median {statistics.median(later):.1f}, range "
        f"{min(later):.1f}-{max(later):.1f}); StageTimer means: data "
        f"{1e3 * split['data']:.1f} ms, step {1e3 * split['step']:.1f} ms; loader get wall ms "
        f"{', '.join(f'{m:.1f}' for m in dat.ms)}; batch assembly in the loader threads "
        f"(MegaPoseDataset.sample_batch, {len(asm.ms)} calls) ms "
        f"{', '.join(f'{m:.0f}' for m in asm.ms)}; peak memory allocated {peak_gb:.2f} GiB; "
        f"launches a step {stp.launches}; FPS paths {paths}")
    for i, per in enumerate(stp.launches):
        if per["farthest_point_sample_cuda"] != 3 or per["two_scale_ball_query_cuda"] != 2 \
                or any(n for k, n in per.items() if k not in ("farthest_point_sample_cuda",
                                                              "two_scale_ball_query_cuda")):
            raise AssertionError(f"train step {i}: launches {per}, expected K7 3, K6 2, no other")
    if paths.count("cluster") != TRAIN_STEPS or paths.count("block") != 2 * TRAIN_STEPS:
        raise AssertionError(f"K7 paths over {TRAIN_STEPS} steps: {paths}")

    trainer, (state, batch, *_) = stp.calls[-1]
    path = check_checkpoint(trainer, state, ckpt)
    log(f"train: {os.path.basename(path)} loaded by latest_checkpoint + load_train_state "
        f"equals the trained state (model and BatchNorm buffers, Adam state, schedule, step)")

    # one step, counted alone, with the kernels' inputs kept; then the
    # card's busy share over one step
    reset_counts(fns)
    with timed_calls(sampling, "farthest_point_sample", device=device) as fcalls, \
            timed_calls(fine_matching, "two_scale_ball_query", device=device) as bcalls:
        trainer.step(state, batch)
    one = read_counts(fns)
    log(f"train: launches in one step {one}")
    if one["farthest_point_sample_cuda"] != 3 or one["two_scale_ball_query_cuda"] != 2:
        raise AssertionError(f"one training step launched {one}")
    device_busy(lambda: trainer.step(state, batch), f"train: step B={cfg.train.batch_size}")

    # K7 and K6 on the inputs this step gave them: K7's cluster call (the
    # per-sample template onboarding), both ball queries (the posed
    # observed cloud, the template cloud)
    tem_n, n_fine = next((pts, args[0]) for pts, args in fcalls.calls
                         if fps.fps_path(pts.shape[1]) == "cluster")
    B, n_tem = tem_n.shape[:2]
    if fps.fps_path(n_tem) != "cluster":
        raise AssertionError(f"fps[{B}x{n_tem}] takes the {fps.fps_path(n_tem)} path")
    log(f"fps cluster path at {B}x{n_tem}: {fps.check_cluster_resident(n_tem)} clusters "
        f"resident at once")
    f_err, f_ms, f_plain = _check_fps(f"fps[{B}x{n_tem}->{n_fine}]", tem_n.detach(), n_fine, fps)
    (pe1, (_, *args)), (pe2, _) = bcalls.calls
    pe1, pe2 = pe1.detach(), pe2.detach()
    n_obs = pe1.shape[1]
    b_err, b_ms, b_plain = _check_ball_query(f"ball_query[{B}x{n_obs}x{n_obs}] posed observed",
                                             pe1, args, bq)
    b2_err, _, _ = _check_ball_query(f"ball_query[{B}x{n_obs}x{n_obs}] template", pe2, args, bq)
    f_bound = bound((n_fine - 1) * B * n_tem * 10, 4 * B * n_tem * 3 + 4 * B * n_fine)
    b_bound = bound(15 * _ball_query_scanned_pairs(pe1, args),
                    2 * 4 * B * n_obs * 3 + 4 * B * n_obs * (args[1] + args[3]))
    log(f"train: last step's batch: {check_step_against_plain(cfg, batch)}")
    # which thread's batch the loader hands the last step depends on the
    # threads' race; every batch the race can hand it is held as well
    ds = MegaPoseDataset(root, img_size=cfg.pem.img_size,
                         n_sample_observed=cfg.pem.n_sample_observed_point,
                         n_sample_template=cfg.pem.n_sample_template_point)
    for w in range(TRAIN_LOADER_THREADS):
        rng = np.random.RandomState(cfg.train.seed + 1 + w)
        for k in range(TRAIN_STEPS - 1):
            drawn = batch_to_device(ds.sample_batch(cfg.train.batch_size, rng), device)
            log(f"train: loader thread {w}, batch {k}: {check_step_against_plain(cfg, drawn)}")
    records = {
        "farthest_point_sample_cuda": dict(
            train_ms=f_ms, train_plain_ms=f_plain, train_bound_ms=f_bound[0],
            train_bound_by=f_bound[1], train_max_abs_err=f_err,
            train_shape=f"{B}x{n_tem}->{n_fine} (cluster path)"),
        "two_scale_ball_query_cuda": dict(
            train_ms=b_ms, train_plain_ms=b_plain, train_bound_ms=b_bound[0],
            train_bound_by=b_bound[1], train_max_abs_err=max(b_err, b2_err),
            train_shape=f"{B}x{n_obs}x{n_obs} (lanes path; the posed observed cloud timed, "
                        f"the template cloud checked)")}
    return stp.launches[0], records


# ----------------------------------------------------------------- phase 11

# card vs the plain CPU run of FastSAM-x on the same weights: ~100 fp32
# convolutions summed in another order on the two devices. Scores and mask
# values in [0, 1]; boxes in pixels of the 480x640 frame (stride-32 DFL
# distances carry the rounding x32); a mask pixel may differ only where the
# card's value before the threshold lies within FASTSAM_NEAR_MASK of it
FASTSAM_SCORE_ATOL = 1e-4
FASTSAM_BOX_ATOL = 1e-2
FASTSAM_NEAR_MASK = 1e-4
# the FastSAM demo's downstream load, pinned as bench.py pins SAM's: the kept
# slots among the first 48 reach the describe, the first 16 records PEM
FASTSAM_DESCRIBE_SLOTS = 48
FASTSAM_PEM_DETECTIONS = 16


def fastsam_conv_flops(net, x):
    """Multiply-adds x 2 of every convolution of `net` on `x` (the
    network's operations; BatchNorm, SiLU, pooling and the DFL softmax are
    < 1% beside them), from the module shapes seen in one forward."""
    import torch
    total = [0]

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * m.out_channels * k
        else:
            total[0] += 2 * out.numel() * (m.in_channels // m.groups) * k
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.inference_mode():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def fastsam_stages(seg, rgb):
    """One frame through the segmentor's stages, keeping what
    generate_masks_device discards: the top-k anchors and the mask values
    before the threshold."""
    import torch
    from sam6d_torch.pipelines.sam_amg import stable_top_k
    H0, W0 = rgb.shape[:2]
    with torch.inference_mode():
        resized, scale, (h_in, w_in) = seg.letterbox_u8(rgb)
        x = seg.canvas(torch.as_tensor(resized, device=seg.device))
        preds, protos = seg.net(x)
        top = stable_top_k(preds[0, :, 4], seg.cfg.max_det)
        boxes, scores, keep, coefs = seg.select(preds[0])
        probs = seg.assemble(boxes, coefs, protos[0], h_in, w_in, H0, W0)
        return dict(x=x, all_scores=preds[0, :, 4], top=top, scores=scores, keep=keep,
                    coefs=coefs, protos=protos[0],
                    boxes_in=boxes, boxes=seg.original_boxes(boxes, scale, H0, W0),
                    probs=probs, geometry=(h_in, w_in, H0, W0), rounds=seg.last_nms_rounds)


def check_fastsam_against_plain(seg, rgb, card):
    """The card's FastSAM-x against the port's plain CPU run of the same
    weights on the same frame."""
    import torch
    from sam6d_torch.pipelines.fastsam import FastSAMSegmentor
    t0 = time.perf_counter()
    cpu = FastSAMSegmentor(seg.cfg, device="cpu",
                           state_dict={k: v.cpu() for k, v in seg.net.state_dict().items()})
    plain = fastsam_stages(cpu, rgb)
    cpu_s = time.perf_counter() - t0
    g = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in card.items()}
    same_top = torch.equal(g["top"], plain["top"])
    same_keep = torch.equal(g["keep"], plain["keep"])
    err_s = float((g["scores"] - plain["scores"]).abs().max())
    err_b = float((g["boxes"] - plain["boxes"]).abs().max())
    err_p = float((g["probs"] - plain["probs"]).abs().max())
    thr = seg.cfg.mask_thresh
    near = (g["probs"] - thr).abs() < FASTSAM_NEAR_MASK
    differ = (g["probs"] > thr) != (plain["probs"] > thr)
    unexplained = int((differ & ~near).sum())
    # the margins that decide the selections on this frame
    s = torch.sort(g["scores"]).values
    ranked = torch.sort(g["all_scores"], descending=True).values
    boundary = float(ranked[seg.cfg.max_det - 1] - ranked[seg.cfg.max_det])
    log(f"fastsam: card vs plain CPU run (FastSAM-x, same weights, CPU {cpu_s:.1f} s): "
        f"same top-{seg.cfg.max_det} anchors in order {same_top}, same kept set {same_keep} "
        f"({int(g['keep'].sum())} kept), max |diff| scores {err_s:.2e} (atol "
        f"{FASTSAM_SCORE_ATOL}), boxes {err_b:.2e} px (atol {FASTSAM_BOX_ATOL}), mask values "
        f"{err_p:.2e}; mask pixels differing {int(differ.sum())}, within {FASTSAM_NEAR_MASK} of "
        f"the threshold {int(near.sum())} of {near.numel()}, differing away from it "
        f"{unexplained}; score gap at the top-k boundary {boundary:.2e}, least gap among "
        f"the selected {float((s[1:] - s[:-1]).min()):.2e}")
    if not (same_top and same_keep) or err_s > FASTSAM_SCORE_ATOL or err_b > FASTSAM_BOX_ATOL \
            or unexplained:
        raise AssertionError("FastSAM on the card disagrees with the plain CPU run")


def fastsam_split(seg, rgb, st):
    """CUDA-event split of one frame's FastSAM beside each part's fp32
    bound: the network, decode + top-k + NMS, mask assembly + resize."""
    import torch
    h_in, w_in, H0, W0 = st["geometry"]
    net, x = seg.net, st["x"]
    D, nm = st["coefs"].shape
    _, Hp, Wp = st["protos"].shape
    with torch.inference_mode():
        levels, protos = net.features(x)
        t = {"network": cuda_ms(lambda: net.features(x), reps=5),
             "decode_topk_nms": cuda_ms(lambda: seg.select(net.decode(levels)[0]), reps=5),
             "masks": cuda_ms(lambda: seg.assemble(st["boxes_in"], st["coefs"], st["protos"],
                                                   h_in, w_in, H0, W0) > seg.cfg.mask_thresh,
                              reps=5),
             "generate_masks_device": cuda_ms(lambda: seg.generate_masks_device(rgb), reps=5)}
    letterbox = []
    for _ in range(5):
        t0 = time.perf_counter()
        seg.letterbox_u8(rgb)
        letterbox.append(1e3 * (time.perf_counter() - t0))
    t["letterbox_host"] = statistics.median(letterbox)
    n_params = sum(v.numel() for v in net.state_dict().values())
    head = sum(sum(t_.numel() for t_ in lv) for lv in levels) + protos.numel()
    A = sum(lv[0].shape[2] * lv[0].shape[3] for lv in levels)
    hp, wp = max(int(round(h_in / 4)), 1), max(int(round(w_in / 4)), 1)
    rounds = st["rounds"]
    bounds = {
        "network": bound(fastsam_conv_flops(net, x), 4 * (n_params + x.numel() + head)),
        # DFL softmax and expectation (~12 operations a bin), sigmoid, top-k
        # keys; box IoU (~20) and each NMS round's two (D, D) row sums
        "decode_topk_nms": bound(A * (4 * 16 * 12 + 40) + D * D * (20 + 4 * rounds),
                                 4 * (head - protos.numel()) + 4 * D * (4 + 1 + 1 + nm)),
        "masks": bound(2 * D * nm * Hp * Wp + 2 * D * (H0 * hp * wp + H0 * wp * W0),
                       4 * (D * (nm + 4) + nm * Hp * Wp) + D * H0 * W0)}
    bounds["generate_masks_device"] = (sum(b[0] for b in bounds.values()), "sum of the parts")
    # the host's resize reads the frame and writes the letterboxed image
    bounds["letterbox_host"] = (0.0, "host, no device bound")
    return t, bounds


def phase_fastsam(job, device="cuda"):
    """FastSAM-x (seeded random weights, each conv rescaled on the job's
    frame) through generate_masks_device on the card, held to the plain CPU
    run; its CUDA-event split beside the bounds, busy share, NMS syncs.
    Returns (the segmentor, its port-named weights)."""
    import torch
    from sam6d_torch.pipelines.fastsam import FastSAMConfig, FastSAMSegmentor
    from sam6d_torch.weights.fastsam import rescale_to_input
    rgb = job["rgb_arr"]
    H0, W0 = rgb.shape[:2]
    fns = frame_counters()
    t0 = time.perf_counter()
    seg = FastSAMSegmentor(FastSAMConfig(), seed=SEED, device=device)
    resized, _, _ = seg.letterbox_u8(rgb)
    rescale_to_input(seg.net, seg.canvas(torch.as_tensor(resized, device=device)))
    torch.cuda.synchronize()
    log(f"fastsam: FastSAM-x ({sum(p.numel() for p in seg.net.parameters())} parameters) "
        f"seeded random weights, rescaled on the frame's canvas, in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts(fns)
    t0 = time.perf_counter()
    out = seg.generate_masks_device(rgb)
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(fns)
    masks, boxes, valid = out["masks"], out["boxes"], out["valid"]
    D = seg.cfg.max_det
    if masks.shape != (D, H0, W0) or masks.dtype != torch.bool or boxes.shape != (D, 4) \
            or out["orig_size"] != out["seg_size"] != (H0, W0):
        raise AssertionError("FastSAM broke the device contract")
    b = boxes.cpu().numpy()
    if not np.isfinite(b).all() or (b < 0).any() or (b[:, [0, 2]] > W0 - 1).any() \
            or (b[:, [1, 3]] > H0 - 1).any():
        raise AssertionError("FastSAM boxes outside the frame")
    n_valid = int(valid.sum())
    if n_valid < 1 or any(launches.values()):
        raise AssertionError(f"FastSAM kept {n_valid} or launched a kernel: {launches}")
    st = fastsam_stages(seg, rgb)
    if not (torch.equal(st["probs"] > seg.cfg.mask_thresh, masks)
            and torch.equal(st["keep"], valid)):
        raise AssertionError("the staged FastSAM run differs from generate_masks_device")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        seg.generate_masks_device(rgb)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    t, bounds = fastsam_split(seg, rgb, st)
    log(f"fastsam: generate_masks_device on the {H0}x{W0} frame (FastSAM-x at "
        f"{seg.cfg.imgsz}, {D} slots) cold {cold_ms:.1f} ms, then wall "
        + ", ".join(f"{m:.1f}" for m in walls) + f" ms; {n_valid} of {D} slots valid; NMS "
        f"{seg.last_nms_rounds} rounds ({seg.last_nms_rounds + 1} device->host syncs); no "
        f"kernel launched; split on CUDA events (median of 5; the host letterbox on the "
        f"host's clock) beside the fp32 bound: "
        + "; ".join(f"{k} {v:.3f} ms (bound {bounds[k][0]:.4f} ms, {bounds[k][1]})"
                    for k, v in t.items()))
    device_busy(lambda: seg.generate_masks_device(rgb), "fastsam: generate_masks_device")
    check_fastsam_against_plain(seg, rgb, st)
    return seg, {k: v.clone() for k, v in seg.net.state_dict().items()}


def phase_fastsam_demo(job, fastsam_sd, device="cuda"):
    """run_demo(segmentor='fastsam') at full width (FastSAM-x, DINOv2-L,
    PEM-base) on phase 7's templates (skip_render): every output file, the
    load pinned (FASTSAM_DESCRIBE_SLOTS slots to the describe,
    FASTSAM_PEM_DETECTIONS records to PEM), K5, K6 and K7 launched, K1-K4
    not. Returns the launches."""
    import shutil
    import torch
    from sam6d_torch.core.config import Config, ISMConfig, ISMMatchingConfig
    from sam6d_torch.pipelines.demo import run_demo
    from sam6d_torch.pipelines.fastsam import FastSAMSegmentor
    from sam6d_torch.pipelines.ism import needed_prefix
    from sam6d_torch.pipelines.pem import PEMPipeline
    fns = frame_counters()
    out = os.path.join(job["dir"], "demo_fastsam")
    shutil.copytree(os.path.join(job["dir"], "demo", "templates"), os.path.join(out, "templates"))
    cfg = Config(ism=ISMConfig(segmentor="fastsam",
                               matching=ISMMatchingConfig(confidence_thresh=-1.0)))
    seg_orig, pem_orig = FastSAMSegmentor.generate_masks_device, PEMPipeline.run_frame
    load = {}

    def pinned_seg(self, image):
        res = seg_orig(self, image)
        kept = res["valid"]
        load["kept"] = int(kept.sum())
        res["valid"] = kept & (torch.arange(len(kept), device=kept.device)
                               < FASTSAM_DESCRIBE_SLOTS)
        load["described"] = int(res["valid"].sum())
        load["prefix"] = needed_prefix(res["valid"].cpu().numpy())
        return res

    def pinned_pem(self, rgb, depth, K, depth_scale, detections, *a, **kw):
        load["records"] = len(detections)
        load["to_pem"] = len(detections[:FASTSAM_PEM_DETECTIONS])
        return pem_orig(self, rgb, depth, K, depth_scale, detections[:FASTSAM_PEM_DETECTIONS],
                        *a, **kw)

    FastSAMSegmentor.generate_masks_device = pinned_seg
    PEMPipeline.run_frame = pinned_pem
    try:
        reset_counts(fns)
        res = run_demo(cfg, job["cad"], job["rgb"], job["depth"], job["cam"], out,
                       sam_state_dict=fastsam_sd, det_score_thresh=-1.0, skip_render=True,
                       device=device, seed=SEED)
        torch.cuda.synchronize()
        launches = read_counts(fns)
    finally:
        FastSAMSegmentor.generate_masks_device = seg_orig
        PEMPipeline.run_frame = pem_orig
    files = ["sam6d_results/detection_ism.json", "sam6d_results/vis_ism.png",
             "sam6d_results/detection_pem.json", "sam6d_results/vis_pem.png"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    if missing or not res["pem"]:
        raise AssertionError(f"run_demo fastsam: missing {missing} or no pose")
    check_pose_records(res["pem"], "run_demo fastsam")
    # K5: every DINOv2 block once a chunk, at the onboarding of the
    # templates and at the describe of the pinned prefix
    d = cfg.ism.dinov2
    n_templates = len([f for f in os.listdir(os.path.join(out, "templates"))
                       if f.startswith("rgb_")])
    want_k5 = d.depth * (-(-n_templates // d.chunk_size) - (-load["prefix"] // d.chunk_size))
    log(f"demo fastsam: run_demo(segmentor='fastsam') wrote {files}; FastSAM kept "
        f"{load['kept']} of {cfg.ism.fastsam.max_det} slots, {load['described']} of the first "
        f"{FASTSAM_DESCRIBE_SLOTS} reached the describe (prefix {load['prefix']}), "
        f"{load['records']} ISM records, {load['to_pem']} reached PEM, "
        f"{len(res['pem'])} poses (R R^T = I within 1e-3); split (wall ms, cold): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["split_ms"].items())
        + f"; kernel launches {launches}")
    for name in ("fused_attention_qkv_cuda", "two_scale_ball_query_cuda",
                 "farthest_point_sample_cuda"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the FastSAM demo")
    if launches["fused_attention_qkv_cuda"] != want_k5 or any(launches[k] for k in SAM_KERNELS):
        raise AssertionError(f"unexpected launches on the FastSAM demo (K5 {want_k5} for "
                             f"{n_templates} templates, K1-K4 0)")
    return launches


def phase_cascade(job, device="cuda"):
    """ViT-H SAM with crop_n_layers=1 and min_mask_region_area=100 (the AMG
    load pinned as in phase 6) through generate_masks on the job's frame:
    boxes inside the frame, invalid slots empty, K1-K4 launched as often as
    the crop boxes and the per-layer grids predict. Returns the launches."""
    import torch
    from sam6d_torch.core.config import SAMConfig
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor, generate_crop_boxes
    rgb = job["rgb_arr"]
    H0, W0 = rgb.shape[:2]
    fns = frame_counters()
    cfg = SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0, max_proposals=128,
                    crop_n_layers=1, min_mask_region_area=100)
    seg = SAMSegmentor(cfg, seed=SEED, device=device)
    crops, layers = generate_crop_boxes((H0, W0), cfg.crop_n_layers, cfg.crop_overlap_ratio)
    want = dict.fromkeys(fns, 0)
    want["flash_attention_relpos_cuda"] = cfg.encoder_depth * len(crops)
    for layer in layers:
        n = max(1, int(cfg.points_per_side // cfg.crop_n_points_downscale_factor ** layer))
        if seg.prefix_length(n * n) < n * n:      # the iou pass runs: 2 launches a chunk
            for k in FACTORED:
                want[k + "_cuda"] += 2 * -(-n * n // cfg.points_per_batch)
    reset_counts(fns)
    t0 = time.perf_counter()
    out = seg.generate_masks(rgb)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(fns)
    valid, masks, boxes = out["valid"], out["masks"], out["boxes"]
    K = cfg.max_proposals
    n = int(valid.sum())
    log(f"cascade: ViT-H generate_masks with crop_n_layers=1 ({len(crops)} crops: "
        f"{crops}) and min_mask_region_area=100 on the {H0}x{W0} frame in {wall_ms:.1f} ms "
        f"wall (cold); {n} of {K} slots valid; kernel launches {launches}, predicted {want}")
    if masks.shape != (K, H0, W0) or not np.isfinite(masks).all() or masks.min() < 0 \
            or masks.max() > 1 or n < 1:
        raise AssertionError("cascade: bad masks or nothing kept")
    b = boxes[valid]
    if (b < 0).any() or (b[:, [0, 2]] > W0).any() or (b[:, [1, 3]] > H0).any() \
            or (b[:, 2] < b[:, 0]).any() or (b[:, 3] < b[:, 1]).any():
        raise AssertionError("cascade: boxes outside the frame")
    if masks[~valid].any() or boxes[~valid].any() or out["iou_preds"][~valid].any():
        raise AssertionError("cascade: an invalid slot is not empty")
    if launches != want:
        raise AssertionError("cascade: K1-K4 launched other than predicted")
    del seg
    return launches


def phase_options(job, device="cuda"):
    """Phase 11: the segmentation options at full width. Returns
    {path: launches}."""
    import torch
    seg, sd = phase_fastsam(job, device)
    del seg
    torch.cuda.empty_cache()
    demo = phase_fastsam_demo(job, sd, device)
    torch.cuda.empty_cache()
    return {"run_demo fastsam": demo,
            "SAM crop cascade + small regions": phase_cascade(job, device)}


# ------------------------------------------------------------------ phase 12

BF16_KERNELS = ("flash_attention_relpos_bf16_cuda", "fused_attention_qkv_bf16_cuda",
                "fused_attention_bf16_cuda", "fused_attention_small_bf16_cuda") + tuple(
                    n + "_bf16_cuda" for n in FACTORED)


def bf16_counters():
    """Every attention entry and every kernel of the frame, by name: the
    bf16 entries beside the fp32 ones."""
    from sam6d_torch.kernels import attention, attention_qkv, attention_relpos
    from sam6d_torch.kernels import factored as fk
    fns = frame_counters()
    fns.update(flash_attention_relpos_bf16_cuda=attention_relpos.flash_attention_relpos_bf16_cuda,
               fused_attention_qkv_bf16_cuda=attention_qkv.fused_attention_qkv_bf16_cuda,
               fused_attention_bf16_cuda=attention.fused_attention_bf16_cuda,
               fused_attention_small_bf16_cuda=attention.fused_attention_small_bf16_cuda)
    fns.update({n + "_bf16_cuda": getattr(fk, n + "_bf16_cuda") for n in FACTORED})
    return fns


def _bf16_cards(rng, shape, scale=1.0):
    import torch
    return (torch.from_numpy(rng.randn(*shape).astype(np.float32) * np.float32(scale))
            .cuda().to(torch.bfloat16))


def _peaked_qkv_cards(rng, B, N, heads, hd):
    """(B, N, 3 heads hd) bf16 qkv on the card in which every query's scores
    peak at one key (the query is twice that key, at a random place) and
    every V row carries its 64-key tile's own offset, (tile mod 64 - 31.5) /
    36, plus a little noise (outputs below 1, where one ulp of bf16 is
    2^-8): a stage of the streaming ring read stale moves the rows whose
    peak key lies in it by 1/36 or more, where flat scores would move them
    by less than the tolerance."""
    import torch
    k = rng.randn(B, N, heads, hd).astype(np.float32)
    q = 2 * k[:, rng.permutation(N)]
    tile = (np.arange(N) // 64 % 64 - 31.5) / 36
    v = (tile[None, :, None, None] + 0.01 * rng.randn(B, N, heads, hd)).astype(np.float32)
    x = np.concatenate([q, k, v], axis=2).reshape(B, N, 3 * heads * hd)
    return torch.from_numpy(x).cuda().to(torch.bfloat16)


def _bf16_err(name, got, want, atol=BF16_ATOL):
    import torch
    torch.cuda.synchronize()
    e = float((got.float() - want.float()).abs().max())
    log(f"{name}: max |diff| {e:.2e} against its plain bf16 version (atol {atol})")
    if not (got.dtype == want.dtype == torch.bfloat16 and e <= atol):
        raise AssertionError(f"{name}: the bf16 entry disagrees with its plain version")
    return e


def _bf16_timed(name, fn, plain, lib, products, other, nbytes):
    """Runs of 10 launches (one launch of the short entries is mostly the
    host's dispatch of it)."""
    ms = cuda_ms(fn, reps=10, launches=10)
    plain_ms = cuda_ms(plain, reps=3, launches=10)
    lib_ms = cuda_ms(lib, reps=10, launches=10)
    b_ms = bf16_bound(products, other, nbytes)
    by = "operations" if products / PEAK_BF16_FLOPS + other / PEAK_FP32_FLOPS \
        >= nbytes / PEAK_BYTES else "bytes"
    log(f"{name}, runs of 10 launches: bf16 entry {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA bf16 {lib_ms:.4f} ms "
        f"(entry/SDPA {ms / lib_ms:.3f}); dense-bf16 bound {b_ms:.4f} ms ({by}, "
        f"{100 * b_ms / ms:.1f}% of it)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_ratio=ms / lib_ms,
                bound_ms=b_ms, bound_by=by)


def _check_bf16_kernels(rng, ptxas):
    """The bf16 entries against the plain versions of their contract at the
    main path's shapes and stress cases, timed beside their dense-bf16
    bounds, the plain versions and SDPA in bf16; fails on a spill in any
    bf16 instantiation."""
    import torch
    import torch.nn.functional as F
    from sam6d_torch.kernels import attention, attention_qkv
    from sam6d_torch.kernels import attention_relpos as rp
    from sam6d_torch.kernels._build import load_library
    lib = load_library()
    regs, smem = {}, {}
    for kernel, hds in (("attention_relpos_wgmma_kernel", (16, 32, 64, 80)),
                        ("attention_qkv_wgmma_kernel", (32, 64)),
                        ("head_major_attention_bf16_kernel", tuple(range(16, 129, 16)))):
        for hd in hds:
            r, spills = ptxas_record(ptxas, kernel, hd)
            regs[f"{kernel}<{hd}>"] = r
            if spills:
                raise AssertionError(f"{kernel}<{hd}> spills {spills} bytes")
            # dynamic shared memory a block, as the C launch sizes it
            if kernel == "attention_qkv_wgmma_kernel":
                smem[f"{kernel}<{hd}>"] = "/".join(
                    str(lib.sam6d_fused_attention_qkv_bf16_smem(n, hd)) for n in (257, 4096))
            elif kernel == "attention_relpos_wgmma_kernel":
                smem[f"{kernel}<{hd}>"] = "/".join(
                    str(lib.sam6d_flash_attention_relpos_bf16_smem(g * g, hd, g, g))
                    for g in (14, 64))
    log("bf16 entries' ptxas registers (no spills): "
        + ", ".join(f"{k} {v}" for k, v in regs.items()))
    log("wgmma kernels' dynamic shared memory a block, bytes (K5 at 257/4096 keys, K1 on a "
        "14x14/64x64 grid): " + ", ".join(f"{k} {v}" for k, v in smem.items()))

    # K5: the describe chunk, a ragged batch, large scores; then the wgmma
    # core's tile edges (64-row and 64-key tiles; the ring's five resident
    # tiles at 320 keys and the streaming ring past them), hd 32, and a qkv
    # 16 bytes into its buffer
    heads, hd, C = 16, 64, 1024
    err5 = edge5 = 0.0
    for B, N, qk in ((16, 257, 1.0), (3, 257, 1.0), (16, 257, 2.0)):
        qkv = _bf16_cards(rng, (B, N, 3 * C))
        with torch.no_grad():
            qkv[..., :2 * C] *= 0.5 * qk
        err5 = max(err5, _bf16_err(
            f"attention_qkv bf16[{B}x{N}x{3 * C}, q and k x{0.5 * qk:g}]",
            attention_qkv.fused_attention_qkv_bf16_cuda(qkv, heads, 0.125),
            attention_qkv.fused_attention_qkv_bf16_plain(qkv, heads, 0.125)))
    for B, N, eh, ehd, offset in ((2, 1, 16, 64, 0), (2, 63, 16, 64, 0), (2, 65, 16, 32, 0),
                                  (2, 196, 16, 64, 0), (2, 320, 16, 64, 0),
                                  (2, 321, 16, 64, 0), (1, 4096, 16, 64, 0),
                                  (2, 257, 16, 64, 8), (1, 4096, 16, 64, None)):
        if offset is None:   # peaked scores, a V offset a key tile
            qkv = _peaked_qkv_cards(rng, B, N, eh, ehd)
        else:
            qkv = _bf16_cards(rng, (offset + B * N * 3 * eh * ehd,))[offset:].view(B, N, -1)
            with torch.no_grad():
                qkv[..., :2 * eh * ehd] *= 0.5
        edge5 = max(edge5, _bf16_err(
            f"attention_qkv bf16[{B}x{N}x{3 * eh * ehd}, hd {ehd}, "
            + ("peaked]" if offset is None else f"offset {2 * offset} bytes]"),
            attention_qkv.fused_attention_qkv_bf16_cuda(qkv, eh, ehd ** -0.5),
            attention_qkv.fused_attention_qkv_bf16_plain(qkv, eh, ehd ** -0.5)))
    B, N = 16, 257
    qkv = _bf16_cards(rng, (B, N, 3 * C))
    q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    k5 = _bf16_timed(
        "attention_qkv bf16[16x257x3072]",
        lambda: attention_qkv.fused_attention_qkv_bf16_cuda(qkv, heads, 0.125),
        lambda: attention_qkv.fused_attention_qkv_bf16_plain(qkv, heads, 0.125),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125),
        4 * B * heads * N * N * hd, 2 * B * heads * N * N, 2 * B * N * 4 * C)

    # K8: the 448 describe's views, large scores, cross-attention; K9
    def views(B, H, N, hd, qk=1.0):
        x = _bf16_cards(rng, (B, N, 3 * H * hd))
        with torch.no_grad():
            x[..., :2 * H * hd] *= 0.5 * qk
        return x.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)

    err8 = 0.0
    for name, ops in (("16x16x1025x64", views(16, 16, 1025, 64)),
                      ("16x16x1025x64 large scores", views(16, 16, 1025, 64, 2.0)),
                      ("2x4x61x300x32 cross", [_bf16_cards(rng, (2, 4, n, 32), s)
                                               for n, s in ((61, 0.5), (300, 0.5), (300, 1.0))])):
        err8 = max(err8, _bf16_err(f"fused_attention bf16[{name}]",
                                   attention.fused_attention_bf16_cuda(*ops, 0.125),
                                   attention.fused_attention_bf16_plain(*ops, 0.125)))
    q, k, v = views(16, 16, 1025, 64)
    n8 = 16 * 16 * 1025 * 1025
    k8 = _bf16_timed("fused_attention bf16[16x16x1025x64]",
                     lambda: attention.fused_attention_bf16_cuda(q, k, v, 0.125),
                     lambda: attention.fused_attention_bf16_plain(q, k, v, 0.125),
                     lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125),
                     4 * n8 * 64, 2 * n8, 2 * 4 * 16 * 16 * 1025 * 64)
    err9 = 0.0
    for qk in (1.0, 2.0):
        ops = [_bf16_cards(rng, (16, 16, 257, 64), s) for s in (0.5 * qk, 0.5 * qk, 1.0)]
        err9 = max(err9, _bf16_err(f"fused_attention_small bf16[16x16x257x64, q and k "
                                   f"x{0.5 * qk:g}]",
                                   attention.fused_attention_small_bf16_cuda(*ops, 0.125),
                                   attention.fused_attention_small_bf16_plain(*ops, 0.125)))
    q, k, v = (_bf16_cards(rng, (16, 16, 257, 64)) for _ in range(3))
    n9 = 16 * 16 * 257 * 257
    k9 = _bf16_timed("fused_attention_small bf16[16x16x257x64]",
                     lambda: attention.fused_attention_small_bf16_cuda(q, k, v, 0.125),
                     lambda: attention.fused_attention_small_bf16_plain(q, k, v, 0.125),
                     lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125),
                     4 * n9 * 64, 2 * n9, 2 * 4 * 16 * 16 * 257 * 64)

    # K1: a global and a windowed ViT-H block, the windowed one also with
    # its rel-pos parameters x3; then the wgmma core's tile edges (N 1, 63,
    # 65, 257; the ring's four resident tiles at hd 80 and the streaming
    # ring past them) at hd 16, 32, 64 and 80
    heads, hd = 16, 80
    C = heads * hd
    rec1, err1, edge1 = {}, 0.0, 0.0
    for name, B, (H, W), rel, eh, ehd in (
            ("global", 1, (64, 64), 1.0, heads, hd), ("windowed", 25, (14, 14), 1.0, heads, hd),
            ("windowed, rel-pos x3", 25, (14, 14), 3.0, heads, hd),
            ("edge", 2, (1, 1), 1.0, 4, 16), ("edge", 2, (7, 9), 1.0, 4, 32),
            ("edge", 2, (5, 13), 1.0, 4, 64), ("edge", 1, (1, 257), 1.0, 4, 32),
            ("edge", 2, (16, 16), 1.0, 4, 80), ("edge", 2, (13, 20), 1.0, 4, 80),
            ("edge, peaked", 1, (64, 64), 1.0, 4, 80)):
        N = H * W
        if name == "edge, peaked":   # peaked scores, a V offset a key tile
            qkv = _peaked_qkv_cards(rng, B, N, eh, ehd)
        else:
            qkv = _bf16_cards(rng, (B, N, 3 * eh * ehd))
            with torch.no_grad():
                qkv[..., :2 * eh * ehd] *= 0.5
        rh, rw = (_bf16_cards(rng, (2 * s - 1, ehd), 0.1 * rel) for s in (H, W))
        args = (qkv, rh, rw, (H, W), eh)
        e = _bf16_err(f"relpos_attention bf16[{name} {B}x{H}x{W}x{3 * eh * ehd}, hd {ehd}]",
                      rp.flash_attention_relpos_bf16_cuda(*args),
                      rp.flash_attention_relpos_bf16_plain(*args))
        if name.startswith("edge"):
            edge1 = max(edge1, e)
            continue
        if rel != 1.0:
            stress_err1 = e
            continue
        err1 = max(err1, e)
        q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        rel_h, rel_w = (t.to(torch.bfloat16).float() for t in rp.rel_pos_tables(
            qkv.float(), rh.float(), rw.float(), (H, W), heads))
        mask = (rel_h.view(B, heads, N, H, 1) + rel_w.view(B, heads, N, 1, W)
                ).reshape(B, heads, N, N).to(torch.bfloat16)
        del rel_h, rel_w
        products = 4 * B * heads * N * N * hd
        other = 4 * B * heads * N * N + 2 * B * heads * N * (H + W) * hd
        nbytes = 2 * (B * N * 4 * C + (2 * H + 2 * W - 2) * hd)
        rec1[name] = _bf16_timed(
            f"relpos_attention bf16[{name} {B}x{N}x{3 * C}]",
            lambda: rp.flash_attention_relpos_bf16_cuda(*args),
            lambda: rp.flash_attention_relpos_bf16_plain(*args),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   scale=hd ** -0.5),
            products, other, nbytes)
        del mask
    g, w = rec1["global"], rec1["windowed"]
    common = dict(route="cuda", tolerance=f"atol {BF16_ATOL} against the plain bf16 version",
                  timing="ms, plain_ms, library_ms: CUDA events over runs of 10 launches")
    return [
        dict(name="flash_attention_relpos_bf16_cuda", source="sam6d_torch/csrc/attention_relpos.cu",
             replaces="sam6d_tpu/kernels/flash_attention.py:316", max_abs_err=err1, **g,
             windowed_ms=w["ms"], windowed_plain_ms=w["plain_ms"],
             windowed_bound_ms=w["bound_ms"], windowed_library_ms=w["library_ms"],
             ptxas_registers=regs["attention_relpos_wgmma_kernel<80>"], ptxas_spill_bytes=0,
             stress_max_abs_err=stress_err1, edge_max_abs_err=edge1,
             shapes="global 1x4096x3840 bf16, 16 heads of 80 (ms; library_ms: SDPA with the "
                    "bf16 bias as a float mask); windowed 25x196x3840 (windowed_*); windowed "
                    "with rel-pos x3 checked (stress_*); tile edges N 1, 63, 65, 257, 256, "
                    "260 at hd 16-80 and 64x64 with peaked scores checked (edge_*)", **common),
        dict(name="fused_attention_qkv_bf16_cuda", source="sam6d_torch/csrc/attention_qkv.cu",
             replaces="sam6d_tpu/kernels/flash_attention.py:280", max_abs_err=err5, **k5,
             ptxas_registers=regs["attention_qkv_wgmma_kernel<64>"], ptxas_spill_bytes=0,
             edge_max_abs_err=edge5,
             shapes="16x257x3072 bf16 (ms); 3x257 and q and k x1 checked; tile edges N 1, "
                    "63, 65, 196, 320, 321, 4096 (also with peaked scores), hd 32, a 16-byte "
                    "offset checked (edge_*)",
             **common),
        dict(name="fused_attention_bf16_cuda", source="sam6d_torch/csrc/attention.cu",
             replaces="sam6d_tpu/kernels/flash_attention.py:133", max_abs_err=err8, **k8,
             ptxas_registers=regs["head_major_attention_bf16_kernel<64>"],
             ptxas_spill_bytes=0,
             shapes="16x16x1025x64 bf16 qkv views (ms); large scores and 2x4x61x300x32 "
                    "cross-attention checked", **common),
        dict(name="fused_attention_small_bf16_cuda", source="sam6d_torch/csrc/attention.cu",
             replaces="sam6d_tpu/kernels/flash_attention.py:203", max_abs_err=err9, **k9,
             ptxas_registers=regs["head_major_attention_bf16_kernel<64>"],
             ptxas_spill_bytes=0, shapes="16x16x257x64 bf16 (ms); large scores checked",
             note="no caller in either package: held to its plain version only", **common),
    ]


# the kernels of each bf16 factored entry (ptxas registers and spills)
BF16_FACTORED_KERNELS = {
    "factored_ln_stats": ("ln_stats_bf16_kernel",),
    "factored_t2i_attention": ("t2i_scores_bf16_kernel", "t2i_bf16_kernel",
                               "t2i_merge_bf16_kernel"),
    "factored_i2t_scores": ("i2t_bf16_kernel",)}


def bf16_factored_err(name, got, want):
    """(agrees, error, description) of a bf16 factored entry against its
    plain version. K2: fp32 mu within FACTORED_ATOL and 1/sigma within
    LN_INV_RTOL (error: the larger of the two, as the fp32 record keeps);
    K4: within BF16_ATOL; K3: within BF16_ATOL x max(1, |plain|), since its
    outputs pass 2, where the output's own rounding, flipped by the fp32
    sums' order, is one ulp (2^-7 |out| at most) and more than 8e-3: the
    same error relative to the output as 8e-3 in [1, 2). K3 and K4: error is
    the max |diff|."""
    import torch
    if name == "factored_ln_stats":
        err = float((got[0] - want[0]).abs().max())
        rel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
        return (err <= FACTORED_ATOL and rel <= LN_INV_RTOL, max(err, rel),
                f"mu max |diff| {err:.2e} (atol {FACTORED_ATOL}), 1/sigma max rel diff "
                f"{rel:.2e} (rtol {LN_INV_RTOL})")
    if not (got.dtype == want.dtype == torch.bfloat16):
        raise AssertionError(f"{name}: the bf16 entry returned {got.dtype}")
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    if name == "factored_i2t_scores":
        return err <= BF16_ATOL, err, f"max |diff| {err:.2e} (atol {BF16_ATOL})"
    share = float((d / want.float().abs().clamp(min=1.0)).max())
    return (share <= BF16_ATOL, err,
            f"max |diff| {err:.2e}, max |diff| / max(1, |plain|) {share:.2e} ({BF16_ATOL}); "
            f"{int((d > 0).sum())} of {d.numel()} outputs differ")


def _check_bf16_factored(seg, ptxas):
    """The bf16 entries of K2-K4 on the bf16 iou pass's own arguments (one
    128-prompt chunk of a bf16 segmentor, captured), held to their plain
    bf16 versions, timed over runs of 10 launches beside the plain version,
    the float32 entry on the same values and the dense-bf16 bound (bytes at
    2 an operand). Fails on a spill in any of their kernels."""
    import torch
    from sam6d_torch.kernels import factored as fk
    ptx = {}
    for n, kernels in BF16_FACTORED_KERNELS.items():
        ptx[n] = {k: ptxas_record(ptxas, k) for k in kernels}
        for kernel, (regs, spills) in ptx[n].items():
            log(f"{n} bf16: {kernel} ptxas {regs} registers, {spills} bytes spilled")
            if spills:
                raise AssertionError(f"{n} bf16: {kernel} spills {spills} bytes")
    calls = capture_factored(seg, np.random.RandomState(SEED + 8))

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.float()
        if isinstance(x, tuple):
            return tuple(f32(y) for y in x)
        return x

    records = []
    for n, line in zip(FACTORED, (296, 350, 167)):
        cuda_fn, plain_fn = getattr(fk, n + "_bf16_cuda"), getattr(fk, n + "_bf16_plain")
        fp32_fn = getattr(fk, n + "_cuda")
        rows = []
        for args in calls[n]:
            if args[2 if n == "factored_ln_stats" else 0].dtype != torch.bfloat16:
                raise AssertionError(f"{n}: the bf16 iou pass passed non-bf16 operands")
            with torch.inference_mode():
                ok, err, desc = bf16_factored_err(n, cuda_fn(*args), plain_fn(*args))
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: cuda_fn(*args), reps=10, launches=10)
                plain_ms = cuda_ms(lambda: plain_fn(*args), reps=3)
                args32 = f32(args)
                fp32_ms = cuda_ms(lambda: fp32_fn(*args32), reps=10, launches=10)
                del args32
            products, other, nbytes = {"factored_ln_stats": _ln_stats_work,
                                       "factored_t2i_attention": _t2i_work,
                                       "factored_i2t_scores": _i2t_work}[n](args)
            b_ms = bf16_bound(products, other, nbytes)
            by = "operations" if products / PEAK_BF16_FLOPS + other / PEAK_FP32_FLOPS \
                >= nbytes / PEAK_BYTES else "bytes"
            blocks = args[{"factored_ln_stats": 0, "factored_t2i_attention": 3,
                           "factored_i2t_scores": 2}[n]]
            ranks = "+".join(str(pd.shape[1]) for pd, _ in blocks) or "0"
            log(f"{n} bf16[B=128, ranks {ranks}]: {desc}; runs of 10 launches: bf16 entry "
                f"{ms:.4f} ms, fp32 entry {fp32_ms:.4f} ms; plain {plain_ms:.4f} ms; dense-bf16 "
                f"bound {b_ms:.4f} ms ({by}, {100 * b_ms / ms:.1f}% of it)")
            if not ok:
                raise AssertionError(f"{n}: the bf16 entry disagrees with its plain version")
            rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, fp32_ms=fp32_ms, b_ms=b_ms,
                             by=by, ranks=ranks))
        first, last = rows[0], rows[-1]
        regs = {f"{k}_ptxas_registers": r for k, (r, _) in ptx[n].items()}
        records.append(dict(
            name=n + "_bf16_cuda", route="cuda", source="sam6d_torch/csrc/factored_bf16.cu",
            replaces=f"sam6d_tpu/kernels/factored_t2i.py:{line}",
            max_abs_err=max(r["err"] for r in rows),
            tolerance=(f"mu atol {FACTORED_ATOL}, 1/sigma rtol {LN_INV_RTOL} (max_abs_err "
                       f"holds the larger)" if n == "factored_ln_stats" else
                       f"|diff| <= {BF16_ATOL} x max(1, |plain|)"
                       if n == "factored_t2i_attention" else f"atol {BF16_ATOL}"),
            ms=last["ms"], plain_ms=last["plain_ms"], bound_ms=last["b_ms"],
            bound_by=last["by"], library_ms=None, fp32_entry_ms=last["fp32_ms"],
            first_call_ms=first["ms"], first_call_plain_ms=first["plain_ms"],
            first_call_bound_ms=first["b_ms"], first_call_fp32_entry_ms=first["fp32_ms"],
            ptxas_spill_bytes=0, **regs,
            timing="ms, fp32_entry_ms: CUDA events over runs of 10 launches; plain_ms: one "
                   "launch",
            shapes=f"B=128, N=4096, ranks {last['ranks']} (ms); ranks {first['ranks']} "
                   f"(first_call_*); bf16 states captured from one chunk of the bf16 iou "
                   f"pass"))
    return records


def _stage_outputs(build, run, dtypes):
    """run(build(dtype)) for each dtype, as float32 numpy arrays; each
    pipeline freed before the next is built."""
    import torch
    out = {}
    for dt in dtypes:
        pipe = build(dt)
        with torch.inference_mode():
            out[dt] = [x.float().cpu().numpy() for x in run(pipe)]
        del pipe
        torch.cuda.empty_cache()
    return out


# the budget the extra stage is held to: the iou_only pass as the decode's IoU
BUDGET_OF = {"amg_decode_iou_only": "amg_decode_iou"}
# how far PEM's fp32 pose may lie from the posed frame's own (q99, degrees):
# the fp32 solve recovers it within a degree, an arbitrary pose lies ~90
# degrees off
POSED_FP32_DEG = 2.0


def bf16_budget_stages():
    """The nine stages of the bf16 budget at full width, and the decode's
    iou_only pass: the port in bf16 against the port in fp32 on the same
    fan-in-scaled weights (tests/torch_port_draw.rand_like_state_dict, the
    JAX package's rand_like_tree on the flax layout, drawn on the CPU; seeds
    1-3 as bf16_budget.py). SAM and DINOv2 take the inputs bf16_budget.py
    gives them. PEM runs its whole `infer` at B=16 on a posed frame
    (`posed_pem_frame`: the template is the observed cloud under a known
    pose) with the conditioned draw (`conditioned_pem_state_dict`): under
    the plain draw and bf16_budget.py's random template the fp32 pose
    itself has no answer (every fine similarity within ~0.01 of 1 / temp),
    so R and t would measure the harness. Returns ({stage: error}, q99 of
    the fp32 pose's angle to the frame's own pose, in degrees)."""
    import torch
    from sam6d_torch.core.config import ISMConfig, SAMConfig
    from sam6d_torch.core.numerics import BUDGETS, q99_rel, rotation_q99
    from sam6d_torch.models import ism_scoring
    from sam6d_torch.models.dinov2 import DINOv2
    from sam6d_torch.models.pem import PEMNet
    from sam6d_torch.models.sam import SAM
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMConfig, PEMPipeline
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_draw import conditioned_pem_state_dict, posed_pem_frame, rand_like_state_dict
    f32, b16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(SEED)
    res = {}
    t0 = time.perf_counter()

    cfg = SAMConfig(max_proposals=128, pred_iou_thresh=-10.0, stability_score_thresh=0.0)
    with torch.device("meta"):
        meta = SAM(cfg)
    sd = {k: v.cuda() for k, v in rand_like_state_dict(meta, 1).items()}
    x = torch.from_numpy(rng.rand(1, 1024, 1024, 3).astype(np.float32)).cuda()
    pts = torch.from_numpy(rng.rand(128, 2).astype(np.float32) * 1024).cuda()[:, None]
    lbl = torch.ones(128, 1, dtype=torch.int64, device="cuda")

    def sam_run(seg):
        e = seg.sam.image_encoder(x)
        pe = seg.sam.prompt_encoder.dense_pe()
        sparse, dense = seg.sam.prompt_encoder(pts, lbl)
        m, iou = seg.sam.mask_decoder(e[0], pe, sparse, dense)
        return e, m, iou, seg.sam.mask_decoder(e[0], pe, sparse, dense, iou_only=True)[1]
    o = _stage_outputs(lambda dt: SAMSegmentor(cfg, state_dict=sd, device="cuda", dtype=dt),
                       sam_run, (f32, b16))
    del sd
    res["sam_encode"] = q99_rel(o[b16][0], o[f32][0])
    res["amg_decode_masks"] = q99_rel(o[b16][1], o[f32][1])
    res["amg_decode_iou"] = q99_rel(o[b16][2], o[f32][2])
    res["amg_decode_iou_only"] = q99_rel(o[b16][3], o[f32][3])

    icfg = ISMConfig()
    d = icfg.dinov2
    with torch.device("meta"):
        meta = DINOv2(d.img_size, d.patch_size, d.embed_dim, d.depth, d.num_heads)
    sd = {k: v.cuda() for k, v in rand_like_state_dict(meta, 2).items()}
    crops = torch.from_numpy(rng.rand(32, d.img_size, d.img_size, 3).astype(np.float32)).cuda()
    o = _stage_outputs(lambda dt: ISMPipeline(icfg, state_dict=sd, device="cuda", dtype=dt),
                       lambda pipe: pipe.dinov2(crops), (f32, b16))
    del sd
    res["dinov2_cls"] = q99_rel(o[b16][0], o[f32][0])
    res["dinov2_patch"] = q99_rel(o[b16][1], o[f32][1])
    valid = torch.ones(128, dtype=torch.bool)
    scores = {}
    for dt in (f32, b16):
        cls = torch.from_numpy(o[dt][0])
        ref = torch.from_numpy(o[f32][0][:42]).to(dt).float()[None]
        scores[dt] = ism_scoring.semantic_scores(torch.cat([cls] * 4)[:128], ref, valid,
                                                 "avg_5", 0.2)["score"].numpy()
    res["ism_scores"] = q99_rel(scores[b16], scores[f32])

    pcfg = PEMConfig()
    with torch.device("meta"):
        meta = PEMNet(pcfg)
    sd = {k: v.cuda() for k, v in conditioned_pem_state_dict(
        rand_like_state_dict(meta, 3)).items()}
    pem32 = PEMPipeline(pcfg, state_dict=sd, device="cuda")

    def features(rgb, choose):
        with torch.inference_mode():
            return pem32.net.extract_img_feats(torch.from_numpy(rgb).cuda(),
                                               torch.from_numpy(choose).cuda()).cpu().numpy()
    frame, R_true, _ = posed_pem_frame(rng, pcfg, 16, features)
    del pem32
    inputs = {k: torch.from_numpy(v).cuda() for k, v in frame.items()}

    def pem_run(pipe):
        out = pipe.net.infer(inputs, pipe._generator(0))
        return out["pred_R"], out["pred_t"], out["pred_pose_score"]
    o = _stage_outputs(lambda dt: PEMPipeline(pcfg, state_dict=sd, device="cuda", dtype=dt),
                       pem_run, (f32, b16))
    del sd
    fp32_deg = 180.0 * rotation_q99(o[f32][0], R_true)
    res["pem_R"] = rotation_q99(o[b16][0], o[f32][0])
    res["pem_t"] = q99_rel(o[b16][1], o[f32][1])
    res["pem_score"] = q99_rel(o[b16][2], o[f32][2])
    log(f"bf16 budget, full width, the port in bf16 against the port in fp32 "
        f"({time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{k} {v:.4f} (budget {BUDGETS[BUDGET_OF.get(k, k)]})"
                    for k, v in res.items())
        + f"; PEM's fp32 pose to the frame's own: q99 {fp32_deg:.4f} deg")
    return res, fp32_deg


def _alternated(label, fns, reps=3):
    """CUDA-event times of each of `fns` ({name: callable}), in turns
    (a, b, b, a), each the median of `reps` calls; returns {name: [ms, ms]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(cuda_ms(fns[n], reps=reps))
    log(f"{label}, CUDA events (median of {reps} calls, in turns): "
        + "; ".join(f"{n} " + ", ".join(f"{m:.1f}" for m in v) + " ms"
                    for n, v in out.items()))
    return out


def phase_bf16_path(job, ptxas):
    """The bf16 main path at full width beside the fp32 one: generate_masks
    (and the fp32 segmentor's, which must reach no bf16 entry), the bf16
    K2-K4 entries on its captured iou-pass states, a 48-valid match_frame,
    PEM run_frame at B=16 and the 448 describe, their launches, times on
    CUDA events and the bf16 runs' busy share; then run_demo with
    Config(dtype="bfloat16") and a bf16 MultiObjectStream frame. Returns
    (launches per kernel on the bf16 path, {path: launches per kernel} of
    each run, the K2-K4 bf16 entries' kernel records)."""
    import dataclasses
    import torch
    from sam6d_torch.core.config import (Config, DINOv2Config, ISMConfig, ISMMatchingConfig,
                                         SAMConfig)
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM, write_pem_job
    from sam6d_torch.pipelines.demo import run_demo
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMConfig, PEMPipeline
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    from sam6d_torch.pipelines.streaming import MultiObjectStream
    f32, b16 = torch.float32, torch.bfloat16
    fns = bf16_counters()
    rgb, depth = job["rgb_arr"], job["depth_arr"]
    scfg = SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0, max_proposals=128)
    icfg = ISMConfig(matching=ISMMatchingConfig(confidence_thresh=-1.0))
    launches, paths = {}, {}

    def expect(what, got, want):
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        log(f"bf16 {what}: kernel launches {got}")
        if bad:
            raise AssertionError(f"bf16 {what}: launches (got, expected) {bad}")

    seg = {dt: SAMSegmentor(scfg, seed=SEED, device="cuda", dtype=dt) for dt in (f32, b16)}
    if not all(p.dtype == b16 for p in seg[b16].sam.parameters()):
        raise AssertionError("the bf16 segmentor holds non-bf16 parameters")
    chunks = scfg.points_per_side ** 2 // scfg.points_per_batch
    reset_counts(fns)
    out = seg[b16].generate_masks(rgb)
    torch.cuda.synchronize()
    got = read_counts(fns)
    n_kept = check_proposals(out, *rgb.shape[:2], scfg.max_proposals)
    want = {"flash_attention_relpos_bf16_cuda": scfg.encoder_depth,
            "flash_attention_relpos_cuda": 0}
    want.update({n + "_cuda": 0 for n in FACTORED})
    want.update({n + "_bf16_cuda": 2 * chunks for n in FACTORED})
    expect(f"generate_masks ({n_kept} kept)", got, want)
    launches.update({k: got[k] for k in ("flash_attention_relpos_bf16_cuda",)
                     + tuple(n + "_bf16_cuda" for n in FACTORED)})
    paths["bf16 generate_masks"] = got
    # the reverse: the float32 segmentor reaches only the float32 entries
    reset_counts(fns)
    seg[f32].generate_masks(rgb)
    torch.cuda.synchronize()
    got = read_counts(fns)
    want = {"flash_attention_relpos_bf16_cuda": 0,
            "flash_attention_relpos_cuda": scfg.encoder_depth}
    want.update({n + "_cuda": 2 * chunks for n in FACTORED})
    want.update({n + "_bf16_cuda": 0 for n in FACTORED})
    expect("(the float32 segmentor) generate_masks", got, want)
    factored_records = _check_bf16_factored(seg[b16], ptxas)
    _alternated(
        "generate_masks_device fp32 vs bf16",
        {"fp32": lambda: seg[f32].generate_masks_device(rgb),
         "bf16": lambda: seg[b16].generate_masks_device(rgb)})
    with torch.inference_mode():
        resized, _, _, _ = seg[b16].preprocess_frame_u8(rgb)
        u8 = torch.as_tensor(resized, device="cuda")
        _alternated("SAM encoder fp32 vs bf16",
                                       {str(dt).split(".")[-1]: (lambda s=seg[dt]: s._encode_u8(u8))
                                        for dt in (f32, b16)})
    device_busy(lambda: seg[b16].generate_masks_device(rgb), "bf16: generate_masks_device")
    del seg
    torch.cuda.empty_cache()

    props = job["proposals"]
    n_valid = int(props["valid"].sum())
    cloud = (load_ply(job["cad"]).sample(icfg.matching.pointcloud_sample_num,
                                         np.random.RandomState(0)) / 1000.0
             ).astype(np.float32)[None]
    ism = {}
    for dt in (f32, b16):
        ism[dt] = ISMPipeline(icfg, seed=SEED, device="cuda", dtype=dt)
        ism[dt].onboard_templates_from_dir(os.path.join(job["dir"], "templates"))
    args = (rgb, depth, K_CAM, 1.0, cloud)
    kw = dict(detections=props, apply_size_filters=False)
    reset_counts(fns)
    res16 = ism[b16].match_frame(*args, **kw)
    torch.cuda.synchronize()
    got = read_counts(fns)
    d = icfg.dinov2
    expect(f"match_frame ({n_valid} of {len(props['valid'])} valid)", got,
           {"fused_attention_qkv_bf16_cuda": d.depth * -(-n_valid // d.chunk_size),
            "fused_attention_qkv_cuda": 0})
    launches["fused_attention_qkv_bf16_cuda"] = got["fused_attention_qkv_bf16_cuda"]
    paths["bf16 match_frame"] = got
    res32 = ism[f32].match_frame(*args, **kw)
    sel = res16["valid"]
    if int(sel.sum()) != n_valid or not all(np.isfinite(res16[k][sel]).all() for k in (
            "scores", "semantic_score", "appe_score", "geometric_score")):
        raise AssertionError("bf16 match_frame: bad scores or selection")
    log(f"bf16 match_frame: scores of the valid slots against the fp32 pipeline's: max "
        f"|diff| {float(np.abs(res16['scores'][sel] - res32['scores'][sel]).max()):.2e}")
    walls = {}
    for name, dt in (("fp32", f32), ("bf16", b16), ("bf16 ", b16), ("fp32 ", f32)):
        t0 = time.perf_counter()
        ism[dt].match_frame(*args, **kw)
        walls.setdefault(name.strip(), []).append(1e3 * (time.perf_counter() - t0))
    log("match_frame wall ms (in turns): " + "; ".join(
        f"{k} " + ", ".join(f"{m:.1f}" for m in v) for k, v in walls.items()))
    with torch.inference_mode():
        rgb01 = torch.as_tensor(rgb, device="cuda").float() / 255.0
        masks = torch.as_tensor(props["masks"], device="cuda").float()
        boxes = torch.as_tensor(props["boxes"], device="cuda").int()
        _alternated(
            f"describe of {n_valid} valid fp32 vs bf16",
            {str(dt).split(".")[-1]: (lambda p=ism[dt]: p._describe_impl(rgb01, masks, boxes,
                                                                           n_valid))
             for dt in (f32, b16)})
    device_busy(lambda: ism[b16].match_frame(*args, **kw), "bf16: match_frame")
    del ism
    torch.cuda.empty_cache()

    pcfg = PEMConfig()
    with tempfile.TemporaryDirectory() as pdir:
        pjob = write_pem_job(pdir, np.random.RandomState(SEED))
        model_points = (load_ply(pjob["cad"]).sample(
            pcfg.n_sample_model_point, np.random.RandomState(0)) / 1000.0).astype(np.float32)
        pem, tem, counts = {}, {}, {}
        for dt in (f32, b16):
            pem[dt] = PEMPipeline(pcfg, seed=SEED, device="cuda", dtype=dt)
            reset_counts(fns)
            tem[dt] = pem[dt].onboard_templates(
                pem[dt].load_template_views(os.path.join(pdir, "templates")))
            onboard = read_counts(fns)
            reset_counts(fns)
            poses, _ = pem[dt].run_frame(pjob["rgb_arr"], pjob["depth_arr"], K_CAM, 1.0,
                                         pjob["dets"], model_points, tem[dt], seed=2)
            torch.cuda.synchronize()
            counts[dt] = (onboard, read_counts(fns))
            check_pose_records(poses, f"{dt} run_frame")
            if len(poses) != 16:
                raise AssertionError(f"{dt} run_frame posed {len(poses)} of 16")
        pk = ("farthest_point_sample_cuda", "two_scale_ball_query_cuda")
        for i, what in enumerate(("onboarding", "run_frame")):
            g16 = {k: counts[b16][i][k] for k in pk}
            g32 = {k: counts[f32][i][k] for k in pk}
            expect(f"PEM {what} (fp32: {g32})", g16, g32)
            if min(g16.values()) < 1:
                raise AssertionError(f"bf16 PEM {what}: K6 or K7 not launched")
        paths["bf16 PEM onboarding"], paths["bf16 PEM run_frame"] = counts[b16]
        inputs = {dt: pem[dt].prepare_frame(pjob["rgb_arr"], pjob["depth_arr"], K_CAM, 1.0,
                                            pjob["dets"], model_points, tem[dt])[0]
                  for dt in (f32, b16)}
        _alternated(
            "PEM infer_batch at B=16 fp32 vs bf16",
            {str(dt).split(".")[-1]: (lambda p=pem[dt], i=inputs[dt]: p.infer_batch(i))
             for dt in (f32, b16)})
        device_busy(lambda: pem[b16].infer_batch(inputs[b16]), "bf16: PEM infer_batch B=16")
        del pem
    torch.cuda.empty_cache()

    p448 = ISMPipeline(ISMConfig(dinov2=DINOv2Config(img_size=448)), seed=SEED, device="cuda",
                       dtype=b16)
    n = p448.cfg.dinov2.chunk_size
    with torch.inference_mode():
        m = torch.as_tensor(props["masks"][:n], device="cuda").float()
        bx = torch.as_tensor(props["boxes"][:n], device="cuda").int()
        reset_counts(fns)
        cls, patch = p448._describe_impl(rgb01, m, bx, n)
        torch.cuda.synchronize()
        got = read_counts(fns)
        ms448 = cuda_ms(lambda: p448._describe_impl(rgb01, m, bx, n), reps=3)
    expect(f"448 describe ({n} crops, {ms448:.1f} ms on CUDA events)",
           got, {"fused_attention_bf16_cuda": p448.cfg.dinov2.depth, "fused_attention_cuda": 0,
                 "fused_attention_qkv_bf16_cuda": 0})
    if not (torch.isfinite(cls).all() and torch.isfinite(patch).all()):
        raise AssertionError("bf16 448 describe: non-finite descriptors")
    launches["fused_attention_bf16_cuda"] = got["fused_attention_bf16_cuda"]
    launches["fused_attention_small_bf16_cuda"] = got["fused_attention_small_bf16_cuda"]
    del p448
    torch.cuda.empty_cache()

    # run_demo in bf16 on phase 7's templates, then a bf16 stream frame
    cfg = Config(ism=ISMConfig(sam=scfg, matching=icfg.matching), dtype="bfloat16")
    out_dir = os.path.join(job["dir"], "demo")
    reset_counts(fns)
    t0 = time.perf_counter()
    res = run_demo(cfg, job["cad"], job["rgb"], job["depth"], job["cam"], out_dir,
                   det_score_thresh=-1.0, skip_render=True, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    got = read_counts(fns)
    paths["bf16 run_demo"] = got
    if not res["pem"] or not os.path.exists(os.path.join(out_dir, "sam6d_results",
                                                          "detection_pem.json")):
        raise AssertionError("bf16 run_demo: no pose or no detection_pem.json")
    check_pose_records(res["pem"], "bf16 run_demo")
    log(f"bf16 run_demo (Config(dtype='bfloat16'), skip_render) in "
        f"{time.perf_counter() - t0:.1f} s: {len(res['ism'])} ISM records, "
        f"{len(res['pem'])} poses; split " + ", ".join(
            f"{k} {v:.1f}" for k, v in res["split_ms"].items()) + f"; launches {got}")
    for k in ("flash_attention_relpos_bf16_cuda", "fused_attention_qkv_bf16_cuda",
              "farthest_point_sample_cuda", "two_scale_ball_query_cuda"):
        if got[k] < 1:
            raise AssertionError(f"bf16 run_demo: {k} not launched")
    if got["flash_attention_relpos_cuda"] or got["fused_attention_qkv_cuda"] or any(
            got[n + "_cuda"] for n in FACTORED):
        raise AssertionError("bf16 run_demo reached an fp32 attention or factored entry")

    seg16 = SAMSegmentor(scfg, seed=SEED, device="cuda", dtype=b16)
    stream = MultiObjectStream(
        ISMPipeline(icfg, seed=SEED, device="cuda", segmentor=seg16, dtype=b16),
        PEMPipeline(pcfg, seed=SEED, device="cuda", dtype=b16), det_score_thresh=-1.0)
    mesh = load_ply(job["cad"])
    rs = np.random.RandomState(0)
    stream.onboard_object(1, os.path.join(out_dir, "templates"),
                          mesh.sample(pcfg.n_sample_model_point, rs) / 1000.0,
                          ism_points=mesh.sample(icfg.matching.pointcloud_sample_num, rs) / 1000.0)
    reset_counts(fns)
    frames = list(stream.process_stream(iter([(rgb, depth, K_CAM, 1.0)] * 2),
                                        depth_in_flight=1))
    torch.cuda.synchronize()
    got = read_counts(fns)
    paths["bf16 MultiObjectStream, 2 frames"] = got
    n_poses = sum(len(f["poses"]) for f in frames)
    for f in frames:
        check_pose_records(f["poses"], "bf16 stream")
    log(f"bf16 MultiObjectStream: {len(frames)} frames, {n_poses} poses; launches {got}")
    if n_poses < 1 or got["flash_attention_relpos_bf16_cuda"] < 1:
        raise AssertionError("the bf16 stream posed nothing or skipped the bf16 entries")
    return launches, paths, factored_records


def phase_bf16(job, ptxas):
    """Phase 12: the bf16 entries, the bf16 budget at full width, the bf16
    main path. Returns (the bf16 entries' kernel records, {path: launches
    per kernel})."""
    import torch
    from sam6d_torch.core.numerics import BUDGETS
    kernels = _check_bf16_kernels(np.random.RandomState(SEED + 7), ptxas)
    torch.cuda.empty_cache()
    budget, pem_fp32_deg = bf16_budget_stages()
    torch.cuda.empty_cache()
    launches, paths, factored_records = phase_bf16_path(job, ptxas)
    kernels += factored_records
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["path_launches"] = {p: n[k["name"]] for p, n in paths.items()}
    over = {k: v for k, v in budget.items() if v > BUDGETS[BUDGET_OF.get(k, k)]}
    if over:
        raise AssertionError(f"bf16 stages over their budget: {over}")
    # the fp32 pose the PEM stages compare against must be the frame's own:
    # against an arbitrary fp32 pose a budget would hold nothing
    if not pem_fp32_deg <= POSED_FP32_DEG:
        raise AssertionError(f"PEM's fp32 pose misses the posed frame's by {pem_fp32_deg} deg")
    return kernels, paths


# ------------------------------------------------------------------ phase 13

# an artifact against the direct call of the same network on the same card:
# the same kernels in the same order, so float32 agrees to the last bits
EXPORT_ATOL = 1e-5
EXPORT_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from sam6d_torch.deploy import load_exported
from sam6d_torch.kernels.ops import OPS
from sam6d_torch.kernels import attention_qkv, ball_query, fps
fns = dict(farthest_point_sample_cuda=fps.farthest_point_sample_cuda,
           two_scale_ball_query_cuda=ball_query.two_scale_ball_query_cuda,
           fused_attention_qkv_cuda=attention_qkv.fused_attention_qkv_cuda,
           fused_attention_qkv_bf16_cuda=attention_qkv.fused_attention_qkv_bf16_cuda)
launches = {}
for name in sys.argv[3:]:
    runner = load_exported(f"{sys.argv[2]}/{name}.pt2")
    args = torch.load(f"{sys.argv[2]}/{name}.in.pt")
    for fn in fns.values():
        fn.launches = 0
    out = runner(*args)
    torch.cuda.synchronize()
    launches[name] = {k: fn.launches for k, fn in fns.items()}
    torch.save(out, f"{sys.argv[2]}/{name}.child.pt")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "sam6d_tpu"))
assert not bad, bad
print(json.dumps(launches))
"""


def export_counters():
    from sam6d_torch.kernels import attention, attention_qkv, ball_query, fps
    return dict(farthest_point_sample_cuda=fps.farthest_point_sample_cuda,
                two_scale_ball_query_cuda=ball_query.two_scale_ball_query_cuda,
                fused_attention_qkv_cuda=attention_qkv.fused_attention_qkv_cuda,
                fused_attention_qkv_bf16_cuda=attention_qkv.fused_attention_qkv_bf16_cuda,
                fused_attention_cuda=attention.fused_attention_cuda)


def _max_err(got, want):
    import torch
    leaves = (lambda x: list(x.values()) if isinstance(x, dict) else list(x))
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(leaves(got), leaves(want)))


def _dispatch_us(qkv, heads, scale, calls=1000):
    """Host µs of one call of torch.ops.sam6d.fused_attention_qkv and of
    fused_attention_qkv_cuda at `qkv`'s shape: medians over `calls` calls
    each, alternating blocks of 100 (the card synchronized between blocks,
    outside the timing, so the launch queue never fills)."""
    import torch
    from sam6d_torch.kernels.attention_qkv import fused_attention_qkv_cuda
    ways = {"torch.ops.sam6d": torch.ops.sam6d.fused_attention_qkv,
            "ctypes wrapper": fused_attention_qkv_cuda}
    times = {k: [] for k in ways}
    with torch.inference_mode():
        for _ in range(calls // 100):
            for k, fn in ways.items():
                torch.cuda.synchronize()
                for _ in range(100):
                    t0 = time.perf_counter_ns()
                    fn(qkv, heads, scale)
                    times[k].append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def phase_export(job_dir):
    """Phase 13: the deployment artifacts (sam6d_torch/deploy) at full
    width: PEM-base at B=16 (fp32) on a synthetic job's prepared frame, the
    DINOv2-L describe at batch 16 (fp32 and bf16) and ViT-H's prompt
    decode at 16 prompts (has_mask 0 and 1). Each is exported on the card,
    saved, loaded here and in a child interpreter that imports only
    sam6d_torch, and held to the direct call (EXPORT_ATOL fp32, BF16_ATOL
    bf16) with the same kernel launches. Returns {artifact: launches}."""
    import torch
    from sam6d_torch.core.config import DINOv2Config, ISMConfig, PEMConfig, SAMConfig
    from sam6d_torch.data.synthetic import K_CAM, write_pem_job
    from sam6d_torch.deploy import (export_dinov2_describe, export_pem_infer,
                                    export_sam_decode, load_exported)
    from sam6d_torch.models.sam import SAM
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMPipeline, load_ply
    from sam6d_torch.weights.dinov2 import random_dinov2_state_dict
    from sam6d_torch.models.dinov2 import DINOv2
    from sam6d_torch.weights.sam import random_sam_state_dict

    fns = export_counters()
    rng = np.random.RandomState(SEED + 13)
    out_dir = os.path.join(job_dir, "export")
    os.makedirs(out_dir)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    programs = {}     # name -> (data, args, direct fn, atol)

    # PEM-base at B=16 on a prepared synthetic frame; the sampler's uniforms
    # are an input of the artifact
    cfg = PEMConfig()
    pipe = PEMPipeline(cfg, seed=SEED, device="cuda")
    os.makedirs(os.path.join(job_dir, "pem13"))
    job = write_pem_job(os.path.join(job_dir, "pem13"), rng)
    model_points = (load_ply(job["cad"]).sample(cfg.n_sample_model_point,
                                               np.random.RandomState(0)) / 1000.0
                    ).astype(np.float32)
    templates = pipe.onboard_templates(pipe.load_template_views(
        os.path.join(job_dir, "pem13", "templates")))
    prep, _ = pipe.prepare_frame(job["rgb_arr"], job["depth_arr"], K_CAM, 1.0, job["dets"],
                                 model_points, templates)
    B = 16
    inputs = {k: torch.as_tensor(v, device="cuda").expand(B, *v.shape[1:]).contiguous()
              for k, v in prep.items() if k in ("rgb", "rgb_choose", "pts", "model",
                                                "dense_po", "dense_fo", "pe_o")}
    inputs["u"] = torch.rand((B, 3 * cfg.coarse.nproposal1), generator=gen, device="cuda")
    t0 = time.perf_counter()
    data = export_pem_infer(cfg, pipe.net, batch_size=B, device="cuda")
    programs["pem"] = (data, time.perf_counter() - t0, (inputs,),
                       lambda x: pipe.net.infer(x, u=x["u"]), EXPORT_ATOL)

    # the DINOv2-L describe at batch 16, fp32 and bf16
    d = DINOv2Config()
    sd = random_dinov2_state_dict(DINOv2(d.img_size, d.patch_size, d.embed_dim, d.depth,
                                         d.num_heads), SEED)
    crops = torch.randn((16, d.img_size, d.img_size, 3), generator=gen, device="cuda")
    for dtype, atol in ((torch.float32, EXPORT_ATOL), (torch.bfloat16, BF16_ATOL)):
        ism = ISMPipeline(ISMConfig(dinov2=d), state_dict=sd, device="cuda", dtype=dtype)
        t0 = time.perf_counter()
        data = export_dinov2_describe(d, sd, batch=16, device="cuda", dtype=dtype)
        programs[f"describe_{str(dtype)[6:]}"] = (data, time.perf_counter() - t0, (crops,),
                                                  ism.dinov2, atol)

    # ViT-H's prompt decode at 16 prompts
    scfg = SAMConfig()
    with torch.device("meta"):
        sam = SAM(scfg)
    sam_sd = {k: v for k, v in random_sam_state_dict(sam, SEED, "cuda").items()
              if not k.startswith("image_encoder.")}
    sam = sam.to_empty(device="cuda")
    sam.load_state_dict(sam_sd, strict=False)
    pe, dec = sam.prompt_encoder.eval(), sam.mask_decoder.eval()
    g, C, P = scfg.img_size // scfg.patch_size, scfg.prompt_embed_dim, 16
    t0 = time.perf_counter()
    data = export_sam_decode(scfg, sam_sd, num_prompts=P, device="cuda")
    secs = time.perf_counter() - t0

    def decode(emb, pts, labels, mask_in, has_mask):
        dense = (has_mask * pe.embed_masks(mask_in)[0]
                 + (1.0 - has_mask) * pe.no_mask_dense())
        return dec(emb, pe.dense_pe(), pe.embed_points(pts, labels), dense)

    emb = 0.1 * torch.randn((g, g, C), generator=gen, device="cuda")
    pts = torch.rand((P, 1, 2), generator=gen, device="cuda") * scfg.img_size
    labels = torch.ones((P, 1), dtype=torch.int64, device="cuda")
    mask_in = torch.randn((P, 4 * g, 4 * g, 1), generator=gen, device="cuda")
    for has_mask in (0.0, 1.0):
        programs[f"decode_has_mask_{int(has_mask)}"] = (
            data, secs, (emb, pts, labels, mask_in,
                         torch.tensor(has_mask, device="cuda")), decode, EXPORT_ATOL)

    launches, records = {}, []
    for name, (data, secs, args, direct, atol) in programs.items():
        path = os.path.join(out_dir, f"{name}.pt2")
        with open(path, "wb") as f:
            f.write(data)
        torch.save(args, os.path.join(out_dir, f"{name}.in.pt"))
        t0 = time.perf_counter()
        runner = load_exported(path)
        load_s = time.perf_counter() - t0
        with torch.inference_mode():
            reset_counts(fns)
            got = runner(*args)
            torch.cuda.synchronize()
            art = read_counts(fns)
            reset_counts(fns)
            want = direct(*args)
            torch.cuda.synchronize()
            dir_counts = read_counts(fns)
            err = _max_err(got, want)
            ms = cuda_ms(lambda: runner(*args), reps=3)
            direct_ms = cuda_ms(lambda: direct(*args), reps=3)
        torch.save(want, os.path.join(out_dir, f"{name}.want.pt"))
        log(f"export {name}: exported in {secs:.1f} s, {len(data) / 2**20:.1f} MB, loaded in "
            f"{load_s:.1f} s; max |artifact - direct| {err:.3e} (atol {atol}); "
            f"{ms:.2f} ms artifact, {direct_ms:.2f} ms direct (CUDA events, median of 3); "
            f"launches artifact {art}, direct {dir_counts}")
        if not err <= atol:
            raise AssertionError(f"the {name} artifact disagrees with its direct call")
        if art != dir_counts:
            raise AssertionError(f"the {name} artifact launches {art}, the direct call "
                                 f"{dir_counts}")
        launches[name] = art
        del runner
    want_k5 = {"describe_float32": "fused_attention_qkv_cuda",
               "describe_bfloat16": "fused_attention_qkv_bf16_cuda"}
    for name, k in want_k5.items():
        if launches[name][k] != d.depth or sum(launches[name].values()) != d.depth:
            raise AssertionError(f"{name}: expected {d.depth} launches of {k} alone")
    if not (launches["pem"]["farthest_point_sample_cuda"] >= 1
            and launches["pem"]["two_scale_ball_query_cuda"] >= 1):
        raise AssertionError("the PEM artifact launched no FPS or no ball query")
    if any(sum(launches[n].values()) for n in launches if n.startswith("decode")):
        raise AssertionError("the decode artifact launched a kernel")

    # the same artifacts in a child interpreter that imports only sam6d_torch
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, ROOT, out_dir, *programs],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"export child failed:\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (_, _, _, _, atol) in programs.items():
        got = torch.load(os.path.join(out_dir, f"{name}.child.pt"))
        err = _max_err(got, torch.load(os.path.join(out_dir, f"{name}.want.pt")))
        if not err <= atol or any(child[name][k] != launches[name].get(k, 0)
                                  for k in child[name]):
            raise AssertionError(f"the {name} artifact in the child: max |diff| {err:.3e}, "
                                 f"launches {child[name]}")
    log(f"export: the {len(programs)} artifacts loaded and run in a child interpreter "
        f"(no jax, no sam6d_tpu) in {time.perf_counter() - t0:.1f} s, each within its "
        f"atol of the direct call with the same launches")

    qkv = torch.randn((16, 257, 3 * d.embed_dim), generator=gen, device="cuda")
    us = _dispatch_us(qkv, d.num_heads, (d.embed_dim // d.num_heads) ** -0.5)
    log(f"export: host µs a call of fused_attention_qkv at {tuple(qkv.shape)} "
        f"(median of 1000): " + ", ".join(f"{k} {v:.1f}" for k, v in us.items()))
    return launches


def main():
    sys.path.insert(0, ROOT)
    import torch
    phase_device()
    from sam6d_torch import use_strict_fp32
    use_strict_fp32()
    # K1 and K5 use the tensor cores through their own three-pass split;
    # every library matmul and every plain version stays in full fp32
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on after use_strict_fp32()")
    ptxas = phase_build()
    from sam6d_torch.core.config import ISMConfig, ISMMatchingConfig, SAMConfig
    from sam6d_torch.data.synthetic import write_ism_job
    from sam6d_torch.kernels import attention_qkv, ball_query, fps
    from sam6d_torch.pipelines.pem import PEMConfig
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    cfg = PEMConfig()
    # ViT-H SAM at full width; random weights make SAM's predicted IoU
    # meaningless, so the load is pinned as bench.py pins it
    t0 = time.perf_counter()
    seg = SAMSegmentor(SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                                 max_proposals=128), seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"sam: ViT-H SAM ({sum(p.numel() for p in seg.sam.parameters())} parameters) "
        f"random weights on the card in {time.perf_counter() - t0:.1f} s")
    kernels = phase_kernels(cfg, seg, ptxas)
    launches, _ = phase_slice(cfg)
    # random weights give arbitrary semantic scores: pin the load as bench.py
    # does, so every valid slot is selected
    ism_cfg = ISMConfig(matching=ISMMatchingConfig(confidence_thresh=-1.0))
    with tempfile.TemporaryDirectory() as job_dir:
        t0 = time.perf_counter()
        job = write_ism_job(job_dir, np.random.RandomState(SEED + 1))
        log(f"ism: synthetic job written in {time.perf_counter() - t0:.1f} s")
        ism_launches, _ = phase_ism((attention_qkv, fps, ball_query), ism_cfg,
                                    job_dir, job)
        torch.cuda.empty_cache()
        sam_launches = phase_sam(seg, ism_cfg, job_dir, job)
        torch.cuda.empty_cache()
        describe_launches = phase_frame(seg, ism_cfg, dict(job, dir=job_dir))
        torch.cuda.empty_cache()
        bop_launches, bop_rgb, bop_job = phase_bop(job_dir)
        torch.cuda.empty_cache()
        predictor_launches = phase_predictor(seg, bop_rgb, bop_job)
        del seg
        torch.cuda.empty_cache()
        train_launches, train_records = phase_train(job_dir)
        torch.cuda.empty_cache()
        option_launches = phase_options(dict(job, dir=job_dir))
        torch.cuda.empty_cache()
        bf16_kernels, bf16_paths = phase_bf16(dict(job, dir=job_dir), ptxas)
        torch.cuda.empty_cache()
        export_launches = phase_export(job_dir)
    # each kernel's count from the run of its own path: K6/K7 from the `pem`
    # CLI run of phase 4, K5 from match_frame in phase 5, K1-K4 from
    # generate_masks in phase 6, K8 (and K9, which no path calls) from the
    # 448 describe of phase 7
    launches["fused_attention_qkv_cuda"] = ism_launches["fused_attention_qkv_cuda"]
    launches.update({k: sam_launches[k] for k in SAM_KERNELS})
    launches.update({k: describe_launches[k]
                     for k in ("fused_attention_cuda", "fused_attention_small_cuda")})
    # and each kernel's launches on the BOP path (phase 8: one ISM frame,
    # the ISM stage with the PBR onboarding, the PEM stage), the predictor's
    # set_image (phase 9) and a PEM training step (phase 10)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["train_launches"] = train_launches[k["name"]]
        k.update(train_records.get(k["name"], {}))
        k["path_launches"] = {
            "bop-eval ism, one frame": bop_launches["ism_frame"][k["name"]],
            f"bop-eval ism, {BOP_FRAMES} frames + pbr onboarding":
                bop_launches["ism_stage"][k["name"]],
            "bop-eval pem": bop_launches["pem_stage"][k["name"]],
            "SAMPredictor.set_image": predictor_launches[k["name"]],
            "PEM training step": train_launches[k["name"]]}
        k["path_launches"].update({p: n[k["name"]] for p, n in option_launches.items()})
        k["path_launches"].update({p: n[k["name"]] for p, n in bf16_paths.items()})
    # the bf16 entries: their launches on the bf16 path of phase 12
    kernels += bf16_kernels
    # and every kernel's launches in each deployment artifact (phase 13)
    for k in kernels:
        k["export_launches"] = {a: n.get(k["name"], 0) for a, n in export_launches.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
