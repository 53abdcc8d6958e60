"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device: CUDA with capability (9, 0); prints the card's name and power
     limit (nvidia-smi) and the torch / CUDA / nvcc versions;
  2. build: compiles the hand-written kernels in sam6d_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (indices exactly equal; ball-query rows may differ only
     where a pair lies within 1e-6 of r^2), timed with CUDA events;
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
     writes detection_ism.json and the `pem` CLI poses every record.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Prints the card's name and power limit, one JSON line of
kernel records (times, launches, errors, bounds), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
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
# off) and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 scores and online softmax summed in another order than the plain
# matmul + softmax (the JAX package's own tolerance for its kernel)
ATTENTION_ATOL = 2e-5
# card vs the plain CPU path through 24 fp32 DINOv2-L blocks: GEMMs and
# reductions summed in another order on the two devices
ISM_ATOL = 1e-3


def log(msg):
    print(msg, flush=True)


def bound(flops, nbytes):
    """(least ms the card could take, what bounds it) for `flops` fp32
    operations on `nbytes` moved."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
    from sam6d_torch.kernels import _build
    t0 = time.perf_counter()
    so, out = _build.build(verbose=True)
    _build.load_library()
    secs = time.perf_counter() - t0
    log(f"build: {so.name} in {secs:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    return secs


# ------------------------------------------------------------------ phase 3

def _check_fps(name, pts, npoint, fps):
    import torch
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


def phase_kernels(cfg):
    """Each kernel against its plain version at every shape the main path
    gives it. FPS: exact indices. Ball query: exact indices, except rows
    holding a pair within NEAR_R2 of r^2 (the two versions round the
    expanded distance differently). Fused attention: within ATTENTION_ATOL."""
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
    # Ball query: the warps walk 32-candidate slices until both quotas are
    # full; each scanned pair costs 15 ops (two dot products, the expanded
    # distance, two compares).
    f_bound = bound(16 * (n_coarse - 1) * n_obs * 10,
                    4 * 16 * n_obs * 3 + 4 * 16 * n_coarse)
    b_bound = bound(15 * _ball_query_scanned_pairs(pts, args),
                    2 * 4 * 16 * n_fine * 3 + 4 * 16 * n_fine * (args[1] + args[3]))
    return [
        dict(name="farthest_point_sample_cuda", route="cuda",
             source="sam6d_torch/csrc/fps.cu",
             replaces="sam6d_tpu/kernels/fps.py:56",
             max_abs_err=max(f_err, t_err, o_err), tolerance="exact indices",
             ms=f_ms, plain_ms=f_plain, bound_ms=f_bound[0], bound_by=f_bound[1],
             library_ms=None, onboard_ms=o_ms, onboard_plain_ms=o_plain,
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
             shapes=f"16x{n_fine}x{n_fine} (ms); 1x{n_fine}x{n_fine} checked; "
                    f"r {fm.pe_radius1}/{fm.pe_radius2}, "
                    f"s {fm.pe_nsample1}/{fm.pe_nsample2}"),
        _check_attention(rng),
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


def _check_attention(rng):
    """K5 against its plain version at the describe shape (16 crops of 257
    tokens, 16 heads of 64), a ragged batch, and N a multiple of both tiles;
    timed against its plain version and the library's SDPA on the same
    strided views."""
    import torch
    import torch.nn.functional as F
    from sam6d_torch.kernels import attention_qkv as att

    heads, hd = 16, 64
    scale = hd ** -0.5
    err = 0.0
    for B, N in ((16, 257), (3, 257), (2, 256)):
        qkv = torch.from_numpy(rng.randn(B, N, 3 * heads * hd).astype(np.float32)
                               ).cuda()
        got = att.fused_attention_qkv_cuda(qkv, heads, scale)
        want = att.fused_attention_qkv_plain(qkv, heads, scale)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        log(f"attention_qkv[{B}x{N}x{3 * heads * hd}, {heads} heads]: max |diff| "
            f"{e:.2e} (atol {ATTENTION_ATOL})")
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
    b_ms, b_by = bound(4 * B * heads * N * N * hd, 4 * B * N * 3 * C + 4 * B * N * C)
    log(f"attention_qkv[16x257x3072]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="fused_attention_qkv_cuda", route="cuda",
                source="sam6d_torch/csrc/attention_qkv.cu",
                replaces="sam6d_tpu/kernels/flash_attention.py:280",
                max_abs_err=err, tolerance=f"atol {ATTENTION_ATOL}",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
                shapes="16x257x3072, 16 heads of 64 (ms); 3x257 and 2x256 checked")


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


def phase_ism(kernels_mod, cfg, device="cuda"):
    """The ISM matching slice at the width of `cfg` (DINOv2-L in the smoke) (onboarding, three
    frames of 128 slots with 48 valid, the plain-path check, detection json
    -> `pem` CLI). Returns (launches per kernel on the matching path, on the
    `pem` run of its detections)."""
    import dataclasses
    import torch
    from sam6d_torch.cli.main import main as cli_main
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM, write_ism_job
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
    rng = np.random.RandomState(SEED + 1)
    with tempfile.TemporaryDirectory() as job_dir:
        t0 = time.perf_counter()
        job = write_ism_job(job_dir, rng)
        props = job["proposals"]
        n_valid, n_slots = int(props["valid"].sum()), len(props["valid"])
        cloud = (load_ply(job["cad"]).sample(cfg.matching.pointcloud_sample_num,
                                             np.random.RandomState(0))
                 / 1000.0).astype(np.float32)[None]
        t1 = time.perf_counter()
        pipe = ISMPipeline(cfg, seed=SEED, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"ism: job written in {t1 - t0:.1f} s; DINOv2 (C={d.embed_dim}, "
            f"{d.depth} blocks, {d.num_heads} heads) random weights on the card "
            f"in {t2 - t1:.1f} s")

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


def main():
    sys.path.insert(0, ROOT)
    import torch
    phase_device()
    from sam6d_torch import use_strict_fp32
    use_strict_fp32()
    phase_build()
    from sam6d_torch.pipelines.pem import PEMConfig
    cfg = PEMConfig()
    kernels = phase_kernels(cfg)
    launches, _ = phase_slice(cfg)
    from sam6d_torch.core.config import ISMConfig, ISMMatchingConfig
    from sam6d_torch.kernels import attention_qkv, ball_query, fps
    # random weights give arbitrary semantic scores: pin the load as bench.py
    # does, so every valid slot is selected
    ism_cfg = ISMConfig(matching=ISMMatchingConfig(confidence_thresh=-1.0))
    ism_launches, _ = phase_ism((attention_qkv, fps, ball_query), ism_cfg)
    # each kernel's count from the run of its own path: K6/K7 from the `pem`
    # CLI run of phase 4, K5 from match_frame in phase 5
    launches["fused_attention_qkv_cuda"] = ism_launches["fused_attention_qkv_cuda"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
