"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device: CUDA with capability (9, 0); prints the card's name and power
     limit (nvidia-smi) and the torch / CUDA / nvcc versions;
  2. build: compiles the hand-written kernels in sam6d_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (indices exactly equal; ball-query rows may differ only
     where a pair lies within 1e-6 of r^2), timed with CUDA events;
  4. slice: writes a synthetic RGB-D job (480x640 frame, box mesh, 42
     point-splatted template views, 16 detections), runs
     `sam6d_torch.cli.main pem` at the full-width PEM-base config with seeded
     random weights, checks the poses and that both kernels launched, then
     answers three more frames through PEMPipeline.run_frame.

Prints one JSON line of kernel records, then as the last line
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


def log(msg):
    print(msg, flush=True)


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
    expanded distance differently)."""
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
    return [
        dict(name="farthest_point_sample_cuda", route="cuda",
             source="sam6d_torch/csrc/fps.cu",
             replaces="sam6d_tpu/kernels/fps.py:56",
             max_abs_err=max(f_err, t_err, o_err), tolerance="exact indices",
             ms=f_ms, plain_ms=f_plain, onboard_ms=o_ms,
             onboard_plain_ms=o_plain,
             shapes=f"16x{n_obs}->{n_coarse} (ms); 1x{n_onb}->{n_fine} "
                    f"(onboard_ms); 1x{n_fine}->{n_coarse} checked"),
        dict(name="two_scale_ball_query_cuda", route="cuda",
             source="sam6d_torch/csrc/ball_query.cu",
             replaces="sam6d_tpu/kernels/ball_query.py:68",
             max_abs_err=max(b_err, b1_err),
             tolerance=f"exact indices except rows with a pair within "
                       f"{NEAR_R2} of r^2",
             ms=b_ms, plain_ms=b_plain,
             shapes=f"16x{n_fine}x{n_fine} (ms); 1x{n_fine}x{n_fine} checked; "
                    f"r {fm.pe_radius1}/{fm.pe_radius2}, "
                    f"s {fm.pe_nsample1}/{fm.pe_nsample2}"),
    ]


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
        check_against_plain(pipe, inputs)
    return launches, frame_ms


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
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
