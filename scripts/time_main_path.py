"""Time the port's main-path stages in one or more checkouts, on one GPU.

    python3 scripts/time_main_path.py ROOT [ROOT ...]

Each ROOT is a directory holding `sam6d_torch/` (this checkout, or a parent
commit unpacked with `git archive`); each is built and imported from there
in its own process, in the order given, so pass parent, change, change,
parent to see one call's drift. On seeded random weights at full width, with
the loads pinned as `chip_smoke.py` pins them, on one synthetic job
(`write_ism_job`: a 480x640 frame, 42 templates, 128 proposal slots of
which 48 are valid, 16 detections), one line a checkout:

- ViT-H `SAMSegmentor.generate_masks_device` on the frame, float32 and
  bfloat16 (1024 prompts, capacity 128): wall ms, the card synchronized
  after each call;
- `ISMPipeline.match_frame` of the 48 valid slots (DINOv2-L, float32):
  wall ms;
- PEM-base `PEMPipeline.infer_batch` at B=16 (float32) on the frame's
  prepared detections: CUDA-event ms (upload included);
- the host µs of one call of the K5 dispatch `fused_attention_qkv` and of
  its `fused_attention_qkv_cuda` at 16x257x3072 (medians of 1000 calls,
  alternating blocks of 100, synchronized between blocks).

Stage times are medians of 5 after one warm-up call. Prints one JSON
object a checkout and writes them all to chiprun_out/time_main_path.json.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPS = 5


def _wall_ms(fn):
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def _event_ms(fn):
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _dispatch_us(public, cuda_fn, args, calls=1000):
    import torch
    times = {"dispatch": [], "cuda": []}
    with torch.inference_mode():
        for _ in range(calls // 100):
            for k, fn in (("dispatch", public), ("cuda", cuda_fn)):
                torch.cuda.synchronize()
                for _ in range(100):
                    t0 = time.perf_counter_ns()
                    fn(*args)
                    times[k].append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import sam6d_torch
    from sam6d_torch import use_strict_fp32
    from sam6d_torch.core.config import ISMConfig, ISMMatchingConfig, PEMConfig, SAMConfig
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM, write_ism_job
    from sam6d_torch.kernels import _build, attention_qkv
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMPipeline
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor

    assert Path(sam6d_torch.__file__).resolve().is_relative_to(Path(root).resolve())
    use_strict_fp32()
    t0 = time.perf_counter()
    _build.load_library()
    rec = {"root": root, "build_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as job_dir:
        job = write_ism_job(job_dir, np.random.RandomState(1))
        rgb = job["rgb_arr"]
        for dtype in (torch.float32, torch.bfloat16):
            seg = SAMSegmentor(SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                                         max_proposals=128), seed=0, device="cuda",
                               dtype=dtype)
            rec[f"generate_masks_device_{str(dtype)[6:]}_ms"] = _wall_ms(
                lambda: seg.generate_masks_device(rgb))
            del seg
            torch.cuda.empty_cache()

        cfg = ISMConfig(matching=ISMMatchingConfig(confidence_thresh=-1.0))
        ism = ISMPipeline(cfg, seed=0, device="cuda")
        ism.onboard_templates_from_dir(os.path.join(job_dir, "templates"))
        cloud = (load_ply(job["cad"]).sample(cfg.matching.pointcloud_sample_num,
                                             np.random.RandomState(0))
                 / 1000.0).astype(np.float32)[None]
        rec["match_frame_48_valid_ms"] = _wall_ms(lambda: ism.match_frame(
            rgb, job["depth_arr"], K_CAM, 1.0, cloud, detections=job["proposals"],
            apply_size_filters=False))
        del ism
        torch.cuda.empty_cache()

        pcfg = PEMConfig()
        pipe = PEMPipeline(pcfg, seed=0, device="cuda")
        templates = pipe.onboard_templates(pipe.load_template_views(
            os.path.join(job_dir, "templates")))
        model_points = (load_ply(job["cad"]).sample(pcfg.n_sample_model_point,
                                                   np.random.RandomState(0)) / 1000.0
                        ).astype(np.float32)
        inputs, kept = pipe.prepare_frame(rgb, job["depth_arr"], K_CAM, 1.0, job["dets"],
                                          model_points, templates)
        assert len(kept) == 16
        rec["pem_infer_batch_b16_ms"] = _event_ms(lambda: pipe.infer_batch(inputs))

    qkv = torch.randn((16, 257, 3072), device="cuda")
    rec["k5_host_us"] = _dispatch_us(attention_qkv.fused_attention_qkv,
                                     attention_qkv.fused_attention_qkv_cuda,
                                     (qkv, 16, 64 ** -0.5))
    return rec


def main():
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    records = []
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--child", os.path.abspath(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{root} failed:\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["root_arg"] = root
        print(json.dumps(rec), flush=True)
        records.append(rec)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "time_main_path.json").write_text(json.dumps(dict(card=smi, runs=records),
                                                        indent=1))


if __name__ == "__main__":
    main()
