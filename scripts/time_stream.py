"""Time MultiObjectStream in one or more checkouts, on one GPU.

    python3 scripts/time_stream.py ROOT [ROOT ...]

Each ROOT is a directory holding `sam6d_torch/` (this checkout, or a parent
commit unpacked with `git archive`); each is built and imported from there
in its own process, in the order given, so pass parent, change, change,
parent to see one call's drift. At full width on seeded random weights
(ViT-H SAM at capacity 128 with the AMG load pinned as `chip_smoke.py`
pins it, DINOv2-L, PEM-base; confidence and detection thresholds -1), two
box objects (the synthetic job's, with its 42 templates, and a second box
rendered on the card), a warm-up frame then the 4 frames of
`write_stream_frames`, in float32 and in bfloat16, one line a checkout
and dtype:

- synchronous (submit_frame, then complete_frame): the host ms of each
  submit_frame and the CUDA-event ms from just before it to just after it
  returned (the work it queued, where it returned before that work ran;
  the time it waited, where it did not); ms per frame and p50 from the
  stream's own throughput();
- pipelined with one frame in flight (process_stream): ms per frame, p50;
- the card's busy share over one more process_stream of the 4 frames under
  torch.profiler (device op time over wall time).

A checkout whose MultiObjectStream has finish_onboarding calls it before
the frames; the warm-up frame is left out of every number in both.
Prints one JSON object a checkout and dtype and writes them all to
chiprun_out/time_stream.json.
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


def _busy_share(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    return busy / wall if busy else None


def child(root: str) -> list:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import sam6d_torch
    from sam6d_torch import use_strict_fp32
    from sam6d_torch.core.config import ISMConfig, ISMMatchingConfig, PEMConfig, SAMConfig
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.data.synthetic import K_CAM, write_ism_job, write_stream_frames
    from sam6d_torch.kernels import _build
    from sam6d_torch.pipelines.ism import ISMPipeline
    from sam6d_torch.pipelines.pem import PEMPipeline
    from sam6d_torch.pipelines.sam_amg import SAMSegmentor
    from sam6d_torch.pipelines.streaming import MultiObjectStream
    from sam6d_torch.render.templates import render_templates

    assert Path(sam6d_torch.__file__).resolve().is_relative_to(Path(root).resolve())
    use_strict_fp32()
    _build.load_library()
    records = []
    with tempfile.TemporaryDirectory() as job_dir:
        job = write_ism_job(job_dir, np.random.RandomState(1))
        cad2, _, frames = write_stream_frames(job_dir, np.random.RandomState(3))
        tdir2 = render_templates(load_ply(cad2), os.path.join(job_dir, "obj2"), device="cuda")
        objects = ((os.path.join(job_dir, "templates"), job["cad"]), (tdir2, cad2))
        items = [(rgb, depth, K_CAM, 1.0) for rgb, depth in frames]
        warm = [(job["rgb_arr"], job["depth_arr"], K_CAM, 1.0)]
        for dtype in (torch.float32, torch.bfloat16):
            icfg = ISMConfig(matching=ISMMatchingConfig(confidence_thresh=-1.0))
            pcfg = PEMConfig()
            seg = SAMSegmentor(SAMConfig(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                                         max_proposals=128), seed=0, device="cuda",
                               dtype=dtype)
            ism = ISMPipeline(icfg, seed=0, device="cuda", segmentor=seg, dtype=dtype)
            pem = PEMPipeline(pcfg, seed=0, device="cuda", dtype=dtype)

            def make_stream():
                stream = MultiObjectStream(ism, pem, det_score_thresh=-1.0)
                rng = np.random.RandomState(0)
                for i, (tdir, cad) in enumerate(objects):
                    mesh = load_ply(cad)
                    stream.onboard_object(
                        i + 1, tdir, mesh.sample(pcfg.n_sample_model_point, rng) / 1000.0,
                        ism_points=mesh.sample(icfg.matching.pointcloud_sample_num, rng)
                        / 1000.0)
                if hasattr(stream, "finish_onboarding"):
                    stream.finish_onboarding()
                return stream

            rec = {"root": root, "dtype": str(dtype)[6:]}
            stream = make_stream()
            host_ms, event_ms = [], []
            for k, item in enumerate(warm + items):
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                t0 = time.perf_counter()
                stream.submit_frame(*item)
                host = 1e3 * (time.perf_counter() - t0)
                b.record()
                stream.complete_frame()
                if k:
                    host_ms.append(host)
                    event_ms.append(a.elapsed_time(b))
            tp = stream.throughput()
            rec.update(submit_host_ms=host_ms, submit_event_ms=event_ms,
                       submit_host_ms_median=statistics.median(host_ms),
                       submit_event_ms_median=statistics.median(event_ms),
                       sync_ms_per_frame=tp["ms_per_frame"], sync_p50_ms=tp.get("p50_ms"))
            stream = make_stream()
            list(stream.process_stream(iter(warm + items), depth_in_flight=1))
            tp = stream.throughput()
            rec.update(pipelined_ms_per_frame=tp["ms_per_frame"],
                       pipelined_p50_ms=tp.get("p50_ms"))
            rec["pipelined_busy_share"] = _busy_share(
                lambda: list(stream.process_stream(iter(items), depth_in_flight=1)))
            records.append(rec)
            del stream, seg, ism, pem
            torch.cuda.empty_cache()
    return records


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
        for rec in json.loads(proc.stdout.strip().splitlines()[-1]):
            rec["root_arg"] = root
            print(json.dumps(rec), flush=True)
            records.append(rec)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "time_stream.json").write_text(json.dumps(dict(card=smi, runs=records), indent=1))


if __name__ == "__main__":
    main()
