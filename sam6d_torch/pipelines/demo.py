"""The three-stage demo pipeline (reference SAM-6D/demo.sh) in one process.

Port of `sam6d_tpu/pipelines/demo.py`: render templates -> ISM (SAM or
FastSAM proposals + DINOv2 matching) -> PEM (poses), every stage on one
device. The reference chains three OS processes through files; here the
file outputs (templates/, detection_ism.json, vis_ism.png,
detection_pem.json, vis_pem.png) stay the public contract while the masks
and features stay on the device between the stages. The three networks run
in `Config.dtype` ("float32" or "bfloat16").
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from ..core.config import Config
from ..core.params import compute_dtype
from ..data.mesh import load_mesh
from ..eval.vis import draw_detections_masks, draw_pose_bbox, side_by_side
from ..render.templates import render_templates
from .fastsam import FastSAMSegmentor
from .ism import ISMPipeline, detections_to_bop_json
from .pem import PEMPipeline
from .sam_amg import SAMSegmentor


def run_demo(
    cfg: Config,
    cad_path: str,
    rgb_path: str,
    depth_path: str,
    cam_path: str,
    output_dir: str,
    dinov2_state_dict: Optional[Dict] = None,
    sam_state_dict: Optional[Dict] = None,
    pem_state_dict: Optional[Dict] = None,
    det_score_thresh: float = 0.2,
    skip_render: bool = False,
    stability_score_thresh: Optional[float] = None,
    device="cuda",
    seed: int = 0,
) -> Dict:
    """Full demo; writes the reference demo.sh output contract under
    `output_dir` and returns dict(ism records, pem results, the ISM result
    arrays, the stage split in ms). The state dicts are port weights
    (reference names); None draws seeded random weights.

    `cfg.ism.segmentor` picks the segmentor: 'sam' (SAMSegmentor at
    `cfg.ism.sam`) or 'fastsam' (FastSAMSegmentor at `cfg.ism.fastsam`).
    As in the JAX demo, the FastSAM weights come in `sam_state_dict`
    (`weights/fastsam.py` names; the network's widths and depths are read
    from it), and `stability_score_thresh` applies to SAM only. Every
    pipeline is built in `cfg.dtype`."""
    t_start = time.perf_counter()
    dtype = compute_dtype(cfg.dtype)
    split = {}

    def lap(name, t0):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        split[name] = 1e3 * (time.perf_counter() - t0)
        return time.perf_counter()

    res_dir = os.path.join(output_dir, "sam6d_results")
    os.makedirs(res_dir, exist_ok=True)
    with open(cam_path) as f:
        cam = json.load(f)
    K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
    depth_scale = float(cam.get("depth_scale", 1.0))
    rgb = np.array(Image.open(rgb_path).convert("RGB"))
    depth = np.array(Image.open(depth_path)).astype(np.float32)
    mesh = load_mesh(cad_path)

    # stage 1: offline templates
    t0 = time.perf_counter()
    tdir = os.path.join(output_dir, "templates")
    if not skip_render or not os.path.isdir(tdir):
        render_templates(mesh, output_dir, level=cfg.ism.template_level,
                         image_size=cfg.render.image_size, device=device)
    t0 = lap("render_ms", t0)

    # stage 2: ISM
    if cfg.ism.segmentor == "fastsam":
        segmentor = FastSAMSegmentor(cfg.ism.fastsam, state_dict=sam_state_dict, seed=seed,
                                     device=device, dtype=dtype)
    else:
        sam_cfg = cfg.ism.sam
        if stability_score_thresh is not None:
            sam_cfg = dataclasses.replace(sam_cfg, stability_score_thresh=stability_score_thresh)
        segmentor = SAMSegmentor(sam_cfg, state_dict=sam_state_dict, seed=seed, device=device,
                                 dtype=dtype)
    ism = ISMPipeline(cfg.ism, state_dict=dinov2_state_dict, seed=seed, device=device,
                      segmentor=segmentor, dtype=dtype)
    t0 = lap("ism_models_ms", t0)
    ism.onboard_templates_from_dir(tdir)
    t0 = lap("ism_onboard_ms", t0)
    model_points_ism = mesh.sample(
        cfg.ism.matching.pointcloud_sample_num, np.random.RandomState(0)
    ).astype(np.float32) / 1000.0
    # reference custom demo: no size filters, no per-object NMS
    result = ism.match_frame(rgb, depth, K, depth_scale, model_points_ism[None],
                             apply_size_filters=False)
    t1 = lap("ism_frame_ms", t0)
    records = detections_to_bop_json(result, runtime=(t1 - t0))
    with open(os.path.join(res_dir, "detection_ism.json"), "w") as f:
        json.dump(records, f)
    vis = draw_detections_masks(rgb, result["masks"], result["valid"])
    Image.fromarray(side_by_side(rgb, vis)).save(os.path.join(res_dir, "vis_ism.png"))

    # stage 3: PEM
    t0 = time.perf_counter()
    pem = PEMPipeline(cfg.pem, state_dict=pem_state_dict, seed=seed, device=device,
                      dtype=dtype)
    model_points = mesh.sample(cfg.pem.n_sample_model_point,
                               np.random.RandomState(0)).astype(np.float32) / 1000.0
    templates = pem.onboard_templates(pem.load_template_views(tdir))
    t0 = lap("pem_onboard_ms", t0)
    results, _ = pem.run_frame(rgb, depth, K, depth_scale, records,
                               model_points, templates, det_score_thresh)
    lap("pem_frame_ms", t0)
    with open(os.path.join(res_dir, "detection_pem.json"), "w") as f:
        json.dump(results, f)

    if results:
        best = max(results, key=lambda r: r["score"])
        vis_pem = draw_pose_bbox(rgb, np.array(best["R"]), np.array(best["t"]),
                                 model_points * 1000.0, K)
        Image.fromarray(side_by_side(rgb, vis_pem)).save(os.path.join(res_dir, "vis_pem.png"))
    split["total_ms"] = 1e3 * (time.perf_counter() - t_start)
    return dict(ism=records, pem=results, ism_result=result, split_ms=split)
