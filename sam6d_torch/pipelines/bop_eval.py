"""BOP benchmark evaluation on one device.

Port of `sam6d_tpu/pipelines/bop_eval.py`:

- ISM: every test frame of a dataset through segmentation and matching
  against every onboarded object, with the size filters and per-object NMS,
  written as BOP-23 COCO json (reference
  `Instance_Segmentation_Model/run_inference.py` and
  detector.test_step/test_epoch_end :324-462);
- PEM: the ISM detections of each frame posed in chunks of 16 against
  per-object template features onboarded once, written as a BOP19 csv
  (reference `Pose_Estimation_Model/test_bop.py:99-241`).

Frames are decoded (and, for PEM, prepared) in a prefetch thread while the
device runs the previous one. With `num_shards` > 1 a process takes the
frames whose index i has i % num_shards == shard and writes a rank file;
`merge_*_shards` combine them (the reference's PL-DDP rank-file contract).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.bop import BOPObject, PEMTestFrameLoader, discover_test_scenes
from ..data.prefetch import iter_prefetched
from ..eval.bop_writer import (category_id_for, format_pose_row, save_bop19_csv,
                               save_json_bop23)
from .ism import ISMPipeline, detections_to_bop_json
from .pem import PEMPipeline, _bucket, _host_backproject


def shard_path(path: str, shard: int, num_shards: int) -> str:
    """The rank file of `shard` (reference detector.py:409-416: each rank
    writes its own file, rank 0 merges)."""
    if num_shards <= 1:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.shard{shard}of{num_shards}{ext}"


def merge_ism_shards(out_json: str, num_shards: int) -> List[Dict]:
    """The shards' ISM records, sorted by (scene, image), into `out_json`
    (reference test_epoch_end gather, detector.py:425-462)."""
    records: List[Dict] = []
    for i in range(num_shards):
        with open(shard_path(out_json, i, num_shards)) as f:
            records.extend(json.load(f))
    records.sort(key=lambda r: (r["scene_id"], r["image_id"]))
    save_json_bop23(out_json, records)
    return records


def merge_pem_shards(out_csv: str, num_shards: int) -> List[str]:
    """The shards' BOP19 rows, sorted by (scene, image), into `out_csv`."""
    rows: List[str] = []
    for i in range(num_shards):
        with open(shard_path(out_csv, i, num_shards)) as f:
            rows.extend(line.strip() for line in f.readlines()[1:] if line.strip())
    rows.sort(key=lambda r: (int(r.split(",")[0]), int(r.split(",")[1])))
    save_bop19_csv(out_csv, rows)
    return rows


def _owns(index: int, shard: int, num_shards: int) -> bool:
    return num_shards <= 1 or index % num_shards == shard


def run_ism_bop_eval(pipeline: ISMPipeline, dataset_dir: str, objects: List[BOPObject],
                     out_json: str, dataset_name: str = "",
                     max_frames: Optional[int] = None, shard: int = 0,
                     num_shards: int = 1) -> List[Dict]:
    """ISM over the test scenes of `dataset_dir` (the first `max_frames`
    frames, this shard's share of them) with the pipeline's segmentor, the
    size filters and per-object NMS; writes the records (a rank file when
    num_shards > 1) and returns them. `pipeline` is onboarded with
    `objects` in order; lmo's category ids are remapped."""
    clouds = np.stack([o.sample_points(pipeline.cfg.matching.pointcloud_sample_num)
                       for o in objects])
    scenes = discover_test_scenes(dataset_dir)

    def frames():
        n = 0
        for scene in scenes:
            for im_id in scene.frame_ids():
                if max_frames is not None and n >= max_frames:
                    return
                if _owns(n, shard, num_shards):
                    yield im_id, scene.load_frame(im_id)
                n += 1

    records: List[Dict] = []
    for im_id, frame in iter_prefetched(frames(), depth=2):
        t0 = time.time()
        result = pipeline.match_frame(frame["rgb"], frame["depth"], frame["K"],
                                      frame["depth_scale"], clouds,
                                      apply_nms_per_object=True)
        recs = detections_to_bop_json(result, scene_id=frame["scene_id"], image_id=im_id,
                                      runtime=time.time() - t0)
        for r in recs:
            r["category_id"] = category_id_for(dataset_name, r["category_id"] - 1)
        records.extend(recs)
    save_json_bop23(shard_path(out_json, shard, num_shards), records)
    return records


def run_pem_bop_eval(pipeline: PEMPipeline, dataset_dir: str, objects: List[BOPObject],
                     detections: List[Dict], out_csv: str, chunk_size: int = 16,
                     max_frames: Optional[int] = None, shard: int = 0,
                     num_shards: int = 1) -> List[str]:
    """PEM on the ISM `detections` (scored at least seg_filter_score) of the
    test scenes of `dataset_dir`: each object's templates onboarded once,
    each frame's instances posed in chunks of `chunk_size`, padded to a
    power-of-two bucket by repeating the last instance, with
    infer_batch(seed=1). Score = pose score x detection score; the time
    column is the frame's time up to its chunk's poses plus the
    detection's own. Writes the BOP19 csv (a rank file when num_shards > 1)
    and returns its rows."""
    cfg = pipeline.cfg
    loader = PEMTestFrameLoader(
        objects, img_size=cfg.img_size, n_sample_observed=cfg.n_sample_observed_point,
        n_sample_template=cfg.n_sample_template_point, n_template_view=cfg.n_template_view,
        seg_filter_score=cfg.seg_filter_score, minimum_n_point=cfg.minimum_n_point)
    # template features once an object (reference test_bop.py:117-119),
    # stacked (O, ...) so a chunk gathers its instances' by object index
    feats = [pipeline.onboard_templates(loader.template_views(obj)) for obj in objects]
    feats = {k: torch.stack([f[k] for f in feats]) for k in feats[0]}

    grouped = loader.group_detections(detections)
    scenes = {s.scene_id: s for s in discover_test_scenes(dataset_dir)}

    def frames():
        n = 0
        for fidx, ((scene_id, im_id), dets) in enumerate(sorted(grouped.items())):
            if max_frames is not None and n >= max_frames:
                return
            if not _owns(fidx, shard, num_shards):
                continue
            scene = scenes.get(scene_id)
            if scene is None:
                continue
            frame = scene.load_frame(im_id)
            # RLE decode, crops and clouds here, in the prefetch thread
            whole_pts = _host_backproject(frame["depth"], frame["depth_scale"], frame["K"])
            insts, kept = loader.assemble_instances(frame, dets, whole_pts)
            if not insts:
                continue
            yield scene_id, im_id, insts, kept
            n += 1

    dev = pipeline.device
    rows: List[str] = []
    for scene_id, im_id, insts, kept in iter_prefetched(frames(), depth=2):
        # from the moment the frame is in hand, as run_ism_bop_eval times it
        t0 = time.time()
        for c0 in range(0, len(insts), chunk_size):
            chunk, kept_chunk = insts[c0:c0 + chunk_size], kept[c0:c0 + chunk_size]
            pad = _bucket(len(chunk), cap=chunk_size) - len(chunk)

            def stack(arrs, dtype=np.float32):
                arr = np.stack(arrs).astype(dtype)
                return np.concatenate([arr, np.repeat(arr[-1:], pad, 0)]) if pad else arr

            oidx = stack([i["obj_idx"] for i in chunk], np.int64)
            inputs = dict(
                rgb=stack([i["rgb"] for i in chunk]),
                rgb_choose=stack([i["rgb_choose"] for i in chunk], np.int64),
                pts=stack([i["pts"] for i in chunk]),
                model=np.stack([objects[i].sample_points(cfg.n_sample_model_point)
                                for i in oidx]))
            inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
            oidx_t = torch.as_tensor(oidx, device=dev)
            inputs.update({k: v[oidx_t] for k, v in feats.items()})
            out = pipeline.infer_batch(inputs, seed=1)
            n = len(chunk)
            R = out["pred_R"][:n].cpu().numpy()
            t = out["pred_t"][:n].cpu().numpy() * 1000.0
            score = out["pred_pose_score"][:n].cpu().numpy()
            dt = time.time() - t0
            for i, det in enumerate(kept_chunk):
                rows.append(format_pose_row(
                    scene_id, im_id, int(det["category_id"]), float(score[i] * det["score"]),
                    R[i], t[i], dt + float(det.get("time", 0.0))))
    save_bop19_csv(shard_path(out_csv, shard, num_shards), rows)
    return rows
