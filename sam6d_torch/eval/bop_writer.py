"""BOP result writers, byte-compatible with the reference outputs. The port's
own copy of `sam6d_tpu/eval/bop_writer.py` (numpy).

- ISM: BOP-23 coco-style json (reference utils/inout.py save_json_bop23 :56-58
  + model/utils.py convert_npz_to_json :199-216) — see
  pipelines/ism.detections_to_bop_json for record assembly.
- PEM: BOP19 csv rows `scene_id,im_id,obj_id,score,R,t,time`
  (reference test_bop.py:166-176).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

# lmo skips object ids {3, 7}; category remap (reference model/utils.py)
LMO_OBJECT_IDS = [1, 5, 6, 8, 9, 10, 11, 12]


def category_id_for(dataset_name: str, object_index: int) -> int:
    if dataset_name == "lmo":
        return LMO_OBJECT_IDS[object_index]
    return object_index + 1


def save_json_bop23(path: str, detections: List[Dict]) -> None:
    """Sorted-by-score json list (reference inout.py:56-58 keeps the raw
    list; ordering preserved)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(detections, f)


def format_pose_row(scene_id: int, im_id: int, obj_id: int, score: float,
                    R: np.ndarray, t: np.ndarray, time_s: float) -> str:
    """One BOP19 csv row. R row-major 9 floats (space-separated), t in mm."""
    R = np.asarray(R).reshape(9)
    t = np.asarray(t).reshape(3)
    return "{},{},{},{},{},{},{}".format(
        scene_id, im_id, obj_id, float(score),
        " ".join(f"{v:.8f}" for v in R),
        " ".join(f"{v:.8f}" for v in t),
        time_s)


def save_bop19_csv(path: str, rows: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for r in rows:
            f.write(r + "\n")


def save_detections_npz(file_path: str, result: Dict, scene_id: int,
                        frame_id: int, runtime: float,
                        dataset_name: str = "") -> None:
    """Per-frame npz in the reference layout (Detections.save_to_file,
    model/utils.py:153-173): category_id, xywh bbox, score, time,
    segmentation masks. Only valid detections are stored."""
    v = result["valid"]
    boxes = result["boxes"][v]
    xywh = np.stack([boxes[:, 0], boxes[:, 1],
                     boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], 1)
    cat = np.array([category_id_for(dataset_name, int(o))
                    for o in result["object_ids"][v]])
    np.savez(file_path,
             scene_id=scene_id, image_id=frame_id, category_id=cat,
             score=result["scores"][v], bbox=xywh, time=runtime,
             segmentation=result["masks"][v])


def convert_npz_to_json(npz_path: str) -> List[Dict]:
    """Reference convert_npz_to_json (model/utils.py:199-216): per-frame npz
    -> BOP-23 records with COCO RLE segmentation (native codec)."""
    from ..data.rle import rle_encode_coco

    data = np.load(npz_path)
    out = []
    for i in range(len(data["score"])):
        mask = data["segmentation"][i] > 0
        out.append({
            "scene_id": int(data["scene_id"]),
            "image_id": int(data["image_id"]),
            "category_id": int(data["category_id"][i]),
            "bbox": [float(x) for x in data["bbox"][i]],
            "score": float(data["score"][i]),
            "time": float(data["time"]),
            "segmentation": rle_encode_coco(mask),
        })
    return out
