"""The port's seven-dataset BOP suite driver (sam6d_torch/cli/bop_suite.py)
on the CPU at tiny widths: on two synthetic BOP trees (data/synthetic.
write_bop_job) named lmo and tless (whose models the suite reads from
models_cad), the suite's PEM stage writes the files that one `bop-eval`
call a dataset writes. The 42 templates of each object are point splats of
its model (`render-bop` is tested in test_torch_port_bop_eval.py)."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from sam6d_torch.cli import bop_suite
from sam6d_torch.cli.main import main
from sam6d_torch.core import config as pc
from sam6d_torch.data.bop import BOP_DATASETS
from sam6d_torch.data.mesh import load_ply
from sam6d_torch.data.synthetic import _splat, write_bop_job
from sam6d_torch.render.poses import template_obj_poses

from torch_port_common import one_torch_thread, tiny_cfg  # noqa: F401 (autouse)


def splat_templates(models_dir, obj_ids, out_dir, size=64):
    """rgb_i.png, mask_i.png and xyz_i.npy (float16 model coordinates, mm)
    of the 42 level-0 views of each object, from 4000 surface points."""
    K = np.array([[500.0, 0, size / 2], [0, 500.0, size / 2], [0, 0, 1]], np.float32)
    for oid in obj_ids:
        surf = load_ply(os.path.join(models_dir, f"obj_{oid:06d}.ply")).sample(
            4000, np.random.RandomState(oid))
        colour = (surf / 80.0 + 0.5).clip(0, 1) * 255.0
        d = os.path.join(out_dir, f"obj_{oid:06d}")
        os.makedirs(d)
        for i, pose in enumerate(template_obj_poses(0)):
            _, pay, hit = _splat(surf @ pose[:3, :3].T + pose[:3, 3], K, (size, size),
                                 np.concatenate([surf, colour], 1))
            Image.fromarray(pay[..., 3:].astype(np.uint8)).save(f"{d}/rgb_{i}.png")
            Image.fromarray((hit * 255).astype(np.uint8)).save(f"{d}/mask_{i}.png")
            np.save(f"{d}/xyz_{i}.npy", pay[..., :3].astype(np.float16))


def test_bop_datasets_and_suite_flags():
    from sam6d_tpu.data.bop import BOP_DATASETS as JAX_BOP_DATASETS
    assert BOP_DATASETS == JAX_BOP_DATASETS
    args = bop_suite.build_parser().parse_args(["--bop_root", "B", "--template_root", "T"])
    assert args.datasets == BOP_DATASETS and args.device == "cuda" and args.stage == "all"


def test_suite_writes_what_one_bop_eval_call_a_dataset_writes(tmp_path, monkeypatch):
    cfg = pc.Config(pem=dataclasses.replace(tiny_cfg(), n_sample_observed_point=96))
    monkeypatch.setattr(pc, "default_config", lambda: cfg)
    root, troot = tmp_path / "bop", str(tmp_path / "templates")
    job = write_bop_job(str(root / "lmo"), np.random.RandomState(0), n_test_frames=1,
                        n_pbr_images=2, n_det=4, hw=(96, 128), n_surface=2000)
    shutil.copytree(root / "lmo", root / "tless")
    os.rename(root / "tless" / "models", root / "tless" / "models_cad")
    splat_templates(str(root / "lmo" / "models"), job["obj_ids"], os.path.join(troot, "lmo"))
    shutil.copytree(os.path.join(troot, "lmo"), os.path.join(troot, "tless"))

    single, suite = tmp_path / "single", tmp_path / "suite"
    for name in ("lmo", "tless"):
        # the PEM stage reads the ISM stage's json: the job's detections
        for out in (single, suite):
            os.makedirs(out / name)
            shutil.copy(job["seg_path"], out / name / f"ism_{name}.json")
        main(["bop-eval", "--dataset_dir", str(root / name), "--dataset_name", name,
              "--template_dir", troot, "--output_dir", str(single / name), "--stage", "pem",
              "--device", "cpu", "--models_dir", "models_cad" if name == "tless" else "models"])
    bop_suite.main(["--bop_root", str(root), "--template_root", troot, "--output_dir",
                    str(suite), "--datasets", "lmo", "tless", "--stage", "pem",
                    "--device", "cpu"])
    for name in ("lmo", "tless"):
        assert sorted(os.listdir(suite / name)) == sorted(os.listdir(single / name))
        rows = [(out / name / f"sam6dtpu_{name}-test.csv").read_text().splitlines()
                for out in (single, suite)]
        # the last column is the wall time of each frame
        assert [r.rsplit(",", 1)[0] for r in rows[1]] == [r.rsplit(",", 1)[0] for r in rows[0]]
        assert len(rows[0]) == 1 + len(json.load(open(job["seg_path"])))


def test_suite_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bop_suite.main(["--bop_root", str(tmp_path), "--template_root", str(tmp_path),
                        "--output_dir", str(tmp_path / "o"), "--datasets", "lmo"])
