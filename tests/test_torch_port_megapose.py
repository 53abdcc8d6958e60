"""The port's training data path against the JAX package on the CPU: every
op of the gdrnpp colour chain and the chain itself, dilate_mask,
random_rotation and MegaPoseDataset.sample_batch, exactly, for the same
RandomState, on a tree `write_megapose_job` wrote; render_training_templates
file for file; the `render-training` and `train` subcommands with
`--device cpu` (train at tests/test_trainer.py's tiny_full_cfg() widths,
batch 2), and `train`'s exit 2 on an empty tree.

Tolerances: the reader is host numpy/PIL on the same files, so its batches
are equal bit for bit. The training templates are held as
test_torch_port_render.py holds render_templates: masks exact, rgb within
one level, float16 xyz within one ulp (or 1e-4 near 0).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sam6d_tpu.data import megapose as jax_megapose
from sam6d_tpu.data import mesh as jax_mesh
from sam6d_tpu.render import templates as jax_templates
from sam6d_torch.cli.main import main as cli_main
from sam6d_torch.core import config as port_config
from sam6d_torch.core.checkpoint import latest_checkpoint, load_train_state
from sam6d_torch.data import megapose
from sam6d_torch.data import mesh as port_mesh
from sam6d_torch.data.synthetic import write_megapose_job
from sam6d_torch.render import templates
from sam6d_torch.train.trainer import PEMTrainer

from tests.test_trainer import tiny_full_cfg

HW = (240, 320)
TEMPLATE_SIZE = 96
XYZ_NEAR_ZERO = 1e-4
READER = dict(img_size=64, n_sample_observed=96, n_sample_template=48)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A write_megapose_job tree whose templates the `render-training` CLI
    rendered on the CPU (at the default 512^2)."""
    root = str(tmp_path_factory.mktemp("megapose"))
    job = write_megapose_job(root, np.random.RandomState(0), n_samples=4, hw=HW)
    cli_main(["render-training", "--data_dir", root, "--source", "gso", "--device", "cpu"])
    return job


def _image(seed=7, hw=(64, 48)):
    return (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("i", range(13))
def test_colour_op_matches_jax(i):
    """Each of the 13 ops on the same image and RandomState, over seeds
    that take each op's branches (per-channel or not)."""
    p, op = megapose.GDRNPP_AUG_CHAIN[i]
    jp, jop = jax_megapose.GDRNPP_AUG_CHAIN[i]
    assert p == jp and op.__name__ == jop.__name__
    for seed in range(6):
        got = op(_image(seed), np.random.RandomState(seed))
        want = jop(_image(seed), np.random.RandomState(seed))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_colour_chain_dilate_and_rotation_match_jax():
    for seed in range(8):
        np.testing.assert_array_equal(
            megapose.color_augment(_image(seed), np.random.RandomState(seed)),
            jax_megapose.color_augment(_image(seed), np.random.RandomState(seed)))
        np.testing.assert_array_equal(megapose.random_rotation(np.random.RandomState(seed)),
                                      jax_megapose.random_rotation(np.random.RandomState(seed)))
    mask = np.random.RandomState(0).rand(40, 30) > 0.97
    np.testing.assert_array_equal(megapose.dilate_mask(mask), jax_megapose.dilate_mask(mask))


def test_megapose_tree_layout(tree):
    root = os.path.join(tree["data_dir"], "MegaPose-GSO")
    for gso_id in tree["gso_ids"]:
        d = os.path.join(root, "templates", gso_id)
        assert sorted(os.listdir(d)) == sorted(f"{n}_{i}.{e}" for i in range(2) for n, e in
                                               (("rgb", "png"), ("mask", "png"), ("xyz", "npy")))
        for i in range(2):
            m = np.array(Image.open(os.path.join(d, f"mask_{i}.png"))) == 255
            xyz = np.load(os.path.join(d, f"xyz_{i}.npy")).astype(np.float32)
            assert m.sum() > 1000
            assert np.abs(np.linalg.norm(xyz[m], axis=-1)).max() <= 1.0 + 1e-3
    ds = megapose.MegaPoseDataset(tree["data_dir"], **READER)
    assert len(ds) == 4 and len(ds.model_info["MegaPose-GSO"]) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_batch_matches_jax(tree, seed):
    """Same tree, same RandomState: the same batch bit for bit (the same
    draws in the same order: instance, dilation, samples, colour chain,
    rotation, shift, noise)."""
    got = megapose.MegaPoseDataset(tree["data_dir"], **READER).sample_batch(
        2, np.random.RandomState(seed))
    want = jax_megapose.MegaPoseDataset(tree["data_dir"], **READER).sample_batch(
        2, np.random.RandomState(seed))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # observed points lie within the template radius (the outlier cut)
    radius = np.linalg.norm(np.concatenate([got["tem1_pts"], got["tem2_pts"]], 1), axis=-1).max(1)
    local = np.einsum("bnj,bji->bni", got["pts"] - got["translation_label"][:, None],
                      got["rotation_label"])
    assert (np.linalg.norm(local, axis=-1).max(1) < radius * 1.2 + 0.02).all()


@pytest.mark.parametrize("shapenet", [False, True])
def test_render_training_templates_matches_jax(tmp_path, tree, shapenet):
    path = os.path.join(tree["data_dir"], "MegaPose-GSO", "google_scanned_objects",
                        "models_normalized", tree["gso_ids"][1], "meshes", "model.ply")
    jdir = jax_templates.render_training_templates(
        jax_mesh.load_ply(path), str(tmp_path / "jax"), shapenet=shapenet,
        image_size=TEMPLATE_SIZE)
    pdir = templates.render_training_templates(
        port_mesh.load_ply(path), str(tmp_path / "port"), shapenet=shapenet,
        image_size=TEMPLATE_SIZE, device="cpu")
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for i in range(2):
        def read(d, name):
            return np.array(Image.open(os.path.join(d, f"{name}_{i}.png"))).astype(np.int32)
        m = read(pdir, "mask")
        np.testing.assert_array_equal(m, read(jdir, "mask"))
        assert (m == 255).sum() > 200
        assert np.abs(read(pdir, "rgb") - read(jdir, "rgb")).max() <= 1
        xp = np.load(os.path.join(pdir, f"xyz_{i}.npy"))
        xj = np.load(os.path.join(jdir, f"xyz_{i}.npy"))
        assert xp.dtype == xj.dtype == np.float16
        ulp = np.spacing(np.maximum(np.abs(xp), np.abs(xj)).astype(np.float16))
        diff = np.abs(xp.astype(np.float32) - xj.astype(np.float32))
        assert (diff <= np.maximum(ulp.astype(np.float32), XYZ_NEAR_ZERO)).all()


def _tiny_train_config():
    cfg = tiny_full_cfg()
    return dataclasses.replace(
        cfg, pem=dataclasses.replace(cfg.pem, n_sample_observed_point=96),
        train=dataclasses.replace(cfg.train, batch_size=2, log_every=1,
                                  checkpoint_every=2))


def test_train_cli_on_cpu(tree, tmp_path, monkeypatch, capsys):
    """`train --device cpu` for 3 steps at tiny widths: a log line a step,
    checkpoints at step 2 and at the end, the last one loadable; the stage
    split printed."""
    monkeypatch.setattr(port_config, "default_config", _tiny_train_config)
    ckpt = str(tmp_path / "ckpt")
    cli_main(["train", "--data_dir", tree["data_dir"], "--ckpt_dir", ckpt, "--iters", "3",
              "--data_workers", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    logs = [line for line in out.splitlines() if line.startswith("iter ")]
    assert [line.split(":")[0] for line in logs] == ["iter 1", "iter 2", "iter 3"]
    for line in logs:
        vals = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
        assert np.isfinite([float(v) for v in vals.values()]).all()
        assert {"loss", "coarse_loss0", "fine_loss0", "fine_acc"} <= set(vals)
    assert "stage means (ms): data" in out and ", step " in out
    assert sorted(os.listdir(ckpt)) == ["step_00000002.pt", "step_00000003.pt"]
    path = latest_checkpoint(ckpt)
    state = load_train_state(path, PEMTrainer(_tiny_train_config(), device="cpu").init_state())
    assert state.step == 3 and state.scheduler.last_epoch == 3
    assert all(torch.isfinite(p).all() for p in state.net.parameters())


def test_train_cli_exits_2_on_an_empty_tree(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["train", "--data_dir", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 2
    assert "no MegaPose shards" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["train", "render-training"])
def test_training_subcommands_default_to_the_card(tmp_path, cmd):
    """Without --device they ask for the card, and say so where there is
    none."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    argv = [cmd, "--data_dir", str(tmp_path)] + (["--source", "gso"]
                                                 if cmd == "render-training" else [])
    with pytest.raises(SystemExit) as e:
        cli_main(argv)
    assert "no CUDA device" in str(e.value.code)
