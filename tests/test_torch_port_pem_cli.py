"""The port's `pem` entry point against the JAX package's, on the CPU at the
tiny configuration of torch_port_common, on a synthetic job written by
`sam6d_torch.data.synthetic.write_pem_job`."""
import json

import numpy as np
import pytest

from sam6d_tpu.pipelines.pem import run_demo_pem as jax_run_demo_pem
from sam6d_torch.cli.main import main
from sam6d_torch.data.synthetic import write_pem_job
from sam6d_torch.pipelines import pem as port_pem
from sam6d_torch.weights.pem import pem_state_dict_from_flax

from torch_port_common import jax_variables, tiny_cfg

LAYOUT_KEYS = ("scene_id", "image_id", "category_id", "bbox", "segmentation")


@pytest.fixture(scope="module")
def variables():
    return jax_variables(tiny_cfg())[1]


def _check_poses(results):
    for r in results:
        R = np.asarray(r["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.isfinite(r["t"]).all() and np.isfinite(r["score"])


def test_pem_cli_gives_the_jax_results_layout(variables, tmp_path, monkeypatch):
    """`python -m sam6d_torch.cli.main pem` and the JAX run_demo_pem on one
    job: same number of results, same order, same schema."""
    cfg = tiny_cfg()
    job = write_pem_job(str(tmp_path), np.random.RandomState(2), n_det=3)
    want = jax_run_demo_pem(cfg, str(tmp_path), job["cad"], job["rgb"],
                            job["depth"], job["cam"], job["seg"],
                            params=variables)
    monkeypatch.setattr(port_pem, "PEMConfig", tiny_cfg)
    main(["pem", "--output_dir", str(tmp_path), "--cad_path", job["cad"],
          "--rgb_path", job["rgb"], "--depth_path", job["depth"],
          "--cam_path", job["cam"], "--seg_path", job["seg"], "--device", "cpu"])
    with open(tmp_path / "sam6d_results" / "detection_pem.json") as f:
        got = json.load(f)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in LAYOUT_KEYS:
            assert g[k] == w[k]
    _check_poses(got)


def test_run_demo_pem_poses_every_detection_in_order(variables, tmp_path):
    """The port's run_demo_pem on the shared weights: one result per
    detection above the score threshold, in input order, each a rotation."""
    cfg = tiny_cfg()
    job = write_pem_job(str(tmp_path), np.random.RandomState(3), n_det=5)
    res = port_pem.run_demo_pem(cfg, str(tmp_path), job["cad"], job["rgb"],
                                job["depth"], job["cam"], job["seg"],
                                state_dict=pem_state_dict_from_flax(variables),
                                device="cpu")
    assert [r["bbox"] for r in res] == [d["bbox"] for d in job["dets"]]
    _check_poses(res)
