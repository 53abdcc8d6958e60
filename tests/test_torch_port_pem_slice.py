"""The PEM slice of the PyTorch port against the JAX package on the CPU, at
the tiny configuration of torch_port_common (atol = rtol = 1e-4 unless
stated): the fine half from JAX's own coarse pose, the trunk, the onboarding
caches, and the freedom of the port and chip_smoke.py from jax and
sam6d_tpu. The `pem` entry point itself is in
test_torch_port_pem_cli.py."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.pipelines.pem import PEMPipeline as JaxPEMPipeline
from sam6d_torch.pipelines import pem as port_pem
from sam6d_torch.weights.pem import pem_state_dict_from_flax

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, jax_variables, tiny_cfg, tiny_inputs, torch_net, tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    inputs = tiny_inputs(np.random.RandomState(0), cfg)
    jnet, variables = jax_variables(cfg)
    return cfg, inputs, jnet, variables, torch_net(cfg, variables)


def test_fine_half_from_jax_coarse_pose_matches_jax(setup):
    cfg, inputs, jnet, variables, net = setup
    want = jnet.apply(variables, {k: jnp.asarray(v) for k, v in inputs.items()},
                      jax.random.PRNGKey(3))
    with torch.no_grad():
        tr = net._shared_trunk({k: tt(v) for k, v in inputs.items()})
        scale = tr["radius"][:, None] + 1e-6
        model_n = tt(inputs["model"]) / scale[..., None]
        R, t, score = net.infer_fine(tr, model_n, tt(want["init_R"]),
                                     tt(want["init_t"]) / scale)
    close(R, want["pred_R"])
    close(t * scale, want["pred_t"])
    close(score, want["pred_pose_score"])


def test_trunk_matches_jax(setup):
    cfg, inputs, jnet, variables, net = setup
    want = jnet.apply(variables, {k: jnp.asarray(v) for k, v in inputs.items()},
                      method="_shared_trunk")
    with torch.no_grad():
        got = net._shared_trunk({k: tt(v) for k, v in inputs.items()})
    for k in ("fps_idx_m", "fps_idx_o"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("dense_pm", "dense_po", "dense_fm", "radius", "sparse_pm",
              "sparse_fm", "geo_m", "sparse_po", "geo_o"):
        close(got[k], want[k])


def _templates(rng, cfg, V=2):
    """Onboarding input with duplicated points (views sampled with
    replacement)."""
    S, P = cfg.img_size, cfg.n_sample_template_point
    base = (rng.rand(V, 60, 3).astype(np.float32) - 0.5) * 0.1
    return dict(rgb=rng.randn(V, S, S, 3).astype(np.float32),
                choose=rng.randint(0, S * S, (V, P)),
                pts=np.stack([b[rng.randint(0, 60, P)] for b in base]))


def test_onboard_templates_matches_jax_on_every_cached_array(setup):
    cfg, _, jnet, variables, _ = setup
    tem = _templates(np.random.RandomState(1), cfg)
    want = JaxPEMPipeline(cfg, params=variables).onboard_templates(tem)
    got = port_pem.PEMPipeline(cfg, state_dict=pem_state_dict_from_flax(variables),
                               device="cpu").onboard_templates(tem)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["fps_idx_o"].numpy(), np.asarray(want["fps_idx_o"]))
    np.testing.assert_array_equal(got["dense_po"].numpy(), np.asarray(want["dense_po"]))
    for k in ("dense_fo", "pe_o", "sparse_po", "sparse_fo"):
        close(got[k], want[k])
    # Under jit, XLA folds the `cos_v + 0.0` of the JAX embedding away, so a
    # -0.0 on the diagonal gives a wedge angle of pi there instead of the
    # reference's 0 (the eager JAX path gives 0, as the port does). Off the
    # diagonal the jitted cache matches; in full it matches eager JAX.
    off = ~np.eye(cfg.coarse_npoint + 1, dtype=bool)
    close(got["geo_o"][off], np.asarray(want["geo_o"])[off])
    po_n = want["dense_po"] / (jnp.max(jnp.linalg.norm(want["dense_po"], axis=-1)) + 1e-6)
    eager = jnet.apply(variables, po_n[None], want["dense_fo"][None],
                       method="template_trunk")
    close(got["geo_o"], eager["geo_o"][0])


def test_port_never_imports_jax():
    """Every module of sam6d_torch, found by walking the package, imports
    nothing of jax, flax, jaxlib or the JAX package sam6d_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import sam6d_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(sam6d_torch.__path__, 'sam6d_torch.')]\n"
            "assert len(names) > 20, names\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'jaxlib', 'sam6d_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_never_imports_jax():
    """chip_smoke.py, at module level or inside any function, imports
    nothing of jax, flax, jaxlib or sam6d_tpu."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    for path in ("sam6d_torch.pipelines.ism", "sam6d_torch.pipelines.bop_eval",
                 "sam6d_torch.pipelines.predictor"):
        assert path in names, path
    bad = [m for m in names if m.split(".")[0] in ("jax", "flax", "jaxlib", "sam6d_tpu")]
    assert not bad, bad
