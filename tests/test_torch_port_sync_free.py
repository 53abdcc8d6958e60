"""The pieces that let the port's frame chain run without host reads, on the
CPU against the JAX package: the NMS fixed point (the plain version of
`csrc/nms.cu`, through `torch.ops.sam6d.nms_fixed_point`) against JAX's
`nms_masked` on exact keep sets; the device `needed_prefix` against the
host one; the describe given a device n_needed against JAX's
`_dino_forward_chunked(n_needed=jnp.int32(n))` at the tiny DINOv2 (chunk
16); the NMS operator's fake against its eager outputs; the uploads'
CPU path."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from sam6d_tpu.ops import masks as jmasks
from sam6d_tpu.pipelines.ism import ISMPipeline as JaxISMPipeline
from sam6d_torch.core.uploads import device_constant, upload
from sam6d_torch.kernels import nms
from sam6d_torch.ops import masks
from sam6d_torch.pipelines import ism as port_ism

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import tiny_dinov2_weights, tiny_ism_cfgs
from torch_port_nms_cases import NMS_CASES, nms_case

DESCRIBE_ATOL = 1e-4   # the DINOv2 parity tolerance (PERF.md §6)
THRESH = 0.5


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_fixed_point_equals_jax_nms_masked(case):
    """The operator's plain version (the CPU side of
    torch.ops.sam6d.nms_fixed_point) keeps exactly JAX's set, in the rounds
    the host loop of nms_masked_rounds counts."""
    boxes, scores, valid, groups, rounds_want = nms_case(case)
    same = groups[:, None] == groups[None, :]
    iou = np.array(jmasks.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    want = np.asarray(jmasks.nms_masked(jnp.asarray(iou), jnp.asarray(scores),
                                        jnp.asarray(valid), jnp.asarray(same), THRESH))
    args = tuple(torch.from_numpy(x) for x in (iou, scores, valid, same))
    keep, rounds = masks.nms_masked_device(*args, THRESH)
    assert keep.dtype == torch.bool and rounds.dtype == torch.int32 and rounds.dim() == 0
    np.testing.assert_array_equal(keep.numpy(), want)
    host_keep, host_rounds = masks.nms_masked_rounds(*args, THRESH)
    assert torch.equal(host_keep, keep) and host_rounds == int(rounds)
    if rounds_want is not None:
        assert int(rounds) == rounds_want
    if case == "chain_half":
        np.testing.assert_array_equal(want[:128], np.arange(128) % 2 == 0)


@pytest.mark.parametrize("case", ["random", "none", "last_only", "first_only", "all"])
def test_needed_prefix_device_equals_host(case):
    rng = np.random.RandomState(len(case))
    valid = {"random": rng.rand(128) > 0.6, "none": np.zeros(128, bool),
             "last_only": np.arange(128) == 127, "first_only": np.arange(128) == 0,
             "all": np.ones(128, bool)}[case]
    got = port_ism.needed_prefix_device(torch.from_numpy(valid))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == port_ism.needed_prefix(valid)


@pytest.fixture(scope="module")
def describe_pipes():
    jcfg, pcfg = tiny_ism_cfgs()
    jcfg = dataclasses.replace(jcfg, dinov2=dataclasses.replace(jcfg.dinov2, chunk_size=16))
    pcfg = dataclasses.replace(pcfg, dinov2=dataclasses.replace(pcfg.dinov2, chunk_size=16))
    sd, variables = tiny_dinov2_weights(pcfg, rng=np.random.RandomState(1))
    imgs = np.random.RandomState(5).rand(40, 28, 28, 3).astype(np.float32)
    return (JaxISMPipeline(jcfg, dinov2_variables=variables),
            port_ism.ISMPipeline(pcfg, state_dict=sd, device="cpu"), imgs)


@pytest.mark.parametrize("n", [0, 1, 16, 17, 40])
def test_describe_with_device_n_needed_matches_jax(describe_pipes, n):
    """A () int32 n_needed describes ceil(n / 16) chunks of the 40 crops
    (three chunks, the last padded), as JAX's loop with a device scalar;
    the rows past them are exactly zero."""
    jax_pipe, port, imgs = describe_pipes
    want_cls, want_patch = jax_pipe._dino_forward_chunked(
        jax_pipe.dinov2_vars, jnp.asarray(imgs), n_needed=jnp.int32(n))
    with torch.inference_mode():
        cls, patch = port._dino_forward_chunked(torch.from_numpy(imgs),
                                                torch.tensor(n, dtype=torch.int32))
    described = min(-(-n // 16) * 16, 40)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), atol=DESCRIBE_ATOL,
                               rtol=DESCRIBE_ATOL)
    np.testing.assert_allclose(patch.numpy(), np.asarray(want_patch), atol=DESCRIBE_ATOL,
                               rtol=DESCRIBE_ATOL)
    assert not cls[described:].any() and not patch[described:].any()
    if described:
        assert cls[:described].abs().sum(dim=1).min() > 0


@pytest.mark.parametrize("n", [1, 24, 300])
def test_nms_operator_fake_matches_eager(n):
    rng = np.random.RandomState(n)
    overlap = torch.from_numpy(np.tril(rng.rand(n, n) > 0.5, -1))
    valid = torch.from_numpy(rng.rand(n) > 0.3)
    got = nms.nms_fixed_point(overlap, valid)
    with FakeTensorMode() as mode:
        fake = nms.nms_fixed_point(mode.from_tensor(overlap), mode.from_tensor(valid))
    for f, g in zip(fake, got):
        assert (tuple(f.shape), f.dtype) == (tuple(g.shape), g.dtype)


@pytest.mark.parametrize("value", [np.float32(2.5), np.arange(6, dtype=np.float32)[::-1],
                                   np.ones((2, 3), bool)],
                         ids=["scalar", "negative_stride", "bool"])
def test_uploads_on_the_cpu_equal_as_tensor(value):
    got = upload(value, "cpu")
    want = torch.as_tensor(np.ascontiguousarray(value) if np.ndim(value) else value)
    assert got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
    key = ("test_upload", str(got.dtype), got.shape)
    first = device_constant(key, lambda: value, "cpu")
    assert device_constant(key, lambda: None, "cpu") is first and torch.equal(first, want)
