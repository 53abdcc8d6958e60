"""The port's prompted SAMPredictor against the JAX package's on the CPU, at
the tiny SAM of torch_port_common (C=32 encoder of 3 blocks, 64x64 canvas)
on one set of seeded weights: the cached embedding, then a point prompt, a
box prompt, points with a box, and a call fed the first call's low-res
logits, in multi- and single-mask modes.

Tolerances: the embedding atol 3e-4 (the JAX package's own encoder
tolerance); iou predictions, low-res logits and mask logits atol = rtol =
1e-4; masks exact, except pixels whose logit lies within 1e-4 of 0."""
import numpy as np
import pytest

from sam6d_tpu.pipelines.predictor import SAMPredictor as JaxSAMPredictor
from sam6d_tpu.pipelines.sam_amg import SAMSegmentor as JaxSAMSegmentor
from sam6d_torch.pipelines.predictor import SAMPredictor
from sam6d_torch.pipelines.sam_amg import SAMSegmentor

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, tiny_sam_cfgs, tiny_sam_weights

MASK_NEAR_ZERO = 1e-4
POINT = np.array([[32.0, 24.0]])
BOX = np.array([8.0, 8.0, 40.0, 40.0])


@pytest.fixture(scope="module")
def predictors():
    jcfg, pcfg = tiny_sam_cfgs()
    variables, sd = tiny_sam_weights(pcfg, seed=1, rng=np.random.RandomState(1))
    jpred = JaxSAMPredictor(JaxSAMSegmentor(jcfg, variables=variables))
    ppred = SAMPredictor(SAMSegmentor(pcfg, state_dict=sd, device="cpu"))
    img = (np.random.RandomState(2).rand(48, 64, 3) * 255).astype(np.uint8)
    jpred.set_image(img)
    ppred.set_image(img)
    return jpred, ppred


def _same(got, want, logits):
    """(masks, iou, low-res) of the port against JAX's; `logits` the port's
    mask logits of the same call, for the near-zero exception."""
    masks, iou, low = got
    assert masks.shape == np.asarray(want[0]).shape and masks.dtype == bool
    close(iou, want[1])
    close(low, want[2])
    differ = masks != np.asarray(want[0])
    assert (np.abs(logits[differ]) < MASK_NEAR_ZERO).all()
    assert masks.any()


def test_set_image_caches_jax_embedding(predictors):
    jpred, ppred = predictors
    assert ppred.geometry == jpred._geom == (48, 64, 48, 64)
    close(ppred.embedding, np.asarray(jpred._embedding), atol=3e-4, rtol=0)


@pytest.mark.parametrize("prompt", ["point", "box", "point+box"])
def test_prompts_match_jax(predictors, prompt):
    jpred, ppred = predictors
    kw = dict(point=dict(point_coords=POINT, point_labels=np.array([1])),
              box=dict(box=BOX),
              **{"point+box": dict(point_coords=np.array([[20.0, 30.0], [50.0, 10.0]]),
                                   point_labels=np.array([1, 0]), box=BOX)})[prompt]
    want = jpred.predict(**kw)
    got = ppred.predict(**kw)
    logits = ppred.predict(**kw, return_logits=True)[0]
    assert got[0].shape == (3, 48, 64) and got[1].shape == (3,) and got[2].shape == (3, 16, 16)
    _same(got, want, logits)
    close(logits, jpred.predict(**kw, return_logits=True)[0])


def test_mask_input_from_the_previous_call_matches_jax(predictors):
    """The reference's refinement loop: a single-mask call, then its low-res
    logits fed back with the same point as mask_input."""
    jpred, ppred = predictors
    kw = dict(point_coords=POINT, point_labels=np.array([1]), multimask_output=False)
    first = ppred.predict(**kw)
    jfirst = jpred.predict(**kw)
    _same(first, jfirst, ppred.predict(**kw, return_logits=True)[0])
    assert first[0].shape == (1, 48, 64) and first[2].shape == (1, 16, 16)
    kw2 = dict(kw, mask_input=first[2])
    got = ppred.predict(**kw2)
    want = jpred.predict(**dict(kw, mask_input=jfirst[2]))
    _same(got, want, ppred.predict(**kw2, return_logits=True)[0])
    # the mask input moves the decode
    assert np.abs(got[2] - first[2]).max() > 1e-3


def test_predict_needs_an_image_and_a_prompt():
    _, pcfg = tiny_sam_cfgs()
    pred = SAMPredictor(SAMSegmentor(pcfg, device="cpu"))
    with pytest.raises(RuntimeError, match="set_image"):
        pred.predict(POINT, np.array([1]))
    pred.set_image(np.zeros((48, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="point_coords"):
        pred.predict()
