"""chip_smoke.py's replay of discrete picks in its card-vs-CPU training-step
check (phase 10), on the CPU: the CPU step takes the card's FPS picks,
structure-embedding neighbours and ball-query lists only where they part
from its own at a near-tie (within chip_smoke.REPLAY_TIE of the cloud's
largest |p|^2), and refuses any other pick."""
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from sam6d_torch.kernels.ball_query import two_scale_ball_query_plain
from sam6d_torch.kernels.fps import farthest_point_sample_plain
from sam6d_torch.models.geo_transformer import nearest_neighbours
from sam6d_torch.train.trainer import (PEMTrainer, batch_to_device, draw_pose_noise,
                                       make_dummy_batch)

from tests.test_trainer import tiny_full_cfg
from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)

# a unit square's corners and its centre: from corner 0, FPS takes the far
# corner 3, then corners 1 and 2 tie
SQUARE = torch.tensor([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0.5, 0]]],
                      dtype=torch.float64)


@pytest.mark.parametrize("case", ["tie", "far"])
def test_fps_replay_takes_a_tie_and_refuses_another_pick(case):
    own = farthest_point_sample_plain(SQUARE.float(), 4)
    assert own.tolist() == [[0, 3, 1, 2]]
    card = own.clone()
    if case == "tie":
        card[0, 2], card[0, 3] = own[0, 3], own[0, 2]
        assert smoke._check_fps_replay(SQUARE, None, card, own) == [0.0]
    else:
        card[0, 2] = 4                     # the centre, half as far
        with pytest.raises(AssertionError, match="FPS picks point 4 at step 2"):
            smoke._check_fps_replay(SQUARE, None, card, own)


@pytest.mark.parametrize("case", ["same", "tie", "far"])
def test_knn_replay_takes_a_tie_and_refuses_another_neighbour(case):
    pts = torch.tensor([[[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 3, 0], [5, 5, 5]]],
                       dtype=torch.float64)
    own = nearest_neighbours(pts.float(), 1)
    card = own.clone()
    if case == "same":
        assert smoke._check_knn_replay(pts, card, own) == 0
    elif case == "tie":                    # points 1 and 2 are both 1 from point 0
        card[0, 0, 1] = 3 - own[0, 0, 1]
        assert smoke._check_knn_replay(pts, card, own) == 1
    else:
        card[0, 0, 1] = 3
        with pytest.raises(AssertionError, match="nearest neighbours of point 0"):
            smoke._check_knn_replay(pts, card, own)


def _cloud(seed=0):
    return torch.tensor(np.random.RandomState(seed).rand(1, 200, 3) * 0.5)


@pytest.mark.parametrize("case", ["same", "boundary", "far-candidate", "missing-hit"])
def test_ball_query_replay_takes_the_radius_and_refuses_other_lists(case):
    x = _cloud()
    if case == "boundary":
        # point 5 just outside the radius of query 0 on the CPU's cloud, just
        # inside on the card's: the two lists differ by it alone
        d = x[0, 5] - x[0, 0]
        x[0, 5] = x[0, 0] + d / d.norm() * (0.1 + 1e-7)
        inside = x.clone()
        inside[0, 5] = x[0, 0] + d / d.norm() * (0.1 - 1e-7)
        own, _ = two_scale_ball_query_plain(x.float(), x.float(), 0.1, 64, 0.2, 16)
        card, _ = two_scale_ball_query_plain(inside.float(), inside.float(), 0.1, 64, 0.2, 16)
        assert bool((card != own).any())
        assert smoke._check_ball_query_replay(x, x, 0.1, card, own) >= 1
        return
    own, _ = two_scale_ball_query_plain(x.float(), x.float(), 0.1, 8, 0.2, 16)
    card = own.clone()
    if case == "same":
        assert smoke._check_ball_query_replay(x, x, 0.1, card, own) == 0
        return
    if case == "far-candidate":
        card[0, 0, 1] = int(((x[0] - x[0, 0]) ** 2).sum(-1).argmax())
    else:
        hits = sorted(set(own[0, 0].tolist()))
        assert len(hits) > 2
        kept = [h for h in hits if h != hits[1]]
        card[0, 0] = torch.tensor(kept + [kept[0]] * (8 - len(kept)))
    with pytest.raises(AssertionError, match="ball query"):
        smoke._check_ball_query_replay(x, x, 0.1, card, own)


def _step(cfg, batch, noise, picks, mode):
    trainer = PEMTrainer(cfg, seed=0, device="cpu")
    state = trainer.init_state()
    with smoke.replayed_picks(mode, picks) as rep:
        _, metrics = trainer.step(state, batch, noise=noise)
    return {k: float(v) for k, v in metrics.items()}, rep.report


@pytest.mark.parametrize("case", ["replayed", "far-pick"])
def test_replayed_picks_through_a_training_step(case):
    """A recorded step replayed on the CPU gives the same metrics with
    nothing parted; a recorded FPS pick moved to another point is refused."""
    cfg = tiny_full_cfg()
    batch = batch_to_device(make_dummy_batch(cfg, 2, np.random.RandomState(3)), "cpu")
    noise = draw_pose_noise(2, torch.Generator().manual_seed(0))
    picks = []
    want, _ = _step(cfg, batch, noise, picks, "record")
    assert [p[0] for p in picks] == ["FPS", "FPS", "nearest neighbours", "FPS",
                                     "nearest neighbours", "ball query", "ball query"]
    if case == "replayed":
        got, report = _step(cfg, batch, noise, picks, "replay")
        assert got == want
        assert report == dict(fps_calls_parted=0, fps_gaps=[], knn_rows_parted=0,
                              ball_query_rows_parted=0)
    else:
        kind, clouds, idx = picks[0]
        moved = idx.clone()
        moved[0, 1] = moved[0, 0]          # the first point again, at distance 0
        picks[0] = (kind, clouds, moved)
        with pytest.raises(AssertionError, match="FPS picks point"):
            _step(cfg, batch, noise, picks, "replay")
