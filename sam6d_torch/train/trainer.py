"""PEM trainer on one device (port of `sam6d_tpu/train/trainer.py`).

Replaces the reference gorilla Solver (`Pose_Estimation_Model/utils/solver.py`
:15-191): one step is the aug-pose-noise init, the training forward with the
positional encodings' BatchNorm in train mode, the correspondence losses,
the backward pass and an Adam + WarmupCosine update. The JAX package's
data-parallel mesh is not ported: the batch lives on one card.

`aug_pose_noise` is split into its random draws (`draw_pose_noise`, from a
`torch.Generator` on the host, so a seed gives the same draws on any
device) and a deterministic function of them (`apply_pose_noise`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.pem import PEMNet
from ..ops.geometry import rotation_from_euler_zyx
from ..weights.pem import random_pem_state_dict
from .losses import compute_correspondence_loss, total_loss
from .lr_schedule import warmup_cosine

STD_ROTS = (15.0, 10.0, 5.0, 1.25, 1.0)


@dataclass
class PoseNoise:
    """The draws of one aug_pose_noise call: the rotation std in degrees
    (one of STD_ROTS, shared by the batch) and two (B, 3) standard
    normals, for the Euler angles and the translation."""
    std: torch.Tensor
    rot: torch.Tensor
    trans: torch.Tensor

    def to(self, device) -> "PoseNoise":
        return PoseNoise(self.std.to(device), self.rot.to(device),
                         self.trans.to(device))


def draw_pose_noise(batch_size: int, generator: Optional[torch.Generator] = None,
                    std_rots=STD_ROTS) -> PoseNoise:
    """The random half of aug_pose_noise, drawn on the host (JAX draws the
    same three things from one key: choice, then two normals)."""
    pick = torch.randint(len(std_rots), (), generator=generator)
    std = torch.tensor(std_rots, dtype=torch.float32)[pick]
    rot = torch.randn((batch_size, 3), generator=generator)
    trans = torch.randn((batch_size, 3), generator=generator)
    return PoseNoise(std, rot, trans)


def apply_pose_noise(gt_R, gt_t, noise: PoseNoise, max_rot: float = 45.0,
                     std_trans: float = 0.2, max_trans: float = 0.8):
    """The deterministic half of aug_pose_noise (reference
    model_utils.py:140-184): Euler noise of `noise.std` degrees clamped to
    max_rot, translation noise clamped to max_trans, z kept positive."""
    noise = noise.to(gt_R.device)
    angles = torch.clamp(noise.rot * noise.std, -max_rot, max_rot) * (np.pi / 180.0)
    rand_rot = rotation_from_euler_zyx(angles[:, 0], angles[:, 1], angles[:, 2])
    trans = torch.clamp(noise.trans * std_trans, -max_trans, max_trans)
    R = gt_R @ rand_rot
    t = gt_t + trans
    t = torch.cat([t[:, :2], torch.clamp(t[:, 2:], min=1e-6)], dim=1)
    return R, t


def aug_pose_noise(gt_R, gt_t, generator: Optional[torch.Generator] = None,
                   std_rots=STD_ROTS, max_rot: float = 45.0,
                   std_trans: float = 0.2, max_trans: float = 0.8):
    """Noisy init pose for fine matching: draw_pose_noise, then
    apply_pose_noise."""
    return apply_pose_noise(gt_R, gt_t, draw_pose_noise(gt_R.shape[0], generator, std_rots),
                            max_rot, std_trans, max_trans)


@dataclass
class TrainState:
    """What a step updates, in place: the network (parameters and BatchNorm
    buffers), the optimizer, the learning-rate schedule and the step."""
    net: PEMNet
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy, as MegaPoseDataset.sample_batch gives it) ->
    tensors on `device`; the camera matrix K, which the step does not read,
    is dropped."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items() if k != "K"}


class PEMTrainer:
    def __init__(self, cfg, seed: int = 1, device="cuda"):
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        t = cfg.train
        self.schedule = warmup_cosine(t.lr, t.max_iters, t.warmup_iters, t.warmup_factor)

    def init_state(self, pretrained_vit: Optional[Dict[str, torch.Tensor]] = None,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state: `state_dict` if given, else seeded random weights
        (random_pem_state_dict at self.seed); `pretrained_vit` (the MAE
        backbone, weights.pem.mae_vit_state_dict) replaces the ViT's."""
        t = self.cfg.train
        net = PEMNet(self.cfg.pem)
        net.load_state_dict(state_dict if state_dict is not None
                            else random_pem_state_dict(net, self.seed))
        if pretrained_vit is not None:
            net.feature_extraction.rgb_net.vit.load_state_dict(pretrained_vit)
        net.to(self.device)
        opt = torch.optim.Adam(net.parameters(), lr=t.lr, betas=tuple(t.betas), eps=t.eps)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: self.schedule(s) / t.lr)
        return TrainState(net, opt, sched, 0)

    def compute_loss(self, net: PEMNet, batch: Dict[str, torch.Tensor], noise: PoseNoise):
        """Forward and losses of one step: (loss, metrics). The BatchNorm
        running statistics move as a side effect."""
        cfg = self.cfg
        tem_pts = torch.cat([batch["tem1_pts"], batch["tem2_pts"]], dim=1)
        radius = torch.linalg.vector_norm(tem_pts, dim=2).amax(dim=1)
        gt_R = batch["rotation_label"]
        gt_t = batch["translation_label"] / (radius[:, None] + 1e-6)
        init_R, init_t = apply_pose_noise(gt_R, gt_t, noise)
        coarse, fine, aux = net.train_forward(batch, init_R, init_t)
        end_points = {}
        end_points.update(compute_correspondence_loss(
            coarse, aux["sparse_pm"], aux["sparse_po"], gt_R, gt_t,
            cfg.pem.coarse.loss_dis_thres, "coarse"))
        end_points.update(compute_correspondence_loss(
            fine, aux["dense_pm"], aux["dense_po"], gt_R, gt_t,
            cfg.pem.fine.loss_dis_thres, "fine"))
        return total_loss(end_points, cfg.train.loss_clamp)

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             noise: Optional[PoseNoise] = None):
        """One update on `batch` (tensors on the trainer's device) with the
        pose noise `noise`, or drawn from `generator`. Returns (state,
        metrics as detached 0-d tensors); the gradients stay in `.grad`."""
        if noise is None:
            noise = draw_pose_noise(batch["pts"].shape[0], generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.compute_loss(state.net, batch, noise)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}


def make_dummy_batch(cfg, batch_size: int, rng: Optional[np.random.RandomState] = None):
    """Synthetic host training batch with the full input contract (the JAX
    package's, same draws; numpy arrays, see batch_to_device)."""
    rng = rng or np.random.RandomState(0)
    S = cfg.pem.img_size
    NF = cfg.pem.fine_npoint
    P_ = cfg.pem.n_sample_template_point
    B = batch_size
    model_pts = (rng.rand(B, P_, 3).astype(np.float32) - 0.5) * 0.2
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    t = np.tile(np.array([[0, 0, 0.5]], np.float32), (B, 1))
    idx = rng.randint(0, P_, NF)
    obs = model_pts[:, idx] @ R.transpose(0, 2, 1) + t[:, None]
    return dict(
        pts=obs,
        rgb=rng.rand(B, S, S, 3).astype(np.float32),
        rgb_choose=rng.randint(0, S * S, (B, NF)),
        rotation_label=R,
        translation_label=t,
        tem1_rgb=rng.rand(B, S, S, 3).astype(np.float32),
        tem1_choose=rng.randint(0, S * S, (B, P_)),
        tem1_pts=model_pts,
        tem2_rgb=rng.rand(B, S, S, 3).astype(np.float32),
        tem2_choose=rng.randint(0, S * S, (B, P_)),
        tem2_pts=model_pts,
    )
