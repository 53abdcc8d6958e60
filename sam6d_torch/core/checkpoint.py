"""Checkpoint IO (port of `sam6d_tpu/core/checkpoint.py`): the training
state, and the template onboarding caches.

Training state: one `torch.save` file a checkpoint, `{ckpt_dir}/step_{step:08d}.pt`
(the JAX package writes an orbax directory `step_{step:08d}` there), holding
the network's `state_dict` (parameters and BatchNorm buffers), the
optimizer's and the schedule's, and the step; `latest_checkpoint` picks the
highest step by name, as the JAX package's does (reference gorilla
per-epoch checkpoints with resume, `utils/solver.py:34-68`).

Template caches (npz): the reference keeps descriptors.pth /
descriptors_appe.pth beside the templates (`model/detector.py:76-128`),
invalidated by `reset_descriptors`. Same keys and format as the JAX
package's, so a cache written by either loads into the other.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def save_train_state(ckpt_dir: str, step: int, state) -> str:
    """Write `state` (train.trainer.TrainState) as step `step`; returns
    the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    torch.save({"model": state.net.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": int(state.step)}, path)
    return path


def load_train_state(path: str, state):
    """Load the checkpoint at `path` into `state` (a TrainState of the same
    configuration, e.g. a fresh PEMTrainer.init_state()), in place; returns
    it."""
    ckpt = torch.load(path, map_location=next(state.net.parameters()).device,
                      weights_only=False)
    state.net.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest-step checkpoint in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


# ----------------------------------------------------------- template caches


def save_template_cache(cache_path: str, **arrays) -> None:
    """np.savez of the named arrays (host arrays or tensors on any device)."""
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    np.savez(cache_path, **{k: v.detach().cpu().numpy() if hasattr(v, "detach")
                            else np.asarray(v) for k, v in arrays.items()})


def load_template_cache(cache_path: str) -> Optional[Dict[str, np.ndarray]]:
    """The cached arrays, or None when there is no cache file."""
    if not os.path.exists(cache_path):
        return None
    with np.load(cache_path) as data:
        return {k: data[k] for k in data.files}
