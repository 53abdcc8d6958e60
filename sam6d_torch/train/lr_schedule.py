"""WarmupCosineLR (reference gorilla scheduler, config/base.yaml:10-14), the
port of `sam6d_tpu/train/lr_schedule.py`: linear warm-up from
warmup_factor * lr over warmup_iters, then cosine decay to 0 at max_iters.

`warmup_cosine` is a plain function of the step, in optax's order of
operations; the trainer wraps it in `torch.optim.lr_scheduler.LambdaLR`.
As with optax, step k's update runs at schedule(k): the first at
lr * warmup_factor.
"""
from __future__ import annotations

import math
from typing import Callable


def warmup_cosine(lr: float, max_iters: int, warmup_iters: int = 1000,
                  warmup_factor: float = 1e-3) -> Callable[[int], float]:
    """schedule(step) -> learning rate (optax.join_schedules of a
    linear_schedule and a cosine_decay_schedule at warmup_iters)."""
    init = lr * warmup_factor
    decay_steps = max(max_iters - warmup_iters, 1)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            count = min(max(step, 0), warmup_iters)
            return (init - lr) * (1.0 - count / warmup_iters) + lr
        count = min(step - warmup_iters, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return schedule
