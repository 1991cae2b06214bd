"""Exponential learning-rate decay (nerfstudio ExponentialDecayScheduler).
Port of lsenerf_tpu/engine/schedules.py: lr(step) = lr_init * (lr_final /
lr_init) ** (step / max_steps), held at lr_final beyond max_steps, with an
optional sine warmup ramp lr_init * sin(pi/2 * step / warmup_steps) over
the first warmup_steps, computed in f32 as the JAX schedule is."""

from __future__ import annotations

import math

import numpy as np


def exponential_decay(lr_init: float, lr_final: float, max_steps: int, warmup_steps: int = 0):
    f32 = np.float32
    log_init, log_final = f32(math.log(lr_init)), f32(math.log(lr_final))

    def schedule(step: int) -> float:
        s = f32(step)
        if warmup_steps > 0 and s < warmup_steps:
            ramp = np.clip(s / f32(warmup_steps), f32(0), f32(1))
            return float(f32(lr_init) * np.sin(f32(0.5 * np.pi) * ramp))
        t = np.clip(s / f32(max_steps), f32(0), f32(1))
        return float(np.exp(log_init * (f32(1) - t) + log_final * t))

    return schedule
