"""Exponential learning-rate decay (nerfstudio ExponentialDecayScheduler).
Port of lsenerf_tpu/engine/schedules.py without the warmup ramp (no caller
uses it): lr(step) = lr_init * (lr_final / lr_init) ** (step / max_steps),
held at lr_final beyond max_steps, computed in f32 as the JAX schedule is."""

from __future__ import annotations

import math

import numpy as np


def exponential_decay(lr_init: float, lr_final: float, max_steps: int):
    f32 = np.float32
    log_init, log_final = f32(math.log(lr_init)), f32(math.log(lr_final))

    def schedule(step: int) -> float:
        t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
        return float(np.exp(log_init * (f32(1) - t) + log_final * t))

    return schedule
