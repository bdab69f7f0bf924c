"""Sampling parameters (port of ``dlrover_tpu/rl/generation.py``'s
``SamplingParams``; the rollout backend belongs to the RL slice)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 = full categorical
    max_new_tokens: int = 16
