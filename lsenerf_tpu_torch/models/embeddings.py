"""Appearance embeddings. Port of the global embedding of
lsenerf_tpu/models/embeddings.py (one shared row, the flagship's
"global_emb"); the per-frame embedding and its eval modes are not ported
yet."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class EmbeddingConfig:
    emb_dim: int = 32


def init_embedding(generator: torch.Generator, config: EmbeddingConfig, device="cpu") -> dict:
    """N(0, 1) init (torch nn.Embedding) of the single global row."""
    return {"table": torch.randn((1, config.emb_dim), generator=generator, device=device)}


def apply_embedding(params: dict, appearance_id: torch.Tensor) -> torch.Tensor:
    """(n,) appearance ids -> (n, emb_dim): the global row for every id, in
    train and eval alike."""
    table = params["table"]
    return table[0].expand(appearance_id.reshape(-1).shape[0], table.shape[1])
