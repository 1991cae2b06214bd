"""Per-appearance latent codes. Port of lsenerf_tpu/models/embeddings.py:
the global embedding (one shared row, "global_emb") and the per-frame one
(one row per appearance id, "evs_emb"), with the eval modes zero, mean and
param, the test row seeded from train row 21, and the eval-run switch
`is_eval`."""

from __future__ import annotations

from dataclasses import dataclass

import torch

EMBEDDING_TYPES = ("global_emb", "evs_emb")
EVAL_MODES = ("zero", "mean", "param")


@dataclass(frozen=True)
class EmbeddingConfig:
    embedding_type: str = "global_emb"
    emb_dim: int = 32
    eval_mode: str = "zero"
    test_init_row: int = 21
    # an eval run routes every forward, training steps included, through
    # the eval-mode embedding
    is_eval: bool = False


def init_embedding(generator: torch.Generator, config: EmbeddingConfig, num_imgs: int = 1,
                   device="cpu") -> dict:
    """N(0, 1) init (torch nn.Embedding): one row, or one per image."""
    rows = 1 if config.embedding_type == "global_emb" else num_imgs
    return {"table": torch.randn((rows, config.emb_dim), generator=generator, device=device)}


def init_test_params(params: dict, config: EmbeddingConfig) -> dict:
    """Seed a one-row test embedding from a train row; a no-op for a
    one-row table or where the test row exists."""
    table = params["table"]
    if table.shape[0] <= 1 or "test_table" in params:
        return params
    row = min(config.test_init_row, table.shape[0] - 1)
    return dict(params, test_table=table[row : row + 1].detach().clone())


def apply_embedding(params: dict, config: EmbeddingConfig, appearance_id: torch.Tensor,
                    train: bool = True) -> torch.Tensor:
    """(n,) or (n, 1) appearance ids -> (n, emb_dim) codes. Training
    indexes the table (the global embedding always row 0); eval applies
    config.eval_mode, as does every forward of an eval run."""
    ids = appearance_id.reshape(-1)
    table = params["table"]
    n = ids.shape[0]
    if config.embedding_type == "global_emb":
        return table[0].expand(n, table.shape[1])
    if train and not config.is_eval:
        # index_select's backward adds the rows' cotangents into the table
        return table.index_select(0, ids.long())
    if config.eval_mode == "zero":
        return torch.zeros((n, table.shape[1]), dtype=table.dtype, device=table.device)
    if config.eval_mode == "mean":
        return table.mean(0).expand(n, table.shape[1])
    if config.eval_mode == "param":
        if "test_table" not in params:
            raise ValueError("eval_mode='param' needs init_test_params (the emb_eval pretrain)")
        return params["test_table"][0].expand(n, table.shape[1])
    raise ValueError(f"unknown eval_mode {config.eval_mode}")
