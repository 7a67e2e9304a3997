"""Deterministic synthetic data pipeline, the port of
``repro.training.data``.

Batches are a pure function of (seed, step), drawn with numpy exactly as
the reference draws them, so both packages see the same tokens, labels and
embeddings bit for bit; a restart at step N reproduces the stream. The
port hands them over as int64 (tokens, labels) and fp32 (embeds,
frontend) tensors on the device asked for (the CPU by default)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"         # audio -> embeds, vlm -> tokens+frontend
    d_model: int = 0
    n_frontend_tokens: int = 0


def batch_at_step(cfg: DataConfig, step: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    # zipf-ish token stream with some structure (repeated n-grams) so the
    # model has something to learn in the examples
    base = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = (base % (cfg.vocab - 2)) + 2
    out: Dict[str, np.ndarray] = {}
    labels = toks[:, 1:]
    if cfg.family == "audio":
        out["embeds"] = rng.standard_normal(
            (cfg.global_batch, cfg.seq_len, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = toks[:, :-1]
    out["labels"] = labels
    if cfg.family == "vlm":
        out["frontend"] = rng.standard_normal(
            (cfg.global_batch, cfg.n_frontend_tokens,
             cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in out.items()}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  device: DeviceLike = None
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at_step(cfg, step, device)
        step += 1
