"""Textual inversion's embedding files and the text encoder's rows.

Counterpart of the helpers of `sd_tpu/train/textual_inversion.py`
(arXiv:2208.01618): a learned concept is `num_vectors` rows of the text
encoder's token-embedding table, assigned to a placeholder token whose
expansion words ('<ph>', '<ph>#1', ...) each map to one token id. The
embedding file is `.safetensors`, {placeholder: [num_vectors, hidden]}
(`save_embedding`); `Text2ImagePipeline.load_textual_inversion` reads it.
The trainer (`train_textual_inversion`) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from sd_tpu_torch.utils.safetensors_io import save_safetensors


def expand_placeholder(token: str, num_vectors: int) -> list[str]:
    """'<ph>' → ['<ph>', '<ph>#1', ...]: one word per vector."""
    return [token if i == 0 else f"{token}#{i}" for i in range(num_vectors)]


def placeholder_ids(tokenizer, token: str, num_vectors: int) -> np.ndarray:
    """The token id of each expansion word; each word must be one token,
    and the ids distinct."""
    if not hasattr(tokenizer, "encode_chunk"):
        raise ValueError("tokenizer must expose encode_chunk for textual inversion")
    ids = []
    for w in expand_placeholder(token, num_vectors):
        got = list(tokenizer.encode_chunk(w))
        if len(got) != 1:
            raise ValueError(f"placeholder word {w!r} tokenizes to {len(got)} ids; textual "
                             "inversion needs exactly one (use a single-token placeholder "
                             "or the hash tokenizer)")
        ids.append(got[0])
    if len(set(ids)) != len(ids):
        raise ValueError(f"placeholder expansion ids collide: {ids}")
    return np.asarray(ids, np.int64)


@torch.no_grad()
def patch_embedding_rows(clip: torch.nn.Module, ids, vectors) -> None:
    """Set rows `ids` of the text encoder's token-embedding table to
    `vectors` [len(ids), hidden], in place, in the table's dtype."""
    table = clip.token_embedding.weight
    rows = torch.as_tensor(np.asarray(ids, np.int64), device=table.device)
    table[rows] = torch.as_tensor(np.asarray(vectors, np.float32)).to(table)


def save_embedding(path: str, token: str, vectors) -> None:
    """Write {token: vectors} (fp32) as the TPU package's embedding file."""
    vectors = np.asarray(vectors, np.float32)
    save_safetensors(path, {token: vectors},
                     metadata={"sd_tpu": "textual_inversion",
                               "num_vectors": str(vectors.shape[0])})
