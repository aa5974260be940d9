"""CLIP text encoder (the SD-v1 conditioner) and the offline tokenizer.

Counterpart of `sd_tpu/models/clip_text.py`: the ViT-L/14 text tower
(vocab 49408, width 768, 12 layers, 12 heads, quick-gelu, causal mask with
a -1e9 bias, LayerNorm eps 1e-5 in fp32, final LayerNorm) with the
`clip_skip` knob, the deterministic hashing tokenizer that stands in
for the CLIP BPE when its vocab files are absent, and `import_torch_clip_text`
(a Hugging Face `CLIPTextModel` state dict into the encoder; as in the TPU
package, `from_sd_checkpoint` does not call it). Attention over 77 tokens
is plain einsum attention, as in the TPU package.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.nn.layers import Dense, LayerNorm, _empty


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    clip_skip: int = 1


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        C = cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        self.num_heads = cfg.num_heads
        self.layer_norm1 = LayerNorm(C, cfg.layer_norm_eps, **kw)
        self.q_proj = Dense(C, C, **kw)
        self.k_proj = Dense(C, C, **kw)
        self.v_proj = Dense(C, C, **kw)
        self.out_proj = Dense(C, C, **kw)
        self.layer_norm2 = LayerNorm(C, cfg.layer_norm_eps, **kw)
        self.fc1 = Dense(C, C * cfg.mlp_ratio, **kw)
        self.fc2 = Dense(C * cfg.mlp_ratio, C, **kw)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        hd = C // self.num_heads
        h = self.layer_norm1(x)
        q = self.q_proj(h).reshape(B, L, self.num_heads, hd)
        k = self.k_proj(h).reshape(B, L, self.num_heads, hd)
        v = self.v_proj(h).reshape(B, L, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
        probs = torch.softmax(logits + mask_bias, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                            v.float())
        x = x + self.out_proj(attn.reshape(B, L, C).to(x.dtype))
        h = self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))
        return x + h


class ClipTextTransformer(nn.Module):
    """CLIP text tower; returns last_hidden_state [B, L, C] (`clip_skip` = N
    takes the hidden state N-1 layers before the end, then the final LN).
    Built on the card unless `device` names another."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig(), *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw).requires_grad_(False)
        self.position_embedding = _empty((cfg.max_length, cfg.hidden_size),
                                         dtype, device)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", ClipEncoderLayer(cfg, **kw))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor,
                clip_skip: int | None = None) -> torch.Tensor:
        cfg = self.cfg
        skip = cfg.clip_skip if clip_skip is None else int(clip_skip)
        if not 1 <= skip <= cfg.num_layers:
            raise ValueError(
                f"clip_skip must be in [1, {cfg.num_layers}], got {skip}")
        L = input_ids.shape[1]
        tok = self.token_embedding(input_ids)
        x = tok + self.position_embedding[None, :L].to(tok.dtype)
        causal = torch.triu(torch.full((L, L), -1e9, dtype=torch.float32,
                                       device=x.device), diagonal=1)[None, None]
        for i in range(cfg.num_layers - skip + 1):
            x = getattr(self, f"layer_{i}")(x, causal)
        return self.final_layer_norm(x)


class SimpleHashTokenizer:
    """Deterministic stand-in tokenizer: hashes whitespace tokens into the
    CLIP vocab range with BOS/EOS/pad framing. Not the CLIP BPE — for random
    weights (tests, benchmarks) only."""

    def __init__(self, max_length: int = 77, vocab_size: int = 49408):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1

    def encode_chunk(self, text: str) -> list[int]:
        """Tokenize a fragment without special tokens."""
        return [
            int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            % (self.vocab_size - 2)
            for w in text.lower().split()
        ]

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = ([self.bos_token_id]
                   + self.encode_chunk(text)[: self.max_length - 2]
                   + [self.eos_token_id])
            out[i, : len(ids)] = ids
        return out


_HF_LAYER = (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
             ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"), ("layer_norm1", "layer_norm1"),
             ("layer_norm2", "layer_norm2"))


@torch.no_grad()
def import_torch_clip_text(model: ClipTextTransformer, state_dict: dict,
                           prefix: str = "text_model.") -> ClipTextTransformer:
    """A Hugging Face `CLIPTextModel` state dict into `model`, in place:
    `{prefix}embeddings.{token,position}_embedding.weight`,
    `{prefix}encoder.layers.{i}.self_attn.{q,k,v,out}_proj.*`, `.mlp.fc{1,2}.*`,
    `.layer_norm{1,2}.*` and `{prefix}final_layer_norm.*`; both sides keep
    torch's [out, in] layout, so nothing is transposed."""
    pairs = [("token_embedding.weight", "embeddings.token_embedding.weight"),
             ("position_embedding", "embeddings.position_embedding.weight")]
    for i in range(model.cfg.num_layers):
        for ours, theirs in _HF_LAYER:
            pairs += [(f"layer_{i}.{ours}.{leaf}", f"encoder.layers.{i}.{theirs}.{leaf}")
                      for leaf in ("weight", "bias")]
    pairs += [(f"final_layer_norm.{leaf}", f"final_layer_norm.{leaf}")
              for leaf in ("weight", "bias")]
    own = dict(model.named_parameters())
    for ours, theirs in pairs:
        src = torch.as_tensor(state_dict[prefix + theirs]).float()
        if tuple(src.shape) != tuple(own[ours].shape):
            raise ValueError(f"{prefix}{theirs}: shape {tuple(src.shape)} != {ours} "
                             f"{tuple(own[ours].shape)}")
        own[ours].copy_(src)
    return model
