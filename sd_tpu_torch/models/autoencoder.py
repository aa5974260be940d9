"""First-stage autoencoders: the KL autoencoder and the VQ model.

Counterpart of `sd_tpu/models/autoencoder.py` `AutoencoderKL` and `VQModel`.
`AutoencoderKL`: `encode` is
the encoder, then `quant_conv` to the posterior's moments, a
`DiagonalGaussian`; `decode` is post_quant_conv followed by the decoder;
calling the module runs encode → posterior sample (or mode) → decode and
returns `(recon, posterior)`, as the TPU package's `__call__` does and as
the GAN step (`sd_tpu_torch.train.gan`) uses it. The module holds the TPU
package's whole KL tree (`encoder`, `decoder`, `quant_conv`,
`post_quant_conv`). Both place per-level attention in the encoder and
decoder where `attn_resolutions` names a level's resolution (`resolution`
halved per level; `models/codec.py`). `VQModel`: the encoder (single z), `quant_conv`, one of
the three quantizer families (`models/quantize.py`), `post_quant_conv`, the
decoder; calling it returns `(recon, codebook_loss, (perplexity, None,
indices))`, the TPU package's contract. Both store their parameters in
`dtype` and compute in `compute_dtype` (the config's `dtype`), and their
resblocks drop at `dropout` inside a training step's `dropout_rng`.
`IdentityFirstStage` is the pass-through first stage of pixel-space latent
diffusion.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.models.codec import Decoder, Encoder
from sd_tpu_torch.models.quantize import EMAVectorQuantizer, GumbelQuantize, VectorQuantizer
from sd_tpu_torch.nn.layers import Conv2d


class AutoencoderKL(nn.Module):
    """The KL autoencoder; built on the card unless `device` names another."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 z_channels: int = 4, out_ch: int = 3, dropout: float = 0.0, *,
                 dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, compute_dtype=compute_dtype, device=resolve_device(device))
        # the block layout, which the SD checkpoint walk reads
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.attn_resolutions, self.resolution = tuple(attn_resolutions), resolution
        attn = dict(attn_resolutions=attn_resolutions, resolution=resolution, dropout=dropout)
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               z_channels=z_channels, double_z=True, **attn, **kw)
        self.decoder = Decoder(ch=ch, out_ch=out_ch, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks,
                               z_channels=z_channels, **attn, **kw)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1, **kw)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, **kw)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """image [B, H, W, 3] in [-1, 1] → posterior over [B, H/8, W/8, embed_dim]."""
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, embed_dim] → image [B, 8h, 8w, out_ch] in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                sample_posterior: bool = True) -> tuple[torch.Tensor, DiagonalGaussian]:
        """(recon, posterior) of image `x`: the posterior sampled with the
        standard-normal `noise` (shape of its mean; the TPU package draws it
        from an rng), or its mode when `noise` is None or `sample_posterior`
        is off."""
        posterior = self.encode(x)
        if sample_posterior and noise is not None:
            z = posterior.sample(noise)
        else:
            z = posterior.mode()
        return self.decode(z), posterior


class VQModel(nn.Module):
    """encoder → quant_conv → quantizer → post_quant_conv → decoder; built on
    the card unless `device` names another. `quantizer_type` picks the
    family: "vq" (argmin codebook trained by its gradient), "gumbel"
    (Gumbel-softmax; its noise handed in) or "ema" (the EMA codebook, fp32
    buffers updated when called with `update=True`)."""

    def __init__(self, n_embed: int = 8192, embed_dim: int = 3, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 z_channels: int = 3, out_ch: int = 3, dropout: float = 0.0,
                 beta: float = 0.25, legacy: bool = True, remap=None,
                 sane_index_shape: bool = False, quantizer_type: str = "vq",
                 kl_weight: float = 5e-4, temp_init: float = 1.0, ema_decay: float = 0.99,
                 *, dtype=torch.float32, compute_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        ckw = dict(compute_dtype=compute_dtype, **kw)
        self.quantizer_type = quantizer_type
        attn = dict(attn_resolutions=attn_resolutions, resolution=resolution, dropout=dropout,
                    **ckw)
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               z_channels=z_channels, double_z=False, **attn)
        self.decoder = Decoder(ch=ch, out_ch=out_ch, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks, z_channels=z_channels, **attn)
        if quantizer_type == "gumbel":
            self.quantize = GumbelQuantize(n_embed, embed_dim, kl_weight=kl_weight,
                                           temp_init=temp_init, remap=remap, **kw)
        elif quantizer_type == "ema":
            self.quantize = EMAVectorQuantizer(n_embed, embed_dim, beta=beta,
                                               decay=ema_decay, device=kw["device"])
        else:
            self.quantize = VectorQuantizer(n_embed, embed_dim, beta=beta, legacy=legacy,
                                            remap=remap, sane_index_shape=sane_index_shape,
                                            **kw)
        self.quant_conv = Conv2d(z_channels, embed_dim, 1, **ckw)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, **ckw)

    def _quantize(self, h, *, gumbel=None, temp=None, update=False, deterministic=True,
                  generator=None):
        """The three families' signatures made one."""
        if self.quantizer_type == "gumbel":
            return self.quantize(h, gumbel=gumbel, temp=temp, deterministic=deterministic,
                                 generator=generator)
        if self.quantizer_type == "ema":
            return self.quantize(h, update=update)
        return self.quantize(h)

    def encode(self, x: torch.Tensor, **quantize_kw):
        """image [B, H, W, 3] → (z_q, codebook_loss, (perplexity, None, indices))."""
        return self._quantize(self.encode_pre_quant(x), **quantize_kw)

    def encode_pre_quant(self, x: torch.Tensor) -> torch.Tensor:
        """The latent before quantization (the latent-diffusion interface)."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z_q))

    def decode_with_quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Quantize a continuous latent (deterministically, no codebook
        update), then decode: the latent-diffusion decode of a VQ first stage."""
        return self.decode(self._quantize(z)[0])

    def decode_code(self, code_b: torch.Tensor, shape: tuple) -> torch.Tensor:
        """Decode codebook indices, `shape` the latent's (B, h, w, embed_dim)."""
        return self.decode(self.quantize.get_codebook_entry(code_b, shape))

    def forward(self, x: torch.Tensor, *, gumbel: torch.Tensor | None = None,
                temp: float | None = None, update: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """(recon, codebook_loss, (perplexity, None, indices)). `gumbel`,
        `generator`, `temp` and `deterministic` reach the Gumbel quantizer,
        `update` the EMA codebook."""
        z_q, diff, info = self.encode(x, gumbel=gumbel, temp=temp, update=update,
                                      deterministic=deterministic, generator=generator)
        return self.decode(z_q), diff, info


class IdentityFirstStage(nn.Module):
    """The pass-through first stage of pixel-space latent diffusion: encode,
    decode and the call return their input; `quantize` too, as (x, None,
    [None, None, None]) with `vq_interface`. No parameters; `dtype`,
    `compute_dtype` and `device` are taken and ignored."""

    def __init__(self, vq_interface: bool = False, *, dtype=None, compute_dtype=None,
                 device=None):
        super().__init__()
        self.vq_interface = vq_interface

    def encode(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return x

    def decode(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return x

    def quantize(self, x: torch.Tensor, *args, **kwargs):
        return (x, None, [None, None, None]) if self.vq_interface else x

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return x
