"""KL autoencoder.

Counterpart of `sd_tpu/models/autoencoder.py` `AutoencoderKL`: `encode` is
the encoder, then `quant_conv` to the posterior's moments, a
`DiagonalGaussian`; `decode` is post_quant_conv followed by the decoder.
The module holds the TPU package's whole KL tree (`encoder`, `decoder`,
`quant_conv`, `post_quant_conv`). The VQ first stages are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sd_tpu_torch.core.config import resolve_device
from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.models.codec import Decoder, Encoder
from sd_tpu_torch.nn.layers import Conv2d


class AutoencoderKL(nn.Module):
    """The KL autoencoder; built on the card unless `device` names another."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 z_channels: int = 4, out_ch: int = 3, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        # `resolution` only places per-level attention (`attn_resolutions`),
        # which SD-v1 does not use and the port does not have yet
        del resolution
        if tuple(attn_resolutions):
            raise NotImplementedError("per-level codec attention is not ported")
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.encoder = Encoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               z_channels=z_channels, double_z=True, **kw)
        self.decoder = Decoder(ch=ch, out_ch=out_ch, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks,
                               z_channels=z_channels, **kw)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1, **kw)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, **kw)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """image [B, H, W, 3] in [-1, 1] → posterior over [B, H/8, W/8, embed_dim]."""
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, embed_dim] → image [B, 8h, 8w, out_ch] in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z))

    forward = decode
