"""The first stage's latent distribution.

Counterpart of `sd_tpu/core/distributions.py` `DiagonalGaussian`: moments
split on the last (NHWC channel) axis, logvar clamped to [-30, 20]. JAX's
explicit PRNG key becomes the standard-normal noise the caller hands to
`sample`, so a test can give both packages the same draw.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """Diagonal Gaussian posterior from concatenated [mean, logvar]."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, parameters: torch.Tensor, dim: int = -1) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(parameters, 2, dim=dim)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std·noise for standard-normal `noise` of the mean's shape,
        in the mean's dtype."""
        return (self.mean + self.std * noise.float()).to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        """KL divergence to `other` (or to N(0, I)), summed over the non-batch
        dims."""
        dims = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(self.mean**2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var
            - 1.0 - self.logvar + other.logvar, dim=dims)
