"""GAN loss pieces of the first-stage trainers.

Counterpart of `sd_tpu/losses/gan.py`: the hinge and vanilla discriminator
losses, the `adopt_weight` warm-up gate, the adaptive discriminator weight
‖∇nll‖ / ‖∇g‖ at the decoder's last layer, the loss configuration and the
L1 + LPIPS reconstruction NLL under a learned global logvar, summed over a
sample and averaged over the batch (the KL trainer's) or averaged over every
element (the VQ trainer's, the taming convention). The last-layer
gradients come from `torch.autograd.grad` in `sd_tpu_torch.train.gan`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """0.5·(E[relu(1−D(x))] + E[relu(1+D(x̂))])."""
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """0.5·(E[softplus(−D(x))] + E[softplus(D(x̂))])."""
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """`value` until `global_step` reaches `threshold`, then `weight`."""
    return value if global_step < threshold else weight


def calculate_adaptive_weight(nll_grad: torch.Tensor, g_grad: torch.Tensor,
                              discriminator_weight: float = 1.0,
                              max_weight: float = 1e4) -> torch.Tensor:
    """d_weight = clamp(‖∇_last nll‖ / (‖∇_last g‖ + 1e-4), 0, 1e4) ·
    disc_weight, detached. The norms are taken in the gradients' own dtype
    (bf16 under the bf16 parameter policy), as the JAX package does."""
    w = torch.linalg.vector_norm(nll_grad) / (torch.linalg.vector_norm(g_grad) + 1e-4)
    return (torch.clamp(w, 0.0, max_weight) * discriminator_weight).detach()


@dataclasses.dataclass(frozen=True)
class GanLossConfig:
    """Weights and gates of the LPIPS + discriminator loss."""

    disc_start: int = 50001
    kl_weight: float = 1e-6
    disc_weight: float = 0.5
    perceptual_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_factor: float = 1.0
    logvar_init: float = 0.0
    disc_loss: str = "hinge"           # "hinge" | "vanilla"
    codebook_weight: float = 1.0       # VQ only
    disc_conditional: bool = False
    use_adaptive_weight: bool = True

    def d_loss_fn(self):
        return hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss


def _rec_map(x: torch.Tensor, recon: torch.Tensor, perceptual: torch.Tensor | None,
             cfg: GanLossConfig) -> torch.Tensor:
    """The weighted L1 map plus the LPIPS distance [B, 1, 1, 1], in fp32."""
    rec = cfg.pixelloss_weight * (x.float() - recon.float()).abs()
    if perceptual is not None and cfg.perceptual_weight > 0:
        rec = rec + cfg.perceptual_weight * perceptual.float()
    return rec


def reconstruction_nll(x: torch.Tensor, recon: torch.Tensor, logvar: torch.Tensor,
                       perceptual: torch.Tensor | None, cfg: GanLossConfig
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll_loss, rec_loss_mean, weighted_nll): L1 plus the LPIPS map
    [B, 1, 1, 1] (or None) under the learned global logvar, in fp32."""
    rec = _rec_map(x, recon, perceptual, cfg)
    nll = rec / torch.exp(logvar) + logvar
    nll_loss = nll.sum() / x.shape[0]
    return nll_loss, rec.mean(), nll_loss


def vq_reconstruction_nll(x: torch.Tensor, recon: torch.Tensor, logvar: torch.Tensor,
                          perceptual: torch.Tensor | None, cfg: GanLossConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nll_loss, rec_loss_mean) of the VQ trainer: the same L1 + LPIPS map
    under the logvar, its MEAN over every element, in fp32."""
    rec = _rec_map(x, recon, perceptual, cfg)
    return (rec / torch.exp(logvar) + logvar).mean(), rec.mean()
