"""Training: the diffusion train step, its optimizer and EMA, remat, LR
schedules and the config-driven latent-diffusion runner."""
