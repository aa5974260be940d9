"""Training: the diffusion train step, its optimizer and EMA, remat, LR
schedules, the GAN steps, checkpoints, metrics and the config-driven runs
(`python -m sd_tpu_torch.train`)."""
