"""Losses: the GAN pieces of the first-stage trainers."""
