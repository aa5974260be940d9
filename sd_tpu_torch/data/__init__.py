"""Images, datasets and the loader (the counterpart of `sd_tpu/data`)."""
