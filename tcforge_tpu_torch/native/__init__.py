"""The port's stand-ins for the JAX package's ``native`` libraries: what a
pinned copy imports from ``tcforge_tpu_torch.native``, without FFmpeg."""
