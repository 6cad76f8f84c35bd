"""Attention ops and their CUDA kernels (see grove_tpu_torch.ops.*)."""
