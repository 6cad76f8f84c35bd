"""grove_tpu_torch — the PyTorch / CUDA port of grove_tpu for NVIDIA Hopper.

The JAX package `grove_tpu` is the reference this package is checked
against; this one imports torch and never jax. It keeps the JAX package's
module names so each module's counterpart is easy to find:

  grove_tpu_torch.ops         attention ops; each Pallas kernel of the main
                              path becomes a CUDA kernel for sm_90a with a
                              plain torch twin beside it
  grove_tpu_torch.models      nn.Modules with the reference checkpoint names
  grove_tpu_torch.infer       greedy generation and sliding-window inference
  grove_tpu_torch.checkpoint  strict loading of reference-named state dicts
  grove_tpu_torch.data        frame sampling and normalization constants
  grove_tpu_torch._kernels    nvcc build + ctypes binding of csrc/*.cu

Configs (`grove_tpu.config`) and tokenizer-side text code (`grove_tpu.text`)
are imported from the JAX package: both are pure Python and numpy.
"""

__version__ = "0.1.0"
