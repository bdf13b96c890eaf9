"""hugs_tpu_torch: the PyTorch and CUDA port of hugs_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
torch and never jax or hugs_tpu; the JAX package stays the reference
that tests hold each ported function to. Entry points run on the GPU
(device="cuda") unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
