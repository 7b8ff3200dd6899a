"""score_sde_pytorch_tpu_torch: the PyTorch/CUDA port of score_sde_pytorch_tpu.

The JAX package beside it is the reference this port is held against. The
port mirrors its module layout and names, imports torch and never JAX, and
runs its hot path through kernels written by hand for NVIDIA Hopper (H100).
"""

__version__ = "0.1.0"
