"""Ops of the port: FIR resampling (torch convolutions) and attention (a
hand-written Hopper kernel beside its plain PyTorch version)."""
