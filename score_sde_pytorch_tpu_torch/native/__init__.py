"""The port's host library: the C++ batch producer and the TFRecord CRC.

Built with g++ on first use (:mod:`.build`); where it cannot be built, the
native loader and the TFRecord reader raise.
"""
from score_sde_pytorch_tpu_torch.native.loader import NativeDataLoader

__all__ = ["NativeDataLoader"]
