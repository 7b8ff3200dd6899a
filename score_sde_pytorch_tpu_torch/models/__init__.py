"""Score networks of the port. Importing the package registers them."""
from score_sde_pytorch_tpu_torch.models import (  # noqa: F401
    ddpm, ncsnpp, ncsnv2)
