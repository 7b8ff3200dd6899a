"""Convert pytorch-fid InceptionV3 weights (.pth state dict) to the npz
format `score_sde_pytorch_tpu_torch.inception` loads (the same format the
JAX package's inception module loads).

Run wherever the weights are available (they cannot be downloaded in
zero-egress environments):

    python -m score_sde_pytorch_tpu_torch.tools.convert_inception_weights \\
        pt_inception-2015-12-05.pth inception_v3_fid.npz
Then point INCEPTION_WEIGHTS_NPZ at the npz.
"""
import sys

import numpy as np


def main():
  if len(sys.argv) != 3:
    raise SystemExit(__doc__)
  src, dst = sys.argv[1], sys.argv[2]
  import torch
  sd = torch.load(src, map_location="cpu", weights_only=False)
  if hasattr(sd, "state_dict"):
    sd = sd.state_dict()
  out = {}
  for k, v in sd.items():
    if k.endswith("num_batches_tracked"):
      continue
    out[k] = v.detach().cpu().numpy()
  np.savez_compressed(dst, **out)
  print(f"wrote {dst} with {len(out)} arrays")


if __name__ == "__main__":
  main()
