#!/usr/bin/env python3
"""Stage entry point of the PyTorch port: `python scripts/train_torch.py`
runs `python -m light_unet_tpu_torch.cli --mode train` with the same flags
(the counterpart of `scripts/train.py`; --device defaults to cuda)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from light_unet_tpu_torch.cli import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(["--mode", "train", *sys.argv[1:]]))
