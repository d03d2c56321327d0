"""Training entry point, the counterpart of the repository's ``train.py``:

    python -m diff_unet_tpu_torch.train --config cfg/amos/train.yaml \
        data_path=/data/AMOS [max_epochs=10 ...]

trains on the NIfTI set of ``<data_path>/dataset.json`` with validation
every ``val_freq`` epochs and ``logs/<log_dir>/weights/epoch_{n}.pt``
every ``save_freq``; ``model_path=.../epoch_{n}`` resumes. ``key=value``
arguments override the config; ``device=cpu`` runs on the CPU (the
default is the card).
"""
from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    from diff_unet_tpu_torch.engine.engine import Trainer
    from diff_unet_tpu_torch.utils.config import engine_kwargs, parse_args

    Trainer(**engine_kwargs(parse_args(argv))).train()


if __name__ == "__main__":
    main()
