"""Evaluation entry point, the counterpart of the repository's ``test.py``:

    python -m diff_unet_tpu_torch.test --config cfg/amos/test.yaml \
        data_path=/data/AMOS model_path=logs/diff-unet-amos/weights/epoch_3000

loads the checkpoint (``model_path``: the port's ``.pt`` or a JAX tree as
``.npz``), serves every case of the validation list of
``<data_path>/dataset.json`` with sliding-window DDIM, prints the
per-class dice / HD95 / IoU table and the mean dice, and writes
``logs/<log_dir>/results.pkl``. ``key=value`` arguments override the
config; ``device=cpu`` runs on the CPU (the default is the card).
"""
from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from diff_unet_tpu_torch.engine.engine import Tester
    from diff_unet_tpu_torch.utils.config import engine_kwargs, parse_args

    return Tester(**engine_kwargs(parse_args(argv))).test()


if __name__ == "__main__":
    main()
