"""HybridMIM encoder pretraining, the counterpart of
``examples/pretrain_mim.py``:

    python -m diff_unet_tpu_torch.pretrain_mim --steps 50 \
        --out logs/mim_encoder.npz [--device cpu]

pretrains a ``HybridMIMBasicUNet`` (seeded random weights, float32) on
synthetic volumes with the composite MIM objective
(``models/hybrid_mim.py:hybrid_mim_loss``), then saves the encoder
subtree (``conv_0``, ``down_1..4``) in flax's names as a ``.npz``
(``engine/checkpoint.py:save_jax_npz``), which
``Trainer(pretrained_path=<that file>)`` grafts into DiffUNet's
``embed_model``. ``--features`` must match the DiffUNet to graft into.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.engine.checkpoint import save_jax_npz
from diff_unet_tpu_torch.engine.sliding_window import window_seed
from diff_unet_tpu_torch.models.basic_unet import DEFAULT_FEATURES
from diff_unet_tpu_torch.models.hybrid_mim import ENCODER_KEYS, \
    HybridMIMBasicUNet, MimPretrainStep
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    init_random

SEED = 0


def synthetic_batch(generator: torch.Generator, batch: int,
                    size: int) -> torch.Tensor:
    """(batch, size, size, size, 1) soft random blobs: N(0, 1) noise
    averaged over 9^3 boxes (zero padding counted, as a SAME sum window
    over 729), plus 0.1 N(0, 1)."""
    dev = generator.device
    base = torch.randn((batch, 1, size, size, size), generator=generator,
                       device=dev)
    smooth = F.avg_pool3d(base, 9, stride=1, padding=4,
                          count_include_pad=True)
    x = smooth + 0.1 * torch.randn(base.shape, generator=generator,
                                   device=dev)
    return x.permute(0, 2, 3, 4, 1).contiguous()


def build(features: Sequence[int] = DEFAULT_FEATURES, lr: float = 1e-3,
          device="cuda", seed: int = SEED
          ) -> Tuple[HybridMIMBasicUNet, MimPretrainStep]:
    """The pretrainer with seeded random weights on ``device`` and its
    step."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           "torch.cuda.is_available() is false; pass "
                           "--device cpu to run on the CPU")
    # float32 throughout: cuDNN's ConvTranspose and 1x1 conv would
    # otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_random(HybridMIMBasicUNet(features=tuple(features)),
                        seed + 1).to(dev)
    return model, MimPretrainStep(model, lr=lr, seed=seed + 3)


def pretrain(step: MimPretrainStep, steps: int, batch: int, size: int,
             seed: int = SEED, log: Optional[Callable[[str], None]] = print
             ) -> List[Dict[str, torch.Tensor]]:
    """``steps`` steps on fresh synthetic batches (batch i from a generator
    seeded from (``seed``, i)); logs every 10th step and the last. Returns
    each step's metrics."""
    dev = step.params[0].device
    history = []
    for i in range(steps):
        g = torch.Generator(device=dev).manual_seed(window_seed(seed, (i,)))
        metrics = step(synthetic_batch(g, batch, size))
        history.append(metrics)
        if log is not None and (i % 10 == 0 or i == steps - 1):
            log(f"step {i}: loss={float(metrics['loss']):.4f} "
                f"recon={float(metrics['recon']):.4f} "
                f"count_ce={float(metrics['count_ce']):.4f} "
                f"pos_bce={float(metrics['pos_bce']):.4f} "
                f"contrast={float(metrics['contrast']):.4f}")
    return history


def save_encoder(model: HybridMIMBasicUNet, path) -> None:
    """Write the encoder subtree in flax's names and layouts as the port's
    JAX ``.npz``."""
    tree = export_jax_params(model)["params"]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_jax_npz(path, {k: tree[k] for k in ENCODER_KEYS})


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="logs/mim_encoder.npz")
    ap.add_argument("--features", type=int, nargs=6,
                    default=DEFAULT_FEATURES,
                    help="must match the DiffUNet features to graft into")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, step = build(args.features, args.lr, args.device)
    t0 = time.time()
    pretrain(step, args.steps, args.batch, args.size)
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")
    save_encoder(model, args.out)
    print(f"encoder subtree saved to {args.out}; finetune with "
          f"Trainer(pretrained_path={args.out!r})")


if __name__ == "__main__":
    main()
