"""HybridMIM self-supervised pretraining of the BasicUNet encoder
(counterpart of ``diff_unet_tpu/models/hybrid_mim.py``), channel-last.

The input is block-masked per sample; the encoder (``conv_0`` and
``down_1..4``: ``BasicUNetEncoder``'s layout, so its parameters graft into
DiffUNet's ``embed_model``) embeds it; a decoder (``up_0..3``,
``decoder_pred``) reconstructs a fixed sub-region of the input; three heads
on the bottom map predict each 2x2x2-patch region's masked-patch count
(9-way), its 8 position flags and a contrastive projection, compared with
a second view's under ``torch.no_grad()``. Every 3x3x3 conv runs on the
conv kernels through ``TwoConv``; ``decoder_pred`` (1x1x1) is a ``Conv``.

The masks come from a ``torch.Generator`` or are given (``masks``: the two
views' voxel keep grids), so that tests can hand the port the JAX model's
draws.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.engine.sliding_window import window_seed
from diff_unet_tpu_torch.engine.train import apply_update, make_optimizer
from diff_unet_tpu_torch.models.basic_unet import BasicUNetEncoder
from diff_unet_tpu_torch.ops.blocks import Conv, ConvTranspose, Dense, \
    TwoConv
from diff_unet_tpu_torch.ops.conv3d import _acc_dtype
from diff_unet_tpu_torch.ops.mim import block_mask

Box = Tuple[Tuple[int, int, int], Tuple[int, int, int]]
# the encoder subtree that DiffUNet's embed_model takes
ENCODER_KEYS = ("conv_0", "down_1", "down_2", "down_3", "down_4")
DEPTH = 4


def _scale_box(box: Box, factor: int) -> Box:
    lo, hi = box
    return (tuple(v * factor for v in lo), tuple(v * factor for v in hi))


def crop_box(x: torch.Tensor, box: Box) -> torch.Tensor:
    """The box of NDHWC ``x`` (a view)."""
    lo, hi = box
    return x[:, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], :]


def mask_region_labels(patch_keep: torch.Tensor, regions_per_dim: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, g, g, g) patch keep grid -> for each of the ``regions_per_dim``^3
    regions (in (rd, rh, rw) order) its masked-patch count (B, R) int64 in
    0..s^3 and its per-position mask flags (B, R, s^3), s = g / regions."""
    b, g = patch_keep.shape[:2]
    r = regions_per_dim
    s = g // r
    m = (1.0 - patch_keep).reshape(b, r, s, r, s, r, s)
    m = m.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, r ** 3, s ** 3)
    return m.sum(-1).long(), m


class _UpCatLite(nn.Module):
    """2x transposed conv (``upsample``), concat [skip, upsampled], then
    TwoConv without temb (``convs``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upsample = ConvTranspose(in_features, features, dtype=dtype)
        self.convs = TwoConv(2 * features, features, use_temb=False,
                             dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convs([skip, self.upsample(x)])


class HybridMIMBasicUNet(BasicUNetEncoder):
    """The masked-image-modeling pretrainer: the ``BasicUNetEncoder``
    (whose parameters are DiffUNet's ``embed_model``'s) with the
    reconstruction decoder and the three heads. ``forward`` returns the
    reconstruction alone where ``pretrained`` is False, else the dict of
    ``hybrid_mim_loss``'s inputs."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 features: Sequence[int] = (32, 32, 64, 128, 256, 32),
                 select_region: Box = ((1, 1, 1), (3, 3, 3)),
                 mask_patch: int = 16, mask_ratio: float = 0.4,
                 contrast_dim: int = 384, pretrained: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(features, in_channels, dtype=dtype)
        fea = tuple(features)
        self.select_region = select_region
        self.mask_patch = mask_patch
        self.mask_ratio = mask_ratio
        self.pretrained = pretrained
        for i in range(DEPTH):
            lvl = DEPTH - 1 - i
            self.add_module(f"up_{i}", _UpCatLite(fea[lvl + 1], fea[lvl],
                                                  dtype=dtype))
        self.decoder_pred = Conv(fea[0], out_channels, 1, dtype=dtype)
        self.pred_mask_region = Dense(fea[4], 9, dtype=dtype)
        self.pred_mask_region_position = Dense(fea[4], 8, dtype=dtype)
        self.contrast_learning_head = Dense(fea[4], contrast_dim,
                                            dtype=dtype)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        return BasicUNetEncoder.forward(self, x)

    def decode(self, outs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Reconstruct ``select_region`` of the bottom level, scaled to the
        input, from the cropped feature maps."""
        h = crop_box(outs[-1], self.select_region)
        for i in range(DEPTH):
            skip = crop_box(outs[DEPTH - 1 - i],
                            _scale_box(self.select_region, 2 ** (i + 1)))
            h = getattr(self, f"up_{i}")(h, skip)
        return self.decoder_pred(h)

    def draw_masks(self, x: torch.Tensor, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two views' (B, D, H, W) voxel keep grids, one block mask per
        sample and view."""
        b, d, h, w = x.shape[:4]
        cells = (d // self.mask_patch) * (h // self.mask_patch) * (
            w // self.mask_patch)
        return tuple(block_mask(
            (d, h, w), patch=self.mask_patch, mask_ratio=self.mask_ratio,
            noise=torch.rand((b, cells), generator=generator,
                             device=generator.device)) for _ in range(2))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        if not self.pretrained:
            return self.decode(self.encode(x))
        b, d, h, w, _ = x.shape
        p = self.mask_patch
        gd = d // p
        if gd % 2 != 0:
            raise ValueError(
                f"HybridMIM needs an even patch grid per dim (got {gd} = "
                f"{d}/{p}): the 9-way/8-way heads assume 2x2x2-patch "
                "regions")
        if masks is None:
            if generator is None:
                raise ValueError("the pretraining forward needs a "
                                 "generator or the two views' masks")
            masks = self.draw_masks(x, generator)
        keep_1, keep_2 = masks
        # each patch's keep flag is its first voxel's
        patch_keep = keep_1.reshape(b, gd, p, h // p, p, w // p, p)[
            :, :, 0, :, 0, :, 0]
        regions = gd // 2
        counts, positions = mask_region_labels(patch_keep, regions)

        outs = self.encode(x * keep_1[..., None].to(x.dtype))
        bottom = outs[-1]
        logits = self.decode(outs)
        local_images = crop_box(x, _scale_box(self.select_region,
                                              2 ** DEPTH))

        c = bottom.shape[-1]
        win = bottom.shape[1] // regions
        windows = bottom.reshape(b, regions, win, regions, win, regions,
                                 win, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        region_feat = windows.reshape(b, regions ** 3, win ** 3, c).mean(2)
        contrast_1 = self.contrast_learning_head(
            bottom.reshape(b, -1, c).mean(1))
        # the second view, head included, carries no gradient: a head
        # gradient from it would let the cosine loss collapse the head
        # instead of training the encoder
        with torch.no_grad():
            bottom_2 = self.encode(x * keep_2[..., None].to(x.dtype))[-1]
            contrast_2 = self.contrast_learning_head(
                bottom_2.reshape(b, -1, c).mean(1))
        return {
            "logits": logits,
            "images": local_images,
            "pred_mask_region": self.pred_mask_region(region_feat),
            "pred_mask_region_position":
                self.pred_mask_region_position(region_feat),
            "mask_labels": counts,
            "mask_position_labels": positions,
            "mask": 1.0 - patch_keep.reshape(b, -1),
            "contrast_pred_1": contrast_1,
            "contrast_pred_2": contrast_2,
        }


def hybrid_mim_loss(out: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The four equally weighted terms, in float32 (float64 stays
    float64): MSE reconstruction of the cropped region, 9-way
    cross-entropy on the regions' masked-patch counts, BCE with logits on
    their position flags, and 1 - cos between the two views' projections.
    Returns (total, terms)."""
    acc = _acc_dtype(out["logits"].dtype)
    recon = torch.mean(torch.square(out["logits"].to(acc)
                                    - out["images"].to(acc)))
    logp = F.log_softmax(out["pred_mask_region"].to(acc), dim=-1)
    count_ce = -torch.mean(torch.gather(logp, -1,
                                        out["mask_labels"][..., None]))
    z = out["pred_mask_region_position"].to(acc)
    y = out["mask_position_labels"].to(acc)
    pos_bce = torch.mean(torch.clamp(z, min=0.0) - z * y
                         + torch.log1p(torch.exp(-torch.abs(z))))
    c1 = out["contrast_pred_1"].to(acc)
    c2 = out["contrast_pred_2"].to(acc)
    cos = torch.sum(c1 * c2, dim=-1) / (
        torch.linalg.vector_norm(c1, dim=-1)
        * torch.linalg.vector_norm(c2, dim=-1) + 1e-8)
    contrast = torch.mean(1.0 - cos)
    terms = {"recon": recon, "count_ce": count_ce, "pos_bce": pos_bce,
             "contrast": contrast}
    return recon + count_ce + pos_bce + contrast, terms


class MimPretrainStep:
    """One pretraining step (counterpart of ``make_mim_pretrain_step``):
    the loss, its backward and one AdamW update with ``optax.adamw(lr)``'s
    defaults (betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on every
    parameter, a constant lr). Step ``count``'s masks come from a
    generator seeded from (``seed``, ``count``), the counterpart of
    ``fold_in(rng, state.step)``, unless ``masks`` are given.

    Returns device tensors ``loss``, ``grad_norm`` (the global L2 norm of
    the gradients) and the four terms."""

    def __init__(self, model: HybridMIMBasicUNet, lr: float = 1e-3,
                 seed: int = 0):
        self.model = model
        self.params = list(model.parameters())
        self.optimizer, self.schedule = make_optimizer(
            self.params, lr=lr, weight_decay=1e-4)
        self.seed = seed
        self.count = 0

    def __call__(self, batch: torch.Tensor,
                 masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        generator = None
        if masks is None:
            generator = torch.Generator(device=batch.device).manual_seed(
                window_seed(self.seed, (self.count,)))
        for p in self.params:
            p.grad = None
        loss, terms = hybrid_mim_loss(self.model(batch, generator, masks))
        loss.backward()
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a parameter got no gradient; optax would "
                               "still decay it")
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        apply_update(self.optimizer, self.schedule, self.count)
        self.count += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                **{k: v.detach() for k, v in terms.items()}}
