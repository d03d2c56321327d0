"""PyTorch port, the Trainer on a synthetic NIfTI set on the CPU (16^3
patches, batch 2, features (4, 4, 8, 16, 32, 4), DDIM-2 validation):
validation every epoch and ``epoch_{n}.pt`` every epoch; two epochs
straight give the same parameters, AdamW state and losses, bit for bit, as
one epoch, a resume from ``epoch_1`` and a second epoch; the best gate
saves only above a mean dice of 0.5; label smoothing over the NIfTI set;
and the preemption save."""
import json

import numpy as np
import pytest
import torch

from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
from diff_unet_tpu_torch.engine import checkpoint as ckpt_lib
from diff_unet_tpu_torch.engine.engine import Trainer
from tests.test_torch_port_data import write_nifti_set
from tests.test_torch_port_swin import torch_threads  # noqa: F401

FEATURES = (4, 4, 8, 16, 32, 4)
COMMON = dict(model_name="diff_unet", image_size=16, spatial_size=16,
              batch_size=2, sw_batch_size=2, overlap=0.25, timesteps=100,
              sample_steps=2, features=FEATURES, num_workers=2,
              use_amp=False, device="cpu", lr=1e-3,
              scheduler="warmup_cosine", warmup_epochs=1)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    data = write_nifti_set(root / "data")
    classes = root / "classes.yaml"
    classes.write_text("0: background\n1: organ_a\n2: organ_b\n")
    return root, dict(data_path=str(data), classes=str(classes), **COMMON)


@pytest.fixture(scope="module")
def straight(workspace):
    """Two epochs with validation and a checkpoint after each."""
    root, kw = workspace
    trainer = Trainer(max_epochs=2, val_freq=1, save_freq=1,
                      log_dir=str(root / "straight"), **kw)
    trainer.train()
    return trainer


def test_trainer_validates_and_saves_every_epoch(workspace, straight):
    root, _ = workspace
    weights = root / "straight/weights"
    assert (weights / "epoch_1.pt").exists()
    assert (weights / "epoch_2.pt").exists()
    assert ckpt_lib.latest_checkpoint(weights).name == "epoch_2.pt"
    steps = len(straight.dataloader["train"])
    assert steps == 2 and straight.global_step == 2 * steps
    assert len(straight.history) == 2 * steps
    assert all(np.isfinite(h["loss"]) for h in straight.history)
    records = [json.loads(line) for line in
               (root / "straight/metrics.jsonl").read_text().splitlines()]
    dices = [r["mean_dice"] for r in records if "mean_dice" in r]
    assert len(dices) == 2 and all(0 <= d <= 1 for d in dices)
    meta = ckpt_lib.load_training_state(weights / "epoch_2")["meta"]
    assert meta["epoch"] == 2 and meta["global_step"] == 2 * steps
    assert set(meta) == {"epoch", "loss", "noise_ratio", "global_step",
                         "best_mean_dice", "project_name", "id"}


def test_resume_gives_the_same_bits(workspace, straight):
    root, kw = workspace
    resumed = Trainer(max_epochs=2, val_freq=1, save_freq=1,
                      model_path=str(root / "straight/weights/epoch_1"),
                      log_dir=str(root / "resumed"), **kw)
    assert resumed.start_epoch == 1 and resumed.train_step.count == 2
    resumed.train()
    assert resumed.global_step == straight.global_step
    for (k, a), (_, b) in zip(straight.module.state_dict().items(),
                              resumed.module.state_dict().items()):
        assert torch.equal(a, b), k
    sa = straight.train_step.optimizer.state_dict()["state"]
    sb = resumed.train_step.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history[2:]]
    assert resumed.best_mean_dice == straight.best_mean_dice


def test_best_gate_saves_only_above_half(workspace, monkeypatch):
    root, kw = workspace
    scripted = iter([0.4, 0.4, 0.4, 0.4, 0.6, 0.7, 0.5, 0.6])
    monkeypatch.setattr(Trainer, "validation_step",
                        lambda self, batch: next(scripted))
    trainer = Trainer(max_epochs=2, val_freq=1, save_freq=10,
                      log_dir=str(root / "gate"), **kw)
    trainer.train()
    saved = sorted(p.name for p in (root / "gate/weights").iterdir())
    assert saved == ["best_0.6000.pt"]         # 0.4 is not above 0.5
    assert trainer.best_mean_dice == pytest.approx(0.6)
    trainer.validation_end([0.55], 2)          # not a new best
    trainer.validation_end([0.45, 0.45], 3)
    assert sorted(p.name for p in (root / "gate/weights").iterdir()) == \
        ["best_0.6000.pt"]


def test_label_smoothing_over_the_nifti_set(workspace):
    root, kw = workspace
    trainer = Trainer(max_epochs=1, val_freq=10, save_freq=10,
                      label_smoothing=True, smoothing_alpha=0.2,
                      log_dir=str(root / "ls"), **kw)
    batch = next(iter(trainer.dataloader["train"]))
    assert batch["label"].shape == (2, 16, 16, 16, 3)
    image, labels = trainer._to_device(batch["image"], batch["label"])
    assert labels.shape == (2, 16, 16, 16, 2) and labels.dtype == \
        torch.float32
    trainer.train()
    assert np.isfinite(trainer.loss)


def test_preemption_saves_and_resumes(workspace, monkeypatch):
    root, kw = workspace

    class Requested(ckpt_lib.PreemptionGuard):
        def __init__(self):
            super().__init__(install=False)
            self.requested = True

    monkeypatch.setattr(ckpt_lib, "PreemptionGuard", Requested)
    data = SyntheticSegmentation((16, 16, 16), num_labels=3, batch_size=2,
                                 batches=3, seed=2)
    kw = {**kw, "data_path": None, "log_dir": str(root / "pre")}
    trainer = Trainer(train_data=data, max_epochs=3, val_freq=10,
                      save_freq=10, **kw)
    trainer.train()
    assert trainer.global_step == 1       # stopped after the first step
    path = root / "pre/weights/preempt.pt"
    assert path.exists()
    resumed = Trainer(train_data=data, max_epochs=3, val_freq=10,
                      save_freq=10, model_path=str(path), **kw)
    assert resumed.start_epoch == 1 and resumed.global_step == 1
    assert resumed.train_step.count == 1
    with pytest.raises(ValueError, match="validation"):
        Trainer(train_data=data, max_epochs=2, val_freq=1, save_freq=10,
                **kw).train()
