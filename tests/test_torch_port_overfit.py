"""PyTorch port, the synthetic learning check (``python -m
diff_unet_tpu_torch.overfit``, the counterpart of
``examples/overfit_synthetic.py``) on the CPU at a small size: the cases
at 48^3 are the example's, a few steps of the recipe lower the loss and
print the example's JSON lines, and the saved ``.npz`` serves through the
``Predictor`` in bf16 and W8A8 int8, weights-only and calibrated."""
import json
from pathlib import Path

import numpy as np

from diff_unet_tpu_torch import overfit
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (8, 8, 16, 32, 64, 8)
SIZE = 16


def test_cases_are_the_examples():
    """``make_case`` at 48 draws the example's volumes (its own function,
    taken from the example's source, which trains when imported)."""
    src = (ROOT / "examples/overfit_synthetic.py").read_text()
    body = src[src.index("def make_case"):src.index("cases = ")]
    scope = {"np": np, "S": 48}
    exec(body, scope)
    for seed in (0, 3):
        want_img, want_lab = scope["make_case"](seed)
        img, lab = overfit.make_case(seed)
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_array_equal(lab, want_lab)
    images, labels, onehot = overfit.make_cases(SIZE)
    assert images.shape == (4, SIZE, SIZE, SIZE, 1)
    assert set(np.unique(labels)) == {0, 1, 2}
    assert onehot.shape == (4, SIZE, SIZE, SIZE, 2)


def test_overfit_steps_lower_the_loss_and_serve_int8(tmp_path, capsys):
    out = tmp_path / "trained.npz"
    res = overfit.run(size=SIZE, iters=5, features=FEATURES, eval_every=4,
                      device="cpu", out=str(out))
    losses = res["losses"]
    assert len(losses) == 5 and losses[-1] < losses[0], losses
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [d["iter"] for d in lines] == [0, 4]
    assert set(lines[0]) == {"iter", "loss", "mean_dice", "elapsed_s"}
    images, _, onehot = overfit.make_cases(SIZE)
    for kw in ({}, {"quantize": True},
               {"quantize": True, "quant_calibrate": 1}):
        pred = overfit.build_predictor(SIZE, FEATURES, "cpu",
                                       model_path=str(out), **kw)
        if kw.get("quant_calibrate"):
            pred.calibrate(images[0])
            assert pred.module.model.conv_0.conv_0.sa is not None
        dices, binaries = overfit.evaluate(pred, images[:1], onehot[:1])
        assert all(0.0 <= d <= 1.0 for d in dices)
        assert binaries[0].shape == (SIZE, SIZE, SIZE, 2)
