"""The port's CheckpointManager (torch.save) with the JAX package's
interface, and the DGCNN trainer's --save-model-path / --load-model-path."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dgnn_tpu_torch.models import DGCNN
from dgnn_tpu_torch.utils import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_checkpoint_roundtrip(tmp_path):
    """The JAX package's round trip (tests/test_checkpoint.py): two steps
    saved, the newest restored into a template."""
    state = {"params": {"w": torch.arange(6, dtype=torch.float32)
                        .reshape(2, 3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.save(1, state, force=True)
    state2 = {"params": {"w": state["params"]["w"] * 2},
              "step": torch.tensor(8, dtype=torch.int32)}
    assert mgr.save(2, state2, force=True)
    mgr.wait()
    template = {"params": {"w": torch.zeros((2, 3), dtype=torch.float64)},
                "step": torch.tensor(0, dtype=torch.int32)}
    step, restored = mgr.restore_latest(template)
    assert step == 2
    assert restored["params"]["w"].dtype == torch.float64  # the template's
    np.testing.assert_allclose(restored["params"]["w"].numpy(),
                               state2["params"]["w"].numpy())
    assert int(restored["step"]) == 8
    mgr.close()


def test_restore_empty_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore_latest({"x": torch.zeros(1)}) is None
    mgr.close()


def test_max_to_keep_prunes_and_interval_skips(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2,
                            save_interval_steps=3)
    saved = [s for s in range(1, 11) if mgr.save(s, {"s": torch.tensor(s)})]
    assert saved == [3, 6, 9]
    assert mgr.save(10, {"s": torch.tensor(10)}, force=True)
    assert mgr.all_steps() == [9, 10]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10.pt",
                                                         "step_9.pt"]
    step, state = mgr.restore_latest({"s": torch.tensor(0)})
    assert (step, int(state["s"])) == (10, 10)


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(3), "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match="template"):
        mgr.restore_latest({"w": torch.zeros(4), "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match="keys"):
        mgr.restore_latest({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="length"):
        mgr.restore_latest({"w": torch.zeros(3), "b": []})


def _trainer():
    spec = importlib.util.spec_from_file_location(
        "train_edgeconv_torch", ROOT / "scripts" / "train_edgeconv_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = ["--device", "cpu", "--num-epochs", "2", "--batch-size", "4", "--k",
        "4", "--num-points", "16", "--train-samples", "16",
        "--test-samples", "8"]


def _eval_logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(x)


def test_edgeconv_trainer_saves_then_loads(tmp_path, capsys):
    """A run saves its parameters and BatchNorm statistics after training;
    the trainer's restore puts them into a model of another seed, whose
    eval logits then equal the first run's; a second run loads the step
    before it trains, as the JAX CLI does."""
    trainer = _trainer()
    # a short timing signal: at the CLI's 2 s the timing loops only run
    # longer on the host
    trainer.MIN_SIGNAL_S = 0.05
    ckpt = tmp_path / "ckpt"
    r = trainer.run(trainer.parser().parse_args(
        TINY + ["--save-model-path", str(ckpt)]))
    assert r["restored_step"] is None
    assert "saved checkpoint" in capsys.readouterr().out
    assert (ckpt / "step_2.pt").exists()
    fresh = DGCNN(k=4, output_classes=r["n_classes"], dropout=0.5,
                  generator=torch.Generator().manual_seed(9))
    x = r["x_test"][:4]
    assert not torch.equal(_eval_logits(fresh, x),
                           _eval_logits(r["model"], x))
    args = trainer.parser().parse_args(TINY + ["--load-model-path",
                                               str(ckpt)])
    assert trainer.restore_checkpoint(trainer.checkpoint_manager(args),
                                      fresh) == 2
    assert torch.equal(_eval_logits(fresh, x), _eval_logits(r["model"], x))
    for name, buf in r["model"].named_buffers():
        assert torch.equal(dict(fresh.named_buffers())[name], buf), name
    r2 = trainer.run(args)
    assert r2["restored_step"] == 2
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert np.isfinite(r2["losses"]).all()
