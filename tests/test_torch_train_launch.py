"""The port's train launcher, ``python -m repro_torch.launch.train``, on
the CPU: the smoke config trains, checkpoints and resumes, ``--remat``
trains the same steps, and without ``--device`` a host with no card
raises.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.launch import train as launch_train
from repro_torch.tree import tree_leaves


def test_train_launcher_smoke_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps
    3``: finite losses, the final line, and a checkpoint that restores
    into the trained parameters bit for bit."""
    trainer = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3",
                                 "--batch", "2", "--seq", "32",
                                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss:" in out and "checkpoint:" in out
    assert len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert latest_step(str(tmp_path)) == 3
    params = trainer.state.params
    back = restore_checkpoint(str(tmp_path), 3, params)
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a.detach(), b)


def test_train_launcher_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_train_launcher_resumes_and_remats(tmp_path, capsys):
    """``--resume`` starts from the newest checkpoint's parameters and
    saves at its step plus ``--steps``; ``--remat`` trains the same
    steps: losses equal to the plain run's bit for bit."""
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-dir"]
    first = launch_train.main(args + [str(tmp_path / "a")])
    again = launch_train.main(["--smoke", "--device", "cpu", "--steps", "1",
                               "--batch", "2", "--seq", "16", "--ckpt-dir",
                               str(tmp_path / "a"), "--resume"])
    remat = launch_train.main(args + [str(tmp_path / "b"), "--remat"])
    assert "resumed from" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "a")) == 3
    assert again.history[0]["loss"] != first.history[0]["loss"]
    assert first.model.remat is False and remat.model.remat is True
    assert ([h["loss"] for h in remat.history]
            == [h["loss"] for h in first.history])
    with pytest.raises(SystemExit):
        launch_train.main(["--smoke", "--device", "cpu", "--resume"])
