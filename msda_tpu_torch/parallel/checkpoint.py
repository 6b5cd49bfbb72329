"""Checkpoint / resume of the training state (PyTorch counterpart of
``msda_tpu/parallel/checkpoint.py``).

Each ``save`` writes the model's and the optimizer's ``state_dict`` and the
step with ``torch.save`` into a temporary directory and then renames it to
``{dir}/{step}``, so that a crash never leaves a partial checkpoint under a
step's name.  ``restore`` loads the latest step by default.

Usage:
    ckpt = TrainCheckpointer(dir)
    ckpt.save(step, model, optimizer)
    step = ckpt.restore(model, optimizer)
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

__all__ = ["TrainCheckpointer"]

_STATE_FILE = "state.pt"


class TrainCheckpointer:
    """Atomic train-state checkpoints with latest-step resume."""

    def __init__(self, directory: str | os.PathLike):
        self._dir = os.path.abspath(os.fspath(directory))
        os.makedirs(self._dir, exist_ok=True)

    def steps(self) -> list[int]:
        """Available checkpoint steps, ascending."""
        return sorted(
            int(name) for name in os.listdir(self._dir)
            if name.isdigit() and os.path.isfile(
                os.path.join(self._dir, name, _STATE_FILE))
        )

    def save(self, step: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer) -> str:
        """Write an atomic checkpoint for ``step`` (replacing one of the
        same step); returns its path."""
        path = os.path.join(self._dir, str(int(step)))
        tmp = tempfile.mkdtemp(prefix=".tmp-", dir=self._dir)
        try:
            torch.save({"step": int(step), "model": model.state_dict(),
                        "optimizer": optimizer.state_dict()},
                       os.path.join(tmp, _STATE_FILE))
            if os.path.exists(path):
                old = tempfile.mkdtemp(prefix=".old-", dir=self._dir)
                os.replace(path, os.path.join(old, "ckpt"))
                os.replace(tmp, path)
                shutil.rmtree(old)
            else:
                os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
        return path

    def restore(self, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer,
                step: int | None = None) -> int:
        """Load a checkpoint into ``model`` and ``optimizer`` (in place);
        ``step=None`` takes the latest.  Returns the step.  Raises
        ``FileNotFoundError`` when there is none."""
        if step is None:
            steps = self.steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
            step = steps[-1]
        path = os.path.join(self._dir, str(int(step)), _STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint for step {step} at {path}")
        # weights_only: the file holds tensors and plain containers only
        state = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])
