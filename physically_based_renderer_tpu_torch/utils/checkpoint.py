"""Checkpoint and resume for inverse rendering (port of `utils/checkpoint.py`,
with `torch.save`/`torch.load` in place of orbax).

Layout under a checkpoint directory, as in the reference: one entry
`step_XXXXXXXX` per saved step (here a single `torch.save` file) and a
`LATEST` file holding the newest step number.  Each file is written under a
temporary name in the same directory and moved into place with
`os.replace`, so a crash never leaves a half-written checkpoint.  The
payload holds the trained parameters (a mapping of field name to tensor),
the optimizer's `state_dict()` and `extra`; `restore` maps every tensor to
the CPU by default (an optimizer's `load_state_dict` moves its state to the
parameters' device).  The reference's orbax checkpoints are not read.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _params_dict(params: Any) -> dict:
    """Trained fields of a params record (None fields dropped) or a dict."""
    if dataclasses.is_dataclass(params):
        params = {f.name: getattr(params, f.name)
                  for f in dataclasses.fields(params)}
    return {k: v for k, v in params.items() if v is not None}


def _atomic_write(target: Path, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=target.parent, prefix=f".{target.name}.")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path: str | Path, step: int, params: Any, opt_state: Any,
         extra: dict | None = None) -> None:
    """Save a training checkpoint (atomic: write a temporary file, then
    rename) and point LATEST at it."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": {k: v.detach()
                          for k, v in _params_dict(params).items()},
               "opt_state": opt_state, "extra": extra or {}}
    _atomic_write(path / f"step_{step:08d}",
                  lambda f: torch.save(payload, f))
    _atomic_write(path / "LATEST", lambda f: f.write(str(step).encode()))


def latest_step(path: str | Path) -> int | None:
    p = Path(path) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(path: str | Path, step: int | None = None,
            map_location: str | torch.device = "cpu"):
    """(step, payload) of the checkpoint at `step` (default: LATEST).
    payload["params"] maps field names to tensors; payload["opt_state"]
    is an optimizer state_dict."""
    path = Path(path).absolute()
    if step is None:
        step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    payload = torch.load(path / f"step_{step:08d}", map_location=map_location,
                         weights_only=True)
    return step, payload


def save_npz(path: str | Path, **arrays) -> None:
    """Light-weight export: a flat npz of named arrays (host copies)."""
    np.savez(path, **{k: (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
                      for k, v in arrays.items()})
