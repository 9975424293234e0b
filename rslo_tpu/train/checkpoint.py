"""Checkpoint store: one ``.npz`` per step with a json index.

The analog of the reference's json-index checkpoint manager
(/root/reference/rslo/torchplus/train/checkpoint.py:10-218): numbered
step checkpoints, ``latest`` resolution, max_to_keep pruning, and
resumable global step + optimizer state.

Layout under ``directory``: ``<step>/state.npz`` holds every leaf of the
saved pytree, keyed by its tree path (``params/middle/SpConv_0/kernel``);
``<step>/dtypes.json`` names the leaves whose dtype numpy cannot store
(bfloat16 and friends, saved as raw bits); ``checkpoints.json`` lists the
steps.  A step directory is written under a temporary name and renamed
into place, so a reader never sees half a checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import jax
import numpy as np

_STATE = "state.npz"
_DTYPES = "dtypes.json"
_INDEX = "checkpoints.json"


def _key_str(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported pytree key {k!r}")


def _path_str(path) -> str:
    return "/".join(_key_str(k) for k in path)


def _write_step(dst: Path, state: Any):
    arrays, dtypes = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = _path_str(path)
        a = np.asarray(leaf)
        if a.dtype.type.__module__ != "numpy":   # e.g. ml_dtypes.bfloat16
            dtypes[key] = a.dtype.name
            a = a.view(f"u{a.dtype.itemsize}")
        arrays[key] = a
    dst.mkdir(parents=True)
    np.savez(dst / _STATE, **arrays)
    (dst / _DTYPES).write_text(json.dumps(dtypes))


def _read_step(src: Path) -> dict:
    dtypes = json.loads((src / _DTYPES).read_text())
    with np.load(src / _STATE) as z:
        out = {k: z[k] for k in z.files}
    for k, name in dtypes.items():
        out[k] = out[k].view(jax.numpy.dtype(name))
    return out


def _steps_in(d: Path) -> list[int]:
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / _STATE).exists())


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 8):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return _steps_in(self.dir)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False):
        """Write ``state`` as step ``step``; a step already on disk is
        kept as it is (resuming at a step that was just saved)."""
        del force  # every save is synchronous and final
        if step in self.all_steps():
            return
        tmp = self.dir / f".{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        _write_step(tmp, state)
        tmp.rename(self.dir / str(step))
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self.dir / str(old))
        index = self.dir / (_INDEX + ".tmp")
        index.write_text(json.dumps({"steps": self.all_steps()}))
        os.replace(index, self.dir / _INDEX)

    def preserve(self, step: int):
        """Copy a saved step into the pruning-immune ``ckpt_best/``
        sibling (best-checkpoint retention: max_to_keep prunes oldest
        steps, which on long runs can include the best periodic-val
        step).  Keeps exactly one preserved step."""
        src = self.dir / str(step)
        if not src.exists():
            return
        dst_root = self.dir.parent / "ckpt_best"
        tmp = self.dir.parent / ".ckpt_best.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        shutil.copytree(src, tmp / str(step))
        if dst_root.exists():
            shutil.rmtree(dst_root)
        tmp.rename(dst_root)

    @staticmethod
    def restore_raw_from(path: str) -> dict:
        """Restore another run's latest checkpoint as nested dicts keyed
        by tree path (no template — for warm-start param surgery across
        differing architectures).  ``path`` may be a model dir or its
        ckpt/."""
        p = Path(path)
        if (p / "ckpt").exists():
            p = p / "ckpt"
        steps = _steps_in(p)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {p}")
        tree: dict = {}
        for key, a in _read_step(p / str(steps[-1])).items():
            *parents, leaf = key.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = a
        return tree

    def restore(self, state_template: Any, step: int | None = None):
        """Load a step into the structure of ``state_template``; None if
        there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        src = self.dir / str(step)
        if step not in self.all_steps():
            src = self.dir.parent / "ckpt_best" / str(step)
            if not (src / _STATE).exists():
                raise FileNotFoundError(f"no checkpoint for step {step}")
        arrays = _read_step(src)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            state_template)
        return jax.tree_util.tree_unflatten(
            treedef, [arrays[_path_str(p)] for p, _ in leaves])
