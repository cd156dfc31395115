"""Asynchronous, atomic checkpoints of a state: port of
``repro/train/checkpoint.py``'s ``CheckpointManager``.

A state is a tree of tuples, NamedTuples, dicts and lists (the reference's
pytree) whose leaves are tensors, ints and numpy arrays: a descent state
(:class:`repro_torch.core.tsne.TsneState`), or an LM trainer's
``(params, AdamWState)``.  An object with a ``checkpoint_tree()`` method
(a :class:`~repro_torch.models.model.DecoderLM`) is saved as that tree and
restored through its ``from_checkpoint_tree(tree)``; a
:class:`~repro_torch.tree.Stacked` leaf (one scanned leaf's per-layer
tensors) is copied to the host layer by layer and stacked there, never on
the card, and split back on restore.  The on-disk format is the
reference's, so each package reads the other's checkpoints:

* one directory a step, ``step_%010d/``, written as ``step_%010d.tmp/`` and
  renamed when complete, so a crash mid-write never leaves a step that
  :meth:`CheckpointManager.latest_step` would pick;
* ``manifest.json`` with ``step``, ``treedef`` (the string JAX prints for
  the same structure) and ``leaves`` ``[{name, shape, dtype}]``;
* one ``.npy`` a leaf, named as the reference's ``_leaf_paths`` names it:
  the path's keys joined by ``__`` (a NamedTuple field as ``.field``):
  ``.y`` for a ``TsneState``'s (dot-files), ``0__embed__embedding`` and
  ``1__.m__layers__attn__wq`` for an LM trainer's.

An ``int`` leaf is stored as a 0-d int32 array, as JAX holds the state's
``iteration`` and the optimizer's ``step``, and restored as an ``int``.  A
bfloat16 leaf is stored by its bits (numpy has no bfloat16: the file's
dtype is two raw bytes, as the reference's ``ml_dtypes`` arrays are
saved) with ``"bfloat16"`` in the manifest.  ``save`` copies every leaf to
the host on the caller's thread and writes on a background thread; one
save is outstanding at a time.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import Stacked, tree_leaves_with_path, tree_map, treedef_str


def _is_stacked(x) -> bool:
    return isinstance(x, Stacked)


def _saved_tree(state):
    """``state`` as it is written: objects with ``checkpoint_tree()``
    replaced by their trees."""
    return tree_map(lambda x: x.checkpoint_tree() if hasattr(x, "checkpoint_tree") else x,
                    state, is_leaf=_is_stacked)


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    """(file name, leaf) in the reference's order, a Stacked as one leaf."""
    out = []
    for path, leaf in tree_leaves_with_path(tree, _is_stacked):
        if not isinstance(leaf, (torch.Tensor, Stacked, int, np.ndarray, np.generic)):
            raise TypeError(f"a checkpointed leaf is a tensor, an array or an int, got "
                            f"{type(leaf)} at {'/'.join(path)}")
        name = "__".join(re.sub(r"[^A-Za-z0-9_.-]", "_", k) for k in path)
        out.append((name or "leaf", leaf))
    return out


def _dtype_name(leaf) -> str | None:
    """"bfloat16" for a bfloat16 tensor (or Stacked of them), else None."""
    t = leaf[0] if isinstance(leaf, Stacked) else leaf
    return "bfloat16" if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 else None


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, Stacked):
        return np.stack([_to_host(t) for t in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    return np.array(leaf, copy=True)


def _from_host(arr: np.ndarray, dtype: str | None, like, device):
    """The saved array in ``like``'s kind: a tensor on ``device`` (default
    ``like``'s), a Stacked split along the first axis, an int, or the
    array."""
    if isinstance(like, (int, np.integer)):
        return int(arr)
    if not isinstance(like, (torch.Tensor, Stacked)):
        return arr
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtype == "bfloat16"
         else torch.from_numpy(arr))
    if isinstance(like, Stacked):
        dev = like[0].device if device is None else device
        return Stacked(t[i].to(dev) for i in range(t.shape[0]))
    return t.to(like.device if device is None else device)


class CheckpointManager:
    """Checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Copy ``state`` to the host now, write it on a background thread."""
        self.wait()                                   # one outstanding save
        tree = _saved_tree(state)
        leaves = _leaf_paths(tree)
        named = [(n, _to_host(leaf)) for n, leaf in leaves]
        manifest = {
            "step": int(step),
            "treedef": treedef_str(tree),
            "leaves": [{"name": n, "shape": list(a.shape),
                        "dtype": _dtype_name(leaf) or str(a.dtype)}
                       for (n, a), (_, leaf) in zip(named, leaves)],
        }

        def write():
            try:
                tmp = self.dir / f"step_{step:010d}.tmp"
                final = self.dir / f"step_{step:010d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for n, a in named:
                    np.save(tmp / f"{n}.npy", a)
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except Exception as exc:                  # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Block until the outstanding save is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write under {self.dir} failed") from err

    def _gc(self) -> None:
        for s in sorted(self._steps())[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def _steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, template: Any, step: int | None = None, device=None):
        """(state with ``template``'s structure, step) from ``step`` (default:
        the newest).  Each tensor leaf goes to ``device`` (default: the
        template leaf's device) with the dtype it was saved in; an ``int``
        leaf comes back an ``int``; an object with ``checkpoint_tree()``
        comes back as ``template_object.from_checkpoint_tree(tree)``.
        Unlike the reference there is no ``shardings`` argument: the port
        has no jit sharding, and a sharded state is split after restore
        (``convert.shard_state``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        dtypes = {m["name"]: m["dtype"] for m in
                  json.loads((d / "manifest.json").read_text())["leaves"]}
        tree = _saved_tree(template)
        loaded = iter([_from_host(np.load(d / f"{name}.npy"), dtypes.get(name), like, device)
                       for name, like in _leaf_paths(tree)])
        restored = tree_map(lambda _: next(loaded), tree, is_leaf=_is_stacked)
        owners = lambda x: hasattr(x, "checkpoint_tree") or _is_stacked(x)   # noqa: E731
        return tree_map(lambda t, r: t.from_checkpoint_tree(r)
                        if hasattr(t, "checkpoint_tree") else r,
                        template, restored, is_leaf=owners), step
