"""Asynchronous, atomic checkpoints of a descent state: port of
``repro/train/checkpoint.py``'s ``CheckpointManager``.

A state is a ``NamedTuple`` (such as :class:`repro_torch.core.tsne.TsneState`)
or a dict of tensors and ints.  The on-disk format is the reference's, so
each package reads the other's checkpoints:

* one directory a step, ``step_%010d/``, written as ``step_%010d.tmp/`` and
  renamed when complete, so a crash mid-write never leaves a step that
  :meth:`CheckpointManager.latest_step` would pick;
* ``manifest.json`` with ``step``, ``treedef`` (the string JAX prints for
  the same structure) and ``leaves`` ``[{name, shape, dtype}]``;
* one ``.npy`` a leaf, named as the reference's ``_leaf_paths`` names it:
  ``.y``, ``.velocity``, ``.gains``, ``.iteration`` for a ``TsneState``
  (dot-files), the key for a dict entry.

An ``int`` leaf is stored as a 0-d int32 array, as JAX holds the state's
``iteration``, and restored as an ``int``.  ``save`` copies every leaf to
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


def _leaf_paths(state) -> list[tuple[str, Any]]:
    """(file name, leaf) in the reference's order: a NamedTuple's fields
    (``.field``) or a dict's keys, sorted as JAX flattens a dict."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        items = [(f".{f}", v) for f, v in zip(state._fields, state)]
    elif isinstance(state, dict):
        items = [(str(k), state[k]) for k in sorted(state)]
    else:
        raise TypeError(f"a checkpointed state is a NamedTuple or a dict, got {type(state)}")
    return [(re.sub(r"[^A-Za-z0-9_.-]", "_", name) or "leaf", v) for name, v in items]


def _treedef(state) -> str:
    """The string ``jax.tree_util.tree_structure`` gives for ``state``."""
    if isinstance(state, dict):
        return "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in sorted(state)) + "})"
    stars = ", ".join("*" for _ in state)
    return f"PyTreeDef(CustomNode(namedtuple[{type(state).__name__}], [{stars}]))"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    return np.array(leaf, copy=True)


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
        named = [(n, _to_host(leaf)) for n, leaf in _leaf_paths(state)]
        manifest = {
            "step": int(step),
            "treedef": _treedef(state),
            "leaves": [{"name": n, "shape": list(a.shape), "dtype": str(a.dtype)}
                       for n, a in named],
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
        leaf comes back an ``int``.  Unlike the reference there is no
        ``shardings`` argument: the port has no jit sharding, and a sharded
        state is split after restore (``convert.shard_state``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        leaves = []
        for name, like in _leaf_paths(template):
            arr = np.load(d / f"{name}.npy")
            if isinstance(like, torch.Tensor):
                leaves.append(torch.from_numpy(arr).to(like.device if device is None
                                                       else device))
            elif isinstance(like, (int, np.integer)):
                leaves.append(int(arr))
            else:
                leaves.append(arr)
        if isinstance(template, dict):
            return dict(zip(sorted(template), leaves)), step
        return type(template)(*leaves), step
