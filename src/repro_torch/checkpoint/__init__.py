"""Checkpointing: mesh-agnostic save/restore + asynchronous saves.

The port's counterpart of the JAX package's ``repro.checkpoint``, on
tensors, with the same on-disk format, so a checkpoint written by either
package restores in the other bitwise:

* **Format** — ``<base>/step_%010d/`` holds ``manifest.json`` (the step
  and, per leaf, its ``/``-joined tree path, file, shape and dtype name)
  and one ``.npy`` per leaf, numbered in tree order (dict keys sorted,
  sequences by index, named tuples by field — the order ``jax.tree_util``
  flattens them in; a named tuple's field is ``.name`` in a path, as jax
  prints its attribute keys, so a train state's paths are
  ``.params/...`` and ``.opt/.m/...`` in both packages).
  ``bfloat16`` leaves are stored as their ``uint16`` bit patterns.  Every
  leaf is written whole, so a checkpoint restores onto any decomposition
  (the elastic legs re-shape a shrunken world over it).  A checkpoint is
  written into ``step_%010d.tmp`` and published by one atomic rename.
  A placed leaf (:class:`~repro_torch.runtime.sharding.Placed`, a state
  sharded over a logical mesh) is gathered first, so the files are the
  same whatever mesh wrote them, and ``restore_checkpoint(...,
  shardings=)`` places the restored tree over another mesh, as the
  reference's does.

* **Asynchronous saves** (the paper's external-events pattern, §4.3/§6.2):
  :meth:`AsyncCheckpointer.save` enqueues the device-to-host copy of every
  CUDA leaf on the producing (current) stream and returns at once; the
  serialisation runs as a task on a host
  :class:`~repro_torch.core.TaskRuntime`, which waits on the copies'
  event before it writes.  Its :class:`~repro_torch.core.tac.EventHandle`
  completes when the file is published — the *dependency release* that
  gates checkpoint-slot reuse and the final barrier (``wait_all``).

* **Fault tolerance** — ``latest_step`` + ``restore_checkpoint`` implement
  step-granular restart; ``install_preemption_handler`` flushes a final
  checkpoint on SIGTERM (cluster preemption).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import TaskRuntime, tac
from ..core.mesh import resolve_device
from ..runtime.sharding import Placed, place

_MANIFEST = "manifest.json"


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _items(tree) -> List[Tuple[Any, Any]]:
    """(path key, child) of a dict, named tuple or sequence, in order."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return list(enumerate(tree))


def _paths_and_leaves(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in tree order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, sub in _items(tree):
        out.extend(_paths_and_leaves(sub, prefix + (k,)))
    return out


def _map_leaves(fn, tree, prefix: Tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        kids = [_map_leaves(fn, v, prefix + (k,)) for k, v in _items(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return fn("/".join(str(p) for p in prefix), tree)


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:010d}")


def _host_copy(leaf):
    """A host snapshot of one leaf: a CUDA tensor is copied into pinned
    memory on the current stream (not waited for); a CPU tensor or an
    array is copied now, so later in-place writes never reach the file;
    a placed leaf is gathered on the host."""
    if isinstance(leaf, Placed):
        return leaf.gather(device="cpu")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.is_cuda:
            host = torch.empty(leaf.shape, dtype=leaf.dtype,
                               pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            return host
        return leaf.clone()
    return np.array(leaf, copy=True)


def _as_array(leaf) -> Tuple[np.ndarray, str]:
    """The array a leaf is stored as, and its dtype name."""
    if isinstance(leaf, Placed):
        leaf = leaf.gather(device="cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(base: str, state: Any, step: int) -> str:
    """Synchronous, mesh-agnostic save: every leaf is copied to the host
    (a CUDA leaf after the work queued on the current stream) and
    written."""
    return _write(base, state, step)


def _write(base: str, host_state: Any, step: int) -> str:
    d = _ckpt_dir(base, step)
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (key, leaf) in enumerate(_paths_and_leaves(host_state)):
        arr, dtype = _as_array(leaf)
        fn = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        entries.append({"path": key, "file": fn,
                        "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"step": step, "entries": entries}, f)
    if os.path.isdir(d):  # idempotent re-save of the same step
        shutil.rmtree(d)
    os.replace(tmp, d)  # atomic publish
    return d


def latest_step(base: str) -> Optional[int]:
    if not os.path.isdir(base):
        return None
    steps = [int(m.group(1)) for n in os.listdir(base)
             if (m := re.match(r"step_(\d+)$", n))]
    return max(steps) if steps else None


def restore_checkpoint(base: str, abstract_state: Any, device=None,
                       step: Optional[int] = None, *,
                       shardings: Any = None) -> Tuple[Any, int]:
    """Restore onto any decomposition: ``abstract_state`` gives the tree
    and each leaf's shape (tensors, arrays or anything with ``.shape``).

    With ``device`` (a ``torch.device`` or its name) every leaf comes back
    as a tensor there; without it, a leaf whose template is a tensor comes
    back as a CPU tensor and any other leaf as a host array (a
    ``bfloat16`` leaf always as a tensor: numpy has no such dtype).  With
    ``shardings`` (a tree of ``runtime.sharding.NamedSharding`` shaped
    like ``abstract_state``) every leaf comes back placed over their mesh
    (a :class:`~repro_torch.runtime.sharding.Placed` of per-rank blocks
    on the mesh's device), bitwise the leaf saved."""
    step = step if step is not None else latest_step(base)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {base}")
    d = _ckpt_dir(base, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["entries"]}
    target = None if device is None else resolve_device(device)

    def load(key, leaf):
        e = by_path[key]
        arr = np.load(os.path.join(d, e["file"]))
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(np.shape(leaf))}")
        if e["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif target is not None or isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(arr)
        else:
            return arr
        return t if target is None else t.to(target)

    tree = _map_leaves(load, abstract_state)
    if shardings is not None:
        tree = place(tree, shardings)
    return tree, manifest["step"]


class AsyncCheckpointer:
    """Non-blocking checkpointing on the host task runtime.

    ``save`` (a) snapshots the state at call time — CUDA leaves by a
    device-to-host copy enqueued on the current stream, behind the work
    that produced them and ahead of any later in-place write on that
    stream — then (b) submits the serialisation as a task that waits on
    the copies' event and writes; its completion is observed through the
    external-events machinery (an :class:`~repro_torch.core.tac.EventHandle`
    fulfilled by the writer once the file is published).  Consecutive
    saves are serialised through an ``inout`` dependency on the checkpoint
    directory; ``wait_all`` is a taskwait.
    """

    def __init__(self, base: str, *, keep: int = 3) -> None:
        self.base = base
        self.keep = keep
        self.runtime = TaskRuntime(num_workers=1)
        self.runtime.start()
        self._lock = threading.Lock()
        self.saved_steps = []

    def save(self, state: Any, step: int) -> tac.EventHandle:
        host_state = _map_leaves(lambda _, leaf: _host_copy(leaf), state)
        copied = tac.ArrayHandle(host_state,
                                 inputs=[leaf for _, leaf in
                                         _paths_and_leaves(state)])
        done = tac.EventHandle()

        def writer():
            copied.wait()          # the device-to-host copies have landed
            path = _write(self.base, host_state, step)
            with self._lock:
                self.saved_steps.append(step)
            self._gc()
            done.complete(path)

        self.runtime.submit(writer, inout=[("ckpt-dir", self.base)],
                            name=f"ckpt@{step}")
        return done

    def _gc(self) -> None:
        with self._lock:
            if len(self.saved_steps) <= self.keep:
                return
            drop = sorted(self.saved_steps)[:-self.keep]
            self.saved_steps = sorted(self.saved_steps)[-self.keep:]
        for s in drop:
            d = _ckpt_dir(self.base, s)
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)

    def wait_all(self) -> None:
        self.runtime.taskwait()

    def close(self) -> None:
        self.wait_all()
        self.runtime.close()


def install_preemption_handler(flush_fn) -> None:
    """Flush a final checkpoint on SIGTERM (cluster preemption signal)."""
    def handler(signum, frame):
        flush_fn()
        raise SystemExit(143)
    signal.signal(signal.SIGTERM, handler)
