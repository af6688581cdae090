"""Checkpointing: atomic commit, async writer, exact-step resume.

Layout::

    <dir>/step_000100.tmp/     (written)
    <dir>/step_000100/         (atomic rename = commit)
        manifest.json          {step, leaf paths, shapes, dtypes}
        arrays.npz             one entry per flattened leaf

A checkpoint is valid iff the rename committed — a killed writer leaves only
a ``.tmp`` that restore ignores, so restart always sees a consistent state.
``save_async`` runs serialization+IO on a daemon thread (training continues);
``wait()`` joins before the next save so at most one write is in flight.

Port of ``repro/checkpoint/manager.py``, same layout and semantics.  A
state is a tree of mappings, named tuples (``AdamWState``), lists,
``nn.Module`` s (their named parameters) and tensor or numpy leaves; a
leaf's key is its path joined by ``/``.  numpy has no bfloat16, so a bf16
leaf is stored as its ``uint16`` bits with ``"bfloat16"`` in the manifest,
and read back as such.  ``restore`` returns the structure of ``like``: new
tensors on each ``like`` leaf's device, and an ``nn.Module`` restored in
place (its parameters overwritten: a full-width model is not copied).

On several ranks (``layout``, the multi-rank step's
:class:`~repro_torch.parallel.fsdp.Layout`) every rank calls ``save``:
each leaf split over ``data`` is all-gathered, rank 0 writes the whole
tree (the one-card layout, so either trainer resumes from it) and the
ranks meet at a barrier.  ``restore`` reads the whole tree on every rank
and keeps each rank's slice of the split leaves, by spec.  The residuals
of a ``compress_pod`` step (``opt/feedback/...``) differ from pod to pod:
they are stored stacked, ``[pod, *leaf]``, and each rank takes its pod's
(:meth:`~repro_torch.parallel.fsdp.Layout.saved`,
:meth:`~repro_torch.parallel.fsdp.Layout.restored`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _children(tree):
    """``[(key, child)]`` of an inner node, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, Mapping):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree, strict=True))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            # analysis: allow(host-sync): a checkpoint is written from the host
            return leaf.view(torch.int16).cpu().numpy().view(np.uint16)
        # analysis: allow(host-sync): a checkpoint is written from the host
        return leaf.cpu().numpy()
    return np.asarray(leaf)  # analysis: allow(host-sync): host leaves only


def _flatten(tree, prefix: str = "") -> dict:
    """``{"arrays": {path: numpy array}, "dtypes": {path: dtype name}}``,
    ``"bfloat16"`` naming the bits of a bf16 tensor."""
    arrays, dtypes = {}, {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            arrays[path] = _to_host(node)
            bf16 = (isinstance(node, torch.Tensor)
                    and node.dtype == torch.bfloat16)
            dtypes[path] = "bfloat16" if bf16 else str(arrays[path].dtype)
            return
        for key, child in kids:
            walk(child, f"{path}/{key}" if path else key)

    walk(tree, prefix)
    return {"arrays": arrays, "dtypes": dtypes}


def _host_tree(tree, layout=None, path: str = ""):
    """The same tree with every tensor leaf copied to host memory (a
    snapshot the writer thread can serialize while training goes on);
    with ``layout``, each leaf as the checkpoint holds it first (a
    collective: every rank calls this)."""
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            leaf = tree.detach()
            if layout is not None:
                leaf = layout.saved(path, leaf)
            return leaf.to("cpu", copy=True)
        return tree
    return {key: _host_tree(child, layout, f"{path}/{key}" if path else key)
            for key, child in kids}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *, layout=None):
        self.dir = directory
        self.keep = keep
        self.layout = layout
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def _writer(self) -> bool:
        return self.layout is None or self.layout.rank == 0

    # ------------------------------------------------------------- writing
    def save(self, step: int, state: Any) -> Optional[str]:
        """Commit ``state`` as ``step``; the path (None on a rank that
        does not write)."""
        if self.layout is not None:
            state = _host_tree(state, self.layout)
            path = self._write(step, state) if self._writer else None
            self.layout.barrier()
            return path
        return self._write(step, state)

    def _write(self, step: int, state: Any) -> str:
        flat = _flatten(state)
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat["arrays"])
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": flat["dtypes"][k]}
                       for k, v in flat["arrays"].items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        return final

    def save_async(self, step: int, state: Any) -> None:
        self.wait()
        # a snapshot off-device (split leaves gathered: a collective, now)
        host_state = _host_tree(state, self.layout)
        if not self._writer:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host_state), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.layout is not None:
            self.layout.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- reading
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: each tensor leaf as a new
        tensor of its ``like`` leaf's dtype on its device, each module's
        parameters in place."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: data[k] for k in data.files}

        def leaf(key, like_leaf):
            arr = flat[key]
            if dtypes[key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.copy())
            if self.layout is not None:
                t = self.layout.restored(key, t)
            if isinstance(like_leaf, torch.Tensor):
                return t.to(device=like_leaf.device, dtype=like_leaf.dtype)
            if isinstance(like_leaf, np.ndarray):
                return arr
            return type(like_leaf)(arr) if np.ndim(arr) == 0 else arr

        def walk(node, path):
            if isinstance(node, nn.Module):
                with torch.no_grad():
                    for key, p in node.named_parameters():
                        p.copy_(leaf(f"{path}/{key}" if path else key, p))
                return node
            kids = _children(node)
            if kids is None:
                return leaf(path, node)
            out = [walk(child, f"{path}/{key}" if path else key)
                   for key, child in kids]
            if isinstance(node, Mapping):
                return type(node)(zip((k for k, _ in kids), out, strict=True))
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*out)
            return type(node)(out)

        return walk(like, "")
