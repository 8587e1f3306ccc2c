"""Checkpoints: one npz of arrays and a manifest a step, atomic, keep-k,
verified on restore, mesh-independent; port of ``repro.checkpoint.ckpt``.

Layout, as the reference's: ``<dir>/step_%010d/`` holds ``arrays.npz``
(leaves keyed ``a<i>`` in sorted path order) and ``manifest.json``
(``step``, ``extra``, ``time`` and, per ``/``-joined leaf path, its key,
shape, dtype name and checksum). A save writes ``step_N.tmp`` and renames
it to ``step_N``, so a save cut short never replaces a complete
checkpoint; ``keep`` bounds the checkpoints kept, the newest always.

numpy has no bf16: a bf16 leaf is stored as its uint16 bits, with
``bfloat16`` as its dtype name in the manifest, and the checksum is the
reference's over those bytes under that name. A checkpoint the JAX package
wrote reads the same way: its bf16 leaves (ml_dtypes' bfloat16, which
loads as ``|V2`` without ml_dtypes) are viewed as their uint16 bits, so
it restores, verified, into torch tensors. A dtype name outside
``DTYPES`` is refused.

Leaves are stored whole by path, whatever mesh they were on. A save of a
tree with DTensor leaves gathers each leaf whole on every rank
(``full_tensor``, a collective every rank makes in the same order), rank
0 writes, and every rank waits at a barrier for the write (after it, for
``save_async``, in ``wait``); the checksums are the whole arrays'.
``restore(..., shardings=)`` places each leaf onto its ``NamedSharding``
(``common/sharding.py``), which may be another mesh than the one it was
saved from (an elastic resize).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.common.sharding import is_distributed
from repro_torch.common.tree import flatten_paths, unflatten_paths

_MANIFEST = "manifest.json"
_DATA = "arrays.npz"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "float64": torch.float64,
          "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _checksum(a: np.ndarray, dtype_name: str) -> str:
    """The reference's: sha256 of the shape, the dtype name and a strided
    subsample of at most about 4096 elements (cheap, order-sensitive)."""
    sub = a.reshape(-1)[:: max(1, a.size // 4096)]
    h = hashlib.sha256()
    h.update(str(a.shape).encode())
    h.update(dtype_name.encode())
    h.update(np.ascontiguousarray(sub).tobytes())
    return h.hexdigest()[:16]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype name); bf16 as its uint16 bits; a
    DTensor gathered whole first."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) not in DTYPES:
        raise TypeError(f"checkpoint: unsupported leaf dtype {arr.dtype}")
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _bits(arr: np.ndarray, dtype_name: str) -> np.ndarray:
    """The array whose bytes the checksum reads (bf16 as uint16, whatever
    numpy type it loaded as)."""
    return arr.view(np.uint16) if dtype_name == "bfloat16" else arr


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._barrier = False    # a distributed save_async to wait for

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if (d.startswith("step_") and not d.endswith(".tmp")
                    and os.path.exists(os.path.join(self.dir, d, _MANIFEST))):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    @staticmethod
    def _snapshot(tree: Any) -> tuple[dict, bool]:
        """(path -> (numpy array, dtype name), copied to the host now;
        whether the tree is distributed, and rank 0 alone writes it)."""
        flat = flatten_paths(tree)
        return ({path: _to_host(leaf) for path, leaf in flat.items()},
                is_distributed(list(flat.values())))

    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        host, distributed = self._snapshot(tree)
        if not distributed or dist.get_rank() == 0:
            self._write(step, host, extra or {})
        if distributed:
            dist.barrier()
        return self._step_dir(step)

    def save_async(self, step: int, tree: Any, extra: dict | None = None):
        """Snapshot to the host now, write on a background thread; a write
        that fails raises from the next ``wait``, which is also where the
        ranks of a distributed save meet."""
        host, distributed = self._snapshot(tree)
        self.wait()
        self._barrier = distributed
        if distributed and dist.get_rank() != 0:
            return

        def write():
            try:
                self._write(step, host, extra or {})
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=write)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint: background save failed") from err

    def _write(self, step: int, host: dict, extra: dict) -> str:
        arrays = {}
        manifest = {"step": step, "extra": extra, "time": time.time(),
                    "leaves": {}}
        for i, path in enumerate(sorted(host)):
            arr, name = host[path]
            key = f"a{i}"
            arrays[key] = arr
            manifest["leaves"][path] = {
                "key": key, "shape": list(arr.shape), "dtype": name,
                "checksum": _checksum(arr, name)}
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _DATA), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, step: int | None = None, *, verify: bool = True,
                device="cpu", shardings: Any = None
                ) -> tuple[int, Any, dict]:
        """Returns (step, tree of tensors on ``device``, extra); the newest
        step by default. ``verify`` checks each leaf's checksum and raises
        IOError on a mismatch. ``shardings``: a tree of the same paths
        whose ``NamedSharding`` leaves (None for a plain tensor) place the
        leaves onto a mesh as DTensors."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        flat = {}
        with np.load(os.path.join(d, _DATA)) as data:
            for path, meta in manifest["leaves"].items():
                name = meta["dtype"]
                if name not in DTYPES:
                    raise TypeError(f"checkpoint step {step}: leaf {path} has "
                                    f"dtype {name}, which the port does not "
                                    "read")
                arr = data[meta["key"]]
                if verify and _checksum(_bits(arr, name), name) \
                        != meta["checksum"]:
                    raise IOError(f"checksum mismatch at {path} in step "
                                  f"{step}")
                flat[path] = _from_host(arr, name, device)
        if shardings is not None:
            flat_s = flatten_paths(shardings)
            flat = {p: v if flat_s.get(p) is None else distribute_tensor(
                v, flat_s[p].mesh, flat_s[p].placements)
                for p, v in flat.items()}
        return step, unflatten_paths(flat), manifest.get("extra", {})
