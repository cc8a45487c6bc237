"""Bounded LRU array cache that spills overflow to disk.

The port's copy of ``casmvsnet_pl_tpu/fusion/spill.py``. The fusion loop
(fuse.py) reuses each view's refined depth and image as source data for
later reference views. Keeping every view of a scan in host RAM costs
several GB at Tanks and Temples scale (2048x1056 x ~300 views), so this
cache keeps a byte-budgeted in-memory LRU front (the pair graph's locality
makes it the fast path) backed by .npy spill files in a temporary
directory that is removed on close.
"""
from __future__ import annotations

import collections
import os
import shutil
import tempfile

import numpy as np


class SpillCache:
    """Mapping key -> ndarray, at most ``max_bytes`` resident in memory.

    Least-recently-used entries are spilled to ``.npy`` files and reloaded
    transparently on access. ``max_bytes=None`` disables spilling (plain
    dict behavior). Use as a context manager (or call :meth:`close`) to
    remove the spill directory.
    """

    def __init__(self, max_bytes: float | None = None,
                 spill_dir: str | None = None):
        self.max_bytes = max_bytes
        self._mem: collections.OrderedDict[object, np.ndarray] = \
            collections.OrderedDict()
        self._spilled: dict[object, str] = {}
        self._bytes = 0
        self._dir = spill_dir
        self._own_dir = False
        self.n_spills = 0
        self.n_reloads = 0

    # -- mapping interface ------------------------------------------------
    def __contains__(self, key) -> bool:
        return key in self._mem or key in self._spilled

    def __len__(self) -> int:
        return len(self._mem) + len(self._spilled)

    def __getitem__(self, key) -> np.ndarray:
        if key in self._mem:
            self._mem.move_to_end(key)
            return self._mem[key]
        path = self._spilled[key]
        arr = np.load(path)
        self.n_reloads += 1
        # promote back to memory (keeps the hot working set resident)
        del self._spilled[key]
        os.unlink(path)
        self._insert(key, arr)
        return arr

    def __setitem__(self, key, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        if key in self._mem:
            self._bytes -= self._mem.pop(key).nbytes
        elif key in self._spilled:
            os.unlink(self._spilled.pop(key))
        self._insert(key, arr)

    def get(self, key, default=None):
        return self[key] if key in self else default

    # -- internals --------------------------------------------------------
    def _insert(self, key, arr: np.ndarray) -> None:
        self._mem[key] = arr
        self._bytes += arr.nbytes
        if self.max_bytes is None:
            return
        while self._bytes > self.max_bytes and len(self._mem) > 1:
            old_key, old = self._mem.popitem(last=False)
            self._bytes -= old.nbytes
            np.save(self._path_for(old_key), old)
            self._spilled[old_key] = self._path_for(old_key)
            self.n_spills += 1

    def _path_for(self, key) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="casmvs_spill_")
            self._own_dir = True
        safe = "".join(c if c.isalnum() else "_" for c in repr(key))
        return os.path.join(self._dir, f"{safe}.npy")

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        self._mem.clear()
        self._spilled.clear()
        self._bytes = 0
        if self._own_dir and self._dir and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "SpillCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
