"""Checkpoint/resume for long snapshot-generation runs.

The reference has no in-process checkpointing — its only restart artifacts
are the never-used ``restart_dir``/``restart_flag`` POD parameters
(PODFS.py:1294, called with ``'PODFS/'``, ``'false'`` at
digitalfilters.py:1500) and the per-step ``.prf`` dumps under ``-v``.

This rebuild makes resume natural: generation is *stateless* — noise
slabs are counter-indexed from ``(seed, t0)`` (ops/filters.py), so any time
block can be recomputed independently, and a checkpoint only needs to record
(a) the config fingerprint and (b) which blocks are done, plus their
snapshot columns.  A killed run resumes by generating the missing blocks —
no RNG state or ring-buffer snapshotting required (the reference's
``np.roll`` ring-buffer, digitalfilters.py:1454-1467, has no analog here).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np


def config_fingerprint(cfg) -> str:
    """Stable hash of the generation-relevant config: any change invalidates
    existing checkpoints."""

    def enc(o):
        if dataclasses.is_dataclass(o):
            return {f.name: enc(getattr(o, f.name))
                    for f in dataclasses.fields(o)}
        if isinstance(o, (tuple, list)):
            return [enc(v) for v in o]
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            # content hash, not repr: the turbulence stress/mean fields feed
            # every generated value, so a checkpoint must be invalidated when
            # they change even if the plane/filter/seed did not (e.g. a new
            # --u_dash or an edited profile file)
            return ["ndarray", list(o.shape), str(o.dtype),
                    hashlib.sha256(np.ascontiguousarray(o).tobytes())
                    .hexdigest()]
        return o

    blob = json.dumps(enc(cfg), sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class GenerationCheckpoint:
    """Block-granular checkpoint store for the snapshot matrix.

    Layout: ``<dir>/meta.json`` + ``<dir>/block_<t0>_<t1>.npz`` with the
    packed (3*Np, t1-t0) columns of A for steps [t0, t1).
    """

    def __init__(self, directory: str, fingerprint: str, nsteps: int,
                 block: int):
        self.dir = directory
        self.fingerprint = fingerprint
        self.nsteps = nsteps
        self.block = block
        os.makedirs(directory, exist_ok=True)
        self.meta_path = os.path.join(directory, "meta.json")
        self._load_meta()

    def _load_meta(self):
        self.completed = set()
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            if (meta.get("fingerprint") == self.fingerprint
                    and meta.get("nsteps") == self.nsteps
                    and meta.get("block") == self.block):
                # only blocks whose files still exist count as done
                for t0 in meta.get("completed", []):
                    if os.path.exists(self._block_path(t0)):
                        self.completed.add(t0)
            else:
                # config changed: invalidate (leave old files; they are
                # keyed by a meta that no longer claims them)
                self.completed = set()

    def _block_path(self, t0: int) -> str:
        return os.path.join(
            self.dir, f"block_{t0:08d}_{min(t0 + self.block, self.nsteps):08d}.npz")

    def _write_meta(self):
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "fingerprint": self.fingerprint,
                "nsteps": self.nsteps,
                "block": self.block,
                "completed": sorted(self.completed),
            }, f)
        os.replace(tmp, self.meta_path)

    def block_starts(self):
        return list(range(0, self.nsteps, self.block))

    def pending(self):
        return [t0 for t0 in self.block_starts() if t0 not in self.completed]

    def save_block(self, t0: int, columns: np.ndarray):
        path = self._block_path(t0)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, A=np.asarray(columns))
        os.replace(tmp, path)
        self.completed.add(t0)
        self._write_meta()

    def load_block(self, t0: int) -> np.ndarray:
        with np.load(self._block_path(t0)) as z:
            return z["A"]

    def assemble(self, num_rows: int, dtype=np.float64) -> np.ndarray:
        """Concatenate all completed blocks into the full (rows, nsteps) A."""
        if self.pending():
            raise ValueError(f"blocks {self.pending()} not yet generated")
        A = np.empty((num_rows, self.nsteps), dtype=dtype)
        for t0 in self.block_starts():
            cols = self.load_block(t0)
            A[:, t0:t0 + cols.shape[1]] = cols
        return A


class GramCheckpoint:
    """Resumable store for the streaming-POD passes (streaming.py,
    parallel/streaming.py).

    The O(B^2) pairwise-Gram pass is the long pole of an out-of-core POD at
    10k-snapshot scale; a crash mid-pass must not restart it from zero.
    Granularity: the mean vector (pass 1) plus one upper-triangular Gram
    *row strip* per block row (pass 2) — row ``bi`` holds the *centered*
    products ``C[t_i:t_i+n_i, t_i:]`` (blocks are mean-subtracted on device
    before the GEMM).  Layout: ``<dir>/gram_meta.json``, ``mean.npz``,
    ``gram_row_<bi>.npz``; all writes are atomic (tmp + rename).
    """

    def __init__(self, directory: str, fingerprint: str, nsteps: int,
                 block: int):
        self.dir = directory
        self.fingerprint = fingerprint
        self.nsteps = nsteps
        self.block = block
        os.makedirs(directory, exist_ok=True)
        self.meta_path = os.path.join(directory, "gram_meta.json")
        self._load_meta()

    def _load_meta(self):
        self.completed_rows = set()
        self.has_mean = False
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            if (meta.get("fingerprint") == self.fingerprint
                    and meta.get("nsteps") == self.nsteps
                    and meta.get("block") == self.block):
                self.has_mean = (meta.get("has_mean", False)
                                 and os.path.exists(self._mean_path()))
                for bi in meta.get("completed_rows", []):
                    if os.path.exists(self._row_path(bi)):
                        self.completed_rows.add(bi)

    def _mean_path(self) -> str:
        return os.path.join(self.dir, "mean.npz")

    def _row_path(self, bi: int) -> str:
        return os.path.join(self.dir, f"gram_row_{bi:06d}.npz")

    def _write_meta(self):
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "fingerprint": self.fingerprint,
                "nsteps": self.nsteps,
                "block": self.block,
                "has_mean": self.has_mean,
                "completed_rows": sorted(self.completed_rows),
            }, f)
        os.replace(tmp, self.meta_path)

    def save_mean(self, mean: np.ndarray):
        tmp = self._mean_path() + ".tmp.npz"
        np.savez_compressed(tmp, mean=np.asarray(mean, dtype=np.float64))
        os.replace(tmp, self._mean_path())
        self.has_mean = True
        self._write_meta()

    def load_mean(self) -> Optional[np.ndarray]:
        if not self.has_mean:
            return None
        with np.load(self._mean_path()) as z:
            return z["mean"]

    def save_row(self, bi: int, strip: np.ndarray):
        """``strip`` = C[t_i:t_i+n_i, t_i:] (n_i, nsteps - t_i), centered."""
        path = self._row_path(bi)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, strip=np.asarray(strip, dtype=np.float64))
        os.replace(tmp, path)
        self.completed_rows.add(bi)
        self._write_meta()

    def load_row(self, bi: int) -> np.ndarray:
        with np.load(self._row_path(bi)) as z:
            return z["strip"]


def generation_fingerprint(cfg, filt, fields, rotate: bool) -> str:
    """Key of a :class:`GenerationCheckpoint`: everything that determines
    the generated values.  `fields` (the resolved stress/mean arrays) is
    part of it (every generated value depends on it through the Lund
    coloring), as is the noise stream the generator draws."""
    from pods_digital_filter_tpu.ops.filters import STREAM_TAG

    return config_fingerprint((cfg.plane, filt, cfg.seed, cfg.dtype, rotate,
                               fields, STREAM_TAG))


def generate_with_checkpoints(
    cfg,
    fields,
    filt,
    checkpoint_dir: str,
    block: Optional[int] = None,
    rotate: bool = True,
    progress=None,
) -> np.ndarray:
    """Resumable snapshot generation: generate (only) the missing time
    blocks, checkpoint each, return the assembled (3*Np, nsteps) matrix.

    A block is one jitted generation call for steps [t0, t0+block) —
    identical output to a single full-range call because noise slabs are
    globally counter-indexed (tested in tests/test_checkpoint.py).
    """
    from pods_digital_filter_tpu.pipeline import generate_snapshot_matrix

    block = block or min(cfg.nsteps, 256)
    fp = generation_fingerprint(cfg, filt, fields, rotate)
    store = GenerationCheckpoint(checkpoint_dir, fp, cfg.nsteps, block)

    for t0 in store.pending():
        n = min(block, cfg.nsteps - t0)
        cols = generate_snapshot_matrix(cfg, fields, filt, t0=t0, nsteps=n,
                                        rotate=rotate)
        store.save_block(t0, np.asarray(cols))
        if progress is not None:
            progress(t0, n)

    num_rows = 3 * cfg.plane.jma * cfg.plane.kma
    return store.assemble(num_rows)
