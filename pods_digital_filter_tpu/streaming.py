"""Out-of-core snapshot POD by deterministic regeneration.

The reference holds the full snapshot matrix ``A (3*Np, Ns)`` in memory
(digitalfilters.py:1397, PODFS.py:1451-1464); at the large-scale target
configuration (1024x512 plane, 10k snapshots) that is ~60 GB — beyond one
device's memory.  Because this framework's generation is *stateless and
counter-indexed* (every snapshot block ``[t0, t0+nb)`` is a pure function of
``(seed, t0)`` — ops/filters.py), A never needs to be stored: it can be
*regenerated* block by block, which is classic rematerialization — trade
FLOPs for memory.

Three streamed passes, holding at most two ``(3*Np, block)`` panels in
device memory:

1. column sums  ->  mean field ``m``;
2. pairwise block GEMMs ``(A_i - m)^T (A_j - m)``  ->  centered Gram.  Each
   regenerated block is centered *inside the generation program*
   (make_generator(center=m) — XLA fuses the subtraction into the pack /
   rotation epilogue, so it costs no extra device memory): with a dominant
   mean (TI ~ 2%) the centered entries are ~1e-4 of the raw magnitudes, so the
   algebraically-equivalent raw-product + rank-1 correction formulation
   loses ~3-4 significant digits in float32 — centering first keeps the
   full working precision
   (tests/test_streaming.py::test_streaming_f32_mean_dominated);
3. spatial-mode projection ``Phi = sum_b (A_b - m 1^T) M_b`` with
   ``M = T_scaled diag(1/lambda) / Ns`` (PODFS.py:1329-1333).

The eigen half (host/device eigh, NaN-robust sort, condition-number valid
count, reference temporal-mode scaling) is shared with the in-memory path
(ops/pod.py:temporal_from_gram), so for configurations that fit in memory
the two paths agree to floating-point tolerance (tests/test_streaming.py).

The O(B^2) Gram pass is resumable: with ``checkpoint_dir`` set, the mean
vector and each completed Gram row strip are persisted
(utils/checkpoint.GramCheckpoint) and a restarted run recomputes only the
missing rows.  The same pass drives the mesh-sharded variant
(parallel/streaming.py) through :func:`streamed_gram`.

Regeneration count is O(B^2) block generations for B = ceil(Ns/block);
pick ``block`` as large as device memory allows (2 panels + the Gram tile).

The Gram and projection contractions run at ``Precision.HIGHEST``: a float32
GEMM on the GPU may otherwise run in TF32 (~3 decimal digits).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from pods_digital_filter_tpu.ops import pod as pod_ops
from pods_digital_filter_tpu.pipeline import make_generator

HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class StreamingPODResult:
    mean_field: np.ndarray      # (3*Np,)
    pod: pod_ops.PODResult
    num_blocks: int
    block: int
    # deferred-spectrum handle (streaming_pod(defer_spectrum=True)): the
    # eigvalsh of the Ns x Ns Gram still running in a worker thread while
    # the caller runs Fourier compression and model export; resolve()
    # joins it and finalizes pod.energy / num_valid / num_trunc
    _pending: object = None

    @property
    def spectrum_pending(self) -> bool:
        return self._pending is not None

    def resolve(self) -> bool:
        """Join the deferred spectrum (no-op if already resolved).

        Returns True if the valid-mode count came out SMALLER than the
        optimistic truncation the caller proceeded with — the pathological
        case in which Fourier/export stages run on more modes than are
        valid and must be redone (tests/test_streaming.py covers it via a
        large tol_cn)."""
        if self._pending is None:
            return False
        spec_fut, pool, tol_cn, num_modes_trunc, k = self._pending
        energy = spec_fut.result()
        pool.shutdown(wait=False)
        self._pending = None
        energy, num_valid, num_trunc = pod_ops.finalize_spectrum(
            energy, tol_cn, num_modes_trunc)
        self.pod.energy = energy
        self.pod.num_valid = num_valid
        shrank = num_trunc < self.pod.num_trunc
        self.pod.num_trunc = num_trunc
        if shrank:
            self.pod.spatial_modes = self.pod.spatial_modes[:, :num_trunc]
        return shrank


def _block_starts(ns: int, block: int):
    return list(range(0, ns, block))


@jax.jit
def _colsum(A):
    return jnp.sum(A, axis=1)


@jax.jit
def _colsum_acc(s, A):
    """``s += A.sum(axis=1)`` as ONE jitted dispatch — the mean pass's
    per-block accumulation."""
    return s + jnp.sum(A, axis=1)


@jax.jit
def _project_block_at(phi, Ac, Mfull, t0):
    """``phi += Ac @ Mfull[t0:t0+T]`` with the mode-coefficient matrix
    resident on device and sliced INSIDE the jit — one dispatch per block
    instead of a per-block host->device upload of the slice."""
    Mb = jax.lax.dynamic_slice_in_dim(Mfull, t0, Ac.shape[1], axis=0)
    return phi + jnp.dot(Ac, Mb.astype(Ac.dtype), precision=HIGHEST,
                         preferred_element_type=phi.dtype)


@jax.jit
def _pair_products(Ai, Aj):
    """Gram tile of two ALREADY-CENTERED blocks (the generator subtracts
    the mean inside the generation program — make_generator(center=m) —
    so float32 keeps its full significance even when the mean dominates
    the fluctuations, and no extra full-block centering buffer exists;
    see module docstring)."""
    return jnp.dot(Ai.T, Aj, precision=HIGHEST,
                   preferred_element_type=Ai.dtype)


class HostBlockCache:
    """Host-side cache of generated blocks (``--streaming_cache``): pass 1
    stores each block once; later passes read it back instead of
    regenerating, cutting the Gram pass's O(B^2) generations to O(B).

    ``mode='ram'`` keeps numpy arrays in host memory; ``mode='disk'`` keeps
    ``.npy`` memmaps under ``directory`` (bounded RAM, survives nothing —
    it is a cache, not a checkpoint).  Worth it only when the host link is
    fast relative to regeneration; otherwise pure regeneration (or
    ``gram_group``) wins — ``benchmarks/bench_flagship.py --crossover``
    measures the crossover."""

    def __init__(self, mode: str = "ram", directory: str | None = None):
        if mode not in ("ram", "disk"):
            raise ValueError(f"streaming_cache mode {mode!r}: ram|disk")
        self.mode = mode
        self._ram: dict = {}
        self._paths: dict = {}
        if mode == "disk":
            import tempfile
            self.dir = directory or tempfile.mkdtemp(prefix="pods_blockcache_")
            os.makedirs(self.dir, exist_ok=True)

    def put(self, t0: int, block) -> None:
        arr = np.asarray(block)
        if self.mode == "ram":
            self._ram[t0] = arr
        else:
            path = os.path.join(self.dir, f"block_{t0:08d}.npy")
            np.save(path, arr)
            self._paths[t0] = path

    def get(self, t0: int):
        if self.mode == "ram":
            return self._ram.get(t0)
        path = self._paths.get(t0)
        return None if path is None else np.load(path, mmap_mode="r")

    def wrap(self, gen):
        """Memoizing wrapper around a block generator (device arrays in,
        device arrays out; cached through host memory).  Only RAW blocks
        are cached (pass 1); the centered generator for passes 2/3 centers
        the cached block on device with a donated buffer
        (:func:`make_centered_generator`)."""

        def cached(t0):
            hit = self.get(int(t0))
            if hit is not None:
                return jnp.asarray(hit)
            A = gen(t0)
            self.put(int(t0), A)
            return A

        return cached


import functools


@functools.lru_cache(maxsize=None)
def _make_column_update(pair_fn):
    """ONE jitted dispatch per Gram column: all of the panel's row-block
    GEMMs against the column block, concatenated and written into the
    donated DEVICE-RESIDENT Gram accumulator at the (row, column) offset.
    Folding the per-row GEMM + insert pair into a single program keeps
    the dispatch count at one per column.  Because the accumulator has one
    shape (ns, ns) for the whole pass, every strip shares ONE executable
    per panel width.
    lru_cached on ``pair_fn`` (a module-level function) so every
    streamed_gram call reuses one jit instance and its executables."""

    def update(C, blocks, Aj, row0, col):
        tiles = [pair_fn(b, Aj) for b in blocks]
        tile = tiles[0] if len(tiles) == 1 else jnp.concatenate(tiles, 0)
        return jax.lax.dynamic_update_slice(
            C, tile, (jnp.asarray(row0, jnp.int32),
                      jnp.asarray(col, jnp.int32)))

    return jax.jit(update, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def _make_strip_slice(w: int, cols: int):
    """Jitted ``C[t_lo:t_lo+w, t_lo:t_lo+cols]`` — materializes one strip
    of the device Gram accumulator into its own (much smaller) buffer so
    it can download asynchronously while the next panel generates.  One
    compile per strip shape (a handful per pass; persistent-cached)."""
    return jax.jit(lambda C, t_lo: jax.lax.dynamic_slice(
        C, (jnp.asarray(t_lo, jnp.int32), jnp.asarray(t_lo, jnp.int32)),
        (w, cols)))


_sym_jit = jax.jit(lambda C, n: (jnp.triu(C) + jnp.triu(C, 1).T) / n)


def symmetrize_gram_device(C_dev, ns: int):
    """Device-side equivalent of the host mirror-and-scale at the end of
    :func:`streamed_gram`: keep the upper triangle as truth (exactly what
    the host assembly does — sub-diagonal tiles computed inside a wide
    panel are discarded), mirror it, divide by ``ns``.  Returns the full
    symmetric ``C = (A-m)^T(A-m)/ns`` as a device array, bit-matching the
    host matrix up to the f64 cast."""
    return _sym_jit(C_dev, jnp.asarray(ns, C_dev.dtype))


def _contiguous_runs(indices):
    """Split a sorted index list into maximal contiguous runs."""
    runs, run = [], []
    for i in indices:
        if run and i != run[-1] + 1:
            runs.append(run)
            run = []
        run.append(i)
    if run:
        runs.append(run)
    return runs


def streamed_gram(gen, ns: int, block: int, pair_fn, store=None,
                  verbose: bool = False, group: int = 1, make_buf=None,
                  return_device: bool = False, keep_host: bool = True):
    """The shared O(B^2) pairwise Gram pass over regenerated blocks.

    ``gen(t0)`` returns the ALREADY-CENTERED block for steps
    ``[t0, min(t0+block, ns))`` in whatever layout
    ``pair_fn(panel, Aj) -> panel.Aj tile`` consumes, with the time axis at
    axis 1 (the mean is subtracted inside the generation program —
    :func:`make_centered_generator` — so no extra full-block centering
    buffer exists in HBM).  With a :class:`GramCheckpoint` ``store``,
    completed row strips are loaded instead of recomputed and new rows are
    persisted as they finish (kill-and-resume tested in
    tests/test_streaming.py).  Returns the centered Gram
    ``C = (A-m)^T (A-m) / ns`` as host float64.

    ``group`` (``--gram_group``) holds that many row blocks resident in
    device memory as ONE wide panel while sweeping the columns once for all
    of them — the on-device cache: regenerated samples drop by ``group``x
    with no host traffic at all (the host-RAM cache trades regeneration
    for host-link uploads instead).

    Device-resident accumulation: every column's Gram tiles are written
    into ONE device ``(ns, ns)`` Gram accumulator (donated
    ``dynamic_update_slice`` — in place), so the column sweep is an async
    dispatch chain (generate -> per-row GEMM -> tile insert) with only a
    periodic sync.  When a panel's sweep finishes, its row strip is sliced
    out of the accumulator and ``copy_to_host_async``'d — the download
    streams over the host link WHILE the next panel generates, and is
    drained into the host matrix one panel later.  The resident panel
    stays a LIST of row blocks, never one concatenated buffer: a single
    contiguous allocation of the whole panel can fail on a fragmented
    heap where the same bytes in block-sized chunks fit.

    ``return_device=True`` additionally returns the raw device
    accumulator (un-normalized, upper-block-triangular — feed it to
    :func:`symmetrize_gram_device`), or None when any row was loaded
    from the checkpoint store (the accumulator would be incomplete) —
    the caller then falls back to host eigensolvers.

    ``keep_host=False`` (device-eigen callers, no checkpoint store): skip
    the strip downloads and the host assembly entirely and return
    ``(None, C_dev)`` — at the flagship size that removes ~210 MB of
    host-link traffic and the O(ns^2) host mirror from the pass; the
    caller materializes a host Gram on demand (rare fallbacks) from the
    symmetrized accumulator.  Forced True when a ``store`` is present
    (checkpoint rows are host-side by design).
    """
    from pods_digital_filter_tpu.parallel.mesh import hard_sync, to_host

    keep_host = keep_host or store is not None
    lead = jax.process_index() == 0
    starts = _block_starts(ns, block)
    nb = len(starts)
    C = np.zeros((ns, ns), dtype=np.float64) if keep_host else None
    group = max(1, int(group))
    # buffer allocator: the sharded path passes one that creates GLOBAL
    # arrays with mesh shardings (a plain jnp.zeros is process-local and
    # cannot mix with global operands under jax.distributed)
    zeros = jnp.zeros if make_buf is None else make_buf
    C_dev = None                 # lazily allocated (needs the block dtype)
    device_complete = True       # False once any row comes from the store
    pending_dl = []              # strips in flight: (slice, run, widths, t_lo)

    def drain(force=True):
        """Land in-flight strip downloads into the host matrix (+ the
        checkpoint store).  ``force=False`` drains only copies that have
        already completed (non-blocking) — called opportunistically so
        ``save_row`` persistence lags the compute by at most one strip."""
        while pending_dl:
            if not force:
                try:
                    if not pending_dl[0][0].is_ready():
                        return
                except Exception:
                    return
            sl_dev, run_, widths_, t_lo_ = pending_dl.pop(0)
            host_strip = to_host(sl_dev)           # completes the async copy
            off = 0
            for bi, wi in zip(run_, widths_):
                ti = starts[bi]
                C[ti:ti + wi, t_lo_:] = host_strip[off:off + wi]
                if store is not None and lead:
                    store.save_row(bi, host_strip[off:off + wi, ti - t_lo_:])
                off += wi
                if verbose:
                    print(f"streaming POD: gram row {bi + 1}/{nb}")

    for g0 in range(0, nb, group):
        rows = list(range(g0, min(g0 + group, nb)))
        pending = [bi for bi in rows
                   if store is None or bi not in store.completed_rows]
        for bi in rows:
            if bi not in pending:
                ti, ni = starts[bi], min(block, ns - starts[bi])
                C[ti:ti + ni, ti:] = store.load_row(bi)
                device_complete = False
                if verbose:
                    print(f"streaming POD: gram row {bi + 1}/{nb} "
                          "(from checkpoint)")
        # rows complete in order, so pending is contiguous; handle the
        # general case anyway (a hand-edited store) by sweeping each run
        for run in _contiguous_runs(pending):
            t_lo = starts[run[0]]                      # first strip step
            widths = [min(block, ns - starts[bi]) for bi in run]
            w = sum(widths)
            # resident panel: a dict of row BLOCKS (no concatenation — see
            # docstring).  Dispatch-only — no per-block sync: the device
            # executes queued programs in order, so generation transients
            # never coexist, and a deep queue is what keeps the device
            # busy while the host waits on the in-flight strip download
            panel = {}
            for bi in run:
                panel[bi] = gen(starts[bi])
            if C_dev is None:
                C_dev = zeros((ns, ns), panel[run[0]].dtype)
            # drain the previous strip here (its copy streamed under the
            # last sweep + this panel's dispatch).  With a checkpoint
            # store the drain is FORCED so `save_row` persistence never
            # lags a completed row by more than the in-flight copy (the
            # pre-round-5 guarantee, tests/test_sharded_streaming.py
            # kill-and-resume); without one it is non-blocking — pure
            # overlap, nothing to persist
            drain(force=store is not None)
            # column sweep over [t_lo, ns): an async dispatch chain into
            # the donated device accumulator; a sync every 32 columns
            # bounds dispatch run-ahead while keeping enough queued device
            # work to hide one strip download (whether that cadence still
            # pays is an open measurement)
            col_update = _make_column_update(pair_fn)
            blocks = tuple(panel[bi] for bi in run)
            Aj = None
            for idx, ji in enumerate(range(run[0], nb)):
                tj = starts[ji]
                # panel columns reuse the resident blocks — no regeneration
                Aj = panel[ji] if ji in panel else gen(tj)
                C_dev = col_update(C_dev, blocks, Aj, t_lo, tj)
                if idx % 32 == 31:
                    hard_sync(C_dev)
            if keep_host:
                # the PREVIOUS strip's async download has had this entire
                # column sweep to stream — drain it now (first run: no-op)
                drain()
                # slice this panel's strip out of the accumulator and
                # start its download; it streams while the NEXT panel
                # generates and sweeps
                sl = _make_strip_slice(w, ns - t_lo)(C_dev, t_lo)
                try:
                    sl.copy_to_host_async()
                except Exception:
                    pass      # backend without async copy: drain() syncs
                pending_dl.append((sl, run, widths, t_lo))
            elif verbose:
                # no host download on this path — report row progress at
                # the sweep boundary instead of at drain time
                for bi in run:
                    print(f"streaming POD: gram row {bi + 1}/{nb} "
                          "(device-resident)")
            # drop every reference to this strip's panel BEFORE the next
            # strip generates its own: the `blocks` tuple alone keeps the
            # full panel alive, and two panels must never coexist
            panel.clear()
            del blocks, Aj
    if not keep_host:
        hard_sync(C_dev)
        if return_device:
            return None, (C_dev if device_complete else None)
        raise ValueError("keep_host=False requires return_device=True")
    drain()
    # mirror upper -> lower, blockwise (a global triu_indices fancy-index
    # mirror allocates two ~ns^2/2 int64 index arrays — 840 MB at the
    # flagship size — and scatters element-wise; the block transpose is a
    # plain strided copy, ~10x faster; the small per-block fancy index
    # covers the within-diagonal-block lower triangle)
    bs = 1024
    il = np.tril_indices(bs, -1)
    for j0 in range(0, ns, bs):
        j1 = min(j0 + bs, ns)
        C[j0:j1, :j0] = C[:j0, j0:j1].T
        blk = C[j0:j1, j0:j1]
        ib = il if j1 - j0 == bs else np.tril_indices(j1 - j0, -1)
        blk[ib] = blk.T[ib]
    C /= ns
    if return_device:
        return C, (C_dev if device_complete else None)
    return C


def make_centered_generator(cfg, fields, filt, block, ns, rotate, m,
                            cached_raw_gen=None):
    """Block generator that yields MEAN-CENTERED blocks for the Gram and
    projection passes.

    Without a cache, the mean subtraction is fused into the generation
    program itself (``make_generator(center=m)``) — XLA folds it into the
    pack/rotation epilogue, so centering costs no extra device memory.  A
    separate centering op would materialize a second full-block temporary
    (3*Np x 512 f32 ~ 3 GB at the flagship block size).

    With a :class:`HostBlockCache` (``cached_raw_gen`` set), raw cached
    blocks are centered on device with a DONATED input buffer (in-place,
    still no second full-block temporary)."""
    if cached_raw_gen is not None:
        sub = jax.jit(lambda A, mm: A - mm[:, None], donate_argnums=0)
        return lambda t0: sub(cached_raw_gen(t0), m)
    gen_block = make_generator(cfg, fields, filt, nsteps=block,
                               rotate=rotate, center=m)

    def gen_c(t0):
        A = gen_block(t0)
        n = min(block, ns - t0)
        return A[:, :n] if n < block else A

    return gen_c


def gram_pass_hbm_estimate(np3: int, block: int, group: int, itemsize: int,
                           nfx: int, ns: int = 0) -> int:
    """Analytic peak device bytes of the Gram-pass column sweep — the
    coexisting tensors:

    * the resident row panel: ``group`` blocks of ``np3 * block`` elements;
    * the regenerated column block (one more);
    * the generation transients inside the column block's generation
      program: the filtered-slab tensor (``block + 2*nfx`` time slabs, the
      temporal-FIR input) and the FIR output block, which coexist at the
      temporal-contraction step;
    * (round 5, when ``ns`` is given) the device-resident ``(ns, ns)``
      Gram accumulator plus up to two in-flight strip slices (the one
      just cut for async download and the previous one still draining),
      each at most ``group * block * ns`` elements.

    Compared against the device's own allocation limit
    (:func:`device_memory_limit`) before every Gram pass."""
    blk = np3 * block * itemsize
    slab = np3 * (block + 2 * nfx) * itemsize     # temporal-FIR input
    transients = slab + blk                       # + FIR output block
    gram_acc = ns * ns * itemsize + 2 * group * block * ns * itemsize
    return int((group + 1) * blk + transients + gram_acc)


def device_memory_limit(device=None) -> int | None:
    """Bytes the runtime lets this process allocate on ``device`` (default:
    the first local device), from ``memory_stats()["bytes_limit"]``; None
    when the backend reports no memory statistics (the CPU backend)."""
    device = jax.local_devices()[0] if device is None else device
    stats = device.memory_stats()
    if not stats or not stats.get("bytes_limit"):
        return None
    return int(stats["bytes_limit"])


def cache_host_ram_estimate(np3: int, ns: int, itemsize: int) -> int:
    """Host bytes a ``--streaming_cache ram`` run will retain: every raw
    generated block, i.e. the full ``(3*Np, Ns)`` snapshot matrix (~63 GB
    at the flagship size)."""
    return np3 * ns * itemsize


def _warn_cache_host_ram(np3, ns, itemsize, phys_bytes=None):
    """Pre-run warning mirroring :func:`_warn_gram_hbm`: ``mode='ram'``
    silently accumulating more than half of physical host RAM should fail
    loudly up front (suggesting ``--streaming_cache disk``), not as a host
    OOM kill mid-pass."""
    est = cache_host_ram_estimate(np3, ns, itemsize)
    if phys_bytes is None:
        try:
            phys_bytes = (os.sysconf("SC_PAGE_SIZE")
                          * os.sysconf("SC_PHYS_PAGES"))
        except (ValueError, OSError, AttributeError):
            return
    if est > 0.5 * phys_bytes:
        import warnings

        warnings.warn(
            f"--streaming_cache ram will retain every generated block: "
            f"~{est / 2 ** 30:.1f} GiB of host memory (the full snapshot "
            f"matrix) against {phys_bytes / 2 ** 30:.1f} GiB physical RAM "
            f"— use --streaming_cache disk (bounded RAM, .npy memmaps) or "
            f"drop the cache (pure regeneration).",
            stacklevel=3)


def _warn_gram_hbm(np3, block, group, itemsize, nfx, ns, bytes_limit):
    """Warn before a Gram pass whose analytic peak exceeds the device's
    allocation limit ``bytes_limit``; silent when the limit is unknown
    (None).  Fires at every group including the default 1: an oversized
    --streaming_block at group=1 fails mid-pass just the same."""
    if bytes_limit is None:
        return
    est = gram_pass_hbm_estimate(np3, block, group, itemsize, nfx, ns)
    if est > bytes_limit:
        import warnings

        warnings.warn(
            f"--gram_group {group} with --streaming_block {block} puts the "
            f"Gram-pass peak at an estimated {est / 2 ** 30:.1f} GiB of "
            f"device memory "
            f"(panel {group} x {np3 * block * itemsize / 2 ** 30:.1f} GiB "
            f"+ generation transients + Gram accumulator), above the "
            f"device's {bytes_limit / 2 ** 30:.1f} GiB allocation limit — "
            f"likely out of memory; reduce --gram_group or "
            f"--streaming_block.",
            stacklevel=3)


def make_gram_store(cfg, filt, fields, rotate, block, extra=()):
    """GramCheckpoint keyed by everything that determines the Gram values —
    including the resolved turbulence stress/mean fields (the Lund coloring
    input): changing --u_dash/--U0/--mean_profile/--turb_profile or the
    profile file contents invalidates the store even when plane/filter/seed
    are unchanged.  "gram-v2": rows store centered products."""
    from pods_digital_filter_tpu.ops.filters import STREAM_TAG
    from pods_digital_filter_tpu.utils.checkpoint import (
        GramCheckpoint, config_fingerprint)

    # the literal False stands where a generator-choice flag used to be
    # keyed, so stores written before that flag went still resume
    fp = config_fingerprint((cfg.plane, filt, cfg.seed, cfg.dtype, rotate,
                             False, fields, STREAM_TAG, "gram-v2")
                            + tuple(extra))
    return GramCheckpoint(cfg.checkpoint_dir, fp, cfg.nsteps, block)


def streaming_pod(
    cfg,
    fields,
    filt,
    rotate: bool = True,
    block: int = 512,
    num_modes_trunc: int | None = None,
    tol_cn: float = 1.0e-15,
    verbose: bool = False,
    timer=None,
    defer_spectrum: bool = False,
) -> StreamingPODResult:
    """Snapshot POD of the full ``cfg.nsteps`` generation run without ever
    materializing the snapshot matrix.

    ``defer_spectrum=True`` (two-phase eig path only): return while the
    full eigvalsh spectrum — needed only for the valid-mode count and the
    eigenvalue file — still runs in a worker thread; the caller overlaps
    Fourier compression / model export with it and calls
    ``result.resolve()`` before touching ``pod.energy``/``num_valid``
    (pipeline._run_pipeline_streaming).

    ``cfg/fields/filt`` are exactly the arguments of
    :func:`pipeline.generate_snapshot_matrix`; blocks are regenerated with
    the same counters, so the result matches the in-memory pipeline.  With
    ``cfg.checkpoint_dir`` set, the mean and Gram passes are resumable.
    ``cfg.gram_group`` > 1 keeps that many row blocks HBM-resident during
    the Gram pass; ``cfg.streaming_cache`` memoizes generated blocks on the
    host (see :func:`streamed_gram` / :class:`HostBlockCache` for when each
    wins).  ``timer`` (utils.timing.StageTimer) records the per-pass wall
    times (mean / gram / eigh / projection).
    """
    from contextlib import nullcontext

    stage = (lambda name: nullcontext()) if timer is None else timer.stage
    ns = cfg.nsteps
    block = min(block, ns)
    starts = _block_starts(ns, block)
    nb = len(starts)
    if num_modes_trunc is None:
        num_modes_trunc = cfg.podfs.num_modes

    store = None
    if getattr(cfg, "checkpoint_dir", "none") != "none":
        store = make_gram_store(cfg, filt, fields, rotate, block)

    _warn_gram_hbm(3 * cfg.plane.jma * cfg.plane.kma, block,
                   getattr(cfg, "gram_group", 1),
                   jnp.dtype(cfg.dtype).itemsize, filt.nfx, ns,
                   device_memory_limit())

    # one compiled executable for every block (t0 is a dynamic argument);
    # the ragged final block generates a full window and keeps the first
    # ns-t0 columns (identical values — the stream is counter-indexed)
    gen_block = make_generator(cfg, fields, filt, nsteps=block, rotate=rotate)

    def gen(t0):
        A = gen_block(t0)
        n = min(block, ns - t0)
        return A[:, :n] if n < block else A

    cache_mode = getattr(cfg, "streaming_cache", "none")
    if cache_mode != "none":
        if cache_mode == "ram":
            _warn_cache_host_ram(3 * cfg.plane.jma * cfg.plane.kma, ns,
                                 jnp.dtype(cfg.dtype).itemsize)
        gen = HostBlockCache(cache_mode).wrap(gen)
        cached_raw_gen = gen
    else:
        cached_raw_gen = None

    # ---- pass 1: mean --------------------------------------------------
    with stage("streaming_mean"):
        m_host = store.load_mean() if store is not None else None
        if m_host is not None:
            m = jnp.asarray(m_host, dtype=jnp.dtype(cfg.dtype))
            if verbose:
                print("streaming POD: mean loaded from checkpoint")
        else:
            s = None
            for t0 in starts:
                s = _colsum(gen(t0)) if s is None \
                    else _colsum_acc(s, gen(t0))
            m = s / ns                           # (3*Np,) device
            from pods_digital_filter_tpu.parallel.mesh import hard_sync
            hard_sync(m)
            if store is not None and jax.process_index() == 0:
                store.save_mean(np.asarray(m, dtype=np.float64))
            if verbose:
                print(f"streaming POD: mean pass done "
                      f"({nb} blocks of {block})")

    # passes 2/3 consume CENTERED blocks; the subtraction lives inside the
    # generation jit (or a donated-buffer op on cached blocks) — zero extra
    # full-block HBM temporaries (see make_centered_generator)
    gen_c = make_centered_generator(cfg, fields, filt, block, ns, rotate, m,
                                    cached_raw_gen=cached_raw_gen)

    # ---- pass 2: Gram (shared, resumable) -------------------------------
    # On the device-eigen (topk) path with no checkpoint store, the host
    # Gram is only a rare-fallback input — skip its ~ns^2/2 download and
    # host assembly entirely (keep_host=False) and materialize it on
    # demand from the symmetrized accumulator if a fallback ever needs it.
    nvec = pod_ops.resolve_num_vectors(cfg, ns, num_modes_trunc)
    with stage("streaming_gram"):
        C, C_dev = streamed_gram(gen_c, ns, block, _pair_products,
                                 store=store, verbose=verbose,
                                 group=getattr(cfg, "gram_group", 1),
                                 return_device=True,
                                 keep_host=nvec is None)

    # ---- eigen half + pass 3 (spatial modes) ----------------------------
    from pods_digital_filter_tpu.parallel.mesh import hard_sync

    def project(temporal_k, energy_k, k):
        """Device projection pass over the centered blocks
        (PODFS.py:1329-1333), using the top-``k`` scaled temporal modes —
        uploaded ONCE and sliced on device per block."""
        dtype = m.dtype
        Mfull = jnp.asarray((temporal_k[:, :k]
                             * (1.0 / energy_k[:k])[None, :]) / ns,
                            dtype=dtype)
        phi = jnp.zeros((m.shape[0], k), dtype=dtype)
        for t0 in starts:
            Ac = gen_c(t0)
            phi = _project_block_at(phi, Ac, Mfull,
                                    jnp.asarray(t0, jnp.int32))
        hard_sync(phi)
        if verbose:
            print("streaming POD: projection pass done")
        return phi

    if nvec is not None:
        # Two-phase eigendecomposition, OVERLAPPED and device-resident:
        # the top-k vector stage runs as device Lanczos on the resident
        # Gram accumulator, and the full spectrum — needed only for the
        # valid-mode count and the eigenvalue file — is ALSO computed on
        # the device (an m = n Lanczos run IS a complete
        # tridiagonalization), dispatched AFTER the projection so the device queue order is vectors ->
        # projection -> spectrum, with the spectrum running under the
        # host-side Fourier/export (and the caller's replay verification,
        # via defer_spectrum).  Host eigvalsh in a worker thread remains
        # the fallback when no device accumulator exists (checkpoint
        # resume) or the device run fails its quality gates.
        from concurrent.futures import ThreadPoolExecutor

        from pods_digital_filter_tpu.ops import lanczos

        k = max(1, min(max(nvec, num_modes_trunc), ns))
        spec_fut = None
        pool = None
        e_k = v_k = None
        C_sym = None
        if C_dev is not None:
            # Float64 path (CPU tests and any f64-capable device): ONE
            # complete block-Lanczos band reduction yields the FULL
            # spectrum and the top-k vectors together — the whole eigen
            # half becomes synchronous: no worker thread, no deferred
            # spectrum, no optimistic shrink-redo.  In float32 the block
            # path is NOT used: its MGS orthonormalization leaves
            # ~1.5e-3 relative spectrum error (vs the scalar recurrence's
            # ~1e-7) — the f32 path uses the scalar recurrence with the
            # deferred overlapped spectrum below.
            e_full = v_blk = None
            with stage("streaming_eigh_vectors"):
                with stage("eigh_vectors_symmetrize"):
                    C_sym = symmetrize_gram_device(C_dev, ns)
                    from pods_digital_filter_tpu.parallel.mesh import \
                        hard_sync as _hs
                    _hs(C_sym)
                C_dev = None     # free the raw accumulator
                if np.dtype(C_sym.dtype) == np.float64:
                    with stage("eigh_vectors_lanczos"):
                        e_full, v_blk = lanczos.spectrum_and_topk(C_sym, k)
            if e_full is not None:
                C_sym = None
                # reference spectrum semantics applied NOW — nothing left
                # to resolve
                energy, num_valid, num_trunc = pod_ops.finalize_spectrum(
                    e_full, tol_cn, num_modes_trunc)
                num_trunc = min(num_trunc, k)
                with stage("streaming_projection"):
                    e_lead = energy[:k]
                    temporal = pod_ops.scale_temporal_leading(v_blk,
                                                              e_lead, ns)
                    phi = project(temporal, e_lead, num_trunc)
                    phi = np.asarray(phi)
                pr = pod_ops.PODResult(
                    energy=energy, temporal_modes=temporal,
                    spatial_modes=phi,
                    num_valid=num_valid, num_trunc=num_trunc,
                )
                return StreamingPODResult(
                    mean_field=np.asarray(m, dtype=np.float64), pod=pr,
                    num_blocks=nb, block=block,
                )
            # float32, or block gates tripped: scalar device Lanczos for
            # the vectors, device/host spectrum deferred as before
            with stage("streaming_eigh_vectors"):
                with stage("eigh_vectors_lanczos"):
                    e_k, v_k = lanczos.topk_or_none(C_sym, k)
            if e_k is None:
                # Lanczos gate tripped: materialize the host Gram from
                # the symmetrized accumulator if the pass skipped it
                # (values equal the host assembly up to the f32 divide)
                if C is None:
                    C = np.asarray(C_sym, dtype=np.float64)
                C_sym = None     # free before the host path
        if e_k is None:
            # host fallback: Gram rows came from the checkpoint store (no
            # device accumulator) or the Lanczos residual gate tripped.
            # Vectors FIRST, then the spectrum thread — both run on the
            # same host cores and must not compete.
            with stage("streaming_eigh_vectors"):
                e_k, v_k = pod_ops.eigh_desc_topk(C, k)
            pool = ThreadPoolExecutor(1)
            spec_fut = pool.submit(pod_ops.eig_spectrum_desc, C)
        with stage("streaming_projection"):
            # reference temporal-mode scaling on the k Lanczos columns
            # (eigenvalues agree with the spectrum to machine precision)
            temporal = pod_ops.scale_temporal_leading(v_k, e_k, ns)
            phi = project(temporal, e_k, k)
            try:
                phi.copy_to_host_async()
            except Exception:
                pass
            # land the truncated modes BEFORE the device spectrum is
            # dispatched, so the download never queues behind the
            # spectrum scan (whether this ordering still pays is an open
            # measurement)
            phi = np.asarray(phi)
        if spec_fut is None:
            # device spectrum, dispatched after the projection: the scan
            # queues behind phi on the device and runs while the host
            # compresses/exports (and replay-verifies, under
            # defer_spectrum/defer_finalize); falls back to host eigvalsh
            # inside the worker if the device run returns non-finite
            def _device_spectrum(C_sym=C_sym, C=C):
                e = lanczos.full_spectrum(C_sym)
                if e is not None:
                    return e
                if C is None:
                    C = np.asarray(C_sym, dtype=np.float64)
                return pod_ops.eig_spectrum_desc(C)

            pool = ThreadPoolExecutor(1)
            spec_fut = pool.submit(_device_spectrum)
            C_sym = None         # the worker holds the last reference
        # optimistic result: the caller may run Fourier/export against the
        # k truncated modes while the spectrum thread finishes
        # (defer_spectrum); resolve() joins and finalizes
        pr = pod_ops.PODResult(
            energy=e_k, temporal_modes=temporal,
            spatial_modes=np.asarray(phi),
            num_valid=k, num_trunc=min(k, num_modes_trunc),
        )
        res = StreamingPODResult(
            mean_field=np.asarray(m, dtype=np.float64), pod=pr,
            num_blocks=nb, block=block,
            _pending=(spec_fut, pool, tol_cn, num_modes_trunc, k),
        )
        if not defer_spectrum:
            with stage("streaming_eigh_spectrum"):
                res.resolve()
        return res

    C_dev = None               # full-eig path is host-side: free the HBM
    with stage("streaming_eigh"):
        energy, temporal, num_valid, num_trunc = \
            pod_ops.temporal_from_gram(C, ns, num_modes_trunc, tol_cn)
    with stage("streaming_projection"):
        phi = project(temporal, energy, num_trunc)

    pr = pod_ops.PODResult(
        energy=energy,
        temporal_modes=temporal,
        spatial_modes=np.asarray(phi),
        num_valid=num_valid,
        num_trunc=num_trunc,
    )
    return StreamingPODResult(
        mean_field=np.asarray(m, dtype=np.float64), pod=pr,
        num_blocks=nb, block=block,
    )


def write_snapshots_streaming(cfg, fields, filt, geom, dt: float,
                              rotate: bool = True, block: int = 512):
    """Verbose-mode per-step ``.prf`` snapshot export without holding A —
    regenerates blocks and writes columns as they appear."""
    import numpy as _np

    from pods_digital_filter_tpu.io import prf as prf_io

    block = min(block, cfg.nsteps)
    gen_block = make_generator(cfg, fields, filt, nsteps=block, rotate=rotate)
    paths = []
    for t0 in _block_starts(cfg.nsteps, block):
        A = _np.asarray(gen_block(t0), dtype=_np.float64)
        A = A[:, :min(block, cfg.nsteps - t0)]
        for i in range(A.shape[1]):
            paths.append(prf_io.write_snapshot_prf(
                cfg.outdir, (t0 + i) * dt, A[:, i], geom,
                cfg.plane.normal, cfg.plane.origin))
    return paths
