"""Typed configuration objects.

Replaces the reference's untyped attribute-bag ``obj``/``i_d`` state object
(``digitalfilters.py:31-32, 1379-1395``) and its optparse flag soup
(``digitalfilters.py:1137-1242``) with frozen dataclasses.  All derived
quantities (filter half-widths, noise-buffer shapes, timestep) are computed in
one place with the reference's exact semantics.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _unit(v: Tuple[float, float, float]) -> Tuple[float, float, float]:
    n = math.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    return (v[0] / n, v[1] / n, v[2] / n)


@dataclass(frozen=True)
class PlaneConfig:
    """Inlet-plane geometry (reference: ``make_inflow_plane``, PODFS.py:1243-1290).

    ``jma`` is the number of cells in the spanwise (j / y) direction, ``kma``
    in the wall-normal (k / z) direction; ``res`` is meters per grid point.
    """

    jma: int = 10
    kma: int = 11
    res: float = 0.1
    normal: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rot_deg: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "normal", _unit(self.normal))

    @property
    def num_points(self) -> int:
        return self.jma * self.kma


@dataclass(frozen=True)
class FilterConfig:
    """Klein digital-filter parameters (reference: digitalfilters.py:1282-1322).

    ``length_scale_*`` are turbulence length scales in grid spacings; the
    filter half-width is ``nf = ceil(fwidth * length_scale)`` per axis
    (digitalfilters.py:1282).  Axis x is time.
    """

    length_scale_x: float = 3.0
    length_scale_y: float = 3.0
    length_scale_z: float = 3.0
    fwidth: float = 2.0
    # Explicit half-width overrides (None -> derived from fwidth*length_scale).
    nfx_override: Optional[int] = None

    @property
    def nfx(self) -> int:
        if self.nfx_override is not None:
            return self.nfx_override
        return int(math.ceil(self.fwidth * self.length_scale_x))

    @property
    def nfy(self) -> int:
        return int(math.ceil(self.fwidth * self.length_scale_y))

    @property
    def nfz(self) -> int:
        return int(math.ceil(self.fwidth * self.length_scale_z))

    def with_time_rescale(self, dt: float, dt_auto: float) -> "FilterConfig":
        """Reference semantics for a user-specified dt (digitalfilters.py:1315-1322):
        the x (time) length scale is stretched by ``dt_auto/dt`` and nfx recomputed.
        """
        factor = dt_auto / dt
        lnx = factor * self.length_scale_x
        nfx = int(math.ceil(float(self.fwidth) * lnx))
        return dataclasses.replace(self, length_scale_x=lnx, nfx_override=nfx)


@dataclass(frozen=True)
class PODFSConfig:
    """POD + Fourier-series compression parameters (PODFS.py:1294, 1523)."""

    num_modes: int = 20           # -m / nm
    energy_target: float = 0.9    # -e / et
    tol_cn: float = 1.0e-15       # condition-number tolerance (digitalfilters.py:1500)


@dataclass(frozen=True)
class PipelineConfig:
    """Full end-to-end run configuration — union of every reference CLI flag
    (digitalfilters.py:1143-1237, docs/usage/options.rst)."""

    plane: PlaneConfig = PlaneConfig()
    filt: FilterConfig = FilterConfig()
    podfs: PODFSConfig = PODFSConfig()

    nsteps: int = 20                    # -n
    dt: float = 0.0                     # -t (0 -> auto from res and mean U)
    mean_profile: str = "hyperbolic-tangent"   # -p
    turb_profile: str = "top-hat"              # --turb_profile
    bulk_velocity: float = 1.0                 # --U0
    turbulence_intensity: float = 0.02         # --u_dash
    inner_d: float = 0.5                       # --ring
    profile_file: str = "none"                 # -i
    massflow: float = 0.0                      # --massflow
    density: float = 0.0                       # --density
    non_dim: bool = False                      # --non_dim
    hdf5: bool = False                         # -5
    verbose: bool = False                      # -v
    test_gradients: bool = False               # --test_gradients
    outdir: str = "PODFS"
    seed: int = 0
    dtype: str = "float32"                     # compute dtype on device
    # Sharding: number of mesh shards along plane (z) and time axes; 1 = no sharding.
    shard_space: int = 1
    shard_time: int = 1
    # Halo-exchange noise generation over the 's' mesh axis
    # (parallel/sharding.generate_sharded_halo): each device draws only its
    # own z-tile of noise and exchanges nfz-wide halos with its neighbours
    # via lax.ppermute — use for very large planes where duplicating the
    # full-width noise per shard dominates.  Statistically equivalent to the
    # exact path, different noise indexing.
    halo_exchange: bool = False
    # Resumable generation: directory for block-granular checkpoints
    # ("none" disables; see utils/checkpoint.py)
    checkpoint_dir: str = "none"
    checkpoint_block: int = 0           # 0 -> auto block size
    # Out-of-core POD (streaming.py): never materialize the (3*Np, Ns)
    # snapshot matrix; regenerate blocks of this many steps from the
    # counter-indexed noise stream instead.  0 -> off (in-memory POD).
    streaming_block: int = 0
    # Streaming-POD Gram-pass accelerators (streaming.py:streamed_gram):
    # gram_group holds this many row blocks device-resident during one
    # column sweep (generations drop ~group-fold, zero host traffic);
    # streaming_cache ("none"|"ram"|"disk") memoizes generated blocks on the
    # host instead — only a win when the host link outruns regeneration
    # (measured crossover: benchmarks/bench_flagship.py).
    gram_group: int = 1
    streaming_cache: str = "none"
    # Eigendecomposition strategy for the streaming POD's Ns x Ns Gram
    # (ops/pod.py:resolve_num_vectors).  "full": host LAPACK dsyevd, all
    # eigenvectors (needed by --verbose, which exports every valid temporal
    # mode).  "topk": two-phase — eigvalsh full SPECTRUM (valid-mode count
    # + eigenvalue file consume every eigenvalue) + Lanczos top-num_modes
    # VECTORS only (projection/Fourier consume only those); ~2x faster at
    # Ns = 10,240 where the full back-transform computes 10,240 vectors to
    # use 20.  "auto": topk for large non-verbose runs.
    eig_mode: str = "auto"

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    def validate(self) -> None:
        """Reject unsupported flag combinations loudly (no silent
        precedence): every execution-mode combination either has a defined
        code path (docs/options.md, 'Execution modes') or raises here."""
        sharded = self.shard_time * self.shard_space > 1
        if self.shard_time < 1 or self.shard_space < 1:
            raise ValueError("shard_time/shard_space must be >= 1")
        if self.halo_exchange and self.shard_space <= 1:
            raise ValueError(
                "--halo requires --shard_space > 1 (halo exchange happens "
                "over the 's' mesh axis)")
        if sharded:
            if not self.streaming_block and self.nsteps % self.shard_time:
                # streaming generates fixed-size windows, so only the block
                # size needs to divide (checked below)
                raise ValueError(
                    f"nsteps={self.nsteps} not divisible by "
                    f"shard_time={self.shard_time}")
            if self.plane.kma % self.shard_space:
                raise ValueError(
                    f"kma={self.plane.kma} not divisible by "
                    f"shard_space={self.shard_space}")
            if self.checkpoint_dir != "none" and not self.streaming_block:
                raise ValueError(
                    "--checkpoint_dir with sharding requires "
                    "--streaming_block (resumable sharded runs checkpoint "
                    "the streaming Gram pass; the in-memory sharded path "
                    "has no checkpoint store)")
            if self.streaming_block and self.streaming_block % self.shard_time:
                raise ValueError(
                    f"streaming_block={self.streaming_block} not divisible "
                    f"by shard_time={self.shard_time}")
            if self.streaming_cache != "none":
                raise ValueError(
                    "--streaming_cache is single-process/single-device "
                    "(sharded blocks live distributed on the mesh; gathering "
                    "them to a host cache would defeat the sharding) — use "
                    "--gram_group instead, which composes with sharding")
        if self.streaming_cache not in ("none", "ram", "disk"):
            raise ValueError(
                f"streaming_cache={self.streaming_cache!r}: none|ram|disk")
        if self.gram_group < 1:
            raise ValueError("gram_group must be >= 1")
        if (self.streaming_cache != "none" or self.gram_group > 1) \
                and not self.streaming_block:
            raise ValueError(
                "--streaming_cache/--gram_group only apply to the streaming "
                "POD (--streaming_block)")
        if self.eig_mode not in ("auto", "full", "topk"):
            raise ValueError(f"eig_mode={self.eig_mode!r}: auto|full|topk")
        if self.eig_mode == "topk" and self.verbose:
            raise ValueError(
                "--eig_mode topk computes only the truncated eigenvectors; "
                "--verbose exports every valid temporal mode and needs the "
                "full basis (use --eig_mode full or auto)")

    def compute_dt(self, U: np.ndarray, V=0.0, W=0.0) -> Tuple[float, "FilterConfig"]:
        """Timestep logic of digitalfilters.py:1311-1322.

        Returns (dt, possibly-rescaled FilterConfig).  With ``dt == 0`` the
        timestep is set to ``res / mean(U over nonzero-speed points)``;
        otherwise the x length scale / half-width are rescaled.
        """
        speed2 = U ** 2 + np.asarray(V) ** 2 + np.asarray(W) ** 2
        flag = speed2 != 0
        dt_auto = self.plane.res / float(np.mean(np.asarray(U)[flag]))
        if self.dt == 0.0:
            return dt_auto, self.filt
        return self.dt, self.filt.with_time_rescale(self.dt, dt_auto)
