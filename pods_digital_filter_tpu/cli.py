"""Command-line driver mirroring every reference flag
(digitalfilters.py:1137-1242; docs/usage/options.rst), plus options of its
own (seed, dtype, sharding, out-of-core POD, profiling).

Usage:  python -m pods_digital_filter_tpu.cli [options]
"""

from __future__ import annotations

import argparse
import sys

from pods_digital_filter_tpu import PROG, __version__
from pods_digital_filter_tpu.config import (
    FilterConfig, PipelineConfig, PlaneConfig, PODFSConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="LES Inflow Generator after Klein et al. — "
                    "digital-filter turbulence + PODFS compression in JAX",
    )
    p.add_argument("--version", action="version", version=f"{PROG} {__version__}")
    p.add_argument("-i", "--inputfile", dest="profilefile", default="none",
                   metavar="FILE", help="1d turbulent profile file or 2d .prf file")
    p.add_argument("-p", "--mean_profile", default="hyperbolic-tangent",
                   help="mean flow profile: hyperbolic-tangent, "
                        "double-hyperbolic-tangent, ring-hyperbolic-tangent, "
                        "circular-hyperbolic-tangent")
    p.add_argument("--turb_profile", default="top-hat",
                   help="turbulence profile: top-hat, none")
    p.add_argument("--U0", "--bulk_velocity", type=float, dest="bulk_velocity",
                   default=1.0, help="bulk velocity magnitude")
    p.add_argument("--u_dash", type=float, dest="turbulence_intensity",
                   default=0.02, help="u'/U0 with u'=v'=w'")
    p.add_argument("-n", "--nsteps", type=int, default=20, help="number of steps")
    p.add_argument("-l", "--lengthscale", type=float, default=3.0,
                   help="turbulent lengthscale in grid spacings")
    p.add_argument("-f", "--fwidth", type=float, default=2.0,
                   help="half filter width in lengthscales (>= 2)")
    p.add_argument("-k", "--nk", type=int, dest="kma", default=11,
                   help="points in k (wall-normal) direction")
    p.add_argument("-j", "--nj", type=int, dest="jma", default=10,
                   help="points in j (spanwise) direction")
    p.add_argument("-t", "--dt", type=float, default=0.0, help="time step (s)")
    p.add_argument("-m", "--nm", type=int, default=20, help="number of POD modes")
    p.add_argument("-e", "--et", type=float, default=0.9,
                   help="target energy for Fourier reconstruction")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="save mean flow, POD spatial and temporal modes")
    p.add_argument("--non_dim", action="store_true",
                   help="non-dimensionalise lengths if using .prf")
    p.add_argument("-r", "--resolution", type=float, dest="res", default=0.1,
                   help="plane resolution in meters per grid point")
    p.add_argument("--nx", type=float, default=1.0, help="plane normal x")
    p.add_argument("--ny", type=float, default=0.0, help="plane normal y")
    p.add_argument("--nz", type=float, default=0.0, help="plane normal z")
    p.add_argument("--ox", type=float, default=0.0, help="plane origin x")
    p.add_argument("--oy", type=float, default=0.0, help="plane origin y")
    p.add_argument("--oz", type=float, default=0.0, help="plane origin z")
    p.add_argument("--rotate", type=float, dest="rot", default=0.0,
                   help="rotate plane about its normal (degrees)")
    p.add_argument("--ring", type=float, default=0.5,
                   help="ring inner diameter / outer diameter")
    p.add_argument("--massflow", type=float, dest="mdot", default=0.0,
                   help="scale .prf velocities to this mass flow (needs --density)")
    p.add_argument("--density", type=float, dest="den", default=0.0,
                   help="density for --massflow")
    p.add_argument("-5", "--hdf5", action="store_true",
                   help="save PODFS control file, mean and modes as one hdf5")
    p.add_argument("--test_gradients", action="store_true",
                   help="set U,V,W = 1y+2z, 3y+4z, 5y+6z to verify gradients")
    # --- extensions beyond the reference flags ---
    p.add_argument("--outdir", default="PODFS", help="output directory")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="device compute dtype")
    p.add_argument("--shard_space", type=int, default=1,
                   help="mesh shards along the plane (z) axis")
    p.add_argument("--shard_time", type=int, default=1,
                   help="mesh shards along the time axis")
    p.add_argument("--halo", action="store_true", dest="halo_exchange",
                   help="halo-exchange noise generation over the 's' mesh "
                        "axis (lax.ppermute) instead of the exact "
                        "duplicate-noise path; use for very large planes. "
                        "Requires --shard_space > 1")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--checkpoint_dir", default="none",
                   help="block-granular generation checkpoints for "
                        "resumable runs (utils/checkpoint.py)")
    p.add_argument("--checkpoint_block", type=int, default=0,
                   help="steps per checkpoint block (0 = auto)")
    p.add_argument("--streaming_block", type=int, default=0,
                   help="out-of-core POD: never materialize the snapshot "
                        "matrix; regenerate blocks of this many steps "
                        "instead (0 = off; use when 3*Np*nsteps exceeds "
                        "device memory)")
    p.add_argument("--gram_group", type=int, default=1,
                   help="streaming POD: hold this many row blocks "
                        "device-resident during the Gram pass (generations "
                        "drop ~group-fold; composes with sharding)")
    p.add_argument("--streaming_cache", default="none",
                   choices=("none", "ram", "disk"),
                   help="streaming POD: memoize generated blocks on the "
                        "host (ram) or as .npy memmaps (disk) — wins only "
                        "when the host link outruns regeneration; "
                        "single-process only")
    p.add_argument("--eig_mode", default="auto",
                   choices=("auto", "full", "topk"),
                   help="streaming POD eigendecomposition: full = all "
                        "eigenvectors (host LAPACK); topk = full spectrum "
                        "(eigvalsh) + Lanczos top-nm vectors only (~2x "
                        "faster at 10k snapshots); auto = topk for large "
                        "non-verbose runs")
    p.add_argument("--timings", action="store_true", help="print stage timings")
    # --- multi-process (multi-host) execution -------------------------------
    p.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed before running: every "
                        "process executes the same SPMD pipeline over the "
                        "global device mesh; only process 0 writes outputs. "
                        "On GPU hosts pass --coordinator, --num_processes "
                        "and --process_id (one process per host, or per "
                        "GPU)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (process 0's "
                        "host and a free port)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's id, 0 .. num_processes-1")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="force the JAX platform (e.g. 'cpu' for "
                        "virtual-mesh runs on a GPU host)")
    return p


def config_from_args(args) -> PipelineConfig:
    return PipelineConfig(
        plane=PlaneConfig(
            jma=args.jma, kma=args.kma, res=args.res,
            normal=(args.nx, args.ny, args.nz),
            origin=(args.ox, args.oy, args.oz),
            rot_deg=args.rot,
        ),
        filt=FilterConfig(
            length_scale_x=args.lengthscale,
            length_scale_y=args.lengthscale,
            length_scale_z=args.lengthscale,
            fwidth=args.fwidth,
        ),
        podfs=PODFSConfig(num_modes=args.nm, energy_target=args.et),
        nsteps=args.nsteps, dt=args.dt,
        mean_profile=args.mean_profile, turb_profile=args.turb_profile,
        bulk_velocity=args.bulk_velocity,
        turbulence_intensity=args.turbulence_intensity,
        inner_d=args.ring, profile_file=args.profilefile,
        massflow=args.mdot, density=args.den,
        non_dim=args.non_dim, hdf5=args.hdf5, verbose=args.verbose,
        test_gradients=args.test_gradients,
        outdir=args.outdir, seed=args.seed, dtype=args.dtype,
        shard_space=args.shard_space, shard_time=args.shard_time,
        halo_exchange=args.halo_exchange,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_block=args.checkpoint_block,
        streaming_block=args.streaming_block,
        gram_group=args.gram_group,
        streaming_cache=args.streaming_cache,
        eig_mode=args.eig_mode,
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        build_parser().parse_args(["--help"])
        return 0
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.hdf5:
        # fail before the run, not at export after it
        from pods_digital_filter_tpu.io.hdf5 import require_h5py

        require_h5py()

    # platform/distributed init must precede the first jax backend use
    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    if args.platform is not None:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        # without x64, jax silently downcasts float64 arrays AND the PRNG
        # draws different (32-bit) uniforms — a different realization, not
        # just lower precision
        import jax

        jax.config.update("jax_enable_x64", True)
    if args.multihost:
        from pods_digital_filter_tpu.parallel.mesh import init_distributed

        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id)

    from pods_digital_filter_tpu.pipeline import run_pipeline
    from pods_digital_filter_tpu.utils.timing import maybe_trace

    with maybe_trace(args.profile_dir):
        result = run_pipeline(cfg)

    print(f"\nPODFS model written to {cfg.outdir}/ "
          f"({result.pod.num_trunc} modes, period {result.fourier.period:.6g} s)")
    if args.timings:
        print(result.timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
