#!/usr/bin/env python3
"""On-device smoke test of the main path on an NVIDIA GPU: generation ->
POD (in memory and out of core) -> PODFS export -> replay, each compared
with a plain reference at the published widths.

Usage (from the repository root):

    python chip_smoke.py           # one GPU: phases 1-4
    python chip_smoke.py --four    # four GPUs: the sharded paths only

Phases:

1. device: JAX must report a GPU; prints its kind, the device count and
   ``nvidia-smi``'s name and power limit;
2. generation parity: the XLA generator at 64x64 x 100 steps against the
   sequential rolling-buffer oracle (``tests/oracle.py``), max abs error
   <= 1e-5 on unit-variance fields;
3. in-memory POD through the CLI (256x128 plane, 1000 snapshots -> 50
   modes): the top-20 eigenvalues written to ``POD.eigenvalues.dat`` agree
   with host float64 ``eigh`` of the same snapshot matrix to <= 1e-4
   relative, and the written model replays (``replay.Replayer``) to
   <= 1e-5 of the field rms of the C evaluator (``native/podfs_replay.c``);
4. out-of-core POD at the flagship plane (1024x512), the step count cut:
   1024 steps streaming (block 256) against in-memory — top-20 spectrum
   <= 1e-4 relative, leading modes |cos| >= 0.999 where the eigenvalue gap
   exceeds 1 % — then 4096 steps streaming, written, complete eigenvalue
   file, replayed.  Stage timings and peak device memory are printed;
   they are smoke numbers, not benchmark numbers.

``--four`` runs only the sharded paths on four GPUs (1024x512 x 1024
steps, meshes (1,4) and (2,2)) against the one-device run in the same
process: exact sharded generation + distributed POD and sharded streaming
agree on the top-20 spectrum to <= 1e-4; the halo-exchange path meets the
statistical bounds of ``tests/test_sharding.py``.

Any phase outside its bound exits non-zero.  So does a run on which JAX
finds no GPU, with a message naming the platform it found.  The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GEN_TOL = 1e-5           # phase 2: max abs error, unit-variance fields
SPECTRUM_TOL = 1e-4      # relative error of the top-20 eigenvalues
REPLAY_TOL = 1e-5        # replay error as a fraction of the field rms
MODE_COS = 0.999         # |cos| of leading modes with an eigenvalue gap
MODE_GAP = 0.01          # ... above 1 %
TOP = 20


def check(label: str, value: float, limit: float, *, at_least=False):
    """Print one measured value beside its bound; exit 1 when it misses."""
    ok = value >= limit if at_least else value <= limit
    rel = ">=" if at_least else "<="
    print(f"{label}: {value:.6g} (bound {rel} {limit:g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {label} outside its bound")


def require_gpu():
    """Phase 1.  Returns the device list; exits 1 unless JAX sees a GPU."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: JAX found no usable backend ({e})")
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, but JAX found platform "
                         f"{platform!r} ({devices[0].device_kind})")
    print(f"phase 1 device: kind={devices[0].device_kind} "
          f"count={len(devices)}", flush=True)
    return devices


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per line,
    read by a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def config(argv):
    """A PipelineConfig exactly as the CLI builds it from ``argv``."""
    from pods_digital_filter_tpu import cli

    return cli.config_from_args(cli.build_parser().parse_args(argv))


def top_rel_err(e, e_ref, top=TOP):
    e, e_ref = np.asarray(e[:top]), np.asarray(e_ref[:top])
    return float(np.max(np.abs(e - e_ref) / np.abs(e_ref)))


def read_eigenvalue_file(path: str) -> np.ndarray:
    rows = [ln.split() for ln in open(path) if not ln.startswith("#")]
    return np.array([float(r[1]) for r in rows if r])


def host_spectrum(cfg) -> np.ndarray:
    """Descending eigenvalues of ``(A-m)^T (A-m) / Ns``, host float64, for
    the snapshot matrix the pipeline generates from ``cfg``."""
    from pods_digital_filter_tpu import pipeline

    fields, _, filt, cfg, rotate = pipeline.resolve_profile(cfg)
    A = np.asarray(pipeline.generate_snapshot_matrix(
        cfg, fields, filt, rotate=rotate), dtype=np.float64)
    A -= A.mean(axis=1, keepdims=True)
    C = A.T @ A / A.shape[1]
    return np.linalg.eigvalsh(C)[::-1]


def replay_error(model_dir: str, num_times: int = 16) -> float:
    """max |Replayer - C evaluator| over ``num_times`` times in one period,
    as a fraction of the C evaluator's field rms."""
    from pods_digital_filter_tpu import native, replay

    rp = replay.Replayer(replay.load_prf(model_dir))
    ts = np.linspace(0.0, rp.model.period, num_times, endpoint=False)
    u_jax = rp.batch(ts)
    with native.NativePODFSReplayer(model_dir) as nat:
        u_c = nat.eval_batch(ts)
    if not np.isfinite(u_jax).all():
        raise SystemExit("chip_smoke: replayed field is not finite")
    return float(np.max(np.abs(u_jax - u_c)) / np.sqrt(np.mean(u_c ** 2)))


def phase_generation(jma=64, kma=64, nsteps=100, lengthscale=3.0,
                     fwidth=2.0, seed=0) -> float:
    """Phase 2: the XLA generator against the sequential oracle on the
    very same Threefry noise."""
    import jax

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    from pods_digital_filter_tpu.config import FilterConfig
    from pods_digital_filter_tpu.ops import filters

    f = FilterConfig(lengthscale, lengthscale, lengthscale, fwidth)
    nf, ln = f.nfx, lengthscale
    key = jax.random.key(seed)
    y = np.asarray(filters.generate_correlated_noise(
        key, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln))
    raw = np.asarray(filters.noise_slabs(
        key, 0, nsteps + 2 * nf, jma + 2 * nf, kma + 2 * nf, 3),
        dtype=np.float64)
    b = oracle.gaussian_coeffs(nf, ln)
    ref = np.stack([oracle.sequential_filter(raw[c], b, b, b, jma, kma)
                    for c in range(3)])
    err = float(np.max(np.abs(y - ref)))
    check(f"phase 2 generation {jma}x{kma}x{nsteps} max abs error vs "
          f"oracle", err, GEN_TOL)
    return err


def phase_in_memory_pod(workdir, jma=256, kma=128, nsteps=1000, modes=50):
    """Phase 3: the CLI's in-memory POD and its written model."""
    from pods_digital_filter_tpu import cli

    outdir = os.path.join(workdir, "in_memory")
    argv = ["-j", str(jma), "-k", str(kma), "-n", str(nsteps),
            "-m", str(modes), "--outdir", outdir, "--timings"]
    rc = cli.main(argv)
    if rc != 0:
        raise SystemExit(f"chip_smoke: CLI exited {rc}")
    e_file = read_eigenvalue_file(os.path.join(outdir,
                                               "POD.eigenvalues.dat"))
    e_ref = host_spectrum(config(argv))
    check(f"phase 3 in-memory POD {jma}x{kma}x{nsteps} top-{TOP} "
          f"eigenvalue rel error vs host f64 eigh",
          top_rel_err(e_file, e_ref), SPECTRUM_TOL)
    check("phase 3 replay vs C evaluator, fraction of field rms",
          replay_error(outdir), REPLAY_TOL)


def mode_cosines(phi, phi_ref, energy, top=TOP):
    """|cos| between matching spatial modes, for the leading modes whose
    eigenvalue is separated from both neighbours by more than MODE_GAP."""
    cos = []
    for i in range(min(top, phi.shape[1], phi_ref.shape[1])):
        gaps = [abs(energy[i] - energy[j]) / energy[i]
                for j in (i - 1, i + 1) if 0 <= j < len(energy)]
        if min(gaps) > MODE_GAP:
            a, b = phi[:, i], phi_ref[:, i]
            cos.append(abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return cos


def report_timings(label, result, card):
    import jax

    for stage, sec in result.timer.times.items():
        print(f"timing [{card}] {label}: {stage} {sec:.3f} s")
    stats = jax.local_devices()[0].memory_stats() or {}
    print(f"memory [{card}] {label}: peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use')} (process peak so far)",
          flush=True)


def phase_out_of_core(workdir, card, jma=1024, kma=512, nsteps=1024,
                      long_nsteps=4096, block=256):
    """Phase 4: streaming against in-memory at the flagship plane width,
    then a longer streaming run that writes and replays its model."""
    import dataclasses

    from pods_digital_filter_tpu.pipeline import run_pipeline

    base = ["-j", str(jma), "-k", str(kma), "-n", str(nsteps), "-m",
            str(TOP)]
    mem = run_pipeline(config(base), write_outputs=False)
    report_timings(f"in-memory {jma}x{kma}x{nsteps}", mem, card)
    mem.A = None                                  # free the host copy
    cfg_s = dataclasses.replace(config(base), streaming_block=block)
    st = run_pipeline(cfg_s, write_outputs=False)
    report_timings(f"streaming {jma}x{kma}x{nsteps}", st, card)
    check(f"phase 4 streaming vs in-memory {jma}x{kma}x{nsteps} top-{TOP} "
          f"eigenvalue rel error",
          top_rel_err(st.pod.energy, mem.pod.energy), SPECTRUM_TOL)
    cos = mode_cosines(st.pod.spatial_modes, mem.pod.spatial_modes,
                       mem.pod.energy)
    print(f"phase 4 modes with an eigenvalue gap > {MODE_GAP:.0%}: "
          f"{len(cos)} of the leading {TOP}")
    if cos:
        check("phase 4 min |cos| of gapped leading modes", min(cos),
              MODE_COS, at_least=True)

    outdir = os.path.join(workdir, "streaming_long")
    cfg_l = config(["-j", str(jma), "-k", str(kma), "-n", str(long_nsteps),
                    "-m", str(TOP), "--outdir", outdir,
                    "--streaming_block", str(block)])
    long = run_pipeline(cfg_l)
    report_timings(f"streaming {jma}x{kma}x{long_nsteps}", long, card)
    e_file = read_eigenvalue_file(os.path.join(outdir,
                                               "POD.eigenvalues.dat"))
    if e_file.shape[0] != long_nsteps or not np.isfinite(e_file).all():
        raise SystemExit(f"chip_smoke: eigenvalue file holds "
                         f"{e_file.shape[0]} values, expected {long_nsteps}")
    print(f"phase 4 eigenvalue file complete: {e_file.shape[0]} values, "
          f"{long.pod.num_trunc} modes written")
    check(f"phase 4 streaming {long_nsteps} replay vs C evaluator, "
          f"fraction of field rms", replay_error(outdir), REPLAY_TOL)


def halo_statistics(mesh, jma, kma, nsteps, lengthscale=3.0, fwidth=2.0):
    """The bounds of tests/test_sharding.py::test_sharded_halo_statistics
    on the halo-exchange generator at full width: unit variance, and the
    adjacent-z correlation across each tile boundary equal to the taps'
    closed form."""
    import jax

    from pods_digital_filter_tpu.config import FilterConfig
    from pods_digital_filter_tpu.ops import filters
    from pods_digital_filter_tpu.parallel import sharding

    f = FilterConfig(lengthscale, lengthscale, lengthscale, fwidth)
    nf, ln = f.nfx, lengthscale
    y = np.asarray(sharding.generate_sharded_halo(
        jax.random.key(10), mesh, 0, nsteps, jma, kma, nf, nf, nf,
        ln, ln, ln, num_components=1))[0]
    b = np.asarray(filters.gaussian_fir_coeffs(nf, ln, np.float32),
                   dtype=np.float64)
    want = float(np.sum(b[:-1] * b[1:]))
    tile = kma // mesh.shape["s"]
    edges = [i * tile for i in range(1, mesh.shape["s"])]
    got = max(abs(np.mean(y[:, :, k - 1] * y[:, :, k]) / y.var() - want)
              for k in edges)
    return abs(float(y.var()) - 1.0), got


def phase_four(card, jma=1024, kma=512, nsteps=1024, block=256):
    """``--four``: the sharded paths against the one-device run."""
    import dataclasses

    import jax

    from pods_digital_filter_tpu.parallel import mesh as mesh_lib
    from pods_digital_filter_tpu.pipeline import run_pipeline

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 devices, JAX found "
                         f"{len(devices)}")
    base = config(["-j", str(jma), "-k", str(kma), "-n", str(nsteps),
                   "-m", str(TOP)])
    one = run_pipeline(base, write_outputs=False)
    one.A = None
    report_timings(f"one device {jma}x{kma}x{nsteps}", one, card)
    for t, s in ((1, 4), (2, 2)):
        mesh = mesh_lib.make_mesh(t, s)
        placed = sorted(d.id for d in mesh.devices.flat)
        if placed != sorted(d.id for d in devices[:4]):
            raise SystemExit(f"chip_smoke --four: mesh ({t},{s}) holds "
                             f"devices {placed}")
        for label, kw in (("exact", {}),
                          ("streaming", {"streaming_block": block})):
            r = run_pipeline(dataclasses.replace(
                base, shard_time=t, shard_space=s, **kw),
                write_outputs=False)
            report_timings(f"sharded {label} mesh ({t},{s})", r, card)
            check(f"four: sharded {label} mesh ({t},{s}) top-{TOP} "
                  f"eigenvalue rel error vs one device",
                  top_rel_err(r.pod.energy, one.pod.energy), SPECTRUM_TOL)
        var_err, corr_err = halo_statistics(mesh, jma, kma, nsteps)
        check(f"four: halo mesh ({t},{s}) |var - 1|", var_err, 0.15)
        check(f"four: halo mesh ({t},{s}) tile-boundary correlation error",
              corr_err, 0.12)
    # every card of the mesh held shards: each one's peak use grew
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devices[:4]]
    print(f"four: peak_bytes_in_use per device {peaks}")
    if min(peaks[1:]) <= 0:
        raise SystemExit("chip_smoke --four: devices 1-3 held no arrays")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    devices = require_gpu()
    card_lines = card_name_and_power()
    print(f"nvidia-smi: {card_lines}", flush=True)
    card = card_lines.splitlines()[0]

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as workdir:
        if args.four:
            phase_four(card)
        else:
            phase_generation()
            phase_in_memory_pod(workdir)
            phase_out_of_core(workdir, card)

    print(card_lines)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
