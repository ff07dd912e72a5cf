"""End-to-end pipeline: the reference's minimum working example
(``python digitalfilters.py -n 5``, quickstart.rst:44-54) and the PODFS
replay-equation consistency check."""

import os

import numpy as np
import pytest

from pods_digital_filter_tpu.config import (
    FilterConfig, PipelineConfig, PlaneConfig, PODFSConfig,
)
from pods_digital_filter_tpu.io import hdf5 as hdf5_io
from pods_digital_filter_tpu.io import prf as prf_io
from pods_digital_filter_tpu.pipeline import run_pipeline


def small_config(tmp_path, **kw):
    defaults = dict(
        plane=PlaneConfig(jma=10, kma=11, res=0.1),
        filt=FilterConfig(length_scale_x=2.0, length_scale_y=2.0,
                          length_scale_z=2.0, fwidth=2.0),
        podfs=PODFSConfig(num_modes=5, energy_target=0.9),
        nsteps=8, outdir=str(tmp_path / "PODFS"), dtype="float64",
        hdf5=True, verbose=True,
    )
    defaults.update(kw)
    return PipelineConfig(**defaults)


def test_mwe_end_to_end(tmp_path):
    cfg = small_config(tmp_path)
    res = run_pipeline(cfg)

    out = cfg.outdir
    assert os.path.exists(os.path.join(out, "PODFS.dat"))
    assert os.path.exists(os.path.join(out, "PODFS_mean.prf"))
    assert os.path.exists(os.path.join(out, "POD.eigenvalues.dat"))
    assert os.path.exists(os.path.join(out, "PODFS.hdf5"))
    for i in range(res.pod.num_trunc):
        assert os.path.exists(os.path.join(out, "PODFS_mode_%4.4i.prf" % (i + 1)))
    # verbose: per-snapshot profiles + temporal modes
    assert os.path.exists(os.path.join(out, "0.00000E+00.prf"))
    assert os.path.exists(os.path.join(out, "POD.temporal_mode_0001.dat"))

    # dt auto-calc: res / mean(U over nonzero points)
    assert res.dt > 0

    # POD energies positive and descending over valid range
    e = res.pod.energy[: res.pod.num_valid]
    assert np.all(np.diff(e) <= 1e-12)
    assert np.all(e > 0)


def test_podfs_replay_consistency(tmp_path):
    """Evaluate the PODFS replay equation
    (docs/usage/CFDCodeIntegration.rst:85-91) from the written artifacts and
    compare against the generated snapshots: with et=1 (all Fourier
    coefficients kept) the reconstruction over the first num_modes modes must
    equal the mean + truncated POD reconstruction."""
    cfg = small_config(tmp_path, podfs=PODFSConfig(num_modes=6, energy_target=1.0),
                       nsteps=12)
    res = run_pipeline(cfg)
    out = cfg.outdir

    period, modes_fc = prf_io.read_podfs_dat(os.path.join(out, "PODFS.dat"))
    h = hdf5_io.read_hdf5(os.path.join(out, "PODFS.hdf5"))
    npts = h["Np"]
    nm = h["N_POD"]
    ns = cfg.nsteps
    dt = res.dt

    # replay: U(x, t) = mean(x) + sum_i phi_i(x) * sum_j b_ij exp(2i pi k_j t / period)
    t = np.arange(ns) * dt
    recon = np.tile(h["mean"][:, 3:6].reshape(-1, order="F")[:, None], (1, ns)).astype(np.complex128)
    for i in range(nm):
        phi = h["modes"][i][:, 3:6].reshape(-1, order="F")
        fc = modes_fc[i]
        a_t = np.zeros(ns, dtype=np.complex128)
        for k, re, im in fc:
            a_t += (re + 1j * im) * np.exp(2j * np.pi * k * t / period)
        recon += phi[:, None] * a_t[None, :]

    # mean + truncated POD reconstruction of the snapshots
    want = res.mean_field[:, None] + res.pod.spatial_modes @ res.pod.temporal_modes[:, :nm].T
    np.testing.assert_allclose(recon.real, want, atol=1e-7)
    np.testing.assert_allclose(recon.imag, 0.0, atol=1e-7)

    # with all valid modes kept this equals the snapshots themselves
    if nm == res.pod.num_valid:
        A_orig = res.mean_field[:, None] + res.A
        np.testing.assert_allclose(recon.real, A_orig, atol=1e-6)


def test_shaped_profiles_run(tmp_path):
    for shape in ("double-hyperbolic-tangent", "circular-hyperbolic-tangent",
                  "ring-hyperbolic-tangent"):
        cfg = small_config(tmp_path, mean_profile=shape, nsteps=5,
                           outdir=str(tmp_path / shape), verbose=False, hdf5=False)
        res = run_pipeline(cfg)
        assert np.isfinite(res.A).all()


def test_turb_profile_none(tmp_path):
    cfg = small_config(tmp_path, turb_profile="none", nsteps=5,
                       verbose=False, hdf5=False)
    res = run_pipeline(cfg)
    # zero turbulence: every snapshot equals the (rotated) mean profile
    assert np.allclose(res.A, 0.0, atol=1e-12)


def test_rotated_plane(tmp_path):
    cfg = small_config(tmp_path, nsteps=5, verbose=False, hdf5=False,
                       plane=PlaneConfig(jma=8, kma=9, res=0.1,
                                         normal=(1.0, 1.0, 0.0)))
    res = run_pipeline(cfg)
    assert np.isfinite(res.A).all()
    # mean velocity should point along the normal direction on average
    npts = cfg.plane.num_points
    mean_u = res.mean_field[:npts].mean()
    mean_v = res.mean_field[npts:2 * npts].mean()
    assert mean_u == pytest.approx(mean_v, rel=0.05)


def test_cli_smoke(tmp_path, monkeypatch):
    from pods_digital_filter_tpu import cli

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-n", "5", "-m", "4", "-j", "8", "-k", "9",
                   "--dtype", "float32", "--outdir", str(tmp_path / "PODFS")])
    assert rc == 0
    assert os.path.exists(tmp_path / "PODFS" / "PODFS.dat")


def test_reynolds_stress_statistical_parity(tmp_path):
    """The full chain (noise -> filter -> Lund) must reproduce the target
    Reynolds stresses within ensemble SNR — the statistical-equivalence
    criterion of SURVEY.md §7 (the reference validates the same physics via
    its Lund construction, digitalfilters.py:143-178)."""
    from pods_digital_filter_tpu.models import profiles as prof
    from pods_digital_filter_tpu.pipeline import (generate_snapshot_matrix,
                                                  resolve_profile)

    cfg = small_config(
        tmp_path,
        plane=PlaneConfig(jma=48, kma=33, res=0.1),
        filt=FilterConfig(length_scale_x=1.5, length_scale_y=1.5,
                          length_scale_z=1.5, fwidth=2.0),
        nsteps=192, turbulence_intensity=0.1, verbose=False, hdf5=False,
        dtype="float32",
    )
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)
    A = np.asarray(generate_snapshot_matrix(cfg, fields, filt, rotate=False))
    npts = cfg.plane.num_points
    jma, kma = cfg.plane.jma, cfg.plane.kma

    u = A[:npts].reshape(jma, kma, -1)
    U_target = np.broadcast_to(np.asarray(fields.mean_u), (jma, kma))[0]
    uu_target = np.broadcast_to(np.asarray(fields.uu), (jma, kma))[0]
    # mean profile: reproduced everywhere
    U_mean = u.mean(axis=(0, 2))
    np.testing.assert_allclose(U_mean, U_target, atol=0.08)
    # Reynolds stress at the jet core (k = kma//2): target (TI*U0)^2 = 0.01
    core = slice(kma // 2 - 3, kma // 2 + 4)
    uu_meas = u[:, core, :].var()
    uu_tgt = float(np.mean(uu_target[core]))
    assert abs(uu_meas - uu_tgt) < 0.25 * uu_tgt, (uu_meas, uu_tgt)
    # shear stress uw is zero for this profile
    w = A[2 * npts:].reshape(jma, kma, -1)
    uw = ((u - u.mean(axis=2, keepdims=True))
          * (w - w.mean(axis=2, keepdims=True))).mean(axis=2)
    # per-point estimate is noisy (~uu/sqrt(Ns)); the field-mean must vanish
    assert abs(uw[:, core].mean()) < 0.05 * uu_tgt
    assert np.abs(uw[:, core]).max() < 0.5 * uu_tgt


def test_two_point_correlation_length_scale(tmp_path):
    """Two-point correlation in z follows the Gaussian tap autocorrelation
    with the prescribed length scale (SURVEY.md §4 closed-form property)."""
    import jax.numpy as jnp

    from pods_digital_filter_tpu.ops import filters

    nf, ln = 4, 2.0
    y = np.asarray(filters.generate_correlated_noise(
        __import__("jax").random.key(5), 0, 96, 48, 64, nf, nf, nf,
        ln, ln, ln, num_components=1, dtype=jnp.float32))[0]
    b = np.asarray(filters.gaussian_fir_coeffs(nf, ln, jnp.float32))
    for sep in (1, 2, 3):
        expected = float((b[:-sep] * b[sep:]).sum())
        meas = (y[..., :-sep] * y[..., sep:]).mean() / y.var()
        assert abs(meas - expected) < 0.06, (sep, meas, expected)


@pytest.mark.parametrize("argv", [
    ["--platform", "rocm"], ["--platform", "metal"], ["--pallas"]])
def test_cli_rejects_removed_options(argv, capsys):
    from pods_digital_filter_tpu import cli

    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(argv)
    assert e.value.code == 2
    assert argv[-1] in capsys.readouterr().err


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cli_platform_choices(platform):
    from pods_digital_filter_tpu import cli

    parser = cli.build_parser()
    assert parser.parse_args(["--platform", platform]).platform == platform
    choices = next(a.choices for a in parser._actions
                   if a.dest == "platform")
    assert choices == ["cpu", "gpu"]
