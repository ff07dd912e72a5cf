"""File formats: .prf headers/rows, PODFS.dat roundtrip, HDF5 layout
(order='F' flattening), plane geometry."""

import numpy as np
import pytest

from pods_digital_filter_tpu.config import PlaneConfig
from pods_digital_filter_tpu.io import hdf5 as hdf5_io
from pods_digital_filter_tpu.io import prf as prf_io
from pods_digital_filter_tpu.io.plane import make_inflow_plane
from pods_digital_filter_tpu.ops.fourier import fourier_compress


def test_fstr_format():
    assert prf_io.fstr(1.0) == "1.000000000000"
    assert prf_io.fstr(-0.5) == "-0.500000000000"


def test_plane_geometry_default_normal():
    cfg = PlaneConfig(jma=10, kma=11, res=0.1)
    geom = make_inflow_plane(cfg)
    cc = geom.cell_centers
    assert cc.shape == (110, 3)
    # plane lies in x=0 for default normal (1,0,0)
    np.testing.assert_allclose(cc[:, 0], 0.0, atol=1e-12)
    # VTK scaling: extent s2 = res*jma^2/(jma-1), cell spacing s2/jma.
    # Tolerances are FLOAT32 eps: the geometry reproduces the reference's
    # VTK float32 point-rounding chain bit-for-bit (io/plane.py,
    # tests/test_golden.py::test_mean_and_mode_prf_full_file_bytes_match),
    # so coordinates carry f32 quantization by design.
    s2 = 0.1 * 10 * 10 / 9
    s3 = 0.1 * 11 * 11 / 10
    # ordering p = j*kma + k: k varies fastest along z, j along y
    np.testing.assert_allclose(cc[1, 1] - cc[0, 1], 0.0, atol=1e-7)
    np.testing.assert_allclose(cc[0, 2] - cc[1, 2], s3 / 11, atol=1e-7)
    np.testing.assert_allclose(cc[11, 1] - cc[0, 1], s2 / 10, atol=1e-7)
    # symmetric about the origin
    np.testing.assert_allclose(cc[:, 1].max(), -cc[:, 1].min(), atol=1e-7)
    np.testing.assert_allclose(cc[:, 2].max(), -cc[:, 2].min(), atol=1e-7)


def test_plane_geometry_rotated_normal():
    n = (1.0, 1.0, 0.5)
    cfg = PlaneConfig(jma=6, kma=7, res=0.2, normal=n, origin=(1.0, 2.0, 3.0))
    geom = make_inflow_plane(cfg)
    cc = geom.cell_centers - np.asarray([1.0, 2.0, 3.0])
    nn = np.asarray(cfg.normal)
    # all cell centres lie in the plane through the origin with normal n
    # (f32 atol: coordinates carry the reference's VTK float32 rounding
    # chain by design — io/plane.py)
    np.testing.assert_allclose(cc @ nn, 0.0, atol=1e-6)
    # areas preserved under rotation
    areas = geom.cell_areas()
    s2 = 0.2 * 36 / 5
    s3 = 0.2 * 49 / 6
    np.testing.assert_allclose(areas, (s2 / 6) * (s3 / 7), rtol=1e-6)


def test_snapshot_prf_roundtrip(tmp_path):
    cfg = PlaneConfig(jma=3, kma=4, res=0.1)
    geom = make_inflow_plane(cfg)
    npts = 12
    u = np.arange(3 * npts, dtype=np.float64) * 0.1
    path = prf_io.write_snapshot_prf(str(tmp_path), 0.123, u, geom,
                                     cfg.normal, cfg.origin)
    assert path.endswith("1.23000E-01.prf")
    lines = open(path).read().splitlines()
    assert lines[0].startswith("# Generated using the digital filter method")
    assert lines[10] == "data,x,y,z,u,v,w"
    rows = np.array([[float(v) for v in l.split(",")] for l in lines[11:]])
    assert rows.shape == (npts, 6)
    np.testing.assert_allclose(rows[:, :3], geom.cell_centers, atol=1e-12)
    np.testing.assert_allclose(rows[:, 3], u[:npts], atol=1e-12)
    np.testing.assert_allclose(rows[:, 5], u[2 * npts:], atol=1e-12)


def test_podfs_dat_roundtrip(tmp_path, rng):
    ns, nm = 20, 3
    y = rng.standard_normal((ns, nm))
    fr = fourier_compress(y, nm, dt=0.05, energy_target=0.9)
    path = prf_io.write_podfs_dat(str(tmp_path), fr)
    period, modes = prf_io.read_podfs_dat(path)
    assert period == pytest.approx(1.0)
    assert len(modes) == nm
    for i in range(nm):
        assert modes[i].shape[0] == fr.counts[i]
        np.testing.assert_allclose(modes[i][:, 0], fr.wavenumbers(i))
        np.testing.assert_allclose(modes[i][:, 1], fr.kept_coeffs(i).real, rtol=1e-12)


def test_hdf5_layout(tmp_path, rng):
    np_pts, nm = 8, 2
    points = rng.standard_normal((np_pts, 3))
    mean = rng.standard_normal(3 * np_pts)
    modes = rng.standard_normal((3 * np_pts, nm))
    n_fc = np.array([2, 3])
    fc = rng.standard_normal((5, 3))
    path = hdf5_io.write_hdf5(str(tmp_path), nm, 0.7, n_fc, fc, points, mean, modes)

    import h5py
    with h5py.File(path) as f:
        assert f["main"].attrs["N_POD"] == nm
        assert f["main"].attrs["period"] == pytest.approx(0.7)
        raw_fc = np.asarray(f["main/FC"])
        # order='F' flatten: all k's first
        np.testing.assert_allclose(raw_fc[:5], fc[:, 0])
        raw_mean = np.asarray(f["main/mean"])
        # order='F': x coords of all points first
        np.testing.assert_allclose(raw_mean[:np_pts], points[:, 0])
        # then u = first third of the packed mean (mean reshaped order='F')
        np.testing.assert_allclose(raw_mean[3 * np_pts:4 * np_pts], mean[:np_pts])
        assert f["main/mean"].attrs["Vars"] == b"x,y,z,u,v,w,dummy"

    back = hdf5_io.read_hdf5(path)
    np.testing.assert_allclose(back["FC"], fc)
    np.testing.assert_allclose(back["modes"][1][:, 3], modes[:np_pts, 1])


def test_eigenvalues_file(tmp_path):
    energy = np.array([4.0, 2.0, 1.0, -0.5])
    path = prf_io.write_eigenvalues(str(tmp_path), 3, energy)
    rows = [l.split() for l in open(path) if not l.startswith("#")]
    assert len(rows) == 4
    assert float(rows[0][1]) == pytest.approx(4.0)
    assert float(rows[2][3]) == pytest.approx(1.0 / 7.0 * 100.0)
    # beyond valid modes: cumulative zeroed
    assert float(rows[3][2]) == 0.0


def test_temporal_modes_roundtrip(tmp_path, rng):
    tm = rng.standard_normal((10, 3))
    paths = prf_io.write_temporal_modes(str(tmp_path), 3, 0.1, tm)
    back = prf_io.read_temporal_modes(paths)
    np.testing.assert_allclose(back, tm, rtol=1e-9)


def test_hdf5_without_h5py_fails_before_the_run(monkeypatch, tmp_path):
    """-5 on a host without h5py stops at start-up with an error naming the
    missing package (None in sys.modules makes its import fail)."""
    import sys

    from pods_digital_filter_tpu import cli

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["-5", "-n", "4", "--outdir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
