"""Native fastio writer: byte parity with the Python "%0.12f" formatter."""

import numpy as np
import pytest

from pods_digital_filter_tpu import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C compiler available")


def _python_rows(rows, sep=","):
    return "".join(sep.join("%0.12f" % v for v in r) + "\n" for r in rows)


def test_fixed12_byte_parity_random(tmp_path):
    rng = np.random.RandomState(0)
    rows = np.concatenate([
        rng.randn(500, 6),
        rng.randn(100, 6) * 1e4,
        rng.randn(100, 6) * 1e-8,
    ])
    path = str(tmp_path / "t.prf")
    assert native.write_rows_fixed12(path, "w", rows)
    with open(path) as f:
        got = f.read()
    assert got == _python_rows(rows)


def test_fixed12_edge_values(tmp_path):
    rows = np.array([
        [0.0, -0.0, 1.0, -1.0, 0.5, -0.5],
        [1e-13, -1e-13, 123456.789, -123456.789, 9.1e6, -9.1e6],
        [1e12, -1e12, np.inf, -np.inf, 3.999999999999, 1.0000000000005],
    ])
    path = str(tmp_path / "e.prf")
    assert native.write_rows_fixed12(path, "w", rows)
    with open(path) as f:
        got = f.read().splitlines()
    exp = _python_rows(rows).splitlines()
    # every finite value must round-trip to the same 12-decimal string
    for g, e in zip(got, exp):
        for gv, ev in zip(g.split(","), e.split(",")):
            if "inf" in ev or "nan" in ev:
                assert gv == ev
            else:
                assert abs(float(gv) - float(ev)) <= 1.01e-12, (gv, ev)


def test_append_mode(tmp_path):
    path = str(tmp_path / "a.prf")
    with open(path, "w") as f:
        f.write("# header\n")
    rows = np.ones((3, 2))
    assert native.write_rows_fixed12(path, "a", rows)
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "# header"
    assert lines[1] == "1.000000000000,1.000000000000"
    assert len(lines) == 4


def test_prf_writer_uses_native(tmp_path):
    """End to end through write_snapshot_prf: identical output whether or not
    the native path is taken (parity against a hand-built expectation)."""
    from pods_digital_filter_tpu.config import PlaneConfig
    from pods_digital_filter_tpu.io import prf as prf_io
    from pods_digital_filter_tpu.io.plane import make_inflow_plane

    geom = make_inflow_plane(PlaneConfig(jma=3, kma=4, res=0.1))
    packed = np.arange(3 * 12, dtype=np.float64) * 0.1
    path = prf_io.write_snapshot_prf(str(tmp_path), 0.5, packed, geom,
                                     (1.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 11 + 12
    first = lines[11].split(",")
    assert len(first) == 6
    np.testing.assert_allclose(float(first[3]), 0.0, atol=1e-12)   # u[0]
    np.testing.assert_allclose(float(first[4]), 1.2, atol=1e-12)   # v[0]


def test_g17_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    rows = rng.randn(50, 3) * 10.0 ** rng.randint(-300, 300, (50, 3))
    path = str(tmp_path / "g.dat")
    assert native.write_rows_g17(path, "w", rows)
    back = np.loadtxt(path)
    np.testing.assert_array_equal(back, rows)   # %.17g round-trips exactly


def test_solver_stub_links_and_runs(tmp_path):
    """examples/solver_inlet_stub.c — the documented solver integration —
    compiles against podfs_replay.h, links libpodfs_replay.so, and replays
    a freshly generated model (link-level test of the public C API)."""
    import os
    import shutil
    import subprocess

    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")

    from pods_digital_filter_tpu.config import (
        FilterConfig, PipelineConfig, PlaneConfig, PODFSConfig)
    from pods_digital_filter_tpu.pipeline import run_pipeline

    outdir = str(tmp_path / "PODFS")
    run_pipeline(PipelineConfig(
        plane=PlaneConfig(jma=6, kma=5, res=0.1),
        filt=FilterConfig(length_scale_x=1.5, length_scale_y=1.5,
                          length_scale_z=1.5, fwidth=2.0),
        podfs=PODFSConfig(num_modes=3, energy_target=0.9),
        nsteps=6, outdir=outdir, dtype="float64"))

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ndir = os.path.join(repo, "pods_digital_filter_tpu", "native")
    lib = str(tmp_path / "libpodfs_replay.so")
    exe = str(tmp_path / "solver_stub")
    subprocess.run([cc, "-O2", "-shared", "-fPIC",
                    os.path.join(ndir, "podfs_replay.c"), "-o", lib, "-lm"],
                   check=True, capture_output=True, timeout=120)
    subprocess.run([cc, "-O2", os.path.join(repo, "examples",
                                            "solver_inlet_stub.c"),
                    "-o", exe, "-I", ndir, "-L", str(tmp_path),
                    "-lpodfs_replay", "-lm",
                    f"-Wl,-rpath,{tmp_path}"],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([exe, outdir, "5"], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "OK np=30 nvars=3 nm=3" in out.stdout
    assert out.stdout.count("step ") == 5


def test_library_name_follows_source_contents(tmp_path):
    """A library built from other sources is never reused: its file name
    carries a hash of the C source it was built from."""
    src = tmp_path / "x.c"
    src.write_text("int f(void) { return 1; }\n")
    first = native.library_name(str(src), "libx.so")
    assert first.startswith("libx-") and first.endswith(".so")
    assert native.library_name(str(src), "libx.so") == first
    src.write_text("int f(void) { return 2; }\n")
    assert native.library_name(str(src), "libx.so") != first
