"""Resumable generation checkpoints (utils/checkpoint.py)."""

import numpy as np
import pytest

from pods_digital_filter_tpu.config import (FilterConfig, PipelineConfig,
                                            PlaneConfig)
from pods_digital_filter_tpu.models import profiles as prof
from pods_digital_filter_tpu.pipeline import (generate_snapshot_matrix,
                                              resolve_profile)
from pods_digital_filter_tpu.utils import checkpoint as ckpt


def _tiny_cfg(tmp_path, nsteps=8):
    return PipelineConfig(
        plane=PlaneConfig(jma=6, kma=5, res=0.1),
        filt=FilterConfig(length_scale_x=1.0, length_scale_y=1.0,
                          length_scale_z=1.0, fwidth=2.0),
        nsteps=nsteps, outdir=str(tmp_path / "out"),
        checkpoint_dir=str(tmp_path / "ck"), dtype="float32",
    )


def test_blockwise_equals_full_generation(tmp_path):
    """Counter-indexed noise makes block generation exact: assembling
    [0,4) + [4,8) equals one [0,8) call bit-for-bit."""
    cfg = _tiny_cfg(tmp_path)
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)

    A_full = np.asarray(generate_snapshot_matrix(cfg, fields, filt,
                                                 rotate=rotate))
    A_ck = ckpt.generate_with_checkpoints(cfg, fields, filt,
                                          cfg.checkpoint_dir, block=4,
                                          rotate=rotate)
    np.testing.assert_array_equal(A_ck, A_full.astype(A_ck.dtype))


def test_resume_skips_completed_blocks(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)

    calls = []
    ckpt.generate_with_checkpoints(cfg, fields, filt, cfg.checkpoint_dir,
                                   block=4, rotate=rotate,
                                   progress=lambda t0, n: calls.append(t0))
    assert calls == [0, 4]

    calls2 = []
    A2 = ckpt.generate_with_checkpoints(cfg, fields, filt, cfg.checkpoint_dir,
                                        block=4, rotate=rotate,
                                        progress=lambda t0, n: calls2.append(t0))
    assert calls2 == []            # nothing regenerated
    assert A2.shape == (3 * 30, 8)


def test_partial_resume_regenerates_missing(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)
    fp = ckpt.generation_fingerprint(cfg, filt, fields, True)
    store = ckpt.GenerationCheckpoint(str(tmp_path / "ck"), fp, 8, 4)
    # simulate a killed run: only block 0 saved
    cols = np.asarray(generate_snapshot_matrix(cfg, fields, filt, t0=0,
                                               nsteps=4, rotate=rotate))
    store.save_block(0, cols)

    calls = []
    ckpt.generate_with_checkpoints(cfg, fields, filt, cfg.checkpoint_dir,
                                   block=4, rotate=rotate,
                                   progress=lambda t0, n: calls.append(t0))
    assert calls == [4]


def test_turbulence_change_invalidates(tmp_path):
    """Round-2 advisor (medium): the fingerprint must cover the resolved
    turbulence stress/mean fields — a rerun with a different --u_dash but
    identical plane/filter/seed must NOT reuse stale blocks."""
    import dataclasses

    cfg = _tiny_cfg(tmp_path)
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)
    A1 = ckpt.generate_with_checkpoints(cfg, fields, filt, cfg.checkpoint_dir,
                                        block=4, rotate=rotate)

    cfg2 = dataclasses.replace(_tiny_cfg(tmp_path), turbulence_intensity=0.10)
    fields2, dt2, filt2, cfg2, rotate2 = resolve_profile(cfg2)
    calls = []
    A2 = ckpt.generate_with_checkpoints(cfg2, fields2, filt2,
                                        cfg2.checkpoint_dir, block=4,
                                        rotate=rotate2,
                                        progress=lambda t0, n: calls.append(t0))
    assert calls == [0, 4]         # stale blocks not reused
    assert not np.allclose(A1, A2, atol=1e-6)


def test_config_change_invalidates(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)
    ckpt.generate_with_checkpoints(cfg, fields, filt, cfg.checkpoint_dir,
                                   block=4, rotate=rotate)
    import dataclasses
    cfg2 = dataclasses.replace(cfg, seed=99)
    calls = []
    ckpt.generate_with_checkpoints(cfg2, fields, filt, cfg.checkpoint_dir,
                                   block=4, rotate=rotate,
                                   progress=lambda t0, n: calls.append(t0))
    assert calls == [0, 4]         # different fingerprint -> regenerate all


# Fingerprints of this configuration as stores written before the fused
# generation kernel and its flag were removed recorded them; a store on disk
# from then must still resume.
_PRE_REMOVAL_FINGERPRINTS = {"generation": "8d36894d5bdb6685",
                             "gram": "e303940a6ace3614"}


@pytest.mark.parametrize("kind", sorted(_PRE_REMOVAL_FINGERPRINTS))
def test_fingerprint_of_older_stores_still_matches(tmp_path, kind):
    from pods_digital_filter_tpu.streaming import make_gram_store

    cfg = PipelineConfig(
        plane=PlaneConfig(jma=6, kma=8, res=0.1),
        filt=FilterConfig(1.0, 1.0, 1.0, 2.0), nsteps=12, seed=3,
        checkpoint_dir=str(tmp_path / "ck"))
    fields, dt, filt, cfg, rotate = resolve_profile(cfg)
    if kind == "generation":
        fp = ckpt.generation_fingerprint(cfg, filt, fields, rotate)
    else:
        fp = make_gram_store(cfg, filt, fields, rotate, 4).fingerprint
    assert fp == _PRE_REMOVAL_FINGERPRINTS[kind]
