"""BASELINE #5 at TRUE size on one chip: 1024x512 plane x 10,000 steps,
out-of-core streaming POD (round-2 verdict next-step #1).

Runs the real pipeline end to end (generation -> streamed mean/Gram ->
10k x 10k host eigh -> projection -> Fourier -> .prf model export), records
per-stage wall time and device peak memory, and replay-verifies the
written model.  The snapshot matrix (3*Np x Ns = 1.57M x 10k ~ 63 GB in
f32) never exists anywhere — each block is regenerated from the
counter-indexed noise stream.

Prints ONE JSON line with the stage table.

Usage:
  python benchmarks/bench_flagship.py                 # the flagship run
  python benchmarks/bench_flagship.py --crossover     # gram_group /
        streaming_cache crossover table at a reduced size (for docs)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pods_digital_filter_tpu.config import (  # noqa: E402
    FilterConfig, PipelineConfig, PlaneConfig, PODFSConfig)


def device_peak_bytes():
    """Measured peak device memory, or None when the backend cannot report
    it (the analytic ``gram_pass_hbm_estimate`` is reported alongside)."""
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats is None:
            return None
        peak = stats.get("peak_bytes_in_use")
        return int(peak) if peak else None
    except Exception:
        return None


def flagship(outdir: str, nsteps: int, gram_group: int,
             block: int = 128, num_modes: int = 20):
    from pods_digital_filter_tpu import replay
    from pods_digital_filter_tpu.pipeline import run_pipeline

    cfg = PipelineConfig(
        plane=PlaneConfig(jma=1024, kma=512, res=0.001),
        filt=FilterConfig(length_scale_x=4.0, length_scale_y=4.0,
                          length_scale_z=4.0, fwidth=2.0),
        podfs=PODFSConfig(num_modes=num_modes, energy_target=0.9),
        nsteps=nsteps, outdir=outdir, dtype="float32",
        streaming_block=block, gram_group=gram_group,
    )
    # One throwaway generator execution before the clock starts, so that
    # compilation and device warm-up of the first execution are reported
    # separately and the stage table measures the pipeline.
    from pods_digital_filter_tpu.pipeline import make_generator, resolve_profile
    fields_w, _dt_w, filt_w, cfg_w, rotate_w = resolve_profile(cfg)
    t0 = time.perf_counter()
    gen_w = make_generator(cfg_w, fields_w, filt_w,
                           nsteps=cfg.streaming_block, rotate=rotate_w)
    np.asarray(gen_w(0)[0, :1])
    warmup_s = time.perf_counter() - t0

    # round-5 structure: the device block-Lanczos eigen half is
    # synchronous, so run_pipeline normally returns with the model fully
    # written (finalize() a no-op; `value` = that wall).  On the
    # checkpoint-resume/host-fallback path a deferred spectrum thread may
    # still be running — finalize() joins it and writes the eigenvalue
    # file, inside the timed window (model completeness is the metric).
    # The replay verification runs AFTER the clock stops and is reported
    # separately.
    t0 = time.perf_counter()
    res = run_pipeline(cfg, write_outputs=True, defer_finalize=True)
    pipeline_return_s = time.perf_counter() - t0
    tf = time.perf_counter()
    res.finalize()
    finalize_s = time.perf_counter() - tf
    total = time.perf_counter() - t0

    tv = time.perf_counter()
    model = replay.load_prf(outdir)
    rp = replay.Replayer(model)
    ts = np.array([0.0, model.period / 3, 2 * model.period / 3])
    fields = rp.batch(ts)
    verify_s = time.perf_counter() - tv
    assert np.isfinite(fields).all()
    fluct = fields - np.mean(fields, axis=0, keepdims=True)
    peak = device_peak_bytes()

    from pods_digital_filter_tpu import streaming as streaming_mod
    hbm_est = streaming_mod.gram_pass_hbm_estimate(
        3 * cfg.plane.jma * cfg.plane.kma, cfg.streaming_block, gram_group,
        4, 8, nsteps)

    stages = {k: round(v, 3) for k, v in res.timer.times.items()}
    return {
        "metric": "flagship BASELINE#5 wall-time (1024x512 x "
                  f"{nsteps} steps, streaming block {cfg.streaming_block}, "
                  f"group {gram_group})",
        "value": round(total, 2),
        "unit": "s",
        "detail": {
            "stages_s": stages,
            "device_warmup_s": round(warmup_s, 2),
            "nsteps": nsteps,
            "num_valid_modes": int(res.pod.num_valid),
            "num_trunc": int(res.pod.num_trunc),
            "device_peak_bytes": peak,        # None: backend cannot report
            "gram_hbm_estimate_gib": round(hbm_est / 2 ** 30, 3),
            "model_files": len(res.files),
            "pipeline_return_s": round(pipeline_return_s, 2),
            "finalize_s": round(finalize_s, 2),
            "replay_verify_s": round(verify_s, 2),
            "replay_fluct_rms": float(np.sqrt(np.mean(fluct ** 2))),
            "energy_top1_frac": float(res.pod.energy[0]
                                      / res.pod.energy[: res.pod.num_valid]
                                      .sum()),
        },
    }


def crossover(nsteps: int = 2048):
    """gram_group / streaming_cache crossover at a reduced size (512x256 x
    nsteps, block 256 -> B=8): measures ONLY the Gram pass."""
    from pods_digital_filter_tpu import streaming
    from pods_digital_filter_tpu.pipeline import make_generator, resolve_profile

    base = PipelineConfig(
        plane=PlaneConfig(jma=512, kma=256, res=0.001),
        filt=FilterConfig(length_scale_x=4.0, length_scale_y=4.0,
                          length_scale_z=4.0, fwidth=2.0),
        podfs=PODFSConfig(num_modes=10, energy_target=0.9),
        nsteps=nsteps, outdir="flagship_xover", dtype="float32",
        streaming_block=256,
    )
    fields, dt, filt, cfg, rotate = resolve_profile(base)
    block, ns = 256, cfg.nsteps

    import dataclasses

    import jax.numpy as jnp

    rows = []
    for variant in ({"gram_group": 1}, {"gram_group": 2}, {"gram_group": 4},
                    {"streaming_cache": "ram"}, {"streaming_cache": "disk"}):
        c = dataclasses.replace(cfg, **variant)
        gen_block = make_generator(c, fields, filt, nsteps=block,
                                   rotate=rotate)

        def gen(t0):
            A = gen_block(t0)
            n = min(block, ns - t0)
            return A[:, :n] if n < block else A

        cached_raw_gen = None
        if c.streaming_cache != "none":
            gen = streaming.HostBlockCache(c.streaming_cache).wrap(gen)
            cached_raw_gen = gen
        # mean (not timed; warms the compile and populates the cache)
        s = None
        for t0 in range(0, ns, block):
            cs = jnp.sum(gen(t0), axis=1)
            s = cs if s is None else s + cs
        m = (s / ns).block_until_ready()
        gen_c = streaming.make_centered_generator(
            c, fields, filt, block, ns, rotate, m,
            cached_raw_gen=cached_raw_gen)
        # two timed passes: the FIRST may absorb compiles of this
        # variant's executables; the SECOND is the warm schedule cost,
        # which is the number the table is for
        t0 = time.perf_counter()
        streaming.streamed_gram(gen_c, ns, block, streaming._pair_products,
                                group=c.gram_group)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        streaming.streamed_gram(gen_c, ns, block, streaming._pair_products,
                                group=c.gram_group)
        warm = time.perf_counter() - t0
        rows.append({**variant, "gram_s": round(warm, 2),
                     "first_pass_incl_compiles_s": round(cold, 2)})
    return {"metric": "gram-pass crossover, warm (512x256 x %d, block 256, "
                      "B=8)" % nsteps,
            "value": rows[0]["gram_s"], "unit": "s",
            "detail": {
                "variants": rows,
                "note": "gram_s is the second (warm) pass; "
                        "first_pass_incl_compiles_s absorbed any "
                        "compiles + host-cache population for the variant",
            }}


def main():
    # persistent compile cache: repeated runs with identical shapes must
    # not compile again.  Pick nsteps a multiple of the block for the same
    # reason (a ragged final block adds three extra shape compiles).
    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--nsteps", type=int, default=10240)
    # defaults: block 128 x group 12 — regenerated samples scale as
    # Ns^2/(group*block), and 12 x 0.75 GiB resident row blocks + one
    # column's generation transients + the Gram accumulator come to
    # ~11.3 GiB analytic (gram_pass_hbm_estimate); a device with more
    # memory admits a larger group (derived from the device: ROADMAP S3)
    ap.add_argument("--gram_group", type=int, default=12)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--num_modes", type=int, default=20)
    ap.add_argument("--outdir", default="flagship_run/PODFS")
    args = ap.parse_args()
    if args.crossover:
        print(json.dumps(crossover()))
        return 0
    os.makedirs(args.outdir, exist_ok=True)
    print(json.dumps(flagship(args.outdir, args.nsteps, args.gram_group,
                              block=args.block,
                              num_modes=args.num_modes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
