"""Device-time breakdown of the XLA generator on one GPU.

Traces the generation program (noise -> spatial filter -> temporal FIR ->
Lund -> pack -> rotate, the body of ``pipeline.make_generator``) at the
``bench.py`` shape — 512x512 plane, 64 steps, nf = 8 — and splits the device time by the
named scope each kernel's HLO op was traced under (``ops/filters.py``):

* ``noise_slabs``: Threefry and the write of the noise slab;
* ``filter_spatial_z``: the first filter GEMM, which reads that slab;
* ``filter_spatial_y``, ``filter_temporal``: the other two GEMMs;
* ``other``: Lund coloring, packing, rotation.

Usage:  python benchmarks/trace_generation.py [--out DIR]

Prints one JSON line with each scope's device time and share of the traced
window's device time, the device-busy share of the window, and the card
(``nvidia-smi`` name and power limit).  Fails when JAX finds no GPU.

XLA runs this program as one CUDA command buffer by default, which the
trace shows as a single event; the script turns command buffers off
(``--xla_gpu_enable_command_buffer=``, recorded in the output) so that each
kernel is its own event.  The untraced wall time is taken with the same
flag.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

XLA_FLAG = "--xla_gpu_enable_command_buffer="

SCOPES = ("noise_slabs", "filter_spatial_z", "filter_spatial_y",
          "filter_temporal")
JMA = KMA = 512
NSTEPS = 64
LN = 4.0                 # nf = ceil(2 * 4.0) = 8
REPS = 5


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the named scope in its ``op_name``."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"",
                         hlo_text):
        name, op_name = m.groups()
        out[name] = next((s for s in SCOPES if f"/{s}/" in f"/{op_name}/"),
                         "other")
    return out


def reduce_trace(xplane_path: str, scopes: dict) -> dict:
    """Per-scope device time and the busy share of the traced window, from
    the kernel events on the GPU planes' stream lines."""
    from jax.profiler import ProfileData

    per_scope = defaultdict(int)
    intervals = []
    unmatched = defaultdict(int)
    lines_seen, example_stats = [], None
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.append(f"{plane.name}|{line.name}")
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                example_stats = example_stats or {
                    k: str(v)[:120] for k, v in stats.items()}
                op = str(stats.get("hlo_op", ev.name))
                text = " ".join(str(v) for v in stats.values())
                scope = next((s for s in SCOPES if f"/{s}/" in text),
                             scopes.get(op))
                if scope is None:
                    unmatched[op] += ev.duration_ns
                    scope = "other"
                per_scope[scope] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    total = sum(per_scope.values())
    return {
        "device_ns": {k: int(v) for k, v in per_scope.items()},
        "device_share": {k: v / total for k, v in per_scope.items()}
        if total else {},
        "busy_share_of_window": busy / window if window else None,
        "window_ns": window,
        "unmatched_ops_ns": dict(sorted(unmatched.items(),
                                        key=lambda kv: -kv[1])[:10]),
        "trace_lines": lines_seen,
        "example_event_stats": example_stats,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/trace_generation")
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + XLA_FLAG).strip()

    from pods_digital_filter_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"trace_generation: needs a GPU, JAX found "
                         f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from pods_digital_filter_tpu.config import (FilterConfig, PipelineConfig,
                                                PlaneConfig)
    from pods_digital_filter_tpu.ops import filters, lund, rotation
    from pods_digital_filter_tpu.pipeline import _pack_snapshots, resolve_profile

    cfg = PipelineConfig(plane=PlaneConfig(jma=JMA, kma=KMA, res=0.001),
                         filt=FilterConfig(LN, LN, LN, 2.0), nsteps=NSTEPS)
    fields, _, filt, cfg, rotate = resolve_profile(cfg)

    # the body of pipeline.make_generator, jitted here so that the HLO op
    # names of the executed program can be read back
    @jax.jit
    def generate(t0, key, stresses, means):
        noise = filters.generate_correlated_noise(
            key, t0, NSTEPS, JMA, KMA, filt.nfx, filt.nfy, filt.nfz,
            filt.length_scale_x, filt.length_scale_y, filt.length_scale_z)
        A = _pack_snapshots(lund.apply_lund_stacked(noise, stresses, means))
        return rotation.rotate_velocity_packed(A, *cfg.plane.normal)

    stresses = tuple(jnp.asarray(s, jnp.float32) for s in fields.stresses())
    means = tuple(jnp.asarray(m, jnp.float32) for m in fields.means())
    call_args = (jax.random.key(cfg.seed), stresses, means)
    scopes = hlo_scopes(generate.lower(jnp.int32(0), *call_args)
                        .compile().as_text())
    generate(jnp.int32(0), *call_args).block_until_ready()   # compile
    t0 = time.perf_counter()
    for i in range(REPS):
        generate(jnp.int32(i * NSTEPS), *call_args).block_until_ready()
    wall = (time.perf_counter() - t0) / REPS

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for i in range(REPS):
            generate(jnp.int32(i * NSTEPS), *call_args).block_until_ready()
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, scopes)
    samples = JMA * KMA * NSTEPS
    # operations and bytes from the shapes (C = 3 components, T = NSTEPS)
    nf, slabs = filt.nfx, NSTEPS + 2 * filt.nfx
    jn, kn = JMA + 2 * filt.nfy, KMA + 2 * filt.nfz
    shape_counts = {
        "noise_bytes_written": 3 * slabs * jn * kn * 4,
        "gemm_flop": {
            "filter_spatial_z": 2 * 3 * slabs * jn * kn * KMA,
            "filter_spatial_y": 2 * 3 * slabs * KMA * jn * JMA,
            "filter_temporal": 2 * 3 * JMA * KMA * slabs * NSTEPS,
        },
    }
    print(json.dumps({
        "metric": "generation device-time breakdown",
        "config": f"{JMA}x{KMA} plane, {NSTEPS} steps, nf={filt.nfx}, "
                  f"f32 HIGHEST, RNG+filter+Lund+pack+rotate",
        "card": card, "device_kind": dev.device_kind,
        "xla_flags": os.environ["XLA_FLAGS"],
        "wall_s_per_call_untraced": wall,
        "samples_per_s_untraced": samples / wall,
        "reps_traced": REPS,
        **shape_counts,
        **red,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
