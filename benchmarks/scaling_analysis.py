"""Collective accounting for the sharded generation + Gram design.

CPU-mesh wall times are NOT performance evidence, so this script reports
what a CPU mesh can show exactly:

**Program structure** on 1/2/4/8 virtual devices: the
   collective instructions XLA actually emits for (a) the halo-exchange
   sharded generation step and (b) the mesh-sharded Gram column update —
   kind, count, and per-device payload bytes, read from the compiled HLO.
   The analytic byte formulas below are validated against these at a small
   shape (exact match asserted).  Scaling itself is measured on GPUs, not
   predicted here.

Run:  python benchmarks/scaling_analysis.py   (forces a CPU mesh; safe
anywhere).  Prints ONE JSON line.
"""

from __future__ import annotations

import json
import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                    # noqa: E402
import jax.numpy as jnp       # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pods_digital_filter_tpu.parallel import mesh as mesh_lib      # noqa: E402
from pods_digital_filter_tpu.parallel import sharding as shard_lib  # noqa: E402
from pods_digital_filter_tpu.parallel import streaming as pstream   # noqa: E402

# small validation shape (divisible by every mesh width)
JMA, KMA, BLOCK, NF = 32, 64, 16, 4
ITEM = 4  # f32

_KIND_RE = re.compile(
    r"\s(all-reduce|collective-permute|all-gather|reduce-scatter)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"([a-z]+[0-9]+|pred)\[([0-9,]*)\]")


def hlo_collectives(compiled) -> dict:
    """Count collective instructions and their per-device payload bytes in
    compiled (SPMD-partitioned) HLO.  An instruction's payload is the sum
    of all result shapes on its LHS (XLA emits tuple-shaped all-reduces
    when it fuses several reductions into one collective)."""
    out = {}
    for mod_text in [compiled.as_text()]:
        for line in mod_text.splitlines():
            line = line.strip()
            if "=" not in line:
                continue
            lhs, _, rhs = line.partition("=")
            m = _KIND_RE.search("= " + rhs)
            if not m or "-done" in rhs.split("(")[0]:
                continue          # start/done pairs: count the start only
            kind = m.group(1)
            head = rhs[:m.start()]          # result shape(s) before the op
            nbytes = 0
            for dt, dims in _SHAPE_RE.findall(head):
                nelem = 1
                for d in dims.split(","):
                    if d:
                        nelem *= int(d)
                isz = {"f32": 4, "bf16": 2, "f64": 8, "u32": 4, "s32": 4,
                       "pred": 1}.get(dt, 4)
                nbytes += nelem * isz
            e = out.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += nbytes
    return out


def analyze_halo_generation(n_s: int) -> dict:
    """Compile the ppermute halo-exchange generation step on a (1, n_s)
    mesh; return measured collectives + analytic halo bytes."""
    mesh = mesh_lib.make_mesh(1, n_s)
    key = jax.random.key(0)

    def step(key):
        return shard_lib.generate_sharded_halo(
            key, mesh, 0, BLOCK, JMA, KMA, NF, NF, NF, 2.0, 2.0, 2.0,
            num_components=3, dtype=jnp.float32)

    compiled = jax.jit(step).lower(key).compile()
    colls = hlo_collectives(compiled)
    # analytic: two ppermutes of the (slabs, C, jma+2nfy, nfz) halo strip
    slabs = BLOCK + 2 * NF
    halo_bytes = 2 * slabs * 3 * (JMA + 2 * NF) * NF * ITEM
    return {"mesh_s": n_s, "collectives": colls,
            "analytic_ppermute_bytes": halo_bytes if n_s > 1 else 0}


def analyze_gram_column(n_s: int, group: int = 2) -> dict:
    """Compile one Gram column update (the O(B^2) inner op of the sharded
    streaming POD: per-shard einsum partials + cross-'s' reduction into the
    replicated accumulator) on a (1, n_s) mesh."""
    mesh = mesh_lib.make_mesh(1, n_s)
    sh_blk = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, None, "s"))
    sh_repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    ns_total = 4 * BLOCK

    def make(shape, sh):
        return jax.jit(lambda: jnp.zeros(shape, jnp.float32),
                       out_shardings=sh)()

    blocks = tuple(make((3, BLOCK, JMA, KMA), sh_blk) for _ in range(group))
    Aj = make((3, BLOCK, JMA, KMA), sh_blk)
    C = make((ns_total, ns_total), sh_repl)
    upd = pstream.__dict__["_pair_products_fields"]

    def column(C, blocks, Aj):
        tiles = [upd(b, Aj) for b in blocks]
        tile = tiles[0] if len(tiles) == 1 else jnp.concatenate(tiles, 0)
        return jax.lax.dynamic_update_slice(
            C, tile, (jnp.int32(0), jnp.int32(0)))

    compiled = jax.jit(column).lower(C, blocks, Aj).compile()
    colls = hlo_collectives(compiled)
    # analytic: the (group*BLOCK, BLOCK) tile is all-reduced over 's'
    tile_bytes = group * BLOCK * BLOCK * ITEM
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
    except Exception:
        flops = 0.0
    return {"mesh_s": n_s, "group": group, "collectives": colls,
            "analytic_allreduce_tile_bytes": tile_bytes if n_s > 1 else 0,
            "hlo_flops_total": flops}


def main():
    result = {"halo_generation": [], "gram_column": []}
    for n in (1, 2, 4, 8):
        g = analyze_halo_generation(n)
        result["halo_generation"].append(g)
        c = analyze_gram_column(n)
        result["gram_column"].append(c)
        # validate the analytic formulas against the emitted HLO
        if n > 1:
            cp = g["collectives"].get("collective-permute", {"bytes": 0})
            assert cp["bytes"] == g["analytic_ppermute_bytes"], (
                n, cp, g["analytic_ppermute_bytes"])
            ar = c["collectives"].get("all-reduce", {"bytes": 0})
            assert ar["bytes"] == c["analytic_allreduce_tile_bytes"], (
                n, ar, c["analytic_allreduce_tile_bytes"])
    result["validated"] = ("analytic collective-byte formulas equal the "
                           "compiled HLO payloads at every mesh width")
    print(json.dumps({"metric": "sharded-design collective accounting",
                      "detail": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
