"""Tests for the collective-byte accounting tool (benchmarks/ici_accounting.py)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from benchmarks.ici_accounting import (accounting_for, collective_inventory,
                                       summarize)

SYNTH = """
ENTRY %main {
  %collective-permute.0 = f32[4,2]{1,0} collective-permute(%x), channel_id=1, metadata={op_name="jit(f)/setup"}
  %all-reduce.9 = f32[] all-reduce(%y), channel_id=2, metadata={op_name="jit(f)/while/body/reduce_sum"}
  %collective-permute.1 = bf16[8,16]{1,0} collective-permute(%z), channel_id=3, metadata={op_name="jit(f)/while/body/while/body/halo"}
  %cps = (f32[4,1]{1,0}, f32[4,1]{1,0}) collective-permute-start(%w), channel_id=4, metadata={op_name="jit(f)/while/body/while/body/scan"}
}
"""


def test_synthetic_inventory_depth_and_bytes():
    inv = collective_inventory(SYNTH)
    assert len(inv) == 4
    cp = [(c["depth"], c["bytes"]) for c in inv if c["op"] == "collective-permute"]
    assert (0, 4 * 2 * 4) in cp       # f32[4,2]
    assert (2, 8 * 16 * 2) in cp      # bf16[8,16]
    assert (2, 4 * 1 * 4) in cp       # tuple type (async start): first buffer
    ar = [c for c in inv if c["op"] == "all-reduce"]
    assert ar[0]["depth"] == 1 and ar[0]["bytes"] == 4

    summ = summarize(inv)
    assert summ["2"]["bytes"] == 8 * 16 * 2 + 4 * 1 * 4
    acct = accounting_for(summ, ng=2, inners_per_outer=10.0)
    # depth-1 bytes once + depth-2 bytes split over ng=2 loops times inners/outer
    assert acct["bytes_per_outer"] == 4 + int((8 * 16 * 2 + 16) / 2 * 10)
    assert acct["allreduces_per_outer"] == 1.0
    # without a measured inner count only the per-inner / per-outer parts
    bare = accounting_for(summ, ng=2)
    assert bare["per_inner_bytes"] == (8 * 16 * 2 + 16) // 2
    assert bare["per_outer_fixed_bytes"] == 4 and "bytes_per_outer" not in bare


def test_real_compiled_sharded_loop_has_depth1_collectives():
    """Compile a tiny sharded while loop on the 8-device CPU mesh and check the
    parser finds its halo permutes and norm all-reduce at depth 1."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("s",))
    sh = NamedSharding(mesh, P(None, "s"))

    def f(x):
        def body(c):
            v, i = c
            w = v + jnp.roll(v, 1, axis=1) + jnp.roll(v, -1, axis=1)
            return w / jnp.sqrt(jnp.sum(w * w)), i + 1

        return jax.lax.while_loop(lambda c: c[1] < 5, body, (x, 0))[0]

    x = jax.device_put(jnp.ones((4, 64), jnp.float32), sh)
    txt = jax.jit(f).lower(x).compile().as_text()
    inv = collective_inventory(txt)
    d1 = [c for c in inv if c["depth"] == 1]
    assert any(c["op"] == "collective-permute" for c in d1)
    assert any(c["op"] == "all-reduce" for c in d1)
    # halo plane is the per-device 4x1 f32 slab
    halo = [c for c in d1 if c["op"] == "collective-permute"]
    assert all(c["bytes"] == 4 * 1 * 4 for c in halo)
