"""Probe: where does the per-layer time of a dense GP prove go on the
device?  Runs a standalone BatchedDenseGrandProduct prove (warm, second
run timed) with the compiled-program counter + per-phase timers.

Usage:  python scripts/probe_gp_overhead.py [nv] [batch]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from jolt_tpu.utils.caches import enable_persistent_compilation_cache  # noqa: E402

enable_persistent_compilation_cache(jax)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jolt_tpu.field import fr_spec  # noqa: E402
from jolt_tpu.field import device as fd  # noqa: E402
from jolt_tpu.subprotocols.grand_product import BatchedDenseGrandProduct  # noqa: E402
from jolt_tpu.transcript import Transcript  # noqa: E402
from jolt_tpu.utils import profiling  # noqa: E402

nv = int(sys.argv[1]) if len(sys.argv) > 1 else 13
batch = int(sys.argv[2]) if len(sys.argv) > 2 else 16

spec = fr_spec()
profiling.count_programs()
profiling.enable()

rng = np.random.default_rng(1)
vals = rng.integers(1, 1 << 63, size=(batch, 1 << nv), dtype=np.uint64)
leaves = fd.to_mont_device(spec, jnp.asarray(fd.pack_u64(vals)))

for it in range(2):
    profiling.reset()
    profiling.reset_programs()
    t0 = time.perf_counter()
    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    jax.block_until_ready(jax.tree.leaves(
        [lay for lay in gp.layers if not isinstance(lay, tuple)] or [0]))
    t1 = time.perf_counter()
    t = Transcript(b"probe")
    proof, r = gp.prove(t)
    t2 = time.perf_counter()
    print(f"--- run {it}: construct {t1-t0:.2f}s prove {t2-t1:.2f}s "
          f"({len(proof.layers)} layers)")
    profiling.print_cumulative()
    profiling.print_programs(top=12)
