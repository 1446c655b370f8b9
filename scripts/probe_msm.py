"""Probe: batch bitplane-MSM throughput on the device at bench-like shapes.

Usage: python scripts/probe_msm.py [J] [log2n] [bits]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from jolt_tpu.utils.caches import enable_persistent_compilation_cache

enable_persistent_compilation_cache(jax)

import numpy as np
import jax.numpy as jnp

from jolt_tpu.field import fr_spec
from jolt_tpu.field import device as fd
from jolt_tpu.commitment import kzg
from jolt_tpu.curve import device as cd

J = int(sys.argv[1]) if len(sys.argv) > 1 else 16
log2n = int(sys.argv[2]) if len(sys.argv) > 2 else 14
bits = int(sys.argv[3]) if len(sys.argv) > 3 else 63
n = 1 << log2n
FR = fr_spec()

pk, vk = kzg.srs_setup(n)
rng = np.random.default_rng(5)
polys = [fd.to_mont_device(FR, jnp.asarray(fd.pack_u64(
    rng.integers(1, 1 << min(bits, 63), size=n, dtype=np.uint64))))
    for _ in range(J)]
print(f"J={J} n=2^{log2n} bits<={bits} "
      f"SEG={cd.MSM_FOLD_SEG} TAIL={cd.MSM_FOLD_TAIL} K={cd.MSM_CHANNEL_CHUNK}",
      flush=True)
for it in range(2):
    t0 = time.perf_counter()
    out = cd.batch_msm_bitplane(pk.g1_jac, polys, FR)
    dt = time.perf_counter() - t0
    rate = J * n / dt
    print(f"run {it}: {dt:.2f}s -> {rate:,.0f} scalar-muls/s", flush=True)
