"""The sha2-chain time-vs-size ladder (reference
headline bench.rs:212-246 runs iters=1000 to trace ~2^22).

Usage:  python scripts/e2e_ladder.py [iters ...]   (default: 4 16 64)
Each rung proves+verifies sha2-chain(iters) on the default backend and
prints one JSON line; results go into PERF.md.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax

from jolt_tpu.utils.caches import enable_persistent_compilation_cache

enable_persistent_compilation_cache(jax)

from jolt_tpu.commitment.hyperkzg import HyperKZG
from jolt_tpu.field import fr_spec
from jolt_tpu.utils import profiling
from jolt_tpu.vm.guests import sha2_chain_expected, sha2_chain_program
from jolt_tpu.vm.host import trace_program
from jolt_tpu.vm.rv32i_vm import rv32i_vm

profiling.enable()
profiling.count_programs()

spec = fr_spec()
vm = rv32i_vm(spec)
inputs = b"\x05" * 32

for iters in [int(x) for x in (sys.argv[1:] or ["4", "16", "64"])]:
    profiling.reset()
    profiling.reset_programs()
    t0 = time.perf_counter()
    steps, device, bytecode_rows = trace_program(
        sha2_chain_program(iters), vm, inputs=inputs)
    trace_s = time.perf_counter() - t0
    assert bytes(device.outputs)[:32] == sha2_chain_expected(inputs, iters)
    n = vm.required_srs_len(device, steps, bytecode_rows)
    print(f"# iters={iters}: trace {len(steps)} steps "
          f"(2^{len(steps).bit_length()}), srs 2^{n.bit_length()-1}",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    pcs = HyperKZG.setup(n)
    srs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = vm.preprocess(bytecode_rows, pcs)
    pre_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, commitments, _, _ = vm.prove(device, steps, pre)
    prove_s = time.perf_counter() - t0
    profiling.print_cumulative()
    t0 = time.perf_counter()
    vm.verify(pre, proof, commitments)
    verify_s = time.perf_counter() - t0
    st = profiling.program_stats()
    print(json.dumps({
        "workload": f"sha2-chain({iters})",
        "trace_length": len(steps),
        "trace_seconds": round(trace_s, 2),
        "srs_seconds": round(srs_s, 2),
        "preprocess_seconds": round(pre_s, 2),
        "prove_seconds": round(prove_s, 2),
        "verify_seconds": round(verify_s, 2),
        "program_count": st["count"],
        "program_load_seconds": st["seconds"],
    }), flush=True)
