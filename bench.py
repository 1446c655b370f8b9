"""Benchmark on one NVIDIA GPU: GP-round field-multiply throughput, MSM
commit throughput, and an end-to-end prove of sha2-chain on the full
RV32I VM with HyperKZG (the reference's headline workload,
bench.rs:212-246).

    python bench.py

Exits non-zero, printing no result, when JAX finds no GPU; any failure in
a stage is a non-zero exit.  Progress goes to stderr; the last line of
stdout is ONE JSON object with the device (platform, kind, count, card
name and power limit) beside every number.  JOLT_BENCH_MSM=0 and
JOLT_BENCH_E2E=0 skip those stages; JOLT_BENCH_E2E_ITERS sets the
sha2-chain iteration count (default 1).

vs_baseline divides the GP-round rate by an ESTIMATE of multicore-rayon
arkworks Fr multiplication throughput: ~15-20M mul/s/core over ~32
threads => ~5e8 field-mul/s.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_T0 = time.monotonic()


def _log(msg):
    print(f"[bench +{time.monotonic() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _card() -> str:
    """Card name and power limit, from a child that never imports JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def bench_e2e() -> dict:
    """sha2-chain prove + verify on the full RV32I VM with HyperKZG."""
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import fr_spec
    from jolt_tpu.utils import profiling
    from jolt_tpu.vm.guests import sha2_chain_expected, sha2_chain_program
    from jolt_tpu.vm.host import trace_program
    from jolt_tpu.vm.rv32i_vm import rv32i_vm

    profiling.enable()
    profiling.count_programs()
    profiling.reset_programs()
    spec = fr_spec()
    vm = rv32i_vm(spec)
    iters = int(os.environ.get("JOLT_BENCH_E2E_ITERS", "1"))
    inputs = b"\x05" * 32
    t0 = time.perf_counter()
    steps, device, bytecode_rows = trace_program(sha2_chain_program(iters),
                                                 vm, inputs=inputs)
    trace_seconds = time.perf_counter() - t0
    assert bytes(device.outputs)[:32] == sha2_chain_expected(inputs, iters)
    _log(f"e2e: trace {len(steps)} steps in {trace_seconds:.2f}s")
    n = vm.required_srs_len(device, steps, bytecode_rows)
    t0 = time.perf_counter()
    pcs = HyperKZG.setup(n)
    srs_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = vm.preprocess(bytecode_rows, pcs)
    preprocess_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, commitments, _, _ = vm.prove(device, steps, pre)
    prove_seconds = time.perf_counter() - t0
    pstats = profiling.program_stats()
    _log(f"e2e: prove {prove_seconds:.2f}s; {pstats['count']} programs "
         f"compiled in {pstats['seconds']:.1f}s")
    for name, calls, total, _ in profiling.cumulative():
        _log(f"e2e:   {name:40s} {calls:5d} {total:9.3f}s")
    t0 = time.perf_counter()
    vm.verify(pre, proof, commitments)
    verify_seconds = time.perf_counter() - t0
    _log(f"e2e: verify {verify_seconds:.2f}s")
    return {
        "e2e_workload": f"sha2-chain({iters}) rv32i hyperkzg",
        "e2e_trace_length": len(steps),
        "e2e_trace_seconds": trace_seconds,
        "e2e_srs_seconds": srs_seconds,
        "e2e_preprocess_seconds": preprocess_seconds,
        "e2e_prove_seconds": prove_seconds,
        "e2e_program_count": pstats["count"],
        "e2e_compile_seconds": pstats["seconds"],
        "e2e_verify_seconds": verify_seconds,
    }


def bench_gp_round(spec, rng) -> dict:
    """GKR rounds (cubic evals -> bind) chained on device in one program,
    at the layer-top shape: B = 32 batched circuits (memory checking
    batches ~54 memories' read/write circuits into one GP), n = 2^16
    interleaved leaves (s = 2^15 per side)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jolt_tpu.field import device as fd
    from jolt_tpu.subprotocols.grand_product import (_pair_bind,
                                                     _pair_cubic_evals)

    B, s = 32, 1 << 15
    mk = lambda *shape: fd.to_mont_device(spec, jnp.asarray(
        fd.pack_u64(rng.integers(1, 1 << 63, size=shape, dtype=np.uint64))))
    l = jnp.moveaxis(mk(B, s), 0, 1)    # [B, L, s]
    rt = jnp.moveaxis(mk(B, s), 0, 1)
    eq = mk(s)
    coeffs = mk(B)
    R = 8

    def step(l, rt, eq, coeffs):
        # each round's challenge derives from its own evals (a real data
        # dependency); the bound halves are tiled back to full size so
        # every round runs the layer-top shape
        acc = fd.zeros(spec, (3,))
        for _ in range(R):
            evals = _pair_cubic_evals(spec, l, rt, eq, coeffs)
            acc = fd.fadd(spec, acc, evals)
            nl, nr, neq = _pair_bind(spec, l, rt, eq, evals[:, 0])
            l = jnp.concatenate([nl, nl], axis=-1)
            rt = jnp.concatenate([nr, nr], axis=-1)
            eq = jnp.concatenate([neq, neq], axis=-1)
        return acc

    step_jit = jax.jit(step)
    jax.block_until_ready(step_jit(l, rt, eq, coeffs))
    iters = 20
    t0 = time.perf_counter()
    outs = [step_jit(l, rt, eq, coeffs) for _ in range(iters)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / iters
    # field muls per round at per-side size s (h = s/2 sibling pairs):
    # evals h*(B*5 + 3), bind h*(B*2 + 1)
    ops_per_sec = R * (s // 2) * (B * 7 + 4) / dt
    _log(f"gp round: {ops_per_sec / 1e6:.1f}M field-muls/s")
    return {"metric": "gp_cubic_round_field_muls_per_sec",
            "value": ops_per_sec, "unit": "field-muls/s",
            "vs_baseline": ops_per_sec / 5e8}


def bench_msm(spec, rng) -> dict:
    """Witness-shaped batch commit: 14 u32 columns + 2 full-width RLC
    columns over a 2^14 SRS prefix (the production bitplane MSM)."""
    import jax.numpy as jnp
    import numpy as np
    from jolt_tpu.commitment.kzg import kzg_commit_batch, srs_setup
    from jolt_tpu.field import device as fd

    n = 1 << 14
    pk, _ = srs_setup(n)
    cols = [fd.to_mont_device(spec, jnp.asarray(fd.pack_u64(
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64))))
        for _ in range(14)]
    cols += [fd.to_mont_device(spec, jnp.asarray(fd.pack_u64(
        rng.integers(1, 1 << 63, size=n, dtype=np.uint64)))) for _ in range(2)]
    kzg_commit_batch(pk, cols)           # compile
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        kzg_commit_batch(pk, cols)
    dt = (time.perf_counter() - t0) / reps
    _log(f"msm: {len(cols) * n / dt / 1e6:.2f}M scalar-muls/s")
    return {"msm_commit_scalar_muls_per_sec": len(cols) * n / dt,
            "msm_commit_batch": f"{len(cols)}x2^14"}


def main():
    import jax
    import numpy as np
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU found (JAX platform {devs[0].platform!r}); "
              "the benchmark runs on a GPU only", file=sys.stderr)
        sys.exit(2)
    from jolt_tpu.field import fr_spec
    from jolt_tpu.utils.caches import enable_persistent_compilation_cache
    enable_persistent_compilation_cache(jax)
    card = _card()
    _log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
         f"card {card}")
    spec = fr_spec()
    rng = np.random.default_rng(7)
    out = bench_gp_round(spec, rng)
    if os.environ.get("JOLT_BENCH_MSM", "1") not in ("0", ""):
        out.update(bench_msm(spec, rng))
    if os.environ.get("JOLT_BENCH_E2E", "1") not in ("0", ""):
        out.update(bench_e2e())
    out["device"] = {"platform": devs[0].platform,
                     "kind": devs[0].device_kind, "count": len(devs),
                     "card": card,
                     "xla_flags": os.environ.get("XLA_FLAGS", "")}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
