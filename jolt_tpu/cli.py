"""Command-line interface (reference: src/main.rs `jolt` binary +
jolt-core/src/main.rs trace/bench driver).

    python -m jolt_tpu.cli prove-fib [--n 8]      prove+verify fibonacci
    python -m jolt_tpu.cli surge-bench [--nv 10]  Surge XOR prover benchmark
    python -m jolt_tpu.cli gp-bench [--logn 14]   grand-product round throughput
"""
from __future__ import annotations

import argparse
import json
import time


def _init_jax(platform: str | None):
    import os
    if platform == "cpu":
        # correctness-drive mode: XLA:CPU compile time dominates; back
        # off backend optimizations (runtime is not what CPU runs
        # measure).  GPU runs are unaffected.
        if "xla_backend_optimization_level" not in os.environ.get(
                "XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_backend_optimization_level=0")
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    from .utils.caches import enable_persistent_compilation_cache
    enable_persistent_compilation_cache(jax)


def _make_pcs(name: str, spec, vm, device, steps, bytecode_rows):
    """Construct the requested commitment scheme, sized to the trace.

    hyperkzg is the production default of the reference (rv32i_vm.rs:228);
    mock skips commitments entirely (test transcript parity only).
    """
    if name == "hyperkzg":
        from .commitment.hyperkzg import HyperKZG
        n = vm.required_srs_len(device, steps, bytecode_rows)
        print(f"HyperKZG SRS length: {n}")
        return HyperKZG.setup(n)
    from .commitment import MockCommitmentScheme
    return MockCommitmentScheme(spec)


def cmd_prove_fib(args):
    _init_jax(args.platform)
    if getattr(args, "profile", False):
        from .utils import profiling
        profiling.enable()
    from .commitment import MockCommitmentScheme
    from .field import fr_spec
    from .instructions import AddInstruction, BneInstruction
    from .subtables.rv32i import (EqSubtable, IdentitySubtable,
                                  TruncateOverflowSubtable)
    from .vm.host import fibonacci_program, trace_program
    from .vm.rv32i_vm import mini_vm

    spec = fr_spec()
    vm = mini_vm([AddInstruction, BneInstruction],
                 [TruncateOverflowSubtable(32), IdentitySubtable(),
                  EqSubtable()], M_mini=1 << 8, spec=spec)
    program = fibonacci_program(args.n)
    steps, device, bytecode_rows = trace_program(
        program, vm, max_input_size=32, max_output_size=32)
    print(f"Trace length: {len(steps)}")
    pcs = _make_pcs(getattr(args, "pcs", "mock"), spec, vm, device, steps,
                    bytecode_rows)
    pre = vm.preprocess(bytecode_rows, pcs)
    t0 = time.time()
    proof, commitments, pt, pacc = vm.prove(device, steps, pre)
    print(f"prove: {time.time() - t0:.2f}s")
    t0 = time.time()
    vm.verify(pre, proof, commitments)
    print(f"verify: {time.time() - t0:.2f}s")
    from .utils.serialization import proof_size_bytes
    print(f"proof size (approx): {proof_size_bytes(proof)} bytes")
    if getattr(args, "profile", False):
        from .utils import profiling
        profiling.print_cumulative()


def cmd_pcs_bench(args):
    """Batch-commit timing per PCS (benches/pcs_bench.rs:25-33 analog)."""
    _init_jax(args.platform)
    import jax
    import numpy as np
    import jax.numpy as jnp
    from .field import fr_spec
    from .field import device as fd

    spec = fr_spec()
    n = 1 << args.logn
    if args.pcs == "hyperkzg":
        from .commitment.hyperkzg import HyperKZG
        pcs = HyperKZG.setup(n)
    elif args.pcs == "zeromorph":
        from .commitment.zeromorph import Zeromorph
        pcs = Zeromorph.setup(n)
    else:
        from .commitment.hyrax import HyraxScheme
        pcs = HyraxScheme.setup(n)
    rng = np.random.default_rng(0)
    poly = fd.to_mont_device(spec, jnp.asarray(
        fd.pack_u64(rng.integers(1, 1 << 63, size=n, dtype=np.uint64))))
    t0 = time.time()
    pcs.commit(poly)
    print(f"{args.pcs} commit 2^{args.logn}: {time.time() - t0:.3f}s "
          "(first call includes compile)")
    t0 = time.time()
    pcs.commit(poly)
    print(f"{args.pcs} commit 2^{args.logn} (warm): {time.time() - t0:.3f}s")


def cmd_analyze(args):
    """Per-opcode trace histogram (host/analyze.rs:27-44 analog)."""
    _init_jax(args.platform)
    from .vm.analyze import trace_analyze
    from .vm.rv32i_vm import rv32i_vm
    if args.guest == "sha2-chain":
        from .vm.guests import sha2_chain_program
        program = sha2_chain_program(args.n)
        inputs = b"\x05" * 32
    elif args.guest == "sha3-chain":
        from .vm.guests import sha3_chain_program
        program = sha3_chain_program(args.n)
        inputs = b"\x05" * 32
    elif args.guest == "collatz":
        from .vm.guests import collatz_program
        program = collatz_program(args.n)
        inputs = b""
    else:
        from .vm.host import fibonacci_program
        program = fibonacci_program(args.n)
        inputs = b""
    vm = rv32i_vm()
    summary = trace_analyze(program, vm, inputs=inputs)
    print(f"Trace length: {summary.trace_len()}")
    for op, count in summary.analyze():
        print(f"{op.name:12s} {count}")


def cmd_prove_sha2_chain(args):
    """End-to-end sha2-chain prove+verify on the full RV32I VM
    (bench.rs:212-246 analog)."""
    _init_jax(args.platform)
    from .commitment import MockCommitmentScheme
    from .field import fr_spec
    from .utils import profiling
    from .vm.guests import sha2_chain_expected, sha2_chain_program
    from .vm.host import trace_program
    from .vm.rv32i_vm import rv32i_vm

    profiling.enable()
    spec = fr_spec()
    vm = rv32i_vm(spec)
    inputs = b"\x05" * 32
    program = sha2_chain_program(args.iters)
    steps, device, bytecode_rows = trace_program(program, vm, inputs=inputs)
    assert bytes(device.outputs)[:32] == sha2_chain_expected(inputs, args.iters)
    print(f"Trace length: {len(steps)}")
    pcs = _make_pcs(getattr(args, "pcs", "mock"), spec, vm, device, steps,
                    bytecode_rows)
    pre = vm.preprocess(bytecode_rows, pcs)
    t0 = time.time()
    proof, commitments, _, _ = vm.prove(device, steps, pre)
    print(f"prove: {time.time() - t0:.2f}s")
    t0 = time.time()
    vm.verify(pre, proof, commitments)
    print(f"verify: {time.time() - t0:.2f}s")
    profiling.print_cumulative()


def cmd_prove_guest(args):
    """End-to-end prove+verify for the example guests (examples/* analogs:
    collatz, sha3-chain, sha2-chain by name)."""
    _init_jax(args.platform)
    from .commitment import MockCommitmentScheme
    from .field import fr_spec
    from .utils import profiling
    from .vm.host import trace_program
    from .vm.rv32i_vm import rv32i_vm

    inputs = b""
    if args.guest == "collatz":
        from .vm.guests import collatz_program
        program = collatz_program(args.n)
    elif args.guest == "sha3-chain":
        from .vm.guests import sha3_chain_expected, sha3_chain_program
        inputs = b"\x05" * 32
        program = sha3_chain_program(args.n)
    elif args.guest == "alloc":
        from .vm.guests import alloc_sum_program
        program = alloc_sum_program(args.n)
    elif args.guest == "multi-function":
        from .vm.guests import multi_function_program
        program = multi_function_program(args.n)
    elif args.guest == "stdlib":
        from .vm.guests import stdlib_program
        program = stdlib_program(args.n)
    elif args.guest == "muldiv":
        from .vm.guests import muldiv_program
        program = muldiv_program()
    elif args.guest == "fibonacci":
        from .vm.host import fibonacci_program
        program = fibonacci_program(args.n)
    elif args.guest == "sha3-ex":  # examples/sha3-ex: single-shot keccak
        from .vm.guests import sha3_chain_expected, sha3_chain_program
        inputs = b"\x05" * 32
        program = sha3_chain_program(1)
    else:  # sha2-chain / sha2-ex (examples/sha2-ex = single-shot sha2)
        from .vm.guests import sha2_chain_expected, sha2_chain_program
        inputs = b"\x05" * 32
        program = sha2_chain_program(1 if args.guest == "sha2-ex" else args.n)

    profiling.enable()
    spec = fr_spec()
    vm = rv32i_vm(spec)
    steps, device, bytecode_rows = trace_program(program, vm, inputs=inputs)
    if args.guest == "sha3-chain":
        assert bytes(device.outputs)[:32] == sha3_chain_expected(inputs, args.n)
    elif args.guest == "sha2-chain":
        assert bytes(device.outputs)[:32] == sha2_chain_expected(inputs, args.n)
    elif args.guest == "alloc":
        import struct
        from .vm.guests import alloc_sum_expected
        got = struct.unpack("<I", bytes(device.outputs)[:4])[0]
        assert got == alloc_sum_expected(args.n)
    elif args.guest == "multi-function":
        import struct
        from .vm.guests import multi_function_expected
        got = struct.unpack("<I", bytes(device.outputs)[:4])[0]
        assert got == multi_function_expected(args.n)
    elif args.guest == "stdlib":
        from .vm.guests import stdlib_expected
        want = stdlib_expected(args.n)
        assert bytes(device.outputs)[:len(want)] == want
    elif args.guest == "muldiv":
        import struct
        from .vm.guests import muldiv_expected
        got = struct.unpack("<I", bytes(device.outputs)[:4])[0]
        assert got == muldiv_expected()
    elif args.guest == "sha2-ex":
        assert bytes(device.outputs)[:32] == sha2_chain_expected(inputs, 1)
    elif args.guest == "sha3-ex":
        assert bytes(device.outputs)[:32] == sha3_chain_expected(inputs, 1)
    print(f"Trace length: {len(steps)}")
    pcs = _make_pcs(getattr(args, "pcs", "mock"), spec, vm, device, steps,
                    bytecode_rows)
    pre = vm.preprocess(bytecode_rows, pcs)
    t0 = time.time()
    proof, commitments, _, _ = vm.prove(device, steps, pre)
    print(f"prove: {time.time() - t0:.2f}s")
    t0 = time.time()
    vm.verify(pre, proof, commitments)
    print(f"verify: {time.time() - t0:.2f}s")
    profiling.print_cumulative()


def cmd_surge_bench(args):
    """The fork's headline benchmark (bench.rs:109-210): Surge XOR lookups.

    Mirrors the reference's methodology: a REAL HyperKZG setup (sized for
    the largest nv), nv sweep, `--prover-runs` averaged prover times
    (default 10, bench.rs:155-163), ark-compressed proof size print
    (bench.rs:101-108, 166-168), and `--verifier-runs` averaged verifier
    times (default 50, bench.rs:170-177).  `--pcs mock` restores the old
    quick mode."""
    _init_jax(args.platform)
    import numpy as np
    from .commitment import MockCommitmentScheme
    from .commitment.hyperkzg import HyperKZG
    from .field import fr_spec
    from .instructions import XorInstruction
    from .lasso import SurgePreprocessing, surge_prove, surge_verify
    from .utils.ark_proof import serialize_surge_proof

    spec = fr_spec()
    nv_list = list(range(args.nv, args.nv_hi + 1)) if args.nv_hi else \
        [args.nv]
    C, M = 4, 1 << 16
    pre = SurgePreprocessing(XorInstruction, C, M, spec)
    if getattr(args, "pcs", "hyperkzg") == "mock":
        pcs = MockCommitmentScheme(spec)
    else:
        pcs = HyperKZG.setup(max(1 << max(nv_list), M))
    rng = np.random.default_rng(0)
    for nv in nv_list:
        n = 1 << nv
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        y = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        total = 0.0
        proof = pt = None
        for _ in range(max(1, args.prover_runs)):
            t0 = time.time()
            proof, pt, _ = surge_prove(pre, pcs, x, y)
            total += time.time() - t0
        prove_avg = total / max(1, args.prover_runs)
        try:
            proof_bytes = len(serialize_surge_proof(proof,
                                                    pre.num_memories))
        except Exception:   # Mock commitments aren't G1 points
            proof_bytes = None
        t0 = time.time()
        for _ in range(max(1, args.verifier_runs)):
            surge_verify(pre, pcs, proof, debug_transcript=pt)
        verify_avg = (time.time() - t0) / max(1, args.verifier_runs)
        print(json.dumps({
            "surge_xor_nv": nv,
            "prover_runs": args.prover_runs,
            "prove_seconds_avg": round(prove_avg, 4),
            "proof_size_bytes": proof_bytes,
            "verifier_runs": args.verifier_runs,
            "verify_seconds_avg": round(verify_avg, 4),
        }))


def cmd_gp_bench(args):
    # bench.py opens the card in its own process: this one stays off JAX
    import subprocess
    import sys
    subprocess.run([sys.executable, "bench.py"], check=True)


_GUEST_TEMPLATE = '''\
"""Guest program for {name} — RV32IM via the jolt_tpu mini-assembler.

The reference's `jolt new` scaffolds a Rust guest crate with a
`#[jolt::provable]` fn (src/main.rs:48-100); here the guest is an
assembled RV32IM program.  Raw ELF bytes (any RV32IM toolchain output)
work too — pass them straight to build_provable.
"""
from jolt_tpu.vm.host import Assembler


def program(n: int = 8):
    """fib(n): result left in x2."""
    asm = Assembler()
    asm.addi(2, 0, 0)   # a = 0
    asm.addi(3, 0, 1)   # b = 1
    asm.addi(1, 0, 0)   # i = 0
    asm.addi(4, 0, n)   # n
    asm.label("loop")
    asm.add(5, 2, 3)    # t = a + b
    asm.add(2, 3, 0)    # a = b
    asm.add(3, 5, 0)    # b = t
    asm.addi(1, 1, 1)   # i += 1
    asm.bne(1, 4, "loop")
    asm.label("halt")
    asm.jal(0, "halt")  # PC repeat => trace termination
    return asm.finish()
'''

_HOST_TEMPLATE = '''\
"""Host for {name}: build, prove, verify (the reference host crate's
main.rs analog — macro output shape per jolt-sdk/macros/src/lib.rs:89-131).
"""
from jolt_tpu.sdk import build_provable

from guest import program


def main():
    prove, verify = build_provable(program(), pcs="{pcs}")
    outputs, artifacts = prove(b"")
    print(f"trace length: {{artifacts.trace_length}}")
    assert verify(artifacts), "proof rejected"
    print("proof verified")


if __name__ == "__main__":
    main()
'''

_README_TEMPLATE = '''\
# {name}

A jolt_tpu guest/host project (scaffolded by `python -m jolt_tpu.cli new`).

- `guest.py` — the RV32IM guest program (mini-assembler; raw ELF bytes from
  any RV32IM toolchain also work).
- `host.py` — proves and verifies one execution:

      python host.py
'''


def cmd_new(args):
    """Scaffold a guest+host project (reference: `jolt new`,
    src/main.rs:48-100)."""
    import os
    d = args.name
    if os.path.exists(d):
        raise SystemExit(f"{d!r} already exists")
    os.makedirs(d)
    ctx = {"name": os.path.basename(d), "pcs": args.pcs}
    with open(os.path.join(d, "guest.py"), "w") as f:
        f.write(_GUEST_TEMPLATE.format(**ctx))
    with open(os.path.join(d, "host.py"), "w") as f:
        f.write(_HOST_TEMPLATE.format(**ctx))
    with open(os.path.join(d, "README.md"), "w") as f:
        f.write(_README_TEMPLATE.format(**ctx))
    print(f"created {d}/: guest.py host.py README.md")


def main():
    p = argparse.ArgumentParser(prog="jolt_tpu")
    p.add_argument("--platform", default=None,
                   help="jax platform override (cpu / gpu)")
    p.add_argument("--jax-trace", default=None, metavar="DIR",
                   help="capture a JAX profiler trace of the command into "
                        "DIR (Perfetto/TensorBoard-compatible; the analog "
                        "of the reference's --format chrome tracing)")
    sub = p.add_subparsers(dest="cmd", required=True)
    nw = sub.add_parser("new", help="scaffold a guest+host project")
    nw.add_argument("name")
    nw.add_argument("--pcs", default="hyperkzg", choices=["mock", "hyperkzg"])
    nw.set_defaults(fn=cmd_new)
    f = sub.add_parser("prove-fib")
    f.add_argument("--n", type=int, default=8)
    f.add_argument("--pcs", default="mock", choices=["mock", "hyperkzg"])
    f.add_argument("--profile", action="store_true",
                   help="print cumulative span timings (sum_timer.rs analog)")
    f.set_defaults(fn=cmd_prove_fib)
    s = sub.add_parser("surge-bench")
    s.add_argument("--nv", type=int, default=10)
    s.add_argument("--nv-hi", type=int, default=0,
                   help="sweep nv..nv-hi (bench.rs:126 sweeps 20..=24)")
    s.add_argument("--pcs", default="hyperkzg", choices=["mock", "hyperkzg"])
    s.add_argument("--prover-runs", type=int, default=10)
    s.add_argument("--verifier-runs", type=int, default=50)
    s.set_defaults(fn=cmd_surge_bench)
    g = sub.add_parser("gp-bench")
    g.add_argument("--logn", type=int, default=14)
    g.set_defaults(fn=cmd_gp_bench)
    pb = sub.add_parser("pcs-bench")
    pb.add_argument("--logn", type=int, default=12)
    pb.add_argument("--pcs", default="hyperkzg",
                    choices=["hyperkzg", "zeromorph", "hyrax"])
    pb.set_defaults(fn=cmd_pcs_bench)
    an = sub.add_parser("analyze")
    an.add_argument("--guest", default="sha2-chain",
                    choices=["sha2-chain", "sha3-chain", "collatz",
                             "fibonacci"])
    an.add_argument("--n", type=int, default=1)
    an.set_defaults(fn=cmd_analyze)
    sh = sub.add_parser("prove-sha2-chain")
    sh.add_argument("--iters", type=int, default=1)
    sh.add_argument("--pcs", default="mock", choices=["mock", "hyperkzg"])
    sh.set_defaults(fn=cmd_prove_sha2_chain)
    pg = sub.add_parser("prove-guest")
    pg.add_argument("--guest", default="collatz",
                    choices=["collatz", "sha3-chain", "sha2-chain",
                             "alloc", "multi-function", "stdlib",
                             "fibonacci", "sha2-ex", "sha3-ex", "muldiv"])
    pg.add_argument("--n", type=int, default=1,
                    help="iterations (chains) or start value (collatz)")
    pg.add_argument("--pcs", default="mock", choices=["mock", "hyperkzg"])
    pg.set_defaults(fn=cmd_prove_guest)
    args = p.parse_args()
    if args.jax_trace:
        from .utils.profiling import jax_trace
        with jax_trace(args.jax_trace):
            args.fn(args)
    else:
        args.fn(args)


if __name__ == "__main__":
    main()
