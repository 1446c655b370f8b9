#!/usr/bin/env python3
"""Smoke test of the prover on one NVIDIA GPU, in one process.

    python chip_smoke.py            # phases 0-3 on one GPU
    python chip_smoke.py --four     # phase 4 only: the mesh path on 4 GPUs

Phases:
  0. environment (JAX, devices, XLA_FLAGS, compile cache, card and power
     limit); exits non-zero when JAX finds no GPU — there is no fallback;
  1. kernel parity at real widths, compiled for the card: the CUDA field
     kernels (Montgomery multiply, add, sub), the GP round and the point
     ops, each against the plain XLA path (bit for bit) and the host
     big-int oracle;
  2. cross-device proof equality: the mini-VM fib(3) HyperKZG proof must
     serialize to the CPU-frozen bytes of fixtures/ark/fib_mini.bin;
  3. end to end: sha2-chain(1) on the full RV32I VM with HyperKZG, proved
     twice (cold, warm) and verified against the host transcript replay;
  4. (--four) stages 1-5 of __graft_entry__.dryrun_multichip on 4 GPUs.

Every check is an assert: any failure ends the run with a non-zero exit.
The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

_T0 = time.perf_counter()

# real widths: the multiply at ~2^22 elements, the GP round at the bench
# shape (B = 32 circuits, 2^15 pairs per side), point ops at 2^14 points
MONT_N = 1 << 22
GP_B, GP_S = 32, 1 << 15
POINTS_N = 1 << 14


def log(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def card_info() -> str:
    """Name and power limit of each card, from a child that never imports
    JAX (so it holds no device memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase0(want_devices: int):
    import jax
    devs = jax.devices()
    plat = devs[0].platform
    print(f"jax {jax.__version__}; devices {devs}", flush=True)
    print(f"platform {plat}; device_kind {devs[0].device_kind}; "
          f"count {len(devs)}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    if plat != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {plat!r}); "
              f"this test runs on a GPU only", file=sys.stderr)
        sys.exit(2)
    if len(devs) < want_devices:
        print(f"chip_smoke: need {want_devices} GPUs, JAX sees "
              f"{len(devs)}", file=sys.stderr)
        sys.exit(2)
    from jolt_tpu.utils.caches import enable_persistent_compilation_cache
    print(f"compile cache: {enable_persistent_compilation_cache(jax)}",
          flush=True)
    print("cards (nvidia-smi name, power.limit):", flush=True)
    print(card_info(), flush=True)
    from jolt_tpu import backend
    from jolt_tpu.field import mont_kernel
    t0 = time.perf_counter()
    mont_kernel.register()
    print(f"CUDA Montgomery kernel built and registered in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(f"backend profile: {backend.profile()}", flush=True)
    return devs


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def limbs_to_ints(limbs) -> list:
    """uint32 [16, N] canonical 16-bit limbs -> N Python ints (vectorized
    through bytes; the per-limb loop of fd.unpack_ints is too slow at 2^22)."""
    import numpy as np
    arr = np.ascontiguousarray(np.asarray(limbs).reshape(16, -1).T
                               .astype("<u2"))
    raw = arr.tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(arr.shape[0])]


def ints_to_limbs(vals):
    import numpy as np
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, 16).T.astype(
        np.uint32)


def rand_canonical(rng, spec, n):
    """n uniform-ish canonical residues (< p) as uint32 [16, n] limbs."""
    import numpy as np
    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    top = int(spec.p_limbs[-1])
    a[-1] = rng.integers(0, top, size=n, dtype=np.uint32)   # < p
    return a


def assert_equal(name, got, want):
    import numpy as np
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    bad = int((g != w).sum())
    assert bad == 0, f"{name}: {bad} differing limbs"


def timed(fn, *args, reps=10):
    """Mean device time of fn(*args) over reps, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase1_field_ops():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jolt_tpu.field import device as fd, fq_spec, fr_spec
    from jolt_tpu.field.mont_kernel import field_op

    n = MONT_N
    plain = {"mul": fd._xla_mul, "add": fd._fadd_impl, "sub": fd._fsub_impl}
    host = {"mul": lambda s, x, y: x * y * s.r_inv % s.p,
            "add": lambda s, x, y: (x + y) % s.p,
            "sub": lambda s, x, y: (x - y) % s.p}
    for spec in (fr_spec(), fq_spec()):
        rng = np.random.default_rng(11)
        a = rand_canonical(rng, spec, n)
        b = rand_canonical(rng, spec, n)
        edges = [0, 1, spec.p - 1, spec.r]
        k = len(edges)
        a[:, :k * k] = ints_to_limbs([x for x in edges for _ in edges])
        b[:, :k * k] = ints_to_limbs([y for _ in edges for y in edges])
        a, b = jnp.asarray(a), jnp.asarray(b)
        # host oracle: the edge pairs + a random sample of lanes
        idx = np.concatenate([np.arange(k * k),
                              rng.choice(n, min(n, 1 << 14), replace=False)])
        ai = limbs_to_ints(np.asarray(a)[:, idx])
        bi = limbs_to_ints(np.asarray(b)[:, idx])
        for op in ("mul", "add", "sub"):
            kern = jax.jit(lambda x, y, op=op: field_op(op, spec, x, y))
            xla = jax.jit(lambda x, y, op=op: plain[op](spec, x, y))
            got = kern(a, b)
            assert_equal(f"{op} {spec.name} kernel vs XLA", got, xla(a, b))
            gi = limbs_to_ints(np.asarray(got)[:, idx])
            bad = [j for j, (x, y, z) in enumerate(zip(ai, bi, gi))
                   if z != host[op](spec, x, y)]
            assert not bad, f"{op} {spec.name} vs host oracle: lanes {bad[:8]}"
            t_k, t_x = timed(kern, a, b), timed(xla, a, b)
            log(f"{op} {spec.name} n={n}: bit-exact vs XLA and host "
                f"({len(idx)} lanes); kernel {t_k * 1e3:.3f} ms "
                f"({n / t_k / 1e9:.2f} G/s), XLA {t_x * 1e3:.3f} ms "
                f"({n / t_x / 1e9:.2f} G/s)")


def _gp_round_fns(kernel: bool):
    """(evals, bind) traced under a profile with the field kernels on or
    off (fresh jits, so the module-level caches do not leak across)."""
    import jax
    from jolt_tpu import backend
    from jolt_tpu.subprotocols import grand_product as gp
    mk = backend.profile().mont_kernel_min if kernel else 0
    spec_ = gp.fr_spec()

    def evals(l, r, eq, coeffs):
        with backend.use(mont_kernel_min=mk):
            return gp._pair_cubic_evals.__wrapped__(spec_, l, r, eq, coeffs)

    def bind(l, r, eq, rc):
        with backend.use(mont_kernel_min=mk):
            return gp._pair_bind.__wrapped__(spec_, l, r, eq, rc)

    return jax.jit(evals), jax.jit(bind)


def phase1_gp_round():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jolt_tpu.field import device as fd, fr_spec
    from jolt_tpu.subprotocols import grand_product as gp

    spec = fr_spec()
    B, s = GP_B, GP_S
    rng = np.random.default_rng(7)
    mk = lambda *shape: jnp.asarray(
        rand_canonical(rng, spec, int(np.prod(shape)))).reshape(
            (16,) + shape)
    l = jnp.moveaxis(mk(B, s), 0, 1)          # [B, L, s]
    r = jnp.moveaxis(mk(B, s), 0, 1)
    eq = mk(s)
    coeffs = mk(B)
    rc = mk(1)[:, 0]
    ev_k, bd_k = _gp_round_fns(True)
    ev_x, bd_x = _gp_round_fns(False)
    got_e, want_e = ev_k(l, r, eq, coeffs), ev_x(l, r, eq, coeffs)
    assert_equal("GP cubic evals kernel vs XLA", got_e, want_e)
    got_b, want_b = bd_k(l, r, eq, rc), bd_x(l, r, eq, rc)
    for name, g, w in zip(("l", "r", "eq"), got_b, want_b):
        assert_equal(f"GP bind {name} kernel vs XLA", g, w)
    # host oracle (grand_product's big-int mirror of the round)
    p = spec.p
    to_ints = lambda t: limbs_to_ints(fd.from_mont_device(spec, t))
    rows = lambda t: [to_ints(t[b]) for b in range(B)]
    ll, rr, eqh = rows(l), rows(r), to_ints(eq)
    co = to_ints(coeffs)
    e_host = gp._host_cubic_evals(p, ll, rr, eqh, co)
    assert to_ints(got_e) == list(e_host), "GP cubic evals vs host oracle"
    rci = to_ints(rc[:, None])[0]
    assert [to_ints(got_b[0][b]) for b in range(B)] == \
        gp._host_bind(p, ll, rci), "GP bind (l) vs host oracle"
    assert to_ints(got_b[2]) == gp._host_bind(p, [eqh], rci)[0], \
        "GP bind (eq) vs host oracle"
    for name, fn, args in (("evals", ev_k, (l, r, eq, coeffs)),
                           ("bind", bd_k, (l, r, eq, rc))):
        ma = fn.lower(*args).compile().memory_analysis()
        log(f"GP round {name} memory_analysis: {ma}")
    t = {k: timed(fn, *args) for k, fn, args in (
        ("evals kernel", ev_k, (l, r, eq, coeffs)),
        ("evals XLA", ev_x, (l, r, eq, coeffs)),
        ("bind kernel", bd_k, (l, r, eq, rc)),
        ("bind XLA", bd_x, (l, r, eq, rc)))}
    muls = (s // 2) * (B * 7 + 4)
    log(f"GP round B={B} s={s}: bit-exact vs XLA and host; " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in t.items())
        + f"; round field-muls/s kernel "
        f"{muls / (t['evals kernel'] + t['bind kernel']) / 1e9:.3f} G, XLA "
        f"{muls / (t['evals XLA'] + t['bind XLA']) / 1e9:.3f} G")


def phase1_points():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jolt_tpu import backend
    from jolt_tpu.curve import device as cd
    from jolt_tpu.curve.bn254 import G1Jacobian
    from jolt_tpu.commitment.kzg import srs_setup
    from jolt_tpu.field import device as fd

    n = POINTS_N
    pk, _ = srs_setup(n)                        # committed fixture points
    X, Y, Z = pk.g1_jac
    host = cd.jacobian_to_host(X, Y, Z)
    aff = [p.to_affine() for p in host]
    # p1: the points; p2: the points shifted by one, except lanes 0-15
    # (P+P), 16-31 (P+(-P)), 32-39 (p1 infinity), 40-47 (p2 infinity)
    p2_aff = aff[1:] + aff[:1]
    p2_aff[:16] = aff[:16]
    p2_aff[16:32] = [a.neg() for a in aff[16:32]]
    x1, y1, _ = cd.points_to_device(aff)
    x2, y2, _ = cd.points_to_device(p2_aff)
    one = fd.ones(cd.FQ, (n,))
    z1 = jnp.where(jnp.arange(n)[None] // 8 == 4, 0, one)
    z2 = jnp.where(jnp.arange(n)[None] // 8 == 5, 0, one)
    P1, P2 = (x1, y1, z1), (x2, y2, z2)
    h1 = [G1Jacobian.identity() if 32 <= i < 40 else a.to_jacobian()
          for i, a in enumerate(aff)]
    h2 = [G1Jacobian.identity() if 40 <= i < 48 else a.to_jacobian()
          for i, a in enumerate(p2_aff)]
    # projective inputs for the complete add: identity is (0:1:0)
    zero = jnp.zeros_like(one)
    q1 = (jnp.where(z1 == 0, zero, x1), jnp.where(z1 == 0, one, y1), z1)
    q2 = (jnp.where(z2 == 0, zero, x2), jnp.where(z2 == 0, one, y2), z2)

    mk = backend.profile().mont_kernel_min
    ops = {
        "jac_add": (lambda a, b: cd.jac_add(a, b), (P1, P2), cd.jacobian_to_host,
                    [a.add(b) for a, b in zip(h1, h2)]),
        "jac_double": (lambda a: cd.jac_double(*a), (P1,), cd.jacobian_to_host,
                       [a.double() for a in h1]),
        "proj_cadd": (lambda a, b: cd.proj_cadd(a, b), (q1, q2),
                      cd.proj_to_host_jac, [a.add(b) for a, b in zip(h1, h2)]),
    }
    for name, (fn, args, to_host, want) in ops.items():
        def run(kernel_min, fn=fn):
            def f(*a):
                with backend.use(mont_kernel_min=kernel_min):
                    return fn(*a)
            return jax.jit(f)
        k_fn, x_fn = run(mk), run(0)
        got, ref = k_fn(*args), x_fn(*args)
        for g, w in zip(got, ref):
            assert_equal(f"{name} kernel vs XLA", g, w)
        got_aff = [p.to_affine() for p in to_host(*got)]
        want_aff = [p.to_affine() for p in want]
        bad = [i for i, (g, w) in enumerate(zip(got_aff, want_aff)) if g != w]
        assert not bad, f"{name} vs host oracle: lanes {bad[:8]}"
        t_k, t_x = timed(k_fn, *args), timed(x_fn, *args)
        log(f"{name} n={n} (P+P, P-P, infinity lanes): bit-exact vs XLA "
            f"and host; kernels {t_k * 1e3:.3f} ms, XLA "
            f"{t_x * 1e3:.3f} ms")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase2_fib_mini():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_ark_proof import FIXDIR, _mini_proof, _serialize
    vm, pre, proof, commitments = _mini_proof()
    blob = _serialize(vm, pre, proof, commitments)
    with open(os.path.join(FIXDIR, "fib_mini.bin"), "rb") as f:
        want = f.read()
    assert blob == want, "GPU mini-fib proof bytes differ from the CPU fixture"
    log(f"mini-VM fib(3) HyperKZG proof: {len(blob)} bytes, equal to the "
        f"CPU fixture")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase3_sha2_chain(runs=("cold", "warm")) -> dict:
    import jax
    from jolt_tpu import backend
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import fr_spec
    from jolt_tpu.utils import profiling
    from jolt_tpu.vm.guests import sha2_chain_expected, sha2_chain_program
    from jolt_tpu.vm.host import trace_program
    from jolt_tpu.vm.rv32i_vm import rv32i_vm

    profiling.count_programs()
    profiling.reset_programs()
    spec = fr_spec()
    vm = rv32i_vm(spec)
    inputs = b"\x05" * 32
    steps, device, bytecode_rows = trace_program(sha2_chain_program(1), vm,
                                                 inputs=inputs)
    assert bytes(device.outputs)[:32] == sha2_chain_expected(inputs, 1), \
        "sha2-chain guest output differs from hashlib"
    log(f"sha2-chain(1): trace length {len(steps)}; output matches hashlib")
    t0 = time.perf_counter()
    pcs = HyperKZG.setup(vm.required_srs_len(device, steps, bytecode_rows))
    pre = vm.preprocess(bytecode_rows, pcs)
    log(f"SRS + preprocess {time.perf_counter() - t0:.1f}s")
    out = {"trace_length": len(steps)}
    for run in runs:
        st0 = profiling.program_stats()
        t0 = time.perf_counter()
        proof, commitments, pt, pacc = vm.prove(device, steps, pre)
        dt = time.perf_counter() - t0
        st = profiling.program_stats()
        out[f"prove_{run}_s"] = dt
        log(f"prove ({run}): {dt:.3f}s; programs compiled "
            f"{st['count'] - st0['count']} in "
            f"{st['seconds'] - st0['seconds']:.1f}s")
    t0 = time.perf_counter()
    vm.verify(pre, proof, commitments, debug_transcript=pt,
              debug_accumulator=pacc)
    out["verify_s"] = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    prof = backend.profile()
    log(f"verify: {out['verify_s']:.3f}s (host transcript replay agrees)")
    log(f"programs compiled in all: {profiling.program_stats()}")
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    log(f"profile in force: {prof}; rounds run off the GPU: "
        f"{backend.offloaded_rounds()}")
    return out


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase4_four():
    import __graft_entry__ as ge
    ge.dryrun_multichip(4)
    log("multi-GPU dryrun: stages 1-5 passed")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh path (phase 4)")
    args = ap.parse_args()
    devs = phase0(4 if args.four else 1)
    if args.four:
        phase4_four()
    else:
        phase1_field_ops()
        phase1_gp_round()
        phase1_points()
        phase2_fib_mini()
        phase3_sha2_chain()
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
