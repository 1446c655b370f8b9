"""The fused Montgomery-multiply kernel (field/mont_kernel.py) and the
backend policy that picks it (backend.py).

The CUDA kernel has no interpret mode.  On the CPU its arithmetic and
layout handling run as the host build of the same source
(``field_op_host``), which must equal the plain XLA path
(``_mont_redc(_carry(_mul_columns(...)))``) and the host big-int oracle
bit for bit; the dispatch is checked on traced programs.  Tests marked
``gpu`` run the kernel compiled for the card and skip elsewhere."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jolt_tpu import backend
from jolt_tpu.field import device as fd
from jolt_tpu.field import fq_spec, fr_spec
from jolt_tpu.field.mont_kernel import field_op, field_op_host

SPECS = [fr_spec(), fq_spec()]


def _operands(spec, n, seed):
    """n random Montgomery residues per operand; the first 16 lanes pair
    every edge value 0, 1, p-1, R mod p with every other."""
    rng = random.Random(seed)
    edges = [0, 1, spec.p - 1, spec.r]
    xs = [x for x in edges for _ in edges]
    ys = [y for _ in edges for y in edges]
    xs += [rng.randrange(spec.p) for _ in range(n - len(xs))]
    ys += [rng.randrange(spec.p) for _ in range(n - len(ys))]
    canon = lambda v: jnp.asarray(fd.pack_ints(v))      # raw limbs
    return xs, ys, canon(xs), canon(ys)


def _plain(spec, a, b):
    return fd._mont_redc(spec, fd._carry(fd._mul_columns(a, b)))


def _host(spec, xs, ys):
    return [x * y * spec.r_inv % spec.p for x, y in zip(xs, ys)]


def mont_mul_host(spec, a, b, **kw):
    return field_op_host("mul", spec, a, b, **kw)


@pytest.mark.parametrize("spec", SPECS, ids=["fr", "fq"])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_kernels_match_plain_and_host(spec, op):
    """Modular add/sub: the host build equals fd's plain carry graphs and
    the big-int oracle, edge values included."""
    xs, ys, a, b = _operands(spec, 150, seed=23)
    got = field_op_host(op, spec, a, b)
    plain = fd._fadd_impl if op == "add" else fd._fsub_impl
    np.testing.assert_array_equal(got, np.asarray(plain(spec, a, b)))
    sign = 1 if op == "add" else -1
    assert [int(v) for v in fd.unpack_ints(got)] == \
        [(x + sign * y) % spec.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("spec", SPECS, ids=["fr", "fq"])
@pytest.mark.parametrize("n", [200, 128, 17], ids=["ragged", "pow2", "tiny"])
def test_kernel_matches_plain_and_host(spec, n):
    xs, ys, a, b = _operands(spec, n, seed=n)
    got = mont_mul_host(spec, a, b)
    want = _plain(spec, a, b)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert [int(v) for v in fd.unpack_ints(got)] == _host(spec, xs, ys)


@pytest.mark.parametrize("spec", SPECS, ids=["fr", "fq"])
def test_kernel_batch_leading_layout(spec):
    """[B, L, s] operands are indexed in place, no transpose: same bits
    as the limb-leading plain path on the moved axes."""
    xs, ys, a, b = _operands(spec, 3 * 40, seed=7)
    a3 = jnp.moveaxis(a.reshape(fd.L, 3, 40), 0, 1)
    b3 = jnp.moveaxis(b.reshape(fd.L, 3, 40), 0, 1)
    got = mont_mul_host(spec, a3, b3, batch_leading=True)
    assert got.shape == (3, fd.L, 40)
    want = _plain(spec, a.reshape(fd.L, 3, 40), b.reshape(fd.L, 3, 40))
    np.testing.assert_array_equal(np.asarray(jnp.moveaxis(got, 1, 0)),
                                  np.asarray(want))


def test_kernel_broadcast_operands():
    spec = fr_spec()
    _, _, a, b = _operands(spec, 2 * 24, seed=3)
    a = a.reshape(fd.L, 2, 24)
    b_col = b.reshape(fd.L, 2, 24)[:, :1, :]           # [L, 1, 24]
    b_one = b[:, :1].reshape(fd.L, 1, 1)               # [L, 1, 1]
    for bb in (b_col, b_one):
        got = mont_mul_host(spec, a, bb)
        want = _plain(spec, a, jnp.broadcast_to(bb, a.shape))
        assert got.shape == a.shape
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _has_kernel(fn, *args, target="jolt_mont_mul") -> bool:
    # a fresh lambda per call: make_jaxpr caches traces per function
    jaxpr = str(jax.make_jaxpr(lambda *a: fn(*a))(*args))
    return target in jaxpr


def test_policy_picks_kernel_above_threshold():
    """fmul traces the kernel for batches >= mont_kernel_min, the plain
    path below it and whenever the threshold is 0 (the cpu profile)."""
    spec = fr_spec()
    small = jnp.zeros((fd.L, 8), jnp.uint32)
    big = jnp.zeros((fd.L, 4, 8), jnp.uint32)           # batch 32
    mul = lambda x, y: fd.fmul(spec, x, y)
    assert backend.profile().mont_kernel_min == 0
    assert not _has_kernel(mul, big, big)
    with backend.use(mont_kernel_min=32):
        assert _has_kernel(mul, big, big)
        assert not _has_kernel(mul, small, small)
        assert _has_kernel(lambda x, y: fd.fmul_bl(spec, x, y),
                           jnp.zeros((4, fd.L, 8), jnp.uint32),
                           jnp.zeros((4, fd.L, 8), jnp.uint32))
        for op, target in ((fd.fadd, "jolt_mont_add"),
                           (fd.fsub, "jolt_mont_sub")):
            assert _has_kernel(lambda x, y: op(spec, x, y), big, big,
                               target=target)
        assert _has_kernel(lambda x: fd.from_mont_device(spec, x), big)


def test_kernel_call_shapes():
    """The traced FFI call sees [P, 16, Q] operands and the 9-word
    constants, and hands back the broadcast shape."""
    spec = fr_spec()
    a = jnp.zeros((fd.L, 3, 5), jnp.uint32)
    b = jnp.zeros((fd.L, 1, 5), jnp.uint32)
    out = jax.eval_shape(lambda x, y: field_op("mul", spec, x, y), a, b)
    assert out.shape == (fd.L, 3, 5) and out.dtype == jnp.uint32
    jaxpr = str(jax.make_jaxpr(lambda x, y: field_op("mul", spec, x, y))(a, b))
    assert "u32[1,16,15]" in jaxpr and "u32[9]" in jaxpr
    bl = jnp.zeros((4, fd.L, 6), jnp.uint32)
    out = jax.eval_shape(
        lambda x: field_op("mul", spec, x, x, batch_leading=True), bl)
    assert out.shape == (4, fd.L, 6)


def test_profile_env_overrides(monkeypatch):
    base = backend.profile()
    assert base.platform == "cpu" and not base.device_fs
    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "1")
    monkeypatch.setenv("JOLT_TPU_MASKED", "1")
    monkeypatch.setenv("JOLT_TPU_HOST_TAIL", "0")
    prof = backend.profile()
    assert prof.device_fs and prof.masked_rounds and prof.host_tail == 0
    assert not prof.chain                  # cpu default stays off
    monkeypatch.setenv("JOLT_TPU_CHAIN", "1")
    assert backend.profile().chain
    monkeypatch.setenv("JOLT_TPU_DEVICE_FS", "0")
    monkeypatch.delenv("JOLT_TPU_CHAIN")
    with backend.use(chain=True):
        assert backend.profile().chain      # explicit override wins
    with backend.use(device_fs=False):
        assert not backend.profile().chain  # chain needs device FS
    assert backend.profile() == dataclasses.replace(
        base, device_fs=False, masked_rounds=True, host_tail=0)


def test_profile_rejects_unknown_platform_and_field(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform.__wrapped__()
    with pytest.raises(TypeError, match="unknown profile fields"):
        with backend.use(no_such_field=1):
            pass


def test_gpu_profile_uses_kernel_and_device_paths():
    gpu = backend.PROFILES["gpu"]
    assert gpu.mont_kernel_min > 0 and gpu.ks_carries
    cpu = backend.PROFILES["cpu"]
    assert cpu.mont_kernel_min == 0 and not cpu.ks_carries


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=["fr", "fq"])
def test_compiled_kernel_matches_plain(gpu, spec):
    """The kernel as built for the card, at 2^20 lanes in both layouts."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    limbs = rng.integers(0, 1 << 16, size=(2, fd.L, n), dtype=np.uint32)
    limbs[:, -1] %= np.uint32(spec.p_limbs[-1])            # < p
    a, b = jnp.asarray(limbs[0]), jnp.asarray(limbs[1])
    want = jax.jit(lambda x, y: _plain(spec, x, y))(a, b)
    got = jax.jit(lambda x, y: field_op("mul", spec, x, y))(a, b)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    a3 = jnp.moveaxis(a.reshape(fd.L, 32, -1), 0, 1)
    b3 = jnp.moveaxis(b.reshape(fd.L, 32, -1), 0, 1)
    got3 = jax.jit(lambda x, y: field_op("mul", spec, x, y,
                                         batch_leading=True))(a3, b3)
    np.testing.assert_array_equal(
        np.asarray(jnp.moveaxis(got3, 1, 0)).reshape(fd.L, n),
        np.asarray(want))


@pytest.mark.gpu
@pytest.mark.parametrize("leading", ["limb", "batch"])
def test_policy_kernel_results_equal_plain(gpu, leading):
    """Through fmul / fmul_bl / fadd / fsub / from_mont with the kernels on
    and off, results are bit-identical."""
    spec = fq_spec()
    _, _, a, b = _operands(spec, 4 * 32, seed=11)
    a, b = a.reshape(fd.L, 4, 32), b.reshape(fd.L, 4, 32)
    if leading == "batch":
        a, b = jnp.moveaxis(a, 0, 1), jnp.moveaxis(b, 0, 1)
        op = lambda x, y: fd.fmul_bl(spec, x, y)
    else:
        op = lambda x, y: (fd.fmul(spec, x, y), fd.fadd(spec, x, y),
                           fd.fsub(spec, x, y), fd.from_mont_device(spec, x))
    with backend.use(mont_kernel_min=0):
        want = jax.jit(op)(a, b)
    with backend.use(mont_kernel_min=1):
        got = jax.jit(lambda x, y: op(x, y))(a, b)   # a fresh trace
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
