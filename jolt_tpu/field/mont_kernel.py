"""BN254 field kernels for NVIDIA GPUs — Montgomery multiply, modular add
and subtract — CUDA called through the XLA foreign function interface
(targets ``jolt_mont_mul``, ``jolt_mont_add``, ``jolt_mont_sub``).

Same layout as ``field/device.py``: 16 little-endian 16-bit limbs in
uint32, Montgomery form with R = 2^256.  One thread per element packs the
limbs into 8 32-bit words, computes in registers and unpacks
(``native/mont_mul.h``): the multiply is CIOS with 64-bit partial products
and one conditional subtraction.  Per element a kernel reads 128 B and
writes 64 B; the plain XLA multiply materialises ~2 KB of f32 column
products per element per schoolbook, and the plain add/sub are log-depth
carry graphs of ~190 HLO lines each.  Results equal the plain path
(``_mont_redc(_carry(_mul_columns(...)))``, ``_fadd_impl``,
``_fsub_impl``) bit for bit.

The library is built from ``native/mont_mul.cu`` with nvcc (sm_90a) on
first use into ``native/_build`` (gitignored) and registered once per
process; a failed build raises.  Each compiled XLA program then references
the prebuilt kernels, so they add nothing to per-program compile time.
The kernels have no interpret mode: ``field_op_host`` runs the same
arithmetic (the shared header) built for the host with g++, for the CPU
tests.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from .spec import NUM_LIMBS, FieldSpec

L = NUM_LIMBS
OPS = {"mul": 0, "add": 1, "sub": 2}        # enum JoltFieldOp in mont_mul.h
TARGETS = {"mul": ("jolt_mont_mul", "JoltMontMul"),
           "add": ("jolt_mont_add", "JoltMontAdd"),
           "sub": ("jolt_mont_sub", "JoltMontSub")}
_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_BUILD = os.path.join(_NATIVE, "_build")
_LOCK = threading.Lock()


def _build(stem: str, sources: tuple, cmd) -> str:
    """Build a shared library from native/ sources once per content hash;
    ``cmd(out_path, source_paths)`` gives the compiler command."""
    paths = [os.path.join(_NATIVE, s) for s in sources]
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD, f"{stem}-{h.hexdigest()[:16]}.so")
    with _LOCK:
        if not os.path.exists(out):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = out + f".tmp{os.getpid()}"
            res = subprocess.run(cmd(tmp, paths), capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building {stem} failed:\n{res.stderr}")
            os.replace(tmp, out)
    return out


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): cannot build the GPU kernel")
    return nvcc


@functools.cache
def register() -> None:
    """Build the CUDA library and register the FFI targets (once)."""
    so = _build("libjolt_mont_mul", ("mont_mul.h", "mont_mul.cu"),
                lambda out, src: [
                    _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", _NATIVE, "-I", jax.ffi.include_dir(),
                    "-o", out, src[1]])
    lib = ctypes.cdll.LoadLibrary(so)
    for target, symbol in TARGETS.values():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")


@functools.cache
def _consts(spec: FieldSpec) -> np.ndarray:
    """uint32[9]: p as 8 little-endian 32-bit words, n0 = -p^-1 mod 2^32."""
    words = [(spec.p >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    return np.asarray(words + [n0], dtype=np.uint32)


def _as3(a, b, batch_leading: bool):
    """Broadcast the operands and view them as [P, 16, Q]."""
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    a = jnp.broadcast_to(a, shape)
    b = jnp.broadcast_to(b, shape)
    if batch_leading:
        return a, b, shape
    return a.reshape((1, L, -1)), b.reshape((1, L, -1)), shape


def field_op(op: str, spec: FieldSpec, a, b, *,
             batch_leading: bool = False):
    """op(a, b) through the CUDA kernel: ``mul`` is the Montgomery product
    a * b * R^-1 mod p, ``add``/``sub`` are (a +/- b) mod p.

    Limb-leading operands ``[L, ...]`` (the ``fd`` layout) or, with
    ``batch_leading``, ``[B, L, s]`` (the GP pair layout); shapes may
    broadcast.  Traceable anywhere; runs on a CUDA device only."""
    a3, b3, shape = _as3(a, b, batch_leading)
    if jax.default_backend() == "gpu":
        register()
    out = jax.ffi.ffi_call(TARGETS[op][0],
                           jax.ShapeDtypeStruct(a3.shape, jnp.uint32))(
        a3, b3, jnp.asarray(_consts(spec)))
    return out.reshape(shape)


@functools.cache
def _host_lib():
    so = _build("libjolt_mont_mul_host", ("mont_mul.h", "mont_mul_host.cc"),
                lambda out, src: ["g++", "-O2", "-std=c++17", "-shared",
                                  "-fPIC", "-I", _NATIVE, "-o", out, src[1]])
    lib = ctypes.CDLL(so)
    p = ctypes.POINTER(ctypes.c_uint32)
    lib.jolt_field_op_host.argtypes = [ctypes.c_int, p, p, p, p,
                                       ctypes.c_int64, ctypes.c_int64]
    return lib


def field_op_host(op: str, spec: FieldSpec, a, b, *,
                  batch_leading: bool = False) -> np.ndarray:
    """The kernels' arithmetic and layout handling, built for the host
    (tests): same inputs and results as ``field_op``, as numpy."""
    a3, b3, shape = _as3(a, b, batch_leading)
    a3 = np.ascontiguousarray(a3, dtype=np.uint32)
    b3 = np.ascontiguousarray(b3, dtype=np.uint32)
    out = np.empty_like(a3)
    ptr = lambda t: t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    _host_lib().jolt_field_op_host(OPS[op], ptr(a3), ptr(b3),
                                   ptr(_consts(spec)), ptr(out),
                                   a3.shape[0], a3.shape[2])
    return out.reshape(shape)
