"""Backend policy: one profile per platform decides every backend-dependent
path of the prover.

Platforms are ``gpu`` (the target: one or more NVIDIA H100s) and ``cpu``
(the test suite and rehearsals).  Any other platform raises — there is no
default profile.  The choices are execution strategies only: every profile
proves the same statement with byte-identical transcripts.

Fields:

* ``ks_carries``     limb carries as Kogge-Stone lookahead (log-depth,
                     elementwise — fuses on a GPU) instead of ``lax.scan``
                     chains (one tight loop on XLA:CPU).
* ``mont_kernel_min`` field multiplies, adds and subtracts over at least
                     this many elements take the CUDA kernels
                     (``field/mont_kernel``); 0 keeps every op on the plain
                     XLA path.
* ``device_fs``      Fiat-Shamir chains on the device (no host sync per
                     sumcheck round; the host replays and checks the chain).
* ``masked_rounds``  fixed-shape masked sumcheck/GP rounds: one compiled
                     program per protocol instance instead of one per
                     halving shape.
* ``chain``          device-chained grand products (one pull per GP);
                     effective only together with ``device_fs``.
* ``host_tail``      GP layers and sumcheck rounds whose per-side size is at
                     or below this finish as host big integers; 0 disables.

Tests force a path through ``use(...)`` or these environment overrides
(read here and nowhere else): JOLT_TPU_DEVICE_FS, JOLT_TPU_MASKED,
JOLT_TPU_CHAIN (``1``/``0``) and JOLT_TPU_HOST_TAIL (an int).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import jax


@dataclasses.dataclass(frozen=True)
class Profile:
    platform: str
    ks_carries: bool
    mont_kernel_min: int
    device_fs: bool
    masked_rounds: bool
    chain: bool
    host_tail: int


PROFILES = {
    # The CPU test suite's settings: per-shape shrinking rounds (cheap,
    # disk-cached XLA:CPU compiles; masked rounds would run every round at
    # full size) and host-bigint tails below 512 per side.
    "cpu": Profile("cpu", ks_carries=False, mont_kernel_min=0,
                   device_fs=False, masked_rounds=False, chain=False,
                   host_tail=512),
    # H100: the accelerator settings.  CUDA kernels for every field op
    # (compile and run time, PERF.md); device FS, masked rounds and chained
    # GPs remove per-round host syncs and per-shape compiles.
    "gpu": Profile("gpu", ks_carries=True, mont_kernel_min=1,
                   device_fs=True, masked_rounds=True, chain=True,
                   host_tail=0),
}

_ENV_BOOL = {"device_fs": "JOLT_TPU_DEVICE_FS",
             "masked_rounds": "JOLT_TPU_MASKED",
             "chain": "JOLT_TPU_CHAIN"}
_ENV_INT = {"host_tail": "JOLT_TPU_HOST_TAIL"}

_overrides: dict = {}
_offloaded = [0]


@functools.lru_cache(maxsize=1)
def platform() -> str:
    """The default backend's platform; raises on anything but gpu/cpu."""
    plat = jax.default_backend()
    if plat not in PROFILES:
        raise RuntimeError(
            f"unsupported JAX platform {plat!r}: jolt_tpu runs on 'gpu' "
            f"(CUDA) or 'cpu' only")
    return plat


def profile() -> Profile:
    """The active profile: the platform's, then env overrides, then use()."""
    base = PROFILES[platform()]
    changes = {}
    for field, var in _ENV_BOOL.items():
        v = os.environ.get(var)
        if v is not None:
            changes[field] = v not in ("0", "")
    for field, var in _ENV_INT.items():
        v = os.environ.get(var)
        if v is not None:
            changes[field] = int(v)
    changes.update(_overrides)
    prof = dataclasses.replace(base, **changes) if changes else base
    if "chain" not in changes and not prof.device_fs:
        prof = dataclasses.replace(prof, chain=False)
    return prof


@contextlib.contextmanager
def use(**changes):
    """Override profile fields for a block.  Fields read while tracing
    (``ks_carries``, ``mont_kernel_min``) only reach programs traced inside
    the block: call ``jax.clear_caches()`` to retrace cached ones."""
    unknown = set(changes) - {f.name for f in dataclasses.fields(Profile)}
    if unknown:
        raise TypeError(f"unknown profile fields {sorted(unknown)}")
    saved = dict(_overrides)
    _overrides.update(changes)
    try:
        yield profile()
    finally:
        _overrides.clear()
        _overrides.update(saved)


def note_offload(rounds: int) -> None:
    """Count sumcheck/GP rounds proved off the default device (host-tail
    big integers or the CPU tail device)."""
    _offloaded[0] += rounds


def offloaded_rounds() -> int:
    return _offloaded[0]
