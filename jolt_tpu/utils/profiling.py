"""Tracing spans + cumulative timing (aux-subsystem parity).

Reference: `#[tracing::instrument]` spans on every significant function and
the `CumulativeTimingLayer` that sums same-name span durations
(jolt-core/src/benches/sum_timer.rs:12-118), plus labeled memory deltas
(utils/profiling.rs:17-74).

Usage:
    with span("prove_grand_product"):
        ...
    print_cumulative()      # name, calls, total seconds (sorted)

Spans nest; each span also emits a `jax.named_scope` so device work shows up
under the same labels in the JAX/XLA profiler trace viewer.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_ops: dict[str, int] = defaultdict(int)
_enabled = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _ops.clear()


@contextlib.contextmanager
def span(name: str, ops: int = 0):
    """Time a region (cumulative per name) + tag device ops for the profiler.

    ``ops``: optional field-multiply count the region performs; cumulative
    per name, reported as achieved ops/s of host wall time (the
    reference's analog is per-span memory/timing instrumentation,
    utils/profiling.rs:17-74 + sum_timer.rs)."""
    if not _enabled:
        yield
        return
    import os
    import sys
    import jax
    live = os.environ.get("JOLT_SPAN_LOG", "") not in ("", "0")
    if live:
        print(f"[span] > {name}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    with jax.named_scope(name):
        yield
    dt = time.perf_counter() - t0
    if live:
        print(f"[span] < {name} {dt:.2f}s", file=sys.stderr, flush=True)
    with _lock:
        _totals[name] += dt
        _counts[name] += 1
        _ops[name] += ops


def cumulative() -> list[tuple[str, int, float, int]]:
    with _lock:
        rows = [(k, _counts[k], _totals[k], _ops[k]) for k in _totals]
    return sorted(rows, key=lambda r: -r[2])


def print_cumulative() -> None:
    rows = cumulative()
    if not rows:
        return
    width = max(len(r[0]) for r in rows)
    print(f"{'span'.ljust(width)}  calls  total_s  Mmuls/s")
    for name, calls, total, ops in rows:
        rate = f"{ops / total / 1e6:7.1f}" if ops and total > 0 else "      -"
        print(f"{name.ljust(width)}  {calls:5d}  {total:8.3f}  {rate}")


# ---------------------------------------------------------------------------
# Compiled-program accounting: compile time is set-up cost.  Wrapping
# compile_or_get_cached counts exactly the per-process first-use events
# (jit reuses the in-memory executable afterwards), including
# persistent-cache loads.
# ---------------------------------------------------------------------------

_programs: list = []          # (name, seconds) per first-use load
_programs_installed = False


def count_programs(on: bool = True) -> None:
    """Install (or remove) the compiled-program counter."""
    global _programs_installed
    from jax._src import compiler as _jc
    if on and not _programs_installed:
        orig = _jc.compile_or_get_cached

        def wrapper(backend, computation, devices, compile_options,
                    *args, **kwargs):
            try:
                name = computation.operation.attributes["sym_name"].value
            except Exception:
                name = "<module>"
            t0 = time.perf_counter()
            out = orig(backend, computation, devices, compile_options,
                       *args, **kwargs)
            _programs.append((name, time.perf_counter() - t0))
            return out

        wrapper._jolt_orig = orig
        _jc.compile_or_get_cached = wrapper
        _programs_installed = True
    elif not on and _programs_installed:
        _jc.compile_or_get_cached = _jc.compile_or_get_cached._jolt_orig
        _programs_installed = False


def reset_programs() -> None:
    _programs.clear()


def program_stats(top: int = 0) -> dict:
    """{'count': N, 'seconds': total_compile_s, 'top': [(name, s), ...]}"""
    out = {"count": len(_programs),
           "seconds": round(sum(s for _, s in _programs), 3)}
    if top:
        out["top"] = sorted(_programs, key=lambda r: -r[1])[:top]
    return out


def print_programs(top: int = 20) -> None:
    st = program_stats(top=top)
    print(f"compiled programs: {st['count']}  "
          f"compile total {st['seconds']:.1f}s")
    for name, s in st.get("top", []):
        print(f"  {s:8.2f}s  {name}")


@contextlib.contextmanager
def jax_trace(log_dir: str):
    """Capture a JAX profiler trace (Perfetto-compatible) for the region —
    the reference's tracing-chrome layer analog (jolt-core/src/main.rs:96)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
