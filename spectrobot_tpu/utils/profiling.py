"""Tracing / profiling utilities (SURVEY.md section 6).

The reference (fedef17/SpectRobot) has no profiling beyond prints; here the
story is the JAX profiler: ``trace()`` captures an XProf/TensorBoard trace
of everything inside the context (kernels, collectives, host overhead), and
``annotate`` names physics stages so traces read as opacity -> RT -> ILS
instead of HLO soup.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/spectrobot_trace") -> Iterator[None]:
    """Capture a jax.profiler trace viewable in TensorBoard/XProf."""
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named scope for a physics stage (shows up in traces)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def stopwatch(label: str, sink=None) -> Iterator[None]:
    """Wall-clock a block; report to ``sink`` (RunLogger) or stderr."""
    import sys
    t0 = time.time()
    yield
    dt = time.time() - t0
    if sink is not None:
        sink.log({"stage": label, "wall_s": dt})
    else:
        print(f"[stopwatch] {label}: {dt:.3f}s", file=sys.stderr)
