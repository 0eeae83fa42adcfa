"""Opt-in JAX profiler capture (SURVEY §5's tracing plan).

Set ``PARAGRAPH_TPU_PROFILE=/some/dir`` to wrap a pipeline run in a
``jax.profiler`` trace; the TensorBoard-loadable artifacts land in that
directory. Degrades to a no-op (with one warning) when the profiler is
unavailable or fails. Opt-in, because tracing slows the host and a
whole run's trace is large; chip_smoke.py traces short windows itself.
"""
from __future__ import annotations

import contextlib
import logging
import os

logger = logging.getLogger("paragraph_tpu")

ENV_VAR = "PARAGRAPH_TPU_PROFILE"


@contextlib.contextmanager
def maybe_profile(tag: str = "run"):
    """Context manager: captures a jax.profiler trace of the enclosed
    block into $PARAGRAPH_TPU_PROFILE/<tag> when the env var is set."""
    out_dir = os.environ.get(ENV_VAR)
    if not out_dir:
        yield
        return
    target = os.path.join(out_dir, tag)
    try:
        import jax

        os.makedirs(target, exist_ok=True)
        ctx = jax.profiler.trace(target)
    except Exception as exc:  # noqa: BLE001 — never break the run
        logger.warning("profiler unavailable (%s: %s); continuing "
                       "without a trace", type(exc).__name__, exc)
        yield
        return
    try:
        with ctx:
            yield
        logger.info("[profile] jax.profiler trace written to %s", target)
    except Exception as exc:  # noqa: BLE001
        logger.warning("profiler capture failed (%s: %s); run continued",
                       type(exc).__name__, exc)
