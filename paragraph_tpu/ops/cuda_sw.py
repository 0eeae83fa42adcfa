"""JAX binding of the CUDA paired graph-SW fill (native/graph_sw_cuda.cu).

The library is built from the repository's sources by ``make -C native
cuda`` (nvcc, ``sm_90a``) into ``native/``, which ``.gitignore`` lists. It
is built on first use when missing or older than its source, and
registered with XLA as an FFI target for the CUDA platform. A failed
build or load raises: there is no fallback engine.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

import jax
import jax.numpy as jnp

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "graph_sw_cuda.cu")
LIB_PATH = os.path.join(_NATIVE_DIR, "libgraph_sw_cuda.so")
TARGET = "paragraph_paired_fill"

_lock = threading.Lock()
_registered = False


def build(force: bool = False) -> str:
    """Compile the CUDA library if it is missing, stale, or `force`d."""
    if force or not os.path.exists(LIB_PATH) or (
            os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC)):
        cmd = ["make", "-C", _NATIVE_DIR, "cuda"] + (["-B"] if force else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {LIB_PATH} failed:\n{proc.stdout}{proc.stderr}")
    return LIB_PATH


def register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.ParagraphPairedFill),
            platform="CUDA")
        _registered = True


def cuda_fill(packed_cols, pred_tables, tile_col_start, tile_col_len,
              tile_event, x, lens, vlens, *, N: int, P: int, M: int,
              TB: int, col_bits: int, j_bits: int, gap_open: int,
              gap_extend: int, match: int, mismatch: int):
    """[4, B] int32 (score, end column, end read row, multi flag) for the
    expanded read codes x [B, M]; see xla_fill in multi_sw.py for the
    semantics both engines share."""
    register()
    B = x.shape[0]
    out_types = (
        jax.ShapeDtypeStruct((4, B), jnp.int32),
        # scratch: boundary H/E columns and per-node maxima per read lane
        jax.ShapeDtypeStruct((B, N, 2, M), jnp.int32),
        jax.ShapeDtypeStruct((B, N), jnp.int32),
    )
    out, _, _ = jax.ffi.ffi_call(TARGET, out_types)(
        packed_cols, pred_tables, tile_col_start, tile_col_len, tile_event,
        x.astype(jnp.int8), lens, vlens,
        n_nodes=np.int32(N), n_preds=np.int32(P), tile_batch=np.int32(TB),
        gap_open=np.int32(gap_open), gap_extend=np.int32(gap_extend),
        match=np.int32(match), mismatch=np.int32(mismatch),
        col_bits=np.int32(col_bits), j_bits=np.int32(j_bits))
    return out
