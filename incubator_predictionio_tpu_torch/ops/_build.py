"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source file compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds. A source may include the shared headers of ``csrc/``
(``*.cuh``). Libraries land in ``build/kernels/`` at the repo root, named by
a hash of the source, every shared header and the compiler flags: an edited
source or header builds anew, an unchanged one loads what is there. Nothing here runs at
import time, and a failed build raises (the port never falls back to the
plain PyTorch version on a card). Each build's wall time is booked under
the library's name in ``utils/jitstats.py`` (``pio_jit_compile_seconds_total``,
``status``'s compile table): the port's counterpart of an XLA compile.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures of every exported function, per source file
SIGNATURES: dict[str, dict[str, tuple[list, object]]] = {
    "attention": {
        "pio_error_string": ([_I], ctypes.c_char_p),
        # q, k, v, out, m, l (both null when serving), B, H, L, D, stream
        "pio_causal_mha_small_head": ([_P] * 6 + [_I] * 4 + [_P], _I),
        # q, k, v, do, m, l, t (scratch), dq, dk, dv, B, H, L, D, stream
        "pio_causal_mha_small_head_bwd": ([_P] * 10 + [_I] * 4 + [_P], _I),
    },
    "flash_attention": {
        "pio_error_string": ([_I], ctypes.c_char_p),
        # q, k, v, out, m, l (both null when serving), B, H, L, D, stream
        "pio_flash_causal": ([_P] * 6 + [_I] * 4 + [_P], _I),
        # q, k, v, do, m, l, di, dk, dv, B, H, L, D, stream
        "pio_flash_causal_bwd_dkv": ([_P] * 9 + [_I] * 4 + [_P], _I),
        # q, k, v, do, m, l, di, dq, B, H, L, D, stream
        "pio_flash_causal_bwd_dq": ([_P] * 8 + [_I] * 4 + [_P], _I),
    },
    "retrieval": {
        "pio_error_string": ([_I], ctypes.c_char_p),
        # q, items, scale, bias, mask, row_mask, out, B, N, D, stream
        "pio_score_catalog": ([_P] * 7 + [_I] * 3 + [_P], _I),
        # q_q, q_scales, cent_q, cent_scales, cent_bias, out, B, C, D, stream
        "pio_score_centroids": ([_P] * 6 + [_I] * 3 + [_P], _I),
    },
    "sparse_update": {
        "pio_error_string": ([_I], ctypes.c_char_p),
        # in [4, R, D], bc [2, R], out [3, R, D], R, D, lr, b1, 1 - b1, b2,
        # 1 - b2, eps, stream
        "pio_adam_rows": ([_P] * 3 + [_I] * 2 + [_F] * 6 + [_P], _I),
        # host_in [4 R D + 2 R], dev_in, dev_out [3, R, D], host_out, R, D,
        # lr, b1, 1 - b1, b2, 1 - b2, eps, stream
        "pio_adam_rows_staged": ([_P] * 4 + [_I] * 2 + [_F] * 6 + [_P], _I),
        # table, m_tab, v_tab, idx, idx bytes (4 or 8), g, bc1, bc2,
        # table_out, m_out, v_out, N, R, D, lr, b1, 1 - b1, b2, 1 - b2, eps,
        # stream
        "pio_adam_rows_indexed": ([_P] * 4 + [_I] + [_P] * 6
                                  + [ctypes.c_longlong] + [_I] * 2 + [_F] * 6
                                  + [_P], _I),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of incubator_predictionio_tpu_torch build only where the CUDA "
            "toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by a hash of
    the source, every ``csrc/*.cuh`` (an edited header rebuilds every
    library, never loads a stale one) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, temp path, final
    path, start time) or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, t0


def _finish(name: str, started) -> None:
    from incubator_predictionio_tpu_torch.utils import jitstats

    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder loads a whole file
    jitstats.observe_compile(name, time.perf_counter() - t0)


def build_all() -> list[str]:
    """Build every source that is not built yet, one ``nvcc`` per source,
    all started together. Returns the names that were compiled."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: s for n in names if (s := _start(n)) is not None}
        for n, s in started.items():
            _finish(n, s)
    return sorted(started)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.pio_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
