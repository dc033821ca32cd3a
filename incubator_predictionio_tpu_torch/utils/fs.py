"""Filesystem locations and crash-safe file writes.

Counterpart of ``incubator_predictionio_tpu/utils/fs.py``: the
``PIO_FS_BASEDIR`` convention (:func:`base_dir`, :func:`subdir`; a
device-resident model's tables persist under ``subdir("device_models")``)
and the crash-safe writes the streaming state dir's cursor, trainer state,
delta archive and quarantine marker go through (:func:`atomic_write_bytes`),
and mid-training checkpoints (:func:`atomic_write_with`).
"""

from __future__ import annotations

import os
from typing import BinaryIO, Callable


def base_dir() -> str:
    """``PIO_FS_BASEDIR`` or ``~/.pio_store``."""
    return os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store"))


def subdir(*parts: str) -> str:
    """A directory under :func:`base_dir`, created on demand."""
    d = os.path.join(base_dir(), *parts)
    os.makedirs(d, exist_ok=True)
    return d


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives a power cut —
    rename() alone only orders the metadata in the page cache. Best-effort:
    some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, durable: bool = True) -> None:
    """Crash-safe file write: tmp in the same directory → flush → fsync →
    rename over the target → directory fsync. Readers see either the old
    complete file or the new complete file, never a torn one; with
    ``durable`` the new content also survives an immediate power cut."""
    atomic_write_with(path, lambda f: f.write(data), durable)


def atomic_write_with(path: str, write: Callable[[BinaryIO], object],
                      durable: bool = True) -> None:
    """:func:`atomic_write_bytes` for content a writer streams into the
    open temporary file (``write(f)``), so a large file never sits in
    memory twice (mid-training checkpoints, ``utils/checkpoint.py``)."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        if durable:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if durable:
        fsync_dir(d)
