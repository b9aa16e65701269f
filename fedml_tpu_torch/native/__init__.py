"""Native (C++) runtime components, built on demand with the system
toolchain and loaded via ctypes — no pybind11 dependency (port of
``fedml_tpu/native``; its own copy of ``msgnet.cpp``).

``load_msgnet()`` compiles ``msgnet.cpp`` with ``g++`` at first use (cached
as ``_build/libmsgnet.so``, keyed on source mtime) and returns the ctypes
library with argtypes configured. This is host transport code for
``comm/tcp.py``, not a device kernel.

Several processes may load it at once (the ranks of a cross-silo
federation started together): one of them builds while the others wait on
a file lock, and the build is written to a private file that is renamed
into place, so no process ever opens a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_LIB = None


def _compile(src: str, out: str):
    """Build ``src`` into ``out`` atomically: g++ writes a file of this
    process's own, renamed onto ``out`` once complete."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-pthread", "-std=c++17",
        src, "-o", tmp,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"native build failed: {' '.join(cmd)}\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)


def _stale(src: str, out: str) -> bool:
    return (not os.path.isfile(out)
            or os.path.getmtime(out) < os.path.getmtime(src))


def load_msgnet() -> ctypes.CDLL:
    """Build (if stale) + load the message-transport library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = os.path.join(_HERE, "msgnet.cpp")
        out = os.path.join(_BUILD, "libmsgnet.so")
        if _stale(src, out):
            # One builder across processes; the others find it fresh.
            os.makedirs(_BUILD, exist_ok=True)
            with open(os.path.join(_BUILD, ".lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if _stale(src, out):
                    _compile(src, out)
        lib = ctypes.CDLL(out)
        lib.mn_server_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mn_server_create.restype = ctypes.c_int
        lib.mn_server_port.argtypes = [ctypes.c_int]
        lib.mn_server_port.restype = ctypes.c_int
        lib.mn_server_recv.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.mn_server_recv.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.mn_server_stop.argtypes = [ctypes.c_int]
        lib.mn_sender_create.restype = ctypes.c_int
        # data as c_char_p: a Python bytes object passes zero-copy (the C
        # side takes const uint8* + explicit length; embedded NULs are fine).
        lib.mn_send.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.mn_send.restype = ctypes.c_int
        lib.mn_sender_destroy.argtypes = [ctypes.c_int]
        lib.mn_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
        return lib
