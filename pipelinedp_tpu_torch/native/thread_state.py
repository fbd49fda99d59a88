"""PyTorch's thread-local state, carried from one thread to another.

PyTorch starts its own worker threads (the inter-op pool, the autograd
engine's device threads) under the thread-local state of the thread that
scheduled their work: grad mode, dispatch keys, and the profiler's state
with its operator callbacks, so that a ``torch.profiler`` session records
what they run. A Python ``threading.Thread`` starts with none of it, so
the profiler records no ``record_function`` range and no operator of such
a thread. ``capture()`` copies the calling thread's state, and
``entered(state)`` runs a block on another thread under it and restores
that thread's own state afterwards, through ``at::ThreadLocalState``
(``thread_state.cc``).

The library is compiled with ``g++`` against the installed torch's
headers at first use, never at import, into the port's build directory
under a name that hashes the source, the flags and the torch version
(``native._build_shared_lib``). Where it cannot be built, ``capture()``
returns None and ``entered`` runs the block as it is.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Optional

from pipelinedp_tpu_torch import native

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "thread_state.cc")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.PyDLL] = None
_ERROR: Optional[str] = None


def _flags_and_libs():
    import torch
    root = os.path.dirname(torch.__file__)
    lib = os.path.join(root, "lib")
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    # The version define is unused by the source: it puts the torch build
    # in the library's hashed name, so another torch never loads it.
    flags = (*native.GXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             f"-DPDP_TORCH_VERSION=\"{torch.__version__}\"",
             "-I" + os.path.join(root, "include"), "-w")
    libs = ("-L" + lib, "-Wl,-rpath," + lib, "-Wl,--no-as-needed",
            "-ltorch_cpu", "-lc10")
    return flags, libs


def _lib() -> Optional[ctypes.PyDLL]:
    """The loaded library, built on first use; None where it cannot be
    built or loaded (the reason is kept in ``_ERROR``)."""
    global _LIB, _ERROR
    if _LIB is not None or _ERROR is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            flags, libs = _flags_and_libs()
            # PyDLL: the calls hold the GIL, as the state they copy holds
            # Python objects (the torch-function mode stack).
            lib = ctypes.PyDLL(native._build_shared_lib(
                _SRC, "_thread_state", flags, libs))
        except (OSError, native.NativeUnavailableError) as e:
            _ERROR = str(e)
            from pipelinedp_tpu_torch import obs
            obs.event("native.thread_state_unavailable", error=_ERROR[-500:])
            return None
        lib.pdp_tls_capture.argtypes = []
        lib.pdp_tls_capture.restype = ctypes.c_void_p
        lib.pdp_tls_set.argtypes = [ctypes.c_void_p]
        lib.pdp_tls_set.restype = None
        lib.pdp_tls_free.argtypes = [ctypes.c_void_p]
        lib.pdp_tls_free.restype = None
        _LIB = lib
        return _LIB


def prepare() -> bool:
    """Builds or loads the library now (so a later ``capture`` does not
    build it); True when it is loaded."""
    return _lib() is not None


class State:
    """One thread's copied state; freed when collected."""

    def __init__(self, lib: ctypes.PyDLL):
        self._lib = lib
        self._ptr = lib.pdp_tls_capture()

    def set(self) -> None:
        self._lib.pdp_tls_set(self._ptr)

    def __del__(self):
        if self._ptr:
            self._lib.pdp_tls_free(self._ptr)
            self._ptr = None


def capture() -> Optional[State]:
    """The calling thread's PyTorch thread-local state, or None where the
    library is unavailable."""
    lib = _lib()
    return State(lib) if lib is not None else None


@contextlib.contextmanager
def entered(state: Optional[State]):
    """Runs the block under ``state`` (a no-op for None), then puts the
    calling thread's own state back."""
    if state is None:
        yield
        return
    own = State(state._lib)
    state.set()
    try:
        yield
    finally:
        own.set()
