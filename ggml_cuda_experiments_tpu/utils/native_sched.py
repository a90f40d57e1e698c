"""ctypes binding for the native C++ continuous-batching scheduler
(native/gct_sched.cpp).

Decision-identical to the Python reference scheduler in models/engine.py
(enforced by tests/test_native_sched.py); the engine uses it with
``scheduler="native"``. The library is built on first use (utils/native.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ggml_cuda_experiments_tpu.utils.native import lib_path

_int = ctypes.c_int
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


@functools.cache
def _lib():
    path = lib_path()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    if not hasattr(lib, "gct_sched_new"):
        return None                     # stale build without the scheduler
    lib.gct_sched_new.restype = ctypes.c_void_p
    lib.gct_sched_new.argtypes = [_int] * 5
    lib.gct_sched_free.argtypes = [ctypes.c_void_p]
    lib.gct_sched_add_request.argtypes = [ctypes.c_void_p, _int, _int, _int]
    lib.gct_sched_admit.restype = _int
    lib.gct_sched_admit.argtypes = [ctypes.c_void_p, _i32p, _i32p, _i32p]
    lib.gct_sched_step_complete.restype = _int
    lib.gct_sched_step_complete.argtypes = [ctypes.c_void_p, _u8p, _i32p,
                                            _i32p]
    for f in ("gct_sched_num_running", "gct_sched_num_waiting",
              "gct_sched_num_free_pages"):
        getattr(lib, f).restype = _int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.gct_sched_state.argtypes = [ctypes.c_void_p, _i32p, _i32p]
    return lib


def available() -> bool:
    return _lib() is not None


class NativeScheduler:
    """Owns admission, page allocation, per-slot lengths, and completion."""

    def __init__(self, max_batch: int, n_pages: int, pages_per_seq: int,
                 page_size: int, max_seq_len: int):
        lib = _lib()
        assert lib is not None, "libgct_native.so missing gct_sched"
        self._lib = lib
        self._h = lib.gct_sched_new(max_batch, n_pages, pages_per_seq,
                                    page_size, max_seq_len)
        self.max_batch = max_batch
        self.pages_per_seq = pages_per_seq

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gct_sched_free(self._h)
            self._h = None

    def add_request(self, rid: int, prompt_len: int,
                    max_new_tokens: int) -> None:
        self._lib.gct_sched_add_request(self._h, rid, prompt_len,
                                        max_new_tokens)

    def admit(self) -> list[tuple[int, int, np.ndarray]]:
        """Admit waiting requests; returns [(rid, slot, page_row)]."""
        cap = self.max_batch
        rids = np.zeros(cap, np.int32)
        slots = np.zeros(cap, np.int32)
        pages = np.zeros((cap, self.pages_per_seq), np.int32)
        n = self._lib.gct_sched_admit(self._h, rids, slots,
                                      pages.reshape(-1))
        return [(int(rids[i]), int(slots[i]), pages[i].copy())
                for i in range(n)]

    def step_complete(self, hit_eos: np.ndarray) -> list[tuple[int, int]]:
        """Advance every running slot one token; returns finished
        [(rid, slot)]."""
        cap = self.max_batch
        frids = np.zeros(cap, np.int32)
        fslots = np.zeros(cap, np.int32)
        n = self._lib.gct_sched_step_complete(
            self._h, np.ascontiguousarray(hit_eos, np.uint8), frids, fslots)
        return [(int(frids[i]), int(fslots[i])) for i in range(n)]

    @property
    def num_running(self) -> int:
        return self._lib.gct_sched_num_running(self._h)

    @property
    def num_waiting(self) -> int:
        return self._lib.gct_sched_num_waiting(self._h)

    @property
    def num_free_pages(self) -> int:
        return self._lib.gct_sched_num_free_pages(self._h)

    def state(self) -> tuple[np.ndarray, np.ndarray]:
        lengths = np.zeros(self.max_batch, np.int32)
        table = np.zeros(self.max_batch * self.pages_per_seq, np.int32)
        self._lib.gct_sched_state(self._h, lengths, table)
        return lengths, table.reshape(self.max_batch, self.pages_per_seq)
