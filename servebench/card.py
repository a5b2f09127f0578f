"""The card: its published peaks and its energy counter.

Peaks are NVIDIA's data sheet figures for the SXM part, dense, at its full
700 W limit; a card set below that limit runs slower, so every result
prints the limit beside the name.  Energy is the board's cumulative counter
through NVML (``nvmlDeviceGetTotalEnergyConsumption``, mJ), read with
``ctypes``; a board without that counter is refused, so ``j_per_token`` has
one source.  Copied from the repository's chip smoke script (``CardEnergy``),
without its power-sampling thread.
"""

from __future__ import annotations

import ctypes

PEAKS = {
    # name as torch.cuda.get_device_name gives it: dense bf16 FLOP/s, HBM bytes/s
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}

NVML_SUCCESS = 0


def peaks(name: str) -> dict:
    if name not in PEAKS:
        raise RuntimeError(f"no published peaks for {name!r}: add them to PEAKS")
    return PEAKS[name]


class CardEnergy:
    """Joules of card ``index`` between ``start`` and ``read``."""

    def __init__(self, index: int = 0):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetPowerManagementLimit",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(self._handle)),
                    "nvmlDeviceGetHandleByIndex_v2")
        self._counter_j()

    def _check(self, rc: int, what: str) -> None:
        if rc != NVML_SUCCESS:
            raise RuntimeError(f"{what}: NVML error {rc}")

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetPowerManagementLimit(self._handle, ctypes.byref(mw)),
                    "nvmlDeviceGetPowerManagementLimit")
        return mw.value / 1e3

    def _counter_j(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(self._handle,
                                                                  ctypes.byref(mj)),
                    "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3

    def start(self) -> None:
        """Begin a reading (call with the card synchronised)."""
        self._j0 = self._counter_j()

    def read(self) -> float:
        """Joules since ``start`` (call with the card synchronised)."""
        return self._counter_j() - self._j0

    def close(self) -> None:
        self._check(self._lib.nvmlShutdown(), "nvmlShutdown")
