"""ctypes bindings for the native robot-boundary runtime (libwvn_native).

A copy of wild_visual_navigation_tpu/runtime/native_ipc.py (it imports no JAX).

See native/wvn_native.cpp. Auto-builds the shared library on first use
(g++ is in the image); every facility has a pure-python fallback so the
framework stays importable where no toolchain exists.

Exposes:
  * RingBuffer — lock-free SPSC queue of fixed-size records (the
    transport replacing the reference's ROS topic between the robot's
    I/O thread and the runtime);
  * RobotStateCodec — binary pack/unpack matching the reference's
    RobotState message fields;
  * image_to_chw — uint8 HWC -> float32 CHW [0,1] (+ fused nearest
    resize), the cv_bridge-equivalent ingest path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libwvn_native.so")
_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
        return True
    except Exception:
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.wvn_ring_create.restype = ctypes.c_void_p
        lib.wvn_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.wvn_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.wvn_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.wvn_ring_push_overwrite.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.wvn_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.wvn_ring_size.argtypes = [ctypes.c_void_p]
        lib.wvn_ring_size.restype = ctypes.c_size_t
        lib.wvn_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.wvn_ring_dropped.restype = ctypes.c_uint64
        lib.wvn_robot_state_size.restype = ctypes.c_size_t
        lib.wvn_pack_robot_state.argtypes = [
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.wvn_unpack_robot_state.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 2
        lib.wvn_image_u8hwc_to_f32chw.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
        ]
        lib.wvn_image_u8hwc_resize_f32chw.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.wvn_image_u8hwc_to_u8chw.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
        ]
        lib.wvn_image_u8hwc_resize_u8chw.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


class RobotStateCodec:
    """Binary RobotState (stamp, pose7, twist6, desired6, seq, flags)."""

    def __init__(self):
        self._lib = load_native()
        self.record_size = int(self._lib.wvn_robot_state_size()) if self._lib else 8 + 7 * 8 + 12 * 8 + 8

    def pack(self, stamp: float, pose7: np.ndarray, twist6: np.ndarray, desired6: np.ndarray,
             seq: int = 0, flags: int = 0) -> bytes:
        pose7 = np.ascontiguousarray(pose7, dtype=np.float64)
        twist6 = np.ascontiguousarray(twist6, dtype=np.float64)
        desired6 = np.ascontiguousarray(desired6, dtype=np.float64)
        if self._lib:
            out = np.empty(self.record_size, dtype=np.uint8)
            self._lib.wvn_pack_robot_state(
                ctypes.c_double(stamp),
                pose7.ctypes.data, twist6.ctypes.data, desired6.ctypes.data,
                seq, flags, out.ctypes.data,
            )
            return out.tobytes()
        import struct

        return struct.pack("<d7d6d6dII", stamp, *pose7, *twist6, *desired6, seq, flags)

    def unpack(self, buf: bytes) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray, int, int]:
        if self._lib:
            b = np.frombuffer(buf, dtype=np.uint8).copy()
            stamp = ctypes.c_double()
            pose7 = np.empty(7, np.float64)
            twist6 = np.empty(6, np.float64)
            desired6 = np.empty(6, np.float64)
            seq = ctypes.c_uint32()
            flags = ctypes.c_uint32()
            self._lib.wvn_unpack_robot_state(
                b.ctypes.data, ctypes.byref(stamp), pose7.ctypes.data, twist6.ctypes.data,
                desired6.ctypes.data, ctypes.byref(seq), ctypes.byref(flags),
            )
            return stamp.value, pose7, twist6, desired6, seq.value, flags.value
        import struct

        vals = struct.unpack("<d7d6d6dII", buf)
        return (vals[0], np.asarray(vals[1:8]), np.asarray(vals[8:14]), np.asarray(vals[14:20]),
                vals[20], vals[21])


class RingBuffer:
    """SPSC queue of fixed-size byte records (native or deque fallback)."""

    def __init__(self, record_size: int, capacity: int = 64, overwrite: bool = True):
        self.record_size = record_size
        self.overwrite = overwrite
        self._lib = load_native()
        if self._lib:
            self._ptr = self._lib.wvn_ring_create(record_size, capacity)
            self._fallback = None
        else:
            from collections import deque

            self._ptr = None
            self._fallback = deque(maxlen=capacity if overwrite else None)
            self._cap = capacity
        self._fallback_dropped = 0

    def push(self, record: bytes) -> bool:
        assert len(record) == self.record_size
        if self._ptr:
            buf = np.frombuffer(record, dtype=np.uint8).copy()
            fn = self._lib.wvn_ring_push_overwrite if self.overwrite else self._lib.wvn_ring_push
            return fn(self._ptr, buf.ctypes.data) == 0
        if not self.overwrite and len(self._fallback) >= self._cap:
            return False
        if self.overwrite and len(self._fallback) >= self._cap:
            # deque(maxlen) silently discards the oldest — count it so
            # `dropped` reports losses in the fallback too
            self._fallback_dropped += 1
        self._fallback.append(record)
        return True

    def pop(self) -> Optional[bytes]:
        if self._ptr:
            out = np.empty(self.record_size, dtype=np.uint8)
            if self._lib.wvn_ring_pop(self._ptr, out.ctypes.data) != 0:
                return None
            return out.tobytes()
        try:
            return self._fallback.popleft()
        except IndexError:
            return None

    def __len__(self) -> int:
        if self._ptr:
            return int(self._lib.wvn_ring_size(self._ptr))
        return len(self._fallback)

    @property
    def dropped(self) -> int:
        if self._ptr:
            return int(self._lib.wvn_ring_dropped(self._ptr))
        return self._fallback_dropped

    def __del__(self):
        if getattr(self, "_ptr", None) and self._lib:
            self._lib.wvn_ring_destroy(self._ptr)
            self._ptr = None


def image_to_chw_u8(img_u8_hwc: np.ndarray, out_h: Optional[int] = None, out_w: Optional[int] = None) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (C, H', W') transpose (+nearest resize);
    the preferred ingest when the device normalizes (4x smaller upload
    than float32 — the runtime's jitted programs accept uint8)."""
    img = np.ascontiguousarray(img_u8_hwc, dtype=np.uint8)
    h, w, c = img.shape
    lib = load_native()
    if out_h is None:
        out_h, out_w = h, w
    if out_w is None:
        out_w = out_h
    if lib:
        dst = np.empty((c, out_h, out_w), dtype=np.uint8)
        if (out_h, out_w) == (h, w):
            lib.wvn_image_u8hwc_to_u8chw(img.ctypes.data, h, w, c, dst.ctypes.data)
        else:
            lib.wvn_image_u8hwc_resize_u8chw(img.ctypes.data, h, w, c, out_h, out_w, dst.ctypes.data)
        return dst
    out = img
    if (out_h, out_w) != (h, w):
        iy = np.clip((np.arange(out_h) * h // out_h), 0, h - 1)
        ix = np.clip((np.arange(out_w) * w // out_w), 0, w - 1)
        out = out[iy][:, ix]
    return out.transpose(2, 0, 1).copy()


def image_to_chw(img_u8_hwc: np.ndarray, out_h: Optional[int] = None, out_w: Optional[int] = None) -> np.ndarray:
    """uint8 (H, W, C) -> float32 (C, H', W') in [0,1], with fused
    nearest resize when out_h/out_w are given."""
    img = np.ascontiguousarray(img_u8_hwc, dtype=np.uint8)
    h, w, c = img.shape
    lib = load_native()
    if out_h is None:
        out_h, out_w = h, w
    if out_w is None:
        out_w = out_h
    if lib:
        dst = np.empty((c, out_h, out_w), dtype=np.float32)
        if (out_h, out_w) == (h, w):
            lib.wvn_image_u8hwc_to_f32chw(img.ctypes.data, h, w, c, dst.ctypes.data)
        else:
            lib.wvn_image_u8hwc_resize_f32chw(img.ctypes.data, h, w, c, out_h, out_w, dst.ctypes.data)
        return dst
    # numpy fallback
    out = img.astype(np.float32) / 255.0
    if (out_h, out_w) != (h, w):
        iy = np.clip((np.arange(out_h) * h // out_h), 0, h - 1)
        ix = np.clip((np.arange(out_w) * w // out_w), 0, w - 1)
        out = out[iy][:, ix]
    return out.transpose(2, 0, 1)
