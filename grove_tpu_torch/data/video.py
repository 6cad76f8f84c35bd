"""Video decoding: ctypes bindings to the repo's native libav decoder.

Counterpart of `grove_tpu/data/video.py` (`VideoDecoder`, `SyntheticVideo`).
The bindings load `native/libgrove_video.so` (C++ of this repo,
`native/video_decoder.cc`, linked against libavformat, libavcodec,
libavutil and libswscale): one demuxer and codec per clip, monotonic sweeps
with keyframe seeks, swscale RGB conversion. ctypes releases the GIL during
calls, so a thread pool can decode several clips at once.

A library that is missing or cannot load (a libav shared object absent)
raises at `VideoDecoder` construction; `probe_library` says why without
raising. `SyntheticVideo` is the file-free stand-in for tests and for a
machine without libav. `NpyVideo` reads a clip stored as a uint8
(T, H, W, 3) `.npy` array with its fps in a JSON file beside it
(`write_npy_clip`): the clip format of the port's synthetic datasets, which
a machine without libav can read. `open_video(path)` picks the decoder by
extension.

Differences from the JAX module: it does not run `make` for a missing
library, and `decode_at_yuv` raises ValueError for an odd output size
(JAX asserts, `video.py:128`): YUV420 needs even sizes, and choosing RGB
for such a source is the caller's decision.
"""

from __future__ import annotations

import ctypes
import json
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libgrove_video.so"

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not LIB_PATH.is_file():
        raise RuntimeError(f"{LIB_PATH} not found; build it with "
                           "`make -C native`")
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:
        raise RuntimeError(f"{LIB_PATH} does not load: {e}") from e
    P = ctypes.POINTER
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_info.argtypes = [ctypes.c_void_p, P(ctypes.c_double),
                            P(ctypes.c_double), P(ctypes.c_int),
                            P(ctypes.c_int)]
    lib.vd_info.restype = ctypes.c_int
    lib.vd_decode_at.argtypes = [
        ctypes.c_void_p, P(ctypes.c_double), ctypes.c_int, P(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_double]
    lib.vd_decode_at.restype = ctypes.c_int
    lib.vd_decode_fps.argtypes = [
        ctypes.c_void_p, ctypes.c_double, P(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.vd_decode_fps.restype = ctypes.c_int
    lib.vd_decode_at_yuv.argtypes = lib.vd_decode_at.argtypes
    lib.vd_decode_at_yuv.restype = ctypes.c_int
    _lib = lib
    return lib


def probe_library() -> Optional[str]:
    """None when the native decoder loads, else why it does not (for a
    missing libav, the loader's message names the shared object)."""
    try:
        _load_lib()
    except RuntimeError as e:
        return str(e)
    return None


def _u8(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class VideoDecoder:
    """One decoder instance per clip (not thread-shared)."""

    def __init__(self, path: str):
        self._h = None
        self._lib = _load_lib()
        self._h = self._lib.vd_open(str(path).encode())
        if not self._h:
            raise IOError(f"could not open video: {path}")
        dur, fps = ctypes.c_double(), ctypes.c_double()
        w, h = ctypes.c_int(), ctypes.c_int()
        self._lib.vd_info(self._h, ctypes.byref(dur), ctypes.byref(fps),
                          ctypes.byref(w), ctypes.byref(h))
        self.duration = dur.value
        self.fps = fps.value
        self.width = w.value
        self.height = h.value

    def _decode(self, fn, timestamps, shape, w: int, h: int) -> np.ndarray:
        ts = np.asarray(sorted(timestamps), np.float64)
        out = np.zeros((len(ts),) + shape, np.uint8)
        n = fn(self._h, ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
               len(ts), _u8(out), w, h, 4.0)
        if n < len(ts):
            # EOF before the tail timestamps: repeat the last good frame
            # (the reference pads short videos the same way)
            if n <= 0:
                raise IOError("decoded zero frames")
            out[n:] = out[n - 1]
        return out

    def decode_at(self, timestamps: Sequence[float],
                  out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Frames covering the given timestamps (sorted) -> (N, H, W, 3)
        RGB uint8; `out_size` (w, h) resizes in swscale."""
        w, h = out_size if out_size else (self.width, self.height)
        return self._decode(self._lib.vd_decode_at, timestamps, (h, w, 3),
                            w, h)

    def decode_at_yuv(self, timestamps: Sequence[float],
                      out_size: Optional[Tuple[int, int]] = None
                      ) -> np.ndarray:
        """Frames at the given timestamps as packed YUV420P, (N, 3H/2, W)
        uint8: Y rows [0, H); U and V (H/2, W/2) side by side in rows
        [H, 3H/2). Half the bytes of RGB24; `GroveModel._norm_*` converts
        and resizes on the device. Raises ValueError for an odd width or
        height, which 4:2:0 cannot hold."""
        w, h = out_size if out_size else (self.width, self.height)
        if w % 2 or h % 2:
            raise ValueError(f"decode_at_yuv: {w}x{h} output; YUV420 needs "
                             "an even width and height (decode_at gives "
                             "RGB at any size)")
        return self._decode(self._lib.vd_decode_at_yuv, timestamps,
                            (3 * h // 2, w), w, h)

    def decode_fps(self, fps: float = 5.0,
                   out_size: Optional[Tuple[int, int]] = None,
                   max_frames: int = 2048) -> np.ndarray:
        """Whole-clip decode resampled at `fps` -> (N, H, W, 3)."""
        w, h = out_size if out_size else (self.width, self.height)
        out = np.zeros((max_frames, h, w, 3), np.uint8)
        n = self._lib.vd_decode_fps(self._h, fps, _u8(out), w, h,
                                    max_frames)
        return out[:n].copy()

    def close(self):
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SyntheticVideo:
    """Deterministic fake clip for tests and benchmarks (no file IO): the
    JAX package's frames (a seeded random image rolled 3 pixels a frame).
    A context manager too (the JAX class is not), so that
    `lambda path: SyntheticVideo(...)` serves as `GroveProcessor`'s
    `decoder_factory`."""

    def __init__(self, num_frames: int = 40, width: int = 64,
                 height: int = 48, fps: float = 5.0, seed: int = 0):
        self.fps = fps
        self.width = width
        self.height = height
        self.duration = num_frames / fps
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
        self._frames = np.stack([
            np.roll(base, shift=3 * i, axis=1) for i in range(num_frames)])

    def decode_at(self, timestamps, out_size=None):
        idx = np.clip((np.asarray(timestamps) * self.fps).astype(int), 0,
                      len(self._frames) - 1)
        return self._frames[idx]

    def decode_at_yuv(self, timestamps, out_size=None):
        from .preprocess import rgb_to_yuv420
        return rgb_to_yuv420(self.decode_at(timestamps, out_size))

    def decode_fps(self, fps=5.0, out_size=None, max_frames=2048):
        step = max(int(round(self.fps / fps)), 1)
        return self._frames[::step][:max_frames]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


NPY_FPS_SUFFIX = ".json"         # the fps file beside a `.npy` clip
NATIVE_TS_SLACK = 1e-6           # `native/video_decoder.cc:142-165`'s slack


def write_npy_clip(path: str, frames: np.ndarray, fps: float) -> None:
    """Store a clip for `NpyVideo`: `path` (a `.npy` file) holds the uint8
    (T, H, W, 3) frames, `path + ".json"` the fps."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_npy_clip: frames {frames.dtype} "
                         f"{frames.shape}, expected uint8 (T, H, W, 3)")
    np.save(path, frames, allow_pickle=False)
    with open(path + NPY_FPS_SUFFIX, "w") as f:
        json.dump({"fps": float(fps)}, f)


class NpyVideo:
    """A `.npy` clip with `VideoDecoder`'s surface (`decode_at`,
    `decode_at_yuv`, `decode_fps`, `width`, `height`, `fps`, `duration`, a
    context manager). Frame k lies at k / fps. `decode_at` serves each
    timestamp t as the native decoder's sweep does: the first frame whose
    time is at least t - 1e-6, the last frame for a t past the end, the
    timestamps sorted. `out_size` resizes bilinearly with
    `preprocess.resize_uint8` (Pillow's filter, where the native decoder
    runs swscale's: a constant colour comes out the same)."""

    def __init__(self, path: str):
        self._frames = np.load(path, mmap_mode="r", allow_pickle=False)
        if (self._frames.dtype != np.uint8 or self._frames.ndim != 4
                or self._frames.shape[-1] != 3 or not len(self._frames)):
            raise IOError(f"{path}: {self._frames.dtype} "
                          f"{self._frames.shape}, expected uint8 "
                          "(T, H, W, 3) with T > 0")
        with open(path + NPY_FPS_SUFFIX) as f:
            self.fps = float(json.load(f)["fps"])
        self.height, self.width = self._frames.shape[1:3]
        self.duration = len(self._frames) / self.fps

    def _frame_indices(self, timestamps: Sequence[float]) -> np.ndarray:
        """The frame each (sorted) timestamp is served by."""
        times = np.arange(len(self._frames)) / self.fps
        ts = np.sort(np.asarray(timestamps, np.float64))
        idx = np.searchsorted(times, ts - NATIVE_TS_SLACK, side="left")
        return np.minimum(idx, len(times) - 1)

    def _resized(self, frames: np.ndarray, out_size) -> np.ndarray:
        if out_size is None or tuple(out_size) == (self.width, self.height):
            return np.ascontiguousarray(frames)
        from .preprocess import resize_uint8
        w, h = out_size
        return resize_uint8(np.asarray(frames), w, h, "bilinear")

    def decode_at(self, timestamps: Sequence[float],
                  out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Frames covering the given timestamps (sorted) -> (N, H, W, 3)
        RGB uint8."""
        return self._resized(self._frames[self._frame_indices(timestamps)],
                             out_size)

    def decode_at_yuv(self, timestamps: Sequence[float],
                      out_size: Optional[Tuple[int, int]] = None
                      ) -> np.ndarray:
        """`decode_at` as packed YUV420P, (N, 3H/2, W) uint8
        (`preprocess.rgb_to_yuv420`); ValueError for an odd size, as
        `VideoDecoder.decode_at_yuv`."""
        from .preprocess import rgb_to_yuv420
        w, h = out_size if out_size else (self.width, self.height)
        if w % 2 or h % 2:
            raise ValueError(f"decode_at_yuv: {w}x{h} output; YUV420 needs "
                             "an even width and height (decode_at gives "
                             "RGB at any size)")
        return rgb_to_yuv420(self.decode_at(timestamps, out_size))

    def decode_fps(self, fps: float = 5.0,
                   out_size: Optional[Tuple[int, int]] = None,
                   max_frames: int = 2048) -> np.ndarray:
        """Whole-clip decode resampled at `fps`, by the native decoder's
        ticks (`vd_decode_fps`): a frame is kept when its time reaches the
        next tick, and the ticks behind it are skipped."""
        keep, tick = [], 0.0
        for k in range(len(self._frames)):
            if len(keep) >= max_frames:
                break
            t = k / self.fps
            if t + 1e-9 >= tick:
                keep.append(k)
                while tick <= t + 1e-9:
                    tick += 1.0 / fps
        return self._resized(self._frames[keep], out_size)

    def close(self):
        self._frames = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_video(path: str):
    """The decoder for `path`: `NpyVideo` for a `.npy` clip, the libav
    `VideoDecoder` for anything else."""
    if os.path.splitext(str(path))[1].lower() == ".npy":
        return NpyVideo(path)
    return VideoDecoder(path)
