"""Host-side frame preprocessing for the two vision towers, without PIL.

Counterpart of `grove_tpu/data/preprocess.py`, whose transforms resize with
Pillow (`Image.resize(..., BICUBIC / BILINEAR)`); the port does not depend
on PIL, so the resize is Pillow's own algorithm in numpy, bit-equal to it
(`tests/test_torch_entry.py` holds every transform equal to the JAX
package's on odd, non-square and upscaled sizes):

* separable 1-D passes, horizontal first (only when the width changes),
  then vertical (only when the height changes), uint8 between them;
* per output index, Pillow's support, window and weights in double, each
  weight to fixed point with 22 fractional bits (rounded half away from
  zero), the taps summed in integers from 1 << 21, then >> 22 and clamped
  to [0, 255] (`Resample.c`: `precompute_coeffs`, `normalize_coeffs_8bpc`,
  `ImagingResampleHorizontal_8bpc`).

Each pass gathers its taps once per (input, output) size and sums them in
int32, as Pillow does. The frames of a clip are split into one chunk per
CPU, each resized and normalized in a thread of one pool (numpy releases
the GIL in these loops); normalization is a lookup of each uint8 level's
float32 value.

Outputs are channels-last (H, W, 3), as in the JAX package. The constants
are copies of the JAX module's, held equal by test.
"""

from __future__ import annotations

import functools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)

# BT.601 limited range, the packed YUV420P layout of
# `native/video_decoder.cc:vd_decode_at_yuv` (`preprocess.py:96-110`)
YUV_OFFSET = np.array([16.0, 128.0, 128.0], np.float32)
RGB_TO_YUV = np.array([[65.738, 129.057, 25.064],
                       [-37.945, -74.494, 112.439],
                       [112.439, -94.154, -18.285]], np.float32) / 256.0
YUV_TO_RGB = np.array([[298.082, 0.0, 408.583],
                       [298.082, -100.291, -208.120],
                       [298.082, 516.412, 0.0]], np.float32) / 256.0

_PRECISION_BITS = 22                    # 32 - 8 - 2, Pillow's 8-bit passes


def _bicubic(x: float) -> float:
    """Pillow's cubic: Keys with a = -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, method: str):
    """(index, weight) int32 arrays (taps, out_size) of one 1-D pass: the
    input index of each tap of each output and its fixed-point weight (0
    past the output's window)."""
    filt, fsupport = _FILTERS[method]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = fsupport * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / fscale
    index = np.zeros((ksize, out_size), np.int64)
    weight = np.zeros((ksize, out_size), np.int32)
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        ws = [filt((x + xmin - center + 0.5) * ss) for x in range(n)]
        total = 0.0
        for w in ws:                      # Pillow's sequential double sum
            total += w
        for x, w in enumerate(ws):
            if total != 0.0:
                w /= total
            index[x, xx] = xmin + x
            weight[x, xx] = int(w * one + (0.5 if w >= 0 else -0.5))
    return index, weight


def _resample_axis(img: np.ndarray, axis: int, out_size: int, method: str,
                   keep: slice = slice(None)) -> np.ndarray:
    """One of Pillow's 8-bit passes along `axis` of a uint8 array: per tap,
    a gather along the axis times the tap's weights, summed in int32 as
    Pillow sums (|sum| < 2^31: 255 levels x the weights' 1-norm x 2^22).
    `keep` selects output indices (each is computed on its own, so the
    kept ones equal the full pass's)."""
    index, weight = _taps(img.shape[axis], out_size, method)
    index, weight = index[:, keep], weight[:, keep]
    shape = [1] * img.ndim
    shape[axis] = index.shape[1]
    out_shape = list(img.shape)
    out_shape[axis] = index.shape[1]
    acc = np.full(out_shape, 1 << (_PRECISION_BITS - 1), np.int32)
    tap = np.empty(out_shape, np.int32)
    for idx, w in zip(index, weight):
        np.multiply(np.take(img, idx, axis=axis), w.reshape(shape), out=tap)
        acc += tap
    np.right_shift(acc, _PRECISION_BITS, out=acc)
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_uint8(frames: np.ndarray, new_w: int, new_h: int, method: str,
                 crop=None) -> np.ndarray:
    """(..., H, W, C) uint8 -> (..., new_h, new_w, C) uint8, each frame
    bit-equal to Pillow's `Image.fromarray(frame).resize((new_w, new_h),
    BICUBIC / BILINEAR)`; with `crop` = (left, top, size) inside the
    resized frame, only that square of it."""
    h, w = frames.shape[-3:-1]
    cols = rows = slice(None)
    if crop is not None:
        left, top, size = crop
        cols, rows = slice(left, left + size), slice(top, top + size)
    out = frames
    if new_w != w:
        out = _resample_axis(out, out.ndim - 2, new_w, method, cols)
    elif crop is not None:
        out = out[..., cols, :]
    if new_h != h:
        out = _resample_axis(out, out.ndim - 3, new_h, method, rows)
    elif crop is not None:
        out = out[..., rows, :, :]
    return np.ascontiguousarray(out)


def _clip_geometry(frames: np.ndarray, size: int) -> np.ndarray:
    """Shortest-edge resize (bicubic, Python `round`) + center crop, as
    PIL's `crop` (zeros where the box would leave the resized frame)."""
    h, w = frames.shape[-3:-1]
    scale = size / min(w, h)
    new_w, new_h = round(w * scale), round(h * scale)
    left, top = (new_w - size) // 2, (new_h - size) // 2
    if left >= 0 and top >= 0 and new_w >= size and new_h >= size:
        return resize_uint8(frames, new_w, new_h, "bicubic",
                            crop=(left, top, size))
    img = resize_uint8(frames, new_w, new_h, "bicubic")
    out = np.zeros(frames.shape[:-3] + (size, size) + frames.shape[-1:],
                   np.uint8)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + size, new_h), min(left + size, new_w)
    out[..., y0 - top:y1 - top, x0 - left:x1 - left, :] = \
        img[..., y0:y1, x0:x1, :]
    return out


def _sam_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """ResizeLongestSide's (new_h, new_w): `int(x * scale + 0.5)`."""
    scale = size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


# every uint8 level's normalized value per channel, by the JAX package's
# float32 arithmetic: a lookup gives the same bits in one pass
_LEVELS = np.arange(256, dtype=np.float32)[:, None]
_CLIP_LUT = (_LEVELS / 255.0 - CLIP_MEAN) / CLIP_STD
_SAM_LUT = (_LEVELS - SAM_MEAN) / SAM_STD


def _normalize(img: np.ndarray, lut: np.ndarray, out: np.ndarray) -> None:
    """out[..., c] = lut[img[..., c], c] for uint8 (..., C) img."""
    for c in range(img.shape[-1]):
        np.take(lut[:, c], img[..., c], out=out[..., c])


_POOL = None
_CPUS = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
         else os.cpu_count() or 1)


def _by_frames(fill, frames: np.ndarray, size: int, dtype) -> np.ndarray:
    """A zeroed (..., size, size, C) array of `dtype` for (..., H, W, C)
    uint8 frames, `fill(chunk, out_chunk)` run on one chunk of frames per
    CPU in the module's thread pool."""
    global _POOL
    x = frames.reshape((-1,) + frames.shape[-3:])
    out = np.zeros((len(x), size, size, x.shape[-1]), dtype)
    n = min(len(x), _CPUS)
    if n <= 1:
        fill(x, out)
    else:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(_CPUS)
        cuts = np.linspace(0, len(x), n + 1).astype(int)
        list(_POOL.map(lambda a, b: fill(x[a:b], out[a:b]), cuts[:-1],
                       cuts[1:]))
    return out.reshape(frames.shape[:-3] + out.shape[1:])


def _clip_fill(size: int, normalize: bool):
    def fill(x, out):
        img = _clip_geometry(x, size)
        if normalize:
            _normalize(img, _CLIP_LUT, out)
        else:
            out[...] = img
    return fill


def _sam_fill(size: int, normalize: bool):
    def fill(x, out):
        new_h, new_w = _sam_size(*x.shape[1:3], size)
        img = resize_uint8(x, new_w, new_h, "bilinear")
        if normalize:
            _normalize(img, _SAM_LUT, out[:, :new_h, :new_w])
        else:
            out[:, :new_h, :new_w] = img
    return fill


def clip_preprocess(frame: np.ndarray, size: int = 336) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) float32, CLIP-normalized; also
    (T, H, W, 3) -> (T, size, size, 3)."""
    return _by_frames(_clip_fill(size, True), frame, size, np.float32)


def sam_preprocess(frame: np.ndarray, size: int = 512) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) float32, SAM-normalized + padded;
    also (T, H, W, 3) -> (T, size, size, 3)."""
    return _by_frames(_sam_fill(size, True), frame, size, np.float32)


def preprocess_frames(frames: np.ndarray, clip_size: int = 336,
                      sam_size: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """(T, H, W, 3) uint8 -> (clip (T,c,c,3), sam (T,s,s,3)) float32."""
    return (clip_preprocess(frames, clip_size),
            sam_preprocess(frames, sam_size))


# ---------------------------------------------------------------------------
# uint8 variants: geometry on the host, normalization on the device
# (`GroveModel._norm_clip` / `_norm_sam`)
# ---------------------------------------------------------------------------

def clip_resize_uint8(frame: np.ndarray, size: int = 336) -> np.ndarray:
    """Resize + center crop only; returns uint8 (size, size, 3) (or
    (T, size, size, 3) for frames)."""
    return _by_frames(_clip_fill(size, False), frame, size, np.uint8)


def sam_resize_uint8(frame: np.ndarray, size: int = 512) -> np.ndarray:
    """ResizeLongestSide + zero pad only; returns uint8 (size, size, 3) (or
    (T, size, size, 3) for frames)."""
    return _by_frames(_sam_fill(size, False), frame, size, np.uint8)


def preprocess_frames_uint8(frames: np.ndarray, clip_size: int = 336,
                            sam_size: int = 512):
    """(T, H, W, 3) uint8 -> uint8 (clip, sam) frames + the SAM frames'
    valid (h, w), with which the device normalizer re-zeroes the pad (the
    reference normalizes before it pads)."""
    valid = np.array(_sam_size(*frames.shape[1:3], sam_size), np.int32)
    return (clip_resize_uint8(frames, clip_size),
            sam_resize_uint8(frames, sam_size), valid)


# ---------------------------------------------------------------------------
# packed YUV420P (Y rows [0, H); U and V (H/2, W/2) side by side below)
# ---------------------------------------------------------------------------

def rgb_to_yuv420(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB -> packed (T, 3H/2, W) uint8 YUV420P (2x2
    mean chroma). H and W must be even."""
    t, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError(f"rgb_to_yuv420: {w}x{h} frames; YUV420 needs an "
                         "even width and height")
    yuv = frames.astype(np.float32) @ RGB_TO_YUV.T + YUV_OFFSET
    yuv = np.clip(np.round(yuv), 0, 255).astype(np.float32)
    y = yuv[..., 0]
    u = yuv[..., 1].reshape(t, h // 2, 2, w // 2, 2).mean((2, 4))
    v = yuv[..., 2].reshape(t, h // 2, 2, w // 2, 2).mean((2, 4))
    out = np.empty((t, 3 * h // 2, w), np.uint8)
    out[:, :h] = np.clip(np.round(y), 0, 255).astype(np.uint8)
    out[:, h:, :w // 2] = np.clip(np.round(u), 0, 255).astype(np.uint8)
    out[:, h:, w // 2:] = np.clip(np.round(v), 0, 255).astype(np.uint8)
    return out


def yuv420_to_rgb(packed: np.ndarray) -> np.ndarray:
    """Packed (T, 3H/2, W) uint8 -> (T, H, W, 3) uint8 RGB (the host mirror
    of `GroveModel._yuv420_to_rgb`; nearest-neighbour chroma)."""
    t, h32, w = packed.shape
    h = h32 * 2 // 3
    y = packed[:, :h].astype(np.float32)
    u = packed[:, h:, :w // 2].astype(np.float32).repeat(2, 1).repeat(2, 2)
    v = packed[:, h:, w // 2:].astype(np.float32).repeat(2, 1).repeat(2, 2)
    yuv = np.stack([y, u, v], axis=-1) - YUV_OFFSET
    rgb = yuv @ YUV_TO_RGB.T
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
