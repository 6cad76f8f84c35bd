"""Box-overlay visualization in numpy (counterpart of
`grove_tpu/utils/visualize.py`, which draws with PIL).

`draw_boxes` draws each outline pixel for pixel as PIL's
`ImageDraw.rectangle(outline=, width=)` does: corners truncated toward
zero, `width` horizontal rows at the top and the bottom over [x0, x1], and
vertical runs from y0 + width toward y1 - width + 1 (the last row left
out, a run that ends where it starts drawing nothing). Labels are drawn in
a 3 x 5 bitmap font kept here (lowercase as uppercase, other characters as
a block), where the JAX function uses PIL's default font: the one
difference between the two outputs. `render_grounded_clip` writes an
animated GIF89a (200 ms a frame, looping) with the standard library: each
frame's exact palette when it has at most 256 colours, else a 3-3-2 RGB
palette, and LZW codes that stay 9 bits wide (a clear code every 254
pixels).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Sequence

import numpy as np

_COLORS = [(255, 64, 64), (64, 200, 64), (64, 128, 255), (255, 200, 0),
           (200, 64, 255), (0, 220, 220), (255, 128, 0), (128, 128, 255)]

# 3 x 5 glyphs: five rows, each a digit whose 3 bits are the row's pixels
# (most significant on the left)
_GLYPHS = dict(item.split(":") for item in (
    "A:25755 B:65656 C:34443 D:65556 E:74647 F:74644 G:34553 H:55755 "
    "I:72227 J:11152 K:55655 L:44447 M:57755 N:65555 O:25552 P:65644 "
    "Q:25573 R:65655 S:34216 T:72222 U:55557 V:55552 W:55775 X:55255 "
    "Y:55222 Z:71247 0:75557 1:26227 2:61247 3:61216 4:55711 5:74616 "
    "6:34757 7:71222 8:75757 9:75716 .:00002 ,:00024 -:00700 _:00007 "
    "':22000 ;:02024 !:22202 ?:61202 /:11244 (:12221 ):42224").split())
_GLYPHS[":"] = "02020"
_GLYPHS[" "] = "00000"
_BLOCK = "77777"


def _paint(img, rows, cols, color):
    """Set the pixels (rows, cols) of img that lie inside it."""
    h, w = img.shape[:2]
    keep = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    img[rows[keep], cols[keep]] = color


def _hline(img, y, xa, xb, color):
    xs = np.arange(min(xa, xb), max(xa, xb) + 1)
    _paint(img, np.full_like(xs, y), xs, color)


def _vline(img, x, ya, yb, color):
    """PIL's vertical line: from ya toward yb, yb itself left out."""
    ys = np.arange(ya, yb) if ya <= yb else np.arange(yb + 1, ya + 1)
    _paint(img, ys, np.full_like(ys, x), color)


def _rectangle(img, box, color, width: int):
    x0, y0, x1, y1 = (int(float(v)) for v in box)
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    for i in range(width):
        _hline(img, y0 + i, x0, x1, color)
        _hline(img, y1 - i, x0, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def _text(img, xy, text: str, color):
    """`text` in the 3 x 5 font, its top left corner at xy, one blank
    column between characters."""
    x, y = (int(float(v)) for v in xy)
    for ch in text:
        glyph = _GLYPHS.get(ch.upper(), _BLOCK)
        for r, row in enumerate(glyph):
            for c in range(3):
                if int(row) >> (2 - c) & 1:
                    _paint(img, np.array([y + r]), np.array([x + c]), color)
        x += 4


def draw_boxes(frame: np.ndarray, boxes, labels: Optional[Sequence[str]] =
               None, width: int = 2) -> np.ndarray:
    """(H, W, 3) uint8 + (K, 4) xyxy -> a new annotated uint8 frame."""
    img = np.array(frame.astype(np.uint8), copy=True)
    for i, box in enumerate(np.asarray(boxes).reshape(-1, 4)):
        color = _COLORS[i % len(_COLORS)]
        _rectangle(img, box, color, width)
        if labels is not None and i < len(labels):
            _text(img, (float(box[0]) + 2, float(box[1]) + 2), labels[i],
                  color)
    return img


def gif_palette(frame: np.ndarray):
    """(H, W, 3) uint8 -> (palette (256, 3) uint8, indices (H*W,) uint8):
    the frame's own colours when there are at most 256, else the 3-3-2 RGB
    palette (each channel's level spread over 0..255)."""
    rgb = frame.reshape(-1, 3).astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    colors, idx = np.unique(packed, return_inverse=True)
    if len(colors) <= 256:
        pal = np.stack([colors >> 16, (colors >> 8) & 255, colors & 255], 1)
    else:
        idx = ((rgb[:, 0] >> 5) << 5) | ((rgb[:, 1] >> 5) << 2) | (
            rgb[:, 2] >> 6)
        code = np.arange(256)
        pal = np.stack([(code >> 5) * 255 // 7, ((code >> 2) & 7) * 255 // 7,
                        (code & 3) * 255 // 3], 1)
    out = np.zeros((256, 3), np.uint8)
    out[:len(pal)] = pal
    return out, idx.astype(np.uint8)


def _lzw(indices: np.ndarray) -> bytes:
    """GIF LZW data (minimum code size 8) for 8-bit indices: a clear code
    before every 254 pixels keeps the decoder's table below 512 entries,
    so every code is a 9-bit literal."""
    chunk, clear, end = 254, 256, 257
    n = len(indices)
    codes = np.full(n + -(-n // chunk) + 1, clear, np.uint16)
    at = np.arange(n)
    codes[at + at // chunk + 1] = indices
    codes[-1] = end
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return b"\x08" + blocks + b"\x00"


def write_gif(path: str, frames: np.ndarray, duration_ms: int = 200,
              loop: int = 0) -> None:
    """(T, H, W, 3) uint8 -> an animated GIF89a: a local palette a frame
    (`gif_palette`), `duration_ms` a frame, `loop` (0: for ever)."""
    frames = np.asarray(frames, np.uint8)
    h, w = frames.shape[1:3]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01", struct.pack("<H", loop),
           b"\x00"]
    for frame in frames:
        pal, idx = gif_palette(frame)
        out += [b"\x21\xf9\x04\x04", struct.pack("<H", duration_ms // 10),
                b"\x00\x00", b"\x2c", struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                pal.tobytes(), _lzw(idx)]
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def render_grounded_clip(frames: np.ndarray, result: Dict,
                         out_path: Optional[str] = None):
    """Overlay a GroveProcessor.generate result onto decoded frames.

    frames: (T, H, W, 3) uint8 aligned with result["frame_indices"]. Returns
    annotated frames; writes an animated GIF when out_path is given."""
    out = []
    for i, fi in enumerate(result["frame_indices"]):
        if fi >= len(frames):
            continue
        out.append(draw_boxes(frames[fi], result["bboxes"][i],
                              result["labels_per_frame"][i]))
    out_np = np.stack(out) if out else frames
    if out_path:
        write_gif(out_path, out_np)
    return out_np
