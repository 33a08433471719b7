"""8x13 raster font for decoder overlays (bounding boxes / pose labels).

The reference draws labels with an 8x13-per-character sprite
(``singleLineSprite`` built in tensordecutil.c:79-104 from the raster
table in tensordec-font.c). That table is the classic public SGI OpenGL
demo font (font.c, (c) 1993 Silicon Graphics — permissively licensed;
the reference's own header says "imported from font.c of
https://courses.cs.washington.edu/courses/cse457/98a/tech/OpenGL/font.c").
The byte-identical glyph data is embedded here (base64 of 95 glyphs x 13
row-bitmask bytes): golden raster-output parity with the reference's
decoder fixtures (tests/nnstreamer_decoder_boundingbox/*_golden*)
requires the exact same pixels, the same way the SSD decode math or the
96-byte flex header must match bit-for-bit.

Rendering parity (tensordecutil.c initSingleLineSprite): glyph rows are
stored bottom-up (display row ``12-j`` = raster row ``j``), bits
MSB-first left-to-right; codepoints outside printable ASCII render as
'*'; each 8x13 cell *overwrites* its area (glyph background pixels become
0), and the pen advances 9 px (tensordec-boundingbox.cc:665-675).
"""

from __future__ import annotations

import base64
from typing import Dict

import numpy as np

CHAR_WIDTH = 8
CHAR_HEIGHT = 13
CHAR_ADVANCE = 9  # 8 px glyph cell + 1 px gap (tensordec-boundingbox.cc draw())

# 95 printable-ASCII glyphs (' '..'~'), 13 bytes each, byte j = bitmask of
# display row 12-j, MSB = leftmost pixel. See module docstring for origin.
_RASTERS_B64 = (
    "AAAAAAAAAAAAAAAAAAAAGBgAABgYGBgYGBgAAAAAAAAAAAA2NjY2AAAAZmb/Zmb/ZmYAAAAA"
    "GH7/Gx9++Nj/fhgAAA4b224wGAx229hwAAB/xs/YcHDYzMxsOAAAAAAAAAAAABgcDA4AAAwY"
    "MDAwMDAwMBgMAAAwGAwMDAwMDAwYMAAAAACZWjz/PFqZAAAAAAAYGBj//xgYGAAAAAAwGBwc"
    "AAAAAAAAAAAAAAAAAP//AAAAAAAAAAA4OAAAAAAAAAAAAGBgMDAYGAwMBgYDAwAAPGbD4/Pb"
    "z8fDZjwAAH4YGBgYGBgYeDgYAAD/wMBgMBgMBgPnfgAAfucDAwd+BwMD534AAAwMDAwM/8xs"
    "PBwMAAB+5wMDB/7AwMDA/wAAfufDw8f+wMDA534AADAwMDAYDAYDAwP/AAB+58PD537nw8Pn"
    "fgAAfucDAwN/58PD534AAAA4OAAAODgAAAAAAAAwGBwcAAAcHAAAAAAABgwYMGDAYDAYDAYA"
    "AAAA//8A//8AAAAAAABgMBgMBgMGDBgwYAAAGAAAGBgMBgPDw34AAD9gz9vT3cN+AAAAAADD"
    "w8PD/8PDw2Y8GAAA/sfDw8f+x8PDx/4AAH7nwMDAwMDAwOd+AAD8zsfDw8PDw8fO/AAA/8DA"
    "wMD8wMDAwP8AAMDAwMDAwPzAwMD/AAB+58PDz8DAwMDnfgAAw8PDw8P/w8PDw8MAAH4YGBgY"
    "GBgYGBh+AAB87sYGBgYGBgYGBgAAw8bM2PDg8NjMxsMAAP/AwMDAwMDAwMDAAADDw8PDw8Pb"
    "///nwwAAx8fPz9/b+/Pz4+MAAH7nw8PDw8PDw+d+AADAwMDAwP7Hw8PH/gAAP27f28PDw8PD"
    "ZjwAAMPGzNjw/sfDw8f+AAB+5wMDB37gwMDnfgAAGBgYGBgYGBgYGP8AAH7nw8PDw8PDw8PD"
    "AAAYPDxmZsPDw8PDwwAAw+f//9vbw8PDw8MAAMNmZjw8GDw8ZmbDAAAYGBgYGBg8PGZmwwAA"
    "/8DAYDB+DAYDA/8AADwwMDAwMDAwMDA8AAMDBgYMDBgYMDBgYAAAPAwMDAwMDAwMDDwAAAAA"
    "AAAAAADDZjwY//8AAAAAAAAAAAAAAAAAAAAAAAAAABg4MHAAAH/Dw38Dw34AAAAAAAD+w8PD"
    "w/7AwMDAwAAAfsPAwMDDfgAAAAAAAH/Dw8PDfwMDAwMDAAB/wMD+w8N+AAAAAAAAMDAwMDD8"
    "MDAwMx5+wwMDf8PDw34AAAAAAADDw8PDw8P+wMDAwAAAGBgYGBgYGAAAGAA4bAwMDAwMDAwA"
    "AAwAAADGzPjw2MzGwMDAwAAAfhgYGBgYGBgYGHgAANvb29vb2/4AAAAAAADGxsbGxsb8AAAA"
    "AAAAfMbGxsbGfAAAAADAwMD+w8PDw/4AAAAAAwMDf8PDw8N/AAAAAAAAwMDAwMDg/gAAAAAA"
    "AP4DA37AwH8AAAAAAAAcNjAwMDD8MDAwAAAAfsbGxsbGxgAAAAAAABg8PGZmw8MAAAAAAADD"
    "5//bw8PDAAAAAAAAw2Y8GDxmwwAAAADAYGAwGDxmZsMAAAAAAAD/YDAYDAb/AAAAAAAADxgY"
    "GDjwOBgYGA8YGBgYGBgYGBgYGBgYAADwGBgYHA8cGBgY8AAAAAAAAAaP8WAAAAA="
)

_RASTERS = np.frombuffer(
    base64.b64decode(_RASTERS_B64), np.uint8
).reshape(95, 13)

_sprites: Dict[int, np.ndarray] = {}


def glyph(ch: str) -> np.ndarray:
    """13x8 bool mask for one character (non-ASCII renders as '*')."""
    code = ord(ch)
    if code < 32 or code >= 127:
        code = ord("*")
    if code not in _sprites:
        rows = _RASTERS[code - 32]  # (13,) row bitmasks, bottom-up
        bits = (rows[:, None] & (np.uint8(0x80) >> np.arange(8))) != 0
        _sprites[code] = bits[::-1]  # display row 12-j = raster row j
    return _sprites[code]


def draw_text(
    frame: np.ndarray, x: int, y: int, text: str, color: int = 0xFFFFFFFF
) -> None:
    """Draw ``text`` into a (h, w) uint32 RGBA canvas at (x, y) top-left.

    Mirrors the reference's glyph loop: stop when the next 8-px cell would
    overflow the right edge; each glyph cell overwrites its full 8x13 area
    (background pixels become 0) exactly like singleLineSprite blitting.
    """
    h, w = frame.shape
    if y < 0:
        y = 0
    if y >= h:  # below the canvas: nothing of the text shows
        return
    for ch in text:
        if x + CHAR_WIDTH > w:
            break
        mask = glyph(ch)
        y2 = min(y + CHAR_HEIGHT, h)
        cell = mask[: y2 - y, :]
        frame[y:y2, x : x + CHAR_WIDTH] = np.where(cell, np.uint32(color), np.uint32(0))
        x += CHAR_ADVANCE
