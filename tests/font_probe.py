"""Writes `yololite_tpu_torch/data/font_simplex.py`, the glyph table behind
`imgops.put_text` / `imgops.text_size`, by probing the installed cv2.

    python tests/font_probe.py

OpenCV 5.0 draws the Hershey faces with its TrueType engine: each glyph is
an anti-aliased coverage bitmap at an integer pen position, blended into the
image glyph after glyph, and the pen advances by a whole number of pixels a
glyph (no kerning). So one bitmap a glyph and size reproduces cv2.putText
exactly, and the table holds, for each printable ASCII character at the
(scale, thickness) pairs the drawing code uses: the bitmap's offset from the
pen (dx, dy), its size, the advance, and the coverage bytes. The probe
renders each character alone with colour 255 on black (where the blend
gives the coverage itself), crops the lit box, and takes the advance from
cv2.getTextSize (its width is the advances' sum plus one). The height is
getTextSize's, which does not depend on the text.
`tests/test_torch_port_viz.py` holds the result against cv2 on every
character and on random strings, origins, colours and backgrounds.
"""

import base64
import os
import zlib

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "yololite_tpu_torch", "data", "font_simplex.py")
SIZES = ((0.5, 1), (0.8, 2))
CHARS = [chr(i) for i in range(32, 127)]
ORG = (40, 40)


def probe(scale: float, thickness: int):
    """(height, blob): blob holds, per character in CHARS, the header bytes
    dx, dy (int8, from the pen), h, w, advance (uint8), then h*w coverage
    bytes."""
    face = cv2.FONT_HERSHEY_SIMPLEX
    heights = {cv2.getTextSize(c, face, scale, thickness)[0][1] for c in CHARS}
    assert len(heights) == 1, heights
    blob = bytearray()
    for c in CHARS:
        img = np.zeros((80, 120), np.uint8)
        cv2.putText(img, c, ORG, face, scale, 255, thickness)
        ys, xs = np.nonzero(img)
        adv = cv2.getTextSize(c, face, scale, thickness)[0][0] - 1
        if len(xs) == 0:
            blob += np.array([0, 0], np.int8).tobytes() + bytes([0, 0, adv])
            continue
        y0, x0 = ys.min(), xs.min()
        bm = img[y0:ys.max() + 1, x0:xs.max() + 1]
        blob += np.array([x0 - ORG[0], y0 - ORG[1]], np.int8).tobytes()
        blob += bytes([bm.shape[0], bm.shape[1], adv]) + bm.tobytes()
    return heights.pop(), bytes(blob)


def main():
    lines = ['"""cv2 5.0.0\'s FONT_HERSHEY_SIMPLEX as coverage bitmaps, written by',
             "`tests/font_probe.py` (which says how they were probed); read by",
             '`data/imgops.py`. Do not edit by hand."""', "",
             "# (scale, thickness): (text height, base64 of the zlib'd glyph records)",
             "GLYPHS = {"]
    for scale, thickness in SIZES:
        height, blob = probe(scale, thickness)
        text = base64.b64encode(zlib.compress(blob, 9)).decode()
        chunks = [text[i:i + 76] for i in range(0, len(text), 76)]
        lines.append(f"    ({scale}, {thickness}): ({height}, (")
        lines += [f'        "{c}"' for c in chunks]
        lines.append("    )),")
    lines.append("}")
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
