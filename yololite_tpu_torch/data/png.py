"""The PNG reader's names, kept here for callers of this module.

The decoder itself is in `data/codecs.py` beside the JPEG and BMP decoders:
chunks and zlib in Python, the unfilter and sample conversion in the host C++
library. `decode_png` returns uint8 [H, W] (gray), [H, W, 3] (RGB) or
[H, W, 4] (RGBA) as libpng gives them under cv2's transforms; damaged data
raises `ValueError`.
"""

from __future__ import annotations

from yololite_tpu_torch.data.codecs import (PNG_SIGNATURE as SIGNATURE, UnsupportedImage,
                                            decode_png, png_exif, read_png)

__all__ = ["SIGNATURE", "UnsupportedImage", "decode_png", "png_exif", "read_png"]
