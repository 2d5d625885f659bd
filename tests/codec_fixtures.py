"""Writes the committed codec fixtures under tests/data/codecs/ and their
manifest, the SHA-256 and shape of each file's `cv2.imread` output.

    python tests/codec_fixtures.py

The files are small JPEGs written by `cv2.imwrite` (baseline in each
sampling, progressive, restart markers, optimized tables, luma and chroma
quality apart, EXIF orientation 6, gray), one progressive JPEG at 640x480
(which `chip_smoke.py` also times), one 24-bit BMP and one palette PNG.
`chip_smoke.py` decodes each with the port's codec on the card's machine,
which has no cv2, and holds the output to the manifest;
`tests/test_torch_port_codecs.py` regenerates the manifest from the
committed files so it cannot drift.
"""

import hashlib
import json
import os
import struct
import zlib

import cv2
import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "codecs")


def fixture_image(h: int = 45, w: int = 61, seed: int = 0) -> np.ndarray:
    """Seeded noise on a smooth gradient (BGR), so clamping is exercised."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    grad = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     (x + y) * 255 / max(h + w - 2, 1)], -1)
    return np.clip(grad + rng.randint(-90, 90, (h, w, 3)), 0, 255).astype(np.uint8)


def frame_image(h: int = 480, w: int = 640, seed: int = 0) -> np.ndarray:
    """A frame-sized image (BGR): a gradient with mild noise and a few flat
    rectangles."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / (w - 1), y * 255 / (h - 1), (x + y) * 255 / (h + w - 2)], -1)
    img = np.clip(img + rng.randint(-16, 17, (h, w, 3)), 0, 255).astype(np.uint8)
    for _ in range(6):
        x1, y1 = rng.randint(0, w - 140), rng.randint(0, h - 100)
        img[y1:y1 + rng.randint(20, 100), x1:x1 + rng.randint(20, 140)] = rng.randint(0, 256, 3)
    return img


def with_exif_orientation(jpeg: bytes, orientation: int, little_endian: bool = True) -> bytes:
    """The JPEG with an APP1 EXIF segment (one IFD0 entry, tag 0x0112)
    inserted after SOI."""
    e = "<" if little_endian else ">"
    tiff = ((b"II*\x00" if little_endian else b"MM\x00*") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHI", 0x0112, 3, 1)
            + struct.pack(e + "H", orientation) + b"\x00\x00" + b"\x00\x00\x00\x00")
    payload = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + jpeg[2:]


def palette_png(h: int = 23, w: int = 31, seed: int = 1) -> bytes:
    """An 8-bit palette PNG with a tRNS chunk (written here: cv2 writes no
    palette PNG of a colour image)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 16, (h, w)).astype(np.uint8)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
    raw = b"".join(b"\x00" + idx[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes())
            + chunk(b"tRNS", bytes(range(0, 256, 32)))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _jpeg(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def fixtures():
    """name -> file bytes."""
    img = fixture_image()
    q, s = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    out = {}
    for name in ("444", "422", "420", "411", "440"):
        out[f"baseline_{name}.jpg"] = _jpeg(img, q, 90, s,
                                            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}"))
    out["progressive_420.jpg"] = _jpeg(img, q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    out["progressive_444.jpg"] = _jpeg(img, q, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, s,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    out["progressive_640x480.jpg"] = _jpeg(frame_image(), q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    out["restart_7.jpg"] = _jpeg(img, q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 7)
    out["optimized.jpg"] = _jpeg(img, q, 60, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    out["luma90_chroma20.jpg"] = _jpeg(img, cv2.IMWRITE_JPEG_LUMA_QUALITY, 90,
                                       cv2.IMWRITE_JPEG_CHROMA_QUALITY, 20)
    out["exif_6.jpg"] = with_exif_orientation(_jpeg(img, q, 90), 6)
    out["gray.jpg"] = _jpeg(img[..., 1], q, 85)
    ok, bmp = cv2.imencode(".bmp", img)
    out["rgb24.bmp"] = bmp.tobytes()
    out["palette.png"] = palette_png()
    return out


def manifest_entry(path: str) -> dict:
    img = cv2.imread(path)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def manifest(directory: str = DIR) -> dict:
    return {name: manifest_entry(os.path.join(directory, name))
            for name in sorted(os.listdir(directory)) if name != "manifest.json"}


def main():
    os.makedirs(DIR, exist_ok=True)
    for name, data in fixtures().items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
    with open(os.path.join(DIR, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
