"""PyTorch port parity: the PNG reader, the dataset and the loader against
cv2 and the JAX package's data pipeline (CPU).

Tolerances, each with its reason:
  - decoded PNG pixels: exact (lossless format; cv2.imread is the reference);
  - `YoloDataset.get` images: exact where the image already has the target
    size (no resize), else within the letterbox tolerance of
    tests/test_torch_port_letterbox.py (the port's bilinear resize is
    torch's, cv2's rounds its fixed-point weights: at most 1 level apart);
    boxes 1e-4 px (fp32 scale and pad of the same geometry);
  - batch order, padding and `nvalid`: exact.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from yololite_tpu.data.dataset import YoloDataset as JaxYoloDataset
from yololite_tpu.data.dataset import max_instances_per_image as jax_max_instances
from yololite_tpu.data.dataset import parse_yolo_label_file as jax_parse_labels
from yololite_tpu.data.loader import DataLoader as JaxDataLoader

from chip_smoke import make_synth_set, write_png
from yololite_tpu_torch.data.dataset import (YoloDataset, max_instances_per_image,
                                             parse_yolo_label_file)
from yololite_tpu_torch.data.loader import DataLoader
from yololite_tpu_torch.data.png import UnsupportedImage, decode_png, read_png


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img, types, **header):
    """A PNG with the given per-row filter types (cycled), written from the
    filter definitions; `header` overrides IHDR fields."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w, ch).astype(np.int16)
    rows = []
    for y in range(h):
        cur, prev = x[y], (x[y - 1] if y else np.zeros_like(x[0]))
        a = np.concatenate([np.zeros((1, ch), np.int16), cur[:-1]])
        c = np.concatenate([np.zeros((1, ch), np.int16), prev[:-1]])
        t = types[y % len(types)]
        pred = [0 * cur, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][t]
        rows.append(bytes([t]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    fields = dict(w=w, h=h, depth=8, ctype={1: 0, 3: 2, 4: 6}[ch], interlace=0)
    fields.update(header)
    ihdr = struct.pack(">IIBBBBB", fields["w"], fields["h"], fields["depth"],
                       fields["ctype"], 0, 0, fields["interlace"])
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


def cv2_rgb(blob):
    """cv2's decode, channels as the file stores them (RGB[A])."""
    img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


@pytest.mark.parametrize("shape", [(7, 13), (9, 5, 3), (6, 11, 4), (1, 1, 3), (33, 47, 3)])
@pytest.mark.parametrize("types", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4, 4, 3, 1]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reader_exact_on_every_filter(shape, types):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    blob = encode_png(img, types)
    got = decode_png(blob)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, cv2_rgb(blob))


@pytest.mark.parametrize("shape", [(31, 17), (40, 29, 3), (23, 30, 4), (480, 640, 3)])
def test_png_reader_exact_on_cv2_written_files(tmp_path, shape):
    rng = np.random.RandomState(shape[0])
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    img[shape[0] // 3:, : shape[1] // 2] = 200               # flat and noisy regions
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = back if back.ndim == 2 else back[..., [2, 1, 0, 3][:back.shape[2]]]
    np.testing.assert_array_equal(read_png(path), want)


def test_png_writer_of_the_smoke_run_is_read_back(tmp_path):
    img = (np.random.RandomState(0).rand(37, 53, 3) * 255).astype(np.uint8)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "w.png"))[..., ::-1], img)


def test_png_variants_it_does_not_read_raise():
    img = np.zeros((4, 4, 3), np.uint8)
    for header in ({"depth": 16}, {"ctype": 3}, {"interlace": 1}, {"ctype": 4}):
        with pytest.raises(UnsupportedImage):
            decode_png(encode_png(img, [0], **header))
    with pytest.raises(ValueError):
        decode_png(b"GIF89a....")
    blob = bytearray(encode_png(img, [0]))
    blob[60:64] = b"\xff\xff\xff\xff"                        # damage the IDAT stream
    with pytest.raises(ValueError):
        decode_png(bytes(blob))


# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """PNG set written from a seed: 96x72 images (letterboxed) and a 64x64
    split (exactly img_size: no resize)."""
    root = str(tmp_path_factory.mktemp("synth"))
    data = make_synth_set(os.path.join(root, "wide"), n_train=10, n_val=5, w=96, h=72)
    make_synth_set(os.path.join(root, "square"), n_train=6, n_val=1, w=64, h=64, seed=1)
    return root, data


def _split(root, name, split="train"):
    return (os.path.join(root, name, split, "images"), os.path.join(root, name, split, "labels"))


@pytest.mark.parametrize("name", ["square", "wide"])
def test_dataset_get_matches_jax(synth, name):
    root, _ = synth
    imgs, labels = _split(root, name)
    jds = JaxYoloDataset(imgs, labels, img_size=64, is_train=True, augment=False,
                         max_boxes=8)
    pds = YoloDataset(imgs, labels, img_size=64, is_train=True, augment=False, max_boxes=8)
    assert len(pds) == len(jds)
    for i in range(len(pds)):
        j, p = jds.get(i), pds.get(i)
        for k in ("labels", "mask", "image_id"):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        np.testing.assert_allclose(p["boxes"], j["boxes"], atol=1e-4, rtol=0)
        if name == "square":
            np.testing.assert_array_equal(p["image"], j["image"])
        else:
            diff = np.abs(p["image"].astype(int) - j["image"].astype(int))
            assert diff.max() <= 1
    for lbl in sorted(os.listdir(labels)):
        np.testing.assert_array_equal(parse_yolo_label_file(os.path.join(labels, lbl)),
                                      jax_parse_labels(os.path.join(labels, lbl)))
    assert max_instances_per_image(labels) == jax_max_instances(labels)


def test_dataset_resize_and_npy_sources_match_jax(synth, tmp_path):
    root, _ = synth
    imgs, labels = _split(root, "wide")
    jds = JaxYoloDataset(imgs, labels, img_size=64, is_train=False, augment=False,
                         max_boxes=8, use_resize=True)
    pds = YoloDataset(imgs, labels, img_size=64, is_train=False, augment=False,
                      max_boxes=8, use_resize=True)
    j, p = jds.get(0), pds.get(0)
    np.testing.assert_allclose(p["boxes"], j["boxes"], atol=1e-4, rtol=0)
    assert np.abs(p["image"].astype(int) - j["image"].astype(int)).max() <= 1
    # a .npy of the BGR frame reads as the PNG does
    npy_dir = tmp_path / "npy"
    npy_dir.mkdir()
    name = sorted(os.listdir(imgs))[0]
    np.save(npy_dir / (name[:-4] + ".npy"), cv2.imread(os.path.join(imgs, name)))
    kw = dict(img_size=64, is_train=False, augment=False, max_boxes=8)
    q = YoloDataset(str(npy_dir), labels, **kw).get(0)
    np.testing.assert_array_equal(q["image"], YoloDataset(imgs, labels, **kw).get(0)["image"])


def test_unsupported_images_raise_and_damaged_ones_go_black(synth, tmp_path):
    root, _ = synth
    imgs, labels = _split(root, "wide", "valid")
    bad = tmp_path / "jpg"
    bad.mkdir()
    cv2.imwrite(str(bad / "a.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(UnsupportedImage, match="a.jpg"):
        YoloDataset(str(bad), labels, img_size=64, is_train=False, augment=False)
    dmg = tmp_path / "damaged"
    dmg.mkdir()
    (dmg / "0000.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    out = YoloDataset(str(dmg), labels, img_size=64, is_train=False, augment=False).get(0)
    assert out["image"].shape == (64, 64, 3) and not out["image"].any()
    assert not out["mask"].any()
    with pytest.raises(NotImplementedError, match="item 8a"):
        YoloDataset(imgs, labels, img_size=64, is_train=True, augment=True)


@pytest.mark.parametrize("shuffle,workers", [(True, 0), (True, 3), (False, 2)])
def test_loader_order_and_padding_match_jax(synth, shuffle, workers):
    root, _ = synth
    imgs, labels = _split(root, "wide")
    kw = dict(img_size=64, is_train=not shuffle, augment=False, max_boxes=8)
    jl = JaxDataLoader(JaxYoloDataset(imgs, labels, **kw), 4, shuffle=shuffle,
                       drop_last=shuffle, seed=7, num_workers=workers)
    pl = DataLoader(YoloDataset(imgs, labels, **kw), 4, shuffle=shuffle,
                    drop_last=shuffle, seed=7, num_workers=workers)
    assert len(pl) == len(jl)
    for _ in range(2):                         # two epochs: the shuffle moves on
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == (2 if shuffle else 3)
        for j, p in zip(jb, pb):
            np.testing.assert_array_equal(p["image_id"], j["image_id"])
            assert int(p["nvalid"]) == int(j["nvalid"])
            np.testing.assert_array_equal(p["mask"], j["mask"])
            np.testing.assert_allclose(p["boxes"], j["boxes"], atol=1e-4, rtol=0)
    assert pl.epoch == jl.epoch == 2
    if not shuffle:                            # final batch padded with image_id -1
        assert list(pb[-1]["image_id"][2:]) == [-1, -1] and int(pb[-1]["nvalid"]) == 2


def test_loader_reraises_a_worker_error(synth):
    root, _ = synth
    imgs, labels = _split(root, "wide")
    ds = YoloDataset(imgs, labels, img_size=64, is_train=False, augment=False)
    ds.get = lambda i, rng=None: 1 / 0
    with pytest.raises(RuntimeError, match="worker failed"):
        list(DataLoader(ds, 2, shuffle=False, num_workers=2))
