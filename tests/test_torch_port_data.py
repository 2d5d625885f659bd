"""PyTorch port parity: the PNG reader, the dataset and the loader against
cv2 and the JAX package's data pipeline (CPU).

Tolerances, each with its reason:
  - decoded PNG pixels: exact (lossless format; cv2.imread is the reference);
  - `YoloDataset.get` images: exact where the image already has the target
    size (no resize), else within the letterbox tolerance of
    tests/test_torch_port_letterbox.py (the port's bilinear resize is
    torch's, cv2's rounds its fixed-point weights: at most 1 level apart);
    boxes 1e-4 px (fp32 scale and pad of the same geometry);
  - augmented samples (mosaic, cutmix, the base and strong presets, with
    and without the photometric ops) on the same RandomState: labels exact,
    boxes 1e-4 px, the RandomState's state equal afterwards; pixels within
    1 level (the final letterbox; the warps, tests/test_torch_port_augment.py)
    when the mosaic tiles need no resize or no colour op follows, else
    within RESIZED_TOL on at most RESIZED_SHARE of the values (a tile's
    1-level resize difference passes through contrast and HSV, which widen
    it);
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


def _png_variant(kind, rng):
    """A PNG of each form the numpy reader used to refuse: 16-bit (cv2's
    writer), palette with tRNS, gray+alpha and Adam7 (written here)."""
    if kind == "depth16":
        ok, buf = cv2.imencode(".png", rng.randint(0, 65536, (5, 7, 3)).astype(np.uint16))
        return buf.tobytes()
    h, w = 5, 7
    if kind == "palette":
        idx = rng.randint(0, 6, (h, w)).astype(np.uint8)
        extra = (_chunk(b"PLTE", rng.randint(0, 256, 18).astype(np.uint8).tobytes())
                 + _chunk(b"tRNS", b"\x00\x80"))
        rows, ctype, interlace = [idx[y].tobytes() for y in range(h)], 3, 0
    elif kind == "gray_alpha":
        ga = rng.randint(0, 256, (h, w, 2)).astype(np.uint8)
        extra, rows, ctype, interlace = b"", [ga[y].tobytes() for y in range(h)], 4, 0
    else:                                                    # Adam7 RGB
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        extra, rows, ctype, interlace = b"", [], 2, 1
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
            sub = rgb[y0::dy, x0::dx]
            if sub.size:
                rows += [np.ascontiguousarray(r).tobytes() for r in sub]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace)
    raw = b"".join(b"\x00" + r for r in rows)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def test_png_variants_it_does_not_read_raise(tmp_path):
    """The PNG forms that raised before the host codec (16-bit, palette,
    gray+alpha, Adam7) now read as cv2.imread reads them; a file that is no
    PNG and a damaged stream still raise ValueError."""
    from yololite_tpu_torch.data.codecs import imread_bgr
    rng = np.random.RandomState(0)
    for kind in ("depth16", "palette", "gray_alpha", "adam7"):
        path = str(tmp_path / f"{kind}.png")
        with open(path, "wb") as f:
            f.write(_png_variant(kind, rng))
        np.testing.assert_array_equal(imread_bgr(path), cv2.imread(path), err_msg=kind)
        assert decode_png(open(path, "rb").read()).dtype == np.uint8
    img = np.zeros((4, 4, 3), np.uint8)
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
    """A split holding a format cv2 reads and the codecs do not (a GIF
    under a .jpg name) raises naming the file when the sample is read; a
    JPEG split builds and reads as JAX's; a damaged PNG or JPEG is a black
    sample with no targets in both packages."""
    root, _ = synth
    imgs, labels = _split(root, "wide", "valid")
    bad = tmp_path / "gif"
    bad.mkdir()
    (bad / "a.jpg").write_bytes(cv2.imencode(".gif", np.zeros((8, 8, 3), np.uint8))[1].tobytes())
    with pytest.raises(UnsupportedImage, match="a.jpg"):
        YoloDataset(str(bad), labels, img_size=64, is_train=False, augment=False).get(0)
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    cv2.imwrite(str(jpg / "a.jpg"), (np.random.RandomState(0).rand(8, 8, 3) * 255).astype(np.uint8))
    kw = dict(img_size=64, is_train=False, augment=False)
    np.testing.assert_array_equal(YoloDataset(str(jpg), labels, **kw).load_image(0),
                                  JaxYoloDataset(str(jpg), labels, **kw).load_image(0))
    dmg = tmp_path / "damaged"
    dmg.mkdir()
    (dmg / "0000.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    (dmg / "0001.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    for i in range(2):
        out = YoloDataset(str(dmg), labels, **kw).get(i)
        want = JaxYoloDataset(str(dmg), labels, **kw).get(i)
        assert out["image"].shape == (64, 64, 3) and not out["image"].any()
        np.testing.assert_array_equal(out["image"], want["image"])
        assert not out["mask"].any()
    # a training set with augmentation builds and draws a sample (this
    # raised before host augmentation was ported)
    aug = YoloDataset(imgs, labels, img_size=64, is_train=True, augment=True).get(
        0, np.random.RandomState(0))
    assert aug["image"].shape == (64, 64, 3) and aug["image"].dtype == np.uint8


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


# --------------------------------------------------------------------------- #
# Augmentation: mosaic, cutmix, the presets, the taper's switches
# --------------------------------------------------------------------------- #
# tiles resized for a mosaic, then colour ops: 2 levels on 6.5e-4 of the
# values at most over 40 seeds
RESIZED_TOL, RESIZED_SHARE = 4, 3e-3
AUG_CASES = {   # name: (split, dataset keyword arguments, tolerance, share > 1 level)
    "mosaic": ("square", dict(mosaic_p=1.0, cutmix_p=0.0), 1, 0.0),
    "mosaic_resized_tiles": ("wide", dict(mosaic_p=1.0, cutmix_p=0.0),
                             RESIZED_TOL, RESIZED_SHARE),
    "cutmix": ("wide", dict(mosaic_p=0.0, cutmix_p=1.0), 1, 0.0),
    "base": ("wide", {}, RESIZED_TOL, RESIZED_SHARE),
    "base_square": ("square", {}, 1, 0.0),
    "strong": ("square", dict(aug_preset="strong"), 1, 0.0),
    "geometry_only": ("wide", dict(photometric=False), 1, 0.0),
    "strong_geometry_only": ("wide", dict(aug_preset="strong", photometric=False), 1, 0.0),
}


def _same_rng(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


def _assert_sample(p, j, tol, share):
    for k in ("labels", "mask", "image_id"):
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    np.testing.assert_allclose(p["boxes"], j["boxes"], atol=1e-4, rtol=0)
    d = np.abs(p["image"].astype(int) - j["image"].astype(int))
    assert d.max() <= tol, f"max diff {d.max()}"
    assert (d > 1).mean() <= share, f"{(d > 1).mean():.2e} of the values > 1 level apart"


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_augmented_get_matches_jax(synth, case):
    root, _ = synth
    split, kw, tol, share = AUG_CASES[case]
    imgs, labels = _split(root, split)
    args = dict(img_size=64, is_train=True, augment=True, max_boxes=24, **kw)
    jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
    for seed in range(12):
        i = seed % len(pds)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        j, p = jds.get(i, rj), pds.get(i, rp)
        _same_rng(rj, rp)
        _assert_sample(p, j, tol, share)


def test_mosaic_and_cutmix_alone_match_jax(synth):
    root, _ = synth
    for split, tol in (("square", 0), ("wide", 1)):
        imgs, labels = _split(root, split)
        args = dict(img_size=64, is_train=True, augment=True, max_boxes=24)
        jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
        for seed in range(6):
            rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
            (ji, jb, jl), (pi, pb, pl) = jds.mosaic(seed % len(jds), rj), pds.mosaic(seed % len(pds), rp)
            _same_rng(rj, rp)
            assert np.abs(pi.astype(int) - ji.astype(int)).max() <= tol
            np.testing.assert_allclose(pb, jb, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(pl, jl)
            img = jds.load_image(0)
            b, l = jds.load_label_processed(0, *img.shape[:2])
            other = (seed + 1) % len(jds)
            ji, jb, jl = jds.cutmix_focus_small(img, b, l, other, rj)
            pi, pb, pl = pds.cutmix_focus_small(pds.load_image(0), b, l, other, rp)
            _same_rng(rj, rp)
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_allclose(pb, jb, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(pl, jl)


def test_taper_switches_match_jax(synth):
    """set_mosaic_cutmix / set_augment / set_img_size leave the port's
    dataset in the JAX dataset's state, and its samples follow."""
    root, _ = synth
    imgs, labels = _split(root, "square")
    args = dict(img_size=64, is_train=True, augment=True, max_boxes=24)
    jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)

    def state(ds):
        return (ds.mosaic_p, ds.cutmix_p, ds.augment_enabled, type(ds.transform).__name__,
                ds.transform.img_size)

    def same_sample(seed):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        _assert_sample(pds.get(1, rp), jds.get(1, rj), 1, 0.0)
        _same_rng(rj, rp)

    assert state(pds) == state(jds) == (0.2, 0.2, True, "TrainTransform", 64)
    for step in (lambda d: d.set_mosaic_cutmix(0.0, 0.0), lambda d: d.set_img_size(96),
                 lambda d: d.set_img_size(64), lambda d: d.set_augment(False),
                 lambda d: d.set_augment(True)):
        step(jds)
        step(pds)
        assert state(pds) == state(jds)
        same_sample(3)
    assert state(pds) == (0.0, 0.0, True, "TrainTransform", 64)
    val = YoloDataset(imgs, labels, img_size=64, is_train=False, augment=True)
    assert not val.augment_enabled and val.mosaic_p == 0.0 and val.cutmix_p == 0.0


def test_augmented_loader_matches_jax_across_threads(synth):
    """The loader's per-sample RNGs give JAX's augmented batches, and the
    same batches on a second pass over the same epoch."""
    root, _ = synth
    imgs, labels = _split(root, "square")
    kw = dict(img_size=64, is_train=True, augment=True, max_boxes=24)
    jl = JaxDataLoader(JaxYoloDataset(imgs, labels, **kw), 3, shuffle=True, seed=5,
                       num_workers=4)
    pl = DataLoader(YoloDataset(imgs, labels, **kw), 3, shuffle=True, seed=5, num_workers=4)
    jb, pb = list(jl), list(pl)
    pl.epoch = 0
    again = list(pl)
    for j, p, q in zip(jb, pb, again):
        for k in ("image", "boxes", "labels", "mask", "image_id"):
            np.testing.assert_array_equal(q[k], p[k])
        np.testing.assert_array_equal(p["labels"], j["labels"])
        np.testing.assert_allclose(p["boxes"], j["boxes"], atol=1e-4, rtol=0)
        assert np.abs(p["image"].astype(int) - j["image"].astype(int)).max() <= 1


def test_strong_preset_kept_across_a_size_switch(synth):
    """JAX's set_img_size keeps only a TrainTransform, so its strong preset
    falls back to letterbox-only samples after a multi-scale switch; the
    port keeps the preset (ROADMAP Queue 3)."""
    root, _ = synth
    imgs, labels = _split(root, "square")
    args = dict(img_size=64, is_train=True, augment=True, aug_preset="strong")
    jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
    for ds in (jds, pds):
        assert type(ds.transform).__name__ == "StrongTrainTransform"
        ds.set_img_size(96)
    assert type(jds.transform).__name__ == "ValTransform"
    assert type(pds.transform).__name__ == "StrongTrainTransform"
    assert pds.transform.img_size == 96 and pds.get(0, np.random.RandomState(0))[
        "image"].shape == (96, 96, 3)
