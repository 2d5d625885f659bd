"""PyTorch port parity, segmentation data: `imgops.fill_poly` against
cv2.fillPoly, polygon labels, seg samples (plain and augmented), the loader's
collate and the device-side unpack of the bit-packed masks, against cv2 and
the JAX package's dataset (CPU).

Tolerances, each with its reason:
  - fill_poly vs cv2.fillPoly (LINE_8, shift 0) on random convex,
    non-convex and self-intersecting polygons, in and partly out of the
    image: bit-exact (the port follows OpenCV 5.0's fixed-point arithmetic);
  - seg samples on the same RandomState: labels, the instance mask,
    "masks_packed" and "gt_rles" exact (the polygon points take the same
    float32 numpy ops in both packages, and the fill is exact); boxes
    1e-4 px; the RandomState's state equal after each call; pixels within 1
    level where no resize runs before a colour op, else within 4 levels on
    at most 3e-3 of the values (the uint8 resize and warp tolerances of
    tests/test_torch_port_data.py);
  - the device unpack vs np.unpackbits: exact.
"""

import glob

import cv2
import numpy as np
import pytest
import torch

from yololite_tpu.data.dataset import YoloDataset as JaxYoloDataset
from yololite_tpu.data.dataset import parse_yolo_seg_file as jax_parse_seg
from yololite_tpu.data.loader import collate as jax_collate

from chip_smoke import make_seg_set, seg_polygon
from yololite_tpu_torch.data.dataset import YoloDataset, parse_yolo_seg_file
from yololite_tpu_torch.data.imgops import clip_line, fill_poly
from yololite_tpu_torch.data.loader import DataLoader, collate
from yololite_tpu_torch.train.steps import gt_masks_from_batch

RESIZED_TOL, RESIZED_SHARE = 4, 3e-3


# --------------------------------------------------------------------------- #
# fill_poly
# --------------------------------------------------------------------------- #
def _random_polygon(rng, kind, h, w):
    n = rng.randint(3, 12)
    if kind == "convex":
        ang = np.sort(rng.rand(n) * 2 * np.pi)
        r = rng.uniform(1, max(h, w) / 2)
        pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
    elif kind == "nonconvex":        # a star: radii alternate
        ang = np.arange(n) * 2 * np.pi / n
        r = np.where(np.arange(n) % 2, 0.3, 1.0) * rng.uniform(2, max(h, w) / 2)
        pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
    elif kind == "selfintersecting":
        pts = np.stack([rng.randint(0, w, n), rng.randint(0, h, n)], 1)
    else:                            # vertices up to a third outside the image
        pts = np.stack([rng.randint(-w // 3, w + w // 3, n),
                        rng.randint(-h // 3, h + h // 3, n)], 1)
    return np.round(pts).astype(np.int32)


@pytest.mark.parametrize("kind", ["convex", "nonconvex", "selfintersecting", "outside"])
def test_fill_poly_equals_cv2(kind):
    rng = np.random.RandomState(len(kind))
    for _ in range(300):
        h, w = rng.randint(1, 90), rng.randint(1, 90)
        pts = _random_polygon(rng, kind, h, w)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = fill_poly(np.zeros((h, w), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {pts.tolist()}")


def test_fill_poly_on_full_size_labels_and_clip_line():
    """The shapes the seg set writer draws, at 640x480 and at their
    prototype resolution (vertices rounded onto the 160 grid, one of them
    at 160: past the last column, as `np.round(poly * 0.25)` gives)."""
    rng = np.random.RandomState(0)
    for i in range(30):
        poly = np.asarray(seg_polygon(rng, ("rect", "tri", "ell")[i % 3], 640, 480))
        for scale, (h, w) in ((1.0, (480, 640)), (0.25, (160, 160))):
            pts = np.round(poly * scale).astype(np.int32)
            pts[0] = (160, 160) if scale < 1 else pts[0]
            want = np.zeros((h, w), np.uint8)
            cv2.fillPoly(want, [pts], 1)
            np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts, 1), want)
    for _ in range(500):
        p1, p2 = (tuple(int(v) for v in rng.randint(-40, 80, 2)) for _ in range(2))
        ok, a, b = cv2.clipLine((0, 0, 40, 30), p1, p2)
        assert clip_line(40, 30, p1, p2) == (ok, a, b)


# --------------------------------------------------------------------------- #
# samples
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def segsets(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    return {"square": make_seg_set(str(root / "square"), 8, 4, w=64, h=64, seed=1),
            "wide": make_seg_set(str(root / "wide"), 8, 4, w=80, h=60, seed=2)}


def _split(data_yaml, split="train"):
    root = data_yaml.rsplit("/", 1)[0]
    return f"{root}/{split}/images", f"{root}/{split}/labels"


def _same_rng(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


def _assert_seg_sample(p, j, tol, share):
    assert sorted(p) == sorted(j)
    for k in ("labels", "mask", "image_id", "masks_packed"):
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    np.testing.assert_allclose(p["boxes"], j["boxes"], atol=1e-4, rtol=0)
    if "gt_rles" in j:
        assert len(p["gt_rles"]) == len(j["gt_rles"]) == int(j["mask"].sum())
        for a, b in zip(p["gt_rles"], j["gt_rles"]):
            assert a["size"] == b["size"]
            np.testing.assert_array_equal(a["counts"], b["counts"])
    d = np.abs(p["image"].astype(int) - j["image"].astype(int))
    assert d.max() <= tol, f"max diff {d.max()}"
    assert (d > 1).mean() <= share


def test_polygon_labels_parse_as_jax(segsets, tmp_path):
    _, labels = _split(segsets["wide"])
    odd = tmp_path / "odd.txt"
    odd.write_text("0 0.5 0.5 0.2 0.4\n1 0.1 0.1 0.3 0.1 0.2 0.4\n2 bad 0.1 0.2 0.3\n")
    for path in sorted(glob.glob(f"{labels}/*.txt")) + [str(odd)]:
        got, want = parse_yolo_seg_file(path), jax_parse_seg(path)
        assert [c for c, _ in got] == [c for c, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split,is_train", [("square", False), ("wide", False),
                                            ("square", True)])
def test_plain_seg_samples_match_jax(segsets, split, is_train):
    """Validation samples (letterbox only, RLEs, cached) and unaugmented
    training samples (no RLEs)."""
    imgs, labels = _split(segsets[split], "valid" if not is_train else "train")
    kw = dict(img_size=64, is_train=is_train, augment=False, max_boxes=8, task="segment",
              want_rles=not is_train)
    jds, pds = JaxYoloDataset(imgs, labels, **kw), YoloDataset(imgs, labels, **kw)
    tol = 0 if split == "square" else 1
    for i in range(len(pds)):
        j, p = jds.get(i), pds.get(i)
        _assert_seg_sample(p, j, tol, 0.0)
        assert p["masks_packed"].shape == (8, 16, 2)
    if not is_train:    # the val cache hands out the same arrays again
        assert pds.get(0) is pds.get(0) and jds.get(0) is jds.get(0)


SEG_AUG_CASES = {   # name: (split, dataset keyword arguments, tolerance, share)
    "mosaic": ("square", dict(mosaic_p=1.0, cutmix_p=0.0), 1, 0.0),
    "mosaic_resized_tiles": ("wide", dict(mosaic_p=1.0, cutmix_p=0.0),
                             RESIZED_TOL, RESIZED_SHARE),
    "cutmix": ("wide", dict(mosaic_p=0.0, cutmix_p=1.0), 1, 0.0),
    "base": ("wide", {}, RESIZED_TOL, RESIZED_SHARE),
    "geometry_only": ("square", dict(photometric=False), 1, 0.0),
}


@pytest.mark.parametrize("case", sorted(SEG_AUG_CASES))
def test_augmented_seg_samples_match_jax(segsets, case):
    split, kw, tol, share = SEG_AUG_CASES[case]
    imgs, labels = _split(segsets[split])
    args = dict(img_size=64, is_train=True, augment=True, max_boxes=24, task="segment",
                want_rles=True, **kw)
    jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
    pasted = 0
    for seed in range(12):
        i = seed % len(pds)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        j, p = jds.get(i, rj), pds.get(i, rp)
        _same_rng(rj, rp)
        _assert_seg_sample(p, j, tol, share)
        pasted += int(p["mask"].sum()) > len(pds.poly_cache[i])
    if case == "cutmix":
        assert pasted > 0            # the copy-paste added instances


def test_cutmix_segment_alone_matches_jax(segsets):
    imgs, labels = _split(segsets["wide"])
    args = dict(img_size=64, is_train=True, augment=True, max_boxes=24, task="segment")
    jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
    for seed in range(8):
        i, other = seed % len(pds), (seed + 3) % len(pds)
        img = pds.load_image(i)
        h, w = img.shape[:2]
        polys = [q * np.array([w, h], np.float32) for _, q in pds.poly_cache[i]]
        labs = np.array([c for c, _ in pds.poly_cache[i]], np.int64)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        ji, jpoly, jl = jds.cutmix_segment(jds.load_image(i), polys, labs, other, rj)
        pi, ppoly, pl = pds.cutmix_segment(img, polys, labs, other, rp)
        _same_rng(rj, rp)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)
        for a, b in zip(ppoly, jpoly):
            np.testing.assert_array_equal(a, b)


def test_seg_loader_collates_and_device_unpack(segsets):
    imgs, labels = _split(segsets["wide"], "valid")
    kw = dict(img_size=64, is_train=False, augment=False, max_boxes=8, task="segment")
    pds, jds = YoloDataset(imgs, labels, **kw), JaxYoloDataset(imgs, labels, **kw)
    batches = list(DataLoader(pds, 3, shuffle=False, drop_last=False))
    assert [int(b["nvalid"]) for b in batches] == [3, 1]
    last = batches[-1]
    assert last["masks_packed"].shape == (3, 8, 16, 2)
    assert [len(r) for r in last["gt_rles"][1:]] == [0, 0]        # padding images
    want = jax_collate([jds.get(i) for i in range(3)])
    got = collate([pds.get(i) for i in range(3)])
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["masks_packed"], want["masks_packed"])
    packed = torch.from_numpy(got["masks_packed"])
    np.testing.assert_array_equal(
        gt_masks_from_batch({"masks_packed": packed}).numpy(),
        np.unpackbits(got["masks_packed"], axis=-1, count=16))
    raw = torch.ones(1, 2, 4, 4)
    assert gt_masks_from_batch({"masks": raw}) is raw
    assert gt_masks_from_batch({}) is None
