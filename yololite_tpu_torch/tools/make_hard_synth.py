"""HardSynth-20, the repo's hard synthetic detection suite (port of
`tools/make_hard_synth.py`).

    python -m yololite_tpu_torch.tools.make_hard_synth --out /tmp/hardsynth \
        --n_train 1600 --n_val 400 [--base 640] [--seed 7] [--seg]

20 classes (5 shapes x 4 textures), 8-48 objects an image at 10-120 px (at
base 640), occlusion up to ~50%, Zipf(1.3) class imbalance, aspect ratios
4:3 to 16:9 both ways, gradient / blotch / line-art clutter, brightness,
contrast, noise and blur. YOLO txt labels (boxes, or with --seg the largest
visible region of each instance as one polygon, holes joined by a slit),
JPEG images at quality 92 and a data.yaml. The same seed gives the same
labels and polygons as the JAX package's tool: the same RandomState draws
in the same order, and the drawing, blur and contour calls follow OpenCV
5.0's arithmetic (`data/imgops.py`; the cubic resize of the blotch map is
within 2 ulp of cv2's, so a pixel may differ by one level). Host numpy
only: no cv2 or PyYAML.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from yololite_tpu_torch.config.config import dump_yaml
from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.imwrite import write_jpeg

SHAPES = ["circle", "square", "triangle", "star", "ring"]
TEXTURES = ["solid", "striped", "dotted", "gradient"]
CLASSES = [f"{s}_{t}" for s in SHAPES for t in TEXTURES]  # 20
ASPECTS = [(4, 3), (3, 4), (16, 9), (9, 16), (3, 2), (2, 3), (1, 1)]
JPEG_QUALITY = 92


def _zipf_probs(n: int, a: float = 1.3) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def _texture_patch(rng, size: int, texture: str, color, color2):
    """Square texture patch later masked by the shape."""
    patch = np.zeros((size, size, 3), np.float32)
    if texture == "solid":
        patch[:] = color
    elif texture == "striped":
        period = max(3, size // 5)
        yy = np.arange(size)
        stripe = ((yy // max(1, period // 2)) % 2).astype(np.float32)
        patch[:] = color
        patch[stripe > 0.5, :] = color2
    elif texture == "dotted":
        patch[:] = color
        step = max(4, size // 4)
        r = max(1, step // 3)
        for y in range(step // 2, size, step):
            for x in range(step // 2, size, step):
                imgops.fill_circle(patch, (x, y), r, color2)
    elif texture == "gradient":
        t = np.linspace(0.0, 1.0, size, dtype=np.float32)[None, :, None]
        patch = np.asarray(color, np.float32) * (1 - t) + \
            np.asarray(color2, np.float32) * t
        patch = np.broadcast_to(patch, (size, size, 3)).copy()
    return patch


def _shape_mask(rng, size: int, shape: str) -> np.ndarray:
    m = np.zeros((size, size), np.uint8)
    c = size // 2
    r = size // 2 - 1
    if shape == "circle":
        imgops.fill_circle(m, (c, c), r, 1)
    elif shape == "square":
        imgops.rectangle(m, (1, 1), (size - 2, size - 2), 1, -1)
    elif shape == "triangle":
        pts = np.array([[c, 1], [1, size - 2], [size - 2, size - 2]], np.int32)
        imgops.fill_poly(m, pts, 1)
    elif shape == "star":
        ang = np.linspace(-np.pi / 2, 1.5 * np.pi, 11)[:-1]
        rad = np.where(np.arange(10) % 2 == 0, r, r * 0.45)
        pts = np.stack([c + rad * np.cos(ang), c + rad * np.sin(ang)], 1)
        imgops.fill_poly(m, pts.astype(np.int32), 1)
    elif shape == "ring":
        imgops.fill_circle(m, (c, c), r, 1)
        imgops.fill_circle(m, (c, c), max(1, int(r * 0.55)), 0)
    return m


def _clutter_background(rng, h: int, w: int) -> np.ndarray:
    # gradient field
    a = rng.rand(3) * 120 + 40
    b = rng.rand(3) * 120 + 40
    t = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    if rng.rand() < 0.5:
        t = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = (a * (1 - t) + b * t) * np.ones((h, w, 3), np.float32)
    # low-frequency blotches
    small = rng.rand(h // 32 + 1, w // 32 + 1, 3).astype(np.float32) * 70 - 35
    img += np.stack([imgops.resize_cubic_f32(small[..., k], w, h) for k in range(3)], -1)
    # distractor line art (belongs to no class)
    for _ in range(rng.randint(4, 14)):
        p1 = (rng.randint(0, w), rng.randint(0, h))
        p2 = (rng.randint(0, w), rng.randint(0, h))
        col = tuple(float(v) for v in rng.rand(3) * 255)
        imgops.line(img, p1, p2, col, rng.randint(1, 3))
    return img


def _place(rng, img, used_boxes, size, cls_id, max_overlap=0.5, tries=12,
           full_mask=None):
    """Try to place one instance; allows partial occlusion up to max_overlap.
    With full_mask=(h,w), also returns the instance's full-image binary mask
    (segmentation mode)."""
    h, w = img.shape[:2]
    if size >= min(h, w) - 2:
        return None
    shape, texture = CLASSES[cls_id].split("_")
    for _ in range(tries):
        x1 = rng.randint(0, w - size)
        y1 = rng.randint(0, h - size)
        box = np.array([x1, y1, x1 + size, y1 + size], np.float32)
        ok = True
        for ub in used_boxes:
            ix = max(0.0, min(box[2], ub[2]) - max(box[0], ub[0]))
            iy = max(0.0, min(box[3], ub[3]) - max(box[1], ub[1]))
            inter = ix * iy
            if inter / (size * size) > max_overlap:
                ok = False
                break
        if not ok:
            continue
        hue = rng.rand(3) * 200 + 30
        hue2 = np.clip(hue + (rng.rand(3) * 160 - 80), 0, 255)
        patch = _texture_patch(rng, size, texture, hue, hue2)
        mask = _shape_mask(rng, size, shape)
        region = img[y1:y1 + size, x1:x1 + size]
        region[mask > 0] = patch[mask > 0]
        ys, xs = np.nonzero(mask)
        tight = np.array([x1 + xs.min(), y1 + ys.min(),
                          x1 + xs.max() + 1, y1 + ys.max() + 1], np.float32)
        if full_mask is not None:
            fm = np.zeros(full_mask, np.uint8)
            fm[y1:y1 + size, x1:x1 + size] = mask
            return tight, fm
        return tight
    return None


def _visible_polygon(vis_mask: np.ndarray):
    """Largest visible component of an instance mask -> one simple polygon.

    Holes (the ring class, or occluders punching through the middle) are
    carried via the standard slit trick: outer contour + reversed hole
    contour joined at their nearest points form one simple polygon whose
    rasterization reproduces the mask with the hole.
    """
    cnts, hier = imgops.find_contours(vis_mask)
    if not cnts or hier is None:
        return None
    hier = hier[0]
    # largest outer contour (the first of equal areas)
    outers = [i for i in range(len(cnts)) if hier[i][3] < 0]
    if not outers:
        return None
    oi = max(outers, key=lambda i: imgops.contour_area(cnts[i]))
    outer = cnts[oi][:, 0, :].astype(np.float32)
    if len(outer) < 3:
        return None
    # largest hole of that contour (one slit is enough for this suite)
    holes = [i for i in range(len(cnts)) if hier[i][3] == oi]
    if holes:
        hi = max(holes, key=lambda i: imgops.contour_area(cnts[i]))
        hole = cnts[hi][:, 0, :].astype(np.float32)
        if len(hole) >= 3 and imgops.contour_area(cnts[hi]) > 4:
            d = np.linalg.norm(outer[:, None, :] - hole[None, :, :], axis=-1)
            a, b = np.unravel_index(np.argmin(d), d.shape)
            outer = np.concatenate([
                outer[:a + 1], hole[b:], hole[:b + 1], outer[a:]], axis=0)
    return outer


def make_image(rng, base: int = 640, seg: bool = False):
    """One scene: (RGB uint8 image, boxes [N, 4] xyxy float32, labels [N],
    polygons (seg) or None)."""
    aw, ah = ASPECTS[rng.randint(len(ASPECTS))]
    if aw >= ah:
        w, h = base, int(round(base * ah / aw))
    else:
        h, w = base, int(round(base * aw / ah))
    img = _clutter_background(rng, h, w)
    probs = _zipf_probs(len(CLASSES))
    n_obj = rng.randint(8, 49)
    boxes, labels, inst_masks = [], [], []
    for _ in range(n_obj):
        cls_id = int(rng.choice(len(CLASSES), p=probs))
        # log-uniform sizes, biased small: 10..120 px (at base 640)
        size = int(np.exp(rng.uniform(np.log(10), np.log(120))))
        placed = _place(rng, img, boxes, size, cls_id, full_mask=(h, w))
        if placed is None:
            continue
        tight, fmask = placed
        boxes.append(tight)
        labels.append(cls_id)
        inst_masks.append(fmask)
    # one annotation policy for both modes: an instance whose visible area
    # (its mask minus everything drawn later) falls under 25% is dropped
    polys = None if not seg else []
    kboxes, klabels = [], []
    for i, m in enumerate(inst_masks):
        vis = m.copy()
        for later in inst_masks[i + 1:]:
            vis[later > 0] = 0
        if vis.sum() < 0.25 * m.sum():
            continue
        if seg:
            poly = _visible_polygon(vis)
            if poly is None:
                continue
            x1, y1 = poly.min(axis=0)
            x2, y2 = poly.max(axis=0)
            if (x2 - x1) < 3 or (y2 - y1) < 3:
                continue
            polys.append(poly)
            kboxes.append(np.array([x1, y1, x2 + 1, y2 + 1], np.float32))
        else:
            kboxes.append(boxes[i])
        klabels.append(labels[i])
    boxes, labels = kboxes, klabels
    # photometric nuisance
    img = img * rng.uniform(0.75, 1.25) + rng.uniform(-20, 20)
    img += rng.randn(h, w, 3) * rng.uniform(0, 8)
    if rng.rand() < 0.3:
        img = imgops.gaussian_blur3(img)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return (img, np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels), polys)


def label_lines(boxes, labels, polys, w: int, h: int, seg: bool):
    """The YOLO txt rows of one image: `cls cx cy bw bh` (6 decimals) or,
    with seg, `cls x1 y1 ...` normalized and clipped (5 decimals)."""
    lines = []
    for j, ((x1, y1, x2, y2), c) in enumerate(zip(boxes, labels)):
        if seg:
            pts = polys[j] / np.array([w, h], np.float32)
            pts = np.clip(pts, 0.0, 1.0)
            coords = " ".join(f"{v:.5f}" for v in pts.reshape(-1))
            lines.append(f"{int(c)} {coords}")
        else:
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            bw, bh = (x2 - x1) / w, (y2 - y1) / h
            lines.append(f"{int(c)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
    return lines


def write_split(root, split, n, seed, base, seg=False):
    """n images of one split under root/<split>/{images,labels}; returns the
    instances a class."""
    idir = os.path.join(root, split, "images")
    ldir = os.path.join(root, split, "labels")
    os.makedirs(idir, exist_ok=True)
    os.makedirs(ldir, exist_ok=True)
    rng = np.random.RandomState(seed)
    counts = np.zeros(len(CLASSES), np.int64)
    for i in range(n):
        img, boxes, labels, polys = make_image(rng, base, seg=seg)
        h, w = img.shape[:2]
        write_jpeg(os.path.join(idir, f"{i:05d}.jpg"), img, JPEG_QUALITY)
        lines = label_lines(boxes, labels, polys, w, h, seg)
        for c in labels:
            counts[int(c)] += 1
        with open(os.path.join(ldir, f"{i:05d}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return counts


def write_data_yaml(out: str, names) -> str:
    """data.yaml with the train and val image dirs, nc and names (keys in
    PyYAML's sorted order)."""
    path = os.path.join(out, "data.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml({"names": list(names), "nc": len(names),
                           "train": f"{out}/train/images", "val": f"{out}/valid/images"}))
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_train", type=int, default=1600)
    ap.add_argument("--n_val", type=int, default=400)
    ap.add_argument("--base", type=int, default=640)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seg", action="store_true",
                    help="emit YOLO-seg polygon labels (occlusion-aware "
                         "visible regions; ring holes via slit polygons)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    tc = write_split(args.out, "train", args.n_train, args.seed, args.base,
                     seg=args.seg)
    vc = write_split(args.out, "valid", args.n_val, args.seed + 1, args.base,
                     seg=args.seg)
    write_data_yaml(args.out, CLASSES)
    print(f"train instances per class: {tc.tolist()}")
    print(f"val   instances per class: {vc.tolist()}")
    print(f"total train {tc.sum()} val {vc.sum()} "
          f"imbalance max/min {tc.max() / max(1, tc.min()):.1f}x")
    return tc, vc


if __name__ == "__main__":
    main()
