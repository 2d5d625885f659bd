// Host C++ for the port: greedy NMS, the pairwise IoU matrix, the COCOeval
// matcher and the space-to-depth pack (the port's own copy of the JAX
// package's `native/kernels.cpp`, same C interface).
//
//   yl_nms         greedy IoU NMS on the host (`ops/nms.nms_numpy`, which
//                  `deploy/infer_exported.py` calls for a "decoded" graph)
//   yl_box_iou     pairwise IoU matrix of xyxy boxes
//   yl_coco_match  COCOeval per-(image, category) greedy matching over all
//                  IoU thresholds (the inner loop of `eval/coco.py`)
//   yl_pack_s2d    space-to-depth 2x2 uint8 pack for the s2d stem
//                  (`deploy/s2d.py`): two memcpys per output pixel, in
//                  cache order in both streams
//
// Built by `csrc/build.py`'s host route (`-O2 -ffp-contract=off`, no
// `-march`): without contraction no `a*b + c` here becomes an FMA, so the
// IoU arithmetic is the same sequence of rounded fp32 operations as the
// numpy plain versions in `native.py`, bit for bit. The JAX package builds
// with `-O3 -march=native`, where GCC may contract; on integral boxes (the
// ties at the threshold the tests hold) both give the exact same IoU.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// boxes: [n,4] xyxy, scores: [n]; keep_out must hold n ints.
// Returns number of kept boxes (indices sorted by descending score).
int yl_nms(const float* boxes, const float* scores, int n, float iou_th,
           int* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    areas[i] = std::max(0.f, b[2] - b[0]) * std::max(0.f, b[3] - b[1]);
  }
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      float ix1 = std::max(bi[0], bj[0]);
      float iy1 = std::max(bi[1], bj[1]);
      float ix2 = std::min(bi[2], bj[2]);
      float iy2 = std::min(bi[3], bj[3]);
      float iw = std::max(0.f, ix2 - ix1);
      float ih = std::max(0.f, iy2 - iy1);
      float inter = iw * ih;
      float iou = inter / (areas[i] + areas[j] - inter + 1e-7f);
      if (iou > iou_th) suppressed[j] = 1;
    }
  }
  return kept;
}

// Pairwise IoU of xyxy boxes: a [n,4] x b [m,4] -> out [n,m]
void yl_box_iou(const float* a, int n, const float* b, int m, float* out) {
  for (int i = 0; i < n; ++i) {
    const float* ai = a + 4 * i;
    float area_a = std::max(0.f, ai[2] - ai[0]) * std::max(0.f, ai[3] - ai[1]);
    for (int j = 0; j < m; ++j) {
      const float* bj = b + 4 * j;
      float area_b = std::max(0.f, bj[2] - bj[0]) * std::max(0.f, bj[3] - bj[1]);
      float iw = std::max(0.f, std::min(ai[2], bj[2]) - std::max(ai[0], bj[0]));
      float ih = std::max(0.f, std::min(ai[3], bj[3]) - std::max(ai[1], bj[1]));
      float inter = iw * ih;
      out[i * m + j] = inter / (area_a + area_b - inter + 1e-7f);
    }
  }
}

// COCOeval greedy matcher for one (image, category).
//   ious      [D,G]  det-gt IoUs (dets sorted by descending score,
//                    gts sorted ignored-last)
//   gt_ignore [G]    1 = ignored GT (outside area range)
//   thrs      [T]    IoU thresholds
// Outputs:
//   dtm   [T,D]  matched gt index + 1, or 0 if unmatched
//   dt_ig [T,D]  1 if the det is ignored at that threshold
void yl_coco_match(const double* ious, const uint8_t* gt_ignore, int D, int G,
                   const double* thrs, int T, int32_t* dtm, uint8_t* dt_ig) {
  std::vector<char> gtm(G);
  for (int t = 0; t < T; ++t) {
    std::fill(gtm.begin(), gtm.end(), 0);
    double thr = thrs[t];
    for (int d = 0; d < D; ++d) {
      double best = std::min(thr, 1.0 - 1e-10);
      int m = -1;
      for (int g = 0; g < G; ++g) {
        if (gtm[g]) continue;
        // once matched to a non-ignored gt, stop at ignored gts
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        double v = ious[(size_t)d * G + g];
        if (v < best) continue;
        best = v;
        m = g;
      }
      if (m == -1) {
        dtm[(size_t)t * D + d] = 0;
        dt_ig[(size_t)t * D + d] = 0;
      } else {
        dtm[(size_t)t * D + d] = m + 1;
        dt_ig[(size_t)t * D + d] = gt_ignore[m];
        gtm[m] = 1;
      }
    }
  }
}

// [B,H,W,C] u8 -> [B,H/2,W/2,4C] u8, phase (di,dj)-major / channel-minor:
// out[b,oy,ox, (di*2+dj)*C + c] = in[b, 2oy+di, 2ox+dj, c].
// For each output pixel, phases (di,0),(di,1) are 2C contiguous source bytes
// (two adjacent input pixels of row 2oy+di) landing at 2C contiguous dest
// bytes — two memcpys per output pixel, sequential in both streams.
void yl_pack_s2d(const uint8_t* in, int B, int H, int W, int C, uint8_t* out) {
  const int oh = H / 2, ow = W / 2;
  const size_t in_row = (size_t)W * C;
  const size_t out_px = (size_t)4 * C;
  for (int b = 0; b < B; ++b) {
    const uint8_t* ib = in + (size_t)b * H * in_row;
    uint8_t* ob = out + (size_t)b * oh * ow * out_px;
    for (int oy = 0; oy < oh; ++oy) {
      const uint8_t* r0 = ib + (size_t)(2 * oy) * in_row;
      const uint8_t* r1 = r0 + in_row;
      uint8_t* o = ob + (size_t)oy * ow * out_px;
      for (int ox = 0; ox < ow; ++ox) {
        std::memcpy(o, r0 + (size_t)(2 * ox) * C, 2 * C);
        std::memcpy(o + 2 * C, r1 + (size_t)(2 * ox) * C, 2 * C);
        o += out_px;
      }
    }
  }
}

}  // extern "C"
