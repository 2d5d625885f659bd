// Greedy-NMS suppression for Hopper (sm_90a): a bitmask pass spread over the
// card, then a chunked greedy scan with one block per image.
//
// Replaces the Pallas TPU kernel `_suppress_kernel` / `pallas_greedy_keep`
// (yololite_tpu/ops/pallas_nms.py). Input: k class-shifted boxes in score-
// descending order and a validity mask; output: the exact greedy keep mask
//   keep(i) = valid(i) and no j < i with keep(j) and IoU(j, i) > thr,
// which is the unique fixpoint the TPU kernel iterates to. The TPU kernel's
// fixpoint of `keep @ sup` matvecs is not carried over: a chain of depth d
// would cost d full k x k passes. A bitmask scan is the GPU's form of it.
//
// Bound on the H100: operations. About 15 fp32 operations per pair (4 min/
// max, 4 sub, 2 clamp, 1 mul, 2 add, 1 div, 1 cmp) over the pairs the data
// needs, at 67 TFLOP/s: ~3.8 us for all B*k*(k-1)/2 pairs at B=128, k=512.
// The bytes (boxes in, keep out) are ~1 MB.
//
// The first design (one block of 8 warps per image, the whole mask in shared
// memory, one warp scanning k rows one by one) ran 89x above that bound:
//   - one SM per image, so a single frame used 1 of 132 SMs;
//   - the mask pass walked the full k x k/32 square, below the diagonal too,
//     with an integer divide, a ballot and a one-lane store per word;
//   - the scan was k dependent steps of ~300 cycles (shuffle, shared loads,
//     store) on one warp while 7 idled;
//   - the mask in shared memory and one `removed` word per lane capped k at
//     1024.
// This design:
//   mask pass  grid (image, chunk c of 32 rows, tile of 8 column words), 8
//              warps a block. The block stages the tile's 256 column boxes
//              and their areas in shared memory; warp v takes word
//              w = tile*8 + v and lane r row 32c + r, whose box stays in
//              registers. Each lane builds its whole 32-bit word in a
//              register (bit l: column 32w+l right of row j, below k, and
//              IoU > thr) and stores it once. Warps with w < c (left of the
//              diagonal) or with 32 invalid rows exit at once, so only the
//              upper triangle is computed, and no lane idles inside a
//              working warp. A lane first finds, without a branch, which
//              of its 32 columns intersect its row; it divides only for
//              those (a zero numerator would take the division's slow path,
//              and most pairs do not intersect). The words go into a
//              [B, k, ceil(k/32)] uint32 scratch tensor in device memory
//              (4.2 MB at B=128, k=512: it stays in the 50 MB L2).
//   scan       one block of 9 warps per image; the `removed` bitset and the
//              valid bits live in shared memory (ceil(k/32) words each). The
//              rows go in chunks of 32, one bitset word c at a time:
//              (a) warp 0 resolves chunk c in a register: lane r holds the
//                  diagonal word of row 32c+r; the 32 shuffles are issued
//                  first, then each step is a bit test, a select and an OR
//                  (3 dependent instructions in the SASS). It then
//                  ORs its kept rows' word c+1 in-warp (__reduce_or_sync)
//                  into `carry` for chunk c+1, and it loads the next chunk's
//                  two words per row while it works;
//              (b) meanwhile 8 helper warps OR the kept rows of chunk c-1
//                  into `removed`: for words c+1..c+32 warp g takes rows g,
//                  g+8, g+16, g+24 and lane l word c+1+l, with values it
//                  loaded one chunk ahead (two register sets in turn, so the
//                  L2 latency hides behind the chunk before) and a shared
//                  atomic OR; each word beyond (k > 1056) has one owner
//                  thread that loads its 32 rows at once;
//              (c) one __syncthreads a chunk. removed[c+1] is then complete:
//                  chunks <= c-1 reached it through (b), chunk c by `carry`.
//              The chain is k/32 chunk steps instead of k row steps.
// No cap on k: the scratch is B*k*ceil(k/32)*4 bytes (1.13 GB at B=128,
// k=8400) and offsets into it are size_t. The grid puts chunks in y, so k is
// limited to 65535*32 rows, where the scratch of one image alone is 550 GB.
//
// The scratch needs no zeroing: the mask pass writes the diagonal word and
// the words right of it of every valid row, and the scan uses no other word.
// It loads some others ahead of time (those of invalid rows, or of rows not
// kept) and drops them.
//
// DIoU mode (a template parameter of the mask pass; the scan is the same):
// bit l is set where DIoU(j, i) = IoU - d2 / c2 > thr, d2 the squared
// distance of the two centres (cx = (x1 + x2) * 0.5) and c2 = (w^2 + h^2) +
// 1e-7 for the enclosing box's w = max(x2) - min(x1) and h likewise, in the
// JAX op order (yololite_tpu/ops/nms.py:40-46). For thr >= 0 the
// intersection prefilter still holds: DIoU > thr >= 0 needs IoU > DIoU, so
// the boxes intersect; a pair with a NaN coordinate has a NaN d2 and is never
// set. About 32 operations a pair (IoU's 15, then 2 sub, 2 mul, 1 add for
// d2, 2 max, 2 min, 2 sub, 2 mul, 2 add for c2, 1 div, 1 sub): ~8.2 us for
// all pairs at B=128, k=512 at 67 TFLOP/s.
//
// Bit-exactness: the keep mask is discrete, so one flipped `IoU > thr` bit is
// a wrong answer. The IoU keeps the JAX op order (ops/boxes.py):
// inter / (((area_j + area_i) - inter) + 1e-7), with each area computed once
// per box as fmaxf(x2-x1,0)*fmaxf(y2-y1,0). The source is compiled with
// --fmad=false and without fast math: the sum is not contracted into an FMA
// and the division is IEEE round-to-nearest, as in XLA's fp32 arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaskWarps = 8;                  // column words per mask block
constexpr int kMaskThreads = 32 * kMaskWarps;
constexpr int kScanHelpers = 8;                // helper warps of the scan
constexpr int kScanThreads = 32 * (1 + kScanHelpers);
constexpr int kRowsPerHelper = 32 / kScanHelpers;
constexpr uint32_t kFull = 0xffffffffu;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

// Block (img, c, tile): rows 32c..32c+31 of image `img` against the column
// words [tile*8, tile*8 + 8). Warp v takes word tile*8 + v; lane r takes
// row 32c + r and builds the whole word in a register. kDiou: the bits are
// DIoU > thr instead of IoU > thr.
template <bool kDiou>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                uint32_t* __restrict__ mask, int k, float iou_th) {
  __shared__ float4 scol[kMaskThreads];         // column 32*tile*8 + t at [t]
  __shared__ float scol_area[kMaskThreads];
  const int img = blockIdx.x;
  const int c = blockIdx.y;
  const int words = (k + 31) >> 5;
  const int w0 = blockIdx.z * kMaskWarps;
  if (w0 + kMaskWarps - 1 < c) return;          // the whole tile is left of the diagonal

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* b = boxes + static_cast<size_t>(img) * k;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // every global load of the block in flight at once: the lane's row box
  // and valid flag, and one column box a thread for the staging
  const int j = (c << 5) + lane;
  const bool row_valid = j < k && valid[static_cast<size_t>(img) * k + j];
  const float4 rb = j < k ? b[j] : zero;
  {
    const int i = (w0 << 5) + threadIdx.x;
    const float4 bx = i < k ? b[i] : zero;
    scol[threadIdx.x] = bx;
    scol_area[threadIdx.x] = box_area(bx);
  }
  __syncthreads();

  const int w = w0 + warp;
  if (w < c || w >= words) return;              // left of the diagonal, or past k
  if (__ballot_sync(kFull, row_valid) == 0u) return;   // invalid rows are never read
  const float ra = box_area(rb);
  // bits l in [lo, hi): columns 32w + l right of row j and below k
  const int lo = max(j + 1 - (w << 5), 0);
  const int hi = min(k - (w << 5), 32);
  const uint32_t cols = lo >= hi ? 0u
                        : (hi - lo == 32 ? kFull : ((1u << (hi - lo)) - 1u) << lo);
  const float4* sc = scol + (warp << 5);
  const float* sa = scol_area + (warp << 5);
  // 1) which of the 32 columns may intersect row j: no branch, no division.
  // A column outside this set has an unclamped width or height <= 0 (or
  // both NaN), so inter is +-0 (or NaN from 0 * inf).
  uint32_t overlap = 0u;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const float4 cb = sc[l];
    const float iw = fminf(rb.z, cb.z) - fmaxf(rb.x, cb.x);
    const float ih = fminf(rb.w, cb.w) - fmaxf(rb.y, cb.y);
    overlap |= static_cast<uint32_t>(fminf(iw, ih) > 0.0f) << l;
  }
  // 2) the IoU only where it can exceed the threshold. With inter == +-0 it
  // is 0 / uni = +-0 for every uni the areas give (>= 1e-7 or +inf), NaN for
  // a NaN uni; with a NaN inter it is NaN. So for thr >= 0 the columns left
  // out above are 0 bits, and they skip the division, whose slow path a
  // zero numerator takes; for thr < 0 every column is computed.
  uint32_t todo = (0.0f > iou_th ? kFull : overlap) & cols;
  uint32_t bits = 0u;
  while (todo != 0u) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1u;
    const float4 cb = sc[l];
    const float iw = fmaxf(fminf(rb.z, cb.z) - fmaxf(rb.x, cb.x), 0.0f);
    const float ih = fmaxf(fminf(rb.w, cb.w) - fmaxf(rb.y, cb.y), 0.0f);
    const float inter = iw * ih;
    const float uni = ((ra + sa[l]) - inter) + 1e-7f;
    bool sup;
    if (kDiou) {
      const float dx = (rb.x + rb.z) * 0.5f - (cb.x + cb.z) * 0.5f;
      const float dy = (rb.y + rb.w) * 0.5f - (cb.y + cb.w) * 0.5f;
      const float ew = fmaxf(rb.z, cb.z) - fminf(rb.x, cb.x);
      const float eh = fmaxf(rb.w, cb.w) - fminf(rb.y, cb.y);
      const float c2 = (ew * ew + eh * eh) + 1e-7f;
      sup = inter / uni - (dx * dx + dy * dy) / c2 > iou_th;
    } else {
      sup = inter != 0.0f ? inter / uni > iou_th : uni == uni;
    }
    bits |= static_cast<uint32_t>(sup) << l;
  }
  if (row_valid) mask[(static_cast<size_t>(img) * k + j) * words + w] = bits;
}

// One step of the scan, chunk c (see the note at the top). The `*_in`
// values were loaded in the step before, the `*_out` ones are loaded now for
// the step after; the caller alternates the two sets, so no register waits
// on a load issued in the same step. Warp 0, lane r: `diag_in` and
// `right_in` are words c and c+1 of row 32c + r, `carry` the kept rows' OR
// over word c from chunk c-1.
__device__ __forceinline__ void scan_step(
    int c, int k, int words, const uint32_t* __restrict__ m,
    uint8_t* __restrict__ out, const uint32_t* svalid, uint32_t* sremoved,
    uint32_t* s_kept, uint32_t diag_in, uint32_t right_in, uint32_t& diag_out,
    uint32_t& right_out, uint32_t& carry,
    const uint32_t (&near_in)[kRowsPerHelper], uint32_t (&near_out)[kRowsPerHelper]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = c << 5;
  if (warp == 0) {
    // (a) removed[c] is complete: chunks <= c-2 reached it through (b)
    // before the last barrier, chunk c-1 through `carry`
    const int rn = row0 + 32 + lane;
    diag_out = rn < k ? m[static_cast<size_t>(rn) * words + c + 1] : 0u;
    right_out = rn < k && c + 2 < words ? m[static_cast<size_t>(rn) * words + c + 2] : 0u;
    uint32_t d[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) d[r] = __shfl_sync(kFull, diag_in, r);
    const uint32_t vb = svalid[c];
    uint32_t kept = 0u;
    if (vb != 0u) {
      uint32_t cur = sremoved[c] | carry | ~vb;   // bits past k are set by ~vb
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!((cur >> r) & 1u)) cur |= d[r];
      kept = ~cur & vb;
    }
    if (row0 + lane < k) out[row0 + lane] = (kept >> lane) & 1u;
    if (lane == 0) s_kept[c & 1] = kept;
    carry = __reduce_or_sync(kFull, ((kept >> lane) & 1u) ? right_in : 0u);
    return;
  }
  // (b) helper warp g: rows g, g+8, g+16, g+24 of a chunk
  const int g = warp - 1;
  const int wn = c + 2 + lane;                   // chunk c's near word, used in c+1
#pragma unroll
  for (int q = 0; q < kRowsPerHelper; ++q) {
    const int r = g + q * kScanHelpers;
    near_out[q] = (wn < words && row0 + r < k)
                      ? m[static_cast<size_t>(row0 + r) * words + wn] : 0u;
  }
  const uint32_t kept = c > 0 ? s_kept[(c - 1) & 1] : 0u;
  if (kept == 0u) return;
  // chunk c-1's kept rows into words c+1 .. c+32 (word c went by `carry`)
  uint32_t a = 0u;
#pragma unroll
  for (int q = 0; q < kRowsPerHelper; ++q)
    if ((kept >> (g + q * kScanHelpers)) & 1u) a |= near_in[q];
  if (a) atomicOr(&sremoved[c + 1 + lane], a);
  // and into words >= c+33 (k > 1056 only): thread h owns w = h mod 256
  const int h = threadIdx.x - 32;
  const int prow0 = row0 - 32;
  int w = h;
  if (w < c + 33) w += ((c + 33 - w + 255) >> 8) << 8;
  for (; w < words; w += 256) {
    uint32_t f[32];
#pragma unroll
    for (int r = 0; r < 32; ++r)
      f[r] = ((kept >> r) & 1u) ? m[static_cast<size_t>(prow0 + r) * words + w] : 0u;
    uint32_t fa = 0u;
#pragma unroll
    for (int r = 0; r < 32; ++r) fa |= f[r];
    sremoved[w] |= fa;                            // its only writer
  }
}

// One block per image: warp 0 resolves the chunks in order, 8 helper warps
// OR the kept rows of the chunk before into `removed`. Dynamic shared
// memory: valid bits, then `removed`, ceil(k/32) words each.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint32_t* __restrict__ mask,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k) {
  extern __shared__ uint32_t sbits[];
  __shared__ uint32_t s_kept[2];
  const int words = (k + 31) >> 5;
  uint32_t* svalid = sbits;
  uint32_t* sremoved = sbits + words;
  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* m = mask + static_cast<size_t>(img) * k * words;
  const uint8_t* v = valid + static_cast<size_t>(img) * k;
  uint8_t* out = keep + static_cast<size_t>(img) * k;

  for (int base = warp << 5; base < k; base += kScanThreads) {
    const int i = base + lane;
    const uint32_t vbits = __ballot_sync(kFull, i < k && v[i]);
    if (lane == 0) {
      svalid[base >> 5] = vbits;
      sremoved[base >> 5] = 0u;
    }
  }
  uint32_t diag_a = 0u, right_a = 0u, diag_b = 0u, right_b = 0u, carry = 0u;
  if (warp == 0 && lane < k) {
    diag_a = m[static_cast<size_t>(lane) * words];
    if (words > 1) right_a = m[static_cast<size_t>(lane) * words + 1];
  }
  uint32_t near_a[kRowsPerHelper] = {}, near_b[kRowsPerHelper] = {};
  __syncthreads();

  for (int c = 0; c < words; c += 2) {
    scan_step(c, k, words, m, out, svalid, sremoved, s_kept, diag_a, right_a,
              diag_b, right_b, carry, near_a, near_b);
    __syncthreads();                              // (c)
    if (c + 1 < words) {
      scan_step(c + 1, k, words, m, out, svalid, sremoved, s_kept, diag_b, right_b,
                diag_a, right_a, carry, near_b, near_a);
      __syncthreads();
    }
  }
}

}  // namespace

// Mask pass. boxes [B,k,4] f32, valid [B,k] bool, mask [B,k,ceil(k/32)]
// uint32 scratch (all contiguous, on the device); diou 0 (IoU) or 1 (DIoU).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int yl_nms_mask(const void* boxes, const void* valid, void* mask,
                           int batch, int k, float iou_th, int diou, void* stream) {
  const int words = (k + 31) >> 5;
  if (batch <= 0 || k <= 0 || words > kMaxGridY || (diou != 0 && diou != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch, words, (words + kMaskWarps - 1) / kMaskWarps);
  const auto kernel = diou ? nms_mask_kernel<true> : nms_mask_kernel<false>;
  kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint32_t*>(mask), k, iou_th);
  return static_cast<int>(cudaGetLastError());
}

// Scan. mask from yl_nms_mask, valid [B,k] bool, keep [B,k] bool.
extern "C" int yl_nms_scan(const void* mask, const void* valid, void* keep,
                           int batch, int k, void* stream) {
  if (batch <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * ((static_cast<size_t>(k) + 31) / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<batch, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k);
  return static_cast<int>(cudaGetLastError());
}

// The whole kernel: mask pass, then scan, both on `stream`. `mask` is the
// caller's scratch, [B, k, ceil(k/32)] uint32; it needs no zeroing.
extern "C" int yl_nms_greedy_keep(const void* boxes, const void* valid,
                                  void* keep, void* mask, int batch, int k,
                                  float iou_th, int diou, void* stream) {
  const int err = yl_nms_mask(boxes, valid, mask, batch, k, iou_th, diou, stream);
  if (err != 0) return err;
  return yl_nms_scan(mask, valid, keep, batch, k, stream);
}
