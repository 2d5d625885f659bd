// Greedy-NMS suppression for Hopper (sm_90a): one thread block per image.
//
// Replaces the Pallas TPU kernel `_suppress_kernel` / `pallas_greedy_keep`
// (yololite_tpu/ops/pallas_nms.py). Input: k class-shifted boxes in score-
// descending order and a validity mask; output: the exact greedy keep mask
//   keep(i) = valid(i) and no j < i with keep(j) and IoU(j, i) > thr,
// which is the unique fixpoint the TPU kernel iterates to.
//
// Design (simple and exact; no attempt at speed yet):
//   phase 0  boxes and areas of the image into shared memory;
//   phase 1  each warp takes (row j, 32-column word w) items; lane l computes
//            IoU(j, 32w + l) with the JAX op order and a ballot packs the 32
//            `IoU > thr and i > j` bits into one word of the k x ceil(k/32)
//            suppression bitmask held in dynamic shared memory (128 KB at
//            k = 1024, 32 KB at k = 512);
//   phase 2  warp 0 scans i = 0..k-1 in order. Lane l owns word l of the
//            `removed` bitset (k <= 1024 -> at most 32 words), so a kept box
//            ORs its mask row into `removed` with one shared-memory load per
//            lane.
// Bound on the H100: the IoU work is about 15 fp32 operations per pair over
// B*k*(k-1)/2 pairs (~3.8 us for B=128, k=512 at 67 TFLOP/s); the bytes are
// ~1 MB. Phase 2 is a chain of k dependent steps on one warp, so the kernel
// is latency-bound far above that; a later change attacks the scan.
//
// Bit-exactness: the keep mask is discrete, so one flipped `IoU > thr` bit is
// a wrong answer. The source is compiled with --fmad=false and without fast
// math: (area_i + area_j) - inter is not contracted into an FMA and the
// division is IEEE round-to-nearest, as in XLA's fp32 arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float iou_pair(float4 a, float area_a, float4 b,
                                          float area_b) {
  float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  float inter = iw * ih;
  float uni = ((area_a + area_b) - inter) + 1e-7f;
  return inter / uni;
}

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int k, float iou_th) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5;
  float4* sbox = reinterpret_cast<float4*>(smem);                 // k
  float* sarea = reinterpret_cast<float*>(sbox + k);               // k
  uint32_t* smask = reinterpret_cast<uint32_t*>(sarea + k);        // k * words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(smask + k * words); // k
  uint8_t* skeep = svalid + k;                                      // k

  const int img = blockIdx.x;
  const float4* b = boxes + static_cast<size_t>(img) * k;
  const uint8_t* v = valid + static_cast<size_t>(img) * k;
  uint8_t* out = keep + static_cast<size_t>(img) * k;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float4 bx = b[i];
    sbox[i] = bx;
    sarea[i] = fmaxf(bx.z - bx.x, 0.0f) * fmaxf(bx.w - bx.y, 0.0f);
    svalid[i] = v[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int item = warp; item < k * words; item += nwarps) {
    const int j = item / words;
    const int w = item - j * words;
    const int i = (w << 5) + lane;
    bool sup = false;
    if (i > j && i < k) {
      sup = iou_pair(sbox[j], sarea[j], sbox[i], sarea[i]) > iou_th;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, sup);
    if (lane == 0) smask[item] = bits;
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t removed = 0;  // word `lane` of the removed bitset
    for (int i = 0; i < k; ++i) {
      const int w = i >> 5;
      const uint32_t word = __shfl_sync(0xffffffffu, removed, w);
      const bool kept = svalid[i] && !((word >> (i & 31)) & 1u);
      if (kept && lane < words) removed |= smask[i * words + lane];
      if (lane == 0) skeep[i] = kept;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = skeep[i];
}

}  // namespace

extern "C" size_t yl_nms_smem_bytes(int k) {
  const size_t words = (static_cast<size_t>(k) + 31) / 32;
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float) + 2) +
         static_cast<size_t>(k) * words * sizeof(uint32_t);
}

// boxes [B,k,4] f32, valid [B,k] bool, keep [B,k] bool (all contiguous, on
// the device). Launches on `stream`; returns cudaGetLastError().
extern "C" int yl_nms_greedy_keep(const void* boxes, const void* valid,
                                  void* keep, int batch, int k, float iou_th,
                                  void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = yl_nms_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_suppress_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_th);
  return static_cast<int>(cudaGetLastError());
}
