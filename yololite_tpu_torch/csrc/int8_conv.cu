// Dynamic int8 convolutions for Hopper (sm_90a): the activation quantize,
// a dense (groups = 1) int8 conv and a depthwise int8 conv, each with the
// JAX package's rescale epilogue.
//
// Replaces `_int8_conv` in yololite_tpu/ops/quant.py (plain XLA there, no
// Pallas): activations are quantized to int8 with one dynamic scale over the
// whole tensor, s_x = max|x| / 127, x_q = clip(round_half_even(x /
// max(s_x, 1e-12)), -127, 127); weights are int8 with a per-output-channel
// scale s_w (computed once on the host, `ops/quant.py`); the conv runs on
// s8 x s8 with int32 accumulators; then out = float(acc) * (s_x * s_w[c]) +
// b[c], cast to the output type. The accumulators are exact integers, so
// they equal JAX's bit for bit; the epilogue keeps JAX's operation order
// with explicitly rounded intrinsics (`__fmul_rn`, `__fadd_rn`; the build
// also passes --fmad=false), so the fp32 output equals the plain PyTorch
// version bit for bit.
//
// Every quantized conv of the 15 detection and 2 segmentation configs is
// groups = 1 (dense) or depthwise with cout = cin (`models/layers.py`:
// ConvBNAct, DWConvBlock, UIB/MBConv/FusedMBConv, ConvNeXtV2's biased 7x7;
// the fused heads, laterals, ProtoNet and `mcoef` are dense 1x1); the
// wrapper (`ops/cuda_int8.py`) raises on any other grouping. Memory is NHWC
// (the port's channels_last), padding symmetric, no dilation.
//
// Bounds on the H100 (3.35 TB/s; 1,979 TOP/s dense int8):
//   quantize   bytes: each input read once (2 B in bf16) and x_q written
//              once (1 B). It reads the input twice (max, then quantize),
//              the second time mostly from the 50 MB L2 at b8 but from
//              device memory at b128; a fused max in the producer would
//              remove the first read (later work).
//   dense      operations for 3x3 convs at wide channels (2*M*O*K int8 ops),
//              bytes for the 1x1 convs of edge_n (x_q in, the output out).
//              The design is mma.sync.m16n8k32 (s8 x s8 -> s32) on 64x64
//              output tiles, K in steps of 32 through shared memory, the im2col
//              gathered on the fly with 16-, 4- or 1-byte loads by the
//              channel count; no cp.async pipeline, no wgmma or TMA yet.
//   depthwise  bytes: K*K int8 MACs per output element is far below the
//              byte rate's break-even; one thread per output element, its
//              neighbours on neighbouring channels so loads coalesce.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum OutType { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// ---------------------------------------------------------------- quantize
template <typename T>
__global__ void absmax_kernel(const T* __restrict__ x, long long n,
                              unsigned int* __restrict__ amax_bits) {
  float m = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    m = fmaxf(m, fabsf(load_f32(x, i)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // non-negative floats order as their bit patterns
    if (lane == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, long long n,
                                const unsigned int* __restrict__ amax_bits,
                                int8_t* __restrict__ q, float* __restrict__ s_out) {
  const float s = __fdiv_rn(__uint_as_float(*amax_bits), 127.0f);
  const float d = fmaxf(s, 1e-12f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = rintf(__fdiv_rn(load_f32(x, i), d));
    q[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

// ---------------------------------------------------------------- epilogue
template <int OUT>
struct Store;
template <>
struct Store<OUT_F32> {
  using T = float;
  static __device__ __forceinline__ void put(float* p, long long i, int acc, float scale,
                                             const float* bias, int c) {
    float v = __fmul_rn(__int2float_rn(acc), scale);
    if (bias) v = __fadd_rn(v, bias[c]);
    p[i] = v;
  }
};
template <>
struct Store<OUT_BF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void put(__nv_bfloat16* p, long long i, int acc,
                                             float scale, const float* bias, int c) {
    float v = __fmul_rn(__int2float_rn(acc), scale);
    if (bias) v = __fadd_rn(v, bias[c]);
    p[i] = __float2bfloat16_rn(v);
  }
};
template <>
struct Store<OUT_I32> {
  using T = int;
  static __device__ __forceinline__ void put(int* p, long long i, int acc, float, const float*,
                                             int) {
    p[i] = acc;
  }
};

// ---------------------------------------------------------------- dense
constexpr int BM = 64, BN = 64, BK = 32, LDS = 48;   // LDS: smem row stride, bytes

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x [N,H,W,C] int8, w [O,Kp] int8 (K = KH*KW*C ordered (ky, kx, c), zero
// padded to Kp, a multiple of 32), out [N*OH*OW, O]. 128 threads: 4 warps in
// a 2x2 grid of 32x32 warp tiles. V = bytes per activation load (C % V == 0,
// so a load never crosses a tap).
template <int V, int OUT>
__global__ void __launch_bounds__(128) conv_dense_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ s_x, const float* __restrict__ s_w,
    const float* __restrict__ bias, typename Store<OUT>::T* __restrict__ out,
    int N, int H, int W, int C, int OH, int OW, int O, int KH, int KW,
    int SH, int SW, int PH, int PW, int Kp) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const long long M = (long long)N * OH * OW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = KH * KW * C;

  // this thread's loads: row tid/2 of each tile, bytes (tid&1)*16 .. +16
  const int ld_row = tid >> 1, ld_col = (tid & 1) * 16;
  const long long am = m0 + ld_row;
  const bool a_row_ok = am < M;
  int a_n = 0, iy0 = 0, ix0 = 0;
  if (a_row_ok) {
    const long long plane = (long long)OH * OW;
    a_n = (int)(am / plane);
    const int r = (int)(am - (long long)a_n * plane);
    iy0 = (r / OW) * SH - PH;
    ix0 = (r % OW) * SW - PW;
  }
  const int b_co = n0 + ld_row;
  const int8_t* xn = x + (long long)a_n * H * W * C;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    int8_t* adst = As + ld_row * LDS + ld_col;
#pragma unroll
    for (int c = 0; c < 16 / V; ++c) {
      const int k = k0 + ld_col + c * V;
      bool ok = a_row_ok && k < K;
      long long off = 0;
      if (ok) {
        const int tap = k / C, ci = k - tap * C;
        const int iy = iy0 + tap / KW, ix = ix0 + tap % KW;
        ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        off = ((long long)iy * W + ix) * C + ci;
      }
      if (V == 16) {
        int4 v = make_int4(0, 0, 0, 0);
        if (ok) v = *reinterpret_cast<const int4*>(xn + off);
        *reinterpret_cast<int4*>(adst) = v;
      } else if (V == 4) {
        int v = 0;
        if (ok) v = *reinterpret_cast<const int*>(xn + off);
        *reinterpret_cast<int*>(adst + c * 4) = v;
      } else {
        adst[c] = ok ? xn[off] : (int8_t)0;
      }
    }
    {
      int4 v = make_int4(0, 0, 0, 0);
      if (b_co < O) v = *reinterpret_cast<const int4*>(w + (long long)b_co * Kp + k0 + ld_col);
      *reinterpret_cast<int4*>(Bs + ld_row * LDS + ld_col) = v;
    }
    __syncthreads();
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* r0 = As + (wm * 32 + mi * 16 + g) * LDS + t * 4;
      const int8_t* r8 = r0 + 8 * LDS;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* c0 = Bs + (wn * 32 + ni * 8 + g) * LDS + t * 4;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  const float sx = OUT == OUT_I32 ? 0.f : *s_x;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = m0 + wm * 32 + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int co = n0 + wn * 32 + ni * 8 + t * 2 + (r & 1);
        if (m < M && co < O) {
          const float scale = OUT == OUT_I32 ? 0.f : __fmul_rn(sx, s_w[co]);
          Store<OUT>::put(out, m * O + co, acc[mi][ni][r], scale, bias, co);
        }
      }
}

// ---------------------------------------------------------------- depthwise
// x [N,H,W,C] int8, w [KH,KW,C] int8, out [N,OH,OW,C]; one thread an output.
// I is the index type: 32-bit whenever the output fits (a 64-bit division
// costs several times a 32-bit one, and the index is split four ways).
template <typename I, int OUT>
__global__ void __launch_bounds__(256) conv_depthwise_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ s_x, const float* __restrict__ s_w,
    const float* __restrict__ bias, typename Store<OUT>::T* __restrict__ out,
    int N, int H, int W, int C, int OH, int OW, int KH, int KW,
    int SH, int SW, int PH, int PW) {
  const I total = (I)N * OH * OW * C;
  const float sx = OUT == OUT_I32 ? 0.f : *s_x;
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int c = (int)(i % (I)C);
    I p = i / (I)C;
    const int ox = (int)(p % (I)OW);
    p /= (I)OW;
    const int oy = (int)(p % (I)OH);
    const long long n = (long long)(p / (I)OH);
    const int8_t* xn = x + n * H * W * C + c;
    int acc = 0;
    for (int ky = 0; ky < KH; ++ky) {
      const int iy = oy * SH - PH + ky;
      if (iy < 0 || iy >= H) continue;
      for (int kx = 0; kx < KW; ++kx) {
        const int ix = ox * SW - PW + kx;
        if (ix < 0 || ix >= W) continue;
        acc += (int)xn[((long long)iy * W + ix) * C] * (int)w[(ky * KW + kx) * C + c];
      }
    }
    const float scale = OUT == OUT_I32 ? 0.f : __fmul_rn(sx, s_w[c]);
    Store<OUT>::put(out, (long long)i, acc, scale, bias, c);
  }
}

template <typename I>
void launch_depthwise(int out_type, int grid, cudaStream_t st, const int8_t* x, const int8_t* w,
                      const float* sx, const float* sw, const float* b, void* out, int N, int H,
                      int W, int C, int OH, int OW, int KH, int KW, int SH, int SW, int PH,
                      int PW) {
  if (out_type == OUT_F32)
    conv_depthwise_kernel<I, OUT_F32><<<grid, 256, 0, st>>>(x, w, sx, sw, b, (float*)out, N, H,
                                                            W, C, OH, OW, KH, KW, SH, SW, PH, PW);
  else if (out_type == OUT_BF16)
    conv_depthwise_kernel<I, OUT_BF16><<<grid, 256, 0, st>>>(x, w, sx, sw, b,
                                                             (__nv_bfloat16*)out, N, H, W, C,
                                                             OH, OW, KH, KW, SH, SW, PH, PW);
  else
    conv_depthwise_kernel<I, OUT_I32><<<grid, 256, 0, st>>>(x, w, sx, sw, b, (int*)out, N, H,
                                                            W, C, OH, OW, KH, KW, SH, SW, PH, PW);
}

int grid_for(long long n, int block) {
  long long blocks = (n + block - 1) / block;
  const long long cap = 132LL * 16;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <int V>
cudaError_t launch_dense(int out_type, dim3 grid, cudaStream_t st, const int8_t* x,
                         const int8_t* w, const float* sx, const float* sw, const float* b,
                         void* out, int N, int H, int W, int C, int OH, int OW, int O, int KH,
                         int KW, int SH, int SW, int PH, int PW, int Kp) {
  if (out_type == OUT_F32)
    conv_dense_kernel<V, OUT_F32><<<grid, 128, 0, st>>>(x, w, sx, sw, b, (float*)out, N, H, W,
                                                        C, OH, OW, O, KH, KW, SH, SW, PH, PW, Kp);
  else if (out_type == OUT_BF16)
    conv_dense_kernel<V, OUT_BF16><<<grid, 128, 0, st>>>(x, w, sx, sw, b, (__nv_bfloat16*)out,
                                                         N, H, W, C, OH, OW, O, KH, KW, SH, SW,
                                                         PH, PW, Kp);
  else
    conv_dense_kernel<V, OUT_I32><<<grid, 128, 0, st>>>(x, w, sx, sw, b, (int*)out, N, H, W, C,
                                                        OH, OW, O, KH, KW, SH, SW, PH, PW, Kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (fp32 when in_type == 0, bf16 when 1) with n elements -> q int8 [n] and
// s_out fp32 [1]; amax_scratch is 4 bytes of device memory.
int yl_int8_quantize(const void* x, int in_type, long long n, void* amax_scratch, void* q,
                     void* s_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(amax_scratch, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const int block = 256, grid = grid_for(n, block);
  unsigned int* amax = (unsigned int*)amax_scratch;
  if (in_type == 0) {
    absmax_kernel<float><<<grid, block, 0, st>>>((const float*)x, n, amax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    quantize_kernel<float><<<grid, block, 0, st>>>((const float*)x, n, amax, (int8_t*)q,
                                                   (float*)s_out);
  } else {
    absmax_kernel<__nv_bfloat16><<<grid, block, 0, st>>>((const __nv_bfloat16*)x, n, amax);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    quantize_kernel<__nv_bfloat16><<<grid, block, 0, st>>>((const __nv_bfloat16*)x, n, amax,
                                                           (int8_t*)q, (float*)s_out);
  }
  return (int)cudaGetLastError();
}

int yl_int8_conv_dense(const void* x, const void* w, const void* s_x, const void* s_w,
                       const void* bias, void* out, int out_type, int N, int H, int W, int C,
                       int OH, int OW, int O, int KH, int KW, int SH, int SW, int PH, int PW,
                       int Kp, void* stream) {
  const long long M = (long long)N * OH * OW;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xi = (const int8_t*)x;
  const int8_t* wi = (const int8_t*)w;
  const float *sx = (const float*)s_x, *sw = (const float*)s_w, *b = (const float*)bias;
  cudaError_t err;
  if (C % 16 == 0)
    err = launch_dense<16>(out_type, grid, st, xi, wi, sx, sw, b, out, N, H, W, C, OH, OW, O,
                           KH, KW, SH, SW, PH, PW, Kp);
  else if (C % 4 == 0)
    err = launch_dense<4>(out_type, grid, st, xi, wi, sx, sw, b, out, N, H, W, C, OH, OW, O,
                          KH, KW, SH, SW, PH, PW, Kp);
  else
    err = launch_dense<1>(out_type, grid, st, xi, wi, sx, sw, b, out, N, H, W, C, OH, OW, O,
                          KH, KW, SH, SW, PH, PW, Kp);
  return (int)err;
}

int yl_int8_conv_depthwise(const void* x, const void* w, const void* s_x, const void* s_w,
                           const void* bias, void* out, int out_type, int N, int H, int W,
                           int C, int OH, int OW, int KH, int KW, int SH, int SW, int PH, int PW,
                           void* stream) {
  const long long total = (long long)N * OH * OW * C;
  const long long want = (total + 255) / 256;
  const int grid = (int)(want < (1LL << 30) ? (want > 0 ? want : 1) : (1LL << 30));
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xi = (const int8_t*)x;
  const int8_t* wi = (const int8_t*)w;
  const float *sx = (const float*)s_x, *sw = (const float*)s_w, *b = (const float*)bias;
  if (total < (1LL << 32))
    launch_depthwise<unsigned int>(out_type, grid, st, xi, wi, sx, sw, b, out, N, H, W, C, OH,
                                   OW, KH, KW, SH, SW, PH, PW);
  else
    launch_depthwise<unsigned long long>(out_type, grid, st, xi, wi, sx, sw, b, out, N, H, W,
                                         C, OH, OW, KH, KW, SH, SW, PH, PW);
  return (int)cudaGetLastError();
}

}  // extern "C"
