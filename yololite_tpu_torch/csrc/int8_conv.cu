// Dynamic int8 convolutions for Hopper (sm_90a): the activation quantize,
// a dense (groups = 1) int8 conv and a depthwise int8 conv, each with the
// JAX package's rescale epilogue.
//
// Replaces `_int8_conv` in yololite_tpu/ops/quant.py:31-58 (plain XLA there,
// no Pallas): activations are quantized to int8 with one dynamic scale over
// the whole tensor, s_x = max|x| / 127, x_q = clip(round_half_even(x /
// max(s_x, 1e-12)), -127, 127); weights are int8 with a per-output-channel
// scale s_w (computed once on the host, `ops/quant.py`); the conv runs on
// s8 x s8 with int32 accumulators; then out = float(acc) * (s_x * s_w[c]) +
// b[c], cast to the output type. The accumulators are exact integers, so
// they equal JAX's bit for bit whatever order the products are summed in;
// the epilogue keeps JAX's operation order with explicitly rounded
// intrinsics (`__fmul_rn`, `__fadd_rn`; the build also passes
// --fmad=false), so the fp32 output equals the plain PyTorch version bit
// for bit.
//
// Every quantized conv of the 15 detection and 2 segmentation configs is
// groups = 1 (dense) or depthwise with cout = cin (`models/layers.py`:
// ConvBNAct, DWConvBlock, UIB/MBConv/FusedMBConv, ConvNeXtV2's biased 7x7;
// the fused heads, laterals, ProtoNet and `mcoef` are dense 1x1); the
// wrapper (`ops/cuda_int8.py`) raises on any other grouping. Memory is NHWC
// (the port's channels_last), padding symmetric, no dilation. The wrapper's
// `plan_dense`/`plan_depthwise` pick each call's variant, tile and shared
// memory; the launchers below check the plan against their own arithmetic.
//
// Bounds on the H100 (3.35 TB/s; 1,979 TOP/s dense int8) and the designs:
//   quantize   bytes: each input read once (2 B in bf16) and x_q written
//              once (1 B). It reads the input twice (max, then quantize),
//              the second time mostly from the 50 MB L2 at b8 but from
//              device memory at b128; a fused max in the producer would
//              remove the first read (later work).
//   dense      bytes at every edge_n call (x_q in once, the output out once:
//              a 1x1 conv does 2*O int8 ops a byte of x_q, far below the
//              tensor cores' break-even of ~590); operations only for wide
//              3x3 convs of the larger configs. A block owns 128 rows of the
//              [M, K] activation matrix, keeps them in shared memory and walks
//              over O in steps of 8, 16 or 32 columns, so each activation byte
//              leaves device memory once. The rows arrive by cp.async
//              (`DenseMode`): a 1x1 call copies x_q's rows as they lie (no
//              im2col index math); a KxK call on C % 16 == 0 copies the input
//              patch under a 2-D output tile once, contiguous, and reads its A
//              fragments through a table of tap offsets; any other call
//              gathers its im2col rows, zero-filled (src-size 0) at the
//              padding; K beyond 736 streams in 128-byte chunks through a
//              3-stage ring. Weights come once in mma fragment order
//              (`pack_dense_mma`): one 8-byte load a lane an n8 x k32 tile,
//              from L1/L2. Within each k32 step a lane's A and B bytes follow
//              one permutation of k, so A fragments are two 8-byte shared
//              loads a row pair (`mma.sync.m16n8k32` s8 -> s32). The epilogue
//              rescales in registers and stages each warp's rows in shared
//              memory: whole rows, stored as one contiguous run, when O is
//              narrow; else a strip a column step, in 16-byte vectors. Where M
//              gives few blocks, grid.y splits O's column steps. Several
//              blocks an SM overlap one block's copies with another's MMAs
//              and stores.
//   depthwise  bytes (K*K MACs an output against 3 bytes moved in bf16),
//              though the 5x5 calls come near the integer rate. A block owns
//              a 20-column x TH-row output tile of one 16-channel group: it
//              copies the input halo once into shared memory with 16-byte
//              cp.async (zero-filled at the padding), the weights as dp4a
//              masks (the weight's byte in its channel's lane, zeros in the
//              others, so one dp4a is one MAC and nothing is unpacked). Each
//              thread computes 5 adjacent outputs of 4 channels, holding the
//              input row window in registers, and stores each output pixel's
//              4 channels as one 8-byte (bf16) or 16-byte (fp32, int32)
//              vector. Index math is per block; channel counts that are not
//              a multiple of 16 mask the last group (4-byte copies, or bytes
//              when C is not a multiple of 4).

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

int grid_for(long long n, int block) {
  long long blocks = (n + block - 1) / block;
  const long long cap = 132LL * 16;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// ---------------------------------------------------------------- common
template <int OUT>
struct OutT;
template <>
struct OutT<OUT_F32> { using T = float; };
template <>
struct OutT<OUT_BF16> { using T = __nv_bfloat16; };
template <>
struct OutT<OUT_I32> { using T = int; };

// out = float(acc) * scale (+ bias), each step rounded as JAX rounds it
__device__ __forceinline__ float rescale(int acc, float scale, const float* bias, float b) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return bias ? __fadd_rn(v, b) : v;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared without registers; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one vector of `bytes` (16, 8, 4 or 2) from shared to global memory
__device__ __forceinline__ void copy_vec(void* dst, const void* src, int bytes) {
  switch (bytes) {
    case 16: *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src); break;
    case 8: *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src); break;
    case 4: *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src); break;
    default: *reinterpret_cast<short*>(dst) = *reinterpret_cast<const short*>(src);
  }
}

// above 48 KB a block's dynamic shared memory needs the kernel's opt-in
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------- dense
constexpr int DBM = 128;        // activation rows a block: 4 warps x 32
constexpr int DTHREADS = 128;
constexpr int DSTAGES = 3;      // cp.async ring depth when K streams in chunks
static_assert(DBM == DTHREADS, "the im2col gather gives each thread one row");
// how a block's 128 rows of the [M, K] activation matrix reach shared memory
enum DenseMode {
  DM_ROWS = 0,    // a 1x1 call: 128 consecutive rows of x_q, copied as they lie
  DM_GATHER = 1,  // any call: each row's im2col K bytes, gathered tap by tap
  DM_HALO = 2,    // a KxK call, C % 16 == 0: the rows are a (128/tw) x tw tile of one
                  // image's output; the input patch under it is copied once and the
                  // A fragments are read from it through a table of tap offsets
};

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct DenseArgs {
  const int8_t* x;      // [N, H, W, C]
  const uint2* wf;      // `pack_dense_mma`: [O32 / 8][Kp / 32][32 lanes] x 8 bytes
  const float* sx;      // [1]
  const float* sw;      // [O]
  const float* bias;    // [O] or null
  void* out;            // [M, O]
  long long M;
  int H, W, C, OH, OW, O, KH, KW, SH, SW, PH, PW, K, Kp;
  int lda;              // shared row pitch in bytes, 32 mod 64 (conflict-free 8-byte loads)
  int kch, kchunks;     // K bytes a stage, stages over K
  int nchunks;          // column steps over O
  int ncb;              // column steps a block: blockIdx.y takes [y*ncb, y*ncb + ncb)
  int tw, tiles_x, tiles_y, hr, hc;   // DM_HALO: tile width, tiles, patch rows and columns
  int full;             // 1: each warp stages its 32 whole output rows and stores them
                        // as one contiguous run after the last column step
  int vin;              // bytes a copy of the activation: 16, 4 or 1
  int vout;             // bytes a store of the output: 16, 8, 4 or 2
};

__host__ __device__ constexpr int dense_spitch(int nt, int osz) {
  return 8 * nt * osz + (osz == 2 ? 16 : 32);
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// One A buffer: the input patch (DM_HALO) or every stage of the rows' K bytes.
__host__ __device__ inline int dense_a_bytes(int mode, const DenseArgs& a) {
  return mode == DM_HALO ? round16(a.hr * a.hc * a.C)
                         : (a.kchunks == 1 ? 1 : DSTAGES) * DBM * a.lda;
}

// shared memory: the A buffer, 4 warps' staging rows, then for DM_GATHER
// each row's image offset and input origin, for DM_HALO each row's output
// row index and the k groups' patch offsets
__host__ __device__ inline int dense_stage_pitch(int nt, int osz, const DenseArgs& a) {
  return a.full ? a.O * osz : dense_spitch(nt, osz);
}

__host__ __device__ inline int dense_smem(int mode, int nt, int osz, const DenseArgs& a) {
  return dense_a_bytes(mode, a) + 4 * 32 * dense_stage_pitch(nt, osz, a) +
         (mode == DM_ROWS ? 0 : 2 * DBM * 8) + (mode == DM_HALO ? round16(a.Kp / 8 * 4) : 0);
}

// x [N,H,W,C] int8 (K = KH*KW*C ordered (ky, kx, c), padded to Kp), out
// [M = N*OH*OW, O]. Block blockIdx.x owns a tile of 128 rows of M:
// consecutive ones, or with DM_HALO a (128/tw) x tw patch of one image's
// output. Warp w owns rows w*32 .. w*32+31 of the tile as two m16 tiles; NT
// n8 tiles make one column step of BN = 8*NT; blockIdx.y picks the block's
// column steps.
template <int MODE, int NT, int OUT>
__global__ void __launch_bounds__(DTHREADS) int8_dense_mma_kernel(const DenseArgs a) {
  using T = typename OutT<OUT>::T;
  constexpr int BN = 8 * NT;
  constexpr int OSZ = (int)sizeof(T);
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a_bytes = dense_a_bytes(MODE, a);
  const int spitch = dense_stage_pitch(NT, OSZ, a);
  int8_t* const stg = smem + a_bytes + warp * 32 * spitch;
  long long* const rows = reinterpret_cast<long long*>(smem + a_bytes + 4 * 32 * spitch);
  int2* const row_org = reinterpret_cast<int2*>(rows + DBM);     // DM_GATHER
  int* const koff = reinterpret_cast<int*>(rows + 2 * DBM);       // DM_HALO
  const int tile = blockIdx.x;

  if constexpr (MODE == DM_HALO) {   // each 8-byte k group's offset in the patch
    for (int q = tid; q < (a.Kp >> 3); q += DTHREADS) {
      const int k = q * 8;
      int off = 0;
      if (k < a.K) {
        const int tap = k / a.C, ky = tap / a.KW;
        off = (ky * a.hc + tap - ky * a.KW) * a.C + k - tap * a.C;
      }
      koff[q] = off;
    }
  }
  // this thread's row of the tile: its output row (DM_HALO; the epilogue
  // reads it after a barrier) or its image offset and input origin
  // (DM_GATHER; read by this thread's gather)
  const long long m0 = (long long)tile * DBM;
  int n_img = 0, oy0 = 0, ox0 = 0;
  if constexpr (MODE == DM_HALO) {
    const int per_img = a.tiles_x * a.tiles_y;
    n_img = tile / per_img;
    const int rem = tile - n_img * per_img, ty = rem / a.tiles_x;
    oy0 = ty * (DBM / a.tw);
    ox0 = (rem - ty * a.tiles_x) * a.tw;
    const int oy = oy0 + tid / a.tw, ox = ox0 + tid % a.tw;
    rows[tid] = oy < a.OH && ox < a.OW ? ((long long)n_img * a.OH + oy) * a.OW + ox : -1;
  } else if constexpr (MODE == DM_GATHER) {
    const long long m = m0 + tid;
    long long base = 0;
    int iy0 = -(1 << 28), ix0 = -(1 << 28);
    if (m < a.M) {
      const long long plane = (long long)a.OH * a.OW;
      const long long n = m / plane;
      const int r = (int)(m - n * plane);
      const int oy = r / a.OW;
      base = n * a.H * a.W * a.C;
      iy0 = oy * a.SH - a.PH;
      ix0 = (r - oy * a.OW) * a.SW - a.PW;
    }
    rows[tid] = base;
    row_org[tid] = make_int2(iy0, ix0);
  }

  // K bytes [kc*kch, kc*kch + kch) of the tile's rows into `dst`. Bytes past
  // K stay unwritten: their weights are zero, and any int8 times 0 adds 0.
  auto gather = [&](int kc, int8_t* dst) {
    const int k0 = kc * a.kch;
    const int kend = min(a.kch, (MODE == DM_ROWS ? a.C : a.K) - k0);
    if (kend <= 0) return;
    const int vpr = kend / a.vin;
    if constexpr (MODE == DM_HALO) {   // the patch, pixel by pixel, C bytes each
      const int vpp = a.C >> 4;
      const int iy0 = oy0 * a.SH - a.PH, ix0 = ox0 * a.SW - a.PW;
      const int8_t* const xn = a.x + (long long)n_img * a.H * a.W * a.C;
      for (int e = tid; e < a.hr * a.hc * vpp; e += DTHREADS) {
        const int p = e / vpp, j = e - p * vpp;
        const int hy = p / a.hc, iy = iy0 + hy, ix = ix0 + p - hy * a.hc;
        const bool ok = (unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W;
        const int8_t* s = ok ? xn + ((long long)iy * a.W + ix) * a.C + 16 * j : a.x;
        cp_async16(dst + p * a.C + 16 * j, s, ok ? 16 : 0);
      }
    } else if constexpr (MODE == DM_ROWS) {   // contiguous: neighbouring lanes, neighbouring bytes
      for (int e = tid; e < DBM * vpr; e += DTHREADS) {
        const int r = e / vpr, j = e - r * vpr;
        const long long m = m0 + r;
        if (m >= a.M) continue;
        const int8_t* s = a.x + m * a.C + k0 + j * a.vin;
        int8_t* d = dst + r * a.lda + j * a.vin;
        if (a.vin == 16) cp_async16(d, s, 16);
        else cp_async4(d, s, 4);
      }
    } else {                    // thread tid gathers row tid; (ky, kx, c) advance by counting
      if (m0 + tid >= a.M) return;
      const int2 org = row_org[tid];
      const int8_t* const xb = a.x + rows[tid];
      int8_t* d = dst + tid * a.lda;
      int tap = k0 / a.C, ci = k0 - tap * a.C;
      int ky = tap / a.KW, kx = tap - ky * a.KW;
      for (int j = 0; j < vpr; ++j, d += a.vin) {
        const int iy = org.x + ky, ix = org.y + kx;
        const bool ok = (unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W;
        const int8_t* s = ok ? xb + ((long long)iy * a.W + ix) * a.C + ci : a.x;
        if (a.vin == 16) cp_async16(d, s, ok ? 16 : 0);
        else if (a.vin == 4) cp_async4(d, s, ok ? 4 : 0);
        else *d = ok ? *s : (int8_t)0;
        ci += a.vin;
        if (ci == a.C) {
          ci = 0;
          if (++kx == a.KW) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
  };

  int acc[2][NT][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  };

  const int kpt = a.Kp >> 5;
  // acc += this warp's 32 rows x columns [nc*BN, nc*BN + BN) over stage kc's
  // k32 steps. Lane (g, t) holds bytes 8t .. 8t+7 of a k32 step in both A
  // (rows g, g+8) and B (column g), as the mma's k 4t..4t+3 and 16+4t..19+4t.
  auto mma_chunk = [&](const int8_t* src, int nc, int kc) {
    const int kt0 = kc * (a.kch >> 5);
    const int kts = min(a.kch >> 5, kpt - kt0);
    // the byte of (row, k = 8t) for rows g, g+8, g+16, g+24 of the warp's 32
    int rb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp * 32 + g + 8 * j;
      if constexpr (MODE == DM_HALO)
        rb[j] = ((r / a.tw) * a.SH * a.hc + (r % a.tw) * a.SW) * a.C;
      else
        rb[j] = r * a.lda + 8 * t;
    }
    const uint2* bp = a.wf + ((size_t)nc * NT * kpt + kt0) * 32 + lane;
    for (int kt = 0; kt < kts; ++kt) {
      const int8_t* p = src + (MODE == DM_HALO ? koff[kt * 4 + t] : kt * 32);
      const uint2 r0 = *reinterpret_cast<const uint2*>(p + rb[0]);
      const uint2 r1 = *reinterpret_cast<const uint2*>(p + rb[1]);
      const uint2 r2 = *reinterpret_cast<const uint2*>(p + rb[2]);
      const uint2 r3 = *reinterpret_cast<const uint2*>(p + rb[3]);
      const uint32_t f0[4] = {r0.x, r1.x, r0.y, r1.y};
      const uint32_t f1[4] = {r2.x, r3.x, r2.y, r3.y};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = __ldg(bp + ((size_t)nt * kpt + kt) * 32);
        const uint32_t fb[2] = {b.x, b.y};
        mma_s8(acc[0][nt], f0, fb);
        mma_s8(acc[1][nt], f1, fb);
      }
    }
  };

  // rescale the warp's 32 x BN tile into its staging rows; unless whole rows
  // are staged, store this column step's part of each row in vout-byte
  // vectors
  auto epilogue = [&](int nc) {
    const int n0 = nc * BN;
    float sc[NT][2], bi[NT][2];
    if constexpr (OUT != OUT_I32) {
      const float sx = *a.sx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n0 + nt * 8 + 2 * t + j;
          const bool in = co < a.O;
          sc[nt][j] = in ? __fmul_rn(sx, __ldg(a.sw + co)) : 0.f;
          bi[nt][j] = in && a.bias ? __ldg(a.bias + co) : 0.f;
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = nt * 8 + 2 * t;
          if (a.full && n0 + col >= a.O) continue;      // past the row (O is even)
          int8_t* p = stg + (mt * 16 + h * 8 + g) * spitch + ((a.full ? n0 : 0) + col) * OSZ;
          const int v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if constexpr (OUT == OUT_I32) {
            *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
          } else {
            const float f0 = rescale(v0, sc[nt][0], a.bias, bi[nt][0]);
            const float f1 = rescale(v1, sc[nt][1], a.bias, bi[nt][1]);
            if constexpr (OUT == OUT_F32) *reinterpret_cast<float2*>(p) = make_float2(f0, f1);
            else *reinterpret_cast<uint32_t*>(p) = bf16_pair(f0, f1);
          }
        }
    __syncwarp();
    if (a.full) return;
    const int vpr = min(BN, a.O - n0) * OSZ / a.vout;
    char* const out = reinterpret_cast<char*>(a.out);
    const long long mw = m0 + warp * 32;
    for (int i = lane; i < 32 * vpr; i += 32) {
      const int r = i / vpr, c = i - r * vpr;
      const long long m = MODE == DM_HALO ? rows[warp * 32 + r] : mw + r;
      if (m >= 0 && m < a.M)
        copy_vec(out + (m * a.O + n0) * OSZ + c * a.vout, stg + r * spitch + c * a.vout,
                 a.vout);
    }
    __syncwarp();
  };
  // whole rows staged: the warp's 32 rows are one contiguous run of the output
  auto store_rows = [&]() {
    const long long mw = m0 + warp * 32;
    const long long nrows = min(32LL, a.M - mw);
    if (nrows <= 0) return;
    const int n16 = (int)(nrows * a.O * OSZ / 16);
    int4* const dst = reinterpret_cast<int4*>(reinterpret_cast<char*>(a.out) + mw * a.O * OSZ);
    const int4* const src = reinterpret_cast<const int4*>(stg);
    for (int i = lane; i < n16; i += 32) dst[i] = src[i];
  };

  const int nc0 = blockIdx.y * a.ncb, ncs = min(a.ncb, a.nchunks - nc0);
  if (a.kchunks == 1) {       // the whole K resident: copy the tile once, walk over O
    gather(0, smem);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int nc = nc0; nc < nc0 + ncs; ++nc) {
      zero();
      mma_chunk(smem, nc, 0);
      epilogue(nc);
    }
    if (a.full) store_rows();
    return;
  }
  // K in chunks: a ring of DSTAGES stages over (column step, K chunk)
  const int stage_bytes = DBM * a.lda;
  const int total = ncs * a.kchunks;
#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < total) gather(s % a.kchunks, smem + s * stage_bytes);
    cp_async_commit();
  }
  zero();
  for (int it = 0; it < total; ++it) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();
    const int nxt = it + DSTAGES - 1;
    if (nxt < total) gather(nxt % a.kchunks, smem + (nxt % DSTAGES) * stage_bytes);
    cp_async_commit();
    const int kc = it % a.kchunks;
    mma_chunk(smem + (it % DSTAGES) * stage_bytes, nc0 + it / a.kchunks, kc);
    if (kc == a.kchunks - 1) {
      epilogue(nc0 + it / a.kchunks);
      zero();
    }
  }
}

template <int MODE, int NT, int OUT>
cudaError_t launch_dense(const DenseArgs& a, dim3 grid, int smem, cudaStream_t st) {
  auto kernel = int8_dense_mma_kernel<MODE, NT, OUT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, DTHREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int MODE, int NT>
cudaError_t launch_dense_out(int out_type, const DenseArgs& a, dim3 grid, int smem,
                             cudaStream_t st) {
  if (out_type == OUT_F32) return launch_dense<MODE, NT, OUT_F32>(a, grid, smem, st);
  if (out_type == OUT_BF16) return launch_dense<MODE, NT, OUT_BF16>(a, grid, smem, st);
  return launch_dense<MODE, NT, OUT_I32>(a, grid, smem, st);
}

template <int MODE>
cudaError_t launch_dense_nt(int nt, int out_type, const DenseArgs& a, dim3 grid, int smem,
                            cudaStream_t st) {
  if (nt == 1) return launch_dense_out<MODE, 1>(out_type, a, grid, smem, st);
  if (nt == 2) return launch_dense_out<MODE, 2>(out_type, a, grid, smem, st);
  return launch_dense_out<MODE, 4>(out_type, a, grid, smem, st);
}

// ---------------------------------------------------------------- depthwise
constexpr int DW_PX = 5;              // adjacent outputs a thread
constexpr int DW_TW = 4 * DW_PX;      // output columns a tile: 4 pixel groups
constexpr int DW_CG = 16;             // channels a block: one 16-byte vector a pixel
constexpr int DW_MAX_THREADS = 320;   // 20-row tiles
// 4 blocks of 320 threads an SM caps registers at 51: the halo loads of more
// tiles are in flight at once (edge_n b128's depthwise sum 0.974 -> 0.925 ms
// on an H100; a 5-block cap of 40 registers took it to 1.69)
constexpr int DW_MIN_BLOCKS = 4;

struct DwArgs {
  const int8_t* x;      // [N, H, W, C]
  const int8_t* w;      // [KH, KW, C]
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;            // [N, OH, OW, C]
  int H, W, C, OH, OW, KH, KW, SH, SW, PH, PW;
  int th, tiles_x;      // output rows a tile (16 threads a row), tiles across
  int tiles, groups;    // tiles of an image's channel group; 16-channel groups
  int total;            // tiles in all: tiles x groups x N
  int hr, hc, pitch;    // halo rows, columns, and row pitch in 16-byte slots
  int vin;              // bytes a copy: 16, 4 or 1
};

// shared memory: the tile's weights as dp4a masks [taps][16] ints, then its halo
__host__ __device__ inline int depthwise_smem(const DwArgs& a) {
  return a.KH * a.KW * DW_CG * 4 + a.hr * a.pitch * DW_CG;
}

// K, S > 0: a KxK kernel at stride S, the row window unrolled in registers;
// K = 0: any KH x KW and strides. Block blockIdx.x owns a tile (spatial tile
// fastest, then 16-channel group, then image). Thread (cw, pg, r) = (tid & 3,
// tid >> 2 & 3, tid >> 4) computes channels 4cw .. 4cw+3 of outputs (r,
// 5pg .. 5pg+4).
template <int K, int S, int OUT>
__global__ void __launch_bounds__(DW_MAX_THREADS, DW_MIN_BLOCKS)
    int8_depthwise_tile_kernel(const DwArgs a) {
  using T = typename OutT<OUT>::T;
  extern __shared__ __align__(16) int8_t smem[];
  const int taps = a.KH * a.KW;
  int* const wm = reinterpret_cast<int*>(smem);           // [taps][16] dp4a masks
  int8_t* const halo = smem + taps * DW_CG * 4;           // [hr][pitch][16 bytes]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int xy = blockIdx.x % a.tiles, rest = blockIdx.x / a.tiles;
  const long long n = rest / a.groups;
  const int c0 = (rest - (int)n * a.groups) * DW_CG, cv = min(DW_CG, a.C - c0);
  const int ty = xy / a.tiles_x;
  const int oy0 = ty * a.th, ox0 = (xy - ty * a.tiles_x) * DW_TW;
  const int iy0 = oy0 * a.SH - a.PH, ix0 = ox0 * a.SW - a.PW;

  for (int i = tid; i < taps * DW_CG; i += nthr) {
    const int j = i & (DW_CG - 1);
    const unsigned v = j < cv ? (unsigned)(uint8_t)a.w[(i >> 4) * a.C + c0 + j] : 0u;
    wm[i] = (int)(v << (8 * (j & 3)));
  }
  const int8_t* const xn = a.x + n * a.H * a.W * a.C + c0;
  for (int e = tid; e < a.hr * a.hc; e += nthr) {
    const int hr = e / a.hc, hc = e - hr * a.hc;
    const int iy = iy0 + hr, ix = ix0 + hc;
    const bool ok = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const int8_t* s = ok ? xn + ((long long)iy * a.W + ix) * a.C : a.x;
    int8_t* d = halo + (hr * a.pitch + hc) * DW_CG;
    if (a.vin == 16) {
      cp_async16(d, s, ok ? 16 : 0);
    } else if (a.vin == 4) {
      for (int j = 0; j < cv; j += 4) cp_async4(d + j, s + j, ok ? 4 : 0);
    } else {
      for (int j = 0; j < cv; ++j) d[j] = ok ? s[j] : (int8_t)0;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cw = tid & 3, pg = (tid >> 2) & 3, r = tid >> 4;
  int acc[DW_PX][4];
#pragma unroll
  for (int p = 0; p < DW_PX; ++p)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[p][b] = 0;
  const int* const hw = reinterpret_cast<const int*>(halo);
  if constexpr (K > 0) {
    constexpr int WN = (DW_PX - 1) * S + K;
    const int* row = hw + (r * S * a.pitch + pg * DW_PX * S) * 4 + cw;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      int xw[WN];
#pragma unroll
      for (int j = 0; j < WN; ++j) xw[j] = row[(ky * a.pitch + j) * 4];
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int4 wv = *reinterpret_cast<const int4*>(wm + (ky * K + kx) * DW_CG + cw * 4);
#pragma unroll
        for (int p = 0; p < DW_PX; ++p) {
          const int xv = xw[p * S + kx];
          acc[p][0] = __dp4a(xv, wv.x, acc[p][0]);
          acc[p][1] = __dp4a(xv, wv.y, acc[p][1]);
          acc[p][2] = __dp4a(xv, wv.z, acc[p][2]);
          acc[p][3] = __dp4a(xv, wv.w, acc[p][3]);
        }
      }
    }
  } else {
    const int* row = hw + (r * a.SH * a.pitch + pg * DW_PX * a.SW) * 4 + cw;
    for (int ky = 0; ky < a.KH; ++ky)
      for (int kx = 0; kx < a.KW; ++kx) {
        const int4 wv = *reinterpret_cast<const int4*>(wm + (ky * a.KW + kx) * DW_CG + cw * 4);
#pragma unroll
        for (int p = 0; p < DW_PX; ++p) {
          const int xv = row[(ky * a.pitch + p * a.SW + kx) * 4];
          acc[p][0] = __dp4a(xv, wv.x, acc[p][0]);
          acc[p][1] = __dp4a(xv, wv.y, acc[p][1]);
          acc[p][2] = __dp4a(xv, wv.z, acc[p][2]);
          acc[p][3] = __dp4a(xv, wv.w, acc[p][3]);
        }
      }
  }

  const int oy = oy0 + r;
  if (oy >= a.OH || 4 * cw >= cv) return;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, bi[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (OUT != OUT_I32) {
    const float sx = *a.sx;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int ch = c0 + 4 * cw + b;
      const bool in = 4 * cw + b < cv;
      sc[b] = in ? __fmul_rn(sx, __ldg(a.sw + ch)) : 0.f;
      bi[b] = in && a.bias ? __ldg(a.bias + ch) : 0.f;
    }
  }
  T* const orow = reinterpret_cast<T*>(a.out) + (n * a.OH + oy) * a.OW * a.C + c0 + 4 * cw;
  const bool vec = (a.C & 3) == 0;
#pragma unroll
  for (int p = 0; p < DW_PX; ++p) {
    const int ox = ox0 + pg * DW_PX + p;
    if (ox >= a.OW) break;
    T* const d = orow + (long long)ox * a.C;
    if constexpr (OUT == OUT_I32) {
      if (vec) {
        *reinterpret_cast<int4*>(d) = make_int4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * cw + b < cv) d[b] = acc[p][b];
      }
    } else {
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) f[b] = rescale(acc[p][b], sc[b], a.bias, bi[b]);
      if (vec) {
        if constexpr (OUT == OUT_F32)
          *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
        else
          *reinterpret_cast<uint2*>(d) = make_uint2(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (4 * cw + b >= cv) continue;
          if constexpr (OUT == OUT_F32) d[b] = f[b];
          else d[b] = __float2bfloat16_rn(f[b]);
        }
      }
    }
  }
}

template <int K, int S, int OUT>
cudaError_t launch_dw(const DwArgs& a, dim3 grid, int threads, int smem, cudaStream_t st) {
  auto kernel = int8_depthwise_tile_kernel<K, S, OUT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_dw_out(int out_type, const DwArgs& a, dim3 grid, int threads, int smem,
                          cudaStream_t st) {
  if (out_type == OUT_F32) return launch_dw<K, S, OUT_F32>(a, grid, threads, smem, st);
  if (out_type == OUT_BF16) return launch_dw<K, S, OUT_BF16>(a, grid, threads, smem, st);
  return launch_dw<K, S, OUT_I32>(a, grid, threads, smem, st);
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

// The plan (`cuda_int8.plan_dense`): mode (DenseMode), nt (n8 tiles a column
// step), ncb (column steps a block; grid.y covers the rest), lda, kch (K
// bytes a stage), kchunks, tw (DM_HALO's tile width), full (stage whole
// output rows), vin, vout and smem, which must equal this file's own count.
// wf is `pack_dense_mma`'s fragment-ordered weight.
int yl_int8_conv_dense(const void* x, const void* wf, const void* s_x, const void* s_w,
                       const void* bias, void* out, int out_type, int N, int H, int W, int C,
                       int OH, int OW, int O, int KH, int KW, int SH, int SW, int PH, int PW,
                       int Kp, int mode, int nt, int ncb, int lda, int kch, int kchunks, int tw,
                       int full, int vin, int vout, int smem, void* stream) {
  DenseArgs a;
  a.x = (const int8_t*)x;
  a.wf = (const uint2*)wf;
  a.sx = (const float*)s_x;
  a.sw = (const float*)s_w;
  a.bias = (const float*)bias;
  a.out = out;
  a.M = (long long)N * OH * OW;
  a.H = H; a.W = W; a.C = C; a.OH = OH; a.OW = OW; a.O = O;
  a.KH = KH; a.KW = KW; a.SH = SH; a.SW = SW; a.PH = PH; a.PW = PW;
  a.K = KH * KW * C;
  a.Kp = Kp;
  a.lda = lda;
  a.kch = kch;
  a.kchunks = kchunks;
  a.nchunks = (O + 8 * nt - 1) / (8 * nt);
  a.ncb = ncb;
  a.tw = tw;
  a.full = full;
  a.vin = vin;
  a.vout = vout;
  const int osz = out_type == OUT_BF16 ? 2 : 4;
  long long blocks = (a.M + DBM - 1) / DBM;
  if (mode == DM_HALO) {
    if (tw < 1 || DBM % tw) return (int)cudaErrorInvalidValue;
    a.tiles_x = (OW + tw - 1) / tw;
    a.tiles_y = (OH + DBM / tw - 1) / (DBM / tw);
    a.hr = (DBM / tw - 1) * SH + KH;
    a.hc = (tw - 1) * SW + KW;
    blocks = (long long)N * a.tiles_x * a.tiles_y;
  }
  const bool vin_ok = vin == 16 || (vin == 4 && mode != DM_HALO) || (vin == 1 && mode == DM_GATHER);
  const bool vout_ok = vout == 16 || vout == 8 || vout == 4 || vout == 2;
  if ((nt != 1 && nt != 2 && nt != 4) || mode < DM_ROWS || mode > DM_HALO || !vin_ok ||
      C % vin || !vout_ok || (O * osz) % vout || lda % 64 != 32 || kch % 32 ||
      (long long)kch * kchunks < Kp || (mode == DM_HALO && kchunks != 1) ||
      (mode == DM_ROWS && (KH != 1 || KW != 1)) || ncb < 1 ||
      (full && (mode == DM_HALO || kchunks != 1 || ncb < a.nchunks || (O * osz) % 16)) ||
      (a.nchunks + ncb - 1) / ncb > 65535 || blocks < 1 || blocks > 0x7fffffffLL ||
      smem != dense_smem(mode, nt, osz, a))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((a.nchunks + ncb - 1) / ncb));
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == DM_ROWS) return (int)launch_dense_nt<DM_ROWS>(nt, out_type, a, grid, smem, st);
  if (mode == DM_HALO) return (int)launch_dense_nt<DM_HALO>(nt, out_type, a, grid, smem, st);
  return (int)launch_dense_nt<DM_GATHER>(nt, out_type, a, grid, smem, st);
}

// The plan (`cuda_int8.plan_depthwise`): variant (10*K + S for the unrolled
// KxK kernels, 0 for any shape), th (output rows a tile), pitch (halo row
// pitch in 16-byte slots), vin and smem, which must equal this file's count.
// The grid is one block a tile.
int yl_int8_conv_depthwise(const void* x, const void* w, const void* s_x, const void* s_w,
                           const void* bias, void* out, int out_type, int N, int H, int W,
                           int C, int OH, int OW, int KH, int KW, int SH, int SW, int PH, int PW,
                           int variant, int th, int pitch, int vin, int smem, void* stream) {
  DwArgs a;
  a.x = (const int8_t*)x;
  a.w = (const int8_t*)w;
  a.sx = (const float*)s_x;
  a.sw = (const float*)s_w;
  a.bias = (const float*)bias;
  a.out = out;
  a.H = H; a.W = W; a.C = C; a.OH = OH; a.OW = OW;
  a.KH = KH; a.KW = KW; a.SH = SH; a.SW = SW; a.PH = PH; a.PW = PW;
  a.th = th;
  a.tiles_x = (OW + DW_TW - 1) / DW_TW;
  a.hr = (th - 1) * SH + KH;
  a.hc = (DW_TW - 1) * SW + KW;
  a.pitch = pitch;
  a.vin = vin;
  const long long tiles = th < 1 ? 0 : (long long)a.tiles_x * ((OH + th - 1) / th);
  const long long groups = (C + DW_CG - 1) / DW_CG, total = tiles * groups * N;
  a.tiles = (int)min(tiles, 0x7fffffffLL);
  a.groups = (int)groups;
  a.total = (int)min(total, 0x7fffffffLL);
  const int threads = 16 * th;
  const bool vin_ok = vin == 16 || vin == 4 || vin == 1;
  const bool var_ok = variant == 0 || (KH == KW && SH == SW && variant == 10 * KH + SH);
  if (!vin_ok || C % vin || !var_ok || th < 1 || threads > DW_MAX_THREADS || pitch < a.hc ||
      smem != depthwise_smem(a) || total < 1 || total > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)total);
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 31: return (int)launch_dw_out<3, 1>(out_type, a, grid, threads, smem, st);
    case 32: return (int)launch_dw_out<3, 2>(out_type, a, grid, threads, smem, st);
    case 51: return (int)launch_dw_out<5, 1>(out_type, a, grid, threads, smem, st);
    case 52: return (int)launch_dw_out<5, 2>(out_type, a, grid, threads, smem, st);
    case 71: return (int)launch_dw_out<7, 1>(out_type, a, grid, threads, smem, st);
    case 0: return (int)launch_dw_out<0, 0>(out_type, a, grid, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
