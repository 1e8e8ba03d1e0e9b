// GEGLU feed-forward for Hopper (sm_90a), plain C interface, four routes.
//
// Replaces the TPU kernels _geglu_kernel / _geglu_stream_kernel behind
// diffusion_tts_tpu/ops/pallas/geglu_ff.py::geglu_ff. Same function, with
// PyTorch's [out, in] weights (w0 [2F, C], w2 [C, F]):
//   [h | gate] = x . w0^T + b0   fp32 accumulation, + bias in fp32, each
//                                rounded to the input dtype (the Dense
//                                output rounding of the TPU kernel);
//   g   = h * gelu(gate)         in fp32 with the exact erf (erff; the TPU
//                                kernel's polynomial exists only because
//                                Mosaic lacks erf), rounded to the input dtype;
//   out = g . w2^T + b2          fp32 accumulation, rounded once.
//
// What bounds it on this card: operations. At the SD shapes the FF does
// 6 * M * C * F FLOPs on (M * C + 3 * C * F + M * C) elements, hundreds of
// FLOPs per byte, far above the H100's 295 FLOP/byte bf16 balance point
// (but at M = 128, the 8x8 latent's rows, the weights' bytes). In fp32 the
// least time is the tensor cores' TF32 rate over the three tf32 products an
// fp32-accurate product takes (164.9 TFLOP/s); the CUDA cores' fp32 FMA
// peaks at 67.
//
// Two launches on every route. Launch 1 is a tiled GEMM whose blocks
// compute matching column tiles of h and of gate from one shared x tile, so
// the epilogue has both and applies bias, rounding and the gelu gate there.
// Launch 2 is the same tiled GEMM for g . w2^T + b2. The [M, F] g tensor goes
// through device memory between them (the TPU kernel keeps it in VMEM): a
// fused kernel would hold an fp32 out tile [BM, C] over all of F, 640 KB at
// BM = 128 and C = 1280, more than a block has; g's round trip is 84 MB each
// way at the largest SD shape, about 50 us at 3.35 TB/s.
//
// Routes. The caller picks one (ops/kernels/geglu_ff.py::route) and this file
// obeys:
//   * tf32x3 (route 3): fp32, C and F multiples of 32 (every SD-1.5 width;
//     a TMA box row is 32 floats), every operand 16-byte aligned; the wgmma
//     route's structure with each product three tf32 wgmma products of the
//     fp32 operands split into hi and lo (geglu_tf32_kernel, below), so that
//     fp32 holds 1e-4 against an fp32 reference with TF32 off.
//   * wgmma (route 2): bf16, C and F multiples of 64 (every SD-1.5 width),
//     every operand 16-byte aligned; Hopper's asynchronous warpgroup
//     products fed by TMA, below.
//   * mma (route 1): bf16, C and F multiples of 8, every operand 16-byte
//     aligned; the products run on the tensor cores (mma.sync m16n8k16, bf16
//     operands, fp32 accumulators: exactly the arithmetic above). It serves
//     the test widths; forced (route="mma") at a wgmma width it times the
//     first tensor-core design beside the new one.
//   * fma (route 0): fp32 at the widths tf32x3 does not take (the test
//     nets' C = 40), and either dtype when asked, which times the first
//     design; the products run on the CUDA cores in fp32 FMA.
//
// The wgmma route (geglu_wgmma_kernel, one template for both launches):
//   * Every operand is K-major (x [M, C], w0 [2F, C], g [M, F], w2 [C, F]),
//     which wgmma reads natively for both bf16 operands. Each is read through
//     a 2-D tensor map in boxes of 64 columns (128-byte rows, 128-byte
//     swizzle), encoded on the host for each call (hopper.cuh's
//     encode_tiled, no -lcuda). Rows past M arrive zero-filled and are
//     masked at the store.
//   * Warp roles: one producer warp (one lane issues every TMA load) keeps a
//     ring of K = 64 stages in flight with full and empty mbarriers; one to
//     three consumer warpgroups take 64 rows each of a tile and run
//     m64nBNk16 products from shared memory into fp32 accumulators,
//     freeing a stage once the next stage's products are issued.
//   * Persistent: min(units, slots) blocks walk the units blockIdx.x,
//     + gridDim.x, ...; the producer fills the next unit's stages while the
//     consumers run the last one's epilogue. The caller's plan
//     (ops/kernels/geglu_ff.py::wgmma_plan) sets each launch's tile rows:
//     128 or 192 (two or three consumers, 4 stages, one block an SM), or
//     64 (one consumer, 3-4 stages, two blocks an SM, so one block's
//     epilogue runs beside the other's products) where larger tiles would
//     leave SMs idle. The units walk the smaller operand's tiles fastest,
//     so the larger streams from device memory once and the smaller is read
//     again from L2.
//   * Launch 1: a tile is 64 g columns, its B tile two 64-row boxes of w0's
//     one map (rows n0 and F + n0), so each thread's accumulator holds h and
//     the gate of the same columns; the epilogue adds the bias, rounds,
//     applies the erff gelu and rounds again, as above. It is bound by what
//     it reads from L2 (about 6 TB/s of stages at the SD widths): a 192-row
//     tile reads 17% less a row than a 128-row one.
//   * Launch 2: 128 or 160 output columns a tile (C = 320, 640, 1280 are
//     whole numbers of 160, so the SD calls fill the SMs in fewer waves).
//     Where the tiles fill under a quarter of the card (the C = 1280 call at
//     M = 128) the depth F is split into `split` shares: each unit writes
//     its fp32 partial, and the tile's last arrival (an integer atomic
//     counter, zeroed by launch 1) sums the partials in a fixed order, adds
//     the bias once and rounds once: two calls give the same bits, and no
//     fp32 atomics are used.
//   * Registers: at most 168 a thread at 288 threads (three warps an SM
//     sub-partition), 152 at 416; the accumulators take 64 (BN = 128) or 80
//     (160), and ptxas reports no spill.
//   * Nothing gives way: a refused encode, launch or misaligned operand is
//     an error (the wrapper raises), never a fall back to the mma route.
//
// The mma route:
//   * Every operand is K-contiguous: x [M, C], w0 [2F, C], g [M, F],
//     w2 [C, F]. That is the row.col layout mma.sync takes, so ldmatrix reads
//     both operands untransposed and no weight is transposed per call.
//   * A block computes a 128 x 128 tile: in launch 1, 64 h columns and the
//     matching 64 gate columns (two row ranges of w0 in one B tile); in
//     launch 2, 128 output columns. 8 warps as 2 (rows) x 4 (columns), each
//     a 64 x 32 tile of 4 x 4 fragments; in launch 1 a warp's 32 columns are
//     16 h and the same 16 gate columns, so each lane holds both halves of
//     the values its epilogue combines.
//   * K steps of 32 through a 4-stage cp.async ring (16-byte copies, 80 KB of
//     shared memory, rows padded to 40 elements so that every ldmatrix is
//     conflict-free). Ragged M, N and K are zero-filled by the copies and
//     masked at the store.
//   * The epilogue stays in fp32 as the function says: bias, round to bf16,
//     erff gelu, round; bf16 pairs stored as 4-byte words.
//
// The tf32x3 route (geglu_tf32_kernel; tiles, units and plan as on wgmma):
//   * Numerics: x = hi + lo with hi the fp32 value as it lies, which the
//     tensor cores read with its low 13 mantissa bits dropped, and lo = those
//     bits (tf32_tail, exact), read as tf32 in turn: about 21 bits of x. A
//     product is lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first, in
//     fp32 accumulators; one tf32 product alone (about 11 bits) misses 1e-4.
//     The tensor cores' fp32 accumulation drops low bits of its addends, so
//     each 128-deep group of products is summed there and the groups are
//     added on the CUDA cores (kTfPromote).
//     The epilogue is the fp32 one of the other routes (bias, erff gelu).
//   * Stages of K = 32 (one 128-byte row of fp32), boxes of 32 floats with
//     the 128-byte swizzle: a k8 step is the 32-byte step of a bf16 k16, so
//     the descriptors are the wgmma route's. All four operands are K-major as
//     they lie, which tf32 wgmma (K-major only) needs.
//   * The split is the consumers' work, not a warpgroup of its own (#6's
//     wgmma route found such a transform warpgroup could not keep up): they
//     write stage it's lo planes (only lo: hi is the raw tile) while the
//     tensor pipe runs stage it - 1's products, into one of two lo buffers.
//   * What bounds it: shared memory's bandwidth. A 128 x 128 x 32 stage with
//     two consumer warpgroups moves about 240 KB through shared memory (TMA
//     32 KB, the split 64 KB, the twelve products' operands 144 KB), about
//     1,900 clocks at 128 B a clock against 1,540 of products.
//   * One block an SM (4 raw stages and the two lo buffers, 148-222 KB), one
//     or two consumer warpgroups and a producer warpgroup (setmaxnreg gives
//     two consumers 208 registers: a group's accumulator and the total).
//
// The fma route: 256 threads as 16 x 16, each owning a 4 x 4 register tile
// (rows ty + 16 i, columns tx + 16 j) of each product over 64 x 64 block
// tiles; the K loop stages [16, 64] slices of both operands, transposed, into
// shared-memory rows padded to 65 floats. Ragged M, N and K are masked.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows and columns of an output tile
constexpr int kDepth = 16;  // K per smem stage
constexpr int kPitch = kTile + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// dst[kk][r] = src[(row0 + r) * ld + k0 + kk] for a [kTile, kDepth] slice of
// a row-major [rows, kdim] matrix; zero outside it.
template <typename T>
__device__ __forceinline__ void load_slice(float (*dst)[kPitch], const T* src, int64_t ld,
                                           int row0, int rows, int k0, int kdim, int tid) {
  for (int e = tid; e < kTile * kDepth; e += kThreads) {
    int r = e / kDepth, kk = e % kDepth;
    int row = row0 + r, col = k0 + kk;
    dst[kk][r] = (row < rows && col < kdim) ? to_f32(src[(int64_t)row * ld + col]) : 0.f;
  }
}

// Launch 1: g[m, n] = round(round(x.w0[n] + b0[n]) * gelu(round(x.w0[F + n] + b0[F + n]))).
template <typename T>
__global__ void __launch_bounds__(kThreads)
geglu_gate_kernel(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
                  T* __restrict__ g, int m, int c, int f) {
  __shared__ float xs[kDepth][kPitch], hs[kDepth][kPitch], gs[kDepth][kPitch];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const T* w0g = w0 + (int64_t)f * c;
  float ah[4][4], ag[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ah[i][j] = ag[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kDepth) {
    load_slice(xs, x, c, m0, m, k0, c, tid);
    load_slice(hs, w0, c, n0, f, k0, c, tid);
    load_slice(gs, w0g, c, n0, f, k0, c, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], bh[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bh[j] = hs[kk][tx + 16 * j];
        bg[j] = gs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[i][j] = fmaf(a[i], bh[j], ah[i][j]);
          ag[i][j] = fmaf(a[i], bg[j], ag[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int col = n0 + tx + 16 * j;
      if (col >= f) continue;
      float h = round_to<T>(ah[i][j] + to_f32(b0[col]));
      float gate = round_to<T>(ag[i][j] + to_f32(b0[f + col]));
      float gelu = 0.5f * gate * (1.f + erff(gate * 0.70710678118654752f));
      g[(int64_t)row * f + col] = from_f32<T>(h * gelu);
    }
  }
}

// Launch 2: out[m, n] = round(g[m] . w2[n] + b2[n]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
geglu_out_kernel(const T* __restrict__ g, const T* __restrict__ w2, const T* __restrict__ b2,
                 T* __restrict__ out, int m, int c, int f) {
  __shared__ float as[kDepth][kPitch], bs[kDepth][kPitch];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < f; k0 += kDepth) {
    load_slice(as, g, f, m0, m, k0, f, tid);
    load_slice(bs, w2, f, n0, c, k0, f, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int col = n0 + tx + 16 * j;
      if (col < c) out[(int64_t)row * c + col] = from_f32<T>(acc[i][j] + to_f32(b2[col]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w0, const void* b0, const void* w2,
                   const void* b2, void* g, void* out, int m, int c, int f,
                   cudaStream_t stream) {
  dim3 grid1((f + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  geglu_gate_kernel<T><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(b0),
      static_cast<T*>(g), m, c, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2((c + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  geglu_out_kernel<T><<<grid2, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(out), m, c, f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- mma route

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;
constexpr int kBM = 128, kBN = 128;  // block tile: rows x (h + gate, or output) columns
constexpr int kBD = 32;              // depth per stage
constexpr int kStages = 4;
constexpr int kMmaPitch = kBD + 8;   // shared-memory row, in elements
constexpr int kStageElems = (kBM + kBN) * kMmaPitch;
constexpr int kMmaSmemBytes = kStages * kStageElems * (int)sizeof(bf16);

// One stage: rows m0.. of a [M, depth] and the block's kBN rows of w, depth
// k0..k0 + kBD, as 16-byte copies; anything out of range is zero-filled.
// GATE: B rows 0..63 are w0's h rows n0.., rows 64..127 its gate rows F + n0..
template <bool GATE>
__device__ __forceinline__ void copy_stage(bf16* as, const bf16* a, const bf16* w, int m0,
                                           int m, int n0, int n, int k0, int depth, int tid) {
  bf16* bs = as + kBM * kMmaPitch;
  constexpr int kPieces = kBD / 8;
#pragma unroll
  for (int i = 0; i < (kBM + kBN) * kPieces / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int r = e / kPieces, col = k0 + 8 * (e % kPieces);
    if (r < kBM) {
      const bool ok = m0 + r < m && col < depth;
      dtts::cp_async16(as + r * kMmaPitch + (col - k0),
                       a + (ok ? (int64_t)(m0 + r) * depth + col : 0), ok);
    } else {
      const int rb = r - kBM;
      const int nn = GATE ? n0 + (rb & 63) : n0 + rb;
      const int wrow = GATE && rb >= 64 ? n + nn : nn;
      const bool ok = nn < n && col < depth;
      dtts::cp_async16(bs + rb * kMmaPitch + (col - k0),
                       w + (ok ? (int64_t)wrow * depth + col : 0), ok);
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// GATE: a = x [M, C], w = w0 [2F, C], bias = b0 [2F], out = g [M, F]; n = F,
// depth = C. Else: a = g [M, F], w = w2 [C, F], bias = b2 [C], out [M, C];
// n = C, depth = F.
template <bool GATE>
__global__ void __launch_bounds__(kMmaThreads)
geglu_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int n,
                 int depth) {
  extern __shared__ __align__(16) unsigned char geglu_smem[];
  bf16* smem = reinterpret_cast<bf16*>(geglu_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's rows wm * 64.., column slot wn
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * (GATE ? kBN / 2 : kBN);
  const int nk = (depth + kBD - 1) / kBD;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) copy_stage<GATE>(smem + st * kStageElems, a, w, m0, m, n0, n, st * kBD, depth, tid);
    dtts::cp_async_commit();
  }

  // acc[i][j]: rows wm * 64 + 16 i, B rows of n-block j (GATE: j = 0, 1 h and
  // j = 2, 3 the same columns' gate).
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    dtts::cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();                     // ... for every thread; stage kt - 1 is read
    const int nx = kt + kStages - 1;
    if (nx < nk)
      copy_stage<GATE>(smem + (nx % kStages) * kStageElems, a, w, m0, m, n0, n, nx * kBD,
                       depth, tid);
    dtts::cp_async_commit();
    const bf16* as = smem + (kt % kStages) * kStageElems;
    const bf16* bs = as + kBM * kMmaPitch;
#pragma unroll
    for (int kk = 0; kk < kBD; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dtts::load_a(af[i], as, kMmaPitch, wm * 64 + 16 * i, kk, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        dtts::load_b2(bfr[p], bs, kMmaPitch, GATE ? 64 * p + 16 * wn : 32 * wn + 16 * p, kk,
                      lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          dtts::mma_bf16(acc[i][2 * p], af[i], bfr[p][0], bfr[p][1]);
          dtts::mma_bf16(acc[i][2 * p + 1], af[i], bfr[p][2], bfr[p][3]);
        }
    }
  }
  dtts::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm * 64 + 16 * i + g + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < (GATE ? 2 : 4); ++j) {
        const int col = n0 + (GATE ? 16 : 32) * wn + 8 * j + 2 * tq;
        if (col >= n) continue;  // n % 8 == 0: col + 1 < n as well
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (GATE) {
            const float h = round_bf16(acc[i][j][2 * r + e] + __bfloat162float(bias[col + e]));
            const float gate =
                round_bf16(acc[i][j + 2][2 * r + e] + __bfloat162float(bias[n + col + e]));
            v[e] = h * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
          } else {
            v[e] = acc[i][j][2 * r + e] + __bfloat162float(bias[col + e]);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * n + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

cudaError_t launch_mma(const void* x, const void* w0, const void* b0, const void* w2,
                       const void* b2, void* g, void* out, int m, int c, int f,
                       cudaStream_t stream) {
  // Above the 48 KB default; the attribute is per device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(
      geglu_mma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geglu_mma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid1((f + kBN / 2 - 1) / (kBN / 2), (m + kBM - 1) / kBM);
  geglu_mma_kernel<true><<<grid1, kMmaThreads, kMmaSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0), static_cast<const bf16*>(b0),
      static_cast<bf16*>(g), m, f, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2((c + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  geglu_mma_kernel<false><<<grid2, kMmaThreads, kMmaSmemBytes, stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), m, c, f);
  return cudaGetLastError();
}

// -------------------------------------------------------------- wgmma route

using dtts::EncodeTiled;
using dtts::encode_tiled;
using dtts::fence_regs;
using dtts::kEncodeFailed;
using dtts::mbar_arrive;
using dtts::mbar_expect_tx;
using dtts::mbar_init;
using dtts::mbar_wait;
using dtts::sm_count;
using dtts::tma_load_2d;
using dtts::wgmma_commit;
using dtts::wgmma_desc;
using dtts::wgmma_fence;
using dtts::wgmma_ss;
using dtts::wgmma_wait;

constexpr int kWgDepth = 64;     // K per stage: one 128-byte swizzled row of bf16
constexpr int kWgRowBytes = 128;

// Shapes of one GEMM of the wgmma route: NC (1-3) consumer warpgroups of 64
// rows (a tile of 64 NC rows), BN B rows per tile (launch 1: 64 h and the
// same 64 gate rows of w0; launch 2: BN output columns), a ring of S stages.
template <int NC, int BN>
struct WgGemm {
  static constexpr int kBM = 64 * NC;
  static constexpr int kStages = NC == 1 && BN == 160 ? 3 : 4;
  static constexpr int kABytes = kBM * kWgRowBytes;
  static constexpr int kBBytes = BN * kWgRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;  // a multiple of 1024
  static constexpr int kThreads = 128 * NC + 32;
  // NC = 1 runs two blocks an SM (one's epilogue beside the other's products)
  static constexpr int kBlocksPerSM = NC == 1 ? 2 : 1;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 16 * kStages;
};

// One GEMM of the wgmma route, persistent: D[M, n] = A[M, depth] . B^T, A
// and B K-major bf16 read through 2-D tensor maps in 64-column boxes with
// the 128-byte swizzle, which is the K-major layout wgmma reads.
//   GATE (launch 1): A = x [M, C], B = w0 [2F, C] (boxes of BN / 2 rows at
//     n0 and F + n0: the accumulator holds the h columns in its first BN / 16
//     n8 blocks and the same columns' gate in the others, in the same
//     thread), n = F,
//     out = g [M, F], bias = b0. Zeroes launch 2's `counters` first.
//   else (launch 2): A = g [M, F], B = w2 [C, F], n = C, out [M, C], bias =
//     b2. With split > 1 each unit is (tile, s), s the fastest: the depth's
//     s-th share, its fp32 partial written to ws [split, M, C]; the unit
//     that counts the tile's last arrival (an integer atomic on counters)
//     sums the partials in the order s = 0, 1, ..., adds the bias once and
//     rounds once, so that two calls give the same bits.
// Units are walked blockIdx.x, + gridDim.x, ...; m_fast puts the m tile
// fastest (the A operand is the smaller one and is read again from L2, B
// streams once), else the n tile. One producer warp (one lane issues the
// TMA loads, running ahead into the next unit while the consumers finish
// the last), NC consumer warpgroups of 64 rows each.
template <int NC, int BN, bool GATE>
__global__ void __launch_bounds__(WgGemm<NC, BN>::kThreads, WgGemm<NC, BN>::kBlocksPerSM)
geglu_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, const bf16* __restrict__ bias,
                   bf16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                   int n_counters, int m, int n, int depth, int split, int m_fast) {
  using C = WgGemm<NC, BN>;
  constexpr int S = C::kStages;
  constexpr int NT = GATE ? BN / 2 : BN;  // output columns of a tile
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  __shared__ int last_unit;
  const uint32_t base = (dtts::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t bar = base + S * C::kStageBytes;  // full[S], then empty[S]
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (S + s); };

  if (GATE) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_counters;
         i += gridDim.x * blockDim.x)
      counters[i] = 0;
  }
  const int mt = (m + C::kBM - 1) / C::kBM, nt = (n + NT - 1) / NT;
  const int units = mt * nt * split;
  const int nk = depth / kWgDepth;
  // unit u: tile u / split and its depth share u % split
  auto decode = [&](int u, int& m0, int& n0, int& k0, int& k1, int& tile) {
    tile = u / split;
    const int s = u % split;
    const int mi = m_fast ? tile % mt : tile / nt, ni = m_fast ? tile / mt : tile % nt;
    m0 = mi * C::kBM;
    n0 = ni * NT;
    k0 = s * nk / split;
    k1 = (s + 1) * nk / split;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;  // consumer warpgroup; NC is the producer warp
  if (w == NC) {
    if (threadIdx.x == 128 * NC) {
      int it = 0;  // stages filled so far, over all units: the ring's position
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0, k0, k1, tile;
        decode(u, m0, n0, k0, k1, tile);
        for (int kk = k0; kk < k1; ++kk, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty(s), ((it / S) - 1) & 1);
          mbar_expect_tx(full(s), C::kStageBytes);
          const uint32_t a_s = base + s * C::kStageBytes, b_s = a_s + C::kABytes;
          tma_load_2d(a_s, &amap, full(s), kk * kWgDepth, m0);
          if (GATE) {
            tma_load_2d(b_s, &bmap, full(s), kk * kWgDepth, n0);
            tma_load_2d(b_s + NT * kWgRowBytes, &bmap, full(s), kk * kWgDepth, n + n0);
          } else {
            tma_load_2d(b_s, &bmap, full(s), kk * kWgDepth, n0);
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart; a k16 step
  // moves the start address 32 bytes along the swizzled row.
  const uint64_t a_desc = wgmma_desc(base + w * 64 * kWgRowBytes, 16, 8 * kWgRowBytes, 1);
  const uint64_t b_desc = wgmma_desc(base + C::kABytes, 16, 8 * kWgRowBytes, 1);
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(empty(s));
  };
  auto consumers_sync = [&]() { asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory"); };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, n0, k0, k1, tile;
    decode(u, m0, n0, k0, k1, tile);
    for (int kk = k0; kk < k1; ++kk, ++it) {
      const int s = it % S;
      mbar_wait(full(s), (it / S) & 1);
      const uint64_t step = (uint64_t)(s * C::kStageBytes) >> 4;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kWgDepth / 16; ++k16)
        wgmma_ss<BN>(acc, a_desc + step + (k16 * 32 >> 4), b_desc + step + (k16 * 32 >> 4),
                     kk > k0 || k16 > 0);
      wgmma_commit();
      if (kk > k0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        fence_regs(acc);
        release((it - 1) % S);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release((it - 1) % S);

    // acc[4 j + 2 r + c]: row 16 warp + g + 8 r of the warpgroup's 64,
    // column 8 j + 2 tq + c of the tile's B rows.
    const int row0 = m0 + 64 * w + 16 * warp + g;
    if (GATE) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          const __nv_bfloat162 bh = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
          const __nv_bfloat162 bg = *reinterpret_cast<const __nv_bfloat162*>(bias + n + col);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float h = round_bf16(acc[4 * j + 2 * r + e] +
                                       __bfloat162float(e ? bh.y : bh.x));
            const float gate = round_bf16(acc[4 * (j + NT / 8) + 2 * r + e] +
                                          __bfloat162float(e ? bg.y : bg.x));
            v[e] = h * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
          }
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * n + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
      continue;
    }
    if (split == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          if (col >= n) continue;  // n % 64 == 0: col + 1 < n as well
          const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * n + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] + __bfloat162float(b.x),
                                    acc[4 * j + 2 * r + 1] + __bfloat162float(b.y));
        }
      }
      continue;
    }
    // Split depth: this unit's partial, then the tile's last arrival sums all.
    const int s_idx = u % split;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col < n)
          *reinterpret_cast<float2*>(ws + ((int64_t)s_idx * m + row) * n + col) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
    __threadfence();  // the partial is visible device-wide before the count
    consumers_sync();
    if (threadIdx.x == 0) last_unit = atomicAdd(counters + tile, 1) == split - 1;
    consumers_sync();
    const bool last = *static_cast<volatile int*>(&last_unit);
    consumers_sync();  // every consumer has read the flag before the next unit sets it
    if (!last) continue;
    __threadfence();
    // acc = p_0 + p_1 + ..., in that order. Each share is read in batches of
    // kBatch pairs, all loaded before any is added, so that a batch's loads
    // are in flight together rather than one load's latency at a time (5 at
    // BN = 160 keeps those kernels inside 168 registers).
    constexpr int kBatch = BN == 160 ? 5 : 8;
    static_assert(NT / 8 % kBatch == 0, "whole batches");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int q = 0; q < split; ++q) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float* src = ws + ((int64_t)q * m + row) * n + n0 + 2 * tq;
#pragma unroll
        for (int b = 0; b < NT / 8 / kBatch; ++b) {
          float2 v[kBatch];
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            const int c8 = 8 * (b * kBatch + jj);
            v[jj] = row < m && n0 + c8 < n ? __ldcg(reinterpret_cast<const float2*>(src + c8))
                                           : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            const int j = b * kBatch + jj;
            acc[4 * j + 2 * r] += v[jj].x;
            acc[4 * j + 2 * r + 1] += v[jj].y;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col >= n) continue;
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * n + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] + __bfloat162float(b.x),
                                  acc[4 * j + 2 * r + 1] + __bfloat162float(b.y));
      }
    }
  }
}

// The 2-D map of a K-major bf16 (or, with fp32, float32) matrix [rows, inner]
// read in boxes of 128-byte rows (64 bf16 or 32 fp32 columns, swizzled at 128
// bytes) by box_rows rows; rows past `rows` read as zero.
int encode_kmajor(CUtensorMap* map, const void* ptr, int inner, int rows, int box_rows,
                  bool fp32 = false) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  const int item = fp32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * item};
  const cuuint32_t box[2] = {(cuuint32_t)(kWgRowBytes / item), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res =
      encode(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

template <int NC, int BN, bool GATE>
cudaError_t launch_wgmma_gemm(const CUtensorMap& am, const CUtensorMap& bm, const void* bias,
                              void* out, float* ws, int* counters, int n_counters, int m, int n,
                              int depth, int split, cudaStream_t stream) {
  using C = WgGemm<NC, BN>;
  cudaError_t err = cudaFuncSetAttribute(geglu_wgmma_kernel<NC, BN, GATE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  constexpr int nt_cols = GATE ? BN / 2 : BN;
  const int64_t units = (int64_t)((m + C::kBM - 1) / C::kBM) * ((n + nt_cols - 1) / nt_cols) *
                        split;
  const int slots = sm_count() * C::kBlocksPerSM;
  const int blocks = units < slots ? (int)units : slots;
  // The A operand is the smaller: it is read again from L2, B streams once.
  const int m_fast = (int64_t)m < (GATE ? 2 * (int64_t)n : (int64_t)n);
  geglu_wgmma_kernel<NC, BN, GATE><<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
      am, bm, static_cast<const bf16*>(bias), static_cast<bf16*>(out), ws, counters, n_counters,
      m, n, depth, split, m_fast);
  return cudaGetLastError();
}

// The wgmma route's two launches. rows1, rows2: tile rows of each launch
// (64, 128, or 192 in launch 1: one to three consumer warpgroups); bn2:
// launch 2's tile columns (128 or 160); split: launch 2's depth shares (1:
// none; else ws holds [split, M, C] fp32 and counters one int per launch-2
// tile).
int launch_wgmma(const void* x, const void* w0, const void* b0, const void* w2, const void* b2,
                 void* g, void* out, float* ws, int* counters, int m, int c, int f, int rows1,
                 int rows2, int bn2, int split, cudaStream_t stream) {
  constexpr int kGateBN = 128;  // launch 1's B rows: 64 h and the same 64 gate columns
  CUtensorMap xm, w0m, gm, w2m;
  int err = encode_kmajor(&xm, x, c, m, rows1);
  if (err == 0) err = encode_kmajor(&w0m, w0, c, 2 * f, kGateBN / 2);
  if (err == 0) err = encode_kmajor(&gm, g, f, m, rows2);
  if (err == 0) err = encode_kmajor(&w2m, w2, f, c, bn2);
  if (err != 0) return err;
  const int tiles2 = split > 1 ? (m + rows2 - 1) / rows2 * ((c + bn2 - 1) / bn2) : 0;
  cudaError_t e;
  if (rows1 == 192)
    e = launch_wgmma_gemm<3, kGateBN, true>(xm, w0m, b0, g, nullptr, counters, tiles2, m, f, c,
                                            1, stream);
  else if (rows1 == 128)
    e = launch_wgmma_gemm<2, kGateBN, true>(xm, w0m, b0, g, nullptr, counters, tiles2, m, f, c,
                                            1, stream);
  else
    e = launch_wgmma_gemm<1, kGateBN, true>(xm, w0m, b0, g, nullptr, counters, tiles2, m, f, c,
                                            1, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
#define DTTS_GEGLU_OUT(NC, BN)                                                                 \
  if (rows2 == 64 * NC && bn2 == BN)                                                           \
    return static_cast<int>(launch_wgmma_gemm<NC, BN, false>(gm, w2m, b2, out, ws, counters,   \
                                                             0, m, c, f, split, stream));
  DTTS_GEGLU_OUT(2, 128)
  DTTS_GEGLU_OUT(2, 160)
  DTTS_GEGLU_OUT(1, 128)
  DTTS_GEGLU_OUT(1, 160)
#undef DTTS_GEGLU_OUT
  return static_cast<int>(cudaErrorInvalidValue);
}


// ------------------------------------------------------------- tf32x3 route

using dtts::fence_proxy_async;
using dtts::tf32_tail;
using dtts::wgmma_ss_tf32;

constexpr int kTfDepth = 32;  // K per stage: one 128-byte swizzled row of fp32
// Stages a group of products accumulates in the tensor cores before the
// group's sum is added to the CUDA cores' fp32 total: the tensor cores'
// fp32 accumulation drops low bits of each addend, an error that grows with
// the chain (5.5e-5 of the largest output at F = 5120 in one chain, 5.1e-6
// promoted: PERF.md §6); 4 stages (K = 128) keep it at the size of a
// 128-deep product.
constexpr int kTfPromote = 4;

// Shapes of one GEMM of the tf32x3 route: NC (1 or 2) consumer warpgroups of
// 64 rows, BN B rows a tile (launch 1: 64 h and the same 64 gate rows of w0;
// launch 2: BN output columns), a ring of S raw stages as TMA writes them and
// two lo buffers of the same layout (the splits of stages it and it + 1). The
// producer is a whole warpgroup, so that at NC = 2 setmaxnreg can move its
// registers to the consumers: each holds its group's accumulator and the
// unit's total, 160 registers at BN = 160, more than the 168 that 9-12 warps
// get at launch leave room for (three warps on an SM sub-partition).
template <int NC, int BN>
struct TfGemm {
  static_assert(NC == 1 || NC == 2, "one or two consumer warpgroups");
  static constexpr int kBM = 64 * NC;
  static constexpr int kABytes = kBM * kWgRowBytes;
  static constexpr int kStageBytes = (kBM + BN) * kWgRowBytes;  // a multiple of 1024
  static constexpr int kThreads = 128 * NC + 128;
  // Registers a thread after setmaxnreg at NC = 2: the launch gives 168 to
  // each of the 384 threads (65,536 / 384, rounded down to 8), shared out
  // again; at NC = 1 the launch's 255 serve as they are. (A producer of 40
  // spilled what it holds across setmaxnreg at BN = 128.)
  static constexpr int kProducerRegs = 88, kConsumerRegs = 208;
  static_assert(NC == 1 || 2 * 128 * kConsumerRegs + 128 * kProducerRegs <= kThreads * 168,
                "setmaxnreg shares out no more than the launch gave");
  // as many raw stages as fit beside the two lo buffers, at most 4
  static constexpr int kFit = (232448 - 1024 - 256 - 2 * kStageBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = 1024 + (kStages + 2) * kStageBytes + 16 * kStages;
  static_assert(kStages >= 3, "three raw stages at least");
};

// One GEMM of the tf32x3 route, persistent, as geglu_wgmma_kernel is (the
// same units, TMA ring, launch 1's paired B boxes and its gelu gate,
// launch 2's fixed-order split of the depth), in fp32: A and B fp32 K-major,
// read through 2-D tensor maps in 32-float boxes with the 128-byte swizzle.
// Each product is three tf32 products, lo_a.hi_b + hi_a.lo_b + hi_a.hi_b,
// the small terms first, in the tensor cores' fp32 accumulators, whose sum
// over each group of kTfPromote stages is added to an fp32 total on the CUDA
// cores (the group's wait comes after the next stage's split, so the split
// still overlaps the products). At stage it the consumers
// first write the lo planes of the stage's A and B tiles (all NC warpgroups
// share the work: a linear float4 pass, since lo keeps TMA's swizzled layout
// element for element) into lo buffer it % 2, while the tensor pipe still
// runs stage it - 1's products, then start stage it's twelve m64nBNk8
// products from shared memory. Two consumer barriers a stage: after the
// split (every lo written) and after the wait for stage it - 1's products
// (so that stage it + 1's split may overwrite that lo buffer).
template <int NC, int BN, bool GATE>
__global__ void __launch_bounds__(TfGemm<NC, BN>::kThreads, 1)
geglu_tf32_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int n_counters, int m, int n, int depth, int split, int m_fast) {
  using C = TfGemm<NC, BN>;
  constexpr int S = C::kStages;
  constexpr int NT = GATE ? BN / 2 : BN;  // output columns of a tile
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  __shared__ int tile_done;
  const uint32_t base = (dtts::smem_addr(tf_smem) + 1023u) & ~1023u;
  const uint32_t lo_base = base + S * C::kStageBytes;  // lo buffers 0 and 1
  const uint32_t bar = lo_base + 2 * C::kStageBytes;   // full[S], then empty[S]
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (S + s); };
  auto smem_ptr = [&](uint32_t addr) { return tf_smem + (addr - dtts::smem_addr(tf_smem)); };

  if (GATE) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_counters;
         i += gridDim.x * blockDim.x)
      counters[i] = 0;
  }
  const int mt = (m + C::kBM - 1) / C::kBM, nt = (n + NT - 1) / NT;
  const int units = mt * nt * split;
  const int nk = depth / kTfDepth;
  // unit u: tile u / split and its depth share u % split
  auto decode = [&](int u, int& m0, int& n0, int& k0, int& k1, int& tile) {
    tile = u / split;
    const int s = u % split;
    const int mi = m_fast ? tile % mt : tile / nt, ni = m_fast ? tile / mt : tile % nt;
    m0 = mi * C::kBM;
    n0 = ni * NT;
    k0 = s * nk / split;
    k1 = (s + 1) * nk / split;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;  // consumer warpgroup; NC is the producer warpgroup
  if (w == NC) {
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 128 * NC) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0, k0, k1, tile;
        decode(u, m0, n0, k0, k1, tile);
        for (int kk = k0; kk < k1; ++kk, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty(s), ((it / S) - 1) & 1);
          mbar_expect_tx(full(s), C::kStageBytes);
          const uint32_t a_s = base + s * C::kStageBytes, b_s = a_s + C::kABytes;
          tma_load_2d(a_s, &amap, full(s), kk * kTfDepth, m0);
          tma_load_2d(b_s, &bmap, full(s), kk * kTfDepth, n0);
          if (GATE) tma_load_2d(b_s + NT * kWgRowBytes, &bmap, full(s), kk * kTfDepth, n + n0);
        }
      }
    }
    return;
  }
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart; a k8 step
  // moves the start 32 bytes along the swizzled row. lo has raw's layout.
  const uint64_t a_desc = wgmma_desc(base + w * 64 * kWgRowBytes, 16, 8 * kWgRowBytes, 1);
  const uint64_t b_desc = wgmma_desc(base + C::kABytes, 16, 8 * kWgRowBytes, 1);
  const uint64_t al_desc = wgmma_desc(lo_base + w * 64 * kWgRowBytes, 16, 8 * kWgRowBytes, 1);
  const uint64_t bl_desc = wgmma_desc(lo_base + C::kABytes, 16, 8 * kWgRowBytes, 1);
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(empty(s));
  };
  auto sync_consumers = [&]() { asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory"); };
  // The lo plane of raw stage s into lo buffer lb. hi is the raw tile: the
  // tensor cores read an fp32 operand with its low 13 mantissa bits dropped
  // (tests/test_torch_kernels_cuda.py holds a product of raw operands
  // bit-equal to the same product of masked ones), so only lo, those bits,
  // is written (hi = tf32(x) rounded and written too, the attention
  // forward's split, ran about 30% slower: PERF.md §6).
  auto split_stage = [&](int s, int lb) {
    const float4* raw = reinterpret_cast<const float4*>(smem_ptr(base + s * C::kStageBytes));
    float4* lo = reinterpret_cast<float4*>(smem_ptr(lo_base + lb * C::kStageBytes));
#pragma unroll 3
    for (int i = threadIdx.x; i < C::kStageBytes / 16; i += 128 * NC) {
      const float4 x = raw[i];
      lo[i] = make_float4(tf32_tail(x.x), tf32_tail(x.y), tf32_tail(x.z), tf32_tail(x.w));
    }
  };

  float acc[BN / 2];   // the CUDA cores' fp32 sum of the unit's promoted groups
  float part[BN / 2];  // the tensor cores' accumulator of the current group
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, n0, k0, k1, tile;
    decode(u, m0, n0, k0, k1, tile);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kk = k0; kk < k1; ++kk, ++it) {
      const int s = it % S, lb = it & 1;
      const bool fresh = (kk - k0) % kTfPromote == 0;  // a group's first stage
      mbar_wait(full(s), (it / S) & 1);
      split_stage(s, lb);
      fence_proxy_async();  // the split's stores, before the products read them
      sync_consumers();
      if (fresh && kk > k0) {  // the last group's products are done: add them up
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        release((it - 1) % S);
      }
      const uint64_t step = (uint64_t)(s * C::kStageBytes) >> 4;
      const uint64_t lstep = (uint64_t)(lb * C::kStageBytes) >> 4;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < kTfDepth / 8; ++k8) {
        const uint64_t o = (uint64_t)(k8 * 32) >> 4;
        wgmma_ss_tf32<BN>(part, al_desc + lstep + o, b_desc + step + o, !fresh || k8 > 0);
        wgmma_ss_tf32<BN>(part, a_desc + step + o, bl_desc + lstep + o, 1);
        wgmma_ss_tf32<BN>(part, a_desc + step + o, b_desc + step + o, 1);
      }
      wgmma_commit();
      if (!fresh) {  // the previous stage's products are done: free its raw slot
        wgmma_wait<1>();
        fence_regs(part);
        release((it - 1) % S);
      }
      sync_consumers();  // ... in every warpgroup: its lo buffer may be written again
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    release((it - 1) % S);

    // acc[4 j + 2 r + c]: row 16 warp + g + 8 r of the warpgroup's 64,
    // column 8 j + 2 tq + c of the tile's B rows.
    const int row0 = m0 + 64 * w + 16 * warp + g;
    if (GATE) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          if (col >= n) continue;  // F % 32 == 0: col + 1 < F as well
          const float2 bh = *reinterpret_cast<const float2*>(bias + col);
          const float2 bg = *reinterpret_cast<const float2*>(bias + n + col);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float h = acc[4 * j + 2 * r + e] + (e ? bh.y : bh.x);
            const float gate = acc[4 * (j + NT / 8) + 2 * r + e] + (e ? bg.y : bg.x);
            v[e] = h * (0.5f * gate * (1.f + erff(0.70710678118654752f * gate)));
          }
          *reinterpret_cast<float2*>(out + (int64_t)row * n + col) = make_float2(v[0], v[1]);
        }
      }
      continue;
    }
    if (split == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          if (col >= n) continue;
          const float2 b = *reinterpret_cast<const float2*>(bias + col);
          *reinterpret_cast<float2*>(out + (int64_t)row * n + col) =
              make_float2(acc[4 * j + 2 * r] + b.x, acc[4 * j + 2 * r + 1] + b.y);
        }
      }
      continue;
    }
    // Split depth: this unit's partial, then the tile's last arrival sums
    // every share in the order 0, 1, ... (as on the wgmma route).
    const int share = u % split;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col >= n) continue;
        *reinterpret_cast<float2*>(ws + ((int64_t)share * m + row) * n + col) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
    __threadfence();  // the partial is visible device-wide before the count
    sync_consumers();
    if (threadIdx.x == 0) tile_done = atomicAdd(counters + tile, 1) == split - 1;
    sync_consumers();
    const bool sum_here = *static_cast<volatile int*>(&tile_done);
    sync_consumers();  // every consumer has read the flag before the next unit sets it
    if (!sum_here) continue;
    __threadfence();
    constexpr int kBatch = BN == 160 ? 5 : 8;
    static_assert(NT / 8 % kBatch == 0, "whole batches");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int q = 0; q < split; ++q) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float* src = ws + ((int64_t)q * m + row) * n + n0 + 2 * tq;
#pragma unroll
        for (int b = 0; b < NT / 8 / kBatch; ++b) {
          float2 v[kBatch];
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            const int c8 = 8 * (b * kBatch + jj);
            v[jj] = row < m && n0 + c8 < n ? __ldcg(reinterpret_cast<const float2*>(src + c8))
                                           : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            acc[4 * (b * kBatch + jj) + 2 * r] += v[jj].x;
            acc[4 * (b * kBatch + jj) + 2 * r + 1] += v[jj].y;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col >= n) continue;
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
        *reinterpret_cast<float2*>(out + (int64_t)row * n + col) =
            make_float2(acc[4 * j + 2 * r] + b.x, acc[4 * j + 2 * r + 1] + b.y);
      }
    }
  }
}

template <int NC, int BN, bool GATE>
cudaError_t launch_tf32_gemm(const CUtensorMap& am, const CUtensorMap& bm, const void* bias,
                             void* out, float* ws, int* counters, int n_counters, int m, int n,
                             int depth, int split, cudaStream_t stream) {
  using C = TfGemm<NC, BN>;
  cudaError_t err = cudaFuncSetAttribute(geglu_tf32_kernel<NC, BN, GATE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  constexpr int nt_cols = GATE ? BN / 2 : BN;
  const int64_t units = (int64_t)((m + C::kBM - 1) / C::kBM) * ((n + nt_cols - 1) / nt_cols) *
                        split;
  const int blocks = units < sm_count() ? (int)units : sm_count();
  // The A operand is the smaller: it is read again from L2, B streams once.
  const int m_fast = (int64_t)m < (GATE ? 2 * (int64_t)n : (int64_t)n);
  geglu_tf32_kernel<NC, BN, GATE><<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
      am, bm, static_cast<const float*>(bias), static_cast<float*>(out), ws, counters,
      n_counters, m, n, depth, split, m_fast);
  return cudaGetLastError();
}

// The tf32x3 route's two launches, with a plan of the wgmma route's form
// (rows1: 64 or 128; rows2: 64 or 128; bn2: 128 or 160; split: launch 2's
// depth shares, ws and counters as there; ops/kernels/geglu_ff.py::tf32x3_plan).
int launch_tf32x3(const void* x, const void* w0, const void* b0, const void* w2, const void* b2,
                  void* g, void* out, float* ws, int* counters, int m, int c, int f, int rows1,
                  int rows2, int bn2, int split, cudaStream_t stream) {
  constexpr int kGateRows = 128;  // launch 1's B rows: 64 h and the same 64 gate columns
  CUtensorMap xm, w0m, gm, w2m;
  int err = encode_kmajor(&xm, x, c, m, rows1, true);
  if (err == 0) err = encode_kmajor(&w0m, w0, c, 2 * f, kGateRows / 2, true);
  if (err == 0) err = encode_kmajor(&gm, g, f, m, rows2, true);
  if (err == 0) err = encode_kmajor(&w2m, w2, f, c, bn2, true);
  if (err != 0) return err;
  const int tiles2 = split > 1 ? (m + rows2 - 1) / rows2 * ((c + bn2 - 1) / bn2) : 0;
  cudaError_t e;
  if (rows1 == 128)
    e = launch_tf32_gemm<2, kGateRows, true>(xm, w0m, b0, g, nullptr, counters, tiles2, m, f, c,
                                             1, stream);
  else
    e = launch_tf32_gemm<1, kGateRows, true>(xm, w0m, b0, g, nullptr, counters, tiles2, m, f, c,
                                             1, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
#define DTTS_GEGLU_TF32_OUT(NC, BN)                                                            \
  if (rows2 == 64 * NC && bn2 == BN)                                                           \
    return static_cast<int>(launch_tf32_gemm<NC, BN, false>(gm, w2m, b2, out, ws, counters, 0, \
                                                            m, c, f, split, stream));
  DTTS_GEGLU_TF32_OUT(2, 128)
  DTTS_GEGLU_TF32_OUT(2, 160)
  DTTS_GEGLU_TF32_OUT(1, 128)
  DTTS_GEGLU_TF32_OUT(1, 160)
#undef DTTS_GEGLU_TF32_OUT
  return static_cast<int>(cudaErrorInvalidValue);
}

// d [64, 32] = a [64, 32] . b [32, 32]^T, fp32 row-major, by four m64n32k8
// tf32 products whose operands lie in shared memory as the tf32x3 route's
// do (K-major, 128-byte swizzle) and as the caller gave them: it shows what
// the tensor cores read of an fp32 value (see split_stage).
__global__ void __launch_bounds__(128) tf32_reads_kernel(const float* __restrict__ a,
                                                         const float* __restrict__ b,
                                                         float* __restrict__ d) {
  __shared__ __align__(1024) float tiles[96 * 32];  // a's 64 rows, then b's 32
  const int tid = threadIdx.x;
  for (int e = tid; e < 96 * 32; e += 128) {
    const int r = e / 32, k = e % 32;
    const float v = r < 64 ? a[r * 32 + k] : b[(r - 64) * 32 + k];
    tiles[r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)] = v;
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t base = dtts::smem_addr(tiles);
  const uint64_t a_desc = wgmma_desc(base, 16, 8 * kWgRowBytes, 1);
  const uint64_t b_desc = wgmma_desc(base + 64 * kWgRowBytes, 16, 8 * kWgRowBytes, 1);
  float acc[16] = {};
  wgmma_fence();
#pragma unroll
  for (int k8 = 0; k8 < 4; ++k8)
    wgmma_ss_tf32<32>(acc, a_desc + 2 * k8, b_desc + 2 * k8, k8 > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = tid / 32, g = (tid % 32) >> 2, tq = tid & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        d[(16 * warp + g + 8 * r) * 32 + 8 * j + 2 * tq + c] = acc[4 * j + 2 * r + c];
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor. x [M, C], w0 [2F, C],
// b0 [2F], w2 [C, F], b2 [C], g (scratch) [M, F], out [M, C], all
// contiguous. route: 0 = fma (either dtype), 1 = mma (bfloat16, C and F
// multiples of 8, every pointer 16-byte aligned), 2 = wgmma (bfloat16, C and
// F multiples of 64, every pointer 16-byte aligned), 3 = tf32x3 (float32, C
// and F multiples of 32, every pointer 16-byte aligned). The wgmma and
// tf32x3 routes' plan (rows1: 64, 128 or, on wgmma, 192; rows2: 64 or 128;
// bn2: 128 or 160; split; ops/kernels/geglu_ff.py::wgmma_plan, tf32x3_plan)
// and their
// split-depth scratch (ws: fp32 [split, M, C], counters: int32, one per
// launch-2 tile; null when split is 1); the other routes ignore them. Two
// launches. Returns the first failing launch's cudaError_t (0 on success),
// or kEncodeFailed + the CUresult of a refused tensor map; the caller raises
// on anything else.
extern "C" int dtts_geglu_ff(const void* x, const void* w0, const void* b0, const void* w2,
                             const void* b2, void* g, void* out, int dtype, int m, int c,
                             int f, int route, void* ws, void* counters, int rows1, int rows2,
                             int bn2, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 3) {
    const bool rows_ok = (rows1 == 64 || rows1 == 128) && (rows2 == 64 || rows2 == 128);
    if (dtype != 0 || c % 32 || f % 32 || !rows_ok || (bn2 != 128 && bn2 != 160) ||
        split < 1 || split > 4 || split > f / 32 ||
        (split > 1 && (ws == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tf32x3(x, w0, b0, w2, b2, g, out, static_cast<float*>(ws),
                         static_cast<int*>(counters), m, c, f, rows1, rows2, bn2, split, s);
  }
  if (route == 2) {
    const bool rows_ok = (rows1 == 64 || rows1 == 128 || rows1 == 192) &&
                         (rows2 == 64 || rows2 == 128);
    if (dtype != 1 || c % 64 || f % 64 || !rows_ok || (bn2 != 128 && bn2 != 160) ||
        split < 1 || split > f / 64 || (split > 1 && (ws == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(x, w0, b0, w2, b2, g, out, static_cast<float*>(ws),
                        static_cast<int*>(counters), m, c, f, rows1, rows2, bn2, split, s);
  }
  if (route == 1) {
    if (dtype != 1 || c % 8 || f % 8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(x, w0, b0, w2, b2, g, out, m, c, f, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w0, b0, w2, b2, g, out, m, c, f, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w0, b0, w2, b2, g, out, m, c, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor cores' reading of fp32 operands (tf32_reads_kernel): d [64, 32]
// = a [64, 32] . b [32, 32]^T, fp32, contiguous, 16-byte aligned. Returns
// the launch's cudaError_t.
extern "C" int dtts_geglu_tf32_reads(const void* a, const void* b, void* d, void* stream) {
  tf32_reads_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
