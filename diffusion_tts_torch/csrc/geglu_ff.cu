// GEGLU feed-forward for Hopper (sm_90a), plain C interface, two routes.
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
// FLOPs per byte, far above the H100's 295 FLOP/byte bf16 balance point.
//
// Two launches on either route. Launch 1 is a tiled GEMM whose blocks
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
//   * mma (route 1): bf16, C and F multiples of 8, every operand 16-byte
//     aligned; the products run on the tensor cores (mma.sync m16n8k16, bf16
//     operands, fp32 accumulators: exactly the arithmetic above).
//   * fma (route 0): fp32 (and bf16 when asked, which times the first
//     design); the products run on the CUDA cores in fp32 FMA, so that fp32
//     holds 1e-4 against an fp32 reference with TF32 off.
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
// The fma route: 256 threads as 16 x 16, each owning a 4 x 4 register tile
// (rows ty + 16 i, columns tx + 16 j) of each product over 64 x 64 block
// tiles; the K loop stages [16, 64] slices of both operands, transposed, into
// shared-memory rows padded to 65 floats. Ragged M, N and K are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor. x [M, C], w0 [2F, C],
// b0 [2F], w2 [C, F], b2 [C], g (scratch) [M, F], out [M, C], all
// contiguous. route: 0 = fma (either dtype), 1 = mma (bfloat16, C and F
// multiples of 8, every pointer 16-byte aligned). Two launches. Returns the
// first failing launch's cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int dtts_geglu_ff(const void* x, const void* w0, const void* b0, const void* w2,
                             const void* b2, void* g, void* out, int dtype, int m, int c,
                             int f, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || c % 8 || f % 8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(x, w0, b0, w2, b2, g, out, m, c, f, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w0, b0, w2, b2, g, out, m, c, f, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w0, b0, w2, b2, g, out, m, c, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
