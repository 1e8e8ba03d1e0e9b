// GEGLU feed-forward for Hopper (sm_90a), plain C interface.
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
// This first version runs the products on the CUDA cores in fp32 from
// shared memory, far below the tensor-core roof; mma/wgmma come later.
//
// What the design does about it:
//   * Two launches. Launch 1 is a tiled GEMM whose blocks compute matching
//     64 x 64 column tiles of h and of gate from one shared x tile, so the
//     epilogue has both and applies bias, rounding and the gelu gate there.
//     Launch 2 is the same tiled GEMM for g . w2^T + b2.
//   * The [M, F] g tensor goes through device memory between the two
//     launches (the TPU kernel keeps it in VMEM): M * F * itemsize bytes
//     written and read again, 84 MB each way per call at the SD 64x64
//     level at batch 8 in bf16.
//     Fusing it away is later work.
//   * 256 threads as 16 x 16, each owning a 4 x 4 register tile (rows
//     ty + 16 i, columns tx + 16 j) of each product; the K loop stages
//     [16, 64] slices of both operands, transposed, into smem rows padded
//     to 65 floats.
//   * Weights are read in their [out, in] layout; nothing is transposed per
//     call. Ragged M, N and K are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every tensor. x [M, C], w0 [2F, C],
// b0 [2F], w2 [C, F], b2 [C], g (scratch) [M, F], out [M, C], all
// contiguous. Two launches. Returns the first failing launch's cudaError_t
// (0 on success); the caller raises on anything else.
extern "C" int dtts_geglu_ff(const void* x, const void* w0, const void* b0, const void* w2,
                             const void* b2, void* g, void* out, int dtype, int m, int c,
                             int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w0, b0, w2, b2, g, out, m, c, f, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w0, b0, w2, b2, g, out, m, c, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
