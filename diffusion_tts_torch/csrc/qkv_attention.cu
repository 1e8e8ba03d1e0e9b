// Fused all-heads self-attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels _qkv_attn_kernel / _qkv_attn_pair_kernel
// (diffusion_tts_tpu/ops/pallas/attention.py::qkv_self_attention). Same
// function: softmax(q.k^T / sqrt(d)) in fp32 over all keys, P cast to the
// input dtype before P.V (the reference AttentionOp cast point), P.V
// accumulated in fp32, output in the input dtype.
//
// What bounds it on this card: at the UNet shapes (T = 64..1024, d = 64)
// attention does 4*T*d FLOPs per q row against 2*3*d input bytes, i.e. it
// is compute-bound (about T/1.5 FLOP/byte for bf16). This first version
// runs the products on the CUDA cores (fp32 FMA) and is therefore bound by
// shared-memory operand traffic and the fp32 FMA rate, far below the
// tensor-core roof; wgmma/TMA come later.
//
// What the design does about it:
//   * Nothing of the TPU design (whole [T, 3C] resident in VMEM, one grid
//     step per (batch, q-tile) over all heads) carries over: one block is
//     one (batch, head, 64-row q tile), so the 132 SMs see B*H*T/64
//     independent blocks and nothing is carried between blocks.
//   * K/V stream through shared memory in 64-key tiles with an online
//     softmax (running max and fp32 row sum), so no [T, T] score matrix
//     exists anywhere and any T works; the ragged last tile is masked.
//   * 256 threads; each owns a 4x4 register tile of S and of O (rows
//     ty + 16 i, columns tx + 16 j). The 16 threads of one row live in
//     one half-warp, so row max/sum reductions are 4 shuffles.
//   * K and P share one buffer (K is dead once S is formed); rows are
//     padded to 65 floats so column-strided reads hit 16 distinct banks.
//   * Explicit (batch, token, head) strides for q, k, v and o: the same
//     code serves the [B, T, 3C] qkv layout and a [B, T, H, D] layout.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head width
constexpr int kTile = 64;      // q rows per block and keys per K/V tile
constexpr int kPitch = kD + 1;  // padded smem row (floats)
constexpr int kThreads = 256;
constexpr int kSmemBytes = 3 * kTile * kPitch * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P in the input dtype for P.V: a round trip through bf16, or nothing.
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

// Load one [kTile, kD] tile (rows row0.., clipped at t) into padded smem.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0, int t,
                                          int64_t stride_t, int tid) {
  for (int e = tid; e < kTile * kD; e += kThreads) {
    int r = e / kD, c = e % kD;
    int row = row0 + r;
    dst[r * kPitch + c] = row < t ? to_f32(base[row * stride_t + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int t,
                     int64_t in_sb, int64_t in_st, int64_t in_sh,
                     int64_t out_sb, int64_t out_st, int64_t out_sh,
                     float scale_log2e) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][kPitch]
  float* kp = smem + kTile * kPitch;      // K tile, then P tile
  float* vs = smem + 2 * kTile * kPitch;  // [kTile][kPitch]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const T* qb = q + in_off;
  const T* kb = k + in_off;
  const T* vb = v + in_off;

  load_tile(qs, qb, q0, t, in_st, tid);

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kTile) {
    load_tile(kp, kb, k0, t, in_st, tid);
    load_tile(vs, vb, k0, t, in_st, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kPitch + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kp[(tx + 16 * j) * kPitch + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax in the log2 domain: exp(x*scale) == exp2(x*scale*log2e)
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < t) ? s[i][j] * scale_log2e : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new = fmaxf(m[i], mx);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[i][j] - m_new);
        l[i] += p;  // fp32 row sum of the unrounded weights
        s[i][j] = round_p<T>(p);
        acc[i][j] *= alpha[i];
      }
    }
    __syncthreads();  // every thread is done reading K: reuse it for P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kp[(ty + 16 * i) * kPitch + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = kp[(ty + 16 * i) * kPitch + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[kk * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // P and V are read: the next tile may overwrite them
  }

  T* ob = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    int row = q0 + ty + 16 * i;
    if (row < t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ob[row * out_st + tx + 16 * j] = from_f32<T>(acc[i][j] / li);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int h,
                   int t, int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t out_sb,
                   int64_t out_st, int64_t out_sh, float scale_log2e, cudaStream_t stream) {
  // 49,920 bytes of dynamic shared memory is above the 48 KB default; the
  // attribute is per device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(qkv_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, h, b);
  qkv_attention_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale_log2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// launch's cudaError_t (0 on success); the caller raises on anything else.
extern "C" int dtts_attention_d64(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int b, int h, int t, int64_t in_sb,
                                  int64_t in_st, int64_t in_sh, int64_t out_sb,
                                  int64_t out_st, int64_t out_sh, float scale_log2e,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb, out_st, out_sh,
                         scale_log2e, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb, out_st,
                                 out_sh, scale_log2e, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
