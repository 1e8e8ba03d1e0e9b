// Self-attention for Hopper (sm_90a), any supported head width, plain C
// interface.
//
// Replaces two TPU kernels of diffusion_tts_tpu/ops/pallas/attention.py:
//   * qkv_self_attention (_qkv_attn_kernel / _qkv_attn_pair_kernel), the
//     EDM UNet's all-heads attention on the [B, T, 3C] projection, d = 64;
//   * flash_attention (_attn_kernel / _attn_kernel_dual), [B, T, H, D]
//     attention: the SD UNet's self-attention (d = 40, 80, 160) and the SD
//     VAE mid-block's single head (d = 512); d = 4 ... 32 serve the
//     test-width SD nets (the CLI's tiny random pipeline among them).
// Same function: softmax(q.k^T / sqrt(d)) in fp32 over all keys, P cast to
// the input dtype before P.V (the reference AttentionOp cast point), P.V
// accumulated in fp32, output in the input dtype. The row sum is taken from
// the unrounded weights, as the Pallas pair kernel does (the flash kernel
// sums the rounded ones; the two differ below the bf16 output rounding).
//
// What bounds it on this card: at the path's shapes attention does 4*T*d
// FLOPs per q row against 2*3*d input bytes, i.e. it is compute-bound (about
// T/1.5 FLOP/byte for bf16). This first version runs the products on the
// CUDA cores (fp32 FMA) and is therefore bound by shared-memory operand
// traffic and the fp32 FMA rate, far below the tensor-core roof; wgmma/TMA
// come later.
//
// What the design does about it:
//   * Nothing of the TPU design (whole [T, 3C] or K/V resident in VMEM, one
//     grid step per (batch, q-tile)) carries over: one block is one (batch,
//     head, BQ-row q tile), so the 132 SMs see B*H*T/BQ independent blocks
//     and nothing is carried between blocks.
//   * K/V stream through shared memory in BK-key tiles with an online
//     softmax (running max and fp32 row sum), so no [T, T] score matrix
//     exists anywhere and any T works; the ragged last tile is masked. The
//     VAE's d = 512 head, which the TPU could not hold resident, streams
//     like every other width.
//   * 256 threads as 16 x 16; each owns BQ/16 rows and BK/16 keys of S and
//     BQ/16 rows and DP/16 columns of O (rows ty + 16 i, columns tx + 16 j).
//     The 16 threads of one row live in one half-warp, so row max/sum
//     reductions are 4 shuffles.
//   * The head width is a template parameter. DP rounds it up to 16 with
//     zero columns (40 -> 48), which leave S unchanged and are not stored.
//     Tiles per width keep the three fp32 tiles inside a block's shared
//     memory: 64 x 64 up to d = 160 (123,648 bytes there), 32 x 32 at
//     d = 512 (196,992 bytes).
//   * K and P share one buffer where P fits into it (K is dead once S is
//     formed); rows are padded by one float so column-strided reads hit
//     distinct banks. The d = 64 instantiation keeps the first version's
//     64 x 64 tiles, 49,920 bytes and layout.
//   * Explicit (batch, token, head) strides for q, k, v and o: the same
//     code serves the [B, T, 3C] qkv layout and a [B, T, H, D] layout.
//   * Training: the block already holds each row's running maximum and sum,
//     so on request it writes the row's log2-sum-exp2 (fp32 [B, H, T]) for the
//     backward kernels (csrc/attention_bwd.cu), which then need no statistics
//     pass of their own (the TPU forward saves none, and its backward starts
//     with one more q.k^T pass). A null pointer, as in serving, writes nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Tile shapes for head width D: BQ q rows per block, BK keys per K/V tile.
template <int D, int BQ, int BK>
struct Tiles {
  static constexpr int kDP = (D + 15) / 16 * 16;  // D padded with zero columns
  static constexpr int kRows = BQ / 16;           // q rows per thread
  static constexpr int kKeys = BK / 16;           // keys per thread
  static constexpr int kCols = kDP / 16;          // output columns per thread
  static constexpr int kPitch = kDP + 1;          // Q/K/V smem row (floats)
  static constexpr int kPPitch = BK + 1;          // P smem row (floats)
  static constexpr bool kShareKP = BQ * kPPitch <= BK * kPitch;
  static constexpr int kQFloats = BQ * kPitch;
  static constexpr int kKFloats = BK * kPitch;
  static constexpr int kSmemBytes =
      (kQFloats + 2 * kKFloats + (kShareKP ? 0 : BQ * kPPitch)) * (int)sizeof(float);
  static_assert(BQ % 16 == 0 && BK % 16 == 0, "tiles are multiples of 16");
  static_assert(kSmemBytes <= 232448, "tiles exceed a block's shared memory");
};

// Load one [ROWS, DP] tile (rows row0.., clipped at t; columns past D are
// zero) into padded smem.
template <typename T, int ROWS, int D, int DP, int PITCH>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0, int t,
                                          int64_t stride_t, int tid) {
  for (int e = tid; e < ROWS * DP; e += kThreads) {
    int r = e / DP, c = e % DP;
    int row = row0 + r;
    dst[r * PITCH + c] = (row < t && c < D) ? to_f32(base[row * stride_t + c]) : 0.f;
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t,
                 int64_t in_sb, int64_t in_st, int64_t in_sh,
                 int64_t out_sb, int64_t out_st, int64_t out_sh,
                 float scale_log2e, float* __restrict__ lse) {
  using C = Tiles<D, BQ, BK>;
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][kPitch]
  float* ks = smem + C::kQFloats;    // [BK][kPitch]
  float* vs = ks + C::kKFloats;      // [BK][kPitch]
  float* ps = C::kShareKP ? ks : vs + C::kKFloats;  // [BQ][kPPitch]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const T* qb = q + in_off;
  const T* kb = k + in_off;
  const T* vb = v + in_off;

  load_tile<T, BQ, D, C::kDP, C::kPitch>(qs, qb, q0, t, in_st, tid);

  float acc[C::kRows][C::kCols], m[C::kRows], l[C::kRows];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += BK) {
    load_tile<T, BK, D, C::kDP, C::kPitch>(ks, kb, k0, t, in_st, tid);
    load_tile<T, BK, D, C::kDP, C::kPitch>(vs, vb, k0, t, in_st, tid);
    __syncthreads();

    float s[C::kRows][C::kKeys];
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < C::kDP; ++d) {
      float qv[C::kRows], kv[C::kKeys];
#pragma unroll
      for (int i = 0; i < C::kRows; ++i) qv[i] = qs[(ty + 16 * i) * C::kPitch + d];
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) kv[j] = ks[(tx + 16 * j) * C::kPitch + d];
#pragma unroll
      for (int i = 0; i < C::kRows; ++i)
#pragma unroll
        for (int j = 0; j < C::kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax in the log2 domain: exp(x*scale) == exp2(x*scale*log2e)
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) {
        s[i][j] = (k0 + tx + 16 * j < t) ? s[i][j] * scale_log2e : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new = fmaxf(m[i], mx);
      float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) {
        float p = exp2f(s[i][j] - m_new);
        l[i] += p;  // fp32 row sum of the unrounded weights
        s[i][j] = round_p<T>(p);
      }
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) acc[i][j] *= alpha;
    }
    if (C::kShareKP) __syncthreads();  // every thread is done reading K: reuse it for P
#pragma unroll
    for (int i = 0; i < C::kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kKeys; ++j) ps[(ty + 16 * i) * C::kPPitch + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[C::kRows], vv[C::kCols];
#pragma unroll
      for (int i = 0; i < C::kRows; ++i) pv[i] = ps[(ty + 16 * i) * C::kPPitch + kk];
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) vv[j] = vs[kk * C::kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < C::kRows; ++i)
#pragma unroll
        for (int j = 0; j < C::kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // P and V are read: the next tile may overwrite them
  }

  T* ob = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    int row = q0 + ty + 16 * i;
    if (row < t) {
      // Training: the row's log2-sum-exp2 of the scaled scores, [B, H, T],
      // from which the backward recomputes P = exp2(s * scale_log2e - lse).
      if (lse != nullptr && tx == 0)
        lse[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t + row] = m[i] + log2f(li);
#pragma unroll
      for (int j = 0; j < C::kCols; ++j) {
        int col = tx + 16 * j;
        if (col < D) ob[row * out_st + col] = from_f32<T>(acc[i][j] / li);
      }
    }
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int h,
                   int t, int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t out_sb,
                   int64_t out_st, int64_t out_sh, float scale_log2e, float* lse,
                   cudaStream_t stream) {
  constexpr int smem = Tiles<D, BQ, BK>::kSmemBytes;
  // Every width's tiles are above the 48 KB default; the attribute is per
  // device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BQ - 1) / BQ, h, b);
  attention_kernel<T, D, BQ, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale_log2e, lse);
  return cudaGetLastError();
}

template <int D, int BQ, int BK>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                         int b, int h, int t, int64_t in_sb, int64_t in_st, int64_t in_sh,
                         int64_t out_sb, int64_t out_st, int64_t out_sh, float scale_log2e,
                         float* lse, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D, BQ, BK>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb, out_st,
                                    out_sh, scale_log2e, lse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D, BQ, BK>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb,
                                            out_st, out_sh, scale_log2e, lse, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: the head width, one of 4, 8, 16,
// 32, 40, 64, 80, 160, 512. Strides are in elements, the head width's stride being 1.
// lse: null when serving; when training, an fp32 [B, H, T] buffer that takes
// each row's log2-sum-exp2 of the scaled scores for the backward kernels
// (csrc/attention_bwd.cu). Returns the launch's cudaError_t (0 on success);
// the caller raises on anything else.
extern "C" int dtts_attention(const void* q, const void* k, const void* v, void* o,
                              int dtype, int d, int b, int h, int t, int64_t in_sb,
                              int64_t in_st, int64_t in_sh, int64_t out_sb, int64_t out_st,
                              int64_t out_sh, float scale_log2e, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DTTS_ATTN(D, BQ, BK)                                                                 \
  case D:                                                                                    \
    return launch_dtype<D, BQ, BK>(dtype, q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb,  \
                                   out_st, out_sh, scale_log2e, lse, s);
  switch (d) {
    DTTS_ATTN(4, 64, 64)
    DTTS_ATTN(8, 64, 64)
    DTTS_ATTN(16, 64, 64)
    DTTS_ATTN(32, 64, 64)
    DTTS_ATTN(40, 64, 64)
    DTTS_ATTN(64, 64, 64)
    DTTS_ATTN(80, 64, 64)
    DTTS_ATTN(160, 64, 64)
    DTTS_ATTN(512, 32, 32)
  }
#undef DTTS_ATTN
  return static_cast<int>(cudaErrorInvalidValue);
}
