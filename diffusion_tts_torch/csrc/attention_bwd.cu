// Flash-attention backward for Hopper (sm_90a), plain C interface, two
// routes.
//
// Replaces the TPU backward of diffusion_tts_tpu/ops/pallas/attention.py::
// _flash_attention_vjp (_attn_stats_kernel, _attn_bwd_dq_kernel,
// _attn_bwd_dkv_kernel), which both the qkv and the [B, T, H, D] custom VJPs
// route to. Same function (attention.py::_attention_bwd_explicit): with
// S = q.k^T * scale and P = softmax(S) in fp32,
//   delta_i = sum_d g_i o_i            (fp32, computed by the caller)
//   dV = P^T . g                       (P cast to the input dtype)
//   dP = g . v^T
//   dS = P * (dP - delta)              (fp32, then cast to the input dtype)
//   dQ = dS . k * scale,   dK = dS^T . q * scale
// every product accumulated in fp32, the scale applied after accumulation,
// results cast to the input dtype.
//
// What bounds it on this card: operations. Any implementation runs five
// T x T x d products (S, dP, dV, dQ, dK), 10*B*H*T^2*d operations, against
// 8 [B, T, H, d] tensors of traffic; this file's two kernels recompute S and
// dP, so they run seven: 14*B*H*T^2*d. At the training path's [16, 1024,
// 6 heads, 64] that is 9.02e10 operations against 101 MB in bf16, about 900
// FLOP/byte, far above the H100's 295 FLOP/byte balance point; at T = 64 the
// work is small enough that the launch and the caller's row term dominate.
//
// Two kernels, each owning its results. dQ sums over key tiles and dK/dV sum
// over query tiles; one fused kernel would need fp32 atomics for one of them,
// and gradients would then differ from run to run (resuming a training run
// depends on bit-identical steps). So dq_*kernel, one block per (batch, head,
// 64-row q tile), streams K/V tiles, and dkv_*kernel, one block per (batch,
// head, 64-key tile), streams Q/g tiles; each recomputes S and dP. No
// atomics, a fixed reduction order: two runs are bit-identical. Nothing of
// the TPU design carries over: there a statistics kernel recomputes each
// row's log-sum-exp (one more q.k^T pass) because the TPU forward saves none.
// Here the forward kernel (csrc/qkv_attention.cu) writes the row statistic it
// already holds, as fp32 [B, H, T] in the log2 domain, and P is recomputed as
// exp2(s * scale * log2e - lse): no [T, T] tensor reaches device memory.
//
// Routes. The caller picks one (ops/kernels/qkv_attention.py::
// backward_route) and this file obeys:
//   * mma (route 1): bf16 at d = 16, 32, 40, 64, 80, every width up to 80
//     of the forward's mma route (the training path's d = 64 among them).
//     The products run on the tensor cores (mma.sync m16n8k16, bf16
//     operands, fp32 accumulators: exactly the arithmetic of the function
//     above).
//   * fma (route 0): fp32 at every width, and bf16 at d = 4, 8 and 160. The
//     products run on the CUDA cores in fp32 FMA, so that fp32 holds 1e-4
//     against an fp32 reference with TF32 off (a TF32 product would not).
//     bf16 can be sent here at any width, which times the first design. At
//     d = 160 the mma route's dK and dV accumulators alone would take 160
//     registers a thread.
//
// The mma route, on the fragment helpers of csrc/mma_bf16.cuh:
//   * 128 threads, four warps of 16 rows: in dq_mma_kernel 16 q rows each,
//     in dkv_mma_kernel 16 keys each. The block's resident pair (Q and g, or
//     K and V) is copied once and its A fragments are loaded once with
//     ldmatrix and stay in registers.
//   * The streamed pair (K and V, or Q and g) goes through a two-stage bf16
//     ring filled by 16-byte cp.async copies while the previous tile is
//     computed: one barrier to enter a tile, one to leave it. Rows past T
//     are zero-filled by the copy. dq: a key past T gets P = 0. dkv: each q
//     tile's 64 lse and delta values are staged in shared memory beside its
//     ring stage, and a q row past T gets lse = +inf, so its P and dS are 0.
//   * dq: S = Q.K^T and dP = g.V^T take B fragments from the [key][d] tiles
//     (load_b2); P and dS are formed on the accumulator fragments with the
//     row lse and delta each lane holds for its rows g and g + 8; dS rounded
//     to bf16 (pack_bf16x2) is the A operand of dQ += dS.K as it stands (the
//     m16n8 accumulator layout is the k16 A layout), and K's B fragments come
//     transposed (load_b2_trans).
//   * dkv: S^T = K.Q^T and dP^T = V.g^T come out in the [key][q] layout, so
//     P^T and dS^T are the A operands of dV += P^T.g and dK += dS^T.Q
//     without a transpose; g's and Q's B fragments come through
//     load_b2_trans from the [q][d] tiles. P and dS never touch shared
//     memory.
//   * Widths round up to a multiple of 16 with zero columns (40 -> 48),
//     written once; the copies never touch them. Row pitch = width + 8
//     elements, which makes every ldmatrix conflict-free. Every pointer and
//     stride must be 16-byte aligned; the wrapper refuses anything else.
//
// The fma route (the first design):
//   * 256 threads as 16 x 16: each thread owns 4 x 4 of the S / dP tile
//     (both products share one pass over d: four operand loads feed 32 FMAs)
//     and 4 x DP/16 of each result. Operands are widened to fp32 in shared
//     memory; dS (and P^T for dV) go through shared memory in the input
//     dtype's rounding; rows are padded by one float against bank conflicts.
//   * Head widths 4 ... 160 (the forward's, padded to 16 with zero columns);
//     at d = 512 four fp32 operand tiles exceed a block's shared memory, and
//     the wrapper raises.
//
// Both routes take explicit (batch, token, head) strides for q/k/v, for g and
// for the results: the qkv form reads q, k and v as the thirds of [B, T, 3C]
// and writes dq | dk | dv straight into the thirds of one [B, T, 3C]
// gradient, with no head-split copy and no concatenation.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // q rows and keys per tile
constexpr int kPer = kTile / 16;     // rows / keys per thread
constexpr int kSPitch = kTile + 1;   // dS / P smem row (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A value in the input dtype's rounding, for a product's operand.
template <typename T> __device__ __forceinline__ float round_to(float p) {
  return to_f32(from_f32<T>(p));
}

template <int D>
struct Shape {
  static constexpr int kDP = (D + 15) / 16 * 16;  // D padded with zero columns
  static constexpr int kCols = kDP / 16;          // result columns per thread
  static constexpr int kPitch = kDP + 1;          // operand smem row (floats)
  static constexpr int kOperand = kTile * kPitch; // floats of one operand tile
  static constexpr int kDqSmem = (4 * kOperand + kTile * kSPitch) * (int)sizeof(float);
  static constexpr int kDkvSmem =
      (4 * kOperand + 2 * kTile * kSPitch + 2 * kTile) * (int)sizeof(float);
  static_assert(kDkvSmem <= 232448, "tiles exceed a block's shared memory");
};

// Load one [kTile, DP] tile (rows row0.., clipped at t; columns past D are
// zero) into padded smem.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0, int t,
                                          int64_t stride_t, int tid) {
  constexpr int DP = Shape<D>::kDP;
  for (int e = tid; e < kTile * DP; e += kThreads) {
    int r = e / DP, c = e % DP;
    int row = row0 + r;
    dst[r * Shape<D>::kPitch + c] = (row < t && c < D) ? to_f32(base[row * stride_t + c]) : 0.f;
  }
}

// a[i][j] = sum_d x[ty + 16 i][d] * y[tx + 16 j][d] and the same for (u, w),
// in one pass over d.
template <int D>
__device__ __forceinline__ void two_products(const float* x, const float* y, const float* u,
                                             const float* w, int ty, int tx,
                                             float (&a)[kPer][kPer], float (&c)[kPer][kPer]) {
  using S = Shape<D>;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < S::kDP; ++d) {
    float xv[kPer], yv[kPer], uv[kPer], wv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      xv[i] = x[(ty + 16 * i) * S::kPitch + d];
      uv[i] = u[(ty + 16 * i) * S::kPitch + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      yv[j] = y[(tx + 16 * j) * S::kPitch + d];
      wv[j] = w[(tx + 16 * j) * S::kPitch + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
        c[i][j] = fmaf(uv[i], wv[j], c[i][j]);
      }
  }
}

// acc[i][j] += sum_r p[ty + 16 i][r] * x[r][tx + 16 j] over the tile's rows r.
template <int D>
__device__ __forceinline__ void accumulate(const float* p, const float* x, int ty, int tx,
                                           float (&acc)[kPer][Shape<D>::kCols]) {
  using S = Shape<D>;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float pv[kPer], xv[S::kCols];
#pragma unroll
    for (int i = 0; i < kPer; ++i) pv[i] = p[(ty + 16 * i) * kSPitch + r];
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) xv[j] = x[r * S::kPitch + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < S::kCols; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
  }
}

// Store acc * scale for rows row0 + ty + 16 i < t, columns tx + 16 j < D.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[kPer][Shape<D>::kCols],
                                           float scale, int row0, int t, int64_t stride_t,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int row = row0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < Shape<D>::kCols; ++j) {
      int col = tx + 16 * j;
      if (col < D) base[row * stride_t + col] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// dQ: one block per (batch, head, q tile); K/V tiles stream.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ g, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t,
          int64_t in_sb, int64_t in_st, int64_t in_sh,
          int64_t g_sb, int64_t g_st, int64_t g_sh,
          int64_t out_sb, int64_t out_st, int64_t out_sh,
          float scale_log2e, float scale) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* qs = smem;                 // [kTile][kPitch]
  float* gs = qs + S::kOperand;
  float* ks = gs + S::kOperand;
  float* vs = ks + S::kOperand;
  float* ds = vs + S::kOperand;     // [kTile][kSPitch]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;

  load_tile<T, D>(qs, q + in_off, q0, t, in_st, tid);
  load_tile<T, D>(gs, g + blockIdx.z * g_sb + blockIdx.y * g_sh, q0, t, g_st, tid);

  float row_lse[kPer], row_delta[kPer], acc[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int row = q0 + ty + 16 * i;
    row_lse[i] = row < t ? lse[stat_off + row] : 0.f;
    row_delta[i] = row < t ? delta[stat_off + row] : 0.f;
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kTile) {
    load_tile<T, D>(ks, k + in_off, k0, t, in_st, tid);
    load_tile<T, D>(vs, v + in_off, k0, t, in_st, tid);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    two_products<D>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float p = (k0 + tx + 16 * j < t) ? exp2f(s[i][j] * scale_log2e - row_lse[i]) : 0.f;
        ds[(ty + 16 * i) * kSPitch + tx + 16 * j] = round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    __syncthreads();
    accumulate<D>(ds, ks, ty, tx, acc);
    __syncthreads();  // dS, K and V are read: the next tile may overwrite them
  }
  store_rows<T, D>(dq + blockIdx.z * out_sb + blockIdx.y * out_sh, acc, scale, q0, t, out_st,
                   ty, tx);
}

// dK and dV: one block per (batch, head, key tile); Q/g tiles stream. The
// score tile is held transposed, [key][q], so that each thread's result rows
// are its keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ g, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int t,
           int64_t in_sb, int64_t in_st, int64_t in_sh,
           int64_t g_sb, int64_t g_st, int64_t g_sh,
           int64_t out_sb, int64_t out_st, int64_t out_sh,
           float scale_log2e, float scale) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][kPitch]
  float* vs = ks + S::kOperand;
  float* qs = vs + S::kOperand;
  float* gs = qs + S::kOperand;
  float* pt = gs + S::kOperand;     // [kTile][kSPitch]: P^T in the input dtype's rounding
  float* dst = pt + kTile * kSPitch;  // [kTile][kSPitch]: dS^T likewise
  float* lse_s = dst + kTile * kSPitch;  // [kTile]
  float* delta_s = lse_s + kTile;        // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t g_off = blockIdx.z * g_sb + blockIdx.y * g_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;

  load_tile<T, D>(ks, k + in_off, k0, t, in_st, tid);
  load_tile<T, D>(vs, v + in_off, k0, t, in_st, tid);

  float acc_k[kPer][S::kCols], acc_v[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < t; q0 += kTile) {
    load_tile<T, D>(qs, q + in_off, q0, t, in_st, tid);
    load_tile<T, D>(gs, g + g_off, q0, t, g_st, tid);
    if (tid < kTile) {
      // a q row past the end gets lse = +inf, so its P and dS are 0
      int row = q0 + tid;
      lse_s[tid] = row < t ? lse[stat_off + row] : INFINITY;
      delta_s[tid] = row < t ? delta[stat_off + row] : 0.f;
    }
    __syncthreads();

    float st[kPer][kPer], dpt[kPer][kPer];  // [key][q]
    two_products<D>(ks, qs, vs, gs, ty, tx, st, dpt);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int col = tx + 16 * j;
        float p = exp2f(st[i][j] * scale_log2e - lse_s[col]);
        pt[(ty + 16 * i) * kSPitch + col] = round_to<T>(p);
        dst[(ty + 16 * i) * kSPitch + col] = round_to<T>(p * (dpt[i][j] - delta_s[col]));
      }
    __syncthreads();
    accumulate<D>(pt, gs, ty, tx, acc_v);
    accumulate<D>(dst, qs, ty, tx, acc_k);
    __syncthreads();  // the tiles are read: the next q tile may overwrite them
  }
  const int64_t out_off = blockIdx.z * out_sb + blockIdx.y * out_sh;
  store_rows<T, D>(dk + out_off, acc_k, scale, k0, t, out_st, ty, tx);
  store_rows<T, D>(dv + out_off, acc_v, 1.f, k0, t, out_st, ty, tx);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int b,
                   int h, int t, const int64_t* in_s, const int64_t* g_s, const int64_t* out_s,
                   float scale_log2e, float scale, cudaStream_t stream) {
  using S = Shape<D>;
  // Both kernels' tiles are above the 48 KB default; the attribute is per
  // device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kDkvSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, h, b);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *gp = static_cast<const T*>(g);
  dq_kernel<T, D><<<grid, kThreads, S::kDqSmem, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), t, in_s[0], in_s[1], in_s[2], g_s[0],
      g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<T, D><<<grid, kThreads, S::kDkvSmem, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t, in_s[0], in_s[1],
      in_s[2], g_s[0], g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- mma route

using bf16 = __nv_bfloat16;

// Tile shapes of the mma route for head width D.
template <int D>
struct MmaShape {
  static constexpr int kDS = (D + 15) / 16 * 16;  // D padded with zero columns
  static constexpr int kSteps = kDS / 16;         // k16 steps over d
  static constexpr int kNB = kDS / 8;             // n8 blocks of a result row
  static constexpr int kThreads = 128;            // four warps of 16 rows
  static constexpr int kStages = 2;               // ring depth of the streamed pair
  static constexpr int kPitch = kDS + 8;          // shared-memory row, in elements
  static constexpr int kChunks = D / 8;           // 16-byte pieces of a row with data
  // the resident pair, then the streamed pair's two rings
  static constexpr int kRows = 2 * kTile + 2 * kStages * kTile;
  static constexpr int kTileBytes = kRows * kPitch * (int)sizeof(bf16);
  // dkv: lse and delta of each stage's 64 q rows, after the tiles
  static constexpr int kSmemBytes = kTileBytes + 2 * kStages * kTile * (int)sizeof(float);
  static_assert(D % 8 == 0, "the mma route copies rows in 16-byte pieces");
  static_assert(kSmemBytes <= 232448, "tiles exceed a block's shared memory");
};

// The zero columns D..kDS of every tile row; the copies never write them.
template <int D>
__device__ __forceinline__ void zero_pad(bf16* tiles, int tid) {
  using C = MmaShape<D>;
  if constexpr (D < C::kDS) {
    constexpr int kPad = (C::kDS - D) / 8;
    for (int e = tid; e < C::kRows * kPad; e += C::kThreads) {
      const int r = e / kPad, c = D + 8 * (e % kPad);
      *reinterpret_cast<uint4*>(tiles + r * C::kPitch + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Rows row0 .. row0 + kTile of a [T, D] slab (token stride stride_t) into a
// tile with MmaShape<D>::kPitch; rows at or past t are zero-filled.
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int row0, int t,
                                          int64_t stride_t, int tid) {
  using C = MmaShape<D>;
  for (int e = tid; e < kTile * C::kChunks; e += C::kThreads) {
    const int r = e / C::kChunks, ch = e % C::kChunks;
    const bool ok = row0 + r < t;
    dtts::cp_async16(dst + r * C::kPitch + ch * 8,
                     src + (ok ? (int64_t)(row0 + r) * stride_t + ch * 8 : 0), ok);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The A fragments of one k16 step over the tile's 64 columns (keys or q
// rows) from fp32 accumulator fragments, rounded to bf16: blocks 2 kk and
// 2 kk + 1 are columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[8][4], int kk) {
  a[0] = dtts::pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = dtts::pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = dtts::pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = dtts::pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// x = A.B^T and y = C.E^T for a warp's 16 rows and the tile's 64 columns:
// a and c are the rows' A fragments held in registers, b and e [64][d]
// tiles in shared memory.
template <int D>
__device__ __forceinline__ void two_products_mma(const uint32_t (&a)[MmaShape<D>::kSteps][4],
                                                 const bf16* b,
                                                 const uint32_t (&c)[MmaShape<D>::kSteps][4],
                                                 const bf16* e, int lane, float (&x)[8][4],
                                                 float (&y)[8][4]) {
  constexpr int P = MmaShape<D>::kPitch;
  zero(x);
  zero(y);
#pragma unroll
  for (int kk = 0; kk < MmaShape<D>::kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t f[4];
      dtts::load_b2(f, b, P, j * 16, kk * 16, lane);
      dtts::mma_bf16(x[2 * j], a[kk], f[0], f[1]);
      dtts::mma_bf16(x[2 * j + 1], a[kk], f[2], f[3]);
      dtts::load_b2(f, e, P, j * 16, kk * 16, lane);
      dtts::mma_bf16(y[2 * j], c[kk], f[0], f[1]);
      dtts::mma_bf16(y[2 * j + 1], c[kk], f[2], f[3]);
    }
}

// acc += A.X for one k16 step: A given as fragments, X rows k0 .. k0 + 15 of
// a [64][d] tile in shared memory, all kDS columns.
template <int D>
__device__ __forceinline__ void accumulate_mma(float (&acc)[MmaShape<D>::kNB][4],
                                               const uint32_t (&a)[4], const bf16* x, int k0,
                                               int lane) {
#pragma unroll
  for (int j = 0; j < MmaShape<D>::kNB / 2; ++j) {
    uint32_t f[4];
    dtts::load_b2_trans(f, x, MmaShape<D>::kPitch, k0, j * 16, lane);
    dtts::mma_bf16(acc[2 * j], a, f[0], f[1]);
    dtts::mma_bf16(acc[2 * j + 1], a, f[2], f[3]);
  }
}

// Store acc * scale for the warp's rows row0 + g and row0 + g + 8 below t,
// columns below D, as bf16 pairs.
template <int D>
__device__ __forceinline__ void store_mma(bf16* base, const float (&acc)[MmaShape<D>::kNB][4],
                                          float scale, int row0, int t, int64_t stride_t,
                                          int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < MmaShape<D>::kNB; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(base + row * stride_t + col) =
            __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

// dQ: one block per (batch, head, 64-row q tile); K/V tiles stream.
template <int D>
__global__ void __launch_bounds__(MmaShape<D>::kThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int t, int64_t in_sb, int64_t in_st, int64_t in_sh,
              int64_t g_sb, int64_t g_st, int64_t g_sh, int64_t out_sb, int64_t out_st,
              int64_t out_sh, float scale_log2e, float scale) {
  using C = MmaShape<D>;
  constexpr int P = C::kPitch;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bwd_smem);  // [kTile][P]
  bf16* gs = qs + kTile * P;                      // [kTile][P]
  bf16* ks = gs + kTile * P;                      // [kStages][kTile][P]
  bf16* vs = ks + C::kStages * kTile * P;         // [kStages][kTile][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;

  zero_pad<D>(qs, tid);
  copy_rows<D>(qs, q + in_off, q0, t, in_st, tid);
  copy_rows<D>(gs, g + blockIdx.z * g_sb + blockIdx.y * g_sh, q0, t, g_st, tid);
  copy_rows<D>(ks, kb, 0, t, in_st, tid);
  copy_rows<D>(vs, vb, 0, t, in_st, tid);
  dtts::cp_async_commit();

  // lse and delta of this lane's rows g and g + 8 (rows past t are never stored)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    row_lse[r] = row < t ? lse[stat_off + row] : 0.f;
    row_delta[r] = row < t ? delta[stat_off + row] : 0.f;
  }
  uint32_t qf[C::kSteps][4], gf[C::kSteps][4];
  float acc[C::kNB][4];
  zero(acc);

  const int ntiles = (t + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    // The next tile goes into the stage that the previous iteration finished
    // reading (the barrier at the end of the loop body).
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D>(ks + nx * kTile * P, kb, (it + 1) * kTile, t, in_st, tid);
      copy_rows<D>(vs + nx * kTile * P, vb, (it + 1) * kTile, t, in_st, tid);
    }
    dtts::cp_async_commit();
    dtts::cp_async_wait<1>();  // everything but the copies just issued has landed
    __syncthreads();
    const bf16* kt = ks + (it % C::kStages) * kTile * P;
    const bf16* vt = vs + (it % C::kStages) * kTile * P;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        dtts::load_a(qf[kk], qs, P, warp * 16, kk * 16, lane);
        dtts::load_a(gf[kk], gs, P, warp * 16, kk * 16, lane);
      }
    }

    float s[8][4], dp[8][4];  // S = Q.K^T, dP = g.V^T
    two_products_mma<D>(qf, kt, gf, vt, lane, s, dp);
    // Element e of block j is row g + 8 (e >> 1), key it*64 + 8 j + 2 tq + (e & 1).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = it * kTile + 8 * j + 2 * tq + (e & 1);
        const float p =
            key < t ? exp2f(s[j][e] * scale_log2e - row_lse[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[e >> 1]);  // dS, fp32
      }
    // dQ += dS.K: dS rounded to bf16 is the A operand as it stands.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(a, s, kk);
      accumulate_mma<D>(acc, a, kt, kk * 16, lane);
    }
    __syncthreads();  // this stage is read: the next iteration's copies may overwrite it
  }
  store_mma<D>(dq + blockIdx.z * out_sb + blockIdx.y * out_sh, acc, scale, q0 + warp * 16, t,
               out_st, lane);
}

// dK and dV: one block per (batch, head, 64-key tile); Q/g tiles stream. The
// products come out as [key][q], so that P^T and dS^T are A operands.
template <int D>
__global__ void __launch_bounds__(MmaShape<D>::kThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int64_t in_sb,
               int64_t in_st, int64_t in_sh, int64_t g_sb, int64_t g_st, int64_t g_sh,
               int64_t out_sb, int64_t out_st, int64_t out_sh, float scale_log2e,
               float scale) {
  using C = MmaShape<D>;
  constexpr int P = C::kPitch;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bwd_smem);  // [kTile][P]
  bf16* vs = ks + kTile * P;                      // [kTile][P]
  bf16* qs = vs + kTile * P;                      // [kStages][kTile][P]
  bf16* gs = qs + C::kStages * kTile * P;         // [kStages][kTile][P]
  float* lse_s = reinterpret_cast<float*>(bwd_smem + C::kTileBytes);  // [kStages][kTile]
  float* delta_s = lse_s + C::kStages * kTile;                         // [kStages][kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;
  const bf16* qb = q + in_off;
  const bf16* gb = g + blockIdx.z * g_sb + blockIdx.y * g_sh;
  // A q row past the end gets lse = +inf, so its P and dS are 0.
  auto stage_stats = [&](int stage, int row0) {
    if (tid < kTile) {
      const int row = row0 + tid;
      lse_s[stage * kTile + tid] = row < t ? lse[stat_off + row] : INFINITY;
      delta_s[stage * kTile + tid] = row < t ? delta[stat_off + row] : 0.f;
    }
  };

  zero_pad<D>(ks, tid);
  copy_rows<D>(ks, k + in_off, k0, t, in_st, tid);
  copy_rows<D>(vs, v + in_off, k0, t, in_st, tid);
  copy_rows<D>(qs, qb, 0, t, in_st, tid);
  copy_rows<D>(gs, gb, 0, t, g_st, tid);
  dtts::cp_async_commit();
  stage_stats(0, 0);

  uint32_t kf[C::kSteps][4], vf[C::kSteps][4];
  float acc_k[C::kNB][4], acc_v[C::kNB][4];
  zero(acc_k);
  zero(acc_v);

  const int ntiles = (t + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D>(qs + nx * kTile * P, qb, (it + 1) * kTile, t, in_st, tid);
      copy_rows<D>(gs + nx * kTile * P, gb, (it + 1) * kTile, t, g_st, tid);
      stage_stats(nx, (it + 1) * kTile);
    }
    dtts::cp_async_commit();
    dtts::cp_async_wait<1>();
    __syncthreads();
    const int cur = it % C::kStages;
    const bf16* qt = qs + cur * kTile * P;
    const bf16* gt = gs + cur * kTile * P;
    const float* ls = lse_s + cur * kTile;
    const float* ds = delta_s + cur * kTile;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        dtts::load_a(kf[kk], ks, P, warp * 16, kk * 16, lane);
        dtts::load_a(vf[kk], vs, P, warp * 16, kk * 16, lane);
      }
    }

    float st[8][4], dpt[8][4];  // S^T = K.Q^T, dP^T = V.g^T
    two_products_mma<D>(kf, qt, vf, gt, lane, st, dpt);
    // Element e of block j is key g + 8 (e >> 1), q row it*64 + 8 j + 2 tq + (e & 1).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        const float p = exp2f(st[j][e] * scale_log2e - ls[col]);
        st[j][e] = p;                            // P^T, fp32
        dpt[j][e] = p * (dpt[j][e] - ds[col]);   // dS^T, fp32
      }
    // dV += P^T.g and dK += dS^T.Q, both rounded to bf16 as A operands.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(a, st, kk);
      accumulate_mma<D>(acc_v, a, gt, kk * 16, lane);
      pack_a(a, dpt, kk);
      accumulate_mma<D>(acc_k, a, qt, kk * 16, lane);
    }
    __syncthreads();  // this stage is read: the next iteration may overwrite it
  }
  const int64_t out_off = blockIdx.z * out_sb + blockIdx.y * out_sh;
  store_mma<D>(dk + out_off, acc_k, scale, k0 + warp * 16, t, out_st, lane);
  store_mma<D>(dv + out_off, acc_v, 1.f, k0 + warp * 16, t, out_st, lane);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       int b, int h, int t, const int64_t* in_s, const int64_t* g_s,
                       const int64_t* out_s, float scale_log2e, float scale,
                       cudaStream_t stream) {
  using C = MmaShape<D>;
  // The attribute is per device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kTileBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, h, b);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(g);
  dq_mma_kernel<D><<<grid, C::kThreads, C::kTileBytes, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dq), t, in_s[0], in_s[1], in_s[2], g_s[0],
      g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_mma_kernel<D><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, in_s[0],
      in_s[1], in_s[2], g_s[0], g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: the head width, one of 4, 8, 16, 32,
// 40, 64, 80, 160. lse and delta are fp32 [B, H, T]: the forward kernel's row
// log2-sum-exp2 and sum_d g*o. Strides are in elements for (batch, token,
// head), the head width's stride being 1: one triple for q, k and v, one for
// g, one for dq, dk and dv. route: 0 = fma (any dtype and width), 1 = mma
// (bfloat16 at d = 16, 32, 40, 64, 80, every pointer and stride 16-byte
// aligned). Two launches (dQ, then dK/dV). Returns the first failing
// launch's cudaError_t (0 on success); the caller raises on anything else.
extern "C" int dtts_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const float* lse, const float* delta, void* dq, void* dk,
                                  void* dv, int dtype, int d, int b, int h, int t,
                                  int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t g_sb,
                                  int64_t g_st, int64_t g_sh, int64_t out_sb, int64_t out_st,
                                  int64_t out_sh, float scale_log2e, float scale, int route,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t in_s[3] = {in_sb, in_st, in_sh}, g_s[3] = {g_sb, g_st, g_sh},
                out_s[3] = {out_sb, out_st, out_sh};
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define DTTS_ATTN_BWD_MMA(D)                                                                \
  case D:                                                                                   \
    return launch_mma<D>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s, g_s, out_s,     \
                         scale_log2e, scale, s);
    switch (d) {
      DTTS_ATTN_BWD_MMA(16)
      DTTS_ATTN_BWD_MMA(32)
      DTTS_ATTN_BWD_MMA(40)
      DTTS_ATTN_BWD_MMA(64)
      DTTS_ATTN_BWD_MMA(80)
    }
#undef DTTS_ATTN_BWD_MMA
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
#define DTTS_ATTN_BWD(D)                                                                      \
  case D:                                                                                     \
    if (dtype == 0)                                                                           \
      return launch<float, D>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s, g_s, out_s,  \
                              scale_log2e, scale, s);                                         \
    if (dtype == 1)                                                                           \
      return launch<__nv_bfloat16, D>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s,      \
                                      g_s, out_s, scale_log2e, scale, s);                     \
    break;
  switch (d) {
    DTTS_ATTN_BWD(4)
    DTTS_ATTN_BWD(8)
    DTTS_ATTN_BWD(16)
    DTTS_ATTN_BWD(32)
    DTTS_ATTN_BWD(40)
    DTTS_ATTN_BWD(64)
    DTTS_ATTN_BWD(80)
    DTTS_ATTN_BWD(160)
  }
#undef DTTS_ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
