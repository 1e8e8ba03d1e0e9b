// Self-attention for Hopper (sm_90a), any supported head width, plain C
// interface, two routes.
//
// Replaces two TPU kernels of diffusion_tts_tpu/ops/pallas/attention.py:
//   * qkv_self_attention (_qkv_attn_kernel / _qkv_attn_pair_kernel), the
//     EDM UNets' all-heads attention on the [B, T, 3C] projection: d = 64
//     (the ADM), d = 256 (the CIFAR-10 DDPM++ SongUNet's single head);
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
// What bounds it on this card: operations. At the path's shapes attention
// does 4*T*d FLOPs per q row against 2*3*d input bytes, about T/1.5
// FLOP/byte in bf16, far above the H100's 295 FLOP/byte balance point.
//
// Routes. The caller picks one (ops/kernels/qkv_attention.py::forward_route)
// and this file obeys:
//   * mma (route 1): bf16 at d = 16, 32, 40, 64, 80, 160, 256, 512, every
//     main path's width. The products run on the tensor cores (mma.sync
//     m16n8k16, bf16 operands, fp32 accumulators: exactly the arithmetic of
//     the function above).
//   * fma (route 0): fp32 at every width, and bf16 at the test widths 4 and
//     8. The products run on the CUDA cores in fp32 FMA, so that fp32 holds
//     1e-4 against an fp32 reference with TF32 off (a TF32 product would
//     not). bf16 can be sent here too, which times the first design.
//
// The mma route, FlashAttention-2 style:
//   * One block per (batch, head, 64-row q tile); four warps each own 16 q
//     rows, so nothing is carried between blocks and B*H*T/64 blocks fill
//     the 132 SMs.
//   * K and V stream through a two-stage bf16 ring in shared memory, filled
//     with 16-byte cp.async copies while the previous tile is computed. Rows
//     past T are zero-filled by the copy; their scores are masked to -inf.
//   * S = Q.K^T on m16n8k16 into fp32 accumulator fragments. Q's fragments
//     are loaded once with ldmatrix and stay in registers up to d = 160.
//   * The online softmax runs on the accumulator fragments in registers:
//     exp2f with 1/sqrt(d)*log2(e) folded into the scores, row max and sum
//     over the quad of lanes that holds a row (two shuffles).
//   * P is rounded to bf16 in registers and is the A operand of P.V as it
//     stands (the m16n8 accumulator layout is the k16 A layout); V's B
//     fragments come from ldmatrix.trans. P never goes through shared memory.
//   * Head widths round up to a multiple of 16 with zero columns (40 -> 48),
//     written once; the copies never touch them. Row pitch = width + 8
//     elements, which makes every ldmatrix conflict-free.
//   * d = 512, the VAE's head: a 16 x 512 fp32 O accumulator is 256
//     registers a thread. Design (a) of the two considered: 8 warps, O's
//     columns split between two warp groups of 4 (256 columns, 128
//     registers each); each group computes the 64 rows' S itself instead of
//     receiving it through shared memory, 1.5x the operations and no
//     exchange or extra barrier (design (b), O's columns split over the grid
//     with S recomputed per 128-column block, costs 2.5x). Q stays in shared
//     memory there and its fragments are loaded per step; K/V tiles are 32
//     keys; 199,680 bytes of shared memory, one block per SM.
//   * d = 256, the DDPM++ net's single head: one warp's 16 x 256 fp32 O
//     accumulator would be 128 registers a thread before S (32), the row
//     state and the addresses, close to the 255 a thread may have. The
//     d = 512 split serves here too: two warp groups of 4, 128 O columns
//     (64 registers) each, 64-key K/V tiles, Q in shared memory; 168,960
//     bytes of shared memory, one block per SM. Its 8 warps also give the
//     SM twice the warps of the one-group form, which counts at the DDPM++
//     net's grids: [8, 256, 768] is 32 blocks of 64 rows for 132 SMs.
//
// The fma route:
//   * One block is one (batch, head, BQ-row q tile) of 256 threads as
//     16 x 16; each owns BQ/16 rows and BK/16 keys of S and BQ/16 rows and
//     DP/16 columns of O (rows ty + 16 i, columns tx + 16 j). The 16 threads
//     of one row live in one half-warp, so row max/sum reductions are 4
//     shuffles.
//   * K/V stream through shared memory in BK-key tiles (widened to fp32)
//     with the same online softmax; DP rounds the width up to 16 with zero
//     columns. Tiles per width keep the three fp32 tiles inside a block's
//     shared memory: 64 x 64 up to d = 160, 32 x 32 at d = 256 and 512. At
//     d = 256 64 x 64 tiles would fit (197 KB, one block per SM); 32 x 32
//     (99 KB) was taken for the grid: the DDPM++ net's [8, 256, 768] gives
//     64 blocks of 32 rows instead of 32 of 64, for 132 SMs. K and P share
//     one buffer where P fits into it; rows are padded by one float.
//
// Both routes:
//   * Explicit (batch, token, head) strides for q, k, v and o: the same
//     code serves the [B, T, 3C] qkv layout and a [B, T, H, D] layout. The
//     mma route needs every pointer and stride 16-byte aligned; the wrapper
//     refuses anything else.
//   * Training: the block holds each row's running maximum and sum, so on
//     request it writes the row's log2-sum-exp2 (fp32 [B, H, T]) for the
//     backward kernels (csrc/attention_bwd.cu), which then need no statistics
//     pass of their own (the TPU forward saves none, and its backward starts
//     with one more q.k^T pass). A null pointer, as in serving, writes nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------- mma route

using bf16 = __nv_bfloat16;

// Tile shapes of the mma route for head width D.
template <int D>
struct MmaTiles {
  static constexpr int kDS = (D + 15) / 16 * 16;     // S's depth: D padded with zero columns
  static constexpr int kGroups = kDS >= 256 ? 2 : 1;  // warp groups splitting O's columns
  static constexpr int kDV = kDS / kGroups;          // O columns per warp
  static constexpr int kBQ = 64;                     // q rows per block: 4 row warps x 16
  static constexpr int kBK = kDS > 256 ? 32 : 64;    // keys per K/V tile
  static constexpr int kStages = 2;                  // K/V ring depth
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kPitch = kDS + 8;              // shared-memory row, in elements
  static constexpr bool kQInRegs = kDS <= 160;        // Q's fragments held in registers
  static constexpr int kChunks = D / 8;               // 16-byte pieces of a row with data
  static constexpr int kRows = kBQ + 2 * kStages * kBK;  // Q, then the K ring, then the V ring
  static constexpr int kSmemBytes = kRows * kPitch * (int)sizeof(bf16);
  static_assert(D % 8 == 0, "the mma route copies rows in 16-byte pieces");
  static_assert(kSmemBytes <= 232448, "tiles exceed a block's shared memory");
};

// rows row0.. of a [T, D] slab (token stride stride_t) into a tile with
// MmaTiles<D>::kPitch; rows at or past t are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int row0, int t,
                                          int64_t stride_t, int tid) {
  using C = MmaTiles<D>;
  for (int e = tid; e < ROWS * C::kChunks; e += NT) {
    const int r = e / C::kChunks, ch = e % C::kChunks;
    const bool ok = row0 + r < t;
    dtts::cp_async16(dst + r * C::kPitch + ch * 8,
                     src + (ok ? (int64_t)(row0 + r) * stride_t + ch * 8 : 0), ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MmaTiles<D>::kThreads)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int t, int64_t in_sb,
                     int64_t in_st, int64_t in_sh, int64_t out_sb, int64_t out_st,
                     int64_t out_sh, float scale_log2e, float* __restrict__ lse) {
  using C = MmaTiles<D>;
  constexpr int NT = C::kThreads, P = C::kPitch, BK = C::kBK;
  constexpr int kSteps = C::kDS / 16;  // k16 steps of S = Q.K^T
  constexpr int kSB = BK / 8;          // n8 blocks of S
  constexpr int kOB = C::kDV / 8;      // n8 blocks of a warp's O
  extern __shared__ __align__(16) unsigned char attn_smem[];
  bf16* qs = reinterpret_cast<bf16*>(attn_smem);  // [kBQ][P]
  bf16* ks = qs + C::kBQ * P;                     // [kStages][BK][P]
  bf16* vs = ks + C::kStages * BK * P;            // [kStages][BK][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp & 3;   // the warp's 16 q rows: wr * 16 ...
  const int wc = warp >> 2;  // the warp's O columns: wc * kDV ...
  const int q0 = blockIdx.x * C::kBQ;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const bf16* qb = q + in_off;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;

  // The zero columns D..kDS of every row; the copies never write them.
  if constexpr (D < C::kDS) {
    constexpr int kPad = (C::kDS - D) / 8;
    for (int e = tid; e < C::kRows * kPad; e += NT) {
      const int r = e / kPad, c = D + 8 * (e % kPad);
      *reinterpret_cast<uint4*>(qs + r * P + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  copy_rows<D, C::kBQ, NT>(qs, qb, q0, t, in_st, tid);
  copy_rows<D, BK, NT>(ks, kb, 0, t, in_st, tid);
  copy_rows<D, BK, NT>(vs, vb, 0, t, in_st, tid);
  dtts::cp_async_commit();

  uint32_t qf[C::kQInRegs ? kSteps : 1][4];
  float acc[kOB][4];
#pragma unroll
  for (int j = 0; j < kOB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  const int ntiles = (t + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    // The next tile goes into the stage that the previous iteration finished
    // reading (the barrier at the end of the loop body).
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D, BK, NT>(ks + nx * BK * P, kb, (it + 1) * BK, t, in_st, tid);
      copy_rows<D, BK, NT>(vs + nx * BK * P, vb, (it + 1) * BK, t, in_st, tid);
    }
    dtts::cp_async_commit();
    dtts::cp_async_wait<1>();  // everything but the copies just issued has landed
    __syncthreads();
    const bf16* kt = ks + (it % C::kStages) * BK * P;
    const bf16* vt = vs + (it % C::kStages) * BK * P;
    if constexpr (C::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) dtts::load_a(qf[kk], qs, P, wr * 16, kk * 16, lane);
      }
    }

    // S = Q.K^T for the warp's 16 rows and the tile's BK keys.
    float s[kSB][4];
#pragma unroll
    for (int j = 0; j < kSB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQInRegs) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        dtts::load_a(a, qs, P, wr * 16, kk * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < kSB / 2; ++j) {
        uint32_t b[4];
        dtts::load_b2(b, kt, P, j * 16, kk * 16, lane);
        dtts::mma_bf16(s[2 * j], a, b[0], b[1]);
        dtts::mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    // Online softmax in the log2 domain: exp(x*scale) == exp2(x*scale*log2e).
    // Element e of block j is row g + 8 (e >> 1), key it*BK + 8 j + 2 tq + (e & 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = it * BK + 8 * j + 2 * tq + (e & 1);
        s[j][e] = key < t ? s[j][e] * scale_log2e : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kSB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;  // this lane's part of the fp32 row sum of the unrounded weights
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < kOB; ++j) {
      acc[j][0] *= alpha[0], acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1], acc[j][3] *= alpha[1];
    }

    // O += P.V: P rounded to bf16 in registers is the A operand as it stands.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = dtts::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = dtts::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = dtts::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = dtts::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kOB / 2; ++j) {
        uint32_t b[4];
        dtts::load_b2_trans(b, vt, P, kk * 16, wc * C::kDV + j * 16, lane);
        dtts::mma_bf16(acc[2 * j], a0, a1, a2, a3, b[0], b[1]);
        dtts::mma_bf16(acc[2 * j + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is read: the next iteration's copies may overwrite it
  }

  bf16* ob = o + blockIdx.z * out_sb + blockIdx.y * out_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wr * 16 + g + 8 * r;
    if (row >= t) continue;
    // Training: the row's log2-sum-exp2 of the scaled scores, [B, H, T],
    // from which the backward recomputes P = exp2(s * scale_log2e - lse).
    if (lse != nullptr && tq == 0 && wc == 0)
      lse[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t + row] = m[r] + log2f(l[r]);
#pragma unroll
    for (int j = 0; j < kOB; ++j) {
      const int col = wc * C::kDV + 8 * j + 2 * tq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * out_st + col) =
            __floats2bfloat162_rn(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int b, int h,
                       int t, int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t out_sb,
                       int64_t out_st, int64_t out_sh, float scale_log2e, float* lse,
                       cudaStream_t stream) {
  using C = MmaTiles<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t + C::kBQ - 1) / C::kBQ, h, b);
  attention_mma_kernel<D><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t, in_sb, in_st, in_sh, out_sb, out_st, out_sh, scale_log2e, lse);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: the head width, one of 4, 8, 16,
// 32, 40, 64, 80, 160, 256, 512. Strides are in elements, the head width's stride being 1.
// lse: null when serving; when training, an fp32 [B, H, T] buffer that takes
// each row's log2-sum-exp2 of the scaled scores for the backward kernels
// (csrc/attention_bwd.cu). route: 0 = fma (any dtype and width), 1 = mma
// (bfloat16 at d = 16, 32, 40, 64, 80, 160, 256, 512, every pointer and stride
// 16-byte aligned). Returns the launch's cudaError_t (0 on success); the
// caller raises on anything else.
extern "C" int dtts_attention(const void* q, const void* k, const void* v, void* o,
                              int dtype, int d, int b, int h, int t, int64_t in_sb,
                              int64_t in_st, int64_t in_sh, int64_t out_sb, int64_t out_st,
                              int64_t out_sh, float scale_log2e, float* lse, int route,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define DTTS_ATTN_MMA(D)                                                                    \
  case D:                                                                                   \
    return launch_mma<D>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb, out_st, out_sh, \
                         scale_log2e, lse, s);
    switch (d) {
      DTTS_ATTN_MMA(16)
      DTTS_ATTN_MMA(32)
      DTTS_ATTN_MMA(40)
      DTTS_ATTN_MMA(64)
      DTTS_ATTN_MMA(80)
      DTTS_ATTN_MMA(160)
      DTTS_ATTN_MMA(256)
      DTTS_ATTN_MMA(512)
    }
#undef DTTS_ATTN_MMA
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
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
    DTTS_ATTN(256, 32, 32)
    DTTS_ATTN(512, 32, 32)
  }
#undef DTTS_ATTN
  return static_cast<int>(cudaErrorInvalidValue);
}
