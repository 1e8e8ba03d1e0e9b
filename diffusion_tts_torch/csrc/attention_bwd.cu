// Flash-attention backward for Hopper (sm_90a), plain C interface, two
// routes.
//
// Replaces the TPU backward of diffusion_tts_tpu/ops/pallas/attention.py::
// _flash_attention_vjp (_attn_stats_kernel, _attn_bwd_dq_kernel,
// _attn_bwd_dkv_kernel), which both the qkv and the [B, T, H, D] custom VJPs
// route to. Same function (attention.py::_attention_bwd_explicit): with
// S = q.k^T * scale and P = softmax(S) in fp32,
//   delta_i = sum_d g_i o_i            (fp32: the caller's on routes 0 and 1,
//                                       the dQ kernel's on route 2)
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
// work is small enough that the launch, a block's fixed cost and (on the fma
// and mma routes) the caller's row term dominate.
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
//   * wgmma (route 2): bf16 at d = 64, 256, the ADM training path's and the
//     DDPM++ training path's widths. Hopper's warpgroup products (wgmma)
//     fed by TMA through mbarrier rings, and the row term delta computed in
//     the dQ kernel; see "The wgmma route" below.
//   * mma (route 1): bf16 at d = 16, 32, 40, 64, 80, 160, 256, every width
//     up to 256 of the forward's mma route; at 64 and 256 only when the
//     caller forces it (route="mma"), which times this design beside
//     wgmma. The products run on the tensor cores (mma.sync m16n8k16, bf16
//     operands, fp32 accumulators: exactly the arithmetic of the function
//     above). Up to d = 80 four warps hold a block's results (the narrow
//     form); at 160 and 256 eight warps split the results' columns (the
//     wide form).
//   * fma (route 0): fp32 at every width, and bf16 at the test widths 4 and
//     8. The products run on the CUDA cores in fp32 FMA, so that fp32 holds
//     1e-4 against an fp32 reference with TF32 off (a TF32 product would
//     not). bf16 can be sent here at any width, which times the first design.
//
// The mma route's narrow form (d <= 80), on the fragment helpers of
// csrc/mma_bf16.cuh:
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
// The mma route's wide form (d = 160 and 256: the DDPM++ net's one head, and
// the SD UNet's widest). In the narrow form each thread holds its rows' dK
// and dV accumulators, 2 d fp32 registers: 512 at d = 256, over the 255 a
// thread may have, and 320 at 160. The budget, for 64-row blocks:
//   * Registers. A block's 64 x 256 dK and dV are 32,768 fp32 values, 128 a
//     thread over 8 warps. So 256 threads, one block per SM: warp w owns
//     result rows 16 (w % 4) .. + 15 and half the columns, (w / 4) * d/2 ..:
//     2 x 64 accumulator registers a thread in dkv_wide_kernel, 64 in
//     dq_wide_kernel (2 x 40 and 40 at d = 160).
//   * P^T and dS^T (dkv), dS (dq): computed once a tile and shared through
//     shared memory. Each warp computes a 16 x 32 piece of the 64 x 64
//     tile (S^T = K.Q^T and dP^T = V.g^T over all of d: 2 x 16 accumulator
//     registers), rounds P and dS to bf16 and writes them to exchange tiles
//     (64 x 72 bf16, 9.2 KB each); after one barrier every warp reads its 16
//     rows' A fragments from them with ldmatrix, for its half of the result
//     columns. Design (b) of three:
//       (a) each warp group computes S^T and dP^T for its own rows, as the
//           forward's d = 256 route does with S: no exchange, but 1.5x the
//           products in dkv and 1.67x in dq;
//       (c) wgmma (m64nNk16, a 64-row result in one warp group's
//           registers), the only way to the full tensor-core rate: one warp
//           group cannot hold dK and dV at d = 256 either (2 x 128 registers
//           a thread), so two groups exchange P^T and dS^T as here. With the
//           mma.sync, the ldmatrix or the streamed copies stripped out
//           (tools/torch_attention_bwd_probe.py), this form loses only a
//           small part of its time each (PERF.md §6): what is left is the
//           latency of each warp's chain of loads and products, two warps to
//           an SM quarter, and the per-launch cost of loading the resident
//           pair, which wgmma's asynchronous products and a producer warp's
//           TMA copies hide. That is the wgmma route (below), which serves
//           d = 256 since it was built; this form stays for d = 160 and for
//           route="mma".
//   * The resident pair's A fragments are loaded per k16 step: held in
//     registers they would take 2 x 64 at d = 256.
//   * Shared memory, bf16 at a pitch of d + 8 (conflict-free ldmatrix; the
//     exchange tiles' pitch of 72 likewise): the resident pair 2 x 64 x 264
//     x 2 B = 67.6 KB, the two-stage ring of the streamed pair 135 KB, the
//     exchange tiles, dkv's lse and delta 1 KB: 212 KB (dq) and 222 KB (dkv)
//     of a block's 227 KB at d = 256, 138 KB and 148 KB at d = 160.
//   * The copies of tile i + 1 (16-byte cp.async) are issued right after the
//     barrier that opens tile i, which every warp passes only when it is
//     done with tile i - 1, and land while tile i is computed. Two barriers
//     a tile: open, and exchange.
//   * The grid. [32, 256, 768] gives 4 x 32 = 128 blocks of 64 rows a
//     kernel, one wave on 132 SMs. Where the 64-row blocks would fill no
//     more than half the SMs ([32, 64, 768]: 32 blocks), a block takes 32
//     rows (8 warps as 2 row pairs x 4 column quarters, exchange tiles of
//     32 x 64, 173 KB / 179 KB): twice the blocks, still one wave. At
//     d = 160 a quarter of the columns (40) is no multiple of the 16 that
//     one ldmatrix.x4 covers, so d = 160 keeps 64-row blocks.
//   * d is a multiple of 16 at both widths: no zero columns.
//
// The wgmma route (d = 64 and 256), on hopper.cuh's TMA, mbarrier and
// wgmma helpers, the forward's wgmma route (csrc/qkv_attention.cu) its
// pattern:
//   * The same two kernels and ownership as above (no atomics, bit-identical
//     runs). dq_wgmma_kernel: one warpgroup a block, 64 q rows;
//     dkv_wgmma_kernel: one warpgroup and 64 keys a block at d = 64, two
//     warpgroups sharing 64 keys at d = 256. One block a tile (not
//     persistent).
//   * Tensor maps (d, H, T, B) per operand, encoded on every call, with
//     boxes of 64 columns by 64 tokens of one head in the 128-byte swizzle;
//     tokens past T read as zero. The block loads its resident pair once and
//     streams the other pair through an S-stage ring with full / empty
//     mbarriers (S = 3 at d = 64, 2 at 256). It feeds the ring itself: warp 0
//     issues the first S loads, and while tile j's first products run it
//     loads tile j - 1 + S into the stage that every warp released at the
//     end of tile j - 1 (in dkv the 32 lanes of warp 0 also stage
//     the tile's 64 lse and delta values into shared memory and arrive on
//     the stage's full barrier). A producer warp of its own (the forward's
//     layout) cost a d = 64 block 32 threads and two thirds of the blocks an
//     SM holds, and in the wide dK/dV kernel a producer warpgroup and
//     setmaxnreg, under which ptxas kept the consumers at the launch's 168
//     registers, spilled and serialized every wgmma (PERF.md §6, PR 23).
//   * Products (m64nNk16, bf16 operands, fp32 accumulators), every one a
//     form the forward issues: S = Q.K^T and dP = g.V^T (dq), S^T = K.Q^T
//     and dP^T = V.g^T (dkv) with both operands in shared memory, K-major;
//     dQ += dS.K, dV += P^T.g and dK += dS^T.Q with the left operand in
//     registers (the accumulator layout is the A layout, as P is in the
//     forward's P.V) and the right one read MN-major from the same tile.
//     Inside a warpgroup nothing overlaps (products, wait, exponentials,
//     products); the blocks that share an SM hide each other's
//     exponentials. Two overlaps inside a warpgroup were tried (PERF.md §6,
//     PR 23): S^T and dP^T as two commit groups, P^T's exponentials under
//     dP^T, measured no faster; dq's dS.K product left in flight under the
//     next tile's S and dP made ptxas serialize every wgmma of the kernel (a
//     register fence on its accumulator sat inside the pipeline).
//   * delta = rowsum(g o) (fp32) is computed by the dQ kernel before its
//     loop, two threads a row, from g and o in global memory, and written
//     to an fp32 [B, H, T] buffer that the dK/dV launch, next on the
//     stream, reads: no PyTorch ops around the two launches.
//   * What bounds it: operations at [16, 1024, 1152] (14 B H T^2 d = 9.02e10
//     in the two kernels, 1536 q tiles); at T = 64 (one key tile) a block's
//     fixed cost, launch, first TMA loads and epilogue, about 5 us in the
//     forward (PERF.md §6, PR 22), and the bytes.
//   * Budget at d = 64: dq holds S, dP and dQ (3 x 32 fp32 a thread) and dS
//     in bf16 (16); dkv holds S^T, dP^T, dK, dV (4 x 32) and P^T, dS^T in
//     bf16 (2 x 16). 128-thread blocks with 16 KB of resident tiles (Q and
//     g, or K and V) and three 16 KB stages: three blocks to an SM (dkv's
//     168 registers and dq's shared memory; ptxas's numbers in PERF.md §6;
//     two stages in dq, four blocks to an SM, measured no faster).
//   * Budget at d = 256: dQ's 64 x 256 fp32 is 128 registers a thread
//     beside S and dP (2 x 32) and dS (16): one warpgroup of up to 255
//     registers. dK and dV are 2 x 128 for one warpgroup, over the 255
//     limit: two warpgroups split the result columns (128 each, 2 x 64
//     registers). Each computes S^T and dP^T for 32 of the tile's 64 q rows
//     (m64n32 products over all of d, 2 x 16 registers), rounds P^T and dS^T
//     to bf16 and writes them into two 8 KB exchange tiles in the 128-byte
//     swizzle; after a named barrier each reads the whole tiles as a
//     shared-memory A operand against its 128 columns of g and Q (MN-major B
//     at N = 128). Two barriers a tile: the exchange tiles free, then
//     written. Shared memory: dq 64 KB resident + 2 x 64 KB ring (198 KB),
//     dkv 64 KB resident + 128 KB ring + 16 KB of exchange (215 KB).
//   * Every pointer and stride must be 16-byte aligned (TMA's rule); the
//     wrapper refuses anything else before the launch, and a refused tensor
//     map returns kEncodeFailed + its CUresult.
//
// The fma route (the first design):
//   * 256 threads as 16 x 16 over 64 x 64 tiles: each thread owns 4 x 4 of
//     the S / dP tile (both products share one pass over d: four operand
//     loads feed 32 FMAs) and 4 x DP/16 of each result. Operands are widened
//     to fp32 in shared memory; dS (and P^T for dV) go through shared memory
//     in the input dtype's rounding; rows are padded by one float against
//     bank conflicts.
//   * Head widths 4 ... 256 (the forward's, padded to 16 with zero columns).
//     At d = 256 four fp32 operand tiles of 64 x 257 take 263 KB, over a
//     block's 227 KB, so the tiles there are 32 q rows by 32 keys (each
//     thread 2 x 2 of S / dP and 2 x 16 of each result; 137 KB for dQ,
//     140 KB for dK/dV). Of the two ways the design had (32-row tiles, or the
//     64-row tiles with d streamed in halves, which would read every operand
//     tile twice and hold half-sums of S and dP between the halves), the
//     32-row tiles keep the kernels' code one for every width and give the
//     training path's small grids (T = 64 or 256, one head) twice the
//     blocks. At d = 512 even those tiles exceed a block's shared memory,
//     and the wrapper raises.
//
// Both routes take explicit (batch, token, head) strides for q/k/v, for g and
// for the results: the qkv form reads q, k and v as the thirds of [B, T, 3C]
// and writes dq | dk | dv straight into the thirds of one [B, T, 3C]
// gradient, with no head-split copy and no concatenation.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMmaTile = 64;  // the mma route's q rows and keys per tile

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

// The fma route's tiles for head width D: 64 q rows and keys up to d = 160;
// 32 at d = 256, where four fp32 operand tiles of 64 x 257 (263 KB) would not
// fit a block's shared memory.
template <int D>
struct Shape {
  static constexpr int kTile = D > 160 ? 32 : 64;  // q rows and keys per tile
  static constexpr int kPer = kTile / 16;          // rows / keys per thread
  static constexpr int kSPitch = kTile + 1;        // dS / P smem row (floats)
  static constexpr int kDP = (D + 15) / 16 * 16;   // D padded with zero columns
  static constexpr int kCols = kDP / 16;           // result columns per thread
  static constexpr int kPitch = kDP + 1;           // operand smem row (floats)
  static constexpr int kOperand = kTile * kPitch;  // floats of one operand tile
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
  using S = Shape<D>;
  constexpr int DP = S::kDP;
  for (int e = tid; e < S::kTile * DP; e += kThreads) {
    int r = e / DP, c = e % DP;
    int row = row0 + r;
    dst[r * S::kPitch + c] = (row < t && c < D) ? to_f32(base[row * stride_t + c]) : 0.f;
  }
}

// a[i][j] = sum_d x[ty + 16 i][d] * y[tx + 16 j][d] and the same for (u, w),
// in one pass over d.
template <int D>
__device__ __forceinline__ void two_products(const float* x, const float* y, const float* u,
                                             const float* w, int ty, int tx,
                                             float (&a)[Shape<D>::kPer][Shape<D>::kPer],
                                             float (&c)[Shape<D>::kPer][Shape<D>::kPer]) {
  using S = Shape<D>;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i)
#pragma unroll
    for (int j = 0; j < S::kPer; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < S::kDP; ++d) {
    float xv[S::kPer], yv[S::kPer], uv[S::kPer], wv[S::kPer];
#pragma unroll
    for (int i = 0; i < S::kPer; ++i) {
      xv[i] = x[(ty + 16 * i) * S::kPitch + d];
      uv[i] = u[(ty + 16 * i) * S::kPitch + d];
    }
#pragma unroll
    for (int j = 0; j < S::kPer; ++j) {
      yv[j] = y[(tx + 16 * j) * S::kPitch + d];
      wv[j] = w[(tx + 16 * j) * S::kPitch + d];
    }
#pragma unroll
    for (int i = 0; i < S::kPer; ++i)
#pragma unroll
      for (int j = 0; j < S::kPer; ++j) {
        a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
        c[i][j] = fmaf(uv[i], wv[j], c[i][j]);
      }
  }
}

// acc[i][j] += sum_r p[ty + 16 i][r] * x[r][tx + 16 j] over the tile's rows r.
template <int D>
__device__ __forceinline__ void accumulate(const float* p, const float* x, int ty, int tx,
                                           float (&acc)[Shape<D>::kPer][Shape<D>::kCols]) {
  using S = Shape<D>;
#pragma unroll 8
  for (int r = 0; r < S::kTile; ++r) {
    float pv[S::kPer], xv[S::kCols];
#pragma unroll
    for (int i = 0; i < S::kPer; ++i) pv[i] = p[(ty + 16 * i) * S::kSPitch + r];
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) xv[j] = x[r * S::kPitch + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < S::kPer; ++i)
#pragma unroll
      for (int j = 0; j < S::kCols; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
  }
}

// Store acc * scale for rows row0 + ty + 16 i < t, columns tx + 16 j < D.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base,
                                           const float (&acc)[Shape<D>::kPer][Shape<D>::kCols],
                                           float scale, int row0, int t, int64_t stride_t,
                                           int ty, int tx) {
  using S = Shape<D>;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    int row = row0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) {
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
  const int q0 = blockIdx.x * S::kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;

  load_tile<T, D>(qs, q + in_off, q0, t, in_st, tid);
  load_tile<T, D>(gs, g + blockIdx.z * g_sb + blockIdx.y * g_sh, q0, t, g_st, tid);

  float row_lse[S::kPer], row_delta[S::kPer], acc[S::kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    int row = q0 + ty + 16 * i;
    row_lse[i] = row < t ? lse[stat_off + row] : 0.f;
    row_delta[i] = row < t ? delta[stat_off + row] : 0.f;
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += S::kTile) {
    load_tile<T, D>(ks, k + in_off, k0, t, in_st, tid);
    load_tile<T, D>(vs, v + in_off, k0, t, in_st, tid);
    __syncthreads();

    float s[S::kPer][S::kPer], dp[S::kPer][S::kPer];
    two_products<D>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < S::kPer; ++i)
#pragma unroll
      for (int j = 0; j < S::kPer; ++j) {
        float p = (k0 + tx + 16 * j < t) ? exp2f(s[i][j] * scale_log2e - row_lse[i]) : 0.f;
        ds[(ty + 16 * i) * S::kSPitch + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
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
  float* dst = pt + S::kTile * S::kSPitch;     // [kTile][kSPitch]: dS^T likewise
  float* lse_s = dst + S::kTile * S::kSPitch;  // [kTile]
  float* delta_s = lse_s + S::kTile;           // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * S::kTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t g_off = blockIdx.z * g_sb + blockIdx.y * g_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;

  load_tile<T, D>(ks, k + in_off, k0, t, in_st, tid);
  load_tile<T, D>(vs, v + in_off, k0, t, in_st, tid);

  float acc_k[S::kPer][S::kCols], acc_v[S::kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < S::kPer; ++i)
#pragma unroll
    for (int j = 0; j < S::kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < t; q0 += S::kTile) {
    load_tile<T, D>(qs, q + in_off, q0, t, in_st, tid);
    load_tile<T, D>(gs, g + g_off, q0, t, g_st, tid);
    if (tid < S::kTile) {
      // a q row past the end gets lse = +inf, so its P and dS are 0
      int row = q0 + tid;
      lse_s[tid] = row < t ? lse[stat_off + row] : INFINITY;
      delta_s[tid] = row < t ? delta[stat_off + row] : 0.f;
    }
    __syncthreads();

    float st[S::kPer][S::kPer], dpt[S::kPer][S::kPer];  // [key][q]
    two_products<D>(ks, qs, vs, gs, ty, tx, st, dpt);
#pragma unroll
    for (int i = 0; i < S::kPer; ++i)
#pragma unroll
      for (int j = 0; j < S::kPer; ++j) {
        int col = tx + 16 * j;
        float p = exp2f(st[i][j] * scale_log2e - lse_s[col]);
        pt[(ty + 16 * i) * S::kSPitch + col] = round_to<T>(p);
        dst[(ty + 16 * i) * S::kSPitch + col] = round_to<T>(p * (dpt[i][j] - delta_s[col]));
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
  dim3 grid((t + S::kTile - 1) / S::kTile, h, b);
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
  static constexpr int kRows = 2 * kMmaTile + 2 * kStages * kMmaTile;
  static constexpr int kTileBytes = kRows * kPitch * (int)sizeof(bf16);
  // dkv: lse and delta of each stage's 64 q rows, after the tiles
  static constexpr int kSmemBytes = kTileBytes + 2 * kStages * kMmaTile * (int)sizeof(float);
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

// Rows row0 .. row0 + ROWS of a [T, D] slab (token stride stride_t) into a
// tile with a row pitch of D rounded up to 16, plus 8, by NT threads; rows at
// or past t are zero-filled.
template <int D, int ROWS = kMmaTile, int NT = MmaShape<D>::kThreads>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int row0, int t,
                                          int64_t stride_t, int tid) {
  constexpr int kChunks = D / 8, kPitch = (D + 15) / 16 * 16 + 8;
  for (int e = tid; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, ch = e % kChunks;
    const bool ok = row0 + r < t;
    dtts::cp_async16(dst + r * kPitch + ch * 8,
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
// a [rows][d] tile in shared memory (row pitch `pitch`), NB n8 blocks of
// columns from c0.
template <int NB>
__device__ __forceinline__ void accumulate_mma(float (&acc)[NB][4], const uint32_t (&a)[4],
                                               const bf16* x, int pitch, int k0, int c0,
                                               int lane) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    uint32_t f[4];
    dtts::load_b2_trans(f, x, pitch, k0, c0 + j * 16, lane);
    dtts::mma_bf16(acc[2 * j], a, f[0], f[1]);
    dtts::mma_bf16(acc[2 * j + 1], a, f[2], f[3]);
  }
}

// Store acc * scale for the warp's rows row0 + g and row0 + g + 8 below t,
// columns col0 + 8 j + ... below D, as bf16 pairs.
template <int D, int NB>
__device__ __forceinline__ void store_mma(bf16* base, const float (&acc)[NB][4], float scale,
                                          int row0, int col0, int t, int64_t stride_t,
                                          int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = col0 + 8 * j + 2 * tq;
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
  bf16* qs = reinterpret_cast<bf16*>(bwd_smem);  // [kMmaTile][P]
  bf16* gs = qs + kMmaTile * P;                      // [kMmaTile][P]
  bf16* ks = gs + kMmaTile * P;                      // [kStages][kMmaTile][P]
  bf16* vs = ks + C::kStages * kMmaTile * P;         // [kStages][kMmaTile][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kMmaTile;
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

  const int ntiles = (t + kMmaTile - 1) / kMmaTile;
  for (int it = 0; it < ntiles; ++it) {
    // The next tile goes into the stage that the previous iteration finished
    // reading (the barrier at the end of the loop body).
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D>(ks + nx * kMmaTile * P, kb, (it + 1) * kMmaTile, t, in_st, tid);
      copy_rows<D>(vs + nx * kMmaTile * P, vb, (it + 1) * kMmaTile, t, in_st, tid);
    }
    dtts::cp_async_commit();
    dtts::cp_async_wait<1>();  // everything but the copies just issued has landed
    __syncthreads();
    const bf16* kt = ks + (it % C::kStages) * kMmaTile * P;
    const bf16* vt = vs + (it % C::kStages) * kMmaTile * P;
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
        const int key = it * kMmaTile + 8 * j + 2 * tq + (e & 1);
        const float p =
            key < t ? exp2f(s[j][e] * scale_log2e - row_lse[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[e >> 1]);  // dS, fp32
      }
    // dQ += dS.K: dS rounded to bf16 is the A operand as it stands.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(a, s, kk);
      accumulate_mma(acc, a, kt, P, kk * 16, 0, lane);
    }
    __syncthreads();  // this stage is read: the next iteration's copies may overwrite it
  }
  store_mma<D>(dq + blockIdx.z * out_sb + blockIdx.y * out_sh, acc, scale, q0 + warp * 16, 0,
               t, out_st, lane);
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
  bf16* ks = reinterpret_cast<bf16*>(bwd_smem);  // [kMmaTile][P]
  bf16* vs = ks + kMmaTile * P;                      // [kMmaTile][P]
  bf16* qs = vs + kMmaTile * P;                      // [kStages][kMmaTile][P]
  bf16* gs = qs + C::kStages * kMmaTile * P;         // [kStages][kMmaTile][P]
  float* lse_s = reinterpret_cast<float*>(bwd_smem + C::kTileBytes);  // [kStages][kMmaTile]
  float* delta_s = lse_s + C::kStages * kMmaTile;                         // [kStages][kMmaTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3;
  const int k0 = blockIdx.x * kMmaTile;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;
  const bf16* qb = q + in_off;
  const bf16* gb = g + blockIdx.z * g_sb + blockIdx.y * g_sh;
  // A q row past the end gets lse = +inf, so its P and dS are 0.
  auto stage_stats = [&](int stage, int row0) {
    if (tid < kMmaTile) {
      const int row = row0 + tid;
      lse_s[stage * kMmaTile + tid] = row < t ? lse[stat_off + row] : INFINITY;
      delta_s[stage * kMmaTile + tid] = row < t ? delta[stat_off + row] : 0.f;
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

  const int ntiles = (t + kMmaTile - 1) / kMmaTile;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D>(qs + nx * kMmaTile * P, qb, (it + 1) * kMmaTile, t, in_st, tid);
      copy_rows<D>(gs + nx * kMmaTile * P, gb, (it + 1) * kMmaTile, t, g_st, tid);
      stage_stats(nx, (it + 1) * kMmaTile);
    }
    dtts::cp_async_commit();
    dtts::cp_async_wait<1>();
    __syncthreads();
    const int cur = it % C::kStages;
    const bf16* qt = qs + cur * kMmaTile * P;
    const bf16* gt = gs + cur * kMmaTile * P;
    const float* ls = lse_s + cur * kMmaTile;
    const float* ds = delta_s + cur * kMmaTile;
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
      accumulate_mma(acc_v, a, gt, P, kk * 16, 0, lane);
      pack_a(a, dpt, kk);
      accumulate_mma(acc_k, a, qt, P, kk * 16, 0, lane);
    }
    __syncthreads();  // this stage is read: the next iteration may overwrite it
  }
  const int64_t out_off = blockIdx.z * out_sb + blockIdx.y * out_sh;
  store_mma<D>(dk + out_off, acc_k, scale, k0 + warp * 16, 0, t, out_st, lane);
  store_mma<D>(dv + out_off, acc_v, 1.f, k0 + warp * 16, 0, t, out_st, lane);
}

template <int D>
cudaError_t launch_narrow(const void* q, const void* k, const void* v, const void* g,
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
  dim3 grid((t + kMmaTile - 1) / kMmaTile, h, b);
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

// ------------------------------------------------- mma route, the wide form

// Tile shapes of the wide form for head width D and BM resident rows a block
// (64, or 32 where the grid is small): 8 warps as kRG row groups of 16 by kCG
// column groups; BN streamed rows a tile.
template <int D, int BM>
struct WideShape {
  static constexpr int kThreads = 256;
  static constexpr int kBN = 64;                // streamed rows a tile
  static constexpr int kStages = 2;             // ring depth of the streamed pair
  static constexpr int kRG = BM / 16;           // warps along the result rows
  static constexpr int kCG = 8 / kRG;           // warps along the result columns
  static constexpr int kSteps = D / 16;         // k16 steps over d
  static constexpr int kSCols = kBN / kCG;      // streamed rows of a warp's S piece
  static constexpr int kSB = kSCols / 8;        // its n8 blocks
  static constexpr int kDV = D / kCG;           // result columns of a warp
  static constexpr int kNB = kDV / 8;           // their n8 blocks
  static constexpr int kPitch = D + 8;          // operand tile row, in elements
  static constexpr int kXPitch = kBN + 8;       // exchange tile row, in elements
  static constexpr int kTileBytes = (2 * BM + 2 * kStages * kBN) * kPitch * (int)sizeof(bf16);
  static constexpr int kXBytes = BM * kXPitch * (int)sizeof(bf16);  // one exchange tile
  static constexpr int kDqSmem = kTileBytes + kXBytes;
  // dkv: two exchange tiles (P^T, dS^T), then each stage's lse and delta
  static constexpr int kDkvSmem =
      kTileBytes + 2 * kXBytes + 2 * kStages * kBN * (int)sizeof(float);
  // whether the shape's warps cover the tiles in whole ldmatrix.x4 pieces
  static constexpr bool kFits = D % 16 == 0 && kDV % 16 == 0 && kSCols % 16 == 0 &&
                                kRG * kCG == 8 && kDkvSmem <= 232448;
};

// x += A.B^T and y += C.E^T for a warp's 16 rows (rows r0.. of the resident
// [BM][D] tiles a and c) and its kSCols streamed rows (rows n0.. of the
// [kBN][D] tiles b and e), over all of d; every fragment from shared memory.
template <int D, int BM>
__device__ __forceinline__ void two_products_wide(const bf16* a, const bf16* b, const bf16* c,
                                                  const bf16* e, int r0, int n0, int lane,
                                                  float (&x)[WideShape<D, BM>::kSB][4],
                                                  float (&y)[WideShape<D, BM>::kSB][4]) {
  using C = WideShape<D, BM>;
  constexpr int P = C::kPitch;
  zero(x);
  zero(y);
  // two k16 steps at a time: unrolled whole, dkv_wide_kernel spills at d = 256
#pragma unroll 2
  for (int kk = 0; kk < C::kSteps; ++kk) {
    uint32_t fa[4], fc[4];
    dtts::load_a(fa, a, P, r0, kk * 16, lane);
    dtts::load_a(fc, c, P, r0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < C::kSB / 2; ++j) {
      uint32_t f[4];
      dtts::load_b2(f, b, P, n0 + j * 16, kk * 16, lane);
      dtts::mma_bf16(x[2 * j], fa, f[0], f[1]);
      dtts::mma_bf16(x[2 * j + 1], fa, f[2], f[3]);
      dtts::load_b2(f, e, P, n0 + j * 16, kk * 16, lane);
      dtts::mma_bf16(y[2 * j], fc, f[0], f[1]);
      dtts::mma_bf16(y[2 * j + 1], fc, f[2], f[3]);
    }
  }
}

// acc += X[r0.., :].Y[:, c0..] over the tile's kBN streamed rows: X an
// exchange tile [BM][kXPitch], Y a streamed [kBN][D] tile.
template <int D, int BM>
__device__ __forceinline__ void accumulate_wide(float (&acc)[WideShape<D, BM>::kNB][4],
                                                const bf16* x, const bf16* y, int r0, int c0,
                                                int lane) {
  using C = WideShape<D, BM>;
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    uint32_t a[4];
    dtts::load_a(a, x, C::kXPitch, r0, kk * 16, lane);
    accumulate_mma(acc, a, y, C::kPitch, kk * 16, c0, lane);
  }
}

// dQ: one block per (batch, head, BM-row q tile); K/V tiles stream. Each tile:
// S = Q.K^T and dP = g.V^T, a 16 x kSCols piece a warp; dS in bf16 to the
// exchange tile; then dQ += dS.K for the warp's rows and columns.
template <int D, int BM>
__global__ void __launch_bounds__(WideShape<D, BM>::kThreads, 1)
dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, int t, int64_t in_sb, int64_t in_st, int64_t in_sh,
               int64_t g_sb, int64_t g_st, int64_t g_sh, int64_t out_sb, int64_t out_st,
               int64_t out_sh, float scale_log2e, float scale) {
  using C = WideShape<D, BM>;
  constexpr int P = C::kPitch, BN = C::kBN, NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bwd_smem);  // [BM][P]
  bf16* gs = qs + BM * P;                        // [BM][P]
  bf16* ks = gs + BM * P;                        // [kStages][BN][P]
  bf16* vs = ks + C::kStages * BN * P;           // [kStages][BN][P]
  bf16* xs = vs + C::kStages * BN * P;           // [BM][kXPitch]: dS in bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp % C::kRG, wc = warp / C::kRG;
  const int q0 = blockIdx.x * BM;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;

  copy_rows<D, BM, NT>(qs, q + in_off, q0, t, in_st, tid);
  copy_rows<D, BM, NT>(gs, g + blockIdx.z * g_sb + blockIdx.y * g_sh, q0, t, g_st, tid);
  copy_rows<D, BN, NT>(ks, kb, 0, t, in_st, tid);
  copy_rows<D, BN, NT>(vs, vb, 0, t, in_st, tid);
  dtts::cp_async_commit();

  // lse and delta of this lane's rows g and g + 8 (rows past t are never stored)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr * 16 + gr + 8 * r;
    row_lse[r] = row < t ? lse[stat_off + row] : 0.f;
    row_delta[r] = row < t ? delta[stat_off + row] : 0.f;
  }
  float acc[C::kNB][4];
  zero(acc);

  const int ntiles = (t + BN - 1) / BN;
  for (int it = 0; it < ntiles; ++it) {
    dtts::cp_async_wait<0>();
    // Tile it has landed, and every warp is done with tile it - 1: its stage
    // and the exchange tile may be overwritten.
    __syncthreads();
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D, BN, NT>(ks + nx * BN * P, kb, (it + 1) * BN, t, in_st, tid);
      copy_rows<D, BN, NT>(vs + nx * BN * P, vb, (it + 1) * BN, t, in_st, tid);
      dtts::cp_async_commit();
    }
    const bf16* kt = ks + (it % C::kStages) * BN * P;
    const bf16* vt = vs + (it % C::kStages) * BN * P;

    float s[C::kSB][4], dp[C::kSB][4];  // S = Q.K^T, dP = g.V^T
    two_products_wide<D, BM>(qs, kt, gs, vt, wr * 16, wc * C::kSCols, lane, s, dp);
    // Element e of block j is row g + 8 (e >> 1), key it*BN + col + (e & 1).
#pragma unroll
    for (int j = 0; j < C::kSB; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = wc * C::kSCols + 8 * j + 2 * tq, key = it * BN + col;
        const float p0 = key < t ? exp2f(s[j][2 * r] * scale_log2e - row_lse[r]) : 0.f;
        const float p1 = key + 1 < t ? exp2f(s[j][2 * r + 1] * scale_log2e - row_lse[r]) : 0.f;
        *reinterpret_cast<uint32_t*>(xs + (wr * 16 + gr + 8 * r) * C::kXPitch + col) =
            dtts::pack_bf16x2(p0 * (dp[j][2 * r] - row_delta[r]),
                              p1 * (dp[j][2 * r + 1] - row_delta[r]));
      }
    __syncthreads();  // the tile's dS is whole
    accumulate_wide<D, BM>(acc, xs, kt, wr * 16, wc * C::kDV, lane);  // dQ += dS.K
  }
  store_mma<D>(dq + blockIdx.z * out_sb + blockIdx.y * out_sh, acc, scale, q0 + wr * 16,
               wc * C::kDV, t, out_st, lane);
}

// dK and dV: one block per (batch, head, BM-key tile); Q/g tiles stream. Each
// tile: S^T = K.Q^T and dP^T = V.g^T, a 16 x kSCols piece a warp; P^T and dS^T
// in bf16 to the exchange tiles; then dV += P^T.g and dK += dS^T.Q for the
// warp's rows and columns.
template <int D, int BM>
__global__ void __launch_bounds__(WideShape<D, BM>::kThreads, 1)
dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int64_t in_sb,
                int64_t in_st, int64_t in_sh, int64_t g_sb, int64_t g_st, int64_t g_sh,
                int64_t out_sb, int64_t out_st, int64_t out_sh, float scale_log2e,
                float scale) {
  using C = WideShape<D, BM>;
  constexpr int P = C::kPitch, BN = C::kBN, NT = C::kThreads, XP = C::kXPitch;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bwd_smem);  // [BM][P]
  bf16* vs = ks + BM * P;                        // [BM][P]
  bf16* qs = vs + BM * P;                        // [kStages][BN][P]
  bf16* gs = qs + C::kStages * BN * P;           // [kStages][BN][P]
  bf16* pt = gs + C::kStages * BN * P;           // [BM][XP]: P^T in bf16
  bf16* dst = pt + BM * XP;                      // [BM][XP]: dS^T in bf16
  float* lse_s = reinterpret_cast<float*>(dst + BM * XP);  // [kStages][BN]
  float* delta_s = lse_s + C::kStages * BN;                // [kStages][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp % C::kRG, wc = warp / C::kRG;
  const int k0 = blockIdx.x * BM;
  const int64_t in_off = blockIdx.z * in_sb + blockIdx.y * in_sh;
  const int64_t stat_off = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * t;
  const bf16* qb = q + in_off;
  const bf16* gb = g + blockIdx.z * g_sb + blockIdx.y * g_sh;
  // A q row past the end gets lse = +inf, so its P and dS are 0.
  auto stage_stats = [&](int stage, int row0) {
    if (tid < BN) {
      const int row = row0 + tid;
      lse_s[stage * BN + tid] = row < t ? lse[stat_off + row] : INFINITY;
      delta_s[stage * BN + tid] = row < t ? delta[stat_off + row] : 0.f;
    }
  };

  copy_rows<D, BM, NT>(ks, k + in_off, k0, t, in_st, tid);
  copy_rows<D, BM, NT>(vs, v + in_off, k0, t, in_st, tid);
  copy_rows<D, BN, NT>(qs, qb, 0, t, in_st, tid);
  copy_rows<D, BN, NT>(gs, gb, 0, t, g_st, tid);
  dtts::cp_async_commit();
  stage_stats(0, 0);

  float acc_k[C::kNB][4], acc_v[C::kNB][4];
  zero(acc_k);
  zero(acc_v);

  const int ntiles = (t + BN - 1) / BN;
  for (int it = 0; it < ntiles; ++it) {
    dtts::cp_async_wait<0>();
    // Tile it has landed (its lse and delta too), and every warp is done with
    // tile it - 1: its stage and the exchange tiles may be overwritten.
    __syncthreads();
    if (it + 1 < ntiles) {
      const int nx = (it + 1) % C::kStages;
      copy_rows<D, BN, NT>(qs + nx * BN * P, qb, (it + 1) * BN, t, in_st, tid);
      copy_rows<D, BN, NT>(gs + nx * BN * P, gb, (it + 1) * BN, t, g_st, tid);
      dtts::cp_async_commit();
      stage_stats(nx, (it + 1) * BN);
    }
    const int cur = it % C::kStages;
    const bf16* qt = qs + cur * BN * P;
    const bf16* gt = gs + cur * BN * P;
    const float* ls = lse_s + cur * BN;
    const float* ds = delta_s + cur * BN;

    float st[C::kSB][4], dpt[C::kSB][4];  // S^T = K.Q^T, dP^T = V.g^T
    two_products_wide<D, BM>(ks, qt, vs, gt, wr * 16, wc * C::kSCols, lane, st, dpt);
    // Element e of block j is key g + 8 (e >> 1), q row it*BN + col + (e & 1).
#pragma unroll
    for (int j = 0; j < C::kSB; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = wc * C::kSCols + 8 * j + 2 * tq, at = (wr * 16 + gr + 8 * r) * XP + col;
        const float p0 = exp2f(st[j][2 * r] * scale_log2e - ls[col]);
        const float p1 = exp2f(st[j][2 * r + 1] * scale_log2e - ls[col + 1]);
        *reinterpret_cast<uint32_t*>(pt + at) = dtts::pack_bf16x2(p0, p1);
        *reinterpret_cast<uint32_t*>(dst + at) = dtts::pack_bf16x2(
            p0 * (dpt[j][2 * r] - ds[col]), p1 * (dpt[j][2 * r + 1] - ds[col + 1]));
      }
    __syncthreads();  // the tile's P^T and dS^T are whole
    accumulate_wide<D, BM>(acc_v, pt, gt, wr * 16, wc * C::kDV, lane);   // dV += P^T.g
    accumulate_wide<D, BM>(acc_k, dst, qt, wr * 16, wc * C::kDV, lane);  // dK += dS^T.Q
  }
  const int64_t out_off = blockIdx.z * out_sb + blockIdx.y * out_sh;
  store_mma<D>(dk + out_off, acc_k, scale, k0 + wr * 16, wc * C::kDV, t, out_st, lane);
  store_mma<D>(dv + out_off, acc_v, 1.f, k0 + wr * 16, wc * C::kDV, t, out_st, lane);
}

template <int D, int BM>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* g,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        int b, int h, int t, const int64_t* in_s, const int64_t* g_s,
                        const int64_t* out_s, float scale_log2e, float scale,
                        cudaStream_t stream) {
  using C = WideShape<D, BM>;
  static_assert(C::kFits, "the wide form's warps do not cover these tiles");
  // The attribute is per device, so it is set on every launch.
  cudaError_t err = cudaFuncSetAttribute(dq_wide_kernel<D, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_wide_kernel<D, BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkvSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BM - 1) / BM, h, b);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(g);
  dq_wide_kernel<D, BM><<<grid, C::kThreads, C::kDqSmem, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dq), t, in_s[0], in_s[1], in_s[2], g_s[0],
      g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_wide_kernel<D, BM><<<grid, C::kThreads, C::kDkvSmem, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, in_s[0],
      in_s[1], in_s[2], g_s[0], g_s[1], g_s[2], out_s[0], out_s[1], out_s[2], scale_log2e,
      scale);
  return cudaGetLastError();
}

// The mma route: the narrow form up to d = 80, the wide form above, with
// 32-row blocks where 64-row ones would fill no more than half the SMs and
// the shape allows them.
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       int b, int h, int t, const int64_t* in_s, const int64_t* g_s,
                       const int64_t* out_s, float scale_log2e, float scale,
                       cudaStream_t stream) {
  if constexpr (D <= 80) {
    return launch_narrow<D>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s, g_s, out_s,
                            scale_log2e, scale, stream);
  } else {
    if constexpr (WideShape<D, 32>::kFits) {
      int device = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
      if (2 * (int64_t)((t + 63) / 64) * b * h <= sms)
        return launch_wide<D, 32>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s, g_s,
                                  out_s, scale_log2e, scale, stream);
    }
    return launch_wide<D, 64>(q, k, v, g, lse, delta, dq, dk, dv, b, h, t, in_s, g_s, out_s,
                              scale_log2e, scale, stream);
  }
}

// -------------------------------------------------------------- wgmma route

// Hopper's asynchronous building blocks (mbarriers, TMA loads, warpgroup
// matrix products, the tensor-map encoder) live in hopper.cuh.
using dtts::EncodeTiled;
using dtts::encode_tiled;
using dtts::fence_regs;
using dtts::kEncodeFailed;
using dtts::mbar_arrive;
using dtts::mbar_expect_tx;
using dtts::mbar_init;
using dtts::mbar_wait;
using dtts::tma_load_4d;
using dtts::wgmma_commit;
using dtts::wgmma_desc;
using dtts::wgmma_fence;
using dtts::wgmma_rs;
using dtts::wgmma_ss;
using dtts::wgmma_wait;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from hoisting one 64-bit descriptor per k16 step out of
// a loop: each use starts from a copy it cannot see through.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// Tile shapes of the wgmma route at head width D (64 or 256). Every tile is
// 64 rows (q rows or keys) of D columns, carried as D / 64 TMA boxes of 64
// columns: 128-byte rows in the 128-byte swizzle, boxes 8 KB apart.
template <int D>
struct WgBwd {
  static_assert(D == 64 || D == 256, "the wgmma route takes d = 64 and 256");
  static constexpr int kBoxes = D / 64;
  static constexpr int kBoxBytes = 64 * 128;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // 8 KB at 64, 32 KB at 256
  static constexpr int kSteps = D / 16;                  // k16 steps of S and dP over d
  static constexpr int kStages = D == 64 ? 3 : 2;        // ring depth of the streamed pair
  // dK/dV's columns split over two warpgroups, P^T and dS^T exchanged
  static constexpr bool kWide = D > 64;
  static constexpr int kXBytes = 64 * 128;  // one exchange tile: 64 x 64 bf16, swizzled
  static constexpr int kDkvWarpgroups = kWide ? 2 : 1;
  // dK/dV blocks an SM is to hold: three at d = 64, which keeps ptxas within
  // 168 registers a thread (172 would leave room for two).
  static constexpr int kDkvMinBlocks = kWide ? 1 : 3;
  // dQ: the resident Q and g tiles, the K/V ring, delta of the block's 64
  // rows, the barriers (qg_full, kv_full[S], kv_empty[S]); 1024 bytes of
  // alignment.
  static constexpr int kDqSmem =
      1024 + 2 * kTileBytes + 2 * kStages * kTileBytes + 64 * 4 + 8 * (1 + 2 * kStages);
  // dK/dV: the resident K and V tiles, the Q/g ring, the exchange tiles
  // (wide form), each stage's lse and delta, the barriers (kv_full,
  // qg_full[S], qg_empty[S]).
  static constexpr int kDkvSmem = 1024 + 2 * kTileBytes + 2 * kStages * kTileBytes +
                                  (kWide ? 2 * kXBytes : 0) + 2 * kStages * 64 * 4 +
                                  8 * (1 + 2 * kStages);
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "tiles exceed a block's shared memory");
};

// Descriptor offset (16-byte units) of k16 step kk over a tile's columns:
// box kk / 4, 32 bytes a step within the box's 128-byte rows.
__device__ __forceinline__ uint32_t col_step(int kk) {
  return static_cast<uint32_t>(((kk / 4) * 64 * 128 + (kk % 4) * 32) >> 4);
}

// dQ: one block per (64 q rows, head, batch), one warpgroup. It holds the
// rows' Q and g tiles and streams the (K, V) tile pairs through an S-stage
// ring that it feeds itself: thread 0 loads the first S pairs, and while a
// tile's first products run it refills the stage that every warp released
// at the end of the tile before (no producer warp: a block is 128 threads,
// so that more blocks share an SM).
// Each tile: S = Q.K^T and dP = g.V^T (wgmma, both operands from shared
// memory, K-major), P = exp2(S scale log2e - lse) and dS = P (dP - delta) in
// the accumulator registers, then dQ += dS.K with dS rounded to bf16 as the
// register A operand and K read MN-major. delta = rowsum(g o) is computed
// here first, from g and o in global memory, and written to `delta` for the
// dK/dV launch that follows on the stream.
template <int D>
__global__ void __launch_bounds__(128, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
                const bf16* __restrict__ g, const bf16* __restrict__ o,
                const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
                int t, int64_t g_sb, int64_t g_st, int64_t g_sh, int64_t o_sb, int64_t o_st,
                int64_t o_sh, int64_t out_sb, int64_t out_st, int64_t out_sh,
                float scale_log2e, float scale) {
  using C = WgBwd<D>;
  constexpr int S = C::kStages, TB = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // Swizzled tiles need 1024-byte alignment.
  const uint32_t base = (dtts::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;           // the Q tile
  const uint32_t g_s = q_s + TB;       // the g tile
  const uint32_t k_s = g_s + TB;       // [S] K tiles
  const uint32_t v_s = k_s + S * TB;   // [S] V tiles
  const uint32_t dl_s = v_s + S * TB;  // [64] delta, fp32
  const uint32_t bar = dl_s + 64 * 4;
  const uint32_t qg_full = bar;
  auto kv_full = [&](int s) { return bar + 8u * (1 + s); };
  auto kv_empty = [&](int s) { return bar + 8u * (1 + S + s); };
  auto smem_ptr = [&](uint32_t addr) { return wg_smem + (addr - dtts::smem_addr(wg_smem)); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int head = blockIdx.y, batch = blockIdx.z, row0 = blockIdx.x * 64;
  const int ntiles = (t + 63) / 64;
  // K/V tile pair j into stage j % S (thread 0)
  auto load_kv = [&](int j) {
    const int s = j % S;
    mbar_expect_tx(kv_full(s), 2 * TB);
    for (int bx = 0; bx < C::kBoxes; ++bx) {
      tma_load_4d(k_s + s * TB + bx * C::kBoxBytes, &kmap, kv_full(s), 64 * bx, head, 64 * j,
                  batch);
      tma_load_4d(v_s + s * TB + bx * C::kBoxBytes, &vmap, kv_full(s), 64 * bx, head, 64 * j,
                  batch);
    }
  };
  if (tid == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), 4);  // lane 0 of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qg_full, 2 * TB);
    for (int bx = 0; bx < C::kBoxes; ++bx) {
      tma_load_4d(q_s + bx * C::kBoxBytes, &qmap, qg_full, 64 * bx, head, row0, batch);
      tma_load_4d(g_s + bx * C::kBoxBytes, &gmap, qg_full, 64 * bx, head, row0, batch);
    }
    for (int j = 0; j < S && j < ntiles; ++j) load_kv(j);
  }

  const int64_t stat = ((int64_t)batch * gridDim.y + head) * t;
  float* dl = reinterpret_cast<float*>(smem_ptr(dl_s));
  {
    // delta = rowsum(g o) in fp32, two threads a row, D / 2 columns each in
    // a fixed order; rows past t get 0 and are never stored.
    const int r = tid / 2, half = tid % 2, row = row0 + r;
    float sum = 0.f;
    if (row < t) {
      const bf16* gp = g + batch * g_sb + row * g_st + head * g_sh + half * (D / 2);
      const bf16* op = o + batch * o_sb + row * o_st + head * o_sh + half * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 2; i += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(gp + i);
        const uint4 b = *reinterpret_cast<const uint4*>(op + i);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      dl[r] = sum;
      if (row < t) delta[stat + row] = sum;
    }
    __syncthreads();  // the block's delta
  }
  // lse and delta of this lane's rows gq and gq + 8 of the warp's 16
  float rl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int local = 16 * warp + gq + 8 * r;
    rd[r] = dl[local];
    rl[r] = row0 + local < t ? lse[stat + row0 + local] : 0.f;
  }

  const uint64_t q_desc = wgmma_desc(q_s, 16, 1024, 1);
  const uint64_t g_desc = wgmma_desc(g_s, 16, 1024, 1);
  const uint64_t k_desc = wgmma_desc(k_s, 16, 1024, 1);  // K as S's B: K-major
  const uint64_t v_desc = wgmma_desc(v_s, 16, 1024, 1);
  // K as dQ's B: MN-major, 64-column atoms (boxes) kBoxBytes apart, 8-key
  // groups 1024 bytes apart
  const uint64_t kt_desc = wgmma_desc(k_s, C::kBoxBytes, 1024, 1);

  float acc[D / 2];  // dQ: 64 rows x D columns over the warpgroup
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];  // S and dP: 64 rows x 64 keys
  uint32_t ds[4][4];

  mbar_wait(qg_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % S;
    mbar_wait(kv_full(s), (j / S) & 1);
    wgmma_fence();
    {
      const uint64_t da = opaque(q_desc), dg = opaque(g_desc);
      const uint64_t dk = opaque(k_desc) + s * (TB >> 4), dv = opaque(v_desc) + s * (TB >> 4);
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk)
        wgmma_ss<64>(sc, da + col_step(kk), dk + col_step(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk)
        wgmma_ss<64>(dp, dg + col_step(kk), dv + col_step(kk), kk > 0);
    }
    wgmma_commit();
    // While they run: every warp has released the previous tile's stage,
    // which takes the pair S - 1 tiles on.
    if (tid == 0 && j > 0 && j - 1 + S < ntiles) {
      mbar_wait(kv_empty((j - 1) % S), ((j - 1) / S) & 1);
      load_kv(j - 1 + S);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // Element i is row gq + 8 ((i >> 1) & 1) of the warp's 16, key
    // 64 j + 8 (i / 4) + 2 tq + (i & 1); a key past t gets P = 0.
    const bool ragged = (j + 1) * 64 > t;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(sc[i], scale_log2e, -rl[r]));
      if (ragged && 64 * j + 8 * (i / 4) + 2 * tq + (i & 1) >= t) p = 0.f;
      sc[i] = p * (dp[i] - rd[r]);  // dS, fp32
    }
    // dS rounded to bf16 is the A operand as it stands: k16 step kk holds
    // n8 blocks 2 kk and 2 kk + 1.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[kk][e] = dtts::pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    fence_regs(acc);
    wgmma_fence();
    {
      const uint64_t db = opaque(kt_desc) + s * (TB >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, ds[kk], db + ((kk * 16 * 128) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(kv_empty(s));  // this warp is done with the stage
  }

  bf16* out = dq + batch * out_sb + head * out_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + gq + 8 * r;
    if (row >= t) continue;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(out + row * out_st + 8 * jn + 2 * tq) =
          __floats2bfloat162_rn(acc[4 * jn + 2 * r] * scale, acc[4 * jn + 2 * r + 1] * scale);
  }
}

// dK and dV: one block per (64 keys, head, batch), fed as dq_wgmma_kernel
// is: warp 0 loads the (Q, g) tile pairs into an S-stage ring, the first S
// at the start and each next one into the stage released the tile before,
// and stages each tile's 64 lse and delta values beside them (a q row past t
// gets lse = +inf, so its P and dS are 0). Each tile: S^T = K.Q^T and
// dP^T = V.g^T (wgmma, both operands from shared memory, K-major), P^T and
// dS^T in the accumulator registers, then dV += P^T.g and dK += dS^T.Q with
// g and Q read MN-major.
//   * d = 64 (the narrow form): one warpgroup holds dK and dV (2 x 32 fp32 a
//     thread); P^T and dS^T, rounded to bf16, are the register A operands
//     as they stand.
//   * d = 256 (the wide form): one 64-key tile, two consumer warpgroups that
//     split the result columns (128 each: 2 x 64 fp32 a thread; one
//     warpgroup would need 2 x 128). Warpgroup w computes S^T and dP^T for
//     q columns 32 w .. 32 w + 31 only (m64n32 products over all of d),
//     rounds P^T and dS^T to bf16 and writes them into two exchange tiles in
//     the 128-byte swizzle; after a named barrier each warpgroup reads the
//     whole 64 x 64 tiles as the A operand from shared memory, against g's
//     and Q's columns 128 w .. 128 w + 127 as an MN-major B at N = 128.
template <int D>
__global__ void __launch_bounds__(128 * WgBwd<D>::kDkvWarpgroups, WgBwd<D>::kDkvMinBlocks)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int64_t out_sb,
                 int64_t out_st, int64_t out_sh, float scale_log2e, float scale) {
  using C = WgBwd<D>;
  constexpr int S = C::kStages, TB = C::kTileBytes;
  constexpr bool kWide = C::kWide;
  constexpr int NC = C::kDkvWarpgroups;
  constexpr int NQ = kWide ? 32 : 64;    // q columns of S^T a warpgroup computes
  constexpr int DC = kWide ? D / 2 : D;  // result columns a warpgroup holds
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (dtts::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t k_s = base;            // the K tile
  const uint32_t v_s = k_s + TB;        // the V tile
  const uint32_t q_s = v_s + TB;        // [S] Q tiles
  const uint32_t g_s = q_s + S * TB;    // [S] g tiles
  const uint32_t x_s = g_s + S * TB;    // wide form: P^T, then dS^T, kXBytes each
  const uint32_t st_s = x_s + (kWide ? 2 * C::kXBytes : 0);  // [S][2][64]: lse, delta
  const uint32_t bar = st_s + S * 2 * 64 * 4;
  const uint32_t kv_full = bar;
  auto qg_full = [&](int s) { return bar + 8u * (1 + s); };
  auto qg_empty = [&](int s) { return bar + 8u * (1 + S + s); };
  auto smem_ptr = [&](uint32_t addr) { return wg_smem + (addr - dtts::smem_addr(wg_smem)); };
  float* stats = reinterpret_cast<float*>(smem_ptr(st_s));

  const int w = threadIdx.x / 128;  // the warpgroup (two in the wide form)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int head = blockIdx.y, batch = blockIdx.z, k0 = blockIdx.x * 64;
  const int ntiles = (t + 63) / 64;
  const int64_t stat = ((int64_t)batch * gridDim.y + head) * t;
  // Q/g tile pair j into stage j % S, with its rows' lse and delta (the 32
  // lanes of warp 0; each lane's arrival releases its stores, lane 0's also
  // announces the tiles' bytes)
  auto load_qg = [&](int j) {
    const int s = j % S;
    for (int r = lane; r < 64; r += 32) {
      const int row = 64 * j + r;
      stats[2 * s * 64 + r] = row < t ? lse[stat + row] : INFINITY;
      stats[(2 * s + 1) * 64 + r] = row < t ? delta[stat + row] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(qg_full(s), 2 * TB);
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        tma_load_4d(q_s + s * TB + bx * C::kBoxBytes, &qmap, qg_full(s), 64 * bx, head, 64 * j,
                    batch);
        tma_load_4d(g_s + s * TB + bx * C::kBoxBytes, &gmap, qg_full(s), 64 * bx, head, 64 * j,
                    batch);
      }
    } else {
      mbar_arrive(qg_full(s));
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(qg_full(s), 32);       // every lane of warp 0
      mbar_init(qg_empty(s), 4 * NC);  // lane 0 of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * TB);
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        tma_load_4d(k_s + bx * C::kBoxBytes, &kmap, kv_full, 64 * bx, head, k0, batch);
        tma_load_4d(v_s + bx * C::kBoxBytes, &vmap, kv_full, 64 * bx, head, k0, batch);
      }
    }
    for (int j = 0; j < S && j < ntiles; ++j) load_qg(j);
  }

  const uint64_t k_desc = wgmma_desc(k_s, 16, 1024, 1);  // K and V: the A operands, K-major
  const uint64_t v_desc = wgmma_desc(v_s, 16, 1024, 1);
  // Q and g as S^T's and dP^T's B (K-major), from q row 32 w in the wide form
  const uint32_t qoff = kWide ? 32 * w * 128 : 0;
  const uint64_t q_desc = wgmma_desc(q_s + qoff, 16, 1024, 1);
  const uint64_t g_desc = wgmma_desc(g_s + qoff, 16, 1024, 1);
  // ... and as dK's and dV's B (MN-major), from column 128 w in the wide form
  const uint32_t coff = kWide ? 2 * w * C::kBoxBytes : 0;
  const uint64_t qt_desc = wgmma_desc(q_s + coff, C::kBoxBytes, 1024, 1);
  const uint64_t gt_desc = wgmma_desc(g_s + coff, C::kBoxBytes, 1024, 1);

  float dka[DC / 2], dva[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
  float st[NQ / 2], dpt[NQ / 2];  // S^T and dP^T: 64 keys x NQ q rows

  mbar_wait(kv_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % S;
    mbar_wait(qg_full(s), (j / S) & 1);
    wgmma_fence();
    {
      const uint64_t da = opaque(k_desc), dvv = opaque(v_desc);
      const uint64_t db = opaque(q_desc) + s * (TB >> 4), dg = opaque(g_desc) + s * (TB >> 4);
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk)
        wgmma_ss<NQ>(st, da + col_step(kk), db + col_step(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk)
        wgmma_ss<NQ>(dpt, dvv + col_step(kk), dg + col_step(kk), kk > 0);
    }
    wgmma_commit();
    // While they run: every warp has released the previous tile's stage,
    // which takes the pair S - 1 tiles on.
    if (threadIdx.x < 32 && j > 0 && j - 1 + S < ntiles) {
      mbar_wait(qg_empty((j - 1) % S), ((j - 1) / S) & 1);
      load_qg(j - 1 + S);
    }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // Element i is key gq + 8 ((i >> 1) & 1) of the warp's 16, q column
    // (32 w in the wide form) + 8 (i / 4) + 2 tq + (i & 1) of the tile.
    const float* ls = stats + 2 * s * 64;
    const float* dls = ls + 64;
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      const int col = (kWide ? 32 * w : 0) + 8 * (i / 4) + 2 * tq + (i & 1);
      const float p = ex2(fmaf(st[i], scale_log2e, -ls[col]));
      st[i] = p;                         // P^T, fp32
      dpt[i] = p * (dpt[i] - dls[col]);  // dS^T, fp32
    }
    if constexpr (!kWide) {
      // P^T and dS^T rounded to bf16 are the A operands as they stand.
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = dtts::pack_bf16x2(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          sa[kk][e] = dtts::pack_bf16x2(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
      const uint64_t dg = opaque(gt_desc) + s * (TB >> 4), dq = opaque(qt_desc) + s * (TB >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(dva, pa[kk], dg + ((kk * 16 * 128) >> 4));
        wgmma_rs<D>(dka, sa[kk], dq + ((kk * 16 * 128) >> 4));
      }
    } else {
      // Both warpgroups are done with the previous tile's exchange tiles.
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      unsigned char* xp = smem_ptr(x_s);
      unsigned char* xd = xp + C::kXBytes;
#pragma unroll
      for (int i = 0; i < NQ / 2; i += 2) {
        // key 16 warp + gq + 8 r, q columns 32 w + 8 jn + 2 tq and + 1:
        // 16-byte chunk 4 w + jn of the 128-byte row, XORed with row % 8
        const int jn = i / 4, r = (i >> 1) & 1, row = 16 * warp + gq + 8 * r;
        const int off = row * 128 + (((4 * w + jn) ^ (row & 7)) << 4) + 4 * tq;
        *reinterpret_cast<uint32_t*>(xp + off) = dtts::pack_bf16x2(st[i], st[i + 1]);
        *reinterpret_cast<uint32_t*>(xd + off) = dtts::pack_bf16x2(dpt[i], dpt[i + 1]);
      }
      dtts::fence_proxy_async();  // the stores, before wgmma reads them
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both halves are written
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
      const uint64_t xpd = opaque(wgmma_desc(x_s, 16, 1024, 1));
      const uint64_t xdd = opaque(wgmma_desc(x_s + C::kXBytes, 16, 1024, 1));
      const uint64_t dg = opaque(gt_desc) + s * (TB >> 4), dq = opaque(qt_desc) + s * (TB >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        dtts::wgmma_ss_bmn128(dva, xpd + 2 * kk, dg + ((kk * 16 * 128) >> 4), 1);
        dtts::wgmma_ss_bmn128(dka, xdd + 2 * kk, dq + ((kk * 16 * 128) >> 4), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if (lane == 0) mbar_arrive(qg_empty(s));
  }

  const int64_t out_off = batch * out_sb + head * out_sh;
  const int c0 = kWide ? DC * w : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + 16 * warp + gq + 8 * r;
    if (row >= t) continue;
#pragma unroll
    for (int jn = 0; jn < DC / 8; ++jn) {
      const int64_t at = out_off + row * out_st + c0 + 8 * jn + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[4 * jn + 2 * r] * scale, dka[4 * jn + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[4 * jn + 2 * r], dva[4 * jn + 2 * r + 1]);
    }
  }
}

// The (d, H, T, B) map of a bf16 [B, T, H, d] tensor with (batch, token,
// head) strides `s` in elements: boxes of 64 columns by 64 tokens of one
// head in the 128-byte swizzle; tokens past t read as zero.
int encode_rows(CUtensorMap* map, const void* ptr, int d, int b, int h, int t,
                const int64_t* s) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

struct BwdMaps {
  CUtensorMap q, k, v, g;
};

template <int D>
cudaError_t launch_dq_wgmma(const BwdMaps& m, const void* g, const void* o, const float* lse,
                            float* delta, void* dq, int b, int h, int t, const int64_t* g_s,
                            const int64_t* o_s, const int64_t* out_s, float scale_log2e,
                            float scale, cudaStream_t stream) {
  constexpr int smem = WgBwd<D>::kDqSmem;
  cudaError_t err = cudaFuncSetAttribute(dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + 63) / 64, h, b);
  dq_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      m.q, m.k, m.v, m.g, static_cast<const bf16*>(g), static_cast<const bf16*>(o), lse, delta,
      static_cast<bf16*>(dq), t, g_s[0], g_s[1], g_s[2], o_s[0], o_s[1], o_s[2], out_s[0],
      out_s[1], out_s[2], scale_log2e, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const BwdMaps& m, const float* lse, const float* delta, void* dk,
                             void* dv, int b, int h, int t, const int64_t* out_s,
                             float scale_log2e, float scale, cudaStream_t stream) {
  constexpr int smem = WgBwd<D>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(dkv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + 63) / 64, h, b);
  dkv_wgmma_kernel<D><<<grid, 128 * WgBwd<D>::kDkvWarpgroups, smem, stream>>>(
      m.q, m.k, m.v, m.g, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t,
      out_s[0], out_s[1], out_s[2], scale_log2e, scale);
  return cudaGetLastError();
}

// The wgmma route: the tensor maps, then dQ (which writes delta), then dK/dV
// on the same stream. The plan is the caller's (ops/kernels/
// qkv_attention.py::bwd_wgmma_plan): the warpgroups of a dQ and of a dK/dV
// block, 1 and 1 at d = 64, 1 and 2 at d = 256; anything else is refused.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* g, const void* o,
                 const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int h,
                 int t, const int64_t* in_s, const int64_t* g_s, const int64_t* o_s,
                 const int64_t* out_s, float scale_log2e, float scale, int dq_nc, int dkv_nc,
                 cudaStream_t stream) {
  if (dq_nc != 1 || dkv_nc != WgBwd<D>::kDkvWarpgroups)
    return static_cast<int>(cudaErrorInvalidValue);
  // autograd runs the backward on a thread of its own, where no context may
  // be current yet: the encoder (a driver call) needs the device's primary
  // context current, which cudaSetDevice makes it.
  int device = 0;
  cudaError_t ctx = cudaGetDevice(&device);
  if (ctx == cudaSuccess) ctx = cudaSetDevice(device);
  if (ctx != cudaSuccess) return static_cast<int>(ctx);
  BwdMaps m;
  int err = encode_rows(&m.q, q, D, b, h, t, in_s);
  if (err == 0) err = encode_rows(&m.k, k, D, b, h, t, in_s);
  if (err == 0) err = encode_rows(&m.v, v, D, b, h, t, in_s);
  if (err == 0) err = encode_rows(&m.g, g, D, b, h, t, g_s);
  if (err != 0) return err;
  cudaError_t e = launch_dq_wgmma<D>(m, g, o, lse, delta, dq, b, h, t, g_s, o_s, out_s,
                                     scale_log2e, scale, stream);
  if (e == cudaSuccess)
    e = launch_dkv_wgmma<D>(m, lse, delta, dk, dv, b, h, t, out_s, scale_log2e, scale, stream);
  return static_cast<int>(e);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: the head width, one of 4, 8, 16, 32,
// 40, 64, 80, 160, 256. lse and delta are fp32 [B, H, T]: the forward
// kernel's row log2-sum-exp2, and sum_d g*o (the caller's on routes 0 and 1;
// on route 2 the dQ launch computes it from g and o and writes it there).
// Strides are in elements for (batch, token, head), the head width's stride
// being 1: one triple for q, k and v, one for g, one for o (route 2 only),
// one for dq, dk and dv. route: 0 = fma (any dtype and width), 1 = mma
// (bfloat16 at d = 16, 32, 40, 64, 80, 160, 256, every pointer and stride
// 16-byte aligned), 2 = wgmma (bfloat16 at d = 64 and 256, aligned the same
// way). dq_consumers, dkv_consumers: the wgmma route's plan (ops/kernels/
// qkv_attention.py::bwd_wgmma_plan), 1 and 1 on the other routes. Two
// launches (dQ, then dK/dV). Returns the first failing launch's cudaError_t
// (0 on success), or kEncodeFailed + the CUresult of a refused tensor map;
// the caller raises on anything else.
extern "C" int dtts_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const void* o, const float* lse, float* delta, void* dq,
                                  void* dk, void* dv, int dtype, int d, int b, int h, int t,
                                  int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t g_sb,
                                  int64_t g_st, int64_t g_sh, int64_t o_sb, int64_t o_st,
                                  int64_t o_sh, int64_t out_sb, int64_t out_st, int64_t out_sh,
                                  float scale_log2e, float scale, int route, int dq_consumers,
                                  int dkv_consumers, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t in_s[3] = {in_sb, in_st, in_sh}, g_s[3] = {g_sb, g_st, g_sh},
                o_s[3] = {o_sb, o_st, o_sh}, out_s[3] = {out_sb, out_st, out_sh};
  if (route == 2) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define DTTS_ATTN_BWD_WGMMA(D)                                                               \
  case D:                                                                                    \
    return launch_wgmma<D>(q, k, v, g, o, lse, delta, dq, dk, dv, b, h, t, in_s, g_s, o_s,   \
                           out_s, scale_log2e, scale, dq_consumers, dkv_consumers, s);
    switch (d) {
      DTTS_ATTN_BWD_WGMMA(64)
      DTTS_ATTN_BWD_WGMMA(256)
    }
#undef DTTS_ATTN_BWD_WGMMA
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dq_consumers != 1 || dkv_consumers != 1) return static_cast<int>(cudaErrorInvalidValue);
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
      DTTS_ATTN_BWD_MMA(160)
      DTTS_ATTN_BWD_MMA(256)
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
    DTTS_ATTN_BWD(256)
  }
#undef DTTS_ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
