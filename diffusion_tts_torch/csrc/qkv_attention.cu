// Self-attention for Hopper (sm_90a), any supported head width, plain C
// interface, four routes.
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
// FLOP/byte in bf16, far above the H100's 295 FLOP/byte balance point. At
// d = 40 the exponentials weigh as much as the products: B*H*T^2 exp2 on
// the SFU (16 a clock per SM) against 4*B*H*T^2*d FLOPs on the tensor cores;
// at [8, 4096, 8, 40] about 0.29 ms against 0.174 ms.
//
// Routes. The caller picks one (ops/kernels/qkv_attention.py::forward_route)
// and this file obeys:
//   * wgmma (route 2): bf16 at d = 40, 64, 80, 160, 256, 512, the ADM's, the
//     SD UNet's, the CIFAR-10 DDPM++ net's and the SD VAE's widths. Hopper's
//     asynchronous warpgroup products (wgmma) fed by TMA, below.
//   * mma (route 1): bf16 at d = 16, 32, 40, 64, 80, 160, 256, 512, the
//     first tensor-core design: the products run through the warp-level mma.sync
//     m16n8k16 (bf16 operands, fp32 accumulators: exactly the arithmetic of
//     the function above). The route takes d = 16 and 32 (test nets); forced
//     (route="mma") it also takes the wgmma widths, 256 and 512 among them,
//     which times this design beside the new one.
//   * tf32x3 (route 3): fp32 at d = 64, 256, the ADM's and the DDPM++ net's
//     widths at the CLIs' default dtype. The products run on the tensor
//     cores as three tf32 wgmma products each (attention_tf32_kernel, below):
//     x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), a.b = lo_a.hi_b +
//     hi_a.lo_b + hi_a.hi_b in fp32 accumulators, which holds 1e-4 against an
//     fp32 reference with TF32 off, as one tf32 product (about 11 bits) would
//     not. The TPU kernel's fp32 dots are the same three passes on its matrix
//     unit.
//   * fma (route 0): fp32 at the other widths, and bf16 at the test widths 4
//     and 8. The products run on the CUDA cores in fp32 FMA. fp32 and bf16
//     can be sent here at any width (route="fma"), which times the first
//     design.
//
// The wgmma route (attention_wgmma_kernel):
//   * Work tiles of (batch, head, 64 NC q rows): NC consumer warpgroups of
//     64 rows each and one producer warp. NC = 2 (128-row tiles) unless
//     T <= 64 or 128-row tiles would give the grid fewer tiles than the
//     card has SMs (the SD UNet's [2, 256, 8, 160]: 32 tiles); then NC = 1,
//     at d = 256 too, where a key split (below) takes NC = 1. At d = 512
//     the two consumer warpgroups share 64-row tiles (below). The caller
//     picks NC with the split (ops/kernels/qkv_attention.py::wgmma_plan)
//     and the C entry takes both as they are.
//   * Persistent: min(tiles, SMs) blocks, each walking the tiles blockIdx.x,
//     + gridDim.x, ... (q tile fastest, so the tiles in flight share K and V
//     in L2). The producer loads the next tile's Q and first K/V tiles while
//     the consumers finish the current one: at the ADM's [8, 1024, 6 heads]
//     (8 K/V tiles a work tile) that hides 10% that one block per tile paid
//     at each tile's start and end.
//   * The producer's one lane issues TMA loads: Q once a tile (freed when
//     the tile's last S has read it), then K and V tiles of BK keys (128;
//     64 at d = 160 and 256 and wherever T <= 64, where 128 keys would be
//     half masked; 32 at d = 512) into a ring of 2 (d = 40, 80, 512) or 3
//     stages, each with full and empty mbarriers for K and for V (K is
//     freed as soon as S has read it).
//   * Registers: at most 168 a thread, what three warps of an SM
//     sub-partition may hold (153-166 used at NC = 2, no spills). A producer
//     warpgroup with setmaxnreg did not get the consumers more from ptxas:
//     192-key tiles spilled alike. The tile descriptors are built from one
//     base each, so that the compiler does not hold one a k16 step.
//   * Layouts: Q, K and V are read through 4-D tensor maps (d, H, T, B)
//     encoded on the host for each call (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPointByVersion: no -lcuda), passed as
//     __grid_constant__ parameters. The qkv layout [B, T, 3C] is three maps
//     at offsets 0, C and 2C with byte strides 2d, 6C and 6TC; [B, T, H, D]
//     is three maps of its own. Columns past d and tokens past T arrive
//     zero-filled; scores of keys past T are masked to -inf.
//   * Widths that do not tile a 128-byte swizzle atom: a box is 16, 32 or
//     64 columns (32-, 64- or 128-byte rows, swizzled at that width: d = 40
//     and 80 take 16, d = 160 32, d = 64, 256 and 512 64). S = Q.K^T is wgmma
//     m64nBKk16 with both operands read from shared memory through
//     descriptors (K-major), its depth d rounded up to 16 (40 -> 48); P.V is
//     m64nDPk16 with DP the columns the boxes cover (48, 64, 80, 160) and V
//     the MN-major B operand.
//   * The online softmax runs on S's fp32 accumulators in registers: ex2
//     with 1/sqrt(d)*log2(e) folded in, row max and sum over the four lanes
//     of a row; O's rescale is skipped where no row of a warp took a new
//     maximum (alpha is then 1 exactly: 7% of d = 512's time, no change at
//     the other widths). P is rounded to bf16 in registers and is the A
//     operand of P.V as it stands (the accumulator layout is the A fragment
//     layout): P never touches shared memory.
//   * Overlap: each warpgroup issues S_j, then P_{j-1}.V_{j-1}, and runs the
//     softmax of S_j while P.V is in flight (wgmma.wait_group 1); O's
//     rescale by the previous tile's factor runs while S_j does. The two
//     warpgroups take turns to issue (named barriers 1 and 2), so one's
//     exponentials run while the other's products do.
//   * d = 256, the DDPM++ net's single head: a consumer warpgroup's 64 x 256
//     fp32 O is 128 registers a thread, S 32 and P 16 (ptxas: 210). One
//     consumer warpgroup and the producer warp, 160 threads, so that a
//     thread may hold 255 registers (two warps a sub-partition), a 3-stage
//     ring, 230,512 bytes of shared memory; or, where 128-row tiles fill
//     the card (the training batches), the up-conv's layout (csrc/
//     conv3x3.cu): two consumer warpgroups taking turns and a producer
//     warpgroup, setmaxnreg 40 / 232, a 2-stage ring (197,736 bytes): two
//     warpgroups share each K/V tile, which halves what the products read
//     from L2. 64-key K/V tiles, d as four 64-column boxes swizzled at 128
//     bytes, P.V at m64n256k16; S is computed once for all of O's columns
//     (the mma route's two warp groups compute it twice).
//   * d = 256's key split: where the q tiles leave the card short of SMs
//     (the serving path's [8, 256, 768]: 32 tiles of 64 rows for 132 SMs),
//     each tile's keys are split over a thread-block cluster of 2 or 4
//     CTAs, whose partial (O, m, l) are merged through distributed shared
//     memory (attention_wgmma_kernel's comment). The caller picks the factor
//     (ops/kernels/qkv_attention.py::wgmma_split) from the SM count and from
//     how many such clusters the card holds at once
//     (dtts_attention_split_clusters: a cluster needs free SMs of one GPC):
//     on an H100 a second wave of clusters costs more than the split saves.
//     The training batches (128 and 512 tiles) run unsplit on the
//     persistent grid.
//   * d = 512, the SD VAE mid-block's single head: a warpgroup's 64 x 512
//     fp32 O would be 256 registers a thread, more than a thread may hold,
//     and wgmma's N stops at 256. So two consumer warpgroups share each
//     64-row q tile, warpgroup w holding O's columns [256 w, 256 w + 256)
//     (128 registers a thread), with a producer warpgroup and setmaxnreg
//     40 / 232 as at d = 256. For S each takes its half of the depth, S_w =
//     Q[:, half w] . K[:, half w]^T (m64n32k16, both operands from shared
//     memory), leaves it in fp32 in shared memory and, after a named
//     barrier, adds the other's: both hold S_0 + S_1 bit for bit (fp32
//     addition commutes) and run the same online softmax; each then issues
//     P.V at m64n256k16 on its half of V. Every product runs once (the mma
//     route's two warp groups compute S twice: 1.5x the products). A 64 KB
//     Q tile, 32-key K/V tiles (32 KB each) through a 2-stage ring, and two
//     slots of the S exchange a warpgroup (32 KB): 230,480 bytes of shared
//     memory. Each 64-row tile streams its head's whole K and V from L2
//     (8 MB at T = 4096). The consumer code is compiled once for each
//     warpgroup, its index a constant, so that the descriptors are uniform
//     values: with the index read at run time every thread redid each
//     k-step's descriptor arithmetic ahead of its m64n32k16 product.
//     No key split: the decode's batch 1 ([1, 4096, 1, 512], 64 tiles for
//     132 SMs) runs unsplit, as fast a tile as batch 4 with every SM busy.
//     A split kernel (d = 256's cluster merge, the partial over Q and the
//     ring) spilled 256-416 bytes in its consumer loop and ran each key
//     tile 2.2x slower.
//   * Nothing gives way: a refused encode, launch (a cluster launch among
//     them) or misaligned input is an error (the wrapper raises), never a
//     fall back to the mma route.
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
//   * d = 512 (served when forced; its own route is wgmma): a 16 x 512 fp32
//     O accumulator is 256 registers a thread. 8 warps, O's columns split
//     between two warp groups of 4 (256 columns, 128 registers each); each
//     group computes the 64 rows' S itself instead of receiving it through
//     shared memory, 1.5x the operations and no exchange or extra barrier
//     (O's columns split over the grid with S recomputed per 128-column
//     block would cost 2.5x). Q stays in shared memory and its fragments
//     are loaded per step; K/V tiles are 32 keys; 199,680 bytes of shared
//     memory, one block per SM.
//   * d = 256 (served when forced; its own route is wgmma): one warp's
//     16 x 256 fp32 O accumulator would be 128 registers a thread before S
//     (32), the row state and the addresses, close to the 255 a thread may
//     have. The d = 512 split serves here too: two warp groups of 4, 128 O
//     columns (64 registers) each, 64-key K/V tiles, Q in shared memory;
//     168,960 bytes of shared memory, one block per SM.
//
// The tf32x3 route: see attention_tf32_kernel's comment.
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
// Every route:
//   * Explicit (batch, token, head) strides for q, k, v and o: the same
//     code serves the [B, T, 3C] qkv layout and a [B, T, H, D] layout. The
//     tensor-core routes need every pointer and stride 16-byte aligned; the
//     wrapper refuses anything else.
//   * Training: the block holds each row's running maximum and sum, so on
//     request it writes the row's log2-sum-exp2 (fp32 [B, H, T]) for the
//     backward kernels (csrc/attention_bwd.cu), which then need no statistics
//     pass of their own (the TPU forward saves none, and its backward starts
//     with one more q.k^T pass). A null pointer, as in serving, writes nothing.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
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
using dtts::sm_count;
using dtts::split_tf32;
using dtts::tma_load_4d;
using dtts::wgmma_commit;
using dtts::wgmma_desc;
using dtts::wgmma_fence;
using dtts::wgmma_rs;
using dtts::wgmma_rs_tf32;
using dtts::wgmma_ss;
using dtts::wgmma_ss_tf32;
using dtts::wgmma_wait;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// Tile shapes of the wgmma route for head width D and K/V tiles of BK keys
// (128; 64 at d = 160 and 256, and at T <= 64, where a 128-key tile is half
// masked; 32 at d = 512, where a 64 KB Q tile and two stages of K and V fill
// shared memory).
template <int D, int BK = (D > 256 ? 32 : D > 128 ? 64 : 128)>
struct WgTiles {
  static constexpr int kDS = (D + 15) / 16 * 16;  // S's depth: D padded to k16 (40 -> 48)
  // Columns a TMA box carries: 16, 32 or 64 bf16 (32-, 64- or 128-byte rows,
  // swizzled at that width).
  static constexpr int kBW = D == 64 || D >= 256 ? 64 : D == 160 ? 32 : 16;
  static constexpr int kDP = (D + kBW - 1) / kBW * kBW;  // columns the boxes cover
  // d = 512: O's columns split between two consumer warpgroups that share
  // the q rows (a warpgroup's 64 x 512 fp32 O would be 256 registers a
  // thread).
  static constexpr int kHalves = D > 256 ? 2 : 1;
  static constexpr int kDW = kDP / kHalves;       // O columns a warpgroup holds; P.V's N
  static constexpr int kRowBytes = 2 * kBW;
  static constexpr int kBoxes = kDP / kBW;
  static constexpr uint32_t kMode = kBW == 64 ? 1 : kBW == 32 ? 2 : 3;  // descriptor swizzle
  static constexpr int kBK = BK;                  // keys per K/V tile
  // K/V ring depth: 2 at d = 40 and 80, 3 at 64 and 160, the faster of 2,
  // 3 and 4 at each width (tools/torch_attention_fwd_probe.py); 3 at 256
  // (2 with two consumer warpgroups: stages()).
  static constexpr int kStages = D == 40 || D == 80 ? 2 : 3;
  static constexpr int kQBytes = 64 * kDP * 2;    // 64 q rows
  static constexpr int kTileBytes = kBK * kDP * 2;  // one K or V tile
  // d = 256 with two consumer warpgroups: two 32 KB Q tiles leave room for
  // 2 stages; d = 512: its 64 KB Q tile too.
  __host__ __device__ static constexpr int stages(int nc) {
    return D == 512 || (D == 256 && nc == 2) ? 2 : kStages;
  }
  // Q tiles of 64 rows a work tile: one a consumer warpgroup, or one that
  // d = 512's two warpgroups share.
  __host__ __device__ static constexpr int q_tiles(int nc) { return kHalves == 2 ? 1 : nc; }
  // d = 512: each warpgroup's S over its half of the depth, exchanged in
  // fp32: [2 slots][2 warpgroups][BK / 8 float4][128 threads].
  static constexpr int kXchgBytes = kHalves == 2 ? 2 * 2 * 64 * kBK * 4 : 0;
  static constexpr int smem_bytes(int nc) {
    return 1024 + q_tiles(nc) * kQBytes + 2 * stages(nc) * kTileBytes + kXchgBytes +
           8 * (2 + 4 * stages(nc));
  }
  // A key split's partial (one consumer warpgroup), written over the ring
  // once its last tile is read: O unnormalized, 64 rows kXPitch floats apart
  // (8 floats of padding: a half-warp's float2 stores hit 32 banks), then
  // each row's (m, l).
  static constexpr int kXPitch = kDP + 8;
  static constexpr int kXBytes = 64 * kXPitch * 4 + 64 * 8;
  static_assert(kDW % 16 == 0 && kDW <= 256, "P.V runs at N = kDW");
  static_assert(smem_bytes(2) <= 232448, "tiles exceed a block's shared memory");
};

// One persistent block per SM: NC consumer warpgroups of 64 q rows each and
// one producer warp (one lane issues every TMA load). The block walks the
// work tiles (batch, head, 64 NC q rows) blockIdx.x, + gridDim.x, ... in
// order, q tile fastest, so the tiles in flight share their K and V in L2;
// the producer loads the next tile's Q and first K/V tiles while the
// consumers finish the current one. The producer is a lone warp: with
// three warps on each SM sub-partition (NC = 2) a thread may hold 168
// registers, all the consumers need at BK = 128; with two (NC = 1) it may
// hold 255, which d = 256's 64 x 256 fp32 O (128 a thread) needs.
//
// SPLIT > 1 (d = 256, NC = 1): clusters of SPLIT CTAs, one work tile a
// cluster (the grid is work * SPLIT blocks). CTA `rank` of the cluster takes
// the tile's K/V tiles [rank n / SPLIT, (rank + 1) n / SPLIT) of n, runs the
// online softmax over them and leaves its unnormalized O and its rows' (m, l)
// in its shared memory. After a cluster barrier each CTA reads every CTA's
// (m, l) through distributed shared memory, takes M = max m_i and L =
// sum l_i exp2(m_i - M) in rank order, and writes O's columns [rank kDP /
// SPLIT, (rank + 1) kDP / SPLIT) as sum_i O_i exp2(m_i - M) / L, also in rank
// order: every CTA merges the same way, so two runs are bit-identical. CTA 0
// writes lse = M + log2 L. A second cluster barrier keeps each CTA's shared
// memory until the others have read it.
//
// d = 256 with two consumer warpgroups (128-row tiles, where they fill the
// card: the training batches), and d = 512: the producer is a whole
// warpgroup, so that setmaxnreg can move registers to the consumers
// (kWgProducerRegs / kWgConsumerRegs): ptxas gives the 384-thread block 168
// a thread, and a consumer needs about 210.
//
// d = 512 (kColumns): the two consumer warpgroups share a work tile's 64 q
// rows; warpgroup w holds O's columns [256 w, 256 w + 256) and reads only
// that half of every V tile. For S it takes the same half of the depth
// (kDepthHalves): S_w = Q[:, half w] . K[:, half w]^T, m64n32k16 at depth 256,
// left in fp32 in shared memory; after a named barrier each adds the other's
// partial, so both hold S_0 + S_1 bit for bit (fp32 addition commutes) and
// run the same online softmax, and each issues P.V at m64n256k16 on its
// columns. The products are the attention's own, once each.
template <int D, int NC>
constexpr bool kProducerWarpgroup = (D == 256 && NC == 2) || D == 512;
template <int D, int NC>
constexpr int wgmma_threads() { return 128 * NC + (kProducerWarpgroup<D, NC> ? 128 : 32); }
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
static_assert(2 * 128 * kWgConsumerRegs + 128 * kWgProducerRegs <= 384 * 168,
              "setmaxnreg shares out no more than the launch gave");
// q rows of a work tile
template <int D, int NC>
__host__ __device__ constexpr int tile_rows() { return 64 * WgTiles<D>::q_tiles(NC); }

// A compile-time int that converts to int in device code.
template <int V>
struct Constant {
  __host__ __device__ constexpr operator int() const { return V; }
};

template <int D, int NC, int BKV, int SPLIT>
__global__ void __launch_bounds__(wgmma_threads<D, NC>(), 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int h,
                       int t, int work, int64_t out_sb, int64_t out_st, int64_t out_sh,
                       float scale_log2e, float* __restrict__ lse) {
  using C = WgTiles<D, BKV>;
  constexpr int BK = C::kBK, S = C::stages(NC), RB = C::kRowBytes, QT = C::q_tiles(NC);
  constexpr bool kColumns = C::kHalves == 2;  // d = 512: O's columns split, the rows shared
  constexpr bool kDepthHalves = kColumns;     // ... and S's depth, the halves exchanged
  constexpr bool kPingPong = NC == 2 && !kColumns;
  constexpr int kRows = tile_rows<D, NC>();
  static_assert(SPLIT == 1 || (NC == 1 && C::kXBytes <= 2 * S * C::kTileBytes),
                "a key split takes one consumer warpgroup and a partial the ring can hold");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // Swizzled tiles need their swizzle's alignment; 1024 bytes serves all three.
  const uint32_t base = (dtts::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;                           // [QT][kBoxes][64][kBW]
  const uint32_t k_s = q_s + QT * C::kQBytes;          // [S][kBoxes][BK][kBW]
  const uint32_t v_s = k_s + S * C::kTileBytes;        // [S][kBoxes][BK][kBW]
  const uint32_t x_s = v_s + S * C::kTileBytes;        // d = 512: S's halves exchanged
  // mbarriers: q_full, q_empty, then k_full[S], v_full[S], k_empty[S], v_empty[S]
  const uint32_t bar = x_s + C::kXchgBytes;
  const uint32_t q_full = bar, q_empty = bar + 8u;
  auto k_full = [&](int s) { return bar + 8u * (2 + s); };
  auto v_full = [&](int s) { return bar + 8u * (2 + S + s); };
  auto k_empty = [&](int s) { return bar + 8u * (2 + 2 * S + s); };
  auto v_empty = [&](int s) { return bar + 8u * (2 + 3 * S + s); };
  // A shared address as a generic pointer.
  auto smem_ptr = [&](uint32_t addr) { return wg_smem + (addr - dtts::smem_addr(wg_smem)); };

  const int w = threadIdx.x / 128;  // the consumer warpgroup; NC is the producer
  const int qtiles = (t + kRows - 1) / kRows;
  // The K/V tiles [j0, j0 + ntiles) of each work tile: all of them, or this
  // CTA's share of a key split (none where SPLIT exceeds the tiles).
  const int rank = SPLIT == 1 ? 0 : (int)dtts::cluster_ctarank();
  const int kv_tiles = (t + BK - 1) / BK;
  const int j0 = rank * kv_tiles / SPLIT;
  const int ntiles = (rank + 1) * kv_tiles / SPLIT - j0;
  const int first = blockIdx.x / SPLIT, stride = gridDim.x / SPLIT;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NC);  // lane 0 of every consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NC);
      mbar_init(v_empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (w == NC) {
    if constexpr (kProducerWarpgroup<D, NC>)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (threadIdx.x == 128 * NC && ntiles > 0) {
      int it = 0;  // K/V tiles loaded so far, over all work tiles: the ring's position
      for (int tile = first, n = 0; tile < work; tile += stride, ++n) {
        const int q0 = tile % qtiles * kRows, head = tile / qtiles % h;
        const int batch = tile / qtiles / h;
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // the previous tile's S is done
        mbar_expect_tx(q_full, QT * C::kQBytes);
        for (int c = 0; c < QT; ++c)
          for (int bx = 0; bx < C::kBoxes; ++bx)
            tma_load_4d(q_s + c * C::kQBytes + bx * 64 * RB, &qmap, q_full, bx * C::kBW, head,
                        q0 + 64 * c, batch);
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int s = it % S, parity = ((it / S) - 1) & 1;
          if (it >= S) mbar_wait(k_empty(s), parity);  // the consumers are done with it
          mbar_expect_tx(k_full(s), C::kTileBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx)
            tma_load_4d(k_s + s * C::kTileBytes + bx * BK * RB, &kmap, k_full(s), bx * C::kBW,
                        head, (j0 + j) * BK, batch);
          if (it >= S) mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), C::kTileBytes);
          for (int bx = 0; bx < C::kBoxes; ++bx)
            tma_load_4d(v_s + s * C::kTileBytes + bx * BK * RB, &vmap, v_full(s), bx * C::kBW,
                        head, (j0 + j) * BK, batch);
        }
      }
    }
  } else {
    if constexpr (kProducerWarpgroup<D, NC>)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    // The consumer warpgroups' work, for warpgroup wc. At d = 512 it is
    // compiled once for each warpgroup with wc a constant, so that the
    // tiles' descriptors are values uniform over the warpgroup, which the
    // compiler keeps and steps in uniform registers (at run time the
    // warpgroup number would put each k-step's descriptor arithmetic on
    // every thread, ahead of each m64n32k16 product).
    auto consume = [&](auto wc) {
      const int w = wc;
      // Consumer warpgroup w: q rows q0 + 64 w ... q0 + 64 w + 63 of each work
      // tile (at d = 512 both take rows q0 ... q0 + 63, warpgroup w O's columns
      // [256 w, 256 w + 256)).
      const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
      const int g = lane >> 2, tq = lane & 3;
      const int row0 = kColumns ? 0 : 64 * w, col0 = kColumns ? w * C::kDW : 0;
      // The halves of Q's and K's depth (d = 512: boxes 4 w ...) and of V's
      // columns this warpgroup reads.
      const uint32_t qw =
          q_s + (kColumns ? (kDepthHalves ? w * C::kQBytes / 2 : 0) : w * C::kQBytes);
      const uint32_t kw = k_s + (kDepthHalves ? w * C::kTileBytes / 2 : 0);
      const uint32_t vw = v_s + (kColumns ? w * C::kTileBytes / 2 : 0);
      constexpr int kSSteps = C::kDS / 16 / (kDepthHalves ? 2 : 1);  // k16 steps of S

      // Descriptors of the tiles' starts; a k16 step adds its byte offset / 16
      // to the address field. Each use starts from a copy the compiler cannot
      // see through, so that it does not hoist one 64-bit descriptor per step
      // out of the loop (at d = 160 that held 20 registers and spilled).
      const uint64_t q_desc = wgmma_desc(qw, 16, 8 * RB, C::kMode);
      const uint64_t k_desc = wgmma_desc(kw, 16, 8 * RB, C::kMode);
      const uint64_t v_desc = wgmma_desc(vw, BK * RB, 8 * RB, C::kMode);
      auto opaque = [](uint64_t x) {
        asm volatile("" : "+l"(x));
        return x;
      };
      // S = Q.K^T over the padded depth: k16 step kk reads box kk*16/kBW at
      // byte offset (kk*16 % kBW)*2; K-major, 8-row groups kRowBytes*8 apart.
      auto issue_s = [&](float (&sc)[BK / 2], int stage) {
        const uint64_t da = opaque(q_desc);
        const uint64_t db = opaque(k_desc) + stage * (C::kTileBytes >> 4);
#pragma unroll
        for (int kk = 0; kk < kSSteps; ++kk) {
          const int bx = kk * 16 / C::kBW, off = (kk * 16 % C::kBW) * 2;
          wgmma_ss<BK>(sc, da + ((bx * 64 * RB + off) >> 4), db + ((bx * BK * RB + off) >> 4),
                       kk > 0);
        }
      };
      // O += P.V: k16 step kk takes keys 16 kk ...; V is MN-major: kBW columns
      // per swizzle atom, atoms (boxes) BK*kRowBytes apart, 8-key groups
      // 8*kRowBytes apart.
      auto issue_pv = [&](float (&acc)[C::kDW / 2], const uint32_t (&p)[BK / 16][4], int stage) {
        const uint64_t dv = opaque(v_desc) + stage * (C::kTileBytes >> 4);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<C::kDW>(acc, p[kk], dv + (kk * 16 * RB >> 4));
      };

      float acc[C::kDW / 2];
      float m[2], l[2];  // rows g and g + 8
      float sc[BK / 2];
      uint32_t p[BK / 16][4];

      // d = 512: S_0 + S_1. Each warpgroup leaves its partial in its slot of
      // the exchange (slots alternate by tile: the other may still be reading
      // the previous one) and, after the named barrier, adds the other's.
      auto add_halves = [&](int tile_no) {
        if constexpr (kDepthHalves) {
          constexpr int kV = BK / 8;  // float4s of a thread's S
          float4* xs =
              reinterpret_cast<float4*>(smem_ptr(x_s)) + (tile_no & 1) * 2 * kV * 128 + tid;
#pragma unroll
          for (int c = 0; c < kV; ++c)
            xs[(w * kV + c) * 128] =
                make_float4(sc[4 * c], sc[4 * c + 1], sc[4 * c + 2], sc[4 * c + 3]);
          asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
          for (int c = 0; c < kV; ++c) {
            const float4 x = xs[((1 - w) * kV + c) * 128];
            sc[4 * c] += x.x, sc[4 * c + 1] += x.y, sc[4 * c + 2] += x.z, sc[4 * c + 3] += x.w;
          }
        }
      };

      // The online softmax of K/V tile j in the log2 domain, in place: sc
      // becomes the unrounded weights, m and l move on, alpha rescales O.
      auto softmax = [&](int j, float (&alpha)[2]) {
        if ((j + 1) * BK > t) {  // the ragged last tile: keys past t score -inf
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (j * BK + 8 * (i / 4) + 2 * tq + (i & 1) >= t) sc[i] = -INFINITY;
        }
        // A row's max and sum run as four independent chains (element
        // 4 q + 2 r + c of row r goes to chain 2 (q & 1) + c), so that the
        // FMNMX and FADD latencies are not paid 32 times in a row.
        float mx[2][4], ls[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) mx[r][k] = -INFINITY, ls[r][k] = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float& x = mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
          x = fmaxf(x, sc[i]);
        }
        float neg[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float row = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
          row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, 1));
          row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, 2));
          const float m_new = fmaxf(m[r], row * scale_log2e);
          alpha[r] = ex2(m[r] - m_new);
          m[r] = m_new;
          neg[r] = -m_new;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          sc[i] = ex2(fmaf(sc[i], scale_log2e, neg[(i >> 1) & 1]));
          ls[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] += sc[i];
        }
        // this lane's part of the fp32 row sum of the unrounded weights
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[r] = fmaf(l[r], alpha[r], (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
      };
      // P rounded to bf16 is the A operand as it stands: k16 step kk holds
      // n8 blocks 2 kk and 2 kk + 1 of S.
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          p[kk][0] = dtts::pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
          p[kk][1] = dtts::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
          p[kk][2] = dtts::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
          p[kk][3] = dtts::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      // Ping-pong (two consumers on their own rows): a warpgroup issues its
      // products only in its turn (named barrier 1 + w) and then hands the
      // turn over, so one warpgroup's exponentials run while the other's
      // products do.
      auto take_turn = [&]() {
        if constexpr (kPingPong) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
      };
      auto pass_turn = [&]() {
        if constexpr (kPingPong) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
      };
      // O's rescale; alpha is 1 exactly where no row of the warp took a new
      // maximum (most tiles past the first few), and then O stays as it is.
      auto rescale = [&](const float (&alpha)[2]) {
        if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
        for (int i = 0; i < C::kDW / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      };
      auto release = [&](uint32_t bar) {
        if (lane == 0) mbar_arrive(bar);
      };

      if (w == 1) pass_turn();  // warpgroup 0 goes first
      int it = 0;  // K/V tiles consumed so far, over all work tiles
      for (int tile = first, n = 0; tile < work; tile += stride, ++n, it += ntiles) {
        const int q0 = tile % qtiles * kRows, head = tile / qtiles % h;
        const int batch = tile / qtiles / h;
#pragma unroll
        for (int i = 0; i < C::kDW / 2; ++i) acc[i] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
        float alpha[2];

        if (ntiles > 0) {
          mbar_wait(q_full, n & 1);
          mbar_wait(k_full(it % S), (it / S) & 1);
          take_turn();
          wgmma_fence();
          issue_s(sc, it % S);
          wgmma_commit();
          pass_turn();
          wgmma_wait<0>();
          fence_regs(sc);
          release(k_empty(it % S));
          if (ntiles == 1) release(q_empty);  // Q is read: the next tile's may come
          add_halves(it);
          softmax(j0, alpha);
          pack();

          for (int j = 1; j < ntiles; ++j) {
            const int s = (it + j) % S, sp = (it + j - 1) % S;
            // S_j on the tensor cores, then P_{j-1}.V_{j-1} behind it; the
            // softmax of S_j runs while P.V is in flight. O's rescale by the
            // previous tile's alpha runs while S_j does.
            mbar_wait(k_full(s), ((it + j) / S) & 1);
            take_turn();
            fence_regs(acc);
            wgmma_fence();
            issue_s(sc, s);
            wgmma_commit();
            rescale(alpha);
            mbar_wait(v_full(sp), ((it + j - 1) / S) & 1);
            fence_regs(acc);
            wgmma_fence();
            issue_pv(acc, p, sp);
            wgmma_commit();
            pass_turn();
            wgmma_wait<1>();
            fence_regs(sc);
            release(k_empty(s));
            if (j == ntiles - 1) release(q_empty);
            add_halves(it + j);
            softmax(j0 + j, alpha);
            wgmma_wait<0>();
            fence_regs(acc);
            release(v_empty(sp));
            pack();
          }
          const int sl = (it + ntiles - 1) % S;
          mbar_wait(v_full(sl), ((it + ntiles - 1) / S) & 1);
          take_turn();
          rescale(alpha);
          fence_regs(acc);
          wgmma_fence();
          issue_pv(acc, p, sl);
          wgmma_commit();
          // Warpgroup 1 was handed one turn before the first: it hands back all
          // but its last.
          if (w == 0 || tile + stride < work) pass_turn();
          wgmma_wait<0>();
          fence_regs(acc);
          release(v_empty(sl));
        }

        if constexpr (SPLIT > 1) {
          // This CTA's partial, over the ring (its last tile is read and no
          // load is in flight: a cluster takes one work tile).
          float* xo = reinterpret_cast<float*>(smem_ptr(k_s));
          float2* xml = reinterpret_cast<float2*>(xo + 64 * C::kXPitch);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            const int row = 16 * warp + g + 8 * r;
            if (tq == 0) xml[row] = make_float2(m[r], l[r]);
#pragma unroll
            for (int j = 0; j < C::kDW / 8; ++j)
              *reinterpret_cast<float2*>(xo + row * C::kXPitch + 8 * j + 2 * tq) =
                  make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
          }
          continue;
        }
        bf16* ob = o + batch * out_sb + head * out_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          const int row = q0 + row0 + 16 * warp + g + 8 * r;
          if (row >= t) continue;
          // Training: the row's log2-sum-exp2 of the scaled scores, [B, H, T].
          if (lse != nullptr && tq == 0 && (!kColumns || w == 0))
            lse[((int64_t)batch * h + head) * t + row] = m[r] + log2f(l[r]);
          const float inv = 1.f / l[r];
#pragma unroll
          for (int j = 0; j < C::kDW / 8; ++j) {
            const int col = col0 + 8 * j + 2 * tq;
            if (col < D)
              *reinterpret_cast<__nv_bfloat162*>(ob + row * out_st + col) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
          }
        }
      }

    };
    if constexpr (kColumns) {
      if (w == 0) consume(Constant<0>{});
      else consume(Constant<1>{});
    } else {
      consume(w);
    }
  }

  if constexpr (SPLIT > 1) {
    dtts::cluster_sync();  // every CTA's partial is written
    const int q0 = first % qtiles * 64, head = first / qtiles % h, batch = first / qtiles / h;
    const uint32_t xo = k_s, xml = k_s + 64 * C::kXPitch * 4;
    // Each row's weight of each partial, exp2(m_i - M) / L, in Q's slot
    // (no one reads Q now).
    float* coef = reinterpret_cast<float*>(smem_ptr(q_s));  // [64][SPLIT]
    const int tid = threadIdx.x;
    if (tid < 64) {
      float mi[SPLIT], li[SPLIT], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) {
        const float2 v = dtts::ld_dsmem_f32x2(dtts::dsmem_addr(xml + 8 * tid, i));
        mi[i] = v.x, li[i] = v.y;
        mx = fmaxf(mx, v.x);
      }
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) {
        mi[i] = exp2f(mi[i] - mx);  // 0 for a CTA without keys (m = -inf)
        sum = fmaf(li[i], mi[i], sum);
      }
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) coef[tid * SPLIT + i] = mi[i] * inv;
      if (lse != nullptr && rank == 0 && q0 + tid < t)
        lse[((int64_t)batch * h + head) * t + q0 + tid] = mx + log2f(sum);
    }
    __syncthreads();
    if (tid < 128) {
      // The consumer warpgroup's threads merge this CTA's columns of O, 4
      // floats an item: every item's loads are issued before the first is
      // used, so that the round trips to the other SMs overlap.
      constexpr int kCols = C::kDP / SPLIT, kVecs = kCols / 4, kItems = 64 * kVecs / 128;
      float4 x[kItems][SPLIT];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int e = tid + 128 * k, row = e / kVecs, col = rank * kCols + 4 * (e % kVecs);
#pragma unroll
        for (int i = 0; i < SPLIT; ++i)
          x[k][i] = dtts::ld_dsmem_f32x4(dtts::dsmem_addr(xo + 4u * (row * C::kXPitch + col), i));
      }
      bf16* ob = o + batch * out_sb + head * out_sh;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int e = tid + 128 * k, row = e / kVecs, col = rank * kCols + 4 * (e % kVecs);
        if (q0 + row >= t) continue;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < SPLIT; ++i) {
          const float c = coef[row * SPLIT + i];
          y.x = fmaf(c, x[k][i].x, y.x), y.y = fmaf(c, x[k][i].y, y.y);
          y.z = fmaf(c, x[k][i].z, y.z), y.w = fmaf(c, x[k][i].w, y.w);
        }
        *reinterpret_cast<uint2*>(ob + (int64_t)(q0 + row) * out_st + col) =
            make_uint2(dtts::pack_bf16x2(y.x, y.y), dtts::pack_bf16x2(y.z, y.w));
      }
    }
    dtts::cluster_sync();  // the others have read this CTA's partial
  }
}


// The (d, H, T, B) map of one of q, k, v, whose boxes are kBW columns of
// `rows` tokens of one head; columns past d and tokens past t read as zero.
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int b, int h, int t, int64_t sb, int64_t st,
               int64_t sh, int rows) {
  using C = WgTiles<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kBW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = C::kBW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::kBW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  // OOB_FILL_NONE fills the columns past d and the tokens past t with zeros.
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}


template <int D, int NC, int BK>
cudaError_t launch_wgmma_nc(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                            void* o, int b, int h, int t, int64_t out_sb, int64_t out_st,
                            int64_t out_sh, float scale_log2e, float* lse, cudaStream_t stream) {
  const int smem = WgTiles<D, BK>::smem_bytes(NC);
  cudaError_t err = cudaFuncSetAttribute(attention_wgmma_kernel<D, NC, BK, 1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = tile_rows<D, NC>();
  const int work = (t + rows - 1) / rows * h * b;  // work tiles
  const int blocks = work < sm_count() ? work : sm_count();
  constexpr int threads = wgmma_threads<D, NC>();
  attention_wgmma_kernel<D, NC, BK, 1><<<blocks, threads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), h, t, work, out_sb, out_st, out_sh, scale_log2e, lse);
  return cudaGetLastError();
}

// A key split of SPLIT CTAs a work tile (d = 256): clusters of SPLIT, one
// work tile each, launched with the cluster dimension; a refused launch
// returns its error.
template <int D, int BK, int SPLIT>
cudaError_t launch_wgmma_split(const CUtensorMap& qm, const CUtensorMap& km,
                               const CUtensorMap& vm, void* o, int b, int h, int t,
                               int64_t out_sb, int64_t out_st, int64_t out_sh, float scale_log2e,
                               float* lse, cudaStream_t stream) {
  const int smem = WgTiles<D, BK>::smem_bytes(1);
  cudaError_t err = cudaFuncSetAttribute(attention_wgmma_kernel<D, 1, BK, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int work = (t + 63) / 64 * h * b;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(work * SPLIT, 1, 1);
  cfg.blockDim = dim3(wgmma_threads<D, 1>(), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = SPLIT;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_wgmma_kernel<D, 1, BK, SPLIT>, qm, km, vm,
                           static_cast<bf16*>(o), h, t, work, out_sb, out_st, out_sh, scale_log2e,
                           lse);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int h, int t,
                 int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t out_sb, int64_t out_st,
                 int64_t out_sh, float scale_log2e, float* lse, int split, int nc,
                 cudaStream_t stream) {
  // K/V tile keys; 64 at t <= 64 where the width's tiles are longer
  constexpr int kBK = WgTiles<D>::kBK, kShortBK = 64;
  const int bk = t <= 64 && kBK > kShortBK ? kShortBK : kBK;
  CUtensorMap qm, km, vm;
  int err = encode_map<D>(&qm, q, b, h, t, in_sb, in_st, in_sh, 64);
  if (err == 0) err = encode_map<D>(&km, k, b, h, t, in_sb, in_st, in_sh, bk);
  if (err == 0) err = encode_map<D>(&vm, v, b, h, t, in_sb, in_st, in_sh, bk);
  if (err != 0) return err;
  // The caller's plan (ops/kernels/qkv_attention.py::wgmma_plan).
  if constexpr (D == 512) {
    // One plan: two consumer warpgroups splitting O's columns, no key
    // split, 32-key tiles at every T.
    if (nc != 2 || split != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma_nc<D, 2, kBK>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                      scale_log2e, lse, stream);
  } else {
    // A key split (d = 256) takes one consumer warpgroup; two take t > 64.
    if ((nc != 1 && nc != 2) || (nc == 2 && (split != 1 || t <= 64)))
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (D == 256) {
      // 64-key tiles; the key split the caller chose, else one or two
      // consumer warpgroups as at the other widths.
      static_assert(kBK == kShortBK, "d = 256 takes 64-key tiles at every T");
      if (split == 1 && nc == 2)
        return launch_wgmma_nc<D, 2, kBK>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                          scale_log2e, lse, stream);
      if (split == 1)
        return launch_wgmma_nc<D, 1, kBK>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                          scale_log2e, lse, stream);
      if (split == 2)
        return launch_wgmma_split<D, kBK, 2>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                             scale_log2e, lse, stream);
      if (split == 4)
        return launch_wgmma_split<D, kBK, 4>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                             scale_log2e, lse, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
      if (t <= 64)
        return launch_wgmma_nc<D, 1, kShortBK>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                               scale_log2e, lse, stream);
      if (nc == 2)
        return launch_wgmma_nc<D, 2, kBK>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                          scale_log2e, lse, stream);
      return launch_wgmma_nc<D, 1, kBK>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                        scale_log2e, lse, stream);
    }
  }
}

// How many clusters of SPLIT CTAs of the d = 256 kernel the card holds at
// once (one CTA an SM: a cluster needs SPLIT free SMs of one GPC).
template <int SPLIT>
cudaError_t split_clusters(int* clusters) {
  using C = WgTiles<256>;
  const int smem = C::smem_bytes(1);
  cudaError_t err = cudaFuncSetAttribute(attention_wgmma_kernel<256, 1, C::kBK, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(SPLIT, 1, 1);
    cfg.blockDim = dim3(wgmma_threads<256, 1>(), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = SPLIT;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(clusters, attention_wgmma_kernel<256, 1, C::kBK, SPLIT>,
                                         &cfg);
  }
  cudaGetLastError();  // the error is returned; leave none behind for a later check
  return err;
}

// ------------------------------------------------------------- tf32x3 route

// Tile shapes of the tf32x3 route for head width D (64 or 256).
template <int D>
struct Tf32Tiles {
  static constexpr int kBK = D > 128 ? 16 : 32;   // keys per K/V tile
  static constexpr int kBoxes = D / 32;            // 32-float (128-byte) TMA boxes of a row
  static constexpr int kQBytes = 64 * D * 4;       // 64 q rows
  static constexpr int kTileBytes = kBK * D * 4;   // one K or V tile
  static constexpr int kCtas = D > 128 ? 1 : 2;    // blocks an SM
  static constexpr int kThreads = 160;             // a consumer warpgroup and a producer warp
  // Q's hi and lo tiles (TMA writes Q where its hi goes); the K tile as TMA
  // wrote it, its hi and lo; the V tile as TMA wrote it, V^T's hi and lo;
  // five mbarriers.
  static constexpr int kSmemBytes = 1024 + 2 * kQBytes + 6 * kTileBytes + 8 * 5;
  // A key split's partial (O unnormalized, 64 rows kXPitch floats apart, then
  // each row's (m, l)), written over Q's tiles once the last S has read them.
  static constexpr int kXPitch = D + 8;
  static_assert(D % 32 == 0, "rows are whole 128-byte boxes");
  static_assert(kCtas * (kSmemBytes + 1024) <= 233472, "the blocks exceed an SM's shared memory");
  static_assert(64 * kXPitch * 4 + 64 * 8 <= 2 * kQBytes, "a partial fits over Q's tiles");
};

// The fp32 forward on the tensor cores, one block per (batch, head, 64 q
// rows) work tile, or SPLIT > 1 blocks (a cluster) sharing its keys as on the
// wgmma route at d = 256. A producer warp's lane 0 issues the TMA loads: Q
// once, then each K/V tile of BK keys as fp32 into a one-stage raw slot for
// K and one for V, refilled as soon as the consumers have split the tile.
// The consumer warpgroup splits every operand into tf32 hi and lo in shared
// memory (Q's hi in place), so that each product is three tf32 wgmma
// products, lo.hi + hi.lo + hi.hi, the small terms first, in fp32
// accumulators:
//   * Q, K (K-major as they lie: TMA's 128-byte swizzle, which hi and lo keep
//     element for element, so the split is a linear pass of float4s);
//     S = Q.K^T is m64nBKk8 with both operands read through descriptors. (Q's
//     hi and lo as k8 A fragments in registers at d = 64, S from registers,
//     ran 25% slower: PERF.md §6.)
//   * V is MN-major in memory and tf32 wgmma takes K-major B only, so V's
//     split writes V^T: plane kb (4 keys) of D rows of 16 bytes, K-major
//     core matrices without a swizzle (LBO between planes, SBO 128 bytes).
//   * P stays in registers: the accumulator gives a thread S's keys 2t and
//     2t + 1 of each 8-key group, the k8 A fragment wants k = t and t + 4. So
//     the V^T split permutes the keys of each group the same way (k = t holds
//     key 2t, k = t + 4 key 2t + 1: even keys in plane 2s, odd in 2s + 1) and
//     P.V, a sum over keys, is unchanged; no shuffle.
//   * Overlap: the split of K_j runs while P_{j-1}.V_{j-1} does, the split of
//     V_j while S_j does. d = 64 fits two blocks an SM, which measured the
//     same as one: what the SM shares (shared memory's bandwidth: the splits
//     and the products move about 160 KB a 32-key tile) holds it, not the
//     softmax's latency (PERF.md §6).
//   * d = 256: Q's hi and lo take 128 KB, so the K/V tiles are 16 keys
//     (S at m64n16k8, P.V at m64n256k8): 230,464 bytes, one block an SM; O is
//     128 registers a thread of the 255 a 160-thread block may hold. d = 64:
//     32-key tiles, 82,984 bytes.
template <int D, int SPLIT>
__global__ void __launch_bounds__(Tf32Tiles<D>::kThreads, Tf32Tiles<D>::kCtas)
attention_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int h,
                      int t, int64_t out_sb, int64_t out_st, int64_t out_sh, float scale_log2e,
                      float* __restrict__ lse) {
  using C = Tf32Tiles<D>;
  constexpr int BK = C::kBK, kRow = 128;  // bytes of a box's row
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  const uint32_t base = (dtts::smem_addr(tf_smem) + 1023u) & ~1023u;
  const uint32_t q_hi = base, q_lo = q_hi + C::kQBytes;  // [kBoxes][64][32], swizzled
  const uint32_t k_raw = q_lo + C::kQBytes;               // [kBoxes][BK][32], swizzled
  const uint32_t k_hi = k_raw + C::kTileBytes, k_lo = k_hi + C::kTileBytes;
  const uint32_t v_raw = k_lo + C::kTileBytes;            // [kBoxes][BK][32], swizzled
  const uint32_t vt_hi = v_raw + C::kTileBytes;           // [BK / 4][D][4]
  const uint32_t vt_lo = vt_hi + C::kTileBytes;
  const uint32_t bar = vt_lo + C::kTileBytes;
  const uint32_t q_full = bar, k_full = bar + 8u, k_empty = bar + 16u, v_full = bar + 24u,
                 v_empty = bar + 32u;
  auto smem_ptr = [&](uint32_t addr) { return tf_smem + (addr - dtts::smem_addr(tf_smem)); };

  const int qtiles = (t + 63) / 64, tile = blockIdx.x / SPLIT;
  const int q0 = tile % qtiles * 64, head = tile / qtiles % h, batch = tile / qtiles / h;
  // This CTA's K/V tiles [j0, j0 + ntiles): all, or its share of a key split
  // (none where SPLIT exceeds the tiles).
  const int rank = SPLIT == 1 ? 0 : (int)dtts::cluster_ctarank();
  const int kv_tiles = (t + BK - 1) / BK;
  const int j0 = rank * kv_tiles / SPLIT;
  const int ntiles = (rank + 1) * kv_tiles / SPLIT - j0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar + 8u * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int bx = 0; bx < C::kBoxes; ++bx)
        tma_load_4d(q_hi + bx * 64 * kRow, &qmap, q_full, bx * 32, head, q0, batch);
      for (int j = 0; j < ntiles; ++j) {
        const int key0 = (j0 + j) * BK;
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);  // the consumers have split K_{j-1}
        mbar_expect_tx(k_full, C::kTileBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx)
          tma_load_4d(k_raw + bx * BK * kRow, &kmap, k_full, bx * 32, head, key0, batch);
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        mbar_expect_tx(v_full, C::kTileBytes);
        for (int bx = 0; bx < C::kBoxes; ++bx)
          tma_load_4d(v_raw + bx * BK * kRow, &vmap, v_full, bx * 32, head, key0, batch);
      }
    }
  } else {
    const int g = lane >> 2, tq = lane & 3;
    float acc[D / 2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    auto sync_consumers = []() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); };
    // hi and lo of the `n` float4s at src, in the same layout (hi may be src).
    auto split_tile = [&](uint32_t src, uint32_t hi, uint32_t lo, int n) {
      const float4* s = reinterpret_cast<const float4*>(smem_ptr(src));
      float4* dh = reinterpret_cast<float4*>(smem_ptr(hi));
      float4* dl = reinterpret_cast<float4*>(smem_ptr(lo));
#pragma unroll 2
      for (int i = tid; i < n; i += 128) {
        float4 a, b;
        split_tf32(s[i], a, b);
        dh[i] = a;
        dl[i] = b;
      }
    };
    // V^T's hi and lo from the raw V tile: item e is row n = e % D of plane
    // kb = e / D, whose 4 floats are V[8 (kb / 2) + 2 c + (kb & 1)][n], c =
    // 0 ... 3, read through TMA's swizzle (16-byte chunk ^ key % 8). A warp
    // reads 32 columns of one key (one 128-byte row) and writes 512
    // contiguous bytes.
    auto split_v = [&]() {
      const unsigned char* raw = smem_ptr(v_raw);
      float4* dh = reinterpret_cast<float4*>(smem_ptr(vt_hi));
      float4* dl = reinterpret_cast<float4*>(smem_ptr(vt_lo));
#pragma unroll 2
      for (int e = tid; e < BK / 4 * D; e += 128) {
        const int n = e % D, kb = e / D;
        const unsigned char* col = raw + (n / 32) * BK * kRow + (n % 4) * 4;
        float x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = 8 * (kb / 2) + 2 * c + (kb & 1);
          x[c] = *reinterpret_cast<const float*>(col + key * kRow +
                                                 ((((n % 32) >> 2) ^ (key & 7)) << 4));
        }
        float4 a, b;
        split_tf32(make_float4(x[0], x[1], x[2], x[3]), a, b);
        dh[e] = a;
        dl[e] = b;
      }
    };

    // Descriptors of the tiles' starts (Q and K swizzled at 128 bytes, 8-row
    // groups 1024 bytes apart; V^T without a swizzle, its planes 16 D bytes
    // apart, 8-row groups 128); a k8 step adds its byte offset / 16. Each use
    // starts from a copy the compiler cannot see through (see the wgmma route).
    const uint64_t qh_desc = wgmma_desc(q_hi, 16, 8 * kRow, 1);
    const uint64_t ql_desc = wgmma_desc(q_lo, 16, 8 * kRow, 1);
    const uint64_t kh_desc = wgmma_desc(k_hi, 16, 8 * kRow, 1);
    const uint64_t kl_desc = wgmma_desc(k_lo, 16, 8 * kRow, 1);
    const uint64_t vh_desc = wgmma_desc(vt_hi, 16 * D, 128, 0);
    const uint64_t vl_desc = wgmma_desc(vt_lo, 16 * D, 128, 0);
    auto opaque = [](uint64_t x) {
      asm volatile("" : "+l"(x));
      return x;
    };
    // S = Q.K^T: k8 step kk reads box kk / 4 at byte offset (kk % 4) * 32.
    auto issue_s = [&](float (&sc)[BK / 2]) {
      const uint64_t qh = opaque(qh_desc), ql = opaque(ql_desc);
      const uint64_t kh = opaque(kh_desc), kl = opaque(kl_desc);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qo = ((kk / 4) * 64 * kRow + (kk % 4) * 32) >> 4;
        const uint32_t ko = ((kk / 4) * BK * kRow + (kk % 4) * 32) >> 4;
        wgmma_ss_tf32<BK>(sc, ql + qo, kh + ko, kk > 0);
        wgmma_ss_tf32<BK>(sc, qh + qo, kl + ko, 1);
        wgmma_ss_tf32<BK>(sc, qh + qo, kh + ko, 1);
      }
    };
    // O += P.V: k8 step s takes the tile's keys 8 s ... 8 s + 7, planes 2 s
    // and 2 s + 1 of V^T.
    auto issue_pv = [&](const uint32_t (&ph)[BK / 8][4], const uint32_t (&pl)[BK / 8][4]) {
      const uint64_t vh = opaque(vh_desc), vl = opaque(vl_desc);
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        const uint32_t off = (2 * s * 16 * D) >> 4;
        wgmma_rs_tf32<D>(acc, pl[s], vh + off);
        wgmma_rs_tf32<D>(acc, ph[s], vl + off);
        wgmma_rs_tf32<D>(acc, ph[s], vh + off);
      }
    };
    // The online softmax of K/V tile j in the log2 domain, in place: sc
    // becomes the unrounded weights, m and l move on, alpha rescales O.
    // Element i of sc is row g + 8 ((i >> 1) & 1), key j BK + 8 (i / 4) +
    // 2 tq + (i & 1).
    auto softmax = [&](float (&sc)[BK / 2], int j, float (&alpha)[2]) {
      if ((j + 1) * BK > t) {  // the ragged last tile: keys past t score -inf
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (j * BK + 8 * (i / 4) + 2 * tq + (i & 1) >= t) sc[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2e);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2e, -m[(i >> 1) & 1]));
        ls[(i >> 1) & 1] += sc[i];  // the fp32 row sum of the unrounded weights
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], ls[r]);
    };
    auto rescale = [&](const float (&alpha)[2]) {
      if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    // P's k8 A fragments, hi and lo: step s holds keys 2 tq (k = tq) and
    // 2 tq + 1 (k = tq + 4) of the tile's group s, rows g and g + 8.
    auto pack = [&](const float (&sc)[BK / 2], uint32_t (&ph)[BK / 8][4],
                    uint32_t (&pl)[BK / 8][4]) {
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        const float a[4] = {sc[4 * s], sc[4 * s + 2], sc[4 * s + 1], sc[4 * s + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float hi, lo;
          split_tf32(a[r], hi, lo);
          ph[s][r] = __float_as_uint(hi);
          pl[s][r] = __float_as_uint(lo);
        }
      }
    };

    if (ntiles > 0) {
      float sc[BK / 2];
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
      mbar_wait(q_full, 0);
      split_tile(q_hi, q_hi, q_lo, C::kQBytes / 16);
      for (int j = 0; j < ntiles; ++j) {
        // K_j's split (P_{j-1}.V_{j-1} still in flight), then S_j.
        mbar_wait(k_full, j & 1);
        split_tile(k_raw, k_hi, k_lo, C::kTileBytes / 16);
        dtts::fence_proxy_async();  // the splits' stores, before the products read them
        sync_consumers();
        if (tid == 0) mbar_arrive(k_empty);
        wgmma_fence();
        issue_s(sc);
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();  // P_{j-1}.V_{j-1} is done: V^T may be written anew
          fence_regs(acc);
        }
        // V_j's split while S_j runs.
        mbar_wait(v_full, j & 1);
        split_v();
        dtts::fence_proxy_async();
        sync_consumers();
        if (tid == 0) mbar_arrive(v_empty);
        wgmma_wait<0>();
        fence_regs(sc);
        float alpha[2];
        softmax(sc, j0 + j, alpha);
        rescale(alpha);
        pack(sc, ph, pl);
        wgmma_fence();
        issue_pv(ph, pl);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }

    if constexpr (SPLIT > 1) {
      // This CTA's partial, over Q's tiles (the last S has read them).
      float* xo = reinterpret_cast<float*>(smem_ptr(q_hi));
      float2* xml = reinterpret_cast<float2*>(xo + 64 * C::kXPitch);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = 16 * warp + g + 8 * r;
        if (tq == 0) xml[row] = make_float2(m[r], l[r]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(xo + row * C::kXPitch + 8 * j + 2 * tq) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    } else {
      float* ob = o + batch * out_sb + head * out_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = q0 + 16 * warp + g + 8 * r;
        if (row >= t) continue;
        // Training: the row's log2-sum-exp2 of the scaled scores, [B, H, T].
        if (lse != nullptr && tq == 0)
          lse[((int64_t)batch * h + head) * t + row] = m[r] + log2f(l[r]);
        const float inv = 1.f / l[r];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(ob + row * out_st + 8 * j + 2 * tq) =
              make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }

  if constexpr (SPLIT > 1) {
    // The merge of the wgmma route's key split, in fp32: every CTA weighs
    // the partials in rank order and writes its share of O's columns.
    dtts::cluster_sync();  // every CTA's partial is written
    const uint32_t xo = q_hi, xml = q_hi + 64 * C::kXPitch * 4;
    float* coef = reinterpret_cast<float*>(smem_ptr(k_raw));  // [64][SPLIT]; no load is left
    if (tid < 64) {
      float mi[SPLIT], li[SPLIT], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) {
        const float2 v = dtts::ld_dsmem_f32x2(dtts::dsmem_addr(xml + 8 * tid, i));
        mi[i] = v.x, li[i] = v.y;
        mx = fmaxf(mx, v.x);
      }
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) {
        mi[i] = exp2f(mi[i] - mx);  // 0 for a CTA without keys (m = -inf)
        sum = fmaf(li[i], mi[i], sum);
      }
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) coef[tid * SPLIT + i] = mi[i] * inv;
      if (lse != nullptr && rank == 0 && q0 + tid < t)
        lse[((int64_t)batch * h + head) * t + q0 + tid] = mx + log2f(sum);
    }
    __syncthreads();
    if (tid < 128) {
      constexpr int kCols = D / SPLIT, kVecs = kCols / 4, kItems = 64 * kVecs / 128;
      float4 x[kItems][SPLIT];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int e = tid + 128 * k, row = e / kVecs, col = rank * kCols + 4 * (e % kVecs);
        const uint32_t at = xo + 4u * (row * C::kXPitch + col);
#pragma unroll
        for (int i = 0; i < SPLIT; ++i) x[k][i] = dtts::ld_dsmem_f32x4(dtts::dsmem_addr(at, i));
      }
      float* ob = o + batch * out_sb + head * out_sh;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int e = tid + 128 * k, row = e / kVecs, col = rank * kCols + 4 * (e % kVecs);
        if (q0 + row >= t) continue;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < SPLIT; ++i) {
          const float c = coef[row * SPLIT + i];
          y.x = fmaf(c, x[k][i].x, y.x), y.y = fmaf(c, x[k][i].y, y.y);
          y.z = fmaf(c, x[k][i].z, y.z), y.w = fmaf(c, x[k][i].w, y.w);
        }
        *reinterpret_cast<float4*>(ob + (int64_t)(q0 + row) * out_st + col) = y;
      }
    }
    dtts::cluster_sync();  // the others have read this CTA's partial
  }
}

// The (d, H, T, B) fp32 map of one of q, k, v: boxes of 32 columns (128
// bytes, swizzled at 128) of `rows` tokens of one head; tokens past t read
// as zero.
int encode_map_f32(CUtensorMap* map, const void* ptr, int d, int b, int h, int t, int64_t sb,
                   int64_t st, int64_t sh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)st * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

// One launch of the tf32x3 kernel: work tiles x SPLIT blocks, in clusters of
// SPLIT where SPLIT > 1; a refused launch returns its error.
template <int D, int SPLIT>
cudaError_t launch_tf32_split(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                              void* o, int b, int h, int t, int64_t out_sb, int64_t out_st,
                              int64_t out_sh, float scale_log2e, float* lse,
                              cudaStream_t stream) {
  using C = Tf32Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_tf32_kernel<D, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int work = (t + 63) / 64 * h * b;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(work * SPLIT, 1, 1);
  cfg.blockDim = dim3(C::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = SPLIT;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, attention_tf32_kernel<D, SPLIT>, qm, km, vm,
                           static_cast<float*>(o), h, t, out_sb, out_st, out_sh, scale_log2e, lse);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int b, int h, int t,
                int64_t in_sb, int64_t in_st, int64_t in_sh, int64_t out_sb, int64_t out_st,
                int64_t out_sh, float scale_log2e, float* lse, int split, int nc,
                cudaStream_t stream) {
  // One consumer warpgroup; a key split (2 or 4) at d = 256 only.
  if (nc != 1 || (split != 1 && (D != 256 || (split != 2 && split != 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  constexpr int bk = Tf32Tiles<D>::kBK;
  int err = encode_map_f32(&qm, q, D, b, h, t, in_sb, in_st, in_sh, 64);
  if (err == 0) err = encode_map_f32(&km, k, D, b, h, t, in_sb, in_st, in_sh, bk);
  if (err == 0) err = encode_map_f32(&vm, v, D, b, h, t, in_sb, in_st, in_sh, bk);
  if (err != 0) return err;
  if (split == 2)
    return launch_tf32_split<D, D == 256 ? 2 : 1>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                                  scale_log2e, lse, stream);
  if (split == 4)
    return launch_tf32_split<D, D == 256 ? 4 : 1>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh,
                                                  scale_log2e, lse, stream);
  return launch_tf32_split<D, 1>(qm, km, vm, o, b, h, t, out_sb, out_st, out_sh, scale_log2e,
                                 lse, stream);
}

}  // namespace

// The number of clusters of `split` (2 or 4) CTAs of the d = 256 wgmma
// kernel that the card can run at once, into *clusters (0: none fits).
extern "C" int dtts_attention_split_clusters(int split, int* clusters) {
  if (split == 2) return static_cast<int>(split_clusters<2>(clusters));
  if (split == 4) return static_cast<int>(split_clusters<4>(clusters));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16; d: the head width, one of 4, 8, 16,
// 32, 40, 64, 80, 160, 256, 512. Strides are in elements, the head width's stride being 1.
// lse: null when serving; when training, an fp32 [B, H, T] buffer that takes
// each row's log2-sum-exp2 of the scaled scores for the backward kernels
// (csrc/attention_bwd.cu). route: 0 = fma (any dtype and width), 1 = mma
// (bfloat16 at d = 16, 32, 40, 64, 80, 160, 256, 512, every pointer and stride
// 16-byte aligned), 2 = wgmma (bfloat16 at d = 40, 64, 80, 160, 256, 512,
// aligned the same way), 3 = tf32x3 (float32 at d = 64, 256, aligned the same
// way). split: CTAs sharing each work tile's keys, 1, or 2 or 4 on the wgmma
// and tf32x3 routes at d = 256 (a thread-block cluster a tile).
// consumers: consumer warpgroups a block, 1, or 2 on the wgmma route without
// a split at t > 64; at d = 512 always 2, the two halves of O's columns
// (ops/kernels/qkv_attention.py::wgmma_plan picks both); 1 on tf32x3
// (ops/kernels/qkv_attention.py::tf32x3_plan). Any other plan is
// refused. Returns the launch's cudaError_t (0 on success), or
// kEncodeFailed + the CUresult of a refused tensor map; the caller raises on
// anything but 0.
extern "C" int dtts_attention(const void* q, const void* k, const void* v, void* o,
                              int dtype, int d, int b, int h, int t, int64_t in_sb,
                              int64_t in_st, int64_t in_sh, int64_t out_sb, int64_t out_st,
                              int64_t out_sh, float scale_log2e, float* lse, int route,
                              int split, int consumers, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 3) {
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
#define DTTS_ATTN_TF32X3(D)                                                                 \
  case D:                                                                                   \
    return launch_tf32<D>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb, out_st, out_sh, \
                          scale_log2e, lse, split, consumers, s);
    switch (d) {
      DTTS_ATTN_TF32X3(64)
      DTTS_ATTN_TF32X3(256)
    }
#undef DTTS_ATTN_TF32X3
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 2) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define DTTS_ATTN_WGMMA(D)                                                                  \
  case D:                                                                                   \
    return launch_wgmma<D>(q, k, v, o, b, h, t, in_sb, in_st, in_sh, out_sb, out_st, out_sh, \
                           scale_log2e, lse, split, consumers, s);
    switch (d) {
      DTTS_ATTN_WGMMA(40)
      DTTS_ATTN_WGMMA(64)
      DTTS_ATTN_WGMMA(80)
      DTTS_ATTN_WGMMA(160)
      DTTS_ATTN_WGMMA(256)
      DTTS_ATTN_WGMMA(512)
    }
#undef DTTS_ATTN_WGMMA
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (split != 1 || consumers != 1) return static_cast<int>(cudaErrorInvalidValue);
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
