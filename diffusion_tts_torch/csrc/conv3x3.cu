// 3x3 SAME stride-1 conv with a normalize+SiLU prologue and a fused
// epilogue, and nearest-2x upsample + 3x3 conv, for Hopper (sm_90a), plain C
// interface, contiguous NCHW activations, two routes.
//
// Replaces the TPU kernels _conv3_stacked_kernel / _conv3_kernel behind
// diffusion_tts_tpu/ops/pallas/conv3x3.py::conv3x3_same and _conv3_up2_kernel
// behind ::conv3x3_up2. Same functions:
//
//   conv3x3_same   out[b,k,y,x] = round( sum_{c,dy,dx} w[k,c,dy,dx] * xn[b,c,y+dy-1,x+dx-1]
//                                        + bias[k] + residual[b,k,y,x]
//                                        + sum_c sc_w[k,c] * sc_x[b,c,y,x] )
//     with xn = x, or, with the prologue, xn = round(silu(float(x) * scale[b,c]
//     + shift[b,c])) rounded to the activation dtype before the product.
//     SAME padding pads xn, not x: a tap that falls outside the image
//     contributes 0 (not silu(shift)), so the prologue runs on in-range
//     pixels only. Products of activation-dtype operands accumulate in fp32;
//     bias, residual and the 1x1 shortcut product join in fp32; the output is
//     rounded once. residual and shortcut exclude each other.
//   conv3x3_up2    out[b,k,2i+a,2j+e] = round( sum_{c,r,s} wp[a,e][k,c,r,s]
//                                        * x[b,c,i+a-1+r,j+e-1+s] + bias[k] )
//     the four 2x2 phase convs of conv3x3(nearest_up2(x)) on the un-upsampled
//     input (16 MACs per 2x2 output block instead of 36), the taps folded in
//     fp32 and rounded once to the activation dtype by the caller, each
//     result stored at its interleaved place in [B,K,2H,2W]: no upsampled
//     input, no phase-major intermediate, no interleave pass.
//
// What bounds them on this card: operations. A call does 2*B*H*W*(9C+Cres)*K
// (32*B*H*W*C*K for up2) FLOPs on B*H*W*(C+Cres+2K) activations and
// (9C+Cres)*K weights, thousands of FLOPs per byte at the VAE decoder's
// shapes, far above the H100's 295 FLOP/byte bf16 balance point.
//
// Routes. The caller picks one (ops/kernels/conv3x3.py::same_route for
// conv3x3_same, ::up2_route for conv3x3_up2) and this file obeys:
//   * wgmma (route 2): bf16 with C a multiple of 16, Cres of 32 and W of 8,
//     on conv3x3_same: every shape of the SD decoder and encoder. Hopper's
//     warpgroup products fed by TMA, below. K and H are any.
//   * up2 wgmma (route 2 of conv3x3_up2): bf16 with C a multiple of 16 and W of 8,
//     every up-conv of the SD decoder (conv3_up2_wgmma_kernel, after
//     conv3x3_same's). K and H are any.
//   * ring (route 1): bf16 with C and Cres multiples of 16 and W a multiple of 8,
//     every shape of the SD decoder (C, K 128-512, W 64-512). K and H are any.
//     Forced, chip_smoke.py times it beside wgmma on either function.
//   * v1 (route 0): fp32 (FMA on the CUDA cores, so that it holds 1e-4
//     against an fp32 reference with TF32 off; a TF32 product would not), and
//     bf16 at ragged C, Cres or W, which no path of the port has. Its bf16
//     body is also kept for chip_smoke.py's v1_ms, the first design timed
//     beside the ring on the same inputs.
//
// The wgmma route (conv3_wgmma_kernel) is an implicit GEMM with M = output
// channels, N = output pixels, depth 9 C (+ Cres):
//   * A tile is 64 channels x 3 output rows x 128 columns of one image.
//     Persistent blocks (one an SM) walk the tiles, the channel block
//     fastest, so the blocks in flight read the same input rows from L2.
//   * Roles: one producer warp (one lane issues every TMA load) and three
//     consumer warpgroups (one output row each, m64n128k16 products, 64 fp32
//     accumulators a thread). Each consumer warp issues a stage's products,
//     frees the stage before, then transforms its twelfth of the next
//     stage's operand patch while the tensor pipe runs the products. (A
//     dedicated transform warpgroup, one warp a sub-partition, could not
//     keep up: it held a [4,512,128,128,512] call on an H100 at 1.05-1.20
//     ms, 2.5x the products alone; issuing the taps in three groups with a
//     third of the transform between them was 13% slower than one group.)
//   * Rings of 4 weight slots, 2 raw slots and 2 operand patches, each with
//     full and empty mbarriers, let the producer run up to 3 stages ahead,
//     across tiles too: the next tile's loads and first patch are under way
//     during a tile's epilogue. No split of the depth, no atomics: two calls
//     give the same bits. Every waiter waits on every phase of a barrier in
//     order (a parity wait two phases ahead would see the phase before it as
//     complete).
//   * A conv stage is 16 input channels under all 9 taps. Weights: a 3-D
//     tensor map over the packed [9, K, C] weights, one box of 16 channels x
//     64 rows x 9 taps, 32-byte swizzled (the K-major layout wgmma reads), 18
//     KB. Raw input: a 4-D map over NCHW x, one box of 152 columns (x0 - 8 ..
//     x0 + 143: the box's innermost start must be 16-byte aligned) x 5 rows x
//     16 channels, 24 KB; the copy zero-fills out-of-image coordinates.
//   * The consumer warps turn the raw rows into the B operand: per row
//     and 16-pixel group, ldmatrix.x4 reads 16 channels x 16 pixels, the
//     prologue runs in fp32 with one rounding (0 outside the image, by
//     position, as on the ring), and stmatrix.x4.trans writes 16 pixels of
//     16 bytes (8 channels) each. The patch is [8-channel chunk][5 x 144
//     pixels][8 channels] (pixel i is column x0 - 8 + i) with no swizzle: 8
//     consecutive pixels are one core matrix (SBO 128 bytes), the chunks LBO
//     = 11520 bytes apart, and pixel p + 1 lies 16 bytes after pixel p, so
//     tap (dy, dx) of output row r is the descriptor of pixel (r + dy) * 144
//     + 7 + dx: no copy per tap. The raw slot's channels are 1520 bytes (95
//     16-byte units, odd) apart, so each ldmatrix is free of bank conflicts,
//     and the stores are whole 128-byte rows.
//   * A shortcut stage is 32 channels of sc_x at the output pixels: sc_w by a
//     2-D map (boxes of 32 channels x 64 rows, 64-byte swizzle) and, per
//     output row, two boxes of 64 pixels x 32 channels of sc_x (128-byte
//     swizzle), which wgmma reads as they land as an MN-major B operand
//     (transpose flag; LBO 4096 between the two 64-pixel halves, SBO 1024
//     between 8-channel groups). No transform.
//   * The epilogue goes through a staging tile per consumer warpgroup (its
//     row's 64 channels x 128 columns, bf16, two 128-byte-swizzled TMA
//     boxes): one lane TMA-loads the residual rows there at the tile's
//     second stage, the warps read them by ldmatrix, add bias and residual
//     to the accumulators in fp32, round once and write the tile back by
//     stmatrix, and one lane stores it by TMA (16-byte accesses and clipping
//     by the copy, where the accumulators' own layout would store 4 bytes a
//     lane and read the residual 4 bytes at a time with its whole latency
//     exposed).
//   * Shared memory: 1024 bytes of alignment slack, 4 x 18,432 (weights), 2 x
//     24,576 (raw rows, the prologue's scales and shifts, or the shortcut's
//     boxes), 3 x 16,384 (staging tiles), 2 x 23,040 (patches) and the
//     mbarriers: 219,288 bytes of the 232,448 a block may have; one block
//     (416 threads) an SM. (4 weight slots took 2-9% less time than 3 with 3
//     raw slots but at the shortcut's calls, 6% more there; 2 weight slots
//     took 1.6x as long.)
//   * ptxas's registers and spills of the four variants (prologue or not,
//     shortcut or not) are printed by chip_smoke.py after the build.
//   * Nothing gives way: a refused encode, launch or misaligned operand is an
//     error (the wrapper raises), never a fall back to the ring.
//
// The ring and v1 are implicit GEMMs: a block computes a tile of output channels
// x output pixels of one image (up2: of one phase, the phase from the grid)
// with 256 threads (eight warps), looping over stages of 16 input channels
// (the shortcut's: 64); each tap of a stage is one shifted read of a patch of
// the input. bf16 products run on mma.sync m16n8k16 (bf16 operands, fp32
// accumulators: exactly the arithmetic above). The fused 1x1 shortcut is
// further stages of the same loop over sc_x with the centre tap only. Ragged
// K and H (and in v1 C, W) are masked.
//
// What held v1 back (the first design: 128 channels x (4 x 32) pixels, warps of
// 64 channels x 32 pixels; 150-185 TFLOP/s at the large shapes):
//   1. one 16-channel stage in flight: barrier, weights by cp.async, the
//      haloed patch by synchronous global loads normalized in registers, wait,
//      barrier, products; nothing is in flight while a block multiplies (the
//      only overlap is the second block on the SM);
//   2. few products per stage where a stage has few taps: up2's 4 taps, the
//      shortcut's 1 tap (with a haloed patch) per 16 channels;
//   3. fragments by 32-bit shared loads: 16 per warp for a tap's A, two per
//      n-block for B;
//   4. a scattered epilogue: each accumulator one 2-byte store, a warp
//      instruction touching 8 channel planes, the residual read alike;
//   5. __launch_bounds__(256, 2): 128 registers, and an 80-byte spill in bf16;
//   6. traffic per MAC: a stage brings 37 KB of weights from L2 (and 9 KB of
//      raw rows) for 2.4M MACs, and its warps read 24 KB of fragments from
//      shared memory per tap for 262K MACs. A ring on v1's tile (1 - 5
//      repaired) ran no faster than v1 at the plain 3x3 shapes.
//
// What the ring does about each:
//   1. A ring of three shared-memory slots filled by 16-byte cp.async. A slot
//      holds the stage's weights straight in the operand layout and its raw
//      input rows in NCHW order, each channel row as the six 16-byte chunks
//      of columns [x0 - 8, x0 + 40), so both halo columns come in whole
//      aligned chunks; chunks outside the image are zero-filled by the copy
//      (and so are rows past K). The prologue's scale and shift ride in the
//      slot too. The raw rows of a landed stage become a [pixel][channel]
//      operand patch (two of them, alternating): prologue in fp32, one
//      rounding, and zero where the pixel lies outside the image, decided by
//      position (silu(shift) != 0, so the zero-filled chunk is not enough).
//      While stage s is multiplied, stage s + 1 is transformed (each warp
//      before its own products: a warp done transforming multiplies beside
//      warps still at their MUFU work) and stage s + 2 is in flight: one
//      barrier a stage. SiLU
//      is h + h tanh(h), h = z / 2: one tanh.approx where the exponential
//      and the divide take two.
//   2. Stage kinds sized to carry a full set of products between barriers:
//      3x3: 16 channels x 9 taps; up2: 16 channels x the phase's 4 taps;
//      shortcut: 64 channels of sc_x under the centre tap, over the output
//      pixels with no halo (4 k16 steps), its raw rows ([channel][256 + 8])
//      being the B operand as they stand: no transform.
//   3. Fragments by ldmatrix.x4 (load_a_swizzled for the weights,
//      mma_bf16.cuh's load_b2 for the patch and load_b2_trans for the
//      shortcut's raw rows).
//      A tap's shift moves the B base by whole patch pixels, so every
//      ldmatrix row stays 16-byte aligned. Conflict-free without padding on
//      the weights: 16-channel rows (2 chunks) store chunk v at v ^ ((row /
//      4) % 2), 64-channel rows (8 chunks) at v ^ (row % 8). Padding
//      elsewhere: patch pixels 24 elements (12 words: eight consecutive pixels
//      in eight distinct 4-bank groups); shortcut channel rows 264 (132
//      words); raw channel rows 496, which puts the two channels that a
//      quarter-warp of the transform reads 16 banks apart. The transform's
//      lanes start at rotated pixel pairs, so its 32-bit stores are
//      conflict-free too.
//   4. An epilogue through shared memory: the fp32 accumulators plus bias go
//      into the ring's memory as a [channels][256 + 8 pixels] tile (3x3: all
//      128 channels at once; up2: 64 at a time); each group of four lanes
//      then writes a whole 32-pixel output row of one channel as 16-byte
//      stores, the residual read as 16-byte vectors and added in fp32 before
//      the one rounding. up2 writes a row of 32 results on every other output
//      column: 2-byte stores at a 4-byte stride, 128 bytes a warp.
//   5. __launch_bounds__(256, 1): one block per SM, 255 registers a thread.
//      The 128 accumulators of 6. leave little room, so: the prologue and
//      the shortcut are template parameters (four 3x3 kernels and up2), the
//      copy loops stay rolled, the transform runs before the taps, and the
//      conv's and the shortcut's stages are two loops. No kernel spills.
//   6. The block tile is 128 channels x (8 rows x 32 columns), warps of 64
//      channels x (2 rows x 32 columns): 128 accumulators a thread. A stage
//      brings 37 KB of weights and 15 KB of raw rows for 4.7M MACs (1.8x
//      fewer bytes per MAC than on v1's tile), and a tap's fragments are 32
//      KB per 524K MACs (1.5x fewer).
// Shared memory per block: 3 slots of 52,864 bytes (3x3: weights 36,864, raw
// rows 15,872, scale/shift 128; a shortcut stage's 50,176 fits in a slot) +
// 2 patches of 16,320 = 191,232; up2: 3 x 32,256 (16,384 + 15,872) + 2 x
// 16,320 = 129,408; of the 232,448 a block may have.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 128;             // output channels per block
constexpr int kTH = 4, kTW = 32;     // output pixels per block: rows x columns
constexpr int kPR = kTH + 2, kPC = kTW + 2;  // the haloed input patch
constexpr int kCC = 16;              // input channels per stage of the conv's own taps
constexpr int kMaxTaps = 9;
// The ring route's conditions (beside bf16): C and Cres multiples of
// kRingChannels, W a multiple of kRingWidth (whole 16-byte chunks).
constexpr int kRingChannels = 16, kRingWidth = 8;

// v1, the first design (route 0). Per dtype: the shared-memory pitches in
// elements (XP of a patch pixel's channels, WP of a weight row's channels)
// and the blocks that share an SM.
template <typename T> struct Config;
template <> struct Config<__nv_bfloat16> { static constexpr int XP = 24, WP = 24, kBlocks = 2; };
template <> struct Config<float> { static constexpr int XP = 17, WP = 20, kBlocks = 1; };

struct ConvArgs {
  const void* x;         // [B, C, H, W]
  const void* w;         // [taps, K, C] (same: 9 taps; up2: 4 phases x 4 taps)
  const void* bias;      // [K] or null
  const void* residual;  // [B, K, H, W] or null
  const float* gn_scale; // [B, C] or null
  const float* gn_shift; // [B, C] or null
  const void* sc_x;      // [B, Cres, H, W] or null
  const void* sc_w;      // [K, Cres] or null
  void* out;             // [B, K, H, W], or [B, K, 2H, 2W] for up2
  int b, c, k, h, w_, cres, up2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One stage of the block's loop: 16 channels of x under the conv's taps, or
// 16 channels of sc_x under the shortcut's single centre tap.
template <typename T>
struct Stage {
  const T* src;        // [B, cin, H, W]
  const T* wsrc;       // [ntaps, K, cin]
  const float* scale;  // the prologue's [B, cin] or null
  int cin, c0, ntaps;
  bool shortcut;
  bool whole;  // all 16 channels and all 128 output channels exist, rows of 16-byte vectors
};

using dtts::cp_async16;
using dtts::cp_async_wait_all;

// ws[(t * kKT + kl) * WP + c] = wsrc[(t * K + k0 + kl) * cin + c0 + c] for
// every tap: asynchronous 16-byte copies for a whole stage (the caller waits
// for them), else element by element with 0 past the last output or input
// channel.
template <typename T>
__device__ __forceinline__ void stage_weights(T* __restrict__ ws, const Stage<T>& st, int k,
                                              int k0, int tid) {
  constexpr int WP = Config<T>::WP;
  constexpr int VEC = 16 / (int)sizeof(T), VPR = kCC / VEC;
  if (st.whole) {
    for (int e = tid; e < st.ntaps * kKT * VPR; e += kThreads) {
      const int v = e % VPR, row = e / VPR;
      cp_async16(ws + row * WP + v * VEC,
                 st.wsrc + ((int64_t)(row / kKT) * k + k0 + row % kKT) * st.cin + st.c0 + v * VEC);
    }
  } else {
    for (int e = tid; e < st.ntaps * kKT * kCC; e += kThreads) {
      const int c = e % kCC, row = e / kCC;
      const int kk = k0 + row % kKT;
      ws[row * WP + c] = (kk < k && st.c0 + c < st.cin)
                             ? st.wsrc[((int64_t)(row / kKT) * k + kk) * st.cin + st.c0 + c]
                             : from_f32<T>(0.f);
    }
  }
}

// The haloed patch of the stage's channels around the tile at (y0, x0), one
// element at a time: xs[(r * kPC + col) * XP + c] holds pixel (y0 - 1 + r,
// x0 - 1 + col), normalized and SiLU'd when the stage has a prologue, 0
// outside the image or past the last channel.
template <typename T>
__device__ __forceinline__ void stage_patch(T* __restrict__ xs, const Stage<T>& st,
                                            const float* __restrict__ shift, int b, int h, int w,
                                            int y0, int x0, int tid) {
  constexpr int XP = Config<T>::XP;
  for (int e = tid; e < kCC * kPR * kPC; e += kThreads) {
    const int c = e / (kPR * kPC), pix = e - c * (kPR * kPC);
    const int r = pix / kPC, col = pix - r * kPC;
    const int gc = st.c0 + c, gy = y0 - 1 + r, gx = x0 - 1 + col;
    T v = from_f32<T>(0.f);
    if (gc < st.cin && gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int64_t plane = (int64_t)b * st.cin + gc;
      v = st.src[(plane * h + gy) * w + gx];
      if (st.scale != nullptr) {
        // two roundings (no fused multiply-add), as the plain version takes them
        const float z = __fadd_rn(__fmul_rn(to_f32(v), st.scale[plane]), shift[plane]);
        v = from_f32<T>(z / (1.f + expf(-z)));
      }
    }
    xs[pix * XP + c] = v;
  }
}

__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// The same patch for a whole bf16 stage whose 32 tile columns lie inside an
// image with 16-byte aligned rows. Warps 0..5: lane (p, rr) takes channels
// 2p and 2p + 1 of 8 pixels of one patch row (warp < 4: row rr, pixels
// 8 warp ..; warps 4, 5: rows 4 and 5), as two 16-byte loads, and writes
// eight 32-bit channel pairs; the four rows of a warp fall in different banks.
// Every thread below 192 then takes one halo element: channel, row, left or
// right column. All loads are issued before any is used.
__device__ __forceinline__ void stage_patch_rows(__nv_bfloat16* __restrict__ xs,
                                                 const Stage<__nv_bfloat16>& st,
                                                 const float* __restrict__ shift, int b, int h,
                                                 int w, int y0, int x0, int tid) {
  constexpr int XP = Config<__nv_bfloat16>::XP;
  const int warp = tid >> 5, lane = tid & 31;
  const bool gn = st.scale != nullptr;
  const int64_t hw = (int64_t)h * w;

  uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
  float sc0 = 1.f, sh0 = 0.f, sc1 = 1.f, sh1 = 0.f;
  bool inside = false;
  const int p = lane & 7, rr = lane >> 3;
  const int r = warp < 4 ? rr : 4 + (rr & 1);
  const int o = warp < 4 ? warp : 2 * (warp - 4) + (rr >> 1);
  if (warp < 6) {
    const int gy = y0 - 1 + r;
    inside = gy >= 0 && gy < h;
    if (inside) {
      const int64_t plane = (int64_t)b * st.cin + st.c0 + 2 * p;
      const __nv_bfloat16* g = st.src + plane * hw + (int64_t)gy * w + x0 + 8 * o;
      v0 = *reinterpret_cast<const uint4*>(g);
      v1 = *reinterpret_cast<const uint4*>(g + hw);
      if (gn) {
        sc0 = st.scale[plane];
        sh0 = shift[plane];
        sc1 = st.scale[plane + 1];
        sh1 = shift[plane + 1];
      }
    }
  }
  const int hc = tid & (kCC - 1), hrow = tid >> 5, hcol = ((tid >> 4) & 1) ? kPC - 1 : 0;
  float hv = 0.f, hsc = 1.f, hsh = 0.f;
  bool hinside = false;
  if (tid < 2 * kCC * kPR) {
    const int gy = y0 - 1 + hrow, gx = x0 - 1 + hcol;
    hinside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    if (hinside) {
      const int64_t plane = (int64_t)b * st.cin + st.c0 + hc;
      hv = __bfloat162float(st.src[plane * hw + (int64_t)gy * w + gx]);
      if (gn) {
        hsc = st.scale[plane];
        hsh = shift[plane];
      }
    }
  }

  if (warp < 6) {
    const __nv_bfloat16* a0 = reinterpret_cast<const __nv_bfloat16*>(&v0);
    const __nv_bfloat16* a1 = reinterpret_cast<const __nv_bfloat16*>(&v1);
    __nv_bfloat16* dst = xs + (r * kPC + 1 + 8 * o) * XP + 2 * p;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float f0 = __bfloat162float(a0[q]), f1 = __bfloat162float(a1[q]);
      if (gn && inside) {
        f0 = silu_fast(__fadd_rn(__fmul_rn(f0, sc0), sh0));
        f1 = silu_fast(__fadd_rn(__fmul_rn(f1, sc1), sh1));
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + q * XP) = __floats2bfloat162_rn(f0, f1);
    }
  }
  if (tid < 2 * kCC * kPR) {
    if (gn && hinside) hv = silu_fast(__fadd_rn(__fmul_rn(hv, hsc), hsh));
    xs[(hrow * kPC + hcol) * XP + hc] = __float2bfloat16(hv);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += one tap's [128 x 16] weights times the patch shifted by (oy, ox).
// bf16: accumulator fragment (i, j) of the warp at (wm, wn) holds channels
// wm * 64 + i * 16 + {g, g + 8} and pixels wn * 32 + j * 8 + {2t, 2t + 1}.
__device__ __forceinline__ void tap_product(float (&acc)[64], const __nv_bfloat16* __restrict__ wt,
                                            const __nv_bfloat16* __restrict__ xs, int oy, int ox,
                                            int tid) {
  constexpr int XP = Config<__nv_bfloat16>::XP, WP = Config<__nv_bfloat16>::WP;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16* ap = wt + (wm * 64 + i * 16 + g) * WP + 2 * t;
    a[i][0] = ld32(ap);
    a[i][1] = ld32(ap + 8 * WP);
    a[i][2] = ld32(ap + 8);
    a[i][3] = ld32(ap + 8 * WP + 8);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat16* bp = xs + ((wn + oy) * kPC + j * 8 + g + ox) * XP + 2 * t;
    const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dtts::mma_bf16(&acc[(i * 4 + j) * 4], a[i], b0, b1);
    }
  }
}

// fp32: thread (ty, tx) holds channels ty + 16 i and pixels tx + 16 j.
__device__ __forceinline__ void tap_product(float (&acc)[64], const float* __restrict__ wt,
                                            const float* __restrict__ xs, int oy, int ox,
                                            int tid) {
  constexpr int XP = Config<float>::XP, WP = Config<float>::WP;
  const int tx = tid & 15, ty = tid >> 4;
  const float* ap = wt + ty * WP;
  const float* bp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = tx + 16 * j;
    bp[j] = xs + (((p / kTW) + oy) * kPC + (p % kTW) + ox) * XP;
  }
#pragma unroll 4
  for (int c = 0; c < kCC; ++c) {
    float av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = ap[16 * i * WP + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = bp[j][c];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
  }
}

// One accumulator to its place: + bias, + residual in fp32, one rounding.
template <typename T>
__device__ __forceinline__ void store_one(const ConvArgs& a, int b, int kk, int y, int x, int pa,
                                          int pe, float v) {
  if (kk >= a.k || y >= a.h || x >= a.w_) return;
  if (a.bias != nullptr) v += to_f32(static_cast<const T*>(a.bias)[kk]);
  const int64_t plane = (int64_t)b * a.k + kk;
  int64_t idx;
  if (a.up2) {
    idx = (plane * (2 * a.h) + 2 * y + pa) * (2 * a.w_) + 2 * x + pe;
  } else {
    idx = (plane * a.h + y) * a.w_ + x;
    if (a.residual != nullptr) v += to_f32(static_cast<const T*>(a.residual)[idx]);
  }
  static_cast<T*>(a.out)[idx] = from_f32<T>(v);
}

// grid (tiles_y * tiles_x, ceil(K / 128), B) or, for up2, (.., .., 4 B) with
// the phase (a, e) = (z & 3) >> 1, z & 1.
template <typename T>
__global__ void __launch_bounds__(kThreads, Config<T>::kBlocks)
conv3_kernel(const ConvArgs a) {
  constexpr int WP = Config<T>::WP;
  constexpr int VEC = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);
  T* xs = ws + kMaxTaps * kKT * WP;

  const int tid = threadIdx.x;
  const int tiles_x = (a.w_ + kTW - 1) / kTW;
  const int x0 = (blockIdx.x % tiles_x) * kTW, y0 = (blockIdx.x / tiles_x) * kTH;
  const int k0 = blockIdx.y * kKT;
  int b = blockIdx.z, pa = 0, pe = 0;
  if (a.up2) {
    pa = (b & 3) >> 1;
    pe = b & 1;
    b >>= 2;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // Stages 0 .. n0 - 1: the conv's own taps over x; n0 .. n0 + n1 - 1: the 1x1
  // shortcut over sc_x.
  const int n0 = (a.c + kCC - 1) / kCC;
  const int n1 = a.sc_x != nullptr ? (a.cres + kCC - 1) / kCC : 0;
  const T* w0 = static_cast<const T*>(a.w);
  if (a.up2) w0 += (int64_t)(2 * pa + pe) * 4 * a.k * a.c;
  const bool rows_whole = std::is_same<T, __nv_bfloat16>::value && a.w_ % VEC == 0 &&
                          x0 + kTW <= a.w_;

  for (int s = 0; s < n0 + n1; ++s) {
    Stage<T> st;
    st.shortcut = s >= n0;
    st.src = static_cast<const T*>(st.shortcut ? a.sc_x : a.x);
    st.wsrc = st.shortcut ? static_cast<const T*>(a.sc_w) : w0;
    st.scale = st.shortcut ? nullptr : a.gn_scale;
    st.cin = st.shortcut ? a.cres : a.c;
    st.c0 = (st.shortcut ? s - n0 : s) * kCC;
    st.ntaps = st.shortcut ? 1 : (a.up2 ? 4 : 9);
    st.whole = st.cin % VEC == 0 && reinterpret_cast<uintptr_t>(st.wsrc) % 16 == 0 &&
               k0 + kKT <= a.k && st.c0 + kCC <= st.cin;

    __syncthreads();  // the previous stage has been consumed
    stage_weights<T>(ws, st, a.k, k0, tid);
    bool rows = false;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      rows = rows_whole && st.whole && reinterpret_cast<uintptr_t>(st.src) % 16 == 0;
      if (rows) stage_patch_rows(xs, st, a.gn_shift, b, a.h, a.w_, y0, x0, tid);
    }
    if (!rows) stage_patch<T>(xs, st, a.gn_shift, b, a.h, a.w_, y0, x0, tid);
    cp_async_wait_all();
    __syncthreads();

    for (int t = 0; t < st.ntaps; ++t) {
      int oy, ox;
      if (st.shortcut) {
        oy = 1;
        ox = 1;
      } else if (a.up2) {
        oy = pa + (t >> 1);
        ox = pe + (t & 1);
      } else {
        oy = t / 3;
        ox = t - 3 * oy;
      }
      tap_product(acc, ws + t * kKT * WP, xs, oy, ox, tid);
    }
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          store_one<T>(a, b, k0 + wm * 64 + i * 16 + g + 8 * (r >> 1), y0 + wn,
                       x0 + j * 8 + 2 * t + (r & 1), pa, pe, acc[(i * 4 + j) * 4 + r]);
  } else {
    const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = tx + 16 * j;
        store_one<T>(a, b, k0 + ty + 16 * i, y0 + p / kTW, x0 + p % kTW, pa, pe,
                     acc[i * 8 + j]);
      }
  }
}

template <typename T>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const size_t bytes =
      (size_t)(kMaxTaps * kKT * Config<T>::WP + kPR * kPC * Config<T>::XP) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      conv3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.h + kTH - 1) / kTH) * ((a.w_ + kTW - 1) / kTW);
  dim3 grid(tiles, (a.k + kKT - 1) / kKT, a.up2 ? 4 * a.b : a.b);
  conv3_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ----------------------------------------------------- route 1: the ring (bf16)

using bf16 = __nv_bfloat16;
using dtts::cp_async_commit;
using dtts::cp_async_wait;

constexpr int kSlots = 3;                         // stages in the ring
constexpr int kRK = 128;                          // output channels per block
constexpr int kRH = 8;                            // output rows per block (of kTW columns)
constexpr int kRPR = kRH + 2;                     // patch rows
constexpr int kRawCols = kTW + 16;                // a raw row: columns x0 - 8 .. x0 + 39
constexpr int kRawPitch = kRPR * kRawCols + 16;   // a raw channel: 496 elements
constexpr int kScPitch = kRH * kTW + 8;           // a shortcut channel: 264 elements
constexpr int kEpiPitch = kRH * kTW + 8;          // an epilogue channel row: 264 floats

// The conv's own stage: 16 channels under all of its taps.
template <bool UP2>
struct ConvStage {
  static constexpr int kTaps = UP2 ? 4 : 9;
  static constexpr int kWeights = kTaps * kRK * kCC;  // elements, rows swizzled
  static constexpr int kRaw = kCC * kRawPitch;        // elements
  static constexpr int kScaleShift = UP2 ? 0 : 2 * kCC;  // floats
  static constexpr int kSlot = (kWeights + kRaw) * 2 + kScaleShift * 4;  // bytes
  static constexpr int P = kCC + 8;                   // patch pixel pitch
  static constexpr int kPatch = kRPR * kPC * P;       // operand patch, elements
};

// The 1x1 shortcut's stage: 64 channels of sc_x under the centre tap.
struct ShortcutStage {
  static constexpr int CC = 64;
  static constexpr int kWeights = kRK * CC;  // rows swizzled
  static constexpr int kSlot = (kWeights + CC * kScPitch) * 2;
};

// Shared memory: kSlots ring slots, then two operand patches.
template <bool UP2>
struct RingSmem {
  static constexpr int kSlot =
      UP2 || ConvStage<UP2>::kSlot >= ShortcutStage::kSlot ? ConvStage<UP2>::kSlot
                                                           : ShortcutStage::kSlot;
  static constexpr int kPatchBytes = ConvStage<UP2>::kPatch * 2;
  static constexpr int kBytes = kSlots * kSlot + 2 * kPatchBytes;
  static_assert(kSlot % 16 == 0 && kPatchBytes % 16 == 0, "16-byte aligned regions");
  // the epilogue tile: all 128 channels at once (3x3), or one half at a time (up2)
  static constexpr int kEpiPasses = UP2 ? 2 : 1;
  static_assert(kRK / kEpiPasses * kEpiPitch * 4 <= kSlots * kSlot, "the epilogue tile fits");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Weight rows of CPR 16-byte chunks are stored with chunk v at position
// v ^ swizzle(row), so that the eight rows of an ldmatrix fall in eight
// distinct 4-bank groups without padding: 2 chunks (16 channels) by
// (row / 4) % 2, 8 chunks (64 channels) by row % 8.
template <int CPR>
__device__ __forceinline__ int swizzled(int row, int v) {
  return row * CPR * 8 + 8 * (v ^ ((row * CPR / 8) % CPR));
}

// The A fragment of rows r0 .. r0 + 15, channels kc .. kc + 15.
template <int CPR>
__device__ __forceinline__ void load_a_swizzled(uint32_t (&f)[4], const bf16* tile, int r0,
                                                int kc, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  dtts::ldmatrix_x4(f, tile + swizzled<CPR>(r, kc / 8 + (lane >> 4)));
}

__device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[4], int k) {
  return k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3];
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// silu(x * scale + shift) with two roundings before it (no fused
// multiply-add), as the plain version takes them; silu(z) = h + h tanh(h)
// with h = z / 2: one MUFU operation where the exponential and the divide
// take two.
__device__ __forceinline__ float prologue(float v, float scale, float shift) {
  const float h = 0.5f * __fadd_rn(__fmul_rn(v, scale), shift);
  return fmaf(h, tanh_approx(h), h);
}

// Where a block is and what it loops over.
struct Block {
  int b, phase, y0, x0, k0, n0, n, tid;
};

// Stage s of the conv's own channels into a slot: the weights of every tap
// ([tap * 128 + k][16], swizzled; rows past K zero-filled), the raw rows
// ([c][row][48] at pitch kRawPitch, chunks outside the image zero-filled)
// and, with the prologue, the stage's scale then shift.
template <bool UP2>
__device__ __forceinline__ void issue_conv(unsigned char* slot, const ConvArgs& a, const Block& k,
                                           int s) {
  using S = ConvStage<UP2>;
  bf16* ws = reinterpret_cast<bf16*>(slot);
  bf16* raw = ws + S::kWeights;
  const bf16* w = static_cast<const bf16*>(a.w) + (UP2 ? (int64_t)k.phase * 4 * a.k * a.c : 0);
  const bf16* x = static_cast<const bf16*>(a.x);
  const int c0 = s * kCC;
#pragma unroll 1  // unrolled, the copies' addresses spill past 255 registers
  for (int e = k.tid; e < S::kTaps * kRK * 2; e += kThreads) {
    const int v = e & 1, row = e >> 1, t = row / kRK, kl = row % kRK;
    const bool ok = k.k0 + kl < a.k;
    cp_async16(ws + swizzled<2>(row, v),
               ok ? w + ((int64_t)t * a.k + k.k0 + kl) * a.c + c0 + 8 * v : w, ok);
  }
#pragma unroll 1  // unrolled, the copies' addresses spill past 255 registers
  for (int e = k.tid; e < kCC * kRPR * 6; e += kThreads) {
    const int q = e % 6, r = (e / 6) % kRPR, c = e / (6 * kRPR);
    const int gy = k.y0 - 1 + r, gx = k.x0 - 8 + 8 * q;
    const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w_;
    cp_async16(raw + c * kRawPitch + r * kRawCols + 8 * q,
               ok ? x + (((int64_t)k.b * a.c + c0 + c) * a.h + gy) * a.w_ + gx : x, ok);
  }
  if (!UP2 && a.gn_scale != nullptr && k.tid < 2 * kCC / 4) {
    constexpr int V = kCC / 4;  // 16-byte chunks of one of the two
    float* ss = reinterpret_cast<float*>(raw + S::kRaw);
    const float* src = k.tid < V ? a.gn_scale : a.gn_shift;
    cp_async16(ss + 4 * k.tid, src + (int64_t)k.b * a.c + c0 + 4 * (k.tid % V));
  }
}

// Stage s of the shortcut: sc_w's [128][64] block (swizzled) and sc_x's 8 x
// 32 pixels of 64 channels ([c][pixel] at pitch kScPitch), zero-filled past
// K, Cres, H and W.
__device__ __forceinline__ void issue_shortcut(unsigned char* slot, const ConvArgs& a,
                                               const Block& k, int s) {
  using S = ShortcutStage;
  bf16* ws = reinterpret_cast<bf16*>(slot);
  bf16* raw = ws + S::kWeights;
  const bf16* w = static_cast<const bf16*>(a.sc_w);
  const bf16* x = static_cast<const bf16*>(a.sc_x);
  const int c0 = s * S::CC;
#pragma unroll 1  // unrolled, the copies' addresses spill past 255 registers
  for (int e = k.tid; e < kRK * S::CC / 8; e += kThreads) {
    const int v = e % (S::CC / 8), kl = e / (S::CC / 8);
    const bool ok = k.k0 + kl < a.k && c0 + 8 * v < a.cres;
    cp_async16(ws + swizzled<S::CC / 8>(kl, v),
               ok ? w + (int64_t)(k.k0 + kl) * a.cres + c0 + 8 * v : w, ok);
  }
#pragma unroll 1  // unrolled, the copies' addresses spill past 255 registers
  for (int e = k.tid; e < S::CC * kRH * (kTW / 8); e += kThreads) {
    const int q = e % (kTW / 8), r = (e / (kTW / 8)) % kRH, c = e / (kRH * kTW / 8);
    const int gy = k.y0 + r, gx = k.x0 + 8 * q;
    const bool ok = c0 + c < a.cres && gy < a.h && gx < a.w_;
    cp_async16(raw + c * kScPitch + r * kTW + 8 * q,
               ok ? x + (((int64_t)k.b * a.cres + c0 + c) * a.h + gy) * a.w_ + gx : x, ok);
  }
}

template <bool UP2, bool SC>
__device__ __forceinline__ void issue_stage(unsigned char* smem, const ConvArgs& a,
                                            const Block& k, int s) {
  if (s < k.n) {
    unsigned char* slot = smem + (s % kSlots) * RingSmem<UP2>::kSlot;
    if (s < k.n0) {
      issue_conv<UP2>(slot, a, k, s);
    } else if constexpr (SC) {
      issue_shortcut(slot, a, k, s - k.n0);
    }
  }
  cp_async_commit();  // one group per stage, empty past the last
}

// The raw rows of a landed conv stage -> an operand patch [10][34][P]: patch
// pixel (r, col) is input pixel (y0 - 1 + r, x0 - 1 + col), channel pairs as
// 32-bit words. The prologue, where there is one, in fp32 with one rounding;
// 0 outside the image. Inner columns: warp task r (r < 10) is one patch
// row, lane (pair, q) the 8 pixels of raw chunk q + 1 of two channels as
// two 16-byte loads; a quarter-warp reads 2 pairs x 4 chunks, 16 banks apart
// by the raw pitch; lane q starts at pixel pair q, so the stores of the four
// q fall in four distinct 8-bank groups. Halo columns: one channel pair of
// one pixel a task, from the other end of the block.
template <bool UP2, bool GN>
__device__ __forceinline__ void transform(bf16* __restrict__ patch, const unsigned char* slot,
                                          const ConvArgs& a, const Block& k) {
  using S = ConvStage<UP2>;
  const bf16* raw = reinterpret_cast<const bf16*>(slot) + S::kWeights;
  const float* ss = reinterpret_cast<const float*>(raw + S::kRaw);
  constexpr bool gn = GN;
  const int warp = k.tid >> 5, lane = k.tid & 31;
  const int q = (lane >> 1) & 3, c = 2 * ((lane & 1) | ((lane >> 3) << 1));
  for (int r = warp; r < kRPR; r += kThreads / 32) {
    const int gy = k.y0 - 1 + r;
    const bool inside = gy >= 0 && gy < a.h && k.x0 + 8 * q < a.w_;
    const bf16* src = raw + c * kRawPitch + r * kRawCols + 8 * (q + 1);
    const uint4 v0 = *reinterpret_cast<const uint4*>(src);
    const uint4 v1 = *reinterpret_cast<const uint4*>(src + kRawPitch);
    const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w}, w1[4] = {v1.x, v1.y, v1.z, v1.w};
    float sc0 = 1.f, sh0 = 0.f, sc1 = 1.f, sh1 = 0.f;
    if (gn) {
      sc0 = ss[c];
      sc1 = ss[c + 1];
      sh0 = ss[kCC + c];
      sh1 = ss[kCC + c + 1];
    }
    bf16* dst = patch + (r * kPC + 1 + 8 * q) * S::P + c;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = (m + q) & 3;  // pixels 2j, 2j + 1
      const uint32_t u0 = pick(w0, j), u1 = pick(w1, j);
      uint32_t p0, p1;
      if (!gn) {
        p0 = __byte_perm(u0, u1, 0x5410);
        p1 = __byte_perm(u0, u1, 0x7632);
      } else if (inside) {
        p0 = dtts::pack_bf16x2(prologue(lo_f32(u0), sc0, sh0), prologue(lo_f32(u1), sc1, sh1));
        p1 = dtts::pack_bf16x2(prologue(hi_f32(u0), sc0, sh0), prologue(hi_f32(u1), sc1, sh1));
      } else {
        p0 = p1 = 0u;
      }
      *reinterpret_cast<uint32_t*>(dst + 2 * j * S::P) = p0;
      *reinterpret_cast<uint32_t*>(dst + (2 * j + 1) * S::P) = p1;
    }
  }
  constexpr int kPairs = kCC / 2;
  for (int e = kThreads - 1 - k.tid; e < kRPR * kPairs * 2; e += kThreads) {
    const int side = e & 1, cp = (e >> 1) % kPairs, r = (e >> 1) / kPairs;
    const int cc = 2 * cp, col = side ? kPC - 1 : 0, gy = k.y0 - 1 + r, gx = k.x0 - 1 + col;
    const bf16* src = raw + cc * kRawPitch + r * kRawCols + col + 7;
    float f0 = __bfloat162float(src[0]), f1 = __bfloat162float(src[kRawPitch]);
    if (gn) {
      const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w_;
      f0 = inside ? prologue(f0, ss[cc], ss[kCC + cc]) : 0.f;
      f1 = inside ? prologue(f1, ss[cc + 1], ss[kCC + cc + 1]) : 0.f;
    }
    *reinterpret_cast<uint32_t*>(patch + (r * kPC + col) * S::P + cc) = dtts::pack_bf16x2(f0, f1);
  }
}

// The warp at (wm, wn) owns channels wm * 64 .. + 63 and output rows 2 wn,
// 2 wn + 1 of the block: accumulator fragment (i, j) holds channels wm * 64
// + i * 16 + {g, g + 8}, row 2 wn + j / 4, columns (j % 4) * 8 + {2t, 2t + 1}.
// One k16 step: the B fragments of all 64 pixels first, then the A fragment
// of one 16-channel block at a time, which keeps 20 fragment registers live
// where all of A and B would take 32.
__device__ __forceinline__ void step_products(float (&acc)[128], const uint32_t (&bf)[4][4],
                                              const bf16* ws, int cpr, int wm, int kc,
                                              int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t af[4];
    if (cpr == 2) {
      load_a_swizzled<2>(af, ws, wm * 64 + i * 16, kc, lane);
    } else {
      load_a_swizzled<8>(af, ws, wm * 64 + i * 16, kc, lane);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {  // (row, pixel 16-block) = (jp / 2, jp % 2)
      dtts::mma_bf16(&acc[(i * 8 + 2 * jp) * 4], af, bf[jp][0], bf[jp][1]);
      dtts::mma_bf16(&acc[(i * 8 + 2 * jp + 1) * 4], af, bf[jp][2], bf[jp][3]);
    }
  }
}

// acc += tap t's products of a conv stage.
template <bool UP2>
__device__ __forceinline__ void conv_tap(float (&acc)[128], const bf16* ws,
                                         const bf16* __restrict__ patch, int phase, int t,
                                         int lane, int wm, int wn) {
  using S = ConvStage<UP2>;
  const int oy = UP2 ? (phase >> 1) + (t >> 1) : t / 3;
  const int ox = UP2 ? (phase & 1) + (t & 1) : t % 3;
  uint32_t bf[4][4];
#pragma unroll
  for (int jp = 0; jp < 4; ++jp)
    dtts::load_b2(bf[jp], patch, S::P, (2 * wn + jp / 2 + oy) * kPC + ox + 16 * (jp % 2), 0,
                  lane);
  step_products(acc, bf, ws + t * kRK * kCC, 2, wm, 0, lane);
}

// The next stage's transform, then acc += this stage's products over its
// taps. A warp that has finished its transform multiplies beside warps still
// transforming; with the transform between two taps instead, ptxas's
// hoisted fragment loads and the transform's registers overflow the 255 a
// thread may have.
template <bool UP2, bool GN>
__device__ __forceinline__ void conv_products(float (&acc)[128], const ConvArgs& a,
                                              const Block& k, const unsigned char* slot,
                                              const bf16* __restrict__ patch, bf16* next_patch,
                                              const unsigned char* next_slot, int lane, int wm,
                                              int wn) {
  const bf16* ws = reinterpret_cast<const bf16*>(slot);
  if (next_patch != nullptr) transform<UP2, GN>(next_patch, next_slot, a, k);
#pragma unroll
  for (int t = 0; t < ConvStage<UP2>::kTaps; ++t)
    conv_tap<UP2>(acc, ws, patch, k.phase, t, lane, wm, wn);
}

// acc += a shortcut stage: B straight from the raw [channel][pixel] rows.
__device__ __forceinline__ void shortcut_products(float (&acc)[128], const unsigned char* slot,
                                                  int lane, int wm, int wn) {
  using S = ShortcutStage;
  const bf16* ws = reinterpret_cast<const bf16*>(slot);
  const bf16* raw = ws + S::kWeights;
#pragma unroll
  for (int kc = 0; kc < S::CC; kc += 16) {
    uint32_t bf[4][4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      dtts::load_b2_trans(bf[jp], raw, kScPitch, kc, (2 * wn + jp / 2) * kTW + 16 * (jp % 2),
                          lane);
    step_products(acc, bf, ws, S::CC / 8, wm, kc, lane);
  }
}

// grid (tiles_y * tiles_x, ceil(K / 128), B) of 128 channels x (8 rows x 32
// columns) tiles, up2 (.., .., 4 B) with the phase (a, e) = (z & 3) >> 1, z & 1.
// GN: the prologue; SC: the 1x1 shortcut. Each variant is its own kernel, so
// that it holds only the registers it needs: with 128 accumulators a thread,
// the 3x3 kernel with both sits at the 255-register limit.
template <bool UP2, bool GN, bool SC>
__global__ void __launch_bounds__(kThreads, 1) conv3_ring_kernel(const ConvArgs a) {
  using S = ConvStage<UP2>;
  using M = RingSmem<UP2>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* patches = reinterpret_cast<bf16*>(smem + kSlots * M::kSlot);

  Block k;
  k.tid = threadIdx.x;
  const int lane = k.tid & 31, warp = k.tid >> 5, wm = warp >> 2, wn = warp & 3;
  const int tiles_x = (a.w_ + kTW - 1) / kTW;
  k.x0 = (blockIdx.x % tiles_x) * kTW;
  k.y0 = (blockIdx.x / tiles_x) * kRH;
  k.k0 = blockIdx.y * kRK;
  k.b = UP2 ? blockIdx.z >> 2 : blockIdx.z;
  k.phase = UP2 ? blockIdx.z & 3 : 0;
  // stages 0 .. n0 - 1: the conv over x; n0 .. n - 1: the shortcut over sc_x
  k.n0 = (a.c + kCC - 1) / kCC;
  k.n = k.n0 + (SC ? (a.cres + ShortcutStage::CC - 1) / ShortcutStage::CC : 0);
  const auto slot_of = [&](int s) { return smem + (s % kSlots) * M::kSlot; };
  const auto patch_of = [&](int s) { return patches + (s & 1) * S::kPatch; };
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // While stage s is multiplied, stage s + 1 is transformed and stage s + 2
  // is in flight: one barrier a stage.
  issue_stage<UP2, SC>(smem, a, k, 0);
  issue_stage<UP2, SC>(smem, a, k, 1);
  cp_async_wait<1>();
  __syncthreads();
  transform<UP2, GN>(patch_of(0), slot_of(0), a, k);
  // The conv's stages, then the shortcut's: two loops, so that neither
  // loop's registers are held for the other's code.
  for (int s = 0; s < k.n0; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s + 1 has landed and stage s is transformed, for every thread;
                      // stage s - 1's slot and patch are consumed
    issue_stage<UP2, SC>(smem, a, k, s + 2);
    conv_products<UP2, GN>(acc, a, k, slot_of(s), patch_of(s),
                           s + 1 < k.n0 ? patch_of(s + 1) : nullptr, slot_of(s + 1), lane, wm,
                           wn);
  }
  if constexpr (SC) {
    for (int s = k.n0; s < k.n; ++s) {
      cp_async_wait<0>();
      __syncthreads();
      issue_stage<UP2, SC>(smem, a, k, s + 2);
      shortcut_products(acc, slot_of(s), lane, wm, wn);
    }
  }
  cp_async_wait<0>();

  // The epilogue, in kEpiPasses passes over the channels: accumulators +
  // bias -> tile[channels][kEpiPitch] in the ring's memory, then whole output
  // rows. The passes are unrolled: a pass chosen at run time would index the
  // accumulators at run time, out of registers.
  float* tile = reinterpret_cast<float*>(smem);
  const bf16* bias = static_cast<const bf16*>(a.bias);
  bf16* out = static_cast<bf16*>(a.out);
  const int g = lane >> 2, t = lane & 3;
  constexpr int kPassCh = kRK / M::kEpiPasses;
#pragma unroll
  for (int pass = 0; pass < M::kEpiPasses; ++pass) {
    const int k0 = k.k0 + pass * kPassCh;
    __syncthreads();  // the products, or the previous pass's stores, are done
    if (M::kEpiPasses == 1 || wm == pass) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ch = wm * 64 + i * 16 + g + 8 * hh;  // in the block
          const float bv =
              bias != nullptr && k.k0 + ch < a.k ? __bfloat162float(bias[k.k0 + ch]) : 0.f;
          float* row = tile + (ch - pass * kPassCh) * kEpiPitch;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float* v = &acc[(i * 8 + j) * 4 + 2 * hh];
            *reinterpret_cast<float2*>(row + (2 * wn + j / 4) * kTW + (j % 4) * 8 + 2 * t) =
                make_float2(v[0] + bv, v[1] + bv);
          }
        }
    }
    __syncthreads();
    if constexpr (!UP2) {
      // four lanes a 32-pixel row of one channel, 8 pixels (16 bytes) a lane;
      // lanes of odd row groups read their two float4 halves the other way
      // round, so a quarter-warp's loads cover all 32 banks
      const bf16* res = static_cast<const bf16*>(a.residual);
      const int q = k.tid & 3, h = (k.tid >> 2) & 1;
      for (int e = k.tid >> 2; e < kPassCh * kRH; e += kThreads / 4) {
        const int ch = e / kRH, r = e % kRH, kk = k0 + ch, y = k.y0 + r, x = k.x0 + 8 * q;
        if (kk >= a.k || y >= a.h || x >= a.w_) continue;
        const float* src = tile + ch * kEpiPitch + r * kTW + 8 * q;
        const float4 f = *reinterpret_cast<const float4*>(src + 4 * h);
        const float4 s2 = *reinterpret_cast<const float4*>(src + 4 - 4 * h);
        float v[8] = {f.x, f.y, f.z, f.w, s2.x, s2.y, s2.z, s2.w};
        if (h) {
          v[0] = s2.x, v[1] = s2.y, v[2] = s2.z, v[3] = s2.w;
          v[4] = f.x, v[5] = f.y, v[6] = f.z, v[7] = f.w;
        }
        const int64_t idx = (((int64_t)k.b * a.k + kk) * a.h + y) * a.w_ + x;
        if (res != nullptr) {
          const uint4 rv = *reinterpret_cast<const uint4*>(res + idx);
          const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            v[2 * m] += lo_f32(rw[m]);
            v[2 * m + 1] += hi_f32(rw[m]);
          }
        }
        *reinterpret_cast<uint4*>(out + idx) =
            make_uint4(dtts::pack_bf16x2(v[0], v[1]), dtts::pack_bf16x2(v[2], v[3]),
                       dtts::pack_bf16x2(v[4], v[5]), dtts::pack_bf16x2(v[6], v[7]));
      }
    } else {
      // a warp a row: lane j's result goes to output column 2 (x0 + j) + e
      const int pa = k.phase >> 1, pe = k.phase & 1;
      for (int e = warp; e < kPassCh * kRH; e += kThreads / 32) {
        const int ch = e / kRH, r = e % kRH, kk = k0 + ch, y = k.y0 + r, x = k.x0 + lane;
        if (kk >= a.k || y >= a.h || x >= a.w_) continue;
        out[(((int64_t)k.b * a.k + kk) * 2 * a.h + 2 * y + pa) * 2 * a.w_ + 2 * x + pe] =
            __float2bfloat16(tile[ch * kEpiPitch + r * kTW + lane]);
      }
    }
  }
}

template <bool UP2, bool GN, bool SC>
cudaError_t launch_ring(const ConvArgs& a, cudaStream_t stream) {
  constexpr int bytes = RingSmem<UP2>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(conv3_ring_kernel<UP2, GN, SC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.h + kRH - 1) / kRH) * ((a.w_ + kTW - 1) / kTW);
  dim3 grid(tiles, (a.k + kRK - 1) / kRK, UP2 ? 4 * a.b : a.b);
  conv3_ring_kernel<UP2, GN, SC><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------- route 2: wgmma (bf16)

using dtts::encode_tiled;
using dtts::EncodeTiled;
using dtts::bulk_commit;
using dtts::bulk_load;
using dtts::bulk_wait;
using dtts::bulk_wait_read;
using dtts::fence_proxy_async;
using dtts::fence_regs;
using dtts::kEncodeFailed;
using dtts::mbar_arrive;
using dtts::mbar_expect_tx;
using dtts::mbar_init;
using dtts::mbar_wait;
using dtts::sm_count;
using dtts::tma_load_2d;
using dtts::tma_load_3d;
using dtts::tma_load_4d;
using dtts::tma_store_4d;
using dtts::wgmma_commit;
using dtts::wgmma_desc;
using dtts::wgmma_fence;
using dtts::wgmma_ss;
using dtts::wgmma_ss_bmn128;
using dtts::wgmma_wait;

// The wgmma route's conditions (beside bf16 and 16-byte aligned operands): C
// a multiple of kWgChannels, Cres of kWgScChannels, W of kWgWidth.
constexpr int kWgChannels = 16, kWgScChannels = 32, kWgWidth = 8;

// A tile: kWgM output channels x kWgNC output rows x kWgCols columns; consumer
// warpgroup r computes row r (m64n128 products, 64 fp32 accumulators a
// thread).
constexpr int kWgM = 64;
constexpr int kWgNC = 3;                  // consumer warpgroups = output rows of a tile
constexpr int kWgCols = 128;              // N of every product
constexpr int kWgPR = kWgNC + 2;          // input rows of a tile, with the halo
// A raw row: columns x0 - 8 .. x0 + 143. The box's innermost start must be a
// whole 16 bytes (a start at x0 - 1 is an illegal instruction; negative
// coordinates are fine and read as zero).
constexpr int kWgRawCols = kWgCols + 24;
constexpr int kWgPW = kWgCols + 16;       // a patch row: columns x0 - 8 .. x0 + 135
constexpr int kWgOctets = kWgPW / 8;      // 8-pixel groups of a patch row
constexpr int kWgSw = 4, kWgSx = 2, kWgP = 2;  // weight slots, raw slots, patches
constexpr int kWgThreads = kWgNC * 128 + 32;   // the consumer warpgroups, the producer
// One conv stage: kWgChannels input channels under all 9 taps (one k16 step a
// tap). Weights [tap][64 rows][16 channels], 32-byte swizzled rows; raw input
// [16 channels][5 rows][152 columns] as it lands (a channel every 1520 bytes:
// 95 16-byte units, odd, so the 8 channel rows of an ldmatrix fall in 8
// distinct bank groups).
constexpr int kWgTapBytes = kWgM * kWgChannels * 2;                 // 2048
constexpr int kWgWSlot = 9 * kWgTapBytes;                           // 18432
constexpr int kWgRawChannel = kWgPR * kWgRawCols * 2;               // 1520
constexpr int kWgRawBytes = kWgChannels * kWgRawChannel;            // 24320
// With the prologue the stage's 16 scales and 16 shifts (fp32) follow the raw
// rows in the slot, by one bulk copy each.
constexpr int kWgScaleShift = 2 * kWgChannels * 4;                  // 128
// One shortcut stage: sc_w [64 rows][32 channels] (64-byte swizzle), sc_x per
// output row two boxes [32 channels][64 pixels] (128-byte swizzle).
constexpr int kWgScWBytes = kWgM * kWgScChannels * 2;               // 4096
constexpr int kWgScBox = kWgScChannels * 64 * 2;                    // 4096
constexpr int kWgScBytes = kWgNC * 2 * kWgScBox;                    // 24576
constexpr int kWgXSlot = kWgRawBytes + kWgScaleShift > kWgScBytes
                             ? kWgRawBytes + kWgScaleShift : kWgScBytes;
// The operand patch: [8-channel chunk][5 x 144 pixels][8 channels], no swizzle:
// 8 pixels x 16 bytes form a core matrix and a pixel is 16 bytes after the
// previous one, so tap (dy, dx) of output row r starts at pixel
// (r + dy) * 144 + 7 + dx (column x0 - 1 + dx): a descriptor offset.
constexpr int kWgChunk = kWgPR * kWgPW * 16;                        // 11520 (LBO)
constexpr int kWgPatch = 2 * kWgChunk;                              // 23040
// The epilogue's staging tile of a consumer warpgroup: its row's 64 channels
// x 128 columns in bf16 as two TMA boxes of [64 channels][64 columns], rows
// of 128 bytes with the 128-byte swizzle (the residual lands there, the
// output leaves from there).
constexpr int kWgOutBox = kWgM * 64 * 2;                            // 8192
constexpr int kWgOut = 2 * kWgOutBox;                               // 16384
constexpr int kWgSmemBytes = 1024 + kWgSw * kWgWSlot + kWgSx * kWgXSlot + kWgNC * kWgOut +
                             kWgP * kWgPatch + 16 * (kWgSw + kWgSx + kWgP) + 8 * kWgNC;
static_assert(kWgWSlot % 1024 == 0 && kWgXSlot % 1024 == 0 && kWgOut % 1024 == 0 &&
              kWgPatch % 16 == 0, "aligned slots");
static_assert(kWgRawChannel / 16 % 2 == 1, "an odd number of 16-byte units a raw channel");
static_assert(kWgSmemBytes <= 232448, "a block's shared memory");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// A tile of the persistent walk: the channel block fastest, so that the
// blocks in flight share their input rows in L2.
struct WgTile {
  int b, y0, x0, k0;
};

__device__ __forceinline__ WgTile wg_tile(const ConvArgs& a, int u) {
  const int kb = (a.k + kWgM - 1) / kWgM, xt = (a.w_ + kWgCols - 1) / kWgCols;
  const int bands = (a.h + kWgNC - 1) / kWgNC;
  WgTile t;
  t.k0 = (u % kb) * kWgM;
  u /= kb;
  t.x0 = (u % xt) * kWgCols;
  u /= xt;
  t.y0 = (u % bands) * kWgNC;
  t.b = u / bands;
  return t;
}

__host__ __device__ __forceinline__ int wg_tiles(const ConvArgs& a) {
  return a.b * ((a.h + kWgNC - 1) / kWgNC) * ((a.w_ + kWgCols - 1) / kWgCols) *
         ((a.k + kWgM - 1) / kWgM);
}

constexpr int kWgPairs = kWgOctets / 2;      // 16-pixel groups of a patch row: 9
constexpr int kWgUnits = kWgPR * kWgPairs;   // transform units a stage: 45
constexpr int kWgBatch = 2;                  // units a warp has in flight

// The prologue of a bf16 pair (lo, hi halves of `v`) with h = z / 2 folded
// into the halved scale and shift (a power of two: the same two roundings,
// halved exactly): silu(z) = h + h tanh(h), as the ring computes it.
__device__ __forceinline__ void silu_pair(uint32_t v, float half_scale, float half_shift,
                                          float& y0, float& y1) {
  const float h0 = __fadd_rn(__fmul_rn(lo_f32(v), half_scale), half_shift);
  const float h1 = __fadd_rn(__fmul_rn(hi_f32(v), half_scale), half_shift);
  y0 = fmaf(h0, tanh_approx(h0), h0);
  y1 = fmaf(h1, tanh_approx(h1), h1);
}

// The raw rows of a landed conv stage -> the operand patch. A unit is one
// raw row r and one 16-pixel group q of all 16 channels: ldmatrix.x4 reads its
// four 8-channel x 8-pixel blocks (lane 4 g + t: channel g of block m's
// channel half m % 2, pixels 2t, 2t + 1 of its pixel half m / 2), the
// prologue runs on them in fp32 with one rounding (0 outside the image,
// decided by position: the copy's zero fill would contribute silu(shift);
// only a unit at the image's edge tests it), and stmatrix.x4.trans writes
// them back transposed, 8 pixels of 16 bytes (8 channels) a block. 45 units a
// stage (the raw row's last 8 columns are not needed) over the 12 consumer
// warps (warp tw takes units tw, tw + 12, ...), kWgBatch at a time, loads
// first. A unit of 8 values a thread keeps the address and position
// arithmetic to a fraction of the prologue's own: the transform shares each
// sub-partition's issue slot with the products' issue.
template <bool GN>
__device__ __forceinline__ void wg_transform(uint32_t raw, const unsigned char* smem_ptr,
                                             uint32_t patch, const ConvArgs& a, const WgTile& t,
                                             int tw, int lane) {
  float sc[2] = {0.f, 0.f}, sh[2] = {0.f, 0.f};
  if (GN) {  // the slot's scales, then shifts, after the raw rows
    const float* ss = reinterpret_cast<const float*>(smem_ptr) + kWgRawBytes / 4;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      sc[m] = 0.5f * ss[8 * m + (lane >> 2)];
      sh[m] = 0.5f * ss[kWgChannels + 8 * m + (lane >> 2)];
    }
  }
  // lane L addresses row L % 8 of block L / 8: channel (L % 16), pixel half L / 16
  const uint32_t src = raw + (lane & 15) * kWgRawChannel + (lane >> 4) * 16;
  const uint32_t dst = patch + ((lane >> 3) & 1) * kWgChunk + ((lane >> 4) * 8 + (lane & 7)) * 16;
  constexpr int kWarps = 4 * kWgNC;  // every consumer warp transforms
  for (int e0 = tw; e0 < kWgUnits; e0 += kWarps * kWgBatch) {
    uint32_t v[kWgBatch][4];
#pragma unroll
    for (int i = 0; i < kWgBatch; ++i) {
      const int e = e0 + kWarps * i, r = e / kWgPairs, q = e - r * kWgPairs;
      if (e < kWgUnits) ldmatrix_x4(v[i], src + r * (kWgRawCols * 2) + q * 32);
    }
#pragma unroll
    for (int i = 0; i < kWgBatch; ++i) {
      const int e = e0 + kWarps * i, r = e / kWgPairs, q = e - r * kWgPairs;
      if (e >= kWgUnits) break;
      if (GN) {
        const int gy = t.y0 - 1 + r, gx0 = t.x0 - 8 + 16 * q;
        const bool row = gy >= 0 && gy < a.h;
        if (row && gx0 >= 0 && gx0 + 16 <= a.w_) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float y0, y1;
            silu_pair(v[i][m], sc[m & 1], sh[m & 1], y0, y1);
            v[i][m] = dtts::pack_bf16x2(y0, y1);
          }
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int gx = gx0 + 8 * (m >> 1) + 2 * (lane & 3);
            const bool in0 = row && gx >= 0 && gx < a.w_;
            const bool in1 = row && gx >= -1 && gx + 1 < a.w_;
            float y0, y1;
            silu_pair(v[i][m], sc[m & 1], sh[m & 1], y0, y1);
            v[i][m] = dtts::pack_bf16x2(in0 ? y0 : 0.f, in1 ? y1 : 0.f);
          }
        }
      }
      stmatrix_x4_trans(dst + (r * kWgPW + 16 * q) * 16, v[i]);
    }
  }
}

// grid: min(tiles, SMs) persistent blocks of kWgThreads threads. Warpgroups
// 0 .. kWgNC - 1 consume (one output row each) and transform, the last warp
// produces (one lane issues every TMA load). GN: the
// prologue; SC: the 1x1 shortcut (after the conv's stages, Cres / 32 stages
// whose sc_x boxes are the B operand as they land: MN-major, 128-byte
// swizzle, no transform).
template <bool GN, bool SC>
__global__ void __launch_bounds__(kWgThreads, 1)
conv3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap scxmap,
                   const __grid_constant__ CUtensorMap scwmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap rmap, const ConvArgs a) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t smem_base = dtts::smem_addr(wg_smem);
  const uint32_t base = (smem_base + 1023u) & ~1023u;
  const uint32_t xbase = base + kWgSw * kWgWSlot;
  const uint32_t obase = xbase + kWgSx * kWgXSlot;
  const uint32_t pbase = obase + kWgNC * kWgOut;
  const uint32_t bar = pbase + kWgP * kWgPatch;
  auto wslot = [&](int s) { return base + s * kWgWSlot; };
  auto xslot = [&](int s) { return xbase + s * kWgXSlot; };
  auto pslot = [&](int s) { return pbase + s * kWgPatch; };
  auto wfull = [&](int s) { return bar + 8u * s; };
  auto wempty = [&](int s) { return bar + 8u * (kWgSw + s); };
  auto xfull = [&](int s) { return bar + 8u * (2 * kWgSw + s); };
  auto xempty = [&](int s) { return bar + 8u * (2 * kWgSw + kWgSx + s); };
  auto pfull = [&](int s) { return bar + 8u * (2 * kWgSw + 2 * kWgSx + s); };
  auto pempty = [&](int s) { return bar + 8u * (2 * kWgSw + 2 * kWgSx + kWgP + s); };
  // the residual's arrival in consumer warpgroup w's staging tile
  auto rfull = [&](int w) { return bar + 8u * (2 * kWgSw + 2 * kWgSx + 2 * kWgP + w); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgSw; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), 4 * kWgNC);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < kWgSx; ++s) {
      mbar_init(xfull(s), 1);
      // each consumer warp once: after its transform reads (a conv stage) or
      // its products (a shortcut stage)
      mbar_init(xempty(s), 4 * kWgNC);
    }
    for (int s = 0; s < kWgP; ++s) {
      mbar_init(pfull(s), 4 * kWgNC);  // each consumer warp's share, after its proxy fence
      mbar_init(pempty(s), 4 * kWgNC);
    }
    for (int w = 0; w < kWgNC; ++w) mbar_init(rfull(w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = wg_tiles(a);
  const int n0 = a.c / kWgChannels, n = n0 + (SC ? a.cres / kWgScChannels : 0);
  // warps 0 .. 4 kWgNC - 1 consume and transform (warpgroup `role`, warp
  // `warp` of it), the last produces
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp_id / 4, warp = warp_id % 4;

  if (warp_id == 4 * kWgNC) {  // the producer warp
    if (lane != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const WgTile t = wg_tile(a, u);
      for (int s = 0; s < n; ++s, ++it) {
        const int ws = it % kWgSw, xs = it % kWgSx;
        if (it >= kWgSw) mbar_wait(wempty(ws), ((it / kWgSw) - 1) & 1);
        if (it >= kWgSx) mbar_wait(xempty(xs), ((it / kWgSx) - 1) & 1);
        if (s < n0) {
          mbar_expect_tx(wfull(ws), kWgWSlot);
          tma_load_3d(wslot(ws), &wmap, wfull(ws), s * kWgChannels, t.k0, 0);
          mbar_expect_tx(xfull(xs), kWgRawBytes + (GN ? kWgScaleShift : 0));
          tma_load_4d(xslot(xs), &xmap, xfull(xs), t.x0 - 8, t.y0 - 1, s * kWgChannels, t.b);
          if (GN) {
            const int64_t plane = (int64_t)t.b * a.c + s * kWgChannels;
            bulk_load(xslot(xs) + kWgRawBytes, a.gn_scale + plane, kWgScaleShift / 2, xfull(xs));
            bulk_load(xslot(xs) + kWgRawBytes + kWgScaleShift / 2, a.gn_shift + plane,
                      kWgScaleShift / 2, xfull(xs));
          }
        } else if (SC) {
          const int c0 = (s - n0) * kWgScChannels;
          mbar_expect_tx(wfull(ws), kWgScWBytes);
          tma_load_2d(wslot(ws), &scwmap, wfull(ws), c0, t.k0);
          mbar_expect_tx(xfull(xs), kWgScBytes);
          for (int q = 0; q < 2 * kWgNC; ++q)
            tma_load_4d(xslot(xs) + q * kWgScBox, &scxmap, xfull(xs), t.x0 + 64 * (q & 1),
                        t.y0 + (q >> 1), c0, t.b);
        }
      }
    }
    return;
  }

  // The consumer warpgroups: role = the tile's output row. Each warp also
  // transforms its share of the next conv stage's patch right after issuing
  // this stage's products, while the tensor cores run them.
  const int g = lane >> 2, tq = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // The raw slot of global stage `it` (a conv stage, conv stage `ip`) of
  // tile t -> patch ip % kWgP: this warp's units, then its arrivals.
  auto transform = [&](int it, int ip, const WgTile& t) {
    const int xs = it % kWgSx, ps = ip % kWgP;
    mbar_wait(xfull(xs), (it / kWgSx) & 1);
    if (ip >= kWgP) mbar_wait(pempty(ps), ((ip / kWgP) - 1) & 1);
    wg_transform<GN>(xslot(xs), wg_smem + (xslot(xs) - smem_base), pslot(ps), a, t, warp_id,
                     lane);
    fence_proxy_async();  // the patch is read by wgmma (the async proxy)
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(pfull(ps));
      mbar_arrive(xempty(xs));
    }
  };
  // The stage whose products were issued last is freed once the next
  // stage's products are issued and it has completed.
  bool pend = false;
  int pend_it = 0, pend_ip = 0;
  bool pend_conv = false;
  auto release = [&]() {
    if (lane == 0) {
      mbar_arrive(wempty(pend_it % kWgSw));
      if (pend_conv) mbar_arrive(pempty(pend_ip % kWgP));
      else mbar_arrive(xempty(pend_it % kWgSx));
    }
    pend = false;
  };
  const uint32_t out_tile = obase + role * kWgOut;
  const bool elected = warp == 0 && lane == 0, residual = a.residual != nullptr;
  int it = 0, ip = 0, tc = 0;  // tc: this block's tiles so far
  if (blockIdx.x < tiles) transform(0, 0, wg_tile(a, blockIdx.x));
  for (int u = blockIdx.x; u < tiles; u += gridDim.x, ++tc) {
    const WgTile t = wg_tile(a, u);
    for (int s = 0; s < n; ++s, ++it) {
      // The residual rows of this tile into the staging tile, once the last
      // tile's output has left it (its store issued a stage or more ago).
      if (residual && elected && s == (n > 1 ? 1 : 0)) {
        bulk_wait_read<0>();
        mbar_expect_tx(rfull(role), kWgOut);
        tma_load_4d(out_tile, &rmap, rfull(role), t.x0, t.y0 + role, t.k0, t.b);
        tma_load_4d(out_tile + kWgOutBox, &rmap, rfull(role), t.x0 + 64, t.y0 + role, t.k0, t.b);
      }
      const int ws = it % kWgSw;
      mbar_wait(wfull(ws), (it / kWgSw) & 1);
      const bool conv = s < n0;
      // the next stage, if it is a conv stage: this tile's, or the next
      // tile's first; it is transformed during this stage's products
      const bool next = s + 1 < n0 || (s + 1 == n && u + (int)gridDim.x < tiles);
      const WgTile tn = s + 1 < n0 ? t : wg_tile(a, u + gridDim.x);
      const int ipn = conv ? ip + 1 : ip;
      if (conv) {
        const int ps = ip % kWgP;
        mbar_wait(pfull(ps), (ip / kWgP) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const uint64_t da = wgmma_desc(wslot(ws) + tap * kWgTapBytes, 16, 256, 3);
          const uint64_t db =
              wgmma_desc(pslot(ps) + ((role + dy) * kWgPW + 7 + dx) * 16, kWgChunk, 128, 0);
          wgmma_ss<128>(acc, da, db, s > 0 || tap > 0);
        }
        wgmma_commit();
      } else if (SC) {
        const int xs = it % kWgSx;
        mbar_wait(xfull(xs), (it / kWgSx) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < kWgScChannels / 16; ++k16) {
          const uint64_t da = wgmma_desc(wslot(ws) + 32 * k16, 16, 512, 2);
          const uint64_t db =
              wgmma_desc(xslot(xs) + role * 2 * kWgScBox + k16 * 2048, kWgScBox, 1024, 1);
          wgmma_ss_bmn128(acc, da, db, 1);
        }
        wgmma_commit();
      }
      if (pend) {
        wgmma_wait<1>();
        fence_regs(acc);
        release();
      }
      if (next) transform(it + 1, ipn, tn);
      pend = true;
      pend_it = it;
      pend_ip = ip;
      pend_conv = conv;
      ip = ipn;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release();

    // The epilogue through the staging tile: acc[4 j + 2 r + c] is channel
    // k0 + 16 warp + g + 8 r, column x0 + 8 j + 2 tq + c, the layout of an
    // ldmatrix / stmatrix fragment of the 8 x 8 block (channels 16 warp + 8 r
    // .., columns 8 j ..). Per two column groups one ldmatrix.x4 reads the
    // residual's blocks (swizzled rows: no bank conflicts), the bias and the
    // residual join in fp32, one rounding, one stmatrix.x4 writes them back;
    // then one lane stores the tile by TMA, which clips rows, channels and
    // columns outside the output.
    if (residual) {
      mbar_wait(rfull(role), tc & 1);
    } else if (elected) {
      bulk_wait_read<0>();  // the last tile's output has left the staging tile
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + role) : "memory");
    const bf16* bias = static_cast<const bf16*>(a.bias);
    float bv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ch = t.k0 + 16 * warp + g + 8 * r;
      bv[r] = bias != nullptr && ch < a.k ? __bfloat162float(bias[ch]) : 0.f;
    }
    // lane L addresses row L % 8 of block L / 8: (r, j) = (b % 2, j0 + b / 2)
    const int row = 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
    for (int j0 = 0; j0 < kWgCols / 8; j0 += 2) {
      const int j = j0 + (lane >> 4);
      const uint32_t addr =
          out_tile + (j / 8) * kWgOutBox + row * 128 + (((j % 8) ^ (row & 7)) * 16);
      uint32_t res[4] = {0u, 0u, 0u, 0u}, o[4];
      if (residual) ldmatrix_x4(res, addr);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = b & 1, jj = j0 + (b >> 1);
        float v0 = acc[4 * jj + 2 * r] + bv[r], v1 = acc[4 * jj + 2 * r + 1] + bv[r];
        if (residual) {
          v0 += lo_f32(res[b]);
          v1 += hi_f32(res[b]);
        }
        o[b] = dtts::pack_bf16x2(v0, v1);
      }
      stmatrix_x4(addr, o);
    }
    fence_proxy_async();  // the staging tile is read by the TMA store (the async proxy)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + role) : "memory");
    if (elected) {
      tma_store_4d(&omap, out_tile, t.x0, t.y0 + role, t.k0, t.b);
      tma_store_4d(&omap, out_tile + kWgOutBox, t.x0 + 64, t.y0 + role, t.k0, t.b);
      bulk_commit();
    }
  }
  if (elected) bulk_wait<0>();  // the shared memory stays until the last store has read it
}

// A tensor map of bf16 with the given dims (innermost first), byte strides of
// dims 1.. and box; the box's out-of-range elements read as zero.
int encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

template <bool GN, bool SC>
cudaError_t launch_wgmma_kernel(const CUtensorMap& xm, const CUtensorMap& wm,
                                const CUtensorMap& sxm, const CUtensorMap& swm,
                                const CUtensorMap& om, const CUtensorMap& rm, const ConvArgs& a,
                                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3_wgmma_kernel<GN, SC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kWgSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = wg_tiles(a), blocks = tiles < sm_count() ? tiles : sm_count();
  conv3_wgmma_kernel<GN, SC><<<blocks, kWgThreads, kWgSmemBytes, stream>>>(xm, wm, sxm, swm, om,
                                                                            rm, a);
  return cudaGetLastError();
}

// The wgmma route: x as 4-D (W, H, C, B) in boxes of 152 x 5 x 16; the
// packed weights as 3-D (C, K, 9) in boxes of 16 x 64 x 9 (32-byte swizzle);
// with the shortcut, sc_x (W, H, Cres, B) in boxes of 64 x 1 x 32 (128-byte
// swizzle) and sc_w (Cres, K) in boxes of 32 x 64 (64-byte swizzle).
int launch_wgmma(const ConvArgs& a, cudaStream_t stream) {
  const cuuint64_t hw = (cuuint64_t)a.h * a.w_;
  CUtensorMap xm, wm, sxm, swm;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)a.w_, (cuuint64_t)a.h, (cuuint64_t)a.c,
                                (cuuint64_t)a.b};
    const cuuint64_t strides[3] = {(cuuint64_t)a.w_ * 2, hw * 2, hw * a.c * 2};
    const cuuint32_t box[4] = {kWgRawCols, kWgPR, kWgChannels, 1};
    const int e = encode_map(&xm, a.x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)a.c, (cuuint64_t)a.k, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)a.c * 2, (cuuint64_t)a.k * a.c * 2};
    const cuuint32_t box[3] = {kWgChannels, kWgM, 9};
    const int e = encode_map(&wm, a.w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
    if (e != 0) return e;
  }
  sxm = xm;
  swm = wm;
  if (a.sc_x != nullptr) {
    const cuuint64_t dims[4] = {(cuuint64_t)a.w_, (cuuint64_t)a.h, (cuuint64_t)a.cres,
                                (cuuint64_t)a.b};
    const cuuint64_t strides[3] = {(cuuint64_t)a.w_ * 2, hw * 2, hw * a.cres * 2};
    const cuuint32_t box[4] = {64, 1, kWgScChannels, 1};
    int e = encode_map(&sxm, a.sc_x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
    const cuuint64_t wdims[2] = {(cuuint64_t)a.cres, (cuuint64_t)a.k};
    const cuuint64_t wstrides[1] = {(cuuint64_t)a.cres * 2};
    const cuuint32_t wbox[2] = {kWgScChannels, kWgM};
    e = encode_map(&swm, a.sc_w, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B);
    if (e != 0) return e;
  }
  CUtensorMap om, rm;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)a.w_, (cuuint64_t)a.h, (cuuint64_t)a.k,
                                (cuuint64_t)a.b};
    const cuuint64_t strides[3] = {(cuuint64_t)a.w_ * 2, hw * 2, hw * a.k * 2};
    const cuuint32_t box[4] = {64, 1, kWgM, 1};
    int e = encode_map(&om, a.out, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
    rm = om;
    if (a.residual != nullptr) {
      e = encode_map(&rm, a.residual, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
      if (e != 0) return e;
    }
  }
  const bool gn = a.gn_scale != nullptr, sc = a.sc_x != nullptr;
  cudaError_t err;
  if (gn)
    err = sc ? launch_wgmma_kernel<true, true>(xm, wm, sxm, swm, om, rm, a, stream)
             : launch_wgmma_kernel<true, false>(xm, wm, sxm, swm, om, rm, a, stream);
  else
    err = sc ? launch_wgmma_kernel<false, true>(xm, wm, sxm, swm, om, rm, a, stream)
             : launch_wgmma_kernel<false, false>(xm, wm, sxm, swm, om, rm, a, stream);
  return static_cast<int>(err);
}

// ------------------------------------ route 2 of conv3x3_up2: wgmma (bf16)
//
// The up-conv as an implicit GEMM per row phase a: M = output channels, N =
// source pixels (i, j), and for each column phase e an accumulator set of its
// own, depth 4 C (the phase's 2x2 taps):
//   out[b, k, 2i + a, 2j + e] = sum_{c, r, s} wp[2a + e][2r + s][k, c]
//                                           * x[b, c, i + a - 1 + r, j + e - 1 + s]
//   * A tile is 64 channels x SR source rows x 128 / SR source columns of one
//     image (2 SR output rows x 256 / SR output columns): SR = 1 where W >
//     kUpNarrow, else SR = 2 (a 64-wide source would leave half of a
//     128-column tile empty). Persistent blocks, one an SM, walk the tiles
//     with the channel block fastest.
//   * Roles: a producer warpgroup (one lane issues every load; setmaxnreg
//     leaves its threads 40 registers and gives the consumers 232: a 9-warp
//     block gets 168 from ptxas, which spilled and ran 4-5% slower on an
//     H100) and two consumer warpgroups, one per row phase a. A stage is 16 input channels:
//     each warpgroup issues 2 column phases x 4 taps of m64n128k16 products
//     (SR = 2: 2 x 4 x 2 rows of m64n64k16), into 2 x 64 fp32 accumulators a
//     thread, then transforms its share of the next stage's patch.
//   * Weights: the caller packs the phase weights in the operand's own
//     layout, [K / 64][C / 16][16 (phase 2a + e, tap 2r + s)][2 channel
//     halves][64 rows][8 channels] (K-major core matrices, no swizzle, rows
//     past K zero), so that a stage's 32 KB are one contiguous bulk copy; a
//     (phase, tap) is a descriptor offset of 2048 bytes. (A 3-D tensor map
//     with 32-byte boxes, as conv3x3_same's, makes 1024 rows a stage, three
//     times #6's rows per product: it held [4,512,128,128,512] at 1.70 ms
//     on an H100 against 1.06 with no loads at all.)
//     Raw input: a 4-D map over NCHW x, boxes of kRawCols columns (from x0 -
//     8: a box's innermost start must be 16-byte aligned) x kRawRows rows x 16
//     channels; TMA's zero fill of out-of-image coordinates is SAME padding
//     itself (no prologue: the transform has no test of position). The box's
//     rows and columns give each channel an odd number of 16-byte units (57
//     at SR = 1, 55 at SR = 2, which loads one row more than it uses), so that
//     each ldmatrix is free of bank conflicts.
//   * The transform is conv3x3_same's without the prologue: ldmatrix.x4 of 16
//     channels x 16 pixels, stmatrix.x4.trans into the K-major patch
//     [8-channel chunk][kPR rows x kPW pixels][8 channels] (pixel p is column
//     x0 - 8 + p): tap (r, s) of phase (a, e) at source row i0 + sr is the
//     descriptor of pixel (sr + a + r) * kPW + 7 + e + s, so the three column
//     shifts -1, 0, +1 all read one patch.
//   * The epilogue interleaves the column phases in registers: at one
//     fragment position a thread's two accumulator sets are output columns 2j
//     and 2j + 1, so it holds 4 consecutive output columns of one channel
//     (+ bias in fp32, one rounding) and writes them as one 8-byte store into
//     its warpgroup's staging tile (its output rows, 64 channels x 256
//     columns as four 128-byte-swizzled TMA boxes; the lanes of odd rows
//     take the column groups in another order, so that a half-warp's 16
//     stores fall in 32 distinct banks); then one lane stores the boxes by
//     TMA, which clips rows, channels and columns outside the output.
//   * Rings of 3 weight slots, 2 raw slots and 2 patches with full and empty
//     mbarriers; shared memory: 1024 bytes of alignment slack, 3 x 32,768
//     (weights), 2 x 15,360 (raw rows), 2 x 32,768 (staging tiles), 2 x
//     13,824 (patches) and the mbarriers: 223,344 bytes of the 232,448 a
//     block may have (a fourth weight slot does not fit beside the staging).
//   * No split of the depth, no atomics: two calls give the same bits.
//     Nothing gives way: a refused encode, launch or misaligned operand is an
//     error (the wrapper raises), never a fall back to the ring.

// The up-conv's wgmma route's conditions (beside bf16 and 16-byte aligned
// operands): C a multiple of kUpChannels, W of kUpWidth.
constexpr int kUpChannels = 16, kUpWidth = 8;
constexpr int kUpNarrow = 64;              // SR = 2 up to this source width
constexpr int kUpNC = 2;                   // consumer warpgroups: the row phases
constexpr int kUpThreads = kUpNC * 128 + 128;  // the consumers, the producer warpgroup
// Registers a thread after setmaxnreg: the launch gives 168 to each of the 384
// threads (65,536 / 384, rounded down to 8), which this shares out again.
constexpr int kUpProducerRegs = 40, kUpConsumerRegs = 232;
static_assert(kUpNC * 128 * kUpConsumerRegs + 128 * kUpProducerRegs <= kUpThreads * 168,
              "setmaxnreg shares out no more than the launch gave");
constexpr int kUpSw = 3, kUpSx = 2, kUpP = 2;  // weight slots, raw slots, patches
constexpr int kUpWSlot = 16 * kWgTapBytes;     // 32768: one bulk copy
constexpr int kUpXSlot = 15 * 1024;            // the larger raw box, rounded up
constexpr int kUpOut = 4 * kWgOutBox;          // a warpgroup's staging tile: 32768
static_assert(kUpChannels == kWgChannels, "one 16-channel stage, one k16 step a tap");

template <int SR>
struct Up2Tile {
  static constexpr int kCols = kWgCols / SR;         // source columns of a tile: N of a product
  static constexpr int kPR = SR + 2;                 // patch rows: i0 - 1 .. i0 + SR
  static constexpr int kRawRows = SR == 1 ? 3 : 5;   // box rows (SR = 2: one unused)
  static constexpr int kRawCols = kCols + 24;        // x0 - 8 .. x0 + kCols + 15
  static constexpr int kPW = kCols + 16;             // patch row: x0 - 8 .. x0 + kCols + 7
  static constexpr int kPairs = kPW / 16;            // 16-pixel units of a patch row
  static constexpr int kUnits = kPR * kPairs;        // transform units a stage: 27 / 20
  static constexpr int kPerWarp = (kUnits + 4 * kUpNC - 1) / (4 * kUpNC);
  static constexpr int kRawChannel = kRawRows * kRawCols * 2;  // 912 / 880 bytes
  static constexpr int kRawBytes = kUpChannels * kRawChannel;  // 14592 / 14080
  static constexpr int kChunk = kPR * kPW * 16;                // LBO: 6912 / 5120
  static constexpr int kPatch = 2 * kChunk;                    // 13824 / 10240
  static_assert(kRawChannel / 16 % 2 == 1, "an odd number of 16-byte units a raw channel");
  static_assert(kRawBytes <= kUpXSlot, "the raw slot fits");
};
constexpr int kUpPatch = Up2Tile<1>::kPatch;
static_assert(Up2Tile<2>::kPatch <= kUpPatch, "the patch slot fits either tile");
constexpr int kUpSmemBytes = 1024 + kUpSw * kUpWSlot + kUpSx * kUpXSlot + kUpNC * kUpOut +
                             kUpP * kUpPatch + 16 * (kUpSw + kUpSx + kUpP);
static_assert(kUpWSlot % 1024 == 0 && kUpXSlot % 1024 == 0 && kUpOut % 1024 == 0 &&
              kUpPatch % 16 == 0, "aligned slots");
static_assert(kUpSmemBytes <= 232448, "a block's shared memory");

template <int SR>
__host__ __device__ __forceinline__ int up2_tiles(const ConvArgs& a) {
  return a.b * ((a.h + SR - 1) / SR) * ((a.w_ + Up2Tile<SR>::kCols - 1) / Up2Tile<SR>::kCols) *
         ((a.k + kWgM - 1) / kWgM);
}

// Tile u of the walk (channel block fastest): y0 is its first source row.
template <int SR>
__device__ __forceinline__ WgTile up2_tile(const ConvArgs& a, int u) {
  const int kb = (a.k + kWgM - 1) / kWgM;
  const int xt = (a.w_ + Up2Tile<SR>::kCols - 1) / Up2Tile<SR>::kCols;
  const int bands = (a.h + SR - 1) / SR;
  WgTile t;
  t.k0 = (u % kb) * kWgM;
  u /= kb;
  t.x0 = (u % xt) * Up2Tile<SR>::kCols;
  u /= xt;
  t.y0 = (u % bands) * SR;
  t.b = u / bands;
  return t;
}

// The raw rows of a landed stage -> the operand patch: a unit is one raw row
// and one 16-pixel group of all 16 channels, one ldmatrix.x4 (lane 4 g + t:
// channel g of block m's channel half m % 2, pixels 2t, 2t + 1 of its pixel
// half m / 2) and one stmatrix.x4.trans (8 pixels of 16 bytes a block). Warp
// tw of the 8 consumer warps takes units tw, tw + 8, ..., two at a time:
// their loads, then their stores (the transform runs while the products hold
// 128 accumulators a thread).
template <int SR>
__device__ __forceinline__ void up2_transform(uint32_t raw, uint32_t patch, int tw, int lane) {
  using U = Up2Tile<SR>;
  constexpr int kWarps = 4 * kUpNC, kBatch = 2;
  const uint32_t src = raw + (lane & 15) * U::kRawChannel + (lane >> 4) * 16;
  const uint32_t dst = patch + ((lane >> 3) & 1) * U::kChunk + ((lane >> 4) * 8 + (lane & 7)) * 16;
#pragma unroll
  for (int i0 = 0; i0 < U::kPerWarp; i0 += kBatch) {
    uint32_t v[kBatch][4];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = tw + kWarps * (i0 + i), r = e / U::kPairs, q = e - r * U::kPairs;
      if (i0 + i < U::kPerWarp && e < U::kUnits)
        ldmatrix_x4(v[i], src + r * (U::kRawCols * 2) + q * 32);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = tw + kWarps * (i0 + i), r = e / U::kPairs, q = e - r * U::kPairs;
      if (i0 + i < U::kPerWarp && e < U::kUnits)
        stmatrix_x4_trans(dst + (r * U::kPW + 16 * q) * 16, v[i]);
    }
  }
}

// One stage's products of the warpgroup of row phase `pa`: for each column
// phase e and tap (r, s), wp[2 pa + e][2r + s] (64 x 16) times the patch
// shifted by (pa + r, e + s - 1), over each of the tile's SR source rows.
template <int SR>
__device__ __forceinline__ void up2_products(float (&acc)[2][SR][64 / SR], uint32_t wslot,
                                             uint32_t pslot, int pa, bool first) {
  using U = Up2Tile<SR>;
  // each product's descriptors are these plus its constant offset (16-byte
  // units in the address field, which no offset here carries out of)
  const uint64_t da0 = wgmma_desc(wslot + 8 * pa * kWgTapBytes, 1024, 128, 0);
  const uint64_t db0 = wgmma_desc(pslot + (pa * U::kPW + 7) * 16, U::kChunk, 128, 0);
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int r = tap >> 1, s = tap & 1;
      const uint64_t da = da0 + (e * 4 + tap) * (kWgTapBytes / 16);
      const int scale = first && tap == 0 ? 0 : 1;
#pragma unroll
      for (int sr = 0; sr < SR; ++sr) {
        const uint64_t db = db0 + (sr + r) * U::kPW + e + s;
        wgmma_ss<U::kCols>(acc[e][sr], da, db, scale);
      }
    }
}

template <int SR>
__device__ __forceinline__ void fence_acc(float (&acc)[2][SR][64 / SR]) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int sr = 0; sr < SR; ++sr) fence_regs(acc[e][sr]);
}

// grid: min(tiles, SMs) persistent blocks of kUpThreads threads. Warpgroups 0
// and 1 consume (row phase a = the warpgroup) and transform, the last
// warpgroup produces (one lane issues every load).
template <int SR>
__global__ void __launch_bounds__(kUpThreads, 1)
conv3_up2_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap omap, const ConvArgs a) {
  using U = Up2Tile<SR>;
  extern __shared__ __align__(1024) unsigned char up_smem[];
  const uint32_t base = (dtts::smem_addr(up_smem) + 1023u) & ~1023u;
  const uint32_t xbase = base + kUpSw * kUpWSlot;
  const uint32_t obase = xbase + kUpSx * kUpXSlot;
  const uint32_t pbase = obase + kUpNC * kUpOut;
  const uint32_t bar = pbase + kUpP * kUpPatch;
  auto wslot = [&](int s) { return base + s * kUpWSlot; };
  auto xslot = [&](int s) { return xbase + s * kUpXSlot; };
  auto pslot = [&](int s) { return pbase + s * kUpPatch; };
  auto wfull = [&](int s) { return bar + 8u * s; };
  auto wempty = [&](int s) { return bar + 8u * (kUpSw + s); };
  auto xfull = [&](int s) { return bar + 8u * (2 * kUpSw + s); };
  auto xempty = [&](int s) { return bar + 8u * (2 * kUpSw + kUpSx + s); };
  auto pfull = [&](int s) { return bar + 8u * (2 * kUpSw + 2 * kUpSx + s); };
  auto pempty = [&](int s) { return bar + 8u * (2 * kUpSw + 2 * kUpSx + kUpP + s); };
  constexpr int kWarps = 4 * kUpNC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kUpSw; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), kWarps);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < kUpSx; ++s) {
      mbar_init(xfull(s), 1);
      mbar_init(xempty(s), kWarps);  // each consumer warp, after its transform's reads
    }
    for (int s = 0; s < kUpP; ++s) {
      mbar_init(pfull(s), kWarps);   // each consumer warp's share, after its proxy fence
      mbar_init(pempty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = up2_tiles<SR>(a), n = a.c / kUpChannels;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp_id / 4, warp = warp_id % 4;

  if (warp_id >= kWarps) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kUpProducerRegs));
    if (warp_id != kWarps || lane != 0) return;
    const bf16* wsrc = static_cast<const bf16*>(a.w);
    int it = 0;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const WgTile t = up2_tile<SR>(a, u);
      for (int s = 0; s < n; ++s, ++it) {
        const int ws = it % kUpSw, xs = it % kUpSx;
        if (it >= kUpSw) mbar_wait(wempty(ws), ((it / kUpSw) - 1) & 1);
        if (it >= kUpSx) mbar_wait(xempty(xs), ((it / kUpSx) - 1) & 1);
        mbar_expect_tx(wfull(ws), kUpWSlot);
        bulk_load(wslot(ws), wsrc + ((int64_t)(t.k0 / kWgM) * n + s) * (kUpWSlot / 2), kUpWSlot,
                  wfull(ws));
        mbar_expect_tx(xfull(xs), U::kRawBytes);
        tma_load_4d(xslot(xs), &xmap, xfull(xs), t.x0 - 8, t.y0 - 1, s * kUpChannels, t.b);
      }
    }
    return;
  }

  // The consumer warpgroups: role = the row phase. Each warp transforms its
  // share of the next stage's patch right after issuing this stage's
  // products, while the tensor cores run them.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kUpConsumerRegs));
  const int g = lane >> 2, tq = lane & 3;
  // acc[e][sr]: column phase e, the tile's source row sr (SR = 1: all 64)
  float acc[2][SR][64 / SR];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[e][i / (64 / SR)][i % (64 / SR)] = 0.f;
  // stage `it` (global over this block's tiles): raw slot -> patch, then arrivals
  auto transform = [&](int it) {
    const int xs = it % kUpSx, ps = it % kUpP;
    mbar_wait(xfull(xs), (it / kUpSx) & 1);
    if (it >= kUpP) mbar_wait(pempty(ps), ((it / kUpP) - 1) & 1);
    up2_transform<SR>(xslot(xs), pslot(ps), warp_id, lane);
    fence_proxy_async();  // the wgmma products read the patch (the async proxy)
    __syncwarp();
    if (lane == 0) mbar_arrive(pfull(ps)), mbar_arrive(xempty(xs));
  };
  // the stage whose products were issued last is freed once the next
  // stage's products are issued and it has completed
  auto release = [&](int it) {
    if (lane == 0) {
      mbar_arrive(wempty(it % kUpSw));
      mbar_arrive(pempty(it % kUpP));
    }
  };
  const uint32_t out_tile = obase + role * kUpOut;
  const bool elected = warp == 0 && lane == 0;
  const bf16* bias = static_cast<const bf16*>(a.bias);
  int it = 0;
  if (blockIdx.x < tiles) transform(0);
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    const WgTile t = up2_tile<SR>(a, u);
    for (int s = 0; s < n; ++s, ++it) {
      const int ws = it % kUpSw, ps = it % kUpP;
      mbar_wait(wfull(ws), (it / kUpSw) & 1);
      mbar_wait(pfull(ps), (it / kUpP) & 1);
      fence_acc<SR>(acc);
      wgmma_fence();
      up2_products<SR>(acc, wslot(ws), pslot(ps), role, s == 0);
      wgmma_commit();
      if (s > 0) {  // the previous stage of this tile
        wgmma_wait<1>();
        fence_acc<SR>(acc);
        release(it - 1);
      }
      // the next stage (this tile's, or the next tile's first) is transformed
      // during this stage's products
      if (s + 1 < n || u + (int)gridDim.x < tiles) transform(it + 1);
    }
    wgmma_wait<0>();
    fence_acc<SR>(acc);
    release(it - 1);

    // The epilogue: accumulator f = 4 j + 2 r + c of column phase e (acc[e],
    // flattened over its SR rows) is channel k0 + 16 warp + g + 8 r,
    // source pixel n = 8 j + 2 tq + c of the tile's SR x kCols (output
    // column 2 n + e of the flattened rows), so a thread holds output columns
    // 16 j + 4 tq .. + 3, which lie in staging box j / 4 at bytes 32 (j % 4) +
    // 8 tq of the channel's 128-byte row (16-byte unit 2 (j % 4) + tq / 2,
    // swizzled by the row's g). Lanes of odd g take the box's column groups
    // m and m + 2 the other way round: the 16 stores of a half-warp then
    // hit 16 distinct (unit, half) places.
    if (elected) bulk_wait_read<0>();  // the last tile's output has left the staging tile
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + role) : "memory");
    float bv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ch = t.k0 + 16 * warp + g + 8 * r;
      bv[r] = bias != nullptr && ch < a.k ? __bfloat162float(bias[ch]) : 0.f;
    }
    const bool odd = g & 1;
    // the 8 bytes of output columns 16 j + 4 tq .. + 3 (flat column group j)
    auto packed = [&](int j, int r, uint32_t& lo, uint32_t& hi) {
      const int f = 4 * j + 2 * r, sr = f / (64 / SR), i = f % (64 / SR);
      lo = dtts::pack_bf16x2(acc[0][sr][i] + bv[r], acc[1][sr][i] + bv[r]);
      hi = dtts::pack_bf16x2(acc[0][sr][i + 1] + bv[r], acc[1][sr][i + 1] + bv[r]);
    };
    auto store = [&](uint32_t row, int j, uint32_t lo, uint32_t hi) {
      const uint32_t addr = row + (j / 4) * kWgOutBox + (((2 * (j % 4) + (tq >> 1)) ^ g) * 16) +
                            8 * (tq & 1);
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo), "r"(hi)
                   : "memory");
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t row = out_tile + (16 * warp + g + 8 * r) * 128;
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += 4)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int ja = j0 + m, jb = j0 + m + 2;
          uint32_t a0, a1, b0, b1;
          packed(ja, r, a0, a1);
          packed(jb, r, b0, b1);
          store(row, odd ? jb : ja, odd ? b0 : a0, odd ? b1 : a1);
          store(row, odd ? ja : jb, odd ? a0 : b0, odd ? a1 : b1);
        }
    }
    fence_proxy_async();  // the staging tile is read by the TMA store (the async proxy)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + role) : "memory");
    if (elected) {
      constexpr int kBoxesPerRow = 4 / SR;  // 64-column boxes of one output row
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_store_4d(&omap, out_tile + q * kWgOutBox, 2 * t.x0 + 64 * (q % kBoxesPerRow),
                     2 * (t.y0 + q / kBoxesPerRow) + role, t.k0, t.b);
      bulk_commit();
    }
  }
  // the shared memory stays until the last store has read it
  if (elected) bulk_wait<0>();
}

template <int SR>
int launch_up2_wgmma_kernel(const ConvArgs& a, cudaStream_t stream) {
  using U = Up2Tile<SR>;
  CUtensorMap xm, om;
  const cuuint64_t hw = (cuuint64_t)a.h * a.w_;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)a.w_, (cuuint64_t)a.h, (cuuint64_t)a.c,
                                (cuuint64_t)a.b};
    const cuuint64_t strides[3] = {(cuuint64_t)a.w_ * 2, hw * 2, hw * a.c * 2};
    const cuuint32_t box[4] = {U::kRawCols, U::kRawRows, kUpChannels, 1};
    const int e = encode_map(&xm, a.x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  {
    const cuuint64_t dims[4] = {2 * (cuuint64_t)a.w_, 2 * (cuuint64_t)a.h, (cuuint64_t)a.k,
                                (cuuint64_t)a.b};
    const cuuint64_t strides[3] = {4 * (cuuint64_t)a.w_, 8 * hw, 8 * hw * a.k};
    const cuuint32_t box[4] = {64, 1, kWgM, 1};
    const int e = encode_map(&om, a.out, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  cudaError_t err = cudaFuncSetAttribute(conv3_up2_wgmma_kernel<SR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kUpSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = up2_tiles<SR>(a), blocks = tiles < sm_count() ? tiles : sm_count();
  conv3_up2_wgmma_kernel<SR><<<blocks, kUpThreads, kUpSmemBytes, stream>>>(xm, om, a);
  return static_cast<int>(cudaGetLastError());
}

// The up-conv's wgmma route: x as 4-D (W, H, C, B) in boxes of kRawCols x
// kRawRows x 16; the output as 4-D (2W, 2H, K, B) in boxes of 64 x 1 x 64
// (128-byte swizzle); the weights by bulk copies of the caller's blocks.
int launch_up2_wgmma(const ConvArgs& a, cudaStream_t stream) {
  return a.w_ <= kUpNarrow ? launch_up2_wgmma_kernel<2>(a, stream)
                           : launch_up2_wgmma_kernel<1>(a, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// route: 0 = v1, 1 = ring, 2 = wgmma.
int run(const ConvArgs& a, int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.b <= 0 || a.c <= 0 || a.k <= 0 || a.h <= 0 || a.w_ <= 0 ||
      (a.up2 ? 4 * (int64_t)a.b : (int64_t)a.b) > 65535 ||
      (a.residual != nullptr && a.sc_x != nullptr) ||
      ((a.gn_scale == nullptr) != (a.gn_shift == nullptr)) ||
      ((a.sc_x == nullptr) != (a.sc_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {a.x, a.w, a.residual, a.gn_scale, a.gn_shift, a.sc_x, a.sc_w, a.out};
  if (route == 2) {
    for (const void* p : ptrs)
      if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
    if (a.up2) {
      if (dtype != 1 || a.c % kUpChannels || a.w_ % kUpWidth)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_up2_wgmma(a, s);
    }
    if (dtype != 1 || a.c % kWgChannels || a.cres % kWgScChannels || a.w_ % kWgWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(a, s);
  }
  if (route == 1) {
    for (const void* p : ptrs)
      if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype != 1 || a.c % kRingChannels || a.cres % kRingChannels || a.w_ % kRingWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    if (a.up2) return launch_ring<true, false, false>(a, s);
    if (a.gn_scale != nullptr)
      return a.sc_x != nullptr ? launch_ring<false, true, true>(a, s)
                               : launch_ring<false, true, false>(a, s);
    return a.sc_x != nullptr ? launch_ring<false, false, true>(a, s)
                             : launch_ring<false, false, false>(a, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, w, bias, residual, sc_x, sc_w and
// out; gn_scale/gn_shift are fp32. x [B, C, H, W]; w [9, K, C] (tap = 3 dy +
// dx); bias [K]; residual [B, K, H, W]; gn_scale, gn_shift [B, C]; sc_x
// [B, Cres, H, W]; sc_w [K, Cres]; out [B, K, H, W]; all contiguous, each
// optional one null. route: 0 = v1, 1 = ring (bf16, C and Cres multiples of
// 16, W a multiple of 8, every pointer 16-byte aligned), 2 = wgmma (bf16, C a
// multiple of 16, Cres of 32, W of 8, every pointer 16-byte aligned). One
// launch. Returns the launch's cudaError_t (0 on success), or kEncodeFailed +
// the CUresult of a refused tensor map; the caller raises on anything else.
extern "C" int dtts_conv3x3_same(const void* x, const void* w, const void* bias,
                                 const void* residual, const float* gn_scale,
                                 const float* gn_shift, const void* sc_x, const void* sc_w,
                                 void* out, int dtype, int b, int c, int k, int h, int wd,
                                 int cres, int route, void* stream) {
  const ConvArgs a{x, w, bias, residual, gn_scale, gn_shift, sc_x, sc_w, out,
                   b, c, k, h, wd, cres, 0};
  return run(a, dtype, route, stream);
}

// x [B, C, H, W]; w the folded 2x2 phase weights in the activation dtype,
// on routes 0 and 1 [4, 4, K, C] (phase 2 a + e, tap 2 r + s), on route 2 =
// wgmma (bf16, C a multiple of 16, W of 8, every pointer 16-byte aligned) in
// the operand layout [ceil(K / 64)][C / 16][16][2][64][8] (rows past K zero);
// bias [K] or null; out [B, K, 2H, 2W]. One launch.
extern "C" int dtts_conv3x3_up2(const void* x, const void* w, const void* bias, void* out,
                                int dtype, int b, int c, int k, int h, int wd, int route,
                                void* stream) {
  const ConvArgs a{x, w, bias, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                   b, c, k, h, wd, 0, 1};
  return run(a, dtype, route, stream);
}
