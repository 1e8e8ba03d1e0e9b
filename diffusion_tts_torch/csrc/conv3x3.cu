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
// Routes. The caller picks one (ops/kernels/conv3x3.py::conv_route) and this
// file obeys:
//   * ring (route 1): bf16 with C and Cres multiples of 16 and W a multiple of 8,
//     every shape of the SD decoder (C, K 128-512, W 64-512). K and H are any.
//   * v1 (route 0): fp32 (FMA on the CUDA cores, so that it holds 1e-4
//     against an fp32 reference with TF32 off; a TF32 product would not), and
//     bf16 at ragged C, Cres or W, which no path of the port has. Its bf16
//     body is also kept for chip_smoke.py's v1_ms, the first design timed
//     beside the ring on the same inputs.
//
// Both routes are implicit GEMMs: a block computes a tile of output channels
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// route: 0 = v1, 1 = ring.
int run(const ConvArgs& a, int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.b <= 0 || a.c <= 0 || a.k <= 0 || a.h <= 0 || a.w_ <= 0 ||
      (a.up2 ? 4 * (int64_t)a.b : (int64_t)a.b) > 65535 ||
      (a.residual != nullptr && a.sc_x != nullptr) ||
      ((a.gn_scale == nullptr) != (a.gn_shift == nullptr)) ||
      ((a.sc_x == nullptr) != (a.sc_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    const void* ptrs[] = {a.x, a.w, a.residual, a.gn_scale, a.gn_shift, a.sc_x, a.sc_w, a.out};
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
// 16, W a multiple of 8, every pointer 16-byte aligned). One launch. Returns
// the launch's cudaError_t (0 on success); the caller raises on anything else.
extern "C" int dtts_conv3x3_same(const void* x, const void* w, const void* bias,
                                 const void* residual, const float* gn_scale,
                                 const float* gn_shift, const void* sc_x, const void* sc_w,
                                 void* out, int dtype, int b, int c, int k, int h, int wd,
                                 int cres, int route, void* stream) {
  const ConvArgs a{x, w, bias, residual, gn_scale, gn_shift, sc_x, sc_w, out,
                   b, c, k, h, wd, cres, 0};
  return run(a, dtype, route, stream);
}

// x [B, C, H, W]; w [4, 4, K, C]: phase 2 a + e, tap 2 r + s, the folded 2x2
// phase weights in the activation dtype; bias [K] or null; out [B, K, 2H, 2W];
// route as above. One launch.
extern "C" int dtts_conv3x3_up2(const void* x, const void* w, const void* bias, void* out,
                                int dtype, int b, int c, int k, int h, int wd, int route,
                                void* stream) {
  const ConvArgs a{x, w, bias, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                   b, c, k, h, wd, 0, 1};
  return run(a, dtype, route, stream);
}
