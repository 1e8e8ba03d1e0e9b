// 3x3 SAME stride-1 conv with a normalize+SiLU prologue and a fused
// epilogue, and nearest-2x upsample + 3x3 conv, for Hopper (sm_90a), plain C
// interface, contiguous NCHW activations.
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
// What the design does about it. The TPU kernels' haloed row bands, 16-column
// padding, stacked-tap dots and post-dot rolls answer VMEM and the MXU; none
// is carried over. Here one block is an implicit-GEMM tile: 128 output
// channels x (4 rows x 32 columns) output pixels of one image, looping over
// 16-channel stages of the input. Per stage the block puts in shared memory
// the weights of every tap ([tap][128][16]) and the haloed 6 x 34 input patch
// ([pixel][16], with the prologue applied and out-of-image pixels zeroed as
// it is written), then each tap is one shifted read of the same patch. The
// fused 1x1 shortcut is further stages of the same loop over sc_x's channels
// with a single centre tap. up2 is the same loop with four taps per phase,
// the phase taken from the grid, and a strided store.
//   * Staging, not the products, is what a first version spent most of its
//     time on: one element per thread per step, each load waited for in
//     turn (3.31 ms at [4,128,512,512] -> 128 in bf16 on an H100 80GB HBM3 at
//     700 W, by chip_smoke.py). So the weights go to shared memory with
//     cp.async, 16 bytes a copy, in flight while the patch is prepared; and
//     a bf16 patch whose rows are whole and 16-byte aligned is read as two
//     16-byte rows of 8 pixels per thread (two neighbouring channels),
//     normalized in registers with the fast exponential and divide, and
//     written as eight 32-bit channel pairs, lanes laid out so that the
//     stores do not collide (2.11 ms there). Ragged tiles, odd widths and fp32
//     take an element-by-element path with the exact exponential.
//   * bf16: the products run on the tensor cores with mma.sync m16n8k16
//     (bf16 operands, fp32 accumulators: exactly the arithmetic above). Eight
//     warps as 2 (channels) x 4 (pixel rows); a warp owns 64 channels x 32
//     pixels, 16 accumulator fragments. Operand rows in shared memory have a
//     24-element pitch, which makes every fragment load conflict-free.
//   * fp32: the products stay on the CUDA cores in fp32 FMA, so that the
//     kernel holds 1e-4 against an fp32 reference (a TF32 product would
//     not). 16 x 16 threads, each an 8 x 8 register tile.
// Two blocks share an SM (128 registers, 65 KB of shared memory each), so one
// block's products cover the other's staging; within a block the two
// alternate. wgmma, a multi-stage TMA pipeline and a coalesced epilogue
// through shared memory are later work.
// Ragged C, K, H and W are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 128;             // output channels per block
constexpr int kTH = 4, kTW = 32;     // output pixels per block: rows x columns
constexpr int kPR = kTH + 2, kPC = kTW + 2;  // the haloed input patch
constexpr int kCC = 16;              // input channels per shared-memory stage
constexpr int kMaxTaps = 9;

// Per dtype: the shared-memory pitches in elements (XP of a patch pixel's
// channels, WP of a weight row's channels) and the blocks that share an SM.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

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
      float* d = &acc[(i * 4 + j) * 4];
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(b0), "r"(b1));
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

int run(const ConvArgs& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.b <= 0 || a.c <= 0 || a.k <= 0 || a.h <= 0 || a.w_ <= 0 ||
      (a.up2 ? 4 * (int64_t)a.b : (int64_t)a.b) > 65535 ||
      (a.residual != nullptr && a.sc_x != nullptr) ||
      ((a.gn_scale == nullptr) != (a.gn_shift == nullptr)) ||
      ((a.sc_x == nullptr) != (a.sc_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, w, bias, residual, sc_x, sc_w and
// out; gn_scale/gn_shift are fp32. x [B, C, H, W]; w [9, K, C] (tap = 3 dy +
// dx); bias [K]; residual [B, K, H, W]; gn_scale, gn_shift [B, C]; sc_x
// [B, Cres, H, W]; sc_w [K, Cres]; out [B, K, H, W]; all contiguous, each
// optional one null. One launch. Returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int dtts_conv3x3_same(const void* x, const void* w, const void* bias,
                                 const void* residual, const float* gn_scale,
                                 const float* gn_shift, const void* sc_x, const void* sc_w,
                                 void* out, int dtype, int b, int c, int k, int h, int wd,
                                 int cres, void* stream) {
  const ConvArgs a{x, w, bias, residual, gn_scale, gn_shift, sc_x, sc_w, out,
                   b, c, k, h, wd, cres, 0};
  return run(a, dtype, stream);
}

// x [B, C, H, W]; w [4, 4, K, C]: phase 2 a + e, tap 2 r + s, the folded 2x2
// phase weights in the activation dtype; bias [K] or null; out [B, K, 2H, 2W].
// One launch.
extern "C" int dtts_conv3x3_up2(const void* x, const void* w, const void* bias, void* out,
                                int dtype, int b, int c, int k, int h, int wd, void* stream) {
  const ConvArgs a{x, w, bias, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                   b, c, k, h, wd, 0, 1};
  return run(a, dtype, stream);
}
