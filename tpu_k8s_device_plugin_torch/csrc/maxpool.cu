// VALID max-pool forward with an int8 argmax index (K1) and its scatter
// backward written as a gather (K2), for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (driven by
// `_pool_fwd_impl`) and `_bwd_kernel` (driven by `_pool_bwd_impl`) of
// tpu_k8s_device_plugin/workloads/pool.py.  Both work on NHWC tensors,
// channel fastest; the index is [B, OH, OW, C] int8, the output's layout.
//
// Semantics (held bit-exact against the plain PyTorch versions in
// workloads/pool.py):
// - K1: the window max in the input dtype, and the first row-major window
//   offset whose value equals it.  The running max is seeded with offset
//   0 and replaced only by a strictly greater value, so ties keep the
//   first offset and an all -inf window gives -inf with index 0.  A NaN
//   makes the max NaN with index 0 (no offset compares equal to NaN).
// - K2: dy[b, h, w, c] sums dp[b, i, j, c] over the windows (i, j) that
//   hold (h, w) at offset k = (h - s*i) * window + (w - s*j) and whose
//   index is k, in ascending k, rounding to the gradient's dtype after
//   every add (bf16 sums round at each step, as the TPU kernel's planes
//   do).  Elements that no window selects are 0; dy is written in full.
//
// What bounds them on this card.  Both do a handful of compares or adds
// per byte: they are bound by HBM bytes.  K1 must read x once and write
// y and the index once; K2 must read dp and the index and write dy.
//
// What the design does about it.  In NHWC a band of whole rows of one
// image is one contiguous span of memory, so both kernels stream bands
// through shared memory and read each byte from HBM about once:
// - A work item is (image b, a band of R pooled rows [i0, i0 + R)): R
//   is about 9 input rows' worth for K1 and 8 for K2, fewer where the
//   stages would not fit in shared memory.  K1 needs the (R - 1) s + w
//   input rows under those windows; K2 the pooled rows
//   [i0 - (w - 1) / s, i0 + R) of dp and of the index, the windows that
//   reach the band's input rows [s i0, s (i0 + R)) (the last band also
//   writes the rows past the last window, as zeros).  Neighbouring bands
//   share a halo: w - s input rows (K1), (w - 1) / s pooled rows (K2).
// - A persistent grid (as many blocks as fit on the SMs) walks the items.
//   In the bulk mode one thread copies each band with `cp.async.bulk`
//   into a ring of two stages, each completing on its mbarrier, one item
//   ahead, so the copy of the next band overlaps the pooling of this one.
//   The cooperative mode loads one item at a time with plain loads by the
//   whole block.  The launch code chooses the mode from the shape: bulk
//   where the channels fill 16-byte vectors, every copied row is a
//   multiple of 16 bytes and two stages of one pooled row fit in shared
//   memory.  Where one stage of one pooled row does not fit either, the
//   cooperative items also split the channels into slices.
// - K1: a thread per output pixel and 16 bytes of channels: w * w reads
//   from shared memory (neighbouring threads read neighbouring 16-byte
//   chunks: no bank conflicts), one 16-byte store of y and one 8-byte
//   store of the index (bf16).
// - K2: a thread per s x s block of input pixels (a s + p, c s + q) and
//   16 bytes of channels.  Window (a - m, c - n) holds pixel (p, q) at
//   offset (p + m s) w + (q + n s), known at compile time: the thread
//   reads each window that reaches its block once from shared memory and
//   adds, pixel by pixel, the ones whose index selects it, in ascending
//   offset.
// - Window and stride are template parameters (3/2 for AlexNet; 2/1, 2/2,
//   3/1, 3/3 besides), so every window loop unrolls; any other pair runs
//   the same kernels with them read at run time (and K2 reading each
//   window from shared memory pixel by pixel).  Arithmetic per item is
//   32-bit, with one 64-bit base per image.
// - bf16 at 8 channels a thread works on packed pairs: K1 compares with
//   `__hgt2_mask` and finds NaNs by an integer test (they win with offset
//   0 at the end, as the canonical NaN); K2 selects by byte compares of
//   the index and adds with `__hadd2`, which rounds each sum to bf16 as
//   the plain version's adds do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;
// the mbarriers sit before the ring, in the first BARS bytes
constexpr int BARS = 128;
// stages of the bulk mode's ring: the copy of the next band overlaps the
// pooling of this one (the cooperative mode has one)
constexpr int NS = 2;
// shared memory a block may take on an H100
constexpr int SMEM_MAX = 232448;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// a + b rounded to the storage type (round to nearest even for bf16);
// a bf16 sum formed in f32 and rounded once equals the correctly rounded
// bf16 sum
__device__ __forceinline__ float add_round(float a, float b) { return a + b; }
__device__ __forceinline__ uint16_t add_round(uint16_t a, uint16_t b) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(to_f(a) + to_f(b)));
}

// two bf16 sums at once, each correctly rounded
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 s =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&s);
}

struct Geo {
  int B, H, W, C, OH, OW;
  int win, str;  // window and stride (the kernels built for a pair
                 // take them from their template parameters)
  int R;         // pooled rows a band
  int bands;     // bands an image
  int cs;        // channels a slice (C in the bulk mode)
  int slices;    // slices a band
  int stage;     // bytes of a stage
  int idx_off;   // K2: where a stage's index rows start
  int bulk;      // 1: cp.async.bulk ring of NS stages, 0: cooperative
};

// an item: image b, pooled rows [i0, i0 + nr), channels [c0, c0 + cn)
struct Band {
  int b, i0, nr, c0, cn;
};

__device__ __forceinline__ Band band_of(int item, const Geo& g) {
  Band d;
  const int band = item / g.slices;
  d.c0 = (item - band * g.slices) * g.cs;
  d.cn = min(g.cs, g.C - d.c0);
  d.b = band / g.bands;
  d.i0 = (band - d.b * g.bands) * g.R;
  d.nr = min(g.R, g.OH - d.i0);
  return d;
}

__device__ __forceinline__ void init_ring(const Geo& g, uint32_t bars) {
  if (g.bulk && threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// n rows of `pixels` pixels x cn channels from global memory (a pixel
// every C elements) into shared memory (a pixel every cn), by the block
template <typename T, int VEC>
__device__ __forceinline__ void load_pixels(T* dst, const T* src,
                                            int pixels, int cn, int C) {
  const int groups = cn / VEC;
  for (int e = threadIdx.x; e < pixels * groups; e += NT) {
    const int p = e / groups, v = e - p * groups;
    *reinterpret_cast<Vec<T, VEC>*>(dst + e * VEC) =
        *reinterpret_cast<const Vec<T, VEC>*>(src + p * C + v * VEC);
  }
}

// ---- K1 -----------------------------------------------------------------

// K1's band of an item: its first input element (channel c0) and its rows
template <int WIN, int STR>
__device__ __forceinline__ long long fwd_src(const Geo& g, const Band& d,
                                             int* rows) {
  const int win = WIN ? WIN : g.win, str = WIN ? STR : g.str;
  *rows = (d.nr - 1) * str + win;
  return (static_cast<long long>(d.b) * g.H + d.i0 * str) * g.W * g.C +
         d.c0;
}

template <typename T, int WIN, int STR>
__device__ __forceinline__ void fwd_issue(const T* x, const Geo& g, int item,
                                          unsigned char* stage,
                                          uint32_t bar) {
  int rows;
  const long long src = fwd_src<WIN, STR>(g, band_of(item, g), &rows);
  const int bytes = rows * g.W * g.C * static_cast<int>(sizeof(T));
  mbar_expect_tx(bar, bytes);
  bulk_load(smem_u32(stage), x + src, bytes, bar);
}

// one output pixel, VEC channels: `cell` is tap (0, 0) of its window in
// shared memory, `row` the elements of an input row there and `pix` of a
// pixel
template <typename T, int VEC, int WIN>
__device__ __forceinline__ void pool_cell(const T* cell, int row, int pix,
                                          int win_rt, T* yo, int8_t* io) {
  const int win = WIN ? WIN : win_rt;
  if constexpr (sizeof(T) == 2 && VEC == 8) {
    // K1's rule on bf16 pairs: a candidate replaces the best only where
    // it is strictly greater (an ordered compare: false beside a NaN);
    // a pair's two 16-bit lanes of `bi` hold its window offsets.  A bf16
    // is a NaN when its low 15 bits exceed 0x7f80
    uint32_t m[4], bi[4], nan[4];
#pragma unroll
    for (int k = 0; k < win * win; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          cell + (k / win) * row + (k % win) * pix);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t is_nan =
            ((w[e] & 0x7fff7fffu) + 0x007f007fu) & 0x80008000u;
        if (k == 0) {
          m[e] = w[e];
          bi[e] = 0;
          nan[e] = is_nan;
        } else {
          const uint32_t gt = __hgt2_mask(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]),
              *reinterpret_cast<const __nv_bfloat162*>(&m[e]));
          m[e] = (w[e] & gt) | (m[e] & ~gt);
          bi[e] = ((k * 0x00010001u) & gt) | (bi[e] & ~gt);
          nan[e] |= is_nan;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lanes = ((nan[e] >> 15) & 0x00010001u) * 0xffffu;
      m[e] = (m[e] & ~lanes) | (0x7fc07fc0u & lanes);
      bi[e] &= ~lanes;
    }
    *reinterpret_cast<uint4*>(yo) = make_uint4(m[0], m[1], m[2], m[3]);
    // the low byte of each 16-bit lane
    *reinterpret_cast<uint2*>(io) =
        make_uint2(__byte_perm(bi[0], bi[1], 0x6420),
                   __byte_perm(bi[2], bi[3], 0x6420));
  } else {
    // VEC is 4 (f32) or 1; the offsets stay in 32-bit registers (a
    // struct of int8 updated by lane goes through the stack)
    Vec<T, VEC> best = *reinterpret_cast<const Vec<T, VEC>*>(cell);
    float m[VEC];
    uint32_t id[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[e] = to_f(best.v[e]);
      id[e] = 0;
    }
#pragma unroll
    for (int k = 1; k < win * win; ++k) {
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(
          cell + (k / win) * row + (k % win) * pix);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f(v.v[e]);
        if (f != f) {  // NaN wins, with index 0, and stays
          m[e] = f;
          best.v[e] = v.v[e];
          id[e] = 0;
        } else if (f > m[e]) {
          m[e] = f;
          best.v[e] = v.v[e];
          id[e] = k;
        }
      }
    }
    *reinterpret_cast<Vec<T, VEC>*>(yo) = best;
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint32_t*>(io) =
          id[0] | id[1] << 8 | id[2] << 16 | id[3] << 24;
    } else {
      static_assert(VEC == 1, "K1 takes 8 bf16, 4 f32 or 1 channel a thread");
      *io = static_cast<int8_t>(id[0]);
    }
  }
}

template <typename T, int VEC, int WIN, int STR>
__global__ void __launch_bounds__(NT)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       int8_t* __restrict__ idx, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = smem + BARS;
  const int str = WIN ? STR : g.str;
  const int items = g.B * g.bands * g.slices;
  init_ring(g, bars);
  if (g.bulk && threadIdx.x == 0 && blockIdx.x < items)
    fwd_issue<T, WIN, STR>(x, g, blockIdx.x, ring, bars);

  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Band d = band_of(item, g);
    const int s = n % NS;
    if (g.bulk) {
      if (threadIdx.x == 0) {
        // the other stage was read in the last round, which every thread
        // has left
        const int ahead = item + gridDim.x;
        if (ahead < items)
          fwd_issue<T, WIN, STR>(x, g, ahead, ring + (1 - s) * g.stage,
                                 bars + 8 * (1 - s));
      }
      mbar_wait(bars + 8 * s, (n / NS) & 1);
    } else {
      int rows;
      const long long src = fwd_src<WIN, STR>(g, d, &rows);
      load_pixels<T, VEC>(reinterpret_cast<T*>(ring), x + src, rows * g.W,
                          d.cn, g.C);
      __syncthreads();
    }
    const T* buf =
        reinterpret_cast<const T*>(ring + (g.bulk ? s * g.stage : 0));
    const long long out0 =
        (static_cast<long long>(d.b) * g.OH + d.i0) * g.OW * g.C + d.c0;
    const int groups = d.cn / VEC, row = g.W * d.cn;
    const int tasks = d.nr * g.OW * groups;
    for (int t = threadIdx.x; t < tasks; t += NT) {
      const int p = t / groups, cg = t - p * groups;
      const int oi = p / g.OW, ow = p - oi * g.OW;
      const int out = p * g.C + cg * VEC;
      pool_cell<T, VEC, WIN>(
          buf + (oi * str * g.W + ow * str) * d.cn + cg * VEC, row, d.cn,
          g.win, y + out0 + out, idx + out0 + out);
    }
    __syncthreads();
  }
}

// ---- K2 -----------------------------------------------------------------

// K2's band of an item: pooled rows [lo, hi) land at local row
// lo - (i0 - mm) of the stage, so window row i is local row i - i0 + mm
__device__ __forceinline__ void bwd_rows(const Geo& g, const Band& d, int mm,
                                         int* lo, int* hi) {
  *lo = max(0, d.i0 - mm);
  *hi = min(g.OH, d.i0 + g.R);
}

template <typename T>
__device__ __forceinline__ void bwd_issue(const int8_t* idx, const T* dp,
                                          const Geo& g, int mm, int item,
                                          unsigned char* stage,
                                          uint32_t bar) {
  const Band d = band_of(item, g);
  int lo, hi;
  bwd_rows(g, d, mm, &lo, &hi);
  const int prow = g.OW * g.C;
  const long long src = (static_cast<long long>(d.b) * g.OH + lo) * prow;
  const int at = (lo - d.i0 + mm) * prow, n = (hi - lo) * prow;
  const int esize = static_cast<int>(sizeof(T));
  mbar_expect_tx(bar, n * (esize + 1));
  bulk_load(smem_u32(stage) + at * esize, dp + src, n * esize, bar);
  bulk_load(smem_u32(stage + g.idx_off) + at, idx + src, n, bar);
}

// the s x s input pixels of block (a, c), VEC channels from cg * VEC of
// the item's slice of cn channels: `sdp` and `sidx` are window (a, 0)'s
// row in shared memory, `dyb` the image's gradient at the slice's first
// channel
template <typename T, int VEC, int WIN, int STR>
__device__ __forceinline__ void scatter_block(const T* sdp,
                                              const int8_t* sidx, int a,
                                              int c, int cg, int cn,
                                              const Geo& g, T* dyb) {
  const int srow = g.OW * cn;
  if constexpr (WIN == 0) {
    // window and stride at run time: each pixel reads the windows that
    // hold it from shared memory, in ascending offset
    const int win = g.win, str = g.str, mm = (win - 1) / str;
    for (int p = 0; p < str; ++p)
      for (int q = 0; q < str; ++q) {
        const int h = a * str + p, w = c * str + q;
        if (h >= g.H || w >= g.W) continue;
        Vec<T, VEC> acc;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc.v[e] = T(0);
        for (int m = 0; m <= mm && p + m * str < win && a - m >= 0; ++m) {
          if (a - m >= g.OH) continue;
          for (int n = 0; n <= mm && q + n * str < win && c - n >= 0; ++n) {
            if (c - n >= g.OW) continue;
            const int k = (p + m * str) * win + q + n * str;
            const int off = -m * srow + (c - n) * cn + cg * VEC;
            const Vec<T, VEC> gv =
                *reinterpret_cast<const Vec<T, VEC>*>(sdp + off);
            const Vec<int8_t, VEC> iv =
                *reinterpret_cast<const Vec<int8_t, VEC>*>(sidx + off);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if (iv.v[e] == k) acc.v[e] = add_round(acc.v[e], gv.v[e]);
          }
        }
        *reinterpret_cast<Vec<T, VEC>*>(dyb + (h * g.W + w) * g.C +
                                        cg * VEC) = acc;
      }
  } else {
    constexpr int MM = (WIN - 1) / STR;
    constexpr int NW = MM + 1;  // windows a side that reach the block
    bool ok[NW][NW];
    int off[NW][NW];
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const int i = a - m, j = c - n;
        ok[m][n] = i >= 0 && i < g.OH && j >= 0 && j < g.OW;
        off[m][n] = -m * srow + j * cn + cg * VEC;
      }
    if constexpr (sizeof(T) == 2 && VEC == 8) {
      uint4 gv[NW][NW];
      uint2 iv[NW][NW];
#pragma unroll
      for (int m = 0; m < NW; ++m)
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          if (ok[m][n]) {
            gv[m][n] = *reinterpret_cast<const uint4*>(sdp + off[m][n]);
            iv[m][n] = *reinterpret_cast<const uint2*>(sidx + off[m][n]);
          } else {  // a window off the image selects nothing
            gv[m][n] = make_uint4(0, 0, 0, 0);
            iv[m][n] = make_uint2(0xffffffffu, 0xffffffffu);
          }
        }
#pragma unroll
      for (int p = 0; p < STR; ++p)
#pragma unroll
        for (int q = 0; q < STR; ++q) {
          const int h = a * STR + p, w = c * STR + q;
          if (h >= g.H || w >= g.W) continue;
          uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (int m = 0; m < NW; ++m)
#pragma unroll
            for (int n = 0; n < NW; ++n) {
              const int di = p + m * STR, dj = q + n * STR;
              if (di >= WIN || dj >= WIN) continue;
              const uint32_t k = (di * WIN + dj) * 0x01010101u;
              // 0xff in each byte of the index equal to k, widened to the
              // 16-bit lanes of the gradient's pairs
              const uint32_t e0 = __vcmpeq4(iv[m][n].x, k);
              const uint32_t e1 = __vcmpeq4(iv[m][n].y, k);
              const uint4 v = gv[m][n];
              acc[0] = add_bf16x2(acc[0], v.x & __byte_perm(e0, 0, 0x1100));
              acc[1] = add_bf16x2(acc[1], v.y & __byte_perm(e0, 0, 0x3322));
              acc[2] = add_bf16x2(acc[2], v.z & __byte_perm(e1, 0, 0x1100));
              acc[3] = add_bf16x2(acc[3], v.w & __byte_perm(e1, 0, 0x3322));
            }
          *reinterpret_cast<uint4*>(dyb + (h * g.W + w) * g.C + cg * VEC) =
              make_uint4(acc[0], acc[1], acc[2], acc[3]);
        }
    } else {
      Vec<T, VEC> gv[NW][NW];
      Vec<int8_t, VEC> iv[NW][NW];
#pragma unroll
      for (int m = 0; m < NW; ++m)
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          if (ok[m][n]) {
            gv[m][n] = *reinterpret_cast<const Vec<T, VEC>*>(sdp + off[m][n]);
            iv[m][n] =
                *reinterpret_cast<const Vec<int8_t, VEC>*>(sidx + off[m][n]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              gv[m][n].v[e] = T(0);
              iv[m][n].v[e] = -1;
            }
          }
        }
#pragma unroll
      for (int p = 0; p < STR; ++p)
#pragma unroll
        for (int q = 0; q < STR; ++q) {
          const int h = a * STR + p, w = c * STR + q;
          if (h >= g.H || w >= g.W) continue;
          Vec<T, VEC> acc;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc.v[e] = T(0);
#pragma unroll
          for (int m = 0; m < NW; ++m)
#pragma unroll
            for (int n = 0; n < NW; ++n) {
              const int di = p + m * STR, dj = q + n * STR;
              if (di >= WIN || dj >= WIN) continue;
              const int k = di * WIN + dj;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                if (iv[m][n].v[e] == k)
                  acc.v[e] = add_round(acc.v[e], gv[m][n].v[e]);
            }
          *reinterpret_cast<Vec<T, VEC>*>(
              dyb + (h * g.W + w) * g.C + cg * VEC) = acc;
        }
    }
  }
}

template <typename T, int VEC, int WIN, int STR>
__global__ void __launch_bounds__(NT)
    maxpool_bwd_kernel(const int8_t* __restrict__ idx,
                       const T* __restrict__ dp, T* __restrict__ dy,
                       Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = smem + BARS;
  const int str = WIN ? STR : g.str;
  const int mm = ((WIN ? WIN : g.win) - 1) / str;
  const int items = g.B * g.bands * g.slices;
  const int cblocks = (g.W + str - 1) / str;
  init_ring(g, bars);
  if (g.bulk && threadIdx.x == 0 && blockIdx.x < items)
    bwd_issue<T>(idx, dp, g, mm, blockIdx.x, ring, bars);

  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Band d = band_of(item, g);
    const int s = n % NS;
    unsigned char* stage = ring + (g.bulk ? s * g.stage : 0);
    if (g.bulk) {
      if (threadIdx.x == 0) {
        const int ahead = item + gridDim.x;
        if (ahead < items)
          bwd_issue<T>(idx, dp, g, mm, ahead, ring + (1 - s) * g.stage,
                       bars + 8 * (1 - s));
      }
      mbar_wait(bars + 8 * s, (n / NS) & 1);
    } else {
      int lo, hi;
      bwd_rows(g, d, mm, &lo, &hi);
      const long long src =
          (static_cast<long long>(d.b) * g.OH + lo) * g.OW * g.C + d.c0;
      const int at = (lo - d.i0 + mm) * g.OW * d.cn;
      load_pixels<T, VEC>(reinterpret_cast<T*>(stage) + at, dp + src,
                          (hi - lo) * g.OW, d.cn, g.C);
      load_pixels<int8_t, VEC>(
          reinterpret_cast<int8_t*>(stage + g.idx_off) + at, idx + src,
          (hi - lo) * g.OW, d.cn, g.C);
      __syncthreads();
    }
    // block rows [i0, i0 + R); the last band also takes the rows past
    // its windows
    const int aend =
        d.i0 + g.R >= g.OH ? (g.H + str - 1) / str : d.i0 + g.R;
    const int groups = d.cn / VEC, srow = g.OW * d.cn;
    const int tasks = (aend - d.i0) * cblocks * groups;
    T* dyb = dy + static_cast<long long>(d.b) * g.H * g.W * g.C + d.c0;
    for (int t = threadIdx.x; t < tasks; t += NT) {
      const int p = t / groups, cg = t - p * groups;
      const int ar = p / cblocks, c = p - ar * cblocks;
      const int local = (ar + mm) * srow;  // window row i0 + ar
      scatter_block<T, VEC, WIN, STR>(
          reinterpret_cast<const T*>(stage) + local,
          reinterpret_cast<const int8_t*>(stage + g.idx_off) + local,
          d.i0 + ar, c, cg, d.cn, g, dyb);
    }
    __syncthreads();
  }
}

// ---- launch -------------------------------------------------------------

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// one launch: the operands (K1: x, y, idx; K2: idx, dp, dy), the shape,
// channels a thread and where to report the plan
struct Call {
  const void* a;
  const void* b;
  void* c;
  Geo g;
  int vec;
  int* plan;
  cudaStream_t stream;
};

// The load mode, the channels a slice and the pooled rows a band.  Bulk
// where `bulk_ok` and two stages of one pooled row of every channel fit;
// else cooperative, one stage, with the channels split into even slices
// (multiples of vec) where one pooled row of them does not fit.  R is
// `want`, lowered until the stages fit, then spread evenly over the bands
// so the last is not a sliver.  `stage_of(R, cs)` gives a stage's bytes.
// Returns -2 when one pooled row of vec channels does not fit.
template <typename StageOf>
int plan_bands(Geo& g, int vec, bool bulk_ok, int want, StageOf stage_of) {
  g.bulk = bulk_ok && BARS + NS * stage_of(1, g.C) <= SMEM_MAX;
  const int budget = (SMEM_MAX - BARS) / (g.bulk ? NS : 1);
  int cs = g.C;
  while (cs > vec && stage_of(1, cs) > budget) cs -= vec;
  const int slices = (g.C + cs - 1) / cs;
  g.cs = round_up((g.C + slices - 1) / slices, vec);
  g.slices = (g.C + g.cs - 1) / g.cs;
  int R = std::min(want, g.OH);
  while (R > 1 && stage_of(R, g.cs) > budget) --R;
  g.bands = (g.OH + R - 1) / R;
  g.R = (g.OH + g.bands - 1) / g.bands;
  g.stage = stage_of(g.R, g.cs);
  return g.stage > budget ? -2 : 0;
}

// a persistent grid, as many blocks as fit on the card's SMs (at most one
// an item); reports the plan (pooled rows a band, channels a slice,
// shared memory bytes a block, blocks, bulk) where asked for
template <typename Kernel>
int grid_for(Kernel kernel, const Call& k, const Geo& g, int smem,
             int* grid) {
  cudaError_t err = set_smem(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = std::max(
      1, std::min(g.B * g.bands * g.slices, sms * std::max(per_sm, 1)));
  if (k.plan) {
    k.plan[0] = g.R;
    k.plan[1] = g.cs;
    k.plan[2] = smem;
    k.plan[3] = *grid;
    k.plan[4] = g.bulk;
  }
  return 0;
}

template <typename T, int VEC, int WIN, int STR>
int launch_fwd(const Call& k) {
  Geo g = k.g;
  const int esize = static_cast<int>(sizeof(T));
  // about 9 input rows a band; every row is a multiple of 16 bytes where
  // the channels fill 16-byte vectors
  const int want = std::max(1, (9 - g.win) / g.str + 1);
  int err = plan_bands(g, VEC, VEC > 1, want, [&](int R, int cs) {
    return round_up(((R - 1) * g.str + g.win) * g.W * cs * esize, 128);
  });
  if (err) return err;
  const int smem = BARS + (g.bulk ? NS : 1) * g.stage;
  auto kernel = maxpool_fwd_kernel<T, VEC, WIN, STR>;
  int grid = 0;
  if ((err = grid_for(kernel, k, g, smem, &grid))) return err;
  kernel<<<grid, NT, smem, k.stream>>>(
      static_cast<const T*>(k.a), static_cast<T*>(const_cast<void*>(k.b)),
      static_cast<int8_t*>(k.c), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int WIN, int STR>
int launch_bwd(const Call& k) {
  Geo g = k.g;
  const int esize = static_cast<int>(sizeof(T));
  const int mm = (g.win - 1) / g.str;
  // 8 pooled rows a band: K2 reads the halo of (w - 1) / s pooled rows
  // once a band, and its stages are small beside K1's.  The index rows
  // of OW * C bytes set the bulk mode's alignment
  auto idx_off = [&](int R, int cs) {
    return round_up((R + mm) * g.OW * cs * esize, 128);
  };
  int err = plan_bands(
      g, VEC, VEC > 1 && g.OW * g.C % 16 == 0, 8, [&](int R, int cs) {
        return idx_off(R, cs) + round_up((R + mm) * g.OW * cs, 128);
      });
  if (err) return err;
  g.idx_off = idx_off(g.R, g.cs);
  const int smem = BARS + (g.bulk ? NS : 1) * g.stage;
  auto kernel = maxpool_bwd_kernel<T, VEC, WIN, STR>;
  int grid = 0;
  if ((err = grid_for(kernel, k, g, smem, &grid))) return err;
  kernel<<<grid, NT, smem, k.stream>>>(static_cast<const int8_t*>(k.a),
                                       static_cast<const T*>(k.b),
                                       static_cast<T*>(k.c), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int WIN, int STR>
int launch(bool fwd, const Call& k) {
  return fwd ? launch_fwd<T, VEC, WIN, STR>(k)
             : launch_bwd<T, VEC, WIN, STR>(k);
}

template <int WIN, int STR>
int dispatch(bool fwd, int dtype, const Call& k) {
  if (dtype == 0 && k.vec == 8) return launch<uint16_t, 8, WIN, STR>(fwd, k);
  if (dtype == 0 && k.vec == 1) return launch<uint16_t, 1, WIN, STR>(fwd, k);
  if (dtype == 1 && k.vec == 4) return launch<float, 4, WIN, STR>(fwd, k);
  if (dtype == 1 && k.vec == 1) return launch<float, 1, WIN, STR>(fwd, k);
  return -1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int run(bool fwd, int dtype, int window, int stride, Call k) {
  if (window < 1 || stride < 1 || window * window > 127) return -1;
  // 16-byte vectors (and the bulk copies) need C to fill them and every
  // operand aligned
  if (k.vec > 1 && (k.g.C % k.vec || !aligned16(k.a) || !aligned16(k.b) ||
                    !aligned16(k.c)))
    return -1;
  k.g.win = window;
  k.g.str = stride;
  k.g.OH = (k.g.H - window) / stride + 1;
  k.g.OW = (k.g.W - window) / stride + 1;
  switch (window * 10 + stride) {
    case 21: return dispatch<2, 1>(fwd, dtype, k);
    case 22: return dispatch<2, 2>(fwd, dtype, k);
    case 31: return dispatch<3, 1>(fwd, dtype, k);
    case 32: return dispatch<3, 2>(fwd, dtype, k);
    case 33: return dispatch<3, 3>(fwd, dtype, k);
  }
  return dispatch<0, 0>(fwd, dtype, k);
}

Geo shape(int B, int H, int W, int C) {
  Geo g{};
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  return g;
}

}  // namespace

// x [B, H, W, C] -> y [B, OH, OW, C] (x's dtype) and idx [B, OH, OW, C]
// int8, all contiguous.  dtype 0 = bf16, 1 = f32; any window (window²
// <= 127) and stride.  vec = channels a thread: 8 (bf16) or 4 (f32) where
// C and every pointer allow 16-byte accesses, else 1.  plan, if not null,
// receives 5 ints: pooled rows a band, channels a slice, shared memory a
// block, blocks, and 1 for the bulk mode (0: cooperative).  Launches on
// `stream` without synchronising.  Returns 0, a cudaError_t, -1 for an
// unsupported dtype, window/stride or vec (or a vec > 1 that C or a
// pointer's alignment does not allow), or -2 when one pooled row of vec
// channels does not fit in shared memory.
extern "C" int maxpool_fwd(const void* x, void* y, void* idx, int dtype,
                           int B, int H, int W, int C, int window,
                           int stride, int vec, int* plan, void* stream) {
  return run(true, dtype, window, stride,
             Call{x, y, idx, shape(B, H, W, C), vec, plan,
                  static_cast<cudaStream_t>(stream)});
}

// idx, dp [B, OH, OW, C] -> dy [B, H, W, C] (dp's dtype), all contiguous;
// the arguments as for maxpool_fwd, with (B, H, W, C) the input's shape.
extern "C" int maxpool_bwd(const void* idx, const void* dp, void* dy,
                           int dtype, int B, int H, int W, int C, int window,
                           int stride, int vec, int* plan, void* stream) {
  return run(false, dtype, window, stride,
             Call{idx, dp, dy, shape(B, H, W, C), vec, plan,
                  static_cast<cudaStream_t>(stream)});
}
