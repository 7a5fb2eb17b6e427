// Fused stride-1 SAME conv + 3x3/s2 VALID max-pool forward (K3) for
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_fused_kernel` driven by
// `_fused_fwd_impl` (tpu_k8s_device_plugin/workloads/convpool.py): an
// odd-window stride-1 conv with SAME padding over NHWC, each conv value
// rounded to the activation dtype (what the unfused conv emits), then the
// 3x3/s2 pool with the first-match int8 index of K1 (csrc/maxpool.cu).
// Only the pooled y [B, OH, OW, F] and the index [B, OH, OW, F] int8
// reach memory; the pre-pool activation never does.
//
// What bounds it on this card.  At AlexNet's stage shapes the conv does
// 2 * K FLOPs per conv value with K = window^2 * C = 432 to 2304, against
// 2 * C / 4 bytes of input per conv value (bf16, stride 1): about 300 to
// 1700 FLOPs per byte of HBM, at or above the H100's ridge (~295 bf16
// FLOPs per byte).  It is bound by tensor-core operations, or close to
// the line for the first stage; the bytes that must move are x, the
// kernel, y and the index.  Only `wgmma` reaches the tensor cores' full
// rate, and the im2col operand, which exists nowhere in memory, has to be
// gathered fast enough to feed it.
//
// What the design does about it (bf16).  An implicit GEMM: M = conv
// pixels, N = features, K = window^2 * C, tap-major and channel-minor (the
// wrapper packs the kernel as [F, window^2 * C], the JAX package's tap
// packing).  One block of 384 threads owns one image, a tile of pooled
// rows and N features, N = 64, 128, 192 or 256: all of F where it divides,
// so the gathered operand serves every feature.  It computes every conv
// row those pooled rows need exactly once (rows 2*p0 .. 2*p0 + 2*rows;
// neighbouring pool windows share rows), 128 pixels at a time, 64 for each
// of two consumer warpgroups.
//
// A third, producer warpgroup fills a ring of stages, each a 128 x 64
// slice of the im2col matrix and the N x 64 slice of the packed kernel
// under it, and runs on across pixel tiles without draining.  The kernel
// slice comes by TMA (a 2-D map over [F, K]; columns past K read as 0).
// The im2col slice is gathered with `cp.async`, 16 bytes (8 channels of
// one tap) a copy, the SAME halo and the ragged edges zero-filled by the
// copy itself (no padded copy of x exists), and written in the 128-byte
// swizzle by hand (16-byte chunk c of row r at chunk c ^ (r % 8)), which
// keeps a 64-wide slice free to span two taps (C = 48); TMA's im2col maps
// would want C a multiple of the slice.  Each thread's pixel coordinates
// are worked out once per pixel tile, and its (tap, channel) advances by
// additions.  The copies and the TMA complete on the stage's `full`
// mbarrier; a consumer waits for it, starts the slice's `wgmma`s
// (m64nNk16, bf16 in, f32 accumulate, both operands read from shared
// memory by the hardware) and hands the stage back
// through its `empty` mbarrier one step later, so a step's products
// overlap the next step's.  There is no block barrier in the loop.
//
// A finished 64 x N tile is rounded to bf16 into the block's conv tile in
// shared memory.  After the last tile the whole block runs the pool with
// K1's rule, eight features a thread (16-byte reads and writes, packed
// bf16 compares), and only the pooled outputs are written.  The launch code sizes the ring (4, 3 or
// 2 stages) and the pooled rows per block from the 227 KB of shared
// memory, taking the split that computes the fewest 128-pixel tiles.
// f32 inputs, which only the tests use, take a plain FMA path with the
// same rule.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int POOL_W = 3;  // pool window (VALID)
constexpr int POOL_S = 2;  // pool stride

constexpr int NT = 384;    // bf16: a producer and two consumer warpgroups
constexpr int TM = 128;    // conv pixels per GEMM tile, 64 per consumer
constexpr int TK = 64;     // contraction per stage: one 128-byte line
constexpr int A_BYTES = TM * TK * 2;
constexpr int PAD = 8;     // conv-tile rows start 16 bytes apart mod 128
constexpr int SMEM_MAX = 227 * 1024;

constexpr int F_BN = 64;        // f32 path: features per block
constexpr int F_LDC = F_BN + PAD;
constexpr int F_THREADS = 128;
constexpr int F_SMEM_BUDGET = 112 * 1024;

struct Geo {
  int B, H, W, C, F, window, pad, KK;  // KK = window * window * C
  int OH, OW, WC;  // pooled dims; WC = 2 * OW + 1 conv columns pooled
  int PR;          // pooled rows per block
  int NS;          // bf16: stages of the ring
};

// K1's rule for one candidate at window offset k: replace only on a
// strictly greater value; a NaN makes the max NaN with index 0 and stays
__device__ __forceinline__ void pool_take(float& m, int& bi, float fv,
                                          int k) {
  if (m == m && (fv != fv || fv > m)) {
    m = fv;
    bi = fv != fv ? 0 : k;
  }
}

template <int N>
__global__ void __launch_bounds__(NT, 1)
    conv_pool_bf16_kernel(const uint16_t* __restrict__ x,
                          const __grid_constant__ CUtensorMap tkp,
                          uint16_t* __restrict__ y, int8_t* __restrict__ idx,
                          Geo g) {
  constexpr int B_BYTES = N * TK * 2, STAGE = A_BYTES + B_BYTES;
  constexpr int LDC = N + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // the ring (stage s: the im2col slice, then the kernel slice), the
  // barriers (stage s full, stage s empty), then the block's conv tile
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + g.NS * STAGE, empty = full + 8 * g.NS;
  uint16_t* sC =
      reinterpret_cast<uint16_t*>(smem + g.NS * STAGE + 16 * g.NS);

  const int f0 = blockIdx.x * N, p0 = blockIdx.y * g.PR, b = blockIdx.z;
  const int prs = min(g.PR, g.OH - p0);
  const int M = (POOL_S * prs + 1) * g.WC;  // conv pixels of the block
  const int h0 = POOL_S * p0;               // its first conv row
  const int nsteps = (g.KK + TK - 1) / TK, ntiles = (M + TM - 1) / TM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.NS; ++s) {
      // the producer's 128 threads (their copies landed) and the thread
      // that announces the TMA's bytes
      mbar_init(full + 8 * s, 129);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer.  This thread copies chunk c (8 channels) of rows r0,
    // r0 + 16, ... of every slice; r % 8 is the same for all of them
    const int c = threadIdx.x % 8, r0 = threadIdx.x / 8;
    const uint32_t dst0 = r0 * 128 + ((c ^ (r0 & 7)) << 4);
    const uint16_t* xb = x + static_cast<long long>(b) * g.H * g.W * g.C;
    int s = 0, round = 0;
    for (int t = 0; t < ntiles; ++t) {
      // the input pixel under tap (0, 0) of each of this thread's rows
      int hb[TM / 16], wb[TM / 16];
#pragma unroll
      for (int j = 0; j < TM / 16; ++j) {
        const int m = t * TM + r0 + 16 * j;
        const int row = m / g.WC;
        hb[j] = m < M ? h0 + row - g.pad : -(1 << 20);  // invalid: masked
        wb[j] = m - row * g.WC - g.pad;
      }
      // column k = 64 step + 8 c of the im2col matrix as (tap row, tap
      // column, channel); past the last tap, di reaches the window
      int ch = 8 * c, di = 0, dj = 0;
      auto carry = [&]() {
        while (ch >= g.C) {
          ch -= g.C;
          if (++dj == g.window) {
            dj = 0;
            ++di;
          }
        }
      };
      carry();
      for (int ks = 0; ks < nsteps; ++ks) {
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t sA = ring + s * STAGE;
        if (threadIdx.x == 0) {
          mbar_expect_tx(full + 8 * s, B_BYTES);
          tma_load_2d(sA + A_BYTES, &tkp, full + 8 * s, ks * TK, f0);
        }
        const bool kok = di < g.window;
#pragma unroll
        for (int j = 0; j < TM / 16; ++j) {
          const int hh = hb[j] + di, ww = wb[j] + dj;
          const bool ok = kok && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
          const uint16_t* from =
              ok ? xb + (static_cast<long long>(hh) * g.W + ww) * g.C + ch
                 : xb;
          cp_async16(sA + dst0 + j * 16 * 128, from, ok ? 16 : 0);
        }
        cp_async_arrive(full + 8 * s);
        ch += TK;
        carry();
        if (++s == g.NS) {
          s = 0;
          ++round;
        }
      }
    }
  } else {
    const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, gq = lane / 4, t4 = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;  // arrives for its warpgroup
    float acc[N / 2];
    int s = 0, round = 0;
    for (int t = 0; t < ntiles; ++t) {
      int held = -1;  // the stage that the last step's wgmmas still read
      for (int ks = 0; ks < nsteps; ++ks) {
        const uint32_t sA = ring + s * STAGE, sB = sA + A_BYTES;
        mbar_wait(full + 8 * s, round & 1);
        fence_proxy_async();  // the gather's writes, before wgmma reads
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          // the first product zeroes the accumulators
          wgmma_ss<N>(acc, desc_k(sA, TM, wg * 64, kk), desc_k(sB, N, 0, kk),
                      ks > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the step before has ended: its stage goes back
        if (leader && held >= 0) mbar_arrive(empty + 8 * held);
        held = s;
        if (++s == g.NS) {
          s = 0;
          ++round;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (leader) mbar_arrive(empty + 8 * held);

      // round to bf16 into the block's conv tile; accumulator a holds
      // feature 8 (a / 4) + 2 t4 + a % 2 of row gq + 8 ((a / 2) % 2) of
      // this warp's 16
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = t * TM + wg * 64 + warp * 16 + gq + 8 * i;
        if (row >= M) continue;
#pragma unroll
        for (int a = 2 * i; a < N / 2; a += 4) {
          const int col = (a / 4) * 8 + t4 * 2;
          *reinterpret_cast<uint32_t*>(&sC[row * LDC + col]) =
              pack_bf16(acc[a], acc[a + 1]);
        }
      }
    }
  }
  __syncthreads();

  // the pool over the block's rounded conv tile sC [M][LDC]: one thread
  // per (pooled row, pooled column, 8 features), features fastest so the
  // stores coalesce
  constexpr int F8 = N / 8;
  for (int o = threadIdx.x; o < prs * g.OW * F8; o += NT) {
    const int f8 = o % F8, pw = (o / F8) % g.OW, pr = o / (F8 * g.OW);
    const uint16_t* cell =
        sC + (POOL_S * pr * g.WC + POOL_S * pw) * LDC + f8 * 8;
    // K1's rule on bf16 pairs: a candidate replaces the best only where
    // it is strictly greater (an ordered compare: false beside a NaN),
    // so the first match wins; a pair's two 16-bit lanes of `bi` hold its
    // window offsets.  NaNs are noted apart and win at the end with
    // offset 0: a bf16 is a NaN when its low 15 bits exceed 0x7f80
    uint32_t m[4], bi[4], nan[4];
#pragma unroll
    for (int k = 0; k < POOL_W * POOL_W; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          cell + ((k / POOL_W) * g.WC + k % POOL_W) * LDC);
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
    const uint4 best = make_uint4(m[0], m[1], m[2], m[3]);
    // the low byte of each 16-bit lane
    const uint2 which = make_uint2(__byte_perm(bi[0], bi[1], 0x6420),
                                   __byte_perm(bi[2], bi[3], 0x6420));
    const long long out =
        ((static_cast<long long>(b) * g.OH + p0 + pr) * g.OW + pw) * g.F +
        f0 + f8 * 8;
    *reinterpret_cast<uint4*>(y + out) = best;
    *reinterpret_cast<uint2*>(idx + out) = which;
  }
}

// f32 inputs: one thread per (conv pixel, feature) at a time, plain FMAs
// in tap-major, channel-minor order, then the pool, one thread an output.
__global__ void __launch_bounds__(F_THREADS)
    conv_pool_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ kp, float* __restrict__ y,
                         int8_t* __restrict__ idx, Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sC = reinterpret_cast<float*>(smem_raw);

  const int f0 = blockIdx.x * F_BN, p0 = blockIdx.y * g.PR, b = blockIdx.z;
  const int prs = min(g.PR, g.OH - p0);
  const int M = (POOL_S * prs + 1) * g.WC;
  const int h0 = POOL_S * p0;
  const float* xb = x + static_cast<long long>(b) * g.H * g.W * g.C;

  for (int o = threadIdx.x; o < M * F_BN; o += F_THREADS) {
    const int n = o % F_BN, m = o / F_BN;
    const int row = m / g.WC, col = m - row * g.WC;
    const float* kr = kp + static_cast<long long>(f0 + n) * g.KK;
    float acc = 0.f;
    for (int di = 0; di < g.window; ++di) {
      const int hh = h0 + row + di - g.pad;
      if (hh < 0 || hh >= g.H) continue;
      for (int dj = 0; dj < g.window; ++dj) {
        const int ww = col + dj - g.pad;
        if (ww < 0 || ww >= g.W) continue;
        const float* xp = xb + (static_cast<long long>(hh) * g.W + ww) * g.C;
        const float* kt = kr + (di * g.window + dj) * g.C;
        for (int c = 0; c < g.C; ++c) acc = fmaf(xp[c], kt[c], acc);
      }
    }
    sC[m * F_LDC + n] = acc;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < prs * g.OW * F_BN; o += F_THREADS) {
    const int f = o % F_BN, pw = (o / F_BN) % g.OW, pr = o / (F_BN * g.OW);
    const float* cell =
        sC + (POOL_S * pr * g.WC + POOL_S * pw) * F_LDC + f;
    float m = cell[0];
    int bi = 0;
#pragma unroll
    for (int k = 1; k < POOL_W * POOL_W; ++k)
      pool_take(m, bi, cell[((k / POOL_W) * g.WC + k % POOL_W) * F_LDC], k);
    const long long out =
        ((static_cast<long long>(b) * g.OH + p0 + pr) * g.OW + pw) * g.F +
        f0 + f;
    y[out] = m;
    idx[out] = static_cast<int8_t>(bi);
  }
}

// the pooled rows per block when `pr` fit: spread evenly over the row
// tiles, so the last one is not a sliver
int spread(int oh, int pr) {
  const int tiles = (oh + pr - 1) / pr;
  return (oh + tiles - 1) / tiles;
}

// bf16: the shared memory of a block of `pr` pooled rows and `ns` stages
int bf16_smem(const Geo& g, int n, int pr, int ns) {
  return 1024 + ns * (A_BYTES + n * TK * 2) +
         (POOL_S * pr + 1) * g.WC * (n + PAD) * 2 + 16 * ns;
}

// bf16: the 128-pixel GEMM tiles one image costs at `pr` pooled rows a
// block
int bf16_tiles(const Geo& g, int pr) {
  int tiles = 0;
  for (int p0 = 0; p0 < g.OH; p0 += pr) {
    const int prs = g.OH - p0 < pr ? g.OH - p0 : pr;
    tiles += ((POOL_S * prs + 1) * g.WC + TM - 1) / TM;
  }
  return tiles;
}

template <int N>
int launch_bf16(const void* x, const void* kp, void* y, void* idx, Geo g,
                cudaStream_t stream) {
  // the ring's depth and the pooled rows per block, from the shared-memory
  // budget: the split with the fewest GEMM tiles, the deeper ring on a tie
  int best = -1;
  for (int ns = 4; ns >= 2; --ns) {
    int pr = g.OH;
    while (pr > 1 && bf16_smem(g, N, pr, ns) > SMEM_MAX) --pr;
    if (bf16_smem(g, N, pr, ns) > SMEM_MAX) continue;
    pr = spread(g.OH, pr);
    const int tiles = bf16_tiles(g, pr);
    if (best < 0 || tiles < best) {
      best = tiles;
      g.PR = pr;
      g.NS = ns;
    }
  }
  if (best < 0) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.KK),
                              static_cast<cuuint64_t>(g.F)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.KK) * 2};
  const cuuint32_t box[2] = {TK, N};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(kp), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return TMA_ERROR + static_cast<int>(r);
  const int smem = bf16_smem(g, N, g.PR, g.NS);
  const cudaError_t err = set_smem(conv_pool_bf16_kernel<N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.F / N, (g.OH + g.PR - 1) / g.PR, g.B);
  conv_pool_bf16_kernel<N><<<grid, NT, smem, stream>>>(
      static_cast<const uint16_t*>(x), map, static_cast<uint16_t*>(y),
      static_cast<int8_t*>(idx), g);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* kp, void* y, void* idx, Geo g,
               cudaStream_t stream) {
  auto smem_bytes = [&](int pr) {
    return (POOL_S * pr + 1) * g.WC * F_LDC * static_cast<int>(sizeof(float));
  };
  int pr = g.OH;
  while (pr > 1 && smem_bytes(pr) > F_SMEM_BUDGET) --pr;
  if (smem_bytes(pr) > F_SMEM_BUDGET) return -2;
  g.PR = spread(g.OH, pr);
  const int smem = smem_bytes(g.PR);
  const cudaError_t err = set_smem(conv_pool_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.F / F_BN, (g.OH + g.PR - 1) / g.PR, g.B);
  conv_pool_f32_kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(kp),
      static_cast<float*>(y), static_cast<int8_t*>(idx), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C] NHWC, kp [F, window^2 * C] (the kernel tap-packed:
// tap-major (di, dj), channel-minor) -> y [B, OH, OW, F] in x's dtype and
// idx [B, OH, OW, F] int8, all contiguous, with OH = (H - 3) / 2 + 1 and
// OW likewise.  dtype 0 = bf16, 1 = f32.  Needs F % 64 == 0, an odd
// window, H, W >= 3, and for bf16 C % 8 == 0 with 16-byte aligned x and
// kp.  Launches on `stream` without synchronising.  Returns 0, a
// cudaError_t, -1 for an unsupported dtype or shape, -2 when one pooled
// row's tile does not fit in shared memory, or TMA_ERROR (10000) + the
// CUresult of a tensor map that could not be encoded.
extern "C" int conv_pool_fwd(const void* x, const void* kp, void* y,
                             void* idx, int dtype, int B, int H, int W, int C,
                             int F, int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || F % 64 || window % 2 == 0 ||
      H < POOL_W || W < POOL_W || (dtype == 0 && C % 8))
    return -1;
  Geo g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.F = F;
  g.window = window;
  g.pad = window / 2;
  g.KK = window * window * C;
  g.OH = (H - POOL_W) / POOL_S + 1;
  g.OW = (W - POOL_W) / POOL_S + 1;
  g.WC = POOL_S * g.OW + 1;
  g.PR = g.NS = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_f32(x, kp, y, idx, g, st);
  // the widest block that divides F: the gathered operand is shared by
  // as many features as possible
  if (F % 256 == 0) return launch_bf16<256>(x, kp, y, idx, g, st);
  if (F % 192 == 0) return launch_bf16<192>(x, kp, y, idx, g, st);
  if (F % 128 == 0) return launch_bf16<128>(x, kp, y, idx, g, st);
  return launch_bf16<64>(x, kp, y, idx, g, st);
}
