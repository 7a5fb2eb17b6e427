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
// kernel, y and the index.
//
// What the design does about it.  An implicit GEMM: M = conv pixels, N =
// features, K = window^2 * C, tap-major and channel-minor (the wrapper
// packs the kernel as [F, window^2 * C], the JAX package's tap packing).
// One block of 4 warps owns one image, a tile of pooled rows and 64
// features.  It computes every conv row those pooled rows need exactly
// once (rows 2*p0 .. 2*p0 + 2*rows; neighbouring pool windows share
// rows), 64 pixels at a time.  Each 64x64 slice of the im2col matrix and
// of the packed kernel is copied into shared memory with `cp.async`, the
// SAME halo and the ragged edges zero-filled by the copy itself (no
// padded copy of x exists), through a ring of three slots, so two steps'
// loads are in flight while one computes.  Each thread's pixel
// coordinates are worked out once per 64-pixel tile; a step only splits
// its column into (tap, channel).  Each warp runs `mma.sync.m16n8k16`
// bf16 with f32 accumulation over its 16 pixels x 64 features, its
// fragments read with `ldmatrix`.  The tile is rounded to bf16 into
// shared memory, where the pool runs with K1's rule, and only the pooled
// outputs are written.  Not yet done: TMA, `wgmma`, warp specialisation.
// f32 inputs, which only the tests use, take a plain FMA path with the
// same epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int POOL_W = 3;  // pool window (VALID)
constexpr int POOL_S = 2;  // pool stride
constexpr int BM = 64;     // conv pixels per GEMM tile (4 warps x 16)
constexpr int BN = 64;     // features per block
constexpr int BK = 64;     // contraction per shared tile (4 x 16)
constexpr int NTHREADS = 128;
static_assert(BM == BN, "A and B tiles share one shared-memory shape");
constexpr int STAGES = 3;  // bf16 path: shared tiles in flight
// +8 columns: rows start 16 bytes apart mod 128, so the fragment reads
// and the epilogue's stores hit distinct banks
constexpr int LDA = BK + 8;
constexpr int LDC = BN + 8;
// dynamic shared memory per block: two blocks fit on an SM
constexpr int SMEM_BUDGET = 112 * 1024;

struct Geo {
  int B, H, W, C, F, window, pad, KK;  // KK = window * window * C
  int OH, OW, WC;  // pooled dims; WC = 2 * OW + 1 conv columns pooled
  int PR;          // pooled rows per block
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, round to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pool over the block's rounded conv tile sC [nr * WC][LDC]: one
// thread per (pooled row, pooled column, feature), features fastest so
// the stores coalesce.  K1's rule: seed with offset 0, replace only on a
// strictly greater value; a NaN makes the max NaN with index 0.
template <typename T>
__device__ void pool_epilogue(const T* sC, T* __restrict__ y,
                              int8_t* __restrict__ idx, const Geo& g, int b,
                              int p0, int prs, int f0) {
  for (int o = threadIdx.x; o < prs * g.OW * BN; o += NTHREADS) {
    const int f = o % BN;
    const int pw = (o / BN) % g.OW;
    const int pr = o / (BN * g.OW);
    const T* c = sC + (POOL_S * pr * g.WC + POOL_S * pw) * LDC + f;
    T best = c[0];
    float m = to_f(best);
    int bi = 0;
#pragma unroll
    for (int k = 1; k < POOL_W * POOL_W; ++k) {
      const int di = k / POOL_W, dj = k % POOL_W;
      const T v = c[(di * g.WC + dj) * LDC];
      const float fv = to_f(v);
      if (m != m) break;  // NaN already: stays, index 0
      if (fv != fv) {
        m = fv;
        best = v;
        bi = 0;
      } else if (fv > m) {
        m = fv;
        best = v;
        bi = k;
      }
    }
    const long long out =
        ((static_cast<long long>(b) * g.OH + p0 + pr) * g.OW + pw) * g.F +
        f0 + f;
    y[out] = best;
    idx[out] = static_cast<int8_t>(bi);
  }
}

// 16 bytes global -> shared without a register round trip; src_bytes 0
// writes zeros (the SAME halo and the ragged edges), reading nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(NTHREADS)
    conv_pool_bf16_kernel(const uint16_t* __restrict__ x,
                          const uint16_t* __restrict__ kp,
                          uint16_t* __restrict__ y, int8_t* __restrict__ idx,
                          Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  // STAGES slots of [A tile | B tile], then the block's conv tile
  typedef uint16_t Tile[BM][LDA];
  Tile* sA = reinterpret_cast<Tile*>(smem);
  Tile* sB = sA + STAGES;
  uint16_t* sC = reinterpret_cast<uint16_t*>(sB + STAGES);

  const int f0 = blockIdx.x * BN, p0 = blockIdx.y * g.PR, b = blockIdx.z;
  const int prs = min(g.PR, g.OH - p0);
  const int M = (POOL_S * prs + 1) * g.WC;  // conv pixels of the block
  const int h0 = POOL_S * p0;               // its first conv row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
  const uint16_t* xb = x + static_cast<long long>(b) * g.H * g.W * g.C;
  const uint16_t* kb = kp + static_cast<long long>(f0) * g.KK;
  const int nsteps = (g.KK + BK - 1) / BK;

  // this thread's share of every tile load: 16 bytes at column kc of
  // rows r0, r0 + 16, r0 + 32, r0 + 48 (of A and of B)
  constexpr int ROWS = BM * (BK / 8) / NTHREADS;  // 4
  const int kc = (threadIdx.x % (BK / 8)) * 8;
  const int r0 = threadIdx.x / (BK / 8);

  for (int m0 = 0; m0 < M; m0 += BM) {
    // the input pixel under tap (0, 0) of each of this thread's rows
    int hb[ROWS], wb[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int m = m0 + r0 + j * (BM / ROWS);
      const int row = m / g.WC;
      hb[j] = m < M ? h0 + row - g.pad : -(1 << 20);  // invalid: masked
      wb[j] = m - row * g.WC - g.pad;
    }
    auto load = [&](int slot, int k0) {
      const int k = k0 + kc;
      const bool kok = k < g.KK;
      const int tap = kok ? k / g.C : 0, ch = k - tap * g.C;
      const int di = tap / g.window, dj = tap - di * g.window;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int r = r0 + j * (BM / ROWS);
        const int hh = hb[j] + di, ww = wb[j] + dj;
        const bool ok =
            kok && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
        const uint16_t* src =
            ok ? xb + (static_cast<long long>(hh) * g.W + ww) * g.C + ch : xb;
        cp_async16(&sA[slot][r][kc], src, ok ? 16 : 0);
        cp_async16(&sB[slot][r][kc],
                   kok ? kb + static_cast<long long>(r) * g.KK + k : kb,
                   kok ? 16 : 0);
      }
    };

    float acc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    // a ring of STAGES slots: the loads of step s + STAGES - 1 are in
    // flight while step s computes
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nsteps) load(st, st * BK);
      cp_async_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
      cp_async_wait<STAGES - 2>();  // step s has landed (this thread's part)
      __syncthreads();  // ... every thread's; and step s - 1 is computed
      const int next = s + STAGES - 1;
      if (next < nsteps) load(next % STAGES, next * BK);
      cp_async_commit();
      const int slot = s % STAGES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, &sA[slot][warp * 16 + lane % 16][kk * 16 +
                                                        (lane / 16) * 8]);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bf[4];  // b0, b1 of n-tiles 2 np and 2 np + 1
          ldmatrix_x4(bf, &sB[slot][np * 16 + (lane / 16) * 8 + lane % 8]
                             [kk * 16 + ((lane / 8) & 1) * 8]);
          mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
          mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    // round to bf16 into the block's conv tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + warp * 16 + gq + 8 * i;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        *reinterpret_cast<uint32_t*>(&sC[row * LDC + nt * 8 + t4 * 2]) =
            pack_bf16(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
  __syncthreads();
  pool_epilogue<uint16_t>(sC, y, idx, g, b, p0, prs, f0);
}

// f32 inputs: one thread per (conv pixel, feature) at a time, plain FMAs
// in tap-major, channel-minor order, then the same epilogue.
__global__ void __launch_bounds__(NTHREADS)
    conv_pool_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ kp, float* __restrict__ y,
                         int8_t* __restrict__ idx, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sC = reinterpret_cast<float*>(smem);

  const int f0 = blockIdx.x * BN, p0 = blockIdx.y * g.PR, b = blockIdx.z;
  const int prs = min(g.PR, g.OH - p0);
  const int M = (POOL_S * prs + 1) * g.WC;
  const int h0 = POOL_S * p0;
  const float* xb = x + static_cast<long long>(b) * g.H * g.W * g.C;

  for (int o = threadIdx.x; o < M * BN; o += NTHREADS) {
    const int n = o % BN, m = o / BN;
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
    sC[m * LDC + n] = acc;
  }
  __syncthreads();
  pool_epilogue<float>(sC, y, idx, g, b, p0, prs, f0);
}

int smem_bytes(const Geo& g, int pr, bool bf16) {
  const int tile = (POOL_S * pr + 1) * g.WC * LDC *
                   static_cast<int>(bf16 ? sizeof(uint16_t) : sizeof(float));
  return tile + (bf16 ? STAGES * (BM + BN) * LDA *
                             static_cast<int>(sizeof(uint16_t))
                      : 0);
}

}  // namespace

// x [B, H, W, C] NHWC, kp [F, window^2 * C] (the kernel tap-packed:
// tap-major (di, dj), channel-minor) -> y [B, OH, OW, F] in x's dtype and
// idx [B, OH, OW, F] int8, all contiguous, with OH = (H - 3) / 2 + 1 and
// OW likewise.  dtype 0 = bf16, 1 = f32.  Needs F % 64 == 0, an odd
// window, H, W >= 3, and for bf16 C % 8 == 0 with 16-byte aligned x and
// kp.  Launches on `stream` without synchronising.  Returns 0, a
// cudaError_t, -1 for an unsupported dtype or shape, or -2 when one
// pooled row's tile does not fit in shared memory.
extern "C" int conv_pool_fwd(const void* x, const void* kp, void* y,
                             void* idx, int dtype, int B, int H, int W, int C,
                             int F, int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || F % BN || window % 2 == 0 ||
      H < POOL_W || W < POOL_W || (dtype == 0 && C % 8))
    return -1;
  const bool bf16 = dtype == 0;
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
  // the most pooled rows whose tile fits, then spread evenly over the
  // row tiles so the last one is not a sliver
  int pr = g.OH;
  while (pr > 1 && smem_bytes(g, pr, bf16) > SMEM_BUDGET) --pr;
  if (smem_bytes(g, pr, bf16) > SMEM_BUDGET) return -2;
  const int tiles = (g.OH + pr - 1) / pr;
  g.PR = (g.OH + tiles - 1) / tiles;
  const int smem = smem_bytes(g, g.PR, bf16);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(F / BN, tiles, B);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(conv_pool_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_pool_bf16_kernel<<<grid, NTHREADS, smem, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(kp),
        static_cast<uint16_t*>(y), static_cast<int8_t*>(idx), g);
  } else {
    err = cudaFuncSetAttribute(conv_pool_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_pool_f32_kernel<<<grid, NTHREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(kp),
        static_cast<float*>(y), static_cast<int8_t*>(idx), g);
  }
  return static_cast<int>(cudaGetLastError());
}
