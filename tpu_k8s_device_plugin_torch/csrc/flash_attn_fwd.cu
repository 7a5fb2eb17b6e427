// Flash attention forward (K4) for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel `_attn_kernel` driven by `_flash_fwd_bhtd`
// (tpu_k8s_device_plugin/workloads/flash_attention.py): causal or full
// attention over [B, T, H, D] with an online softmax in f32, causal runs
// stopping at the diagonal, and rows with no visible key written as 0.
//
// What bounds it on this card.  Attention at head_dim 128 does 4*D = 512
// FLOPs for every visible (query, key) pair and moves only O(T*D) bytes,
// so at T >= 512 it sits far above the H100's ridge point (~295 bf16 FLOPs
// per byte of HBM): it is bound by tensor-core operations, and the [T, T]
// score matrix must never reach memory.  Only `wgmma` reaches the tensor
// cores' full rate, and it stalls whenever a tile is still on its way or
// the softmax between its two products holds the warpgroup.
//
// What the design does about it (bf16).  One block of 384 threads owns 128
// query rows of one (batch, head): a producer warpgroup, which gives its
// registers away (`setmaxnreg`: 24 for it, 240 for each consumer), and two
// consumer warpgroups of 64 rows each.  The producer's first thread loads
// Q once by TMA and streams the K/V tiles of BN keys through a ring of NS
// stages: it waits for a stage's `empty` mbarrier (both consumers have
// handed it back), then loads it with TMA, which reports the bytes to the
// stage's `full` mbarrier.  There is no block barrier in the loop, so the
// consumers drift apart and one's softmax overlaps the other's products.
// Per tile a consumer computes S = Q K^T (m64nBNk16, both operands K-major
// in shared memory), the online softmax in registers in the log2 domain
// (`ex2.approx` of S * scale * log2(e) - max * scale * log2(e)), rounds P
// to bf16 straight from the S accumulator fragments, which are laid out as
// the A fragments of the next product (the TPU kernel's rounding point),
// and starts O += P V (m64nDk16) with P from registers and the V tile read
// MN-major (the transpose bit).  P V runs on while the next tile's S is
// queued behind it; the stage goes back to the producer when both have
// ended.  The mask is applied only on a tile that crosses the diagonal or
// the end of Tk; the running max, sum and O stay in f32; a row with no
// visible key keeps max = -inf, is shifted by 0 instead, and gives 0 (never
// exp(-inf - (-inf))).  The heaviest causal blocks (the last rows) are
// launched first.
//
// Tiles are stored as hopper.cuh describes: [Dp / 64][rows][64] in the
// 128-byte swizzle, Dp = 64 or 128 (head dims below are zero-padded in
// shared memory: TMA reads columns past D and rows past T as 0, and they
// are never written back).  The tensor maps are encoded per call over the
// tensors' (batch, time, head) strides, so the fused-projection views of
// the model need no copy, and query head h reads KV head h / group, so
// grouped K/V are read at their compact size.  With no key at all (Tk = 0)
// no map can be encoded: a small kernel writes the zeros.  An f32 path
// with plain FMAs serves f32 inputs.
//
// With a non-null `lse` the kernel also writes the per-row natural-log
// logsumexp max * scale + log(sum) (f32, [B, H, Tq]; -inf for a row with
// no visible key), the residual the backward kernels (flash_attn_bwd.cu)
// rebuild P from, as the TPU kernel does under `save_residuals`.  The
// running max and sum are already in registers at the end, so the cost is
// one f32 write per row; the inference path passes null and writes nothing
// more.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 384;  // bf16: a producer and two consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // setmaxnreg
constexpr int BM = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int BN = 128;  // keys per streamed tile
constexpr int NS = 3;    // stages of the ring (Q + 3 x 64 KB at D 128: 225 KB)

constexpr int F_BQ = 64;  // f32 path: one thread per query row
constexpr int F_BK = 32;  // f32 path: key rows per shared-memory tile

template <int DP>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          uint16_t* __restrict__ o, float* __restrict__ lse,
                          int D, int Tq, int Tk, int group, Strides os,
                          float scale, int causal) {
  constexpr int QB = BM * DP * 2, KB = BN * DP * 2;  // tile bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // Q, the ring (stage s: K at ring + 2 s KB, V after it), then the
  // barriers: Q in, stage s full, stage s empty
  const uint32_t sQ = smem_u32(smem), ring = sQ + QB;
  const uint32_t qbar = ring + NS * 2 * KB, full = qbar + 8,
                 empty = full + 8 * NS;

  const int h = blockIdx.x, b = blockIdx.z, H = gridDim.x;
  // last query rows first: under a causal mask they have the most work
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int n_tiles = (Tk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BM, Tq) + BN - 1) / BN);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one thread starts every copy
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(qbar, QB);
      for (int c = 0; c < DP / 64; ++c)
        tma_load(sQ + c * BM * 128, &tq, qbar, c * 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        const uint32_t sK = ring + s * 2 * KB;
        if (j >= NS) mbar_wait(empty + 8 * s, (j / NS - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * KB);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(sK + c * BN * 128, &tk, full + 8 * s, c * 64, j * BN, hk,
                   b);
          tma_load(sK + KB + c * BN * 128, &tv, full + 8 * s, c * 64, j * BN,
                   hk, b);
        }
      }
    }
    return;
  }
  regs_up<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;  // arrives for its warpgroup
  const int wrow0 = q0 + wg * 64;  // this warpgroup's first row
  // this thread's rows: row[0] and row[0] + 8
  const int row[2] = {wrow0 + warp * 16 + g, wrow0 + warp * 16 + g + 8};
  const float sl2 = scale * LOG2E;
  // the running max of the raw scores, this thread's share of the row sum
  // (reduced over the quad once, at the end) and O
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  int held = -1;  // the stage that the last P V may still be reading
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN, s = j % NS;
    const uint32_t sK = ring + s * 2 * KB, sV = sK + KB;
    mbar_wait(full + 8 * s, (j / NS) & 1);

    float s_[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<BN>(s_, desc_k(sQ, BM, wg * 64, kk), desc_k(sK, BN, 0, kk),
                   kk);
    wgmma_commit();
    // S is in, and with it the last tile's P V: its stage goes back
    wgmma_wait<0>();
    fence_regs(s_);
    fence_regs(acc);
    if (leader && held >= 0) mbar_arrive(empty + 8 * held);
    held = s;

    // element i: n8 fragment i / 4, row (i / 2) % 2, column pair i % 2
    if ((causal && k0 + BN - 1 > wrow0) || k0 + BN > Tk) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
        if (col >= Tk || (causal && col > row[(i >> 1) & 1]))
          s_[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_[i]);
    float off[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a quad hold one row between them
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no visible key yet keeps m = -inf and is shifted by 0:
      // ex2(-inf) = 0, and no -inf is ever subtracted from -inf
      off[r] = (m_new == -INFINITY) ? 0.f : m_new * sl2;
      corr[r] = ex2(m[r] * sl2 - off[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float p = ex2(fmaf(s_[i], sl2, -off[(i >> 1) & 1]));
      s_[i] = p;
      rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P rounded to bf16 as the A fragments, V read MN-major
    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) a_frag(a[kk], s_, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DP>(acc, a[kk], desc_mn(sV, BN, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = (l[r] == 0.f) ? 1.f : 1.f / l[r];
    if (lse != nullptr && t4 == 0 && row[r] < Tq)
      lse[(static_cast<long long>(b) * H + h) * Tq + row[r]] =
          (l[r] == 0.f) ? -INFINITY : m[r] * scale + logf(l[r]);
  }
#pragma unroll
  for (int n8 = 0; n8 < DP / 8; ++n8) {
    if (n8 * 8 >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Tq) continue;
      uint16_t* out = o + b * os.b + static_cast<long long>(row[r]) * os.t +
                      h * os.h + n8 * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(out) = pack_bf16(
          acc[n8 * 4 + 2 * r] * inv[r], acc[n8 * 4 + 2 * r + 1] * inv[r]);
    }
  }
}

// bf16 with no key at all: every row is empty, so O = 0 and lse = -inf.
// One thread per output row.
__global__ void flash_fwd_bf16_no_keys_kernel(uint16_t* __restrict__ o,
                                              float* __restrict__ lse, int D,
                                              int Tq, int H, Strides os) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= Tq) return;
  uint16_t* out =
      o + b * os.b + static_cast<long long>(row) * os.t + h * os.h;
  for (int d = 0; d < D; ++d) out[d] = 0;
  if (lse != nullptr)
    lse[(static_cast<long long>(b) * H + h) * Tq + row] = -INFINITY;
}

// f32 inputs: one thread per query row, plain FMAs, online softmax one
// key at a time.  Q sits in shared memory column-major, so a warp's
// reads of its 32 rows' element d are 32 consecutive words.
template <int D>
__global__ void __launch_bounds__(F_BQ)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int group,
                         Strides qs, Strides ks,
                         Strides vs, Strides os, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;              // [D][F_BQ]
  float* sK = sQ + D * F_BQ;     // [F_BK][D]
  float* sV = sK + F_BK * D;     // [F_BK][D]

  const int q0 = blockIdx.x * F_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  for (int i = threadIdx.x; i < F_BQ * D; i += F_BQ) {
    const int rr = i / D, c = i % D;
    sQ[c * F_BQ + rr] =
        (q0 + rr < Tq) ? qp[static_cast<long long>(q0 + rr) * qs.t + c] : 0.f;
  }
  const int row = q0 + threadIdx.x;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  int n_tiles = (Tk + F_BK - 1) / F_BK;
  if (causal) n_tiles = min(n_tiles, (q0 + F_BQ + F_BK - 1) / F_BK);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += F_BQ) {
      const int rr = i / D, c = i % D;
      const bool ok = k0 + rr < Tk;
      sK[i] = ok ? kp[static_cast<long long>(k0 + rr) * ks.t + c] : 0.f;
      sV[i] = ok ? vp[static_cast<long long>(k0 + rr) * vs.t + c] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < F_BK; ++jj) {
      const int col = k0 + jj;
      if (col >= Tk || (causal && col > row)) continue;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
        dot = fmaf(sQ[d * F_BQ + threadIdx.x], sK[jj * D + d], dot);
      const float x = dot * scale;
      const float m_new = fmaxf(m, x);
      const float corr = expf(m - m_new);
      const float p = expf(x - m_new);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sV[jj * D + d], acc[d] * corr);
      m = m_new;
    }
  }
  if (row >= Tq) return;
  const float denom = (l == 0.f) ? 1.f : l;
  if (lse != nullptr)
    lse[(static_cast<long long>(b) * gridDim.y + h) * Tq + row] =
        (l == 0.f) ? -INFINITY : m + logf(l);
  float* op = o + b * os.b + static_cast<long long>(row) * os.t + h * os.h;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = acc[d] / denom;
}

// bf16: the head dim padded to DP = 64 or 128 in shared memory
template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Tq, int Tk, int H, int Hkv, int D,
                Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int causal, cudaStream_t stream) {
  uint16_t* out = static_cast<uint16_t*>(o);
  if (Tk == 0) {
    const dim3 grid((Tq + 127) / 128, H, B);
    flash_fwd_bf16_no_keys_kernel<<<grid, 128, 0, stream>>>(out, lse, D, Tq,
                                                            H, os);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(&mq, q, B, Tq, H, D, qs, BM);
  if (r == CUDA_SUCCESS) r = make_map(&mk, k, B, Tk, Hkv, D, ks, BN);
  if (r == CUDA_SUCCESS) r = make_map(&mv, v, B, Tk, Hkv, D, vs, BN);
  if (r != CUDA_SUCCESS) return TMA_ERROR + static_cast<int>(r);
  const int smem = 1024 + (BM + NS * 2 * BN) * DP * 2 + (1 + 2 * NS) * 8;
  cudaError_t e = set_smem(flash_fwd_bf16_kernel<DP>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (Tq + BM - 1) / BM, B);
  flash_fwd_bf16_kernel<DP><<<grid, NT, smem, stream>>>(
      mq, mk, mv, out, lse, D, Tq, Tk, H / Hkv, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Tq, int Tk, int H, int group,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, cudaStream_t stream) {
  const int smem = (D * F_BQ + 2 * F_BK * D) * static_cast<int>(sizeof(float));
  cudaError_t err = set_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + F_BQ - 1) / F_BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, F_BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, Tk,
      group, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, Hkv, D], o [B, Tq, H, D], all with unit
// stride on D (bf16: 16-byte aligned rows); lse [B, H, Tq] f32 contiguous,
// or null for no write.  A size-1 dim's stride may be passed as 0.
// dtype 0 = bf16, 1 = f32.  Launches on `stream` without synchronising.
// Returns 0, a cudaError_t, -1 for an unsupported D, or TMA_ERROR (10000)
// + the CUresult of a bf16 tensor map that could not be encoded.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int B,
                              int Tq, int Tk, int H, int Hkv, int D,
                              long long qsb,
                              long long qst, long long qsh, long long ksb,
                              long long kst, long long ksh, long long vsb,
                              long long vst, long long vsh, long long osb,
                              long long ost, long long osh, float scale,
                              int causal, void* stream) {
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      os{osb, ost, osh};
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 16 || D > 128 || D % 16) return -1;
  if (dtype == 0)
    return D <= 64 ? launch_bf16<64>(q, k, v, o, l, B, Tq, Tk, H, Hkv, D, qs,
                                     ks, vs, os, scale, causal, st)
                   : launch_bf16<128>(q, k, v, o, l, B, Tq, Tk, H, Hkv, D, qs,
                                      ks, vs, os, scale, causal, st);
  switch (D) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return static_cast<int>(launch_f32<DD>(q, k, v, o, l, B, Tq, Tk, H,     \
                                           H / Hkv, qs, ks, vs, os, scale,  \
                                           causal, st));
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return -1;
  }
}
