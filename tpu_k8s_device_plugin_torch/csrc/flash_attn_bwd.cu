// Flash attention backward for Hopper (sm_90a), with a plain C interface:
// K5 (dQ) and K6 (dK, dV).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` driven by
// `_flash_bwd_bhtd` (tpu_k8s_device_plugin/workloads/flash_attention.py).
// Given the forward's per-row logsumexp `lse` and delta = sum_d dO * O
// (both f32, [B, H, Tq]), each rebuilds P = exp(S * scale - lse) tile by
// tile, so the [T, T] matrices never reach memory:
//
//   K5: dQ = scale * (P o (dO V^T - delta)) K
//   K6: dV = P^T dO,  dK = scale * (P o (dO V^T - delta))^T Q
//
// with the TPU kernels' rounding points: S and dP accumulate in f32, P is
// rounded to the input dtype before P^T dO and dS before dS K and dS^T Q,
// and dQ and dK are scaled once at the end.
//
// What bounds them on this card.  Per visible (query, key) pair K5 does
// three products (6*D FLOPs) and K6 four (8*D), against O(T*D) bytes: at
// T >= 512 both sit far above the H100's ridge point, so they are bound
// by tensor-core operations.  Only `wgmma` reaches the tensor cores' full
// rate; it reads its shared-memory operands through descriptors in one of
// a few swizzled layouts, runs asynchronously, and stalls whenever a tile
// it needs is still on its way from memory.
//
// What the design does about it (bf16).  Every product is `wgmma` (bf16 in,
// f32 accumulate), issued by two consumer warpgroups that each own 64 rows
// of a 128-row block.  A third, producer warpgroup keeps the ring of
// shared-memory tiles filled by TMA (below) and gives its registers to the
// consumers (`setmaxnreg`: 24 for it, 240 for each of them), so that the
// two consumers never wait for each other: while one computes P and dS,
// the other's products run.  The exponent is
// exp2(S * scale * log2(e) - lse * log2(e)) with `ex2.approx`.
//
// K5: one block per 128 query rows of one (batch, head).  Q and dO sit in
// shared memory for the whole block; the K/V tiles of 64 keys stream
// through the ring.  Per tile and warpgroup, S = Q K^T and dP = dO V^T are
// m64n64k16 with both operands read from shared memory (K-major).  P and
// dS = P (dP - delta) are computed in registers.  The f32 accumulator
// fragment of a wgmma is laid out as the A fragment of the next one, so
// dS, rounded to bf16, feeds dQ += dS K (m64nDk16) straight from
// registers, with the same K tile read MN-major (the transpose bit).  dQ
// stays in registers (64 f32 a thread at D = 128).  The causal loop stops
// at the diagonal, a warpgroup skips a tile hidden from all its rows, and
// the heaviest causal blocks (the last rows) are launched first.
//
// K6: the TPU kernel carries dK/dV accumulators across a sequential grid
// dimension; blocks on Hopper run in no order, so that dimension is a
// loop inside the block.  One block per 128 keys of one (batch, KV head)
// keeps K and V in shared memory (loaded once) and dK and dV in registers
// (2 x 64 f32 a thread).  It loops over the `group` query heads that read
// this KV head and, for each, over the query tiles from the causal
// diagonal to the end; Q, dO and the tile's lse and delta stream through
// the ring in tiles of 64 queries.  Per tile and warpgroup, S^T = K Q^T
// and dP^T = V dO^T read both operands from shared memory, then
// dV += P^T dO and dK += dS^T Q take P^T and dS^T from registers and dO
// and Q MN-major.  The group is summed inside the kernel in a fixed order
// in f32 and rounded once: no atomics, deterministic, and closer to exact
// than the TPU path, which rounds each head's dK/dV to bf16 before
// repeat_kv's gradient adds them.  The heaviest causal blocks (the first
// keys) are launched first.
//
// The ring.  Streamed tiles go through NS = 3 stages.  The producer waits
// for a stage's `empty` mbarrier (both consumers have handed it back),
// then loads it with TMA, which reports the bytes to the stage's `full`
// mbarrier; a consumer waits for `full`, and hands the stage back once
// the wgmmas that read it have ended (in K5 at the next tile's first wait,
// so the last product of a tile overlaps the next tile's first two).  K6's
// lse and delta are read by the producer warp's lanes, which arrive on
// `full` after their stores.  The tensor maps are encoded per call over
// the tensors' strides, and TMA reads rows past T and columns past D as 0.
//
// Layout.  Tiles are stored as hopper.cuh describes ([Dp / 64][rows][64]
// in the 128-byte swizzle), so one stored tile serves as a K-major and as
// an MN-major operand.  Dp is 64 or 128: head dims below are zero-padded
// in shared memory (columns past D load as 0 and are never written back),
// so one kernel serves every D and D = 128 pays nothing.
//
// Layout in memory: q/do/dq [B, Tq, H, D], k/v/dk/dv [B, Tk, Hkv, D], read
// and written through their (batch, time, head) strides with unit stride
// on D, so the fused-projection views of the model need no copy.  P is set
// to 0 wherever the causal or ragged mask hides a pair, never computed
// from -inf; rows past T in a ragged last tile load as 0, contribute
// exactly 0 to every sum and are not written.  An f32 path with plain
// FMAs serves f32 inputs.
//
// Output mode.  The bf16 kernels store dQ, dK and dV either in bf16 or in
// f32 (a template flag): ring attention sums the partials of its blocks
// before one rounding, which is the TPU path's `keep_f32` (its dQ and
// dK/dV pallas_calls at flash_attention.py:351 and :377 with f32 outputs).
// The accumulation is f32 in both; only the epilogue's stores differ, so a
// bf16 output is the f32 one rounded to nearest even, bit for bit.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 384;  // bf16: a producer and two consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // setmaxnreg
constexpr int BM = 128;  // K5: query rows per block; K6: keys per block
constexpr int BN = 64;   // K5: keys per streamed tile; K6: queries
constexpr int NS = 3;    // stages of the ring

constexpr int F_BQ = 64;   // f32 dQ: one thread per query row
constexpr int F_BK = 32;   // f32 dQ: key rows per shared-memory tile
constexpr int F_KR = 64;   // f32 dK/dV: one thread per key row
constexpr int F_QT = 16;   // f32 dK/dV: query rows per shared-memory tile

// ---------------------------------------------------------------- K5 --

template <int DP, bool F32OUT>
__global__ void __launch_bounds__(NT, 1)
    flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         void* __restrict__ dq, int D, int Tq, int Tk,
                         int group, Strides dqs, float scale, int causal) {
  constexpr int QB = BM * DP * 2, KB = BN * DP * 2;  // tile bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // Q, dO, the ring (stage s: K at ring + 2 s KB, V after it), then the
  // barriers: Q and dO in, stage s full, stage s empty
  const uint32_t sQ = smem_u32(smem), sD = sQ + QB, ring = sQ + 2 * QB;
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

  if (threadIdx.x < 128) {  // producer: one thread issues every copy
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(qbar, 2 * QB);
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(sQ + c * BM * 128, &tq, qbar, c * 64, q0, h, b);
        tma_load(sD + c * BM * 128, &tdo, qbar, c * 64, q0, h, b);
      }
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
  // this thread's rows: row[0] and row[0] + 8; a row past Tq gets lse =
  // +inf, so P = 0 there
  int row[2];
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wrow0 + warp * 16 + g + 8 * i;
    const long long ri = (static_cast<long long>(b) * H + h) * Tq + row[i];
    l2[i] = row[i] < Tq ? lse[ri] * LOG2E : INFINITY;
    dl[i] = row[i] < Tq ? delta[ri] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  int held = -1;  // the stage that the last dS K may still be reading
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN, s = j % NS;
    const uint32_t sK = ring + s * 2 * KB, sV = sK + KB;
    mbar_wait(full + 8 * s, (j / NS) & 1);
    if (causal && k0 > wrow0 + 63) {  // hidden from all 64 rows
      wgmma_wait<0>();
      if (leader) {
        if (held >= 0) mbar_arrive(empty + 8 * held);
        mbar_arrive(empty + 8 * s);
      }
      held = -1;
      continue;
    }

    float s_[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s_, desc_k(sQ, BM, wg * 64, kk), desc_k(sK, BN, 0, kk),
                   kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(sD, BM, wg * 64, kk), desc_k(sV, BN, 0, kk),
                   kk);
    wgmma_commit();

    // P = exp(S * scale - lse), 0 where masked, while dP is computed; the
    // last tile's dS K has ended, so its stage goes back to the producer
    wgmma_wait<1>();
    fence_regs(s_);
    if (leader && held >= 0) mbar_arrive(empty + 8 * held);
    held = s;
    const bool edge = (causal && k0 + BN - 1 > wrow0) || k0 + BN > Tk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // fragment i / 4, row (i / 2) % 2
      float p = ex2(fmaf(s_[i], sl2, -l2[(i >> 1) & 1]));
      if (edge) {
        const int col = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
        if (col >= Tk || (causal && col > row[(i >> 1) & 1])) p = 0.f;
      }
      s_[i] = p;
    }
    // dS = P (dP - delta), rounded to bf16 as the A fragments of dS K
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s_[i] *= dp[i] - dl[(i >> 1) & 1];
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], s_, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(acc, a[kk], desc_mn(sK, BN, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the epilogue: the same f32 values, stored as bf16 pairs or, in the
  // f32 output mode (the ring's partials), as f32 pairs
#pragma unroll
  for (int n8 = 0; n8 < DP / 8; ++n8) {
    if (n8 * 8 >= D) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= Tq) continue;
      const long long off = b * dqs.b + static_cast<long long>(row[i]) * dqs.t +
                            h * dqs.h + n8 * 8 + t4 * 2;
      const float lo = acc[n8 * 4 + 2 * i] * scale,
                  hi = acc[n8 * 4 + 2 * i + 1] * scale;
      if constexpr (F32OUT)
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + off) =
            make_float2(lo, hi);
      else
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(dq) + off) =
            pack_bf16(lo, hi);
    }
  }
}

// f32 inputs: one thread per query row, plain FMAs.  Q and dO sit in
// shared memory column-major, so a warp's reads of its 32 rows' element d
// are 32 consecutive words; K/V rows are read by every thread alike.
template <int D>
__global__ void __launch_bounds__(F_BQ)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Tq, int Tk, int group,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [D][F_BQ]
  float* sD = sQ + D * F_BQ;                         // [D][F_BQ]
  float* sK = sD + D * F_BQ;                         // [F_BK][D]
  float* sV = sK + F_BK * D;                         // [F_BK][D]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_BQ;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int hk = h / group;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  for (int i = threadIdx.x; i < F_BQ * D; i += F_BQ) {
    const int rr = i / D, c = i % D;
    const bool ok = q0 + rr < Tq;
    sQ[c * F_BQ + rr] =
        ok ? qp[static_cast<long long>(q0 + rr) * qs.t + c] : 0.f;
    sD[c * F_BQ + rr] =
        ok ? dop[static_cast<long long>(q0 + rr) * dos.t + c] : 0.f;
  }
  const int row = q0 + threadIdx.x;
  const long long ri = (static_cast<long long>(b) * H + h) * Tq + row;
  const float lrow = row < Tq ? lse[ri] : 0.f;
  const float drow = row < Tq ? delta[ri] : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

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
      if (row >= Tq || col >= Tk || (causal && col > row)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[d * F_BQ + threadIdx.x], sK[jj * D + d], s);
        dp = fmaf(sD[d * F_BQ + threadIdx.x], sV[jj * D + d], dp);
      }
      const float ds = expf(s * scale - lrow) * (dp - drow);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, sK[jj * D + d], acc[d]);
    }
  }
  if (row >= Tq) return;
  float* out = dq + b * dqs.b + static_cast<long long>(row) * dqs.t + h * dqs.h;
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = acc[d] * scale;
}

// ---------------------------------------------------------------- K6 --

template <int DP, bool F32OUT>
__global__ void __launch_bounds__(NT, 1)
    flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          void* __restrict__ dk, void* __restrict__ dv,
                          int D, int Tq, int Tk, int H, int group, Strides dks,
                          Strides dvs, float scale, int causal) {
  constexpr int KB = BM * DP * 2, QB = BN * DP * 2;  // tile bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // K, V, the ring (stage s: Q at ring + 2 s QB, dO after it, its lse and
  // delta at rows + 2 s BN), then the barriers: K and V in, stage s full,
  // stage s empty
  const uint32_t sK = smem_u32(smem), sV = sK + KB, ring = sK + 2 * KB;
  float* rows = reinterpret_cast<float*>(smem + 2 * KB + NS * 2 * QB);
  const uint32_t kvbar = smem_u32(rows + NS * 2 * BN), full = kvbar + 8,
                 empty = full + 8 * NS;

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BM;  // first keys first: the most causal work
  // the work: the group's query heads, each from the first query tile
  // whose last row reaches this block's keys
  const int qt0 = causal ? k0 / BN : 0;
  const int nq = (Tq + BN - 1) / BN - qt0;
  const int n_items = group * nq;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one warp
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * KB);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(sK + c * BM * 128, &tk, kvbar, c * 64, k0, hk, b);
          tma_load(sV + c * BM * 128, &tv, kvbar, c * 64, k0, hk, b);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % NS, h = hk * group + it / nq;
        const int q0 = (qt0 + it % nq) * BN;
        if (it >= NS) mbar_wait(empty + 8 * s, (it / NS - 1) & 1);
        // lse and delta of the tile's rows, 0 past Tq, by the lanes
        const long long r0 = (static_cast<long long>(b) * H + h) * Tq + q0;
        float* st = rows + s * 2 * BN;
        for (int r = lane; r < BN; r += 32) {
          const bool ok = q0 + r < Tq;
          st[r] = ok ? lse[r0 + r] : 0.f;
          st[BN + r] = ok ? delta[r0 + r] : 0.f;
        }
        if (lane == 0) {  // Q and dO by TMA
          const uint32_t sQ = ring + s * 2 * QB;
          mbar_expect_tx(full + 8 * s, 2 * QB);
          for (int c = 0; c < DP / 64; ++c) {
            tma_load(sQ + c * BN * 128, &tq, full + 8 * s, c * 64, q0, h, b);
            tma_load(sQ + QB + c * BN * 128, &tdo, full + 8 * s, c * 64, q0,
                     h, b);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }
  regs_up<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;  // arrives for its warpgroup
  const int wkey0 = k0 + wg * 64;  // this warpgroup's first key
  const int key[2] = {wkey0 + warp * 16 + g, wkey0 + warp * 16 + g + 8};
  const float sl2 = scale * LOG2E;
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_items; ++it) {
    const int q0 = (qt0 + it % nq) * BN, s = it % NS;
    const uint32_t sQ = ring + s * 2 * QB, sD = sQ + QB;
    const float* sL = rows + s * 2 * BN;
    const float* sDl = sL + BN;
    mbar_wait(full + 8 * s, (it / NS) & 1);
    if (causal && q0 + BN - 1 < wkey0) {  // before all 64 keys
      if (leader) mbar_arrive(empty + 8 * s);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
    float s_[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s_, desc_k(sK, BM, wg * 64, kk), desc_k(sQ, BN, 0, kk),
                   kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(sV, BM, wg * 64, kk), desc_k(sD, BN, 0, kk),
                   kk);
    wgmma_commit();

    // P^T = exp(S^T * scale - lse), 0 where masked; a column is a query
    wgmma_wait<1>();
    fence_regs(s_);
    const bool edge = (causal && wkey0 + 63 > q0) || q0 + BN > Tq;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 l = *reinterpret_cast<const float2*>(sL + n8 * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n8 * 4 + e;
        float p = ex2(fmaf(s_[i], sl2, -(e & 1 ? l.y : l.x) * LOG2E));
        if (edge) {
          const int qg = q0 + n8 * 8 + t4 * 2 + (e & 1);
          if (qg >= Tq || (causal && key[e >> 1] > qg)) p = 0.f;
        }
        s_[i] = p;
      }
    }
    // dS^T = P^T (dP^T - delta); P^T and dS^T rounded to bf16 as the A
    // fragments of P^T dO and dS^T Q
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 d = *reinterpret_cast<const float2*>(sDl + n8 * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n8 * 4 + e;
        dp[i] = s_[i] * (dp[i] - (e & 1 ? d.y : d.x));
      }
    }
    uint32_t ap[4][4], ad[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag(ap[kk], s_, kk);
      a_frag(ad[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dva, ap[kk], desc_mn(sD, BN, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dka, ad[kk], desc_mn(sQ, BN, kk));
    wgmma_commit();
    // wait here, then hand the stage back: until these wgmmas end, their
    // 32 A-fragment registers stay taken, and beside the next tile's S^T
    // and dP^T they would spill
    wgmma_wait<0>();
    if (leader) mbar_arrive(empty + 8 * s);
  }
  fence_regs(dka);
  fence_regs(dva);

  // the epilogue: bf16 pairs, or f32 pairs in the f32 output mode
#pragma unroll
  for (int n8 = 0; n8 < DP / 8; ++n8) {
    if (n8 * 8 >= D) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= Tk) continue;
      const int col = n8 * 8 + t4 * 2;
      const long long koff = b * dks.b +
                             static_cast<long long>(key[i]) * dks.t +
                             hk * dks.h + col;
      const long long voff = b * dvs.b +
                             static_cast<long long>(key[i]) * dvs.t +
                             hk * dvs.h + col;
      const float k_lo = dka[n8 * 4 + 2 * i] * scale,
                  k_hi = dka[n8 * 4 + 2 * i + 1] * scale;
      const float v_lo = dva[n8 * 4 + 2 * i], v_hi = dva[n8 * 4 + 2 * i + 1];
      if constexpr (F32OUT) {
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + koff) =
            make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + voff) =
            make_float2(v_lo, v_hi);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(dk) + koff) =
            pack_bf16(k_lo, k_hi);
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(dv) + voff) =
            pack_bf16(v_lo, v_hi);
      }
    }
  }
}

// f32 inputs: one thread per key row, plain FMAs.  The block's K and V
// rows and its dK/dV sums sit in shared memory column-major (a warp's
// accesses to element d of its 32 rows are 32 consecutive words); query
// rows are staged 16 at a time and read by every thread alike.
template <int D>
__global__ void __launch_bounds__(F_KR)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Tq, int Tk, int H, int group, Strides qs,
                         Strides ks, Strides vs, Strides dos, Strides dks,
                         Strides dvs, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [D][F_KR]
  float* sV = sK + D * F_KR;                         // [D][F_KR]
  float* sdK = sV + D * F_KR;                        // [D][F_KR]
  float* sdV = sdK + D * F_KR;                       // [D][F_KR]
  float* sQ = sdV + D * F_KR;                        // [F_QT][D]
  float* sD = sQ + F_QT * D;                         // [F_QT][D]
  float* sL = sD + F_QT * D;                         // [F_QT]
  float* sDl = sL + F_QT;                            // [F_QT]

  const int k0 = blockIdx.x * F_KR, hk = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, key = k0 + t;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  for (int i = t; i < F_KR * D; i += F_KR) {
    const int rr = i / D, c = i % D;
    const bool ok = k0 + rr < Tk;
    sK[c * F_KR + rr] =
        ok ? kp[static_cast<long long>(k0 + rr) * ks.t + c] : 0.f;
    sV[c * F_KR + rr] =
        ok ? vp[static_cast<long long>(k0 + rr) * vs.t + c] : 0.f;
    sdK[c * F_KR + rr] = 0.f;
    sdV[c * F_KR + rr] = 0.f;
  }

  const int qstart = causal ? k0 : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* qp = q + b * qs.b + h * qs.h;
    const float* dop = dout + b * dos.b + h * dos.h;
    const long long rows = (static_cast<long long>(b) * H + h) * Tq;
    for (int q0 = qstart; q0 < Tq; q0 += F_QT) {
      __syncthreads();
      for (int i = t; i < F_QT * D; i += F_KR) {
        const int rr = i / D, c = i % D;
        const bool ok = q0 + rr < Tq;
        sQ[i] = ok ? qp[static_cast<long long>(q0 + rr) * qs.t + c] : 0.f;
        sD[i] = ok ? dop[static_cast<long long>(q0 + rr) * dos.t + c] : 0.f;
      }
      if (t < F_QT) {
        const bool ok = q0 + t < Tq;
        sL[t] = ok ? lse[rows + q0 + t] : 0.f;
        sDl[t] = ok ? delta[rows + q0 + t] : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < F_QT; ++jj) {
        const int qg = q0 + jj;
        if (key >= Tk || qg >= Tq || (causal && key > qg)) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(sK[d * F_KR + t], sQ[jj * D + d], s);
          dp = fmaf(sV[d * F_KR + t], sD[jj * D + d], dp);
        }
        const float p = expf(s * scale - sL[jj]);
        const float ds = p * (dp - sDl[jj]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          sdV[d * F_KR + t] = fmaf(p, sD[jj * D + d], sdV[d * F_KR + t]);
          sdK[d * F_KR + t] = fmaf(ds, sQ[jj * D + d], sdK[d * F_KR + t]);
        }
      }
    }
  }
  __syncthreads();  // the zero fill above was spread over the block
  if (key >= Tk) return;
  float* kout =
      dk + b * dks.b + static_cast<long long>(key) * dks.t + hk * dks.h;
  float* vout =
      dv + b * dvs.b + static_cast<long long>(key) * dvs.t + hk * dvs.h;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kout[d] = sdK[d * F_KR + t] * scale;
    vout[d] = sdV[d * F_KR + t];
  }
}

// the maps of q, dout (boxes of q_rows) and k, v (boxes of k_rows), from
// the strides of q, k, v, dout in turn; a failed encode is returned as
// TMA_ERROR + its CUresult
int make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
              const void* v, const void* dout, int B, int Tq, int Tk, int H,
              int Hkv, int D, const long long* st, int q_rows, int k_rows) {
  CUresult r = make_map(&m[0], q, B, Tq, H, D, at(st, 0), q_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(&m[1], dout, B, Tq, H, D, at(st, 3), q_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(&m[2], k, B, Tk, Hkv, D, at(st, 1), k_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(&m[3], v, B, Tk, Hkv, D, at(st, 2), k_rows);
  return r == CUDA_SUCCESS ? 0 : TMA_ERROR + static_cast<int>(r);
}

// bf16: the head dim padded to DP = 64 or 128 in shared memory; dQ (and
// dK, dV) in bf16, or in f32 with F32OUT
template <int DP, bool F32OUT>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int Tq, int Tk, int H, int Hkv, int D,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap m[4];
  const int err =
      make_maps(m, q, k, v, dout, B, Tq, Tk, H, Hkv, D, st, BM, BN);
  if (err) return err;
  const int smem = 1024 + (2 * BM + NS * 2 * BN) * DP * 2 + (1 + 2 * NS) * 8;
  cudaError_t e = set_smem(flash_dq_bf16_kernel<DP, F32OUT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (Tq + BM - 1) / BM, B);
  flash_dq_bf16_kernel<DP, F32OUT><<<grid, NT, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, dq, D, Tq, Tk, H / Hkv, at(st, 4),
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool F32OUT>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int Tq, int Tk, int H, int Hkv,
                    int D, const long long* st, float scale, int causal,
                    cudaStream_t stream) {
  CUtensorMap m[4];
  const int err =
      make_maps(m, q, k, v, dout, B, Tq, Tk, H, Hkv, D, st, BN, BM);
  if (err) return err;
  const int smem = 1024 + (2 * BM + NS * 2 * BN) * DP * 2 +
                   NS * 2 * BN * static_cast<int>(sizeof(float)) +
                   (1 + 2 * NS) * 8;
  cudaError_t e = set_smem(flash_dkv_bf16_kernel<DP, F32OUT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(Hkv, (Tk + BM - 1) / BM, B);
  flash_dkv_bf16_kernel<DP, F32OUT><<<grid, NT, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, dk, dv, D, Tq, Tk, H, H / Hkv,
      at(st, 4), at(st, 5), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int Tq,
                          int Tk, int H, int group, const long long* st,
                          float scale, int causal, cudaStream_t stream) {
  const int smem = (2 * D * F_BQ + 2 * F_BK * D) * sizeof(float);
  cudaError_t err = set_smem(flash_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + F_BQ - 1) / F_BQ, H, B);
  flash_dq_f32_kernel<D><<<grid, F_BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), Tq, Tk, group, at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), at(st, 4), scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int Tq, int Tk, int H, int Hkv,
                           const long long* st, float scale, int causal,
                           cudaStream_t stream) {
  const int smem = (4 * D * F_KR + 2 * F_QT * D + 2 * F_QT) * sizeof(float);
  cudaError_t err = set_smem(flash_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + F_KR - 1) / F_KR, Hkv, B);
  flash_dkv_f32_kernel<D><<<grid, F_KR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H,
      H / Hkv, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4),
      at(st, 5), scale, causal);
  return cudaGetLastError();
}

}  // namespace

#define FLASH_BWD_CASES(CALL) \
  CALL(16) CALL(32) CALL(48) CALL(64) CALL(80) CALL(96) CALL(112) CALL(128)

namespace {

// the bf16 kernels at DP = 64 or 128, with bf16 or f32 outputs
template <bool F32OUT>
int dq_bf16(const void* q, const void* k, const void* v, const void* dout,
            const float* l, const float* dl, void* dq, int B, int Tq, int Tk,
            int H, int Hkv, int D, const long long* st, float scale,
            int causal, cudaStream_t stream) {
  return D <= 64 ? launch_dq_bf16<64, F32OUT>(q, k, v, dout, l, dl, dq, B,
                                               Tq, Tk, H, Hkv, D, st, scale,
                                               causal, stream)
                 : launch_dq_bf16<128, F32OUT>(q, k, v, dout, l, dl, dq, B,
                                                Tq, Tk, H, Hkv, D, st, scale,
                                                causal, stream);
}

template <bool F32OUT>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
             const float* l, const float* dl, void* dk, void* dv, int B,
             int Tq, int Tk, int H, int Hkv, int D, const long long* st,
             float scale, int causal, cudaStream_t stream) {
  return D <= 64 ? launch_dkv_bf16<64, F32OUT>(q, k, v, dout, l, dl, dk, dv,
                                                B, Tq, Tk, H, Hkv, D, st,
                                                scale, causal, stream)
                 : launch_dkv_bf16<128, F32OUT>(q, k, v, dout, l, dl, dk, dv,
                                                 B, Tq, Tk, H, Hkv, D, st,
                                                 scale, causal, stream);
}

}  // namespace

// K5.  q/dout/dq [B, Tq, H, D], k/v [B, Tk, Hkv, D], all with unit stride
// on D; lse and delta [B, H, Tq] f32 contiguous.  `strides` holds the
// (batch, time, head) element strides of q, k, v, dout, dq.  dtype 0 =
// bf16, 1 = f32 inputs; out_dtype the same for dq: bf16 inputs may write
// f32 (the ring's partials: the same accumulation, another store), f32
// inputs write f32.  Launches on `stream` without synchronising.  Returns
// 0, a cudaError_t, -1 for an unsupported D or dtype pair, or TMA_ERROR
// (10000) + the CUresult of a bf16 tensor map that could not be encoded.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int dtype,
                                 int out_dtype, int B, int Tq, int Tk, int H,
                                 int Hkv, int D, const long long* strides,
                                 float scale, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 16 || D > 128 || D % 16 || out_dtype < dtype || out_dtype > 1)
    return -1;
  if (dtype == 0)
    return out_dtype ? dq_bf16<true>(q, k, v, dout, l, dl, dq, B, Tq, Tk, H,
                                     Hkv, D, strides, scale, causal, st)
                     : dq_bf16<false>(q, k, v, dout, l, dl, dq, B, Tq, Tk, H,
                                      Hkv, D, strides, scale, causal, st);
  switch (D) {
#define DQ_CASE(DD)                                                          \
  case DD:                                                                   \
    return static_cast<int>(launch_dq_f32<DD>(q, k, v, dout, l, dl, dq, B,   \
                                              Tq, Tk, H, H / Hkv, strides,   \
                                              scale, causal, st));
    FLASH_BWD_CASES(DQ_CASE)
#undef DQ_CASE
    default:
      return -1;
  }
}

// K6.  As K5, with dk/dv [B, Tk, Hkv, D] (the grouped shape: each KV
// head's gradients summed over its H / Hkv query heads) and `strides`
// holding those of q, k, v, dout, dk, dv.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int dtype, int out_dtype, int B, int Tq,
                                  int Tk, int H, int Hkv, int D,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 16 || D > 128 || D % 16 || out_dtype < dtype || out_dtype > 1)
    return -1;
  if (dtype == 0)
    return out_dtype
               ? dkv_bf16<true>(q, k, v, dout, l, dl, dk, dv, B, Tq, Tk, H,
                                Hkv, D, strides, scale, causal, st)
               : dkv_bf16<false>(q, k, v, dout, l, dl, dk, dv, B, Tq, Tk, H,
                                 Hkv, D, strides, scale, causal, st);
  switch (D) {
#define DKV_CASE(DD)                                                         \
  case DD:                                                                   \
    return static_cast<int>(launch_dkv_f32<DD>(q, k, v, dout, l, dl, dk, dv, \
                                               B, Tq, Tk, H, Hkv, strides,   \
                                               scale, causal, st));
    FLASH_BWD_CASES(DKV_CASE)
#undef DKV_CASE
    default:
      return -1;
  }
}
