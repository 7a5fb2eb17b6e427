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
// and dQ is scaled once at the end.
//
// What bounds them on this card.  Per visible (query, key) pair K5 does
// three products (6*D FLOPs) and K6 four (8*D), against O(T*D) bytes: at
// T >= 512 both sit far above the H100's ridge point, so they are bound
// by tensor-core operations.
//
// What the design does about it.  Both run on `mma.sync.m16n8k16` in
// bf16 with f32 accumulation, with the fragment layouts of K4
// (flash_attn_fwd.cu), so the products of S and dP feed the next product
// from registers.
//
// K5: one block of 4 warps per 64-row query tile of one (batch, head);
// each warp owns 16 rows and keeps their Q and dO fragments, lse, delta
// and the dQ accumulator in registers.  K/V tiles of 64 keys stream
// through shared memory, and the causal loop stops at the diagonal.  The
// heaviest causal tiles (the last rows) are launched first.
//
// K6: the TPU kernel carries dK/dV accumulators across a sequential grid
// dimension; blocks on Hopper run in no order, so that dimension is a
// loop inside the block.  One block of 4 warps owns a 64-row key tile of
// one (batch, KV head) and keeps dK and dV for it in registers (each warp
// 16 keys).  It loops over the `group` query heads that read this KV
// head and, for each, over the query tiles from the causal diagonal to
// the end, staging Q, dO, lse and delta in shared memory.  The group is
// summed inside the kernel in a fixed order in f32 and rounded once: no
// atomics, deterministic, and closer to exact than the TPU path, which
// rounds each head's dK/dV to bf16 before repeat_kv's gradient adds them.
//
// Layout: q/do/dq [B, Tq, H, D], k/v/dk/dv [B, Tk, Hkv, D], read and
// written through their (batch, time, head) strides with unit stride on
// D, so the fused-projection views of the model need no copy.  Rows past
// T in a ragged last tile are zero-filled on load, contribute exactly 0
// to every sum (P is set to 0 wherever the causal or ragged mask hides a
// pair, never computed from -inf) and are not written.  An f32 path with
// plain FMAs serves f32 inputs.  This is the simple first form: no
// cp.async/TMA pipelining, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int NTHREADS = 128;
constexpr int QC = 32;  // K6: queries per register chunk

constexpr int F_BQ = 64;   // f32 dQ: one thread per query row
constexpr int F_BK = 32;   // f32 dQ: key rows per shared-memory tile
constexpr int F_KR = 64;   // f32 dK/dV: one thread per key row
constexpr int F_QT = 16;   // f32 dK/dV: query rows per shared-memory tile

struct Strides {
  long long b, t, h;  // element strides; the head dim has stride 1
};

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

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of one head into a shared tile, 16 bytes per
// thread per step; rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[D + 8],
                                          const uint16_t* src,
                                          long long t_stride, int row0,
                                          int T) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * t_stride + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// The A fragment of a 16 x 16 block of a shared tile, for the thread
// whose fragment rows are r, r + 8 and columns c, c + 1, c + 8, c + 9.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t a[4], uint16_t (*s)[D + 8],
                                       int r, int c) {
  a[0] = ld32(&s[r][c]);
  a[1] = ld32(&s[r + 8][c]);
  a[2] = ld32(&s[r][c + 8]);
  a[3] = ld32(&s[r + 8][c + 8]);
}

// ---------------------------------------------------------------- K5 --

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int Tq, int Tk,
                         int group, Strides qs, Strides ks, Strides vs,
                         Strides dos, Strides dqs, float scale, int causal) {
  __shared__ __align__(16) uint16_t sK[BK][D + 8];
  __shared__ __align__(16) uint16_t sV[BK][D + 8];

  // last query tiles first: under a causal mask they have the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint16_t* qp = q + b * qs.b + h * qs.h;
  const uint16_t* dop = dout + b * dos.b + h * dos.h;
  const uint16_t* kp = k + b * ks.b + hk * ks.h;
  const uint16_t* vp = v + b * vs.b + hk * vs.h;

  // Q and dO tiles through sK/sV into A fragments, kept in registers
  load_tile<D>(sK, qp, qs.t, q0, Tq);
  load_tile<D>(sV, dop, dos.t, q0, Tq);
  __syncthreads();
  const int r = warp * 16 + g;
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag_a<D>(qf[kk], sK, r, kk * 16 + t4 * 2);
    frag_a<D>(df[kk], sV, r, kk * 16 + t4 * 2);
  }

  const int row[2] = {q0 + r, q0 + r + 8};
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long ri = (static_cast<long long>(b) * H + h) * Tq + row[i];
    lrow[i] = row[i] < Tq ? lse[ri] : 0.f;
    drow[i] = row[i] < Tq ? delta[ri] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(sK, kp, ks.t, k0, Tk);
    load_tile<D>(sV, vp, vs.t, k0, Tk);
    __syncthreads();

#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {  // 32 keys at a time
      // S = Q K^T and dP = dO V^T for 4 n-tiles of 8 keys
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = kk * 16 + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int key = c * 32 + nt * 8 + g;
          mma_bf16_16816(s[nt], qf[kk], ld32(&sK[key][col]),
                         ld32(&sK[key][col + 8]));
          mma_bf16_16816(dp[nt], df[kk], ld32(&sV[key][col]),
                         ld32(&sV[key][col + 8]));
        }
      }
      // P = exp(S * scale - lse), 0 where masked; dS = P (dP - delta)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c * 32 + nt * 8 + t4 * 2 + (e & 1);
          const int i = e >> 1;
          const bool ok =
              row[i] < Tq && col < Tk && !(causal && col > row[i]);
          const float p = ok ? expf(s[nt][e] * scale - lrow[i]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - drow[i]);
        }
      // dQ += dS K: dS rounded to bf16, straight from the fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
        const int kr = c * 32 + kk * 16 + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const int n = dt * 8 + g;
          mma_bf16_16816(acc[dt], a, pack_raw(sK[kr][n], sK[kr + 1][n]),
                         pack_raw(sK[kr + 8][n], sK[kr + 9][n]));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Tq) continue;
    uint16_t* out = dq + b * dqs.b + static_cast<long long>(row[i]) * dqs.t +
                    h * dqs.h;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + t4 * 2) = pack_bf16(
          acc[dt][2 * i] * scale, acc[dt][2 * i + 1] * scale);
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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int Tq, int Tk, int H, int group, Strides qs,
                          Strides ks, Strides vs, Strides dos, Strides dks,
                          Strides dvs, float scale, int causal) {
  // K, V (the block's keys), Q, dO (one query tile): 64 rows each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sK = reinterpret_cast<uint16_t (*)[D + 8]>(smem_raw);
  auto sV = sK + BK;
  auto sQ = sV + BK;
  auto sD = sQ + BQ;
  float* sL = reinterpret_cast<float*>(sD + BQ);  // lse of the tile's rows
  float* sDl = sL + BQ;                            // delta

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kr = warp * 16 + g;  // this thread's key rows: kr, kr + 8
  const int key[2] = {k0 + kr, k0 + kr + 8};

  load_tile<D>(sK, k + b * ks.b + hk * ks.h, ks.t, k0, Tk);
  load_tile<D>(sV, v + b * vs.b + hk * vs.h, vs.t, k0, Tk);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  const int n_qtiles = (Tq + BQ - 1) / BQ;
  // the first query tile whose last row reaches this key tile
  const int qt0 = causal ? k0 / BQ : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const uint16_t* qp = q + b * qs.b + h * qs.h;
    const uint16_t* dop = dout + b * dos.b + h * dos.h;
    const long long rows = (static_cast<long long>(b) * H + h) * Tq;
    for (int qt = qt0; qt < n_qtiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous tile
      load_tile<D>(sQ, qp, qs.t, q0, Tq);
      load_tile<D>(sD, dop, dos.t, q0, Tq);
      if (threadIdx.x < BQ) {
        const bool ok = q0 + threadIdx.x < Tq;
        sL[threadIdx.x] = ok ? lse[rows + q0 + threadIdx.x] : 0.f;
        sDl[threadIdx.x] = ok ? delta[rows + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < BQ / QC; ++c) {
        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys against 32
        // queries (4 n-tiles of 8)
        float s[4][4], dp[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int col = kk * 16 + t4 * 2;
          uint32_t ak[4], av[4];
          frag_a<D>(ak, sK, kr, col);
          frag_a<D>(av, sV, kr, col);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int qr = c * QC + nt * 8 + g;
            mma_bf16_16816(s[nt], ak, ld32(&sQ[qr][col]),
                           ld32(&sQ[qr][col + 8]));
            mma_bf16_16816(dp[nt], av, ld32(&sD[qr][col]),
                           ld32(&sD[qr][col + 8]));
          }
        }
        // P^T = exp(S^T * scale - lse), 0 where masked;
        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c * QC + nt * 8 + t4 * 2 + (e & 1);
            const int qg = q0 + qc, kg = key[e >> 1];
            const bool ok = qg < Tq && kg < Tk && !(causal && kg > qg);
            const float p = ok ? expf(s[nt][e] * scale - sL[qc]) : 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - sDl[qc]);
          }
        // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk) {
          const uint32_t ap[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
          };
          const uint32_t ad[4] = {
              pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
          };
          const int qr = c * QC + kk * 16 + t4 * 2;
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            const int n = dt * 8 + g;
            mma_bf16_16816(dva[dt], ap, pack_raw(sD[qr][n], sD[qr + 1][n]),
                           pack_raw(sD[qr + 8][n], sD[qr + 9][n]));
            mma_bf16_16816(dka[dt], ad, pack_raw(sQ[qr][n], sQ[qr + 1][n]),
                           pack_raw(sQ[qr + 8][n], sQ[qr + 9][n]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Tk) continue;
    uint16_t* kout = dk + b * dks.b + static_cast<long long>(key[i]) * dks.t +
                     hk * dks.h;
    uint16_t* vout = dv + b * dvs.b + static_cast<long long>(key[i]) * dvs.t +
                     hk * dvs.h;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(kout + col) = pack_bf16(
          dka[dt][2 * i] * scale, dka[dt][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(vout + col) =
          pack_bf16(dva[dt][2 * i], dva[dt][2 * i + 1]);
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

// strides[]: (batch, time, head) element strides of each tensor in turn
Strides at(const long long* strides, int i) {
  return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Tq, int Tk, int H, int group,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_dq_bf16_kernel<D><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        lse, delta, static_cast<uint16_t*>(dq), Tq, Tk, group, at(st, 0),
        at(st, 1), at(st, 2), at(st, 3), at(st, 4), scale, causal);
  } else {
    const int smem = (2 * D * F_BQ + 2 * F_BK * D) * sizeof(float);
    cudaError_t err = set_smem(flash_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tq + F_BQ - 1) / F_BQ, H, B);
    flash_dq_f32_kernel<D><<<grid, F_BQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), Tq, Tk, group, at(st, 0), at(st, 1),
        at(st, 2), at(st, 3), at(st, 4), scale, causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Tq,
                       int Tk, int H, int Hkv, const long long* st,
                       float scale, int causal, cudaStream_t stream) {
  const int group = H / Hkv;
  if (dtype == 0) {
    const int smem = (2 * BK + 2 * BQ) * (D + 8) * sizeof(uint16_t) +
                     2 * BQ * sizeof(float);
    cudaError_t err = set_smem(flash_dkv_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tk + BK - 1) / BK, Hkv, B);
    flash_dkv_bf16_kernel<D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        lse, delta, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
        Tq, Tk, H, group, at(st, 0), at(st, 1), at(st, 2), at(st, 3),
        at(st, 4), at(st, 5), scale, causal);
  } else {
    const int smem =
        (4 * D * F_KR + 2 * F_QT * D + 2 * F_QT) * sizeof(float);
    cudaError_t err = set_smem(flash_dkv_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tk + F_KR - 1) / F_KR, Hkv, B);
    flash_dkv_f32_kernel<D><<<grid, F_KR, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H,
        group, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4),
        at(st, 5), scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

#define FLASH_BWD_CASES(CALL) \
  CALL(16) CALL(32) CALL(48) CALL(64) CALL(80) CALL(96) CALL(112) CALL(128)

// K5.  q/dout/dq [B, Tq, H, D], k/v [B, Tk, Hkv, D], all with unit stride
// on D; lse and delta [B, H, Tq] f32 contiguous.  `strides` holds the
// (batch, time, head) element strides of q, k, v, dout, dq.  dtype 0 =
// bf16, 1 = f32.  Launches on `stream` without synchronising.  Returns 0,
// a cudaError_t, or -1 for an unsupported D.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int dtype,
                                 int B, int Tq, int Tk, int H, int Hkv, int D,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DQ_CASE(DD)                                                         \
  case DD:                                                                  \
    return static_cast<int>(launch_dq<DD>(dtype, q, k, v, dout, l, dl, dq,  \
                                          B, Tq, Tk, H, H / Hkv, strides,   \
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
                                  int dtype, int B, int Tq, int Tk, int H,
                                  int Hkv, int D, const long long* strides,
                                  float scale, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DKV_CASE(DD)                                                        \
  case DD:                                                                  \
    return static_cast<int>(launch_dkv<DD>(dtype, q, k, v, dout, l, dl, dk, \
                                           dv, B, Tq, Tk, H, Hkv, strides,  \
                                           scale, causal, st));
    FLASH_BWD_CASES(DKV_CASE)
#undef DKV_CASE
    default:
      return -1;
  }
}
