// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_attn_kernel` driven by `_flash_fwd_bhtd`
// (tpu_k8s_device_plugin/workloads/flash_attention.py): causal or full
// attention over [B, T, H, D] with an online softmax in f32, causal runs
// stopping at the diagonal, and rows with no visible key written as 0.
//
// What bounds it on this card.  Prefill attention at head_dim 128 does
// 4*D = 512 FLOPs for every visible (query, key) pair and moves only
// O(T*D) bytes, so at T >= 512 it sits far above the H100's ridge point
// (~295 bf16 FLOPs per byte of HBM): it is bound by tensor-core
// operations, and the [T, T] score matrix must never reach memory.
//
// What the design does about it.  One block of 4 warps owns a 64-row
// query tile of one (batch, head); each warp owns 16 rows.  K/V stream
// through shared memory in 64-row tiles; S = Q K^T * scale and O += P V
// run on `mma.sync.m16n8k16` in bf16 with f32 accumulation, and P never
// leaves registers (the S accumulator fragments are exactly the A
// fragments of the P V product).  The running max, sum and accumulator
// stay in f32; P is rounded to bf16 before P V, as the TPU kernel does.
// The kernel reads [B, T, H, D] through its strides (no transposes),
// masks a ragged T itself, and maps query head h to KV head h / group,
// so grouped K/V are read at their compact size.  This is the simple
// first form: no cp.async/TMA pipelining, no wgmma, no warp
// specialisation.  An f32 path with plain FMAs serves f32 inputs.
//
// With a non-null `lse` the kernel also writes the per-row logsumexp
// m + log(l) (f32, [B, H, Tq]; -inf for a row with no visible key), the
// residual the backward kernels (flash_attn_bwd.cu) rebuild P from, as
// the TPU kernel does under `save_residuals`.  The running max and sum
// are already in registers at the end, so the cost is one f32 write per
// row; the inference path passes null and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block (4 warps x 16 rows)
constexpr int BK = 64;  // key rows per shared-memory tile
constexpr int NTHREADS = 128;

constexpr int F_BQ = 64;  // f32 path: one thread per query row
constexpr int F_BK = 32;  // f32 path: key rows per shared-memory tile

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

// Rows [row0, row0 + 64) of one head into a shared tile, 16 bytes per
// thread per step; rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[D + 8],
                                          const uint16_t* src,
                                          long long t_stride, int row0,
                                          int T) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < BK * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * t_stride + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          uint16_t* __restrict__ o,
                          float* __restrict__ lse, int Tq, int Tk,
                          int group, Strides qs, Strides ks, Strides vs,
                          Strides os, float scale, int causal) {
  // +8 columns: rows start 16 bytes apart mod 128, so the fragment
  // reads below hit 32 distinct banks
  __shared__ __align__(16) uint16_t sK[BK][D + 8];
  __shared__ __align__(16) uint16_t sV[BK][D + 8];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint16_t* qp = q + b * qs.b + h * qs.h;
  const uint16_t* kp = k + b * ks.b + hk * ks.h;
  const uint16_t* vp = v + b * vs.b + hk * vs.h;

  // Q tile through sK into A fragments, kept in registers throughout
  load_tile<D>(sK, qp, qs.t, q0, Tq);
  __syncthreads();
  const int r = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&sK[r][c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&sK[r + 8][c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&sK[r][c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&sK[r + 8][c + 8]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  // this thread's two rows: g and g + 8 of its warp's 16
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + r, q0 + r + 8};

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(sK, kp, ks.t, k0, Tk);
    load_tile<D>(sV, vp, vs.t, k0, Tk);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys, f32 accumulate
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + t4 * 2;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][c]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][c + 8]);
        mma_bf16_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale, mask (ragged T and the causal diagonal), row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= Tk || (causal && col > row[e >> 1])) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float safe[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads of a quad hold one row between them
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no visible key yet keeps m = -inf; exp(-inf) = 0
      safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[i] = expf(m[i] - safe[i]);
      m[i] = m_new;
    }
    // P = exp(S - m); l holds this thread's share of the row sum and
    // is reduced over the quad once, at the end
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - safe[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: P rounded to bf16, straight from the S fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const int kr = kk * 16 + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int n = dt * 8 + g;
        const uint32_t b0 = pack_raw(sV[kr][n], sV[kr + 1][n]);
        const uint32_t b1 = pack_raw(sV[kr + 8][n], sV[kr + 9][n]);
        mma_bf16_16816(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= Tq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Tq + row[i]] =
          (l[i] == 0.f) ? -INFINITY : m[i] + logf(l[i]);
    uint16_t* op = o + b * os.b + static_cast<long long>(row[i]) * os.t +
                   h * os.h;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(op + col) = pack_bf16(
          acc[dt][2 * i] / denom, acc[dt][2 * i + 1] / denom);
    }
  }
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

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int Tq, int Tk, int H,
                   int group, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_fwd_bf16_kernel<D><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), lse, Tq,
        Tk, group, qs, ks, vs, os, scale, causal);
  } else {
    const int smem = (D * F_BQ + 2 * F_BK * D) * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tq + F_BQ - 1) / F_BQ, H, B);
    flash_fwd_f32_kernel<D><<<grid, F_BQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, Tk,
        group, qs, ks, vs, os, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, Hkv, D], o [B, Tq, H, D], all with unit
// stride on D; lse [B, H, Tq] f32 contiguous, or null for no write.
// dtype 0 = bf16, 1 = f32.  Launches on `stream` without synchronising.
// Returns 0, a cudaError_t, or -1 for an unsupported D.
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
  const int group = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define FLASH_CASE(DD)                                                    \
  case DD:                                                                \
    return static_cast<int>(launch<DD>(dtype, q, k, v, o,                \
                                       static_cast<float*>(lse), B, Tq,   \
                                       Tk, H, group, qs, ks, vs, os,      \
                                       scale, causal, st));
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
