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
//   do).  Elements that no window selects are 0.
//
// What bounds them on this card.  Both do a handful of compares or adds
// per byte: they are bound by HBM bytes.  K1 must read x once and write
// y and the index once; K2 must read dp and the index and write dy.
//
// What the design does about it.  One thread owns one output element
// (K1) or one input element (K2) and a group of channels: 16 bytes of
// the data type (8 bf16 or 4 f32) where C and the pointers allow it, so
// each load and store is one 16-byte access and neighbouring threads
// touch neighbouring addresses.  K1's overlapping windows re-read
// neighbouring rows through L1/L2, not HBM.  K2 gathers instead of
// scattering: each thread visits the few windows that can reach its
// element, in ascending offset order, so there are no atomics, the sum
// order is fixed and the result deterministic, and every element of dy is
// written exactly once (zeros included), so dy needs no memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

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

struct Shape {
  int B, H, W, C, OH, OW, window, stride;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       int8_t* __restrict__ idx, Shape s) {
  const int groups = s.C / VEC;
  const long long total =
      static_cast<long long>(s.B) * s.OH * s.OW * groups;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(t % groups) * VEC;
    long long r = t / groups;
    const int ow = static_cast<int>(r % s.OW);
    r /= s.OW;
    const int oh = static_cast<int>(r % s.OH);
    const long long b = r / s.OH;
    const T* base = x + ((b * s.H + oh * s.stride) * s.W + ow * s.stride) *
                            static_cast<long long>(s.C) + c0;

    Vec<T, VEC> best = *reinterpret_cast<const Vec<T, VEC>*>(base);
    float m[VEC];
    int8_t id[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[e] = to_f(best.v[e]);
      id[e] = 0;
    }
    for (int k = 1; k < s.window * s.window; ++k) {
      const int di = k / s.window, dj = k - di * s.window;
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(
          base + (static_cast<long long>(di) * s.W + dj) * s.C);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f(v.v[e]);
        if (m[e] != m[e]) continue;  // NaN already: stays, index 0
        if (f != f) {
          m[e] = f;
          best.v[e] = v.v[e];
          id[e] = 0;
        } else if (f > m[e]) {
          m[e] = f;
          best.v[e] = v.v[e];
          id[e] = static_cast<int8_t>(k);
        }
      }
    }
    const long long o = t * VEC;
    *reinterpret_cast<Vec<T, VEC>*>(y + o) = best;
    Vec<int8_t, VEC> iv;
#pragma unroll
    for (int e = 0; e < VEC; ++e) iv.v[e] = id[e];
    *reinterpret_cast<Vec<int8_t, VEC>*>(idx + o) = iv;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    maxpool_bwd_kernel(const int8_t* __restrict__ idx,
                       const T* __restrict__ dp, T* __restrict__ dy,
                       Shape s) {
  const int groups = s.C / VEC;
  const long long total = static_cast<long long>(s.B) * s.H * s.W * groups;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(t % groups) * VEC;
    long long r = t / groups;
    const int w = static_cast<int>(r % s.W);
    r /= s.W;
    const int h = static_cast<int>(r % s.H);
    const long long b = r / s.H;

    Vec<T, VEC> acc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = T(0);
    for (int di = 0; di < s.window; ++di) {
      const int hi = h - di;
      if (hi < 0 || hi % s.stride) continue;
      const int i = hi / s.stride;
      if (i >= s.OH) continue;
      for (int dj = 0; dj < s.window; ++dj) {
        const int wj = w - dj;
        if (wj < 0 || wj % s.stride) continue;
        const int j = wj / s.stride;
        if (j >= s.OW) continue;
        const int k = di * s.window + dj;
        const long long o =
            ((b * s.OH + i) * s.OW + j) * static_cast<long long>(s.C) + c0;
        const Vec<int8_t, VEC> iv =
            *reinterpret_cast<const Vec<int8_t, VEC>*>(idx + o);
        const Vec<T, VEC> g = *reinterpret_cast<const Vec<T, VEC>*>(dp + o);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (iv.v[e] == k) acc.v[e] = add_round(acc.v[e], g.v[e]);
      }
    }
    *reinterpret_cast<Vec<T, VEC>*>(dy + t * VEC) = acc;
  }
}

int grid_for(long long total) {
  long long blocks = (total + NTHREADS - 1) / NTHREADS;
  // a grid-stride loop covers the rest; 132 SMs x 16 blocks keeps every
  // SM full
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* x, void* y, void* idx, Shape s,
                       cudaStream_t stream) {
  const long long total =
      static_cast<long long>(s.B) * s.OH * s.OW * (s.C / VEC);
  maxpool_fwd_kernel<T, VEC><<<grid_for(total), NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int8_t*>(idx), s);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* idx, const void* dp, void* dy, Shape s,
                       cudaStream_t stream) {
  const long long total =
      static_cast<long long>(s.B) * s.H * s.W * (s.C / VEC);
  maxpool_bwd_kernel<T, VEC><<<grid_for(total), NTHREADS, 0, stream>>>(
      static_cast<const int8_t*>(idx), static_cast<const T*>(dp),
      static_cast<T*>(dy), s);
  return cudaGetLastError();
}

Shape make_shape(int B, int H, int W, int C, int window, int stride) {
  return Shape{B,      H,      W, C, (H - window) / stride + 1,
               (W - window) / stride + 1, window, stride};
}

}  // namespace

// x [B, H, W, C] -> y [B, OH, OW, C] (x's dtype) and idx [B, OH, OW, C]
// int8, all contiguous.  dtype 0 = bf16, 1 = f32.  vec = channels per
// thread: 8 (bf16) or 4 (f32) when C and every pointer allow 16-byte
// accesses, else 1.  Launches on `stream` without synchronising.
// Returns 0, a cudaError_t, or -1 for an unsupported dtype/vec.
extern "C" int maxpool_fwd(const void* x, void* y, void* idx, int dtype,
                           int B, int H, int W, int C, int window,
                           int stride, int vec, void* stream) {
  const Shape s = make_shape(B, H, W, C, window, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 8) return launch_fwd<uint16_t, 8>(x, y, idx, s, st);
  if (dtype == 0 && vec == 1) return launch_fwd<uint16_t, 1>(x, y, idx, s, st);
  if (dtype == 1 && vec == 4) return launch_fwd<float, 4>(x, y, idx, s, st);
  if (dtype == 1 && vec == 1) return launch_fwd<float, 1>(x, y, idx, s, st);
  return -1;
}

// idx, dp [B, OH, OW, C] -> dy [B, H, W, C] (dp's dtype), all contiguous;
// the arguments as for maxpool_fwd, with (B, H, W, C) the input's shape.
extern "C" int maxpool_bwd(const void* idx, const void* dp, void* dy,
                           int dtype, int B, int H, int W, int C, int window,
                           int stride, int vec, void* stream) {
  const Shape s = make_shape(B, H, W, C, window, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 8) return launch_bwd<uint16_t, 8>(idx, dp, dy, s, st);
  if (dtype == 0 && vec == 1) return launch_bwd<uint16_t, 1>(idx, dp, dy, s, st);
  if (dtype == 1 && vec == 4) return launch_bwd<float, 4>(idx, dp, dy, s, st);
  if (dtype == 1 && vec == 1) return launch_bwd<float, 1>(idx, dp, dy, s, st);
  return -1;
}
