// The stacked weighted mix of K flat model vectors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/weighted_mix.py:88
// weighted_mix (_mix_kernel, :81-85).  Computes what
// repro_torch/kernels/ref.py:weighted_mix_ref computes, with f32 weights
// w (K,):
//     out[j] = sum_{k = 0 .. K-1} w[k] * models[k, j]    in models' dtype
// in f32 math, from zero, in the order k = 0 .. K-1, each product rounded
// to f32 and then added (__fmul_rn, __fadd_rn: no contraction into an
// FMA), so the plain version's sequence of tensor operations gives the
// same bits.  The mask renormalization of the reference stays outside
// (repro_torch/kernels/ref.py:masked_weights), as in the TPU kernel.
//
// Bound: bytes.  Each of the K rows is read once and the output written
// once, (K + 1) * N * itemsize bytes, against 2 * K * N operations.  At
// the DFL engine's wake-up (K 7, N 50,890 f32, 1.6 MB) the call is over
// in a few memory latencies, so the design cuts the trips a thread makes
// to memory and the launch's own waits:
//
// - One trip a thread.  A thread loads its elements of GROUP rows before
//   the first add, then sums them in order; K runs as full groups of
//   GROUP rows and one remainder group (an instantiation for each
//   remainder size, so its loads too are in flight together), the groups
//   in order.  At K <= GROUP that is one trip.  The launch bounds give
//   ptxas the registers to hold a group (MIN_BLOCKS).
// - Weights in the launch.  Weights from the host are passed by value in
//   the kernel's parameters (ByValue: MAX_BY_VALUE floats, 2 KB of the
//   4 KB a launch takes), read from the constant bank with no dependent
//   load and no copy to the device before the launch.  Weights on the device are read through a pointer
//   (ByPointer, __ldg), with K as a runtime value.
// - A grid that fills the card.  The wrapper's launch plan
//   (kernels/weighted_mix.py:launch_plan) picks the widest load that
//   the base, the row stride and the output all allow (16, 8, 4 bytes;
//   2 for bf16: VEC elements a load) and a block size and grid that put
//   a block on every SM at the wake-up; a grid-stride loop covers large
//   N.  The last N % VEC elements take a scalar tail.
//
// Rows are addressed through a row stride, so a (K, N) view into a larger
// buffer (the DFL engine's inbox, a region's rows of the client buffer) is
// read in place.  A thread reads all K values of an element before it
// writes it, so the output may be one of the rows.  Indices are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // the plan's largest block
// Blocks of MAX_THREADS an SM that the register budget must allow: 2, so
// ptxas may give a thread up to 128 registers.  Without it ptxas kept a
// thread near 32 registers: it placed the first adds among a group's
// loads and reloaded into the registers they freed, so the later rows'
// loads waited for the first row's (two trips at K 7, one a row in the
// groups).  With it, every load of a group issues before the first add.
constexpr int MIN_BLOCKS = 2;
constexpr int GROUP = 8;          // rows a trip
constexpr int MAX_BY_VALUE = 512; // host weights carried in the launch up to this K

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack { T x[VEC]; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The weights as kernel parameters: CAP floats in the constant bank.
template <int CAP> struct ByValue {
  float w[CAP];
  __device__ __forceinline__ float operator[](int k) const { return w[k]; }
};

struct ByPointer {
  const float* w;
  __device__ __forceinline__ float operator[](int k) const { return __ldg(w + k); }
};

// acc += w[k] * rows[k] for k = k0 .. k0 + G - 1 in order, all G loads
// issued before the first add.
template <int G, typename T, int VEC, typename W>
__device__ __forceinline__ void mix_group(const T* p, long long row_stride, const W& w, int k0,
                                          float (&acc)[VEC]) {
  Pack<T, VEC> x[G];
#pragma unroll
  for (int i = 0; i < G; ++i)
    x[i] = *reinterpret_cast<const Pack<T, VEC>*>(p + (long long)(k0 + i) * row_stride);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float wk = w[k0 + i];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(wk, to_f32(x[i].x[v])));
  }
}

// The remainder group: G = rem, one instantiation each.
template <int G, typename T, int VEC, typename W>
__device__ __forceinline__ void mix_rest(const T* p, long long row_stride, const W& w, int k0,
                                         int rem, float (&acc)[VEC]) {
  if constexpr (G > 0) {
    if (rem == G) return mix_group<G>(p, row_stride, w, k0, acc);
    mix_rest<G - 1>(p, row_stride, w, k0, rem, acc);
  }
}

// Sums the K rows of the VEC elements at p into acc (from zero).
template <typename T, int VEC, typename W>
__device__ __forceinline__ void mix_rows(const T* p, long long row_stride, const W& w, int K,
                                         float (&acc)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  int k0 = 0;
  for (; k0 + GROUP <= K; k0 += GROUP) mix_group<GROUP>(p, row_stride, w, k0, acc);
  mix_rest<GROUP - 1>(p, row_stride, w, k0, K - k0, acc);
}

// Elements [VEC * g, VEC * g + VEC) for the groups g this thread owns;
// then, with VEC > 1, the scalar tail [VEC * (N / VEC), N) one element a
// thread.
template <typename T, int VEC, typename W>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
weighted_mix_kernel(const T* models, long long row_stride, const __grid_constant__ W w, T* out,
                    int K, long long N) {
  const long long groups = N / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long g = first; g < groups; g += stride) {
    const long long j = g * VEC;
    float acc[VEC];
    mix_rows(models + j, row_stride, w, K, acc);
    Pack<T, VEC> o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) store(&o.x[v], acc[v]);
    *reinterpret_cast<Pack<T, VEC>*>(out + j) = o;
  }
  if constexpr (VEC > 1) {
    for (long long j = groups * VEC + first; j < N; j += stride) {
      float acc[1];
      mix_rows(models + j, row_stride, w, K, acc);
      store(out + j, acc[0]);
    }
  }
}

struct Launch {
  long long row_stride, N;
  int K, threads, blocks;
  cudaStream_t stream;
};

template <typename T, int VEC, typename W>
cudaError_t go(const Launch& a, const T* models, T* out, const W& w) {
  weighted_mix_kernel<T, VEC, W>
      <<<a.blocks, a.threads, 0, a.stream>>>(models, a.row_stride, w, out, a.K, a.N);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const Launch& a, const void* models, void* out, const float* w,
                       bool on_host) {
  const T* m = static_cast<const T*>(models);
  T* o = static_cast<T*>(out);
  if (on_host) {
    ByValue<MAX_BY_VALUE> v{};
    for (int k = 0; k < a.K; ++k) v.w[k] = w[k];
    return go<T, VEC>(a, m, o, v);
  }
  return go<T, VEC>(a, m, o, ByPointer{w});
}

template <typename T>
cudaError_t launch(const Launch& a, const void* models, void* out, const float* w,
                   bool on_host, int vec) {
  switch (vec) {
    case 1: return launch_vec<T, 1>(a, models, out, w, on_host);
    case 2: return launch_vec<T, 2>(a, models, out, w, on_host);
    case 4: return launch_vec<T, 4>(a, models, out, w, on_host);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_vec<T, 8>(a, models, out, w, on_host);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted).  models is a (K, N) device buffer whose rows start
// `row_stride` elements apart and whose columns are adjacent (f32, or
// bf16 when `bf16`); out a contiguous (N,) buffer of models' dtype, which
// may be one of the rows; w the (K,) f32 weights, in host memory when
// `w_on_host` (copied into the launch's parameters, K <= 512) and in
// device memory otherwise.  `vec`, `threads` and `blocks` are the
// wrapper's launch plan: elements a load (1, 2 or 4; 8 for bf16), threads
// a block (a multiple of 32 up to 256) and blocks.  Returns
// cudaErrorInvalidValue, launching nothing, for K < 1, N < 1, a negative
// row stride, a plan outside those limits, or a load width that the base,
// the output or (with K > 1) the row stride is not aligned to.
int weighted_mix(const void* models, long long row_stride, const void* w, int w_on_host,
                 void* out, int K, long long N, int bf16, int vec, int threads, int blocks,
                 void* stream) {
  const long long itemsize = bf16 ? 2 : 4;
  const long long width = vec * itemsize;
  const bool aligned = vec >= 1 && width <= 16 && (uintptr_t)models % width == 0 &&
                       (uintptr_t)out % width == 0 &&
                       (K == 1 || (row_stride * itemsize) % width == 0);
  if (K < 1 || N < 1 || row_stride < 0 || !aligned || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || blocks < 1 || (w_on_host && K > MAX_BY_VALUE))
    return (int)cudaErrorInvalidValue;
  const Launch a{row_stride, N, K, threads, blocks, static_cast<cudaStream_t>(stream)};
  const float* wf = static_cast<const float*>(w);
  if (bf16) return (int)launch<__nv_bfloat16>(a, models, out, wf, w_on_host != 0, vec);
  return (int)launch<float>(a, models, out, wf, w_on_host != 0, vec);
}

const char* weighted_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
