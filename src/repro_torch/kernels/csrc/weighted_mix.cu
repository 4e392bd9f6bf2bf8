// The stacked weighted mix of K flat model vectors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/weighted_mix.py:88
// weighted_mix (_mix_kernel, :81-85).  Computes what
// repro_torch/kernels/ref.py:weighted_mix_ref computes, with f32 weights
// w (K,) read from the device:
//     out[j] = sum_{k = 0 .. K-1} w[k] * models[k, j]    in models' dtype
// in f32 math, from zero, in the order k = 0 .. K-1, each product rounded
// to f32 and then added (__fmul_rn, __fadd_rn: no contraction into an
// FMA), so the plain version's sequence of tensor operations gives the
// same bits.  The mask renormalization of the reference stays outside
// (the wrapper's K scalar operations), as in the TPU kernel.
//
// Bound: bytes.  Each of the K rows is read once and the output written
// once, (K + 1) * N * itemsize bytes, against 2 * K * N operations, so
// the design only streams.  No Pallas tiling or padding is carried over:
// threads walk N with a grid-stride loop over groups of VEC adjacent
// elements, read every row's group by one 16-byte load (8 bytes for bf16
// at VEC 4 would halve the width, so bf16 takes VEC 8), sum in registers
// and store the group once.  Rows are addressed through a row stride, so
// a (K, N) view into a larger buffer (the DFL engine's inbox, a region's
// rows of the client buffer) is read in place.  The vector path needs the
// base, the row stride and the output on the 16-byte grid; the last N %
// VEC elements take a scalar tail, and any other layout takes VEC 1.  A
// thread reads all K values of an element before it writes it, so the
// output may be one of the rows.  Indices are 64-bit; K is any int >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack { T x[VEC]; };

// Elements [lo + VEC * g, lo + VEC * g + VEC) for the groups g this thread
// owns, lo = 0 and `groups` of them; then, with VEC > 1, the scalar tail
// [VEC * groups, N) one element a thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
weighted_mix_kernel(const T* models, long long row_stride, const float* __restrict__ w,
                    T* out, int K, long long N) {
  const long long groups = N / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long g = first; g < groups; g += stride) {
    const long long j = g * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wk = __ldg(w + k);
      const Pack<T, VEC> xv =
          *reinterpret_cast<const Pack<T, VEC>*>(models + k * row_stride + j);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(wk, to_f32(xv.x[v])));
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) store(&o.x[v], acc[v]);
    *reinterpret_cast<Pack<T, VEC>*>(out + j) = o;
  }
  if (VEC > 1) {
    for (long long j = groups * VEC + first; j < N; j += stride) {
      float acc = 0.0f;
      for (int k = 0; k < K; ++k)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), to_f32(models[k * row_stride + j])));
      store(out + j, acc);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* models, long long row_stride, const float* w, T* out, int K,
                       long long N, int sms, cudaStream_t stream) {
  const long long work = N / VEC > 0 ? N / VEC : N;
  const long long need = (work + THREADS - 1) / THREADS;
  const long long cap = 16LL * sms;  // about 16 blocks an SM
  const int blocks = (int)(need < cap ? need : cap);
  weighted_mix_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(models, row_stride, w, out, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* models, long long row_stride, const float* w, T* out, int K,
                   long long N, int sms, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);  // 4 f32 or 8 bf16: one 16-byte load
  const bool aligned = (uintptr_t)models % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                       (row_stride * (long long)sizeof(T)) % 16 == 0;
  if (aligned) return launch_vec<T, VEC>(models, row_stride, w, out, K, N, sms, stream);
  return launch_vec<T, 1>(models, row_stride, w, out, K, N, sms, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted; cudaErrorInvalidValue for K < 1, N < 1 or a negative
// row stride).  models is a (K, N) device buffer whose rows start
// `row_stride` elements apart and whose columns are adjacent (f32, or
// bf16 when `bf16`); w a (K,) f32 device vector; out a contiguous (N,)
// buffer of models' dtype, which may be one of the rows.  `sms` is the
// card's SM count.
int weighted_mix(const void* models, long long row_stride, const void* w, void* out, int K,
                 long long N, int bf16, int sms, void* stream) {
  if (K < 1 || N < 1 || row_stride < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (bf16)
    return (int)launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(models), row_stride,
                                      wf, static_cast<__nv_bfloat16*>(out), K, N, sms, s);
  return (int)launch<float>(static_cast<const float*>(models), row_stride, wf,
                            static_cast<float*>(out), K, N, sms, s);
}

const char* weighted_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
