// The incremental mixing accumulate over (B, N) row buffers, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/weighted_mix.py:150
// mix_accumulate (_accum_kernel and _scale_kernel).  Computes what
// repro_torch/kernels/ref.py:mix_accumulate_ref computes, with per-row
// f32 weights w (B,):
//     accumulate form:  out[b, j] = acc[b, j] + w[b] * x[b, j]  in acc's dtype
//     init form:        out[b, j] = w[b] * x[b, j]              in x's dtype
// in f32 math.  The accumulate form is one fused multiply-add (fmaf): XLA
// on the CPU contracts the reference's `acc + x * w` into an FMA (the
// port's tests read it bit-equal to the fused form and one f32 spacing
// off the separately rounded one), so the kernel rounds once as well.
// The init form is one rounded multiply (__fmul_rn).
//
// Bound: bytes.  Every input byte is read once and every output byte
// written once (12 bytes an element for f32 in the accumulate form)
// against 2 operations an element, so the design only streams: a block
// row per grid y (the row's weight read once), threads walking the row
// with a grid-stride loop over groups of VEC adjacent elements moved by
// one vector load or store each.  An element is read before it is
// written by the same thread, so `out` may alias `acc` or `x`.  A row
// start off the vector grid takes VEC = 1.  Indices are 64-bit.

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

// INIT selects the init form: no accumulator, and out has x's dtype.
template <typename TO, typename TX, bool INIT, int VEC>
__global__ void __launch_bounds__(THREADS)
mix_accumulate_kernel(const TO* acc, const TX* x, const float* __restrict__ w, TO* out,
                      long long N) {
  const int b = blockIdx.y;
  const float wb = w[b];
  const long long row = (long long)b * N;
  const long long groups = N / VEC;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long j = row + g * VEC;
    const Pack<TX, VEC> xv = *reinterpret_cast<const Pack<TX, VEC>*>(x + j);
    Pack<TO, VEC> o;
    if constexpr (INIT) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) store(&o.x[v], __fmul_rn(to_f32(xv.x[v]), wb));
    } else {
      const Pack<TO, VEC> av = *reinterpret_cast<const Pack<TO, VEC>*>(acc + j);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        store(&o.x[v], fmaf(to_f32(xv.x[v]), wb, to_f32(av.x[v])));
    }
    *reinterpret_cast<Pack<TO, VEC>*>(out + j) = o;
  }
}

template <typename TO, typename TX, bool INIT, int VEC>
cudaError_t launch_vec(const TO* acc, const TX* x, const float* w, TO* out, int B,
                       long long N, int sms, cudaStream_t stream) {
  const long long need = (N / VEC + THREADS - 1) / THREADS;
  const long long cap = (16LL * sms + B - 1) / B;  // about 16 blocks an SM in all
  const int blocks = (int)(need < cap ? (need > 0 ? need : 1) : cap);
  mix_accumulate_kernel<TO, TX, INIT, VEC>
      <<<dim3(blocks, B), THREADS, 0, stream>>>(acc, x, w, out, N);
  return cudaGetLastError();
}

template <typename TO, typename TX, bool INIT>
cudaError_t launch(const TO* acc, const TX* x, const float* w, TO* out, int B, long long N,
                   int sms, cudaStream_t stream) {
  // 16 bytes of f32 or 8 of bf16 a group; every row start on that grid
  constexpr int VEC = 4;
  const uintptr_t ax = VEC * sizeof(TX), ao = VEC * sizeof(TO);
  const bool aligned = N % VEC == 0 && (uintptr_t)x % ax == 0 && (uintptr_t)out % ao == 0 &&
                       (INIT || (uintptr_t)acc % ao == 0);
  if (aligned) return launch_vec<TO, TX, INIT, VEC>(acc, x, w, out, B, N, sms, stream);
  return launch_vec<TO, TX, INIT, 1>(acc, x, w, out, B, N, sms, stream);
}

template <typename TX>
cudaError_t dispatch_acc(const void* acc, const TX* x, const float* w, void* out,
                         int acc_bf16, int B, long long N, int sms, cudaStream_t s) {
  if (acc == nullptr)
    return launch<TX, TX, true>(nullptr, x, w, static_cast<TX*>(out), B, N, sms, s);
  if (acc_bf16)
    return launch<__nv_bfloat16, TX, false>(static_cast<const __nv_bfloat16*>(acc), x, w,
                                            static_cast<__nv_bfloat16*>(out), B, N, sms, s);
  return launch<float, TX, false>(static_cast<const float*>(acc), x, w,
                                  static_cast<float*>(out), B, N, sms, s);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted; cudaErrorInvalidValue for B outside [1, 65535] or
// N < 1).  x is a contiguous (B, N) device buffer (f32, or bf16 when
// `x_bf16`); w a (B,) f32 device vector; acc, when not null, a contiguous
// (B, N) buffer (bf16 when `acc_bf16`) and out of acc's dtype, else out of
// x's dtype.  out may be acc or x.  `sms` is the card's SM count.
int mix_accumulate(const void* acc, const void* x, const void* w, void* out, int B,
                   long long N, int acc_bf16, int x_bf16, int sms, void* stream) {
  if (B < 1 || B > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (x_bf16)
    return (int)dispatch_acc<__nv_bfloat16>(acc, static_cast<const __nv_bfloat16*>(x), wf,
                                            out, acc_bf16, B, N, sms, s);
  return (int)dispatch_acc<float>(acc, static_cast<const float*>(x), wf, out, acc_bf16, B,
                                  N, sms, s);
}

const char* mix_accumulate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
