// The int8-block receive fold, dequantize and accumulate in one pass, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wire_codec.py:176
// dequant_accumulate.  Computes what repro_torch/kernels/ref.py:
// dequant_accumulate_ref computes, for q (B, Nq) int8 and scales
// (B, Nq / block) bf16 in the layout of quantize_block.cu and per-row f32
// weights w (B,):
//     accumulate form:  out[b, c] = acc[b, c] + w[b] * (q[b, c] * s)   c < N
//                       in acc's dtype (f32 or bf16), N <= Nq
//     init form:        out[b, c] = w[b] * (q[b, c] * s)                c < Nq, f32
// where s = scales[b, c / block].  q * s is one rounded multiply and exact
// (8 bits of q times the 8-bit significand of a bf16 scale); the
// accumulate form is one fused multiply-add (fmaf), rounded once, as the
// plain version rounds it; the init form one rounded multiply (__fmul_rn).
// The dequantized row never exists in device memory.
//
// Bound: bytes.  An f32 accumulate reads 4 + 1 bytes and writes 4 an
// element, the scales 2 bytes a block, against 3 operations an element,
// so the design only streams: one grid row per buffer row (its weight read
// once), threads walking the row with a grid-stride loop over groups of 16
// adjacent columns: one 16-byte load of q, four 16-byte loads and stores
// of f32 acc and out (two of bf16), and one scale, since 16 columns never
// straddle a block of 32, 64 or 128.  An element is read before it is
// written by the same thread, so `out` may alias `acc`.  A buffer off the
// 16-byte grid, and the last N % 16 columns of a row, take one column a
// thread.  Indices are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;  // columns a thread takes at once: one 16-byte load of q

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 values of T moved as 16-byte words (4 of them for f32, 2 for bf16)
template <typename T> struct alignas(16) Row16 { T x[VEC]; };

template <typename T>
__device__ __forceinline__ Row16<T> load16(const T* p) {
  constexpr int WORDS = VEC * sizeof(T) / 16;
  Row16<T> r;
  const uint4* src = reinterpret_cast<const uint4*>(p);
  uint4* dst = reinterpret_cast<uint4*>(r.x);
#pragma unroll
  for (int i = 0; i < WORDS; ++i) dst[i] = src[i];
  return r;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Row16<T>& r) {
  constexpr int WORDS = VEC * sizeof(T) / 16;
  uint4* dst = reinterpret_cast<uint4*>(p);
  const uint4* src = reinterpret_cast<const uint4*>(r.x);
#pragma unroll
  for (int i = 0; i < WORDS; ++i) dst[i] = src[i];
}

template <typename TA, bool INIT>
__device__ __forceinline__ float fold(const TA* acc, long long j, float w, float d) {
  if constexpr (INIT) {
    return __fmul_rn(w, d);
  } else {
    return fmaf(w, d, to_f32(acc[j]));
  }
}

// INIT selects the init form (acc is null and TA is float).  WIDE takes
// the 16-column vector path for whole groups; the ragged tail of a row,
// or every column when !WIDE, goes one column a thread.
template <typename TA, bool INIT, bool WIDE, int BLOCK>
__global__ void __launch_bounds__(THREADS)
dequant_accumulate_kernel(const TA* acc, const int8_t* __restrict__ q,
                          const __nv_bfloat16* __restrict__ scales,
                          const float* __restrict__ w, TA* out, long long N, long long Nq) {
  const long long b = blockIdx.y;
  const float wb = w[b];
  const int8_t* qb = q + b * Nq;
  const __nv_bfloat16* sb = scales + b * (Nq / BLOCK);
  const TA* ab = INIT ? nullptr : acc + b * N;
  TA* ob = out + b * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (WIDE) {
    const long long groups = N / VEC;
    for (long long g = first; g < groups; g += stride) {
      const long long col = g * VEC;
      const float s = __bfloat162float(sb[col / BLOCK]);
      const Row16<int8_t> qv = load16(qb + col);
      Row16<TA> o;
      if constexpr (INIT) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) o.x[v] = __fmul_rn(wb, __fmul_rn((float)qv.x[v], s));
      } else {
        const Row16<TA> av = load16(ab + col);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          store(&o.x[v], fmaf(wb, __fmul_rn((float)qv.x[v], s), to_f32(av.x[v])));
      }
      store16(ob + col, o);
    }
    done = groups * VEC;
  }
  for (long long c = done + first; c < N; c += stride) {
    const float d = __fmul_rn((float)qb[c], __bfloat162float(sb[c / BLOCK]));
    store(&ob[c], fold<TA, INIT>(ab, c, wb, d));
  }
}

template <typename TA, bool INIT, int BLOCK>
cudaError_t launch(const TA* acc, const int8_t* q, const __nv_bfloat16* scales,
                   const float* w, TA* out, int B, long long N, long long Nq, int sms,
                   cudaStream_t stream) {
  // rows start on the 16-byte grid when the bases do and N keeps them there
  const uintptr_t row_bytes = (uintptr_t)N * sizeof(TA);
  const bool wide = (uintptr_t)q % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                    (INIT || (uintptr_t)acc % 16 == 0) && row_bytes % 16 == 0;
  const long long per_thread = wide ? VEC : 1;
  const long long need = ((N + per_thread - 1) / per_thread + THREADS - 1) / THREADS;
  const long long per_row = (16LL * sms + B - 1) / B;  // about 16 blocks an SM in all
  const dim3 grid((unsigned)(need < per_row ? (need > 0 ? need : 1) : per_row), (unsigned)B);
  if (wide)
    dequant_accumulate_kernel<TA, INIT, true, BLOCK>
        <<<grid, THREADS, 0, stream>>>(acc, q, scales, w, out, N, Nq);
  else
    dequant_accumulate_kernel<TA, INIT, false, BLOCK>
        <<<grid, THREADS, 0, stream>>>(acc, q, scales, w, out, N, Nq);
  return cudaGetLastError();
}

template <int BLOCK>
cudaError_t dispatch(const void* acc, const int8_t* q, const __nv_bfloat16* scales,
                     const float* w, void* out, int acc_bf16, int B, long long N,
                     long long Nq, int sms, cudaStream_t s) {
  if (acc == nullptr)
    return launch<float, true, BLOCK>(nullptr, q, scales, w, static_cast<float*>(out), B,
                                      Nq, Nq, sms, s);
  if (acc_bf16)
    return launch<__nv_bfloat16, false, BLOCK>(
        static_cast<const __nv_bfloat16*>(acc), q, scales, w,
        static_cast<__nv_bfloat16*>(out), B, N, Nq, sms, s);
  return launch<float, false, BLOCK>(static_cast<const float*>(acc), q, scales, w,
                                     static_cast<float*>(out), B, N, Nq, sms, s);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted; cudaErrorInvalidValue for a block other than 32, 64 or
// 128, B outside [1, 65535], Nq not a positive multiple of block, or,
// with acc, N outside [1, Nq]).  q is a contiguous (B, Nq) int8 device
// buffer, scales a contiguous (B, Nq / block) bf16 one, w a (B,) f32 one.
// acc, when not null, is a contiguous (B, N) buffer (bf16 when
// `acc_bf16`, else f32) and out a contiguous (B, N) one of acc's dtype,
// which may be acc; with a null acc, out is a contiguous (B, Nq) f32
// buffer and N is not read.  `sms` is the card's SM count.
int dequant_accumulate(const void* acc, const void* q, const void* scales, const void* w,
                       void* out, int B, long long N, long long Nq, int block, int acc_bf16,
                       int sms, void* stream) {
  if (B < 1 || B > 65535 || Nq < 1) return (int)cudaErrorInvalidValue;
  if (block != 32 && block != 64 && block != 128) return (int)cudaErrorInvalidValue;
  if (Nq % block != 0) return (int)cudaErrorInvalidValue;
  if (acc != nullptr && (N < 1 || N > Nq)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const float* wf = static_cast<const float*>(w);
  if (block == 128) return (int)dispatch<128>(acc, qi, sc, wf, out, acc_bf16, B, N, Nq, sms, s);
  if (block == 64) return (int)dispatch<64>(acc, qi, sc, wf, out, acc_bf16, B, N, Nq, sms, s);
  return (int)dispatch<32>(acc, qi, sc, wf, out, acc_bf16, B, N, Nq, sms, s);
}

const char* dequant_accumulate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
