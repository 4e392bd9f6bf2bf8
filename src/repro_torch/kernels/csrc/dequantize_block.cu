// Per-block dequantization of an int8 wire buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wire_codec.py:145
// dequantize_block.  Computes what repro_torch/kernels/ref.py:
// dequantize_block_ref computes: out[b, c] = q[b, c] * scales[b, c / block]
// in f32, for q (B, NB * block) int8 and scales (B, NB) bf16 (the layout
// of quantize_block.cu).  The product is one rounded multiply (__fmul_rn),
// and exact: 8 bits of q times the 8-bit significand of a bf16 scale.
// The output is f32 with row stride ldo, and only its first `ncols`
// columns (at most NB * block) are written, as in gather_mix_int8.cu, so a
// caller with N columns passes a (B, N) buffer and gets no block padding.
//
// Bound: bytes: 1 byte of q read and 4 bytes written an element, the
// scales once.  Row b is grid row b; each thread takes 4 adjacent columns
// (one 4-byte load of q, one 16-byte store), which never straddle a block
// since block is a multiple of 4, and threads walk the row with a
// grid-stride loop.  An output off the vector grid takes one column a
// thread.  Indices are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int VEC> struct alignas(VEC) I8s { int8_t x[VEC]; };
template <int VEC> struct alignas(4 * VEC) F32s { float x[VEC]; };

template <int BLOCK, int VEC>
__global__ void __launch_bounds__(THREADS)
dequantize_block_kernel(const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ scales,
                        float* __restrict__ out, long long NB, long long ncols,
                        long long ldo) {
  const long long b = blockIdx.y;
  const int8_t* qb = q + b * NB * BLOCK;
  const __nv_bfloat16* sb = scales + b * NB;
  float* ob = out + b * ldo;
  const long long groups = (ncols + VEC - 1) / VEC;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long col = g * VEC;
    const float s = __bfloat162float(sb[col / BLOCK]);
    const I8s<VEC> p = *reinterpret_cast<const I8s<VEC>*>(qb + col);
    F32s<VEC> o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) o.x[v] = __fmul_rn((float)p.x[v], s);
    if (col + VEC <= ncols) {
      *reinterpret_cast<F32s<VEC>*>(ob + col) = o;
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (col + v < ncols) ob[col + v] = o.x[v];
    }
  }
}

template <int BLOCK>
cudaError_t launch(const int8_t* q, const __nv_bfloat16* scales, float* out, int B,
                   long long NB, long long ncols, long long ldo, int sms,
                   cudaStream_t stream) {
  // q's rows start on the 4-byte grid (NB * block is a multiple of 4), and
  // out's on the 16-byte grid when ldo is a multiple of 4
  const bool vec = (uintptr_t)q % 4 == 0 && (uintptr_t)out % 16 == 0 && ldo % 4 == 0;
  const int VEC = vec ? 4 : 1;
  const long long need = ((ncols + VEC - 1) / VEC + THREADS - 1) / THREADS;
  const long long per_row = (16LL * sms + B - 1) / B;
  const dim3 grid((unsigned)(need < per_row ? need : per_row), (unsigned)B);
  if (vec)
    dequantize_block_kernel<BLOCK, 4>
        <<<grid, THREADS, 0, stream>>>(q, scales, out, NB, ncols, ldo);
  else
    dequantize_block_kernel<BLOCK, 1>
        <<<grid, THREADS, 0, stream>>>(q, scales, out, NB, ncols, ldo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted; cudaErrorInvalidValue for a block other than 32, 64 or
// 128, B outside [1, 65535], NB < 1, ncols outside [1, NB * block] or
// ldo < ncols).  q is a contiguous (B, NB * block) int8 device buffer,
// scales a contiguous (B, NB) bf16 one, out a (B, ldo) f32 one whose first
// ncols columns are written.  `sms` is the card's SM count.
int dequantize_block(const void* q, const void* scales, void* out, int B, long long NB,
                     int block, long long ncols, long long ldo, int sms, void* stream) {
  if (B < 1 || B > 65535 || NB < 1) return (int)cudaErrorInvalidValue;
  if (block != 32 && block != 64 && block != 128) return (int)cudaErrorInvalidValue;
  if (ncols < 1 || ncols > NB * block || ldo < ncols) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  float* o = static_cast<float*>(out);
  if (block == 128) return (int)launch<128>(qi, sc, o, B, NB, ncols, ldo, sms, s);
  if (block == 64) return (int)launch<64>(qi, sc, o, B, NB, ncols, ldo, sms, s);
  return (int)launch<32>(qi, sc, o, B, NB, ncols, ldo, sms, s);
}

const char* dequantize_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
