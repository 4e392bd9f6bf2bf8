// Symmetric per-block quantization of (B, N) f32 rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wire_codec.py:95
// quantize_block.  Computes what repro_torch/kernels/ref.py:
// quantize_block_ref computes.  Row b is cut into NB = ceil(N / block)
// blocks of `block` columns, the tail padded with zeros; for block j
//     s      = bf16(max|x| / levels)          (the stored scale, round to nearest even)
//     s_used = s > 0 ? s : 1
//     q      = clip(rint(x / s_used), -levels, levels)   as int8
//     r      = x - q * s_used                 (the error-feedback residual, optional)
// q is (B, NB * block), scales (B, NB) bf16 with scales[b, j] covering
// columns j * block .. (j + 1) * block, the residual (B, N) f32.
//
// q and the scales are held bit-equal to the reference, so the arithmetic
// is IEEE f32 step by step: a true division (__fdiv_rn) for max / levels
// and for x / s_used, never a multiply by a reciprocal; the scale rounded
// to bf16 first (__float2bfloat16_rn) and used back in f32; rintf, which
// rounds half to even as jnp.round does; the residual as one rounded
// multiply and one rounded subtract (__fmul_rn, __fsub_rn), so nvcc cannot
// contract it into an FMA (q * s_used is exact anyway: 8 bits of q times
// the 8-bit significand of a bf16).  The build keeps -ftz=false and
// -prec-div=true, so subnormal scales stay subnormal.
//
// Bound: bytes.  x is read once (4 bytes an element), q written once (1),
// the scales (2 bytes a block) and the residual (4) once.  One warp takes
// one (row, block) at a time: each lane loads block / 32 adjacent columns
// with one vector load, the warp reduces max|x| with shuffles, and every
// lane writes its q and residual columns; warps walk the (row, block)
// pairs with a grid-stride loop.  Each lane reads its columns before it
// writes them, so the residual may be written over x.  A row start off the
// vector grid, or a ragged last block, takes scalar loads for those lanes.
// Indices are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int VPT> struct alignas(4 * VPT) F32s { float x[VPT]; };
template <int VPT> struct alignas(VPT) I8s { int8_t x[VPT]; };

template <int BLOCK>
__global__ void __launch_bounds__(THREADS)
quantize_block_kernel(const float* x, long long ldx, int8_t* __restrict__ q,
                      __nv_bfloat16* __restrict__ scales, float* res, long long ldr, int B,
                      long long N, long long NB, int levels, int vec) {
  constexpr int VPT = BLOCK / 32;
  const int lane = threadIdx.x & 31;
  const long long tasks = (long long)B * NB;
  const float lv = (float)levels;
  for (long long t = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5); t < tasks;
       t += (long long)gridDim.x * WARPS) {
    const long long b = t / NB, j = t - b * NB;
    const long long col = j * BLOCK + lane * VPT;
    const float* xr = x + b * ldx;
    float v[VPT];
    const bool whole = vec && col + VPT <= N;
    if (whole) {
      const F32s<VPT> p = *reinterpret_cast<const F32s<VPT>*>(xr + col);
#pragma unroll
      for (int i = 0; i < VPT; ++i) v[i] = p.x[i];
    } else {
#pragma unroll
      for (int i = 0; i < VPT; ++i) v[i] = col + i < N ? xr[col + i] : 0.0f;
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const __nv_bfloat16 sb = __float2bfloat16_rn(__fdiv_rn(amax, lv));
    const float s = __bfloat162float(sb);
    const float su = s > 0.0f ? s : 1.0f;
    if (lane == 0) scales[t] = sb;
    I8s<VPT> qo;
    float r[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const float qi = fminf(fmaxf(rintf(__fdiv_rn(v[i], su)), -lv), lv);
      qo.x[i] = (int8_t)qi;
      r[i] = __fsub_rn(v[i], __fmul_rn(qi, su));
    }
    *reinterpret_cast<I8s<VPT>*>(q + b * NB * BLOCK + col) = qo;
    if (res != nullptr) {
      float* rr = res + b * ldr;
      if (whole) {
        F32s<VPT> p;
#pragma unroll
        for (int i = 0; i < VPT; ++i) p.x[i] = r[i];
        *reinterpret_cast<F32s<VPT>*>(rr + col) = p;
      } else {
#pragma unroll
        for (int i = 0; i < VPT; ++i)
          if (col + i < N) rr[col + i] = r[i];
      }
    }
  }
}

template <int BLOCK>
cudaError_t launch(const float* x, long long ldx, int8_t* q, __nv_bfloat16* scales, float* res,
                   long long ldr, int B, long long N, long long NB, int levels, int sms,
                   cudaStream_t stream) {
  constexpr int VPT = BLOCK / 32;
  const uintptr_t a = 4 * VPT;
  const int vec = ldx % VPT == 0 && (uintptr_t)x % a == 0 &&
                  (res == nullptr || (ldr % VPT == 0 && (uintptr_t)res % a == 0));
  const long long need = ((long long)B * NB + WARPS - 1) / WARPS;
  const int blocks = (int)(need < 16LL * sms ? need : 16LL * sms);
  quantize_block_kernel<BLOCK>
      <<<blocks, THREADS, 0, stream>>>(x, ldx, q, scales, res, ldr, B, N, NB, levels, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted; cudaErrorInvalidValue for a block other than 32, 64 or
// 128, levels outside [1, 127], B < 1, N < 1, or a q buffer off the
// block / 32 byte grid).  x is a (B, N) f32 device buffer with row stride
// ldx (elements); q a contiguous (B, NB * block) int8 buffer; scales a
// contiguous (B, NB) bf16 buffer; res, when not null, a (B, N) f32 buffer
// with row stride ldr, which may be x itself.  `sms` is the card's SM count.
int quantize_block(const void* x, long long ldx, void* q, void* scales, void* res,
                   long long ldr, int B, long long N, int block, int levels, int sms,
                   void* stream) {
  if (B < 1 || N < 1 || levels < 1 || levels > 127) return (int)cudaErrorInvalidValue;
  if (block != 32 && block != 64 && block != 128) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)q % (block / 32) != 0) return (int)cudaErrorInvalidValue;
  const long long NB = (N + block - 1) / block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int8_t* qi = static_cast<int8_t*>(q);
  __nv_bfloat16* sc = static_cast<__nv_bfloat16*>(scales);
  float* r = static_cast<float*>(res);
  if (block == 128)
    return (int)launch<128>(xf, ldx, qi, sc, r, ldr, B, N, NB, levels, sms, s);
  if (block == 64) return (int)launch<64>(xf, ldx, qi, sc, r, ldr, B, N, NB, levels, sms, s);
  return (int)launch<32>(xf, ldx, qi, sc, r, ldr, B, N, NB, levels, sms, s);
}

const char* quantize_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
