// One whole mixing round over an int8-block encoded (C, N) population,
// for Hopper (sm_90a): the compressed sibling of gather_mix.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wire_codec.py:233
// gather_mix_int8.  Computes what repro_torch/kernels/ref.py:
// gather_mix_int8_ref computes, through the dense (C, C) round matrix W
// the wrapper scatters from the (srcs, weights) table:
//     out[i, j] = sum_k W[i, k] * (q[k, j] * scales[k, j / block])
// in f32, for q (C, NB * block) int8 and scales (C, NB) bf16 (the layout
// of quantize_block.cu).  The output is f32 with row stride ldo, and only
// its first `ncols` columns (at most NB * block) are written, so a caller
// with N columns passes a (C, N) buffer and gets no block padding.
//
// Bound: bytes.  q is read once (1 byte an element), the scales once and
// the output written once (4 bytes an element), against 2 * C * C
// operations an element, which stays below the memory time while C is
// below about 25; at C = 8 the card reads 5 bytes an element where the
// uncompressed round reads 8.  The design is gather_mix.cu's column
// streaming with the decode moved into registers, so the f32 image of the
// population never exists in device memory:
//   * W lives in shared memory, loaded once per block; blocks walk the
//     columns with a grid-stride loop;
//   * C <= 32: a thread owns VEC adjacent columns (which never straddle a
//     block, block being a multiple of 4), loads the C rows' q with one
//     VEC-byte load each and their C scales, dequantizes them in registers
//     (one rounded multiply, exact) and writes its C output rows;
//   * 32 < C <= 224: a block dequantizes a tile of columns (C x TILE f32)
//     into shared memory beside W, synchronises, and computes the tile's C
//     output rows.
// The sum over sources is fmaf over k = 0..C-1, as in gather_mix.cu's
// register body.
// Indices are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 224;
constexpr int SMEM_BYTES = 232448;  // what one block may use on Hopper

template <int VEC> struct alignas(VEC) I8s { int8_t x[VEC]; };
template <int VEC> struct alignas(4 * VEC) F32s { float x[VEC]; };

template <int BLOCK, int CB, int VEC>
__global__ void __launch_bounds__(THREADS)
gather_mix_int8_reg(const float* __restrict__ W, const int8_t* __restrict__ q,
                    const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int C,
                    long long NB, long long ncols, long long ldo, int vec_out) {
  extern __shared__ float Ws[];  // (C, C)
  for (int t = threadIdx.x; t < C * C; t += blockDim.x) Ws[t] = W[t];
  __syncthreads();
  const long long Nq = NB * BLOCK;
  const long long groups = (ncols + VEC - 1) / VEC;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long col = g * VEC;
    const long long blk = col / BLOCK;
    float x[CB][VEC];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (k < C) {
        const float s = __bfloat162float(scales[k * NB + blk]);
        const I8s<VEC> p = *reinterpret_cast<const I8s<VEC>*>(q + k * Nq + col);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[k][v] = __fmul_rn((float)p.x[v], s);
      }
    }
    const bool whole = vec_out && col + VEC <= ncols;
    for (int i = 0; i < C; ++i) {
      F32s<VEC> acc;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.x[v] = 0.0f;
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        if (k < C) {
          const float w = Ws[i * C + k];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc.x[v] = fmaf(w, x[k][v], acc.x[v]);
        }
      }
      float* o = out + i * ldo + col;
      if (whole) {
        *reinterpret_cast<F32s<VEC>*>(o) = acc;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (col + v < ncols) o[v] = acc.x[v];
      }
    }
  }
}

template <int BLOCK>
__global__ void __launch_bounds__(THREADS)
gather_mix_int8_tile(const float* __restrict__ W, const int8_t* __restrict__ q,
                     const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int C,
                     long long NB, long long ncols, long long ldo, int tile) {
  extern __shared__ float sm[];
  float* Ws = sm;          // (C, C)
  float* X = sm + C * C;   // (C, tile): the block's dequantized column tile
  for (int t = threadIdx.x; t < C * C; t += blockDim.x) Ws[t] = W[t];
  const long long Nq = NB * BLOCK;
  for (long long j0 = blockIdx.x * (long long)tile; j0 < ncols;
       j0 += (long long)gridDim.x * tile) {
    const int width = (int)(ncols - j0 < tile ? ncols - j0 : tile);
    __syncthreads();  // W is loaded; the previous tile's reads are done
    for (int t = threadIdx.x; t < C * tile; t += blockDim.x) {
      const int k = t / tile, j = t % tile;
      const long long c = j0 + j;
      X[t] = j < width ? __fmul_rn((float)q[k * Nq + c],
                                   __bfloat162float(scales[k * NB + c / BLOCK]))
                       : 0.0f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < C * tile; t += blockDim.x) {
      const int i = t / tile, j = t % tile;
      if (j < width) {
        float acc = 0.0f;
        for (int k = 0; k < C; ++k) acc = fmaf(Ws[i * C + k], X[k * tile + j], acc);
        out[i * ldo + j0 + j] = acc;
      }
    }
  }
}

template <int BLOCK, int CB>
cudaError_t launch_reg(const float* W, const int8_t* q, const __nv_bfloat16* scales,
                       float* out, int C, long long NB, long long ncols, long long ldo,
                       int sms, cudaStream_t stream) {
  constexpr int VEC = CB <= 16 ? 4 : 2;
  const int vec_out = ldo % VEC == 0 && (uintptr_t)out % (4 * VEC) == 0;
  const long long need = ((ncols + VEC - 1) / VEC + THREADS - 1) / THREADS;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  gather_mix_int8_reg<BLOCK, CB, VEC><<<blocks, THREADS, C * C * sizeof(float), stream>>>(
      W, q, scales, out, C, NB, ncols, ldo, vec_out);
  return cudaGetLastError();
}

template <int BLOCK>
cudaError_t launch(const float* W, const int8_t* q, const __nv_bfloat16* scales, float* out,
                   int C, long long NB, long long ncols, long long ldo, int sms,
                   cudaStream_t stream) {
  if (C <= 8) return launch_reg<BLOCK, 8>(W, q, scales, out, C, NB, ncols, ldo, sms, stream);
  if (C <= 16)
    return launch_reg<BLOCK, 16>(W, q, scales, out, C, NB, ncols, ldo, sms, stream);
  if (C <= 32)
    return launch_reg<BLOCK, 32>(W, q, scales, out, C, NB, ncols, ldo, sms, stream);
  // the widest power-of-two tile, from 256 columns down to 32, that fits
  // beside W in a block's shared memory
  int tile = 256;
  while (tile > 32 && (size_t)(C * C + C * tile) * sizeof(float) > SMEM_BYTES) tile /= 2;
  const size_t smem = (size_t)(C * C + C * tile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_mix_int8_tile<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long need = (ncols + tile - 1) / tile;
  const int blocks = (int)(need < 4LL * sms ? need : 4LL * sms);
  gather_mix_int8_tile<BLOCK>
      <<<blocks, THREADS, smem, stream>>>(W, q, scales, out, C, NB, ncols, ldo, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when
// it was accepted; cudaErrorInvalidValue for C outside [1, 224], a block
// other than 32, 64 or 128, NB < 1, ncols outside [1, NB * block],
// ldo < ncols, or q off the 4-byte grid).  W is a contiguous (C, C) f32
// device matrix; q a contiguous (C, NB * block) int8 buffer; scales a
// contiguous (C, NB) bf16 buffer; out a (C, ldo) f32 buffer whose first
// ncols columns are written.  `sms` is the card's SM count.
int gather_mix_int8(const void* W, const void* q, const void* scales, void* out, int C,
                    long long NB, int block, long long ncols, long long ldo, int sms,
                    void* stream) {
  if (C < 1 || C > MAX_C || NB < 1) return (int)cudaErrorInvalidValue;
  if (block != 32 && block != 64 && block != 128) return (int)cudaErrorInvalidValue;
  if (ncols < 1 || ncols > NB * block || ldo < ncols) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)q % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  float* o = static_cast<float*>(out);
  if (block == 128) return (int)launch<128>(w, qi, sc, o, C, NB, ncols, ldo, sms, s);
  if (block == 64) return (int)launch<64>(w, qi, sc, o, C, NB, ncols, ldo, sms, s);
  return (int)launch<32>(w, qi, sc, o, C, NB, ncols, ldo, sms, s);
}

const char* gather_mix_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
