// One whole FedLay mixing round over a resident (C, N) population buffer,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/weighted_mix.py:230
// gather_mix (_gather_mix_kernel).  Computes what
// repro_torch/kernels/ref.py:gather_mix_ref computes, through the dense
// (C, C) round matrix W the wrapper scatters from the (srcs, weights)
// table (repro_torch/kernels/ref.py:round_matrix):
//     out[i, j] = sum_k W[i, k] * buf[k, j]
// with f32 accumulation and the output in buf's dtype (f32 or bf16).
//
// Bound: bytes.  Every byte of buf is read once and every output byte
// written once: 2 * C * N * sizeof(buf) bytes at 3.35 TB/s (H100 SXM),
// against 2 * C * C * N f32 operations at 67 TFLOP/s, which stays below
// the memory time while C < about 80.  So the design streams columns:
//   * column j of the output depends on column j of buf alone.  W lives
//     in shared memory, loaded once per block; blocks walk the columns
//     with a grid-stride loop;
//   * C <= 32 (the slot runtime's capacities): a thread owns VEC adjacent
//     columns, loads the C values of each into registers with one vector
//     load per row (neighbouring threads on neighbouring addresses), and
//     writes its C output rows from them.  All loads of a column precede
//     its stores, so `out` may alias `buf` (an in-place round);
//   * 32 < C <= 224: a block stages a tile of columns (C x TILE f32) in
//     shared memory beside W, synchronises, computes the tile's C output
//     rows and synchronises again before the next tile, so again `out`
//     may alias `buf`;
//   * ragged N needs no padding: a row start that is not aligned to the
//     vector width, or N not a multiple of it, takes VEC = 1.
// Indices are 64-bit: C * N passes 2^31 at full model width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 224;
constexpr int SMEM_BYTES = 232448;  // what one block may use on Hopper

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// VEC adjacent elements moved as one load or store.
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack { T x[VEC]; };

template <typename T, int CB, int VEC>
__global__ void __launch_bounds__(THREADS)
gather_mix_reg(const float* __restrict__ W, const T* buf, T* out, int C, long long N) {
  extern __shared__ float Ws[];  // (C, C)
  for (int t = threadIdx.x; t < C * C; t += blockDim.x) Ws[t] = W[t];
  __syncthreads();
  const long long groups = N / VEC;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long col = g * VEC;
    float x[CB][VEC];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (k < C) {
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(buf + k * N + col);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[k][v] = to_f32(p.x[v]);
      }
    }
    for (int i = 0; i < C; ++i) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        if (k < C) {
          const float w = Ws[i * C + k];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = fmaf(w, x[k][v], acc[v]);
        }
      }
      Pack<T, VEC> p;
#pragma unroll
      for (int v = 0; v < VEC; ++v) store_f32(&p.x[v], acc[v]);
      *reinterpret_cast<Pack<T, VEC>*>(out + i * N + col) = p;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_mix_tile(const float* __restrict__ W, const T* buf, T* out, int C, long long N,
                int tile) {
  extern __shared__ float sm[];
  float* Ws = sm;          // (C, C)
  float* X = sm + C * C;   // (C, tile): the block's column tile
  for (int t = threadIdx.x; t < C * C; t += blockDim.x) Ws[t] = W[t];
  for (long long j0 = blockIdx.x * (long long)tile; j0 < N;
       j0 += (long long)gridDim.x * tile) {
    const int width = (int)(N - j0 < tile ? N - j0 : tile);
    __syncthreads();  // W is loaded; the previous tile's reads are done
    for (int t = threadIdx.x; t < C * tile; t += blockDim.x) {
      const int k = t / tile, j = t % tile;
      X[t] = j < width ? to_f32(buf[k * N + j0 + j]) : 0.0f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < C * tile; t += blockDim.x) {
      const int i = t / tile, j = t % tile;
      if (j < width) {
        float acc = 0.0f;
        for (int k = 0; k < C; ++k) acc = fmaf(Ws[i * C + k], X[k * tile + j], acc);
        store_f32(out + i * N + j0 + j, acc);
      }
    }
  }
}

template <typename T, int CB, int VEC>
cudaError_t launch_reg(const float* W, const T* buf, T* out, int C, long long N, int sms,
                       cudaStream_t stream) {
  const long long need = (N / VEC + THREADS - 1) / THREADS;
  const int blocks = (int)(need < 8LL * sms ? (need > 0 ? need : 1) : 8LL * sms);
  gather_mix_reg<T, CB, VEC>
      <<<blocks, THREADS, C * C * sizeof(float), stream>>>(W, buf, out, C, N);
  return cudaGetLastError();
}

template <typename T, int CB>
cudaError_t launch_cb(const float* W, const T* buf, T* out, int C, long long N, int sms,
                      cudaStream_t stream) {
  constexpr int VEC = CB <= 16 ? 4 : 2;
  const uintptr_t align = VEC * sizeof(T);
  if (N % VEC == 0 && (uintptr_t)buf % align == 0 && (uintptr_t)out % align == 0)
    return launch_reg<T, CB, VEC>(W, buf, out, C, N, sms, stream);
  return launch_reg<T, CB, 1>(W, buf, out, C, N, sms, stream);
}

template <typename T>
cudaError_t launch(const float* W, const T* buf, T* out, int C, long long N, int sms,
                   cudaStream_t stream) {
  if (C <= 8) return launch_cb<T, 8>(W, buf, out, C, N, sms, stream);
  if (C <= 16) return launch_cb<T, 16>(W, buf, out, C, N, sms, stream);
  if (C <= 32) return launch_cb<T, 32>(W, buf, out, C, N, sms, stream);
  // the widest power-of-two tile, from 256 columns down to 32, that fits
  // beside W in a block's shared memory
  int tile = 256;
  while (tile > 32 && (size_t)(C * C + C * tile) * sizeof(float) > SMEM_BYTES) tile /= 2;
  const size_t smem = (size_t)(C * C + C * tile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_mix_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long need = (N + tile - 1) / tile;
  const int blocks = (int)(need < 4LL * sms ? need : 4LL * sms);
  gather_mix_tile<T><<<blocks, THREADS, smem, stream>>>(W, buf, out, C, N, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when it
// was accepted; cudaErrorInvalidValue for C outside [1, 224] or N < 1).
// W is a contiguous (C, C) f32 device matrix; buf and out are contiguous
// (C, N) device buffers of one dtype (f32, or bf16 when `bf16`), and may
// be the same buffer.  `sms` is the card's SM count.
int gather_mix(const void* W, const void* buf, void* out, int C, long long N, int bf16,
               int sms, void* stream) {
  if (C < 1 || C > MAX_C || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  if (bf16)
    return (int)launch<__nv_bfloat16>(w, static_cast<const __nv_bfloat16*>(buf),
                                      static_cast<__nv_bfloat16*>(out), C, N, sms, s);
  return (int)launch<float>(w, static_cast<const float*>(buf), static_cast<float*>(out), C,
                            N, sms, s);
}

const char* gather_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
