// One whole FedLay mixing round over a resident (C, N) population buffer,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/weighted_mix.py:230
// gather_mix (_gather_mix_kernel).  Computes what
// repro_torch/kernels/ref.py:gather_mix_ref computes from the (C, K1)
// table of sources and weights:
//     out[i, j] = sum_k weights[i, k] * buf[srcs[i, k], j]
// with f32 accumulation and the output in buf's dtype (f32 or bf16);
// duplicate sources add.
//
// Bound: bytes.  Every byte of buf is read once and every output byte
// written once: 2 * C * N * sizeof(buf) bytes at 3.35 TB/s (H100 SXM),
// against 2 * C * K1 * N f32 operations, far below the f32 rate.  Column
// j of the output depends on column j of buf alone, so both bodies stream
// columns, and every load of a column precedes every store to it, so
// `out` may alias `buf` (the codec rounds mix in place).  The wrapper's
// launch plan (kernels/gather_mix.py:launch_plan) picks the body from C
// (the register body up to C 24, where the card timed it the faster at
// every N tried, the gather body above) and passes the tile, stages,
// widths, shared memory and grid; the entry checks them.
//   * C <= 24 (the slot runtime's capacities, the churn loop, the fault
//     storm; it holds up to 32 rows): the register body.  Each block
//     scatters the (C, K1) table into the dense (C, C) round matrix W in
//     shared memory (a row's entries in order, so duplicates add; a
//     source outside [0, C) is dropped), so that no launch but this one
//     builds it; a thread owns VEC adjacent columns, loads the C values
//     of each into registers with one vector load per row (neighbouring
//     threads on neighbouring addresses), and writes its C output rows
//     from them.  C x C x N products, but at small C they hide under the
//     loads.
//   * C > 24 (the cohort round, C 128): the gather body, a per-row gather
//     over a staged column tile, with no (C, C) matrix.  The dense form was
//     the TPU kernel's design (W feeds its matrix unit for free); here it
//     would cost C / K1 times the products (18 x at C 128, K1 7) and a
//     shared-memory load for each.  Instead:
//       - a block owns tiles of TILE columns across all C rows, walked
//         with a grid-stride loop by a grid of the blocks the card holds
//         at once (two of 512 threads an SM: the body takes up to 64
//         registers a thread), and copies each tile into a ring of
//         STAGES (1 or 2) shared-memory stages by cp.async, the next
//         tile's copy in flight while this one is mixed;
//       - the (C, K1) table is copied once into shared memory beside the
//         ring, packed as (source, weight bits), where it fits; else it is
//         read from device memory;
//       - a thread owns (row i, 16 bytes of adjacent columns of the tile),
//         reads its row's K1 (source, weight) pairs, KC at a time with all
//         their loads in flight together, sums K1 16-byte reads of the
//         tile per column group, and stores the result in stores of the
//         copy width, neighbouring threads on neighbouring columns;
//       - a tile is staged whole before the block writes any of its
//         outputs, and no other block touches its columns, so an in-place
//         round stays right;
//       - a source outside [0, C) is the caller's contract, as in the
//         reference; the body drops that term (as the reference's scatter
//         drops an index >= C) and never reads outside the staged tile
//         (the wrapper clamps a wider integer table to [-1, C] before it
//         narrows it to int32, so no such source wraps into [0, C));
//       - the copy width W (16, 8 or 4 bytes by cp.async; 2 for bf16 by
//         plain loads) is the widest that buf, out and the row length
//         N * sizeof(buf) are all aligned to: at N 50,890 f32 a row is 8
//         bytes past a 16-byte boundary every other row, so 8.  buf is
//         never padded; a ragged last tile copies and writes its valid
//         columns only, and N < TILE is one ragged tile;
//       - a block keeps STAGES x C x TILE x sizeof(buf) bytes of tiles in
//         shared memory, so C is at most 232,448 / (32 x 4) = 1,816 (one
//         stage of a 32-column f32 tile), whatever K1.
//     The ring's second stage pays off when a block has several tiles; at
//     the cohort round (796 tiles of 64 columns, 264 blocks) it has three.
// Indices are 64-bit where they reach into buf: C * N passes 2^31 at full
// model width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // the register body's block
// The gather body's block, and the blocks of it an SM must be able to hold
// (so at most 64 registers a thread); the launch plan's grid counts on
// that many (GATHER_MIN_BLOCKS in kernels/gather_mix.py).
constexpr int GATHER_THREADS = 512, MIN_BLOCKS = 2;
constexpr int REGISTER_ROWS = 32;   // the register body's most rows
constexpr int GATHER_MAX_C = 1816;
constexpr int SMEM_BYTES = 232448;  // what one block may use on Hopper

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// VEC adjacent elements moved as one load or store.
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack { T x[VEC]; };

// ---- the register body (C <= 32 rows) ------------------------------------

template <typename T, int CB, int VEC>
__global__ void __launch_bounds__(THREADS)
gather_mix_reg(const int* __restrict__ srcs, const float* __restrict__ weights, int K1,
               const T* buf, T* out, int C, long long N) {
  extern __shared__ float Ws[];  // (C, C): W[i, srcs[i, k]] += weights[i, k]
  for (int t = threadIdx.x; t < C * C; t += blockDim.x) Ws[t] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    for (int k = 0; k < K1; ++k) {
      const int s = __ldg(srcs + i * K1 + k);
      if ((unsigned)s < (unsigned)C) Ws[i * C + s] += __ldg(weights + i * K1 + k);
    }
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

template <typename T, int CB, int VEC>
cudaError_t launch_reg(const int* srcs, const float* weights, int K1, const T* buf, T* out,
                       int C, long long N, int blocks, cudaStream_t stream) {
  gather_mix_reg<T, CB, VEC>
      <<<blocks, THREADS, C * C * sizeof(float), stream>>>(srcs, weights, K1, buf, out, C, N);
  return cudaGetLastError();
}

// CB, the register rows, from C; VEC from the plan: 4 (C <= 16) or 2, or 1
// where the rows' alignment allows no wider.
template <typename T>
cudaError_t launch_register(const int* sr, const float* w, int K1, const T* buf, T* out,
                            int C, long long N, int vec, int blocks, cudaStream_t s) {
  if (C <= 8) return vec == 4 ? launch_reg<T, 8, 4>(sr, w, K1, buf, out, C, N, blocks, s)
                              : launch_reg<T, 8, 1>(sr, w, K1, buf, out, C, N, blocks, s);
  if (C <= 16) return vec == 4 ? launch_reg<T, 16, 4>(sr, w, K1, buf, out, C, N, blocks, s)
                               : launch_reg<T, 16, 1>(sr, w, K1, buf, out, C, N, blocks, s);
  return vec == 2 ? launch_reg<T, 32, 2>(sr, w, K1, buf, out, C, N, blocks, s)
                  : launch_reg<T, 32, 1>(sr, w, K1, buf, out, C, N, blocks, s);
}

// ---- the gather body (any C up to 1,816) ---------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most `pending` (0 or 1) of this thread's copy groups are
// in flight.
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Columns [j0, j0 + width) of all C rows of buf into the stage X (C rows of
// `tile` elements), in copies of WB bytes, then one commit group (empty
// when the block has no such tile).  Copies of 2 bytes (bf16 rows that are
// only 2-byte aligned) go by plain loads and stores.
template <typename T, int WB>
__device__ __forceinline__ void stage_tile(T* X, const T* buf, int C, long long N,
                                           long long j0, int width, int tile) {
  constexpr int E = WB / sizeof(T);  // elements a copy
  const int per_row = tile / E;
  for (int t = threadIdx.x; t < C * per_row; t += blockDim.x) {
    const int k = t / per_row, c = (t - k * per_row) * E;
    if (c < width) {
      T* dst = X + k * tile + c;
      const T* src = buf + k * N + j0 + c;
      if constexpr (WB >= 4) cp_async(dst, src, WB);
      else *dst = *src;
    }
  }
  cp_commit();
}

// One (source, weight) entry of row i's table: from shared memory, packed
// as (src, weight bits), or from the two device arrays.
template <bool SHARED>
__device__ __forceinline__ void entry(const int2* tp, const int* srcs, const float* weights,
                                      int at, int& s, float& w) {
  if constexpr (SHARED) {
    const int2 e = tp[at];
    s = e.x;
    w = __int_as_float(e.y);
  } else {
    s = __ldg(srcs + at);
    w = __ldg(weights + at);
  }
}

// The outputs of a staged tile.  A thread keeps V = 16 / sizeof(T) adjacent
// columns from c (one 16-byte read of the tile a source) and walks the rows
// i = r, r + R, ... (R rows side by side in the block).  A row's table is
// read in chunks of KC entries whose loads, and then whose reads of the
// tile, are all in flight together.  The V results go out in stores of
// WB bytes, the width the rows' alignment allows, and only those inside
// the tile's `width` valid columns.
constexpr int KC = 8;

template <typename T, int WB, bool SHARED>
__device__ __forceinline__ void mix_tile(const T* X, const int2* tp, const int* srcs,
                                         const float* weights, T* out, int C, int K1,
                                         long long N, long long j0, int width, int tile) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SV = WB / sizeof(T);
  const int per_row = tile / V;
  const int R = blockDim.x / per_row;
  const int c = (threadIdx.x % per_row) * V;
  if (c >= width) return;
  for (int i = threadIdx.x / per_row; i < C; i += R) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int k0 = 0; k0 < K1; k0 += KC) {
      int s[KC];
      float w[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[j] = -1;
        w[j] = 0.0f;
        if (k0 + j < K1) entry<SHARED>(tp, srcs, weights, i * K1 + k0 + j, s[j], w[j]);
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if ((unsigned)s[j] < (unsigned)C) {  // a source outside [0, C) is dropped
          const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(X + s[j] * tile + c);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(w[j], to_f32(x.x[v]), acc[v]);
        }
      }
    }
    T* row = out + i * N + j0 + c;
#pragma unroll
    for (int g = 0; g < V / SV; ++g) {
      if (c + g * SV < width) {
        Pack<T, SV> p;
#pragma unroll
        for (int v = 0; v < SV; ++v) store_f32(&p.x[v], acc[g * SV + v]);
        *reinterpret_cast<Pack<T, SV>*>(row + g * SV) = p;
      }
    }
  }
}

// The ring holds `stages` tiles of (C, tile) elements; with `table`, the
// (C, K1) table follows it in shared memory, packed as (src, weight bits).
template <typename T, int WB>
__global__ void __launch_bounds__(GATHER_THREADS, MIN_BLOCKS)
gather_mix_gather(const int* __restrict__ srcs, const float* __restrict__ weights,
                  const T* buf, T* out, int C, int K1, long long N, int tile, int stages,
                  int table) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // stages x (C, tile)
  int2* tp = reinterpret_cast<int2*>(smem + (size_t)stages * C * tile * sizeof(T));
  const int span = C * tile;
  const long long tiles = (N + tile - 1) / tile;
  // the block's tiles: blockIdx.x + n * gridDim.x for n < mine
  const long long mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long step = (long long)gridDim.x * tile;
  const long long first = (long long)blockIdx.x * tile;
  auto width_at = [&](long long j0) { return (int)(N - j0 < tile ? N - j0 : tile); };
  for (int n = 0; n < stages - 1; ++n) {
    if (n < mine) {
      const long long j0 = first + n * step;
      stage_tile<T, WB>(ring + n * span, buf, C, N, j0, width_at(j0), tile);
    } else {
      cp_commit();
    }
  }
  if (table)  // while the first tiles are in flight; the loop's barrier publishes it
    for (int t = threadIdx.x; t < C * K1; t += blockDim.x)
      tp[t] = make_int2(__ldg(srcs + t), __float_as_int(__ldg(weights + t)));
  for (long long n = 0; n < mine; ++n) {
    // refill the stage that the previous tile left (the barrier that ended
    // the last iteration freed it), then wait for this tile's copies
    const long long ahead = n + stages - 1;
    if (ahead < mine) {
      const long long j0 = first + ahead * step;
      stage_tile<T, WB>(ring + (int)(ahead % stages) * span, buf, C, N, j0, width_at(j0),
                        tile);
    } else {
      cp_commit();
    }
    cp_wait(stages - 1);
    __syncthreads();
    const long long j0 = first + n * step;
    const T* X = ring + (int)(n % stages) * span;
    if (table)
      mix_tile<T, WB, true>(X, tp, srcs, weights, out, C, K1, N, j0, width_at(j0), tile);
    else
      mix_tile<T, WB, false>(X, tp, srcs, weights, out, C, K1, N, j0, width_at(j0), tile);
    __syncthreads();
  }
}

template <typename T, int WB>
cudaError_t launch_gather_at(const int* srcs, const float* weights, const T* buf, T* out,
                             int C, int K1, long long N, int tile, int stages, int table,
                             int smem, int threads, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_mix_gather<T, WB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_mix_gather<T, WB><<<blocks, threads, smem, stream>>>(srcs, weights, buf, out, C,
                                                              K1, N, tile, stages, table);
  return cudaGetLastError();
}

// The copy width from the plan: 16, 8 or 4 bytes by cp.async, and for bf16
// also 2 bytes by plain loads and stores.
template <typename T>
cudaError_t launch_gather(const int* srcs, const float* weights, const T* buf, T* out,
                          int C, int K1, long long N, int tile, int stages, int table,
                          int width, int smem, int threads, int blocks, cudaStream_t s) {
  switch (width) {
    case 16: return launch_gather_at<T, 16>(srcs, weights, buf, out, C, K1, N, tile, stages,
                                            table, smem, threads, blocks, s);
    case 8: return launch_gather_at<T, 8>(srcs, weights, buf, out, C, K1, N, tile, stages,
                                          table, smem, threads, blocks, s);
    case 4: return launch_gather_at<T, 4>(srcs, weights, buf, out, C, K1, N, tile, stages,
                                          table, smem, threads, blocks, s);
  }
  if constexpr (sizeof(T) == 2)
    return launch_gather_at<T, 2>(srcs, weights, buf, out, C, K1, N, tile, stages, table,
                                  smem, threads, blocks, s);
  return cudaErrorInvalidValue;
}

// Is the plan one that the body can run?  (The plan itself is the
// wrapper's; this only refuses what would read or write out of bounds.)
bool plan_ok(int body, int C, int K1, long long N, long long itemsize, const void* buf,
             const void* out, int tile, int stages, int table, int width, long long smem,
             int threads, int blocks) {
  const bool aligned = width >= itemsize && width <= 16 && (width & (width - 1)) == 0 &&
                       (uintptr_t)buf % width == 0 && (uintptr_t)out % width == 0 &&
                       (N * itemsize) % width == 0;
  if (C < 1 || N < 1 || K1 < 1 || blocks < 1 || !aligned) return false;
  if (body == 0) {  // register: VEC = width / itemsize as the C bucket allows
    const long long vec = width / itemsize;
    return C <= REGISTER_ROWS && smem == (long long)C * C * 4 && threads == THREADS &&
           (vec == 1 || vec == (C <= 16 ? 4 : 2));
  }
  const long long entries = (long long)C * K1;
  return body == 1 && C <= GATHER_MAX_C && entries < (1LL << 31) &&
         (tile == 32 || tile == 64 || tile == 128) && (stages == 1 || stages == 2) &&
         threads == GATHER_THREADS &&
         smem == stages * C * tile * itemsize + (table ? entries * 8 : 0) &&
         smem <= SMEM_BYTES;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when it
// was accepted).  buf and out are contiguous (C, N) device buffers of one
// dtype (f32, or bf16 when `bf16`), and may be the same buffer.  `body`
// and the numbers after it are the wrapper's launch plan:
//   srcs (C, K1) int32 and weights (C, K1) f32 are the table, on the
//   device, for both bodies;
//   body 0, the register body: `width` the bytes of a thread's vector
//     load, smem C * C * 4 (the round matrix it scatters the table into);
//   body 1, the gather body: `tile` columns a stage (32, 64 or 128),
//     `stages` (1 or 2) of them in the ring, the table copied into shared
//     memory beside them when `table`, `width` bytes a copy and a store,
//     smem their bytes;
//   `threads` a block (256 for the register body, 512 for the gather
//   body) and `blocks` in the grid.
// Returns cudaErrorInvalidValue, launching nothing, for a plan the body
// cannot run: C, K1, N or the grid below 1, C above the body's limit (32
// and 1,816), a width that buf, out or a row of N elements is not aligned
// to, a tile or a ring the planner does not make, shared memory that is
// not the body's or exceeds 232,448 bytes, or another block size.
int gather_mix(const void* srcs, const void* weights, const void* buf, void* out, int C,
               int K1, long long N, int bf16, int body, int tile, int stages, int table,
               int width, int smem, int threads, int blocks, void* stream) {
  const long long itemsize = bf16 ? 2 : 4;
  if (!plan_ok(body, C, K1, N, itemsize, buf, out, tile, stages, table, width, smem, threads,
               blocks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = width / (int)itemsize;
  const int* si = static_cast<const int*>(srcs);
  const float* wi = static_cast<const float*>(weights);
  if (body == 0) {
    if (bf16)
      return (int)launch_register<__nv_bfloat16>(si, wi, K1,
                                                 static_cast<const __nv_bfloat16*>(buf),
                                                 static_cast<__nv_bfloat16*>(out), C, N, vec,
                                                 blocks, s);
    return (int)launch_register<float>(si, wi, K1, static_cast<const float*>(buf),
                                       static_cast<float*>(out), C, N, vec, blocks, s);
  }
  if (bf16)
    return (int)launch_gather<__nv_bfloat16>(si, wi, static_cast<const __nv_bfloat16*>(buf),
                                             static_cast<__nv_bfloat16*>(out), C, K1, N, tile,
                                             stages, table, width, smem, threads, blocks, s);
  return (int)launch_gather<float>(si, wi, static_cast<const float*>(buf),
                                   static_cast<float*>(out), C, K1, N, tile, stages, table,
                                   width, smem, threads, blocks, s);
}

const char* gather_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
