// The Mamba2 SSD chunked scan (state-space duality), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:76
// ssd_scan (_ssd_kernel).  Computes what
// repro_torch/kernels/ref.py:ssd_chunked_ref computes, per (batch b,
// head h), over chunks of Q rows, with x (B, S, H, P), dt (B, S, H) after
// softplus, A (H,) negative and single-group Bm, Cm (B, S, N):
//     cs_i    = Σ_{k<=i} dt_k·A                       (within the chunk)
//     y_i     = Σ_{j<=i} (C_i·B_j)·exp(cs_i − cs_j)·dt_j·x_j
//             + exp(cs_i)·(C_i · stateᵀ)               (state entering the chunk)
//     state'  = exp(cs_end)·state + Σ_j exp(cs_end − cs_j)·dt_j·x_j ⊗ B_j
// in f32 (FMA on the CUDA cores, no tensor cores, so no TF32), y in x's
// dtype.  The state starts at zero; the state after the last chunk is
// written to `final_state` (the TPU kernel drops it; a prefill needs it to
// prime the decode cache).
//
// Bound: operations.  At the slice's shape (B 4, S 32768, H 32, P 64,
// N 128, Q 256) the dual form does about 21 MFLOP per (b, h, chunk) for
// 2.3 GB moved in all, far above the card's f32 ridge.  Design, simple
// first:
// - one block of 256 threads per (b, h), walking the chunks in order with
//   the (P, N) state in shared memory (kept transposed, n-major, so a
//   thread reads its P/16 columns of one n as one vector);
// - a chunk is done in row tiles of T = 64: the C tile, then for each
//   column tile j0 <= i0 the B tile and the dt·x tile are staged in
//   shared memory (B and C transposed, rows padded by 4 floats), the
//   64 x 64 score tile C·Bᵀ ∘ decay is formed (a 4 x 4 block per
//   thread) and stored transposed, and y gains scores · (dt·x); tiles
//   above the diagonal are skipped, the diagonal one is masked before
//   the exp;
// - after the chunk's rows, the state update streams the chunk's B and
//   dt·x·exp(cs_end − cs) tiles again, each thread owning N/16 x P/16
//   entries of the state in registers;
// - the chunk's cumsum is one warp's shuffle scan.
// x, Bm and Cm may be row-strided views (the conv output's slices): only
// their innermost dims must be dense.  Indices are 64-bit.  Known gains
// left for later: splitting the chunk states from the inter-chunk pass to
// fill more than B·H SMs, wgmma for the products, and C·Bᵀ shared by the
// H heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;        // rows (and columns) of a tile
constexpr int TP = T + 4;    // padded row of a transposed tile
constexpr int MAX_Q = 1024;  // longest chunk (cs and dt live in shared memory)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// V consecutive floats from 16-byte (V % 4 == 0) or 8-byte (V == 2)
// aligned shared memory.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      out[k] = f.x; out[k + 1] = f.y; out[k + 2] = f.z; out[k + 3] = f.w;
    }
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x; out[1] = f.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = p[k];
  }
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* final_state;
  int H, S, Q;
  long long x_sb, x_ss;  // x strides in elements: batch, step (head P, p 1)
  long long b_sb, b_ss;  // Bm strides: batch, step (n 1)
  long long c_sb, c_ss;  // Cm strides: batch, step (n 1)
};

template <int N>
constexpr size_t smem_floats(int P, int Q) {
  return (size_t)N * P + 2 * (size_t)N * TP + (size_t)T * P + (size_t)T * TP + 2 * (size_t)Q;
}

template <typename TT, int P, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(const Args a) {
  constexpr int PV = P / 16;  // columns p of y and of the state a thread holds
  constexpr int NV = N / 16;  // rows n of the state a thread holds
  extern __shared__ __align__(16) float smem[];
  float* stT = smem;          // [N][P]   the state, transposed
  float* Ct = stT + N * P;    // [N][TP]  C tile, transposed
  float* Bt = Ct + N * TP;    // [N][TP]  B tile, transposed
  float* xs = Bt + N * TP;    // [T][P]   dt·x tile (times the decay to the end in the update)
  float* St = xs + T * P;     // [T][TP]  score tile, transposed: St[j][i]
  float* cs = St + T * TP;    // [Q]      inclusive cumsum of dt·A over the chunk
  float* dts = cs + a.Q;      // [Q]      dt over the chunk

  const int H = a.H, Q = a.Q;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float Ah = a.A[h];
  const TT* xb = static_cast<const TT*>(a.x) + b * a.x_sb + (long long)h * P;
  const TT* Bb = static_cast<const TT*>(a.Bm) + b * a.b_sb;
  const TT* Cb = static_cast<const TT*>(a.Cm) + b * a.c_sb;
  const float* dtb = a.dt + (long long)b * a.S * H + h;
  TT* yb = static_cast<TT*>(a.y) + ((long long)b * a.S * H + h) * P;
  const long long y_ss = (long long)H * P;
  const long long st_off = (long long)bh * P * N;

  for (int e = tid; e < N * P; e += THREADS) stT[e] = 0.f;

  // stage rows [s, s + nr) of the chunk: B transposed into Bt, and dt·x
  // times `decay(j)` into xs; rows past nr are zero
  auto stage_b_x = [&](long long s, int j0, int nr, bool to_end, float cs_end) {
    for (int e = tid; e < T * N; e += THREADS) {
      const int j = e / N, n = e % N;
      Bt[n * TP + j] = j < nr ? to_f32(Bb[(s + j) * a.b_ss + n]) : 0.f;
    }
    for (int e = tid; e < T * P; e += THREADS) {
      const int j = e / P, p = e % P;
      float v = 0.f;
      if (j < nr) {
        v = to_f32(xb[(s + j) * a.x_ss + p]) * dts[j0 + j];
        if (to_end) v *= expf(cs_end - cs[j0 + j]);
      }
      xs[j * P + p] = v;
    }
  };

  const int nchunks = a.S / Q;
  for (int c = 0; c < nchunks; ++c) {
    const long long s0 = (long long)c * Q;
    __syncthreads();  // the last chunk is done with cs, dts and the state
    for (int i = tid; i < Q; i += THREADS) dts[i] = dtb[(s0 + i) * H];
    __syncthreads();
    if (tid < 32) {  // one warp's inclusive scan of dt·A
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? dts[i] * Ah : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (i < Q) cs[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cs_end = cs[Q - 1];

    // ---- y, one row tile at a time; rows i0 + ty*4 + r, columns tx*PV + v
    for (int i0 = 0; i0 < Q; i0 += T) {
      const int ni = min(T, Q - i0);
      for (int e = tid; e < T * N; e += THREADS) {
        const int i = e / N, n = e % N;
        Ct[n * TP + i] = i < ni ? to_f32(Cb[(s0 + i0 + i) * a.c_ss + n]) : 0.f;
      }
      __syncthreads();

      float acc[4][PV];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int v = 0; v < PV; ++v) acc[r][v] = 0.f;
      // inter-chunk term: C_i · stateᵀ, then times exp(cs_i)
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PV];
        load_vec<4>(Ct + n * TP + ty * 4, cv);
        load_vec<PV>(stT + n * P + tx * PV, sv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int v = 0; v < PV; ++v) acc[r][v] = fmaf(cv[r], sv[v], acc[r][v]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        const float e = i < ni ? expf(cs[i0 + i]) : 0.f;
#pragma unroll
        for (int v = 0; v < PV; ++v) acc[r][v] *= e;
      }

      // intra-chunk term over the column tiles at or left of the diagonal
      for (int j0 = 0; j0 <= i0; j0 += T) {
        const int nj = min(T, Q - j0);
        __syncthreads();  // the last tile's readers of Bt, xs and St are done
        stage_b_x(s0 + j0, j0, nj, false, 0.f);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
          load_vec<4>(Ct + n * TP + ty * 4, cv);
          load_vec<4>(Bt + n * TP + tx * 4, bv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] = fmaf(cv[r], bv[q], sc[r][q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx * 4 + q;
          float s4[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ty * 4 + r;
            // masked before the exp: above the diagonal, or off the chunk
            s4[r] = (j0 + j <= i0 + i && i < ni && j < nj)
                        ? sc[r][q] * expf(cs[i0 + i] - cs[j0 + j])
                        : 0.f;
          }
          *reinterpret_cast<float4*>(St + j * TP + ty * 4) = make_float4(s4[0], s4[1], s4[2], s4[3]);
        }
        __syncthreads();
        for (int j = 0; j < nj; ++j) {
          float sv[4], xv[PV];
          load_vec<4>(St + j * TP + ty * 4, sv);
          load_vec<PV>(xs + j * P + tx * PV, xv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int v = 0; v < PV; ++v) acc[r][v] = fmaf(sv[r], xv[v], acc[r][v]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (i < ni) {
          TT* row = yb + (s0 + i0 + i) * y_ss + tx * PV;
#pragma unroll
          for (int v = 0; v < PV; ++v) store(row + v, acc[r][v]);
        }
      }
      __syncthreads();  // every thread is done with Ct
    }

    // ---- the state update; this thread owns rows n = ty + 16k and
    // columns p = tx*PV + v of the transposed state
    float sacc[NV][PV];
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int v = 0; v < PV; ++v) sacc[k][v] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += T) {
      const int nj = min(T, Q - j0);
      __syncthreads();
      stage_b_x(s0 + j0, j0, nj, true, cs_end);
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        float xv[PV];
        load_vec<PV>(xs + j * P + tx * PV, xv);
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const float bv = Bt[(ty + 16 * k) * TP + j];
#pragma unroll
          for (int v = 0; v < PV; ++v) sacc[k][v] = fmaf(bv, xv[v], sacc[k][v]);
        }
      }
    }
    // every read of the old state in this chunk came before the
    // __syncthreads above, and each entry has one owner
    const float dec = expf(cs_end);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float* row = stT + (ty + 16 * k) * P + tx * PV;
#pragma unroll
      for (int v = 0; v < PV; ++v) row[v] = fmaf(dec, row[v], sacc[k][v]);
    }
  }

  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS) {
    const int p = e / N, n = e % N;
    a.final_state[st_off + e] = stT[n * P + p];
  }
}

template <typename TT, int P, int N>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t bytes = smem_floats<N>(P, a.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<TT, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<TT, P, N><<<blocks, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TT, int P>
cudaError_t dispatch_n(const Args& a, int N, int blocks, cudaStream_t s) {
  switch (N) {
    case 32: return launch<TT, P, 32>(a, blocks, s);
    case 64: return launch<TT, P, 64>(a, blocks, s);
    case 128: return launch<TT, P, 128>(a, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TT>
cudaError_t dispatch_p(const Args& a, int P, int N, int blocks, cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<TT, 32>(a, N, blocks, s);
    case 64: return dispatch_n<TT, 64>(a, N, blocks, s);
    case 128: return dispatch_n<TT, 128>(a, N, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 when it
// was accepted; cudaErrorInvalidValue for P or N outside {32, 64, 128}, a
// chunk Q outside [1, 1024] or not dividing S, B·H outside [1, 2^31 − 1]
// or a null final_state).  x (B, S, H, P) with its (H, P) dims dense and
// strides x_sb, x_ss (elements) over batch and step; Bm and Cm (B, S, N)
// with n dense and strides over batch and step; all three bf16 when
// `bf16`, else f32.  dt (B, S, H) and A (H,) dense f32; y a dense (B, S, H, P) buffer of
// x's dtype; final_state a dense (B, H, P, N) f32 buffer.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             void* y, void* final_state, int B, int S, int H, int P, int N,
             int Q, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
             long long c_sb, long long c_ss, int bf16, void* stream) {
  const long long blocks = (long long)B * H;
  if (B < 1 || H < 1 || S < 1 || Q < 1 || Q > MAX_Q || S % Q != 0 || blocks > 0x7fffffffLL ||
      final_state == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = static_cast<const float*>(dt); a.A = static_cast<const float*>(A);
  a.Bm = Bm; a.Cm = Cm; a.y = y;
  a.final_state = static_cast<float*>(final_state);
  a.H = H; a.S = S; a.Q = Q;
  a.x_sb = x_sb; a.x_ss = x_ss; a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)dispatch_p<__nv_bfloat16>(a, P, N, (int)blocks, s);
  return (int)dispatch_p<float>(a, P, N, (int)blocks, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
