// Single-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py:flash_decode
// (_decode_kernel).  Computes what repro_torch/kernels/ref.py:flash_decode_ref
// computes: out[b, hq] = softmax over the valid cache entries of
// q[b, hq] . k[b, :, hq / G] * hd^-0.5, applied to v, where an entry idx is
// valid when idx <= pos[b] and idx < L.  Rows with pos[b] < 0 are empty
// serving slots and come out exactly 0.
//
// Bound: bytes.  The kernel must stream the valid prefix of the K and V
// caches once: 2 * sum_b min(pos_b + 1, L) * Hkv * hd * sizeof(kv) bytes at
// 3.35 TB/s (H100 SXM), against 4 * sum_b min(pos_b + 1, L) * Hq * hd f32
// operations, far below the card's f32 rate.  So the design keeps many
// loads in flight and reads each cache byte once:
//   * one thread block per (b, kv head, L split).  The wrapper cuts L into
//     spans of at most 512 rows, and finer when B * Hkv * splits blocks
//     would leave SMs idle, so that a long row is read by many SMs at once;
//     a second pass combines the splits' (m, l, acc) partials.  A split
//     that is entirely masked carries m = -1e30, l = 0, acc = 0 and drops
//     out of the combine;
//   * inside a block each warp streams its own cache rows, U rows at a time,
//     with no block-wide barrier in the loop: lane i holds elements
//     [i*D, i*D + D) of a row (D = hd / 32), loaded as one vector, so a
//     warp reads a row as one contiguous transaction.  At most 128
//     registers a thread let 4 blocks share an SM, for more loads in
//     flight;
//   * the G = Hq / Hkv query heads of the group share every K/V load: each
//     warp keeps all G heads' running max, sum and accumulator in registers
//     and scores each loaded row against every head;
//   * the cache is read in place through its strides in (B, L, Hkv, hd)
//     layout; rows past pos[b] are never loaded;
//   * at the end the block's warps merge their softmax states through
//     shared memory.
// Accumulation is f32 throughout; q and the caches may each be f32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int U = 2;  // cache rows a warp loads before it computes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The widest load word for a run of BYTES bytes (at most 16).
template <int BYTES> struct Word { using type = uint4; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };

// D consecutive elements at p, as floats, loaded in words of up to 16
// bytes (the wrapper checked that every row start is aligned to them).
template <typename T, int D>
__device__ __forceinline__ void load_run(const T* __restrict__ p, float (&out)[D]) {
  constexpr int BYTES = D * (int)sizeof(T);
  using W = typename Word<(BYTES < 16 ? BYTES : 16)>::type;
  constexpr int NW = BYTES / (int)sizeof(W);
  W w[NW];
#pragma unroll
  for (int c = 0; c < NW; ++c) w[c] = reinterpret_cast<const W*>(p)[c];
  const T* t = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int i = 0; i < D; ++i) out[i] = to_f32(t[i]);
}

template <typename TQ, typename TKV, int D, int GM>
__global__ void __launch_bounds__(THREADS, 4) flash_decode_split(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int* __restrict__ pos, TQ* __restrict__ out, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int Hq, int Hkv, int L,
    int chunk, float scale, long long sk_b, long long sk_l, long long sk_h, long long sv_b,
    long long sv_l, long long sv_h) {
  constexpr int HD = 32 * D;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ __align__(16) float q_sh[GM * HD];
  __shared__ float m_sh[NWARPS][GM];
  __shared__ float l_sh[NWARPS][GM];
  __shared__ float acc_sh[NWARPS][GM * HD];

  const long long row0 = (long long)b * Hq + (long long)h * G;  // first query head
  for (int e = tid; e < G * HD; e += THREADS) q_sh[e] = to_f32(q[row0 * HD + e]);
  __syncthreads();

  const int pb = pos[b];
  const int valid_end = pb < 0 ? 0 : (pb >= L ? L : pb + 1);
  const int l0 = split * chunk;
  const int l1 = min(l0 + chunk, valid_end);

  float m[GM], l[GM], acc[GM][D];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[g][i] = 0.f;
  }

  const TKV* kb = k + b * sk_b + h * sk_h + lane * D;
  const TKV* vb = v + b * sv_b + h * sv_h + lane * D;
  for (int t = l0 + warp * U; t < l1; t += NWARPS * U) {
    float kf[U][D], vf[U][D];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < l1) {
        load_run<TKV, D>(kb + (long long)(t + u) * sk_l, kf[u]);
        load_run<TKV, D>(vb + (long long)(t + u) * sv_l, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    // scores of the U rows against every head, summed across the warp
    float s[U][GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float qg[D];
      load_run<float, D>(q_sh + g * HD + lane * D, qg);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) dot = fmaf(qg[i], kf[u][i], dot);
        s[u][g] = dot;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
        }
      }
    }
    // online softmax over the U rows; an invalid row adds exactly nothing
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = t + u < l1 ? s[u][g] * scale : NEG_INF;
        mx = fmaxf(mx, s[u][g]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = t + u < l1 ? expf(s[u][g] - m_new) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][i], a);
        acc[g][i] = a;
      }
    }
  }

  // merge the warps' softmax states
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      m_sh[warp][g] = m[g];
      l_sh[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) acc_sh[warp][g * HD + lane * D + i] = acc[g][i];
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, m_sh[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(m_sh[w][g] - mx);
      lsum += l_sh[w][g] * c;
      a += acc_sh[w][e] * c;
    }
    if (n_split == 1) {
      out[row0 * HD + e] = from_f32<TQ>(a / fmaxf(lsum, 1e-30f));
    } else {
      const long long prow = (row0 + g) * n_split + split;
      acc_part[prow * HD + (e - g * HD)] = a;
      if (e - g * HD == 0) {
        m_part[prow] = mx;
        l_part[prow] = lsum;
      }
    }
  }
}

// One block per (b, query head): merge the splits' partials.
template <typename TQ>
__global__ void __launch_bounds__(THREADS) flash_decode_combine(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, TQ* __restrict__ out, int n_split, int hd) {
  const long long row = blockIdx.x;
  const float* m = m_part + row * n_split;
  const float* l = l_part + row * n_split;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m[s]);
  float lsum = 0.f;
  for (int s = 0; s < n_split; ++s) lsum += l[s] * expf(m[s] - mx);
  const float denom = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s)
      acc += acc_part[(row * n_split + s) * hd + d] * expf(m[s] - mx);
    out[row * hd + d] = from_f32<TQ>(acc / denom);
  }
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* out;
  float *m_part, *l_part, *acc_part;
  int B, Hq, Hkv, hd, L, n_split, chunk;
  float scale;
  long long sk_b, sk_l, sk_h, sv_b, sv_l, sv_h;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GM>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.n_split, a.Hkv, a.B);
  flash_decode_split<TQ, TKV, D, GM><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.pos, static_cast<TQ*>(a.out), a.m_part, a.l_part,
      a.acc_part, a.Hq, a.Hkv, a.L, a.chunk, a.scale, a.sk_b, a.sk_l, a.sk_h, a.sv_b, a.sv_l,
      a.sv_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  flash_decode_combine<TQ><<<(unsigned)a.B * a.Hq, THREADS, 0, a.stream>>>(
      a.m_part, a.l_part, a.acc_part, static_cast<TQ*>(a.out), a.n_split, a.hd);
  return cudaGetLastError();
}

// GM: the register budget of query heads per group, the least of 2, 4, 8,
// 16 that holds G; GM * D <= 64 keeps the accumulators in registers.
template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Args& a) {
  const int G = a.Hq / a.Hkv;
  if (G <= 2) return launch<TQ, TKV, D, 2>(a);
  if (G <= 4) return launch<TQ, TKV, D, 4>(a);
  if (G <= 8) return launch<TQ, TKV, D, 8>(a);
  if (G <= 16) return launch<TQ, TKV, D, 16>(a);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const Args& a) {
  switch (a.hd) {
    case 32: return launch_g<TQ, TKV, 1>(a);
    case 64: return launch_g<TQ, TKV, 2>(a);
    case 128: return launch_g<TQ, TKV, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launches (0 when
// they were accepted; cudaErrorInvalidValue for a head_dim other than 32,
// 64, 128 or a group wider than 16 query heads).  Pointers are
// device pointers; q and out are contiguous (B, Hq, hd); k and v are
// (B, L, Hkv, hd) with unit stride on the last axis and the given element
// strides on the others, every row start aligned to min(hd / 32 elements,
// 16 bytes); pos is (B,) int32.  The partial buffers hold
// B * Hq * n_split (m, l) and B * Hq * n_split * hd (acc) floats and are
// unused when n_split == 1.  `chunk` is the L span of one split.
int flash_decode(const void* q, const void* k, const void* v, const int* pos, void* out,
                 float* m_part, float* l_part, float* acc_part, int B, int Hq, int Hkv,
                 int hd, int L, int n_split, int chunk, float scale, long long sk_b,
                 long long sk_l, long long sk_h, long long sv_b, long long sv_l,
                 long long sv_h, int q_bf16, int kv_bf16, void* stream) {
  const Args a{q,    k,    v,    pos,  out,  m_part, l_part, acc_part,
               B,    Hq,   Hkv,  hd,   L,    n_split, chunk, scale,
               sk_b, sk_l, sk_h, sv_b, sv_l, sv_h,   static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (q_bf16 && kv_bf16) err = launch_d<__nv_bfloat16, __nv_bfloat16>(a);
  else if (q_bf16) err = launch_d<__nv_bfloat16, float>(a);
  else if (kv_bf16) err = launch_d<float, __nv_bfloat16>(a);
  else err = launch_d<float, float>(a);
  return (int)err;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
