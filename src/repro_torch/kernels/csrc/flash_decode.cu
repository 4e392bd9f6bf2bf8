// Single-token GQA flash-decode attention for Hopper (sm_90a), one launch.
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
// operations: at G = 3 about 1.5 (f32) or 6 (bf16) operations a cache byte,
// far below the card's crossover.  So the design is about bytes in flight,
// launches and instruction issue:
//
//   * Work cut over the live rows, on the device.  The grid has n_blocks
//     blocks, a multiple of Hkv fixed by the host from B, Hkv, L and the SM
//     count (blocks_per_sm an SM, and at least one a (b, kv head)); the
//     host never reads pos.  Each block reads pos and works out its span.  With
//     n_b = min(pos_b + 1, L) (0 for pos_b < 0) the valid rows of row b,
//     T = sum_b n_b, U the live rows (n_b > 0), S = n_blocks / Hkv,
//     N = min(S, T), E = N - U and D = T - U, block i takes KV head
//     h = i % Hkv and span index q = i / Hkv < N; live row b owns the span
//     indices [C(b), C(b + 1)) with
//         C(b) = live rows before b + floor(E * R(b) / D)   (0 when D = 0),
//         R(b) = sum over the live rows before b of (n - 1),
//     and span j of the c = C(b + 1) - C(b) spans of a row of n entries holds
//     its entries [floor(j * n / c), floor((j + 1) * n / c)).  Every live row
//     gets at least one span and at most n, so no span is empty, a long row
//     gets proportionally more spans, an empty slot gets none, and blocks
//     with work are the first min(n_blocks, Hkv * T).  The Hkv heads of a
//     span are neighbouring blocks, so at any time they read neighbouring
//     bytes of the same cache rows.  Blocks i < B also write the zeros of an
//     empty row b = i.  The same formula is mirrored in Python by
//     kernels/flash_decode.py:partition and checked by the CPU tests.
//   * One launch.  A (b, h) of one span writes its output directly.
//     Otherwise each span writes its (m, l, acc) partial to the slot of its
//     block (span j of (b, h) in slot (C(b) + j) * Hkv + h) and takes a
//     ticket on the (b, h) counter, an increment that wraps to 0 on the last
//     ticket (so no memset launch is needed before the next call); the block
//     that draws the last ticket merges the partials, each output element
//     summed over the spans in span order j = 0 .. c - 1, so the result is
//     the same bits on every run.
//   * Bytes in flight.  K and V tiles of TR = 32 rows stream through a ring
//     of STAGES >= 3 stages in shared memory, loaded with 16-byte cp.async
//     (narrower copies when a row start is not 16-byte aligned); the copy of
//     tile t + STAGES - 1 is issued before tile t is scored.  At head_dim
//     128 an f32 ring is 3 stages of 32 KB (two blocks an SM) and a bf16
//     ring 3 stages of 16 KB (four blocks an SM, for more warps), so each SM
//     keeps 128 KB of cache in flight either way.  The cache is read in
//     place through its strides.
//   * Few cross-lane reductions.  Scoring gives one cache row to each lane
//     (rows padded by 16 bytes in shared memory, so the lanes' 16-byte reads
//     do not conflict) and one query head to each warp (heads g, g + 4, ...),
//     so a tile costs each head one warp max and one warp sum, and the
//     running max is rescaled once a tile.  The weighted sum gives each lane
//     hd / 32 columns of V and each warp every fourth row of the tile, for
//     all G heads of the group at once.
//   * Partition in one warp (a warp scan over B, no block barriers), q
//     loaded while the first tiles are in flight, and a merge that copies a
//     chunk of up to JMAX partials into the ring in one round of cp.async.
// Accumulation is f32 throughout; q and the caches may each be f32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int TR = 32;               // cache rows a tile: one a lane when scoring
constexpr int NACC = 4;              // independent partial sums of a score
constexpr int JMAX = 64;             // most spans merged from one shared-memory load
constexpr float NEG_INF = -1e30f;

struct Params {
  const void *q, *k, *v;
  const int* pos;
  void* out;
  float* part;    // n_blocks slots of part_stride(G, hd) floats: acc, m, l
  int* ticket;    // B * Hkv counters, 0 between calls
  int B, Hq, Hkv, L, n_blocks, copy_bytes;
  float scale;
  long long sk_b, sk_l, sk_h, sv_b, sv_l, sv_h;
};

// Blocks an SM: four for a bf16 cache and groups of up to 4 query heads
// (more warps an SM for the same bytes in flight), else two (an f32 tile is
// twice the bytes; wider groups need the registers);
// kernels/flash_decode.py:blocks_per_sm.
template <typename T, int GM> constexpr int blocks_per_sm() { return sizeof(T) == 2 && GM <= 4 ? 4 : 2; }

// Tile geometry of a cache row of HD elements of T: a ring of at least
// three stages in about 192 KB / BPS of shared memory.
template <typename T, int HD, int BPS>
struct Geo {
  static constexpr int RB = HD * (int)sizeof(T);    // bytes of a cache row
  static constexpr int PITCH = RB + 16;             // padded shared-memory row
  static constexpr int CPR = RB / 16;               // 16-byte chunks a row
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int TILE = TR * PITCH;           // one K or V tile
  static constexpr int FIT = 192 * 1024 / BPS / (2 * TILE);
  static constexpr int STAGES = FIT < 3 ? 3 : (FIT > 8 ? 8 : FIT);
  static constexpr int RING = STAGES * 2 * TILE;
  static_assert(TR * CPR >= THREADS && (TR * CPR) % THREADS == 0, "tile copy");
};

// Floats of a span's partial: G * hd of acc, G of m, G of l, padded to 16 bytes.
__host__ __device__ constexpr int part_stride(int G, int hd) { return (G * (hd + 2) + 3) / 4 * 4; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The widest load word for a run of BYTES bytes (at most 16).
template <int BYTES> struct Word { using type = uint4; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };

// N consecutive elements of T at p (aligned to their bytes, at most 16), as
// floats.  A bf16 is the high half of the f32 with the same bits.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const void* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  using W = typename Word<(BYTES < 16 ? BYTES : 16)>::type;
  constexpr int NW = BYTES / (int)sizeof(W);
  W w[NW];
#pragma unroll
  for (int c = 0; c < NW; ++c) w[c] = reinterpret_cast<const W*>(p)[c];
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = f[i];
  } else if constexpr (N == 1) {
    out[0] = __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(w) << 16);
  } else {
    const unsigned* u = reinterpret_cast<const unsigned*>(w);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      out[2 * i] = __uint_as_float(u[i] << 16);
      out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

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
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from global src to shared dst, in copies of w bytes (the widest
// that every row start allows); 2-byte rows go by plain loads and stores.
__device__ __forceinline__ void copy16(void* dst, const void* src, int w) {
  if (w >= 4) {
    for (int o = 0; o < 16; o += w)
      cp_async(static_cast<char*>(dst) + o, static_cast<const char*>(src) + o, w);
  } else {
#pragma unroll
    for (int o = 0; o < 8; ++o)
      static_cast<unsigned short*>(dst)[o] = static_cast<const unsigned short*>(src)[o];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int valid_rows(int p, int L) { return p < 0 ? 0 : (p >= L ? L : p + 1); }

// The block's span: rows [r0, r1) of KV head h of row b; the unit's spans
// sit in the partial slots first, first + Hkv, ... (count of them).
struct Span {
  int b, h, r0, r1, first, count;
};

// Finds block i's span by the formula in the header, in warp 0 (the
// other warps wait at the block's next barrier); writes *out and returns
// whether the block has a span.
__device__ bool find_span(const Params& p, int i, Span* out) {
  const int lane = threadIdx.x & 31;
  long long T = 0, U = 0;
  for (int b = lane; b < p.B; b += 32) {
    const int n = valid_rows(p.pos[b], p.L);
    T += n;
    U += n > 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T += __shfl_xor_sync(0xffffffffu, T, o);
    U += __shfl_xor_sync(0xffffffffu, U, o);
  }
  const long long S = p.n_blocks / p.Hkv;
  const long long N = T < S ? T : S;
  const int q = i / p.Hkv, h = i % p.Hkv;
  if (q >= N) return false;
  const long long E = N - U, D = T - U;
  auto C = [&](long long live_before, long long r) { return live_before + (D > 0 ? E * r / D : 0); };
  long long carry_m = 0, carry_live = 0;
  for (int base = 0; base < p.B; base += 32) {
    const int b = base + lane;
    const int n = b < p.B ? valid_rows(p.pos[b], p.L) : 0;
    const long long m = n > 0 ? n - 1 : 0, lv = n > 0;
    long long inc_m = m, inc_l = lv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long ym = __shfl_up_sync(0xffffffffu, inc_m, o);
      const long long yl = __shfl_up_sync(0xffffffffu, inc_l, o);
      if (lane >= o) {
        inc_m += ym;
        inc_l += yl;
      }
    }
    const long long c0 = C(carry_live + inc_l - lv, carry_m + inc_m - m);
    const long long c1 = C(carry_live + inc_l, carry_m + inc_m);
    const bool mine = n > 0 && c0 <= q && q < c1;
    if (mine) {
      const long long j = q - c0, c = c1 - c0;
      *out = Span{b, h, (int)(j * n / c), (int)((j + 1) * n / c), (int)c0 * p.Hkv + h, (int)c};
    }
    if (__any_sync(0xffffffffu, mine)) return true;
    carry_m += __shfl_sync(0xffffffffu, inc_m, 31);
    carry_live += __shfl_sync(0xffffffffu, inc_l, 31);
  }
  return false;   // not reached: every q < N lies in a live row's spans
}

template <typename TQ, typename TKV, int D, int GM>
struct Layout {
  static constexpr int HD = 32 * D;
  static constexpr int BPS = blocks_per_sm<TKV, GM>();
  using G_ = Geo<TKV, HD, BPS>;
  static constexpr int Q_OFF = G_::RING;                    // q of the group, f32
  static constexpr int P_OFF = Q_OFF + GM * HD * 4;         // p of a tile, [TR][GM]
  static constexpr int S_OFF = P_OFF + TR * GM * 4;         // alpha, m, l, m*, scale, L
  static constexpr int INT_OFF = S_OFF + 6 * GM * 4;
  static constexpr int BYTES = INT_OFF + 16 + (int)sizeof(Span);
  // after the loop the ring holds the warps' accumulators; when merging,
  // partials from its start and the weights [GM][JMAX] at its end
  static constexpr int W_OFF = G_::RING - GM * JMAX * 4;
  static_assert(NWARPS * GM * HD * 4 <= W_OFF, "epilogue fits the ring");
  static_assert(part_stride(GM, HD) * 4 <= W_OFF, "one partial fits the ring");
};

template <typename TQ, typename TKV, int D, int GM>
__global__ void __launch_bounds__(THREADS, (blocks_per_sm<TKV, GM>())) flash_decode_kernel(const Params p) {
  using Lay = Layout<TQ, TKV, D, GM>;
  using Gm = typename Lay::G_;
  constexpr int HD = Lay::HD;
  constexpr int HPW = (GM + NWARPS - 1) / NWARPS;   // heads a warp scores
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_sh = reinterpret_cast<float*>(smem + Lay::Q_OFF);
  float* p_sh = reinterpret_cast<float*>(smem + Lay::P_OFF);
  float* alpha_sh = reinterpret_cast<float*>(smem + Lay::S_OFF);
  float* m_sh = alpha_sh + GM;
  float* l_sh = m_sh + GM;
  float* mstar_sh = l_sh + GM;
  float* scale_sh = mstar_sh + GM;
  float* lsum_sh = scale_sh + GM;
  float* w_sh = reinterpret_cast<float*>(smem + Lay::W_OFF);
  int* flag_sh = reinterpret_cast<int*>(smem + Lay::INT_OFF);
  Span* span_sh = reinterpret_cast<Span*>(smem + Lay::INT_OFF + 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x;
  const int G = p.Hq / p.Hkv;

  if (i < p.B && p.pos[i] < 0) {   // an empty slot: its row is exactly 0
    TQ* o = static_cast<TQ*>(p.out) + (long long)i * p.Hq * HD;
    for (int e = tid; e < p.Hq * HD; e += THREADS) o[e] = from_f32<TQ>(0.f);
  }
  if (warp == 0) {
    const bool has = find_span(p, i, span_sh);
    if (lane == 0) flag_sh[0] = has;
  }
  __syncthreads();
  if (!flag_sh[0]) return;
  const Span s = *span_sh;
  const long long row0 = (long long)s.b * p.Hq + (long long)s.h * G;   // first query head
  const char* kb = static_cast<const char*>(p.k) + (s.b * p.sk_b + s.h * p.sk_h) * (long long)sizeof(TKV);
  const char* vb = static_cast<const char*>(p.v) + (s.b * p.sv_b + s.h * p.sv_h) * (long long)sizeof(TKV);
  const long long k_row = p.sk_l * (long long)sizeof(TKV), v_row = p.sv_l * (long long)sizeof(TKV);
  const int n_tiles = (s.r1 - s.r0 + TR - 1) / TR;

  // tile t into ring stage t % STAGES: chunk c of the tile is row c / CPR,
  // 16 bytes at column c % CPR; rows past the span are left unloaded
  auto issue = [&](int t) {
    if (t < n_tiles) {
      unsigned char* kd = smem + (t % Gm::STAGES) * 2 * Gm::TILE;
      unsigned char* vd = kd + Gm::TILE;
      const int r = s.r0 + t * TR;
      const int rows = min(TR, s.r1 - r);
#pragma unroll
      for (int c = tid; c < TR * Gm::CPR; c += THREADS) {
        const int row = c / Gm::CPR, col = c % Gm::CPR;
        if (row < rows) {
          copy16(kd + row * Gm::PITCH + col * 16, kb + (r + row) * k_row + col * 16, p.copy_bytes);
          copy16(vd + row * Gm::PITCH + col * 16, vb + (r + row) * v_row + col * 16, p.copy_bytes);
        }
      }
    }
    cp_commit();
  };

  float m_run[HPW], l_run[HPW];
  float acc[GM][D];
#pragma unroll
  for (int kk = 0; kk < HPW; ++kk) {
    m_run[kk] = NEG_INF;
    l_run[kk] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[g][d] = 0.f;

#pragma unroll
  for (int t = 0; t < Gm::STAGES - 1; ++t) issue(t);
  {                                   // q while the first tiles are in flight
    constexpr int QPER = (GM * HD + THREADS - 1) / THREADS;
    const TQ* q = static_cast<const TQ*>(p.q) + row0 * HD;
    float x[QPER];
#pragma unroll
    for (int k = 0; k < QPER; ++k) {
      const int e = tid + k * THREADS;
      x[k] = e < G * HD ? to_f32(q[e]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < QPER; ++k)
      if (tid + k * THREADS < GM * HD) q_sh[tid + k * THREADS] = x[k];
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<Gm::STAGES - 2>();
    __syncthreads();                  // tile t landed; stage (t - 1) is free
    issue(t + Gm::STAGES - 1);
    const unsigned char* ks = smem + (t % Gm::STAGES) * 2 * Gm::TILE;
    const unsigned char* vs = ks + Gm::TILE;
    const int rows = min(TR, s.r1 - s.r0 - t * TR);

    // scores: lane = row, warp = head (g = warp, warp + 4, ...)
    if (warp < G) {
      float sc[HPW][NACC];            // NACC independent sums a head
#pragma unroll
      for (int kk = 0; kk < HPW; ++kk)
#pragma unroll
        for (int a = 0; a < NACC; ++a) sc[kk][a] = 0.f;
      if (lane < rows) {
        const unsigned char* kr = ks + lane * Gm::PITCH;
#pragma unroll
        for (int c = 0; c < Gm::CPR; ++c) {
          float kf[Gm::EPC];
          load_vals<TKV, Gm::EPC>(kr + c * 16, kf);
#pragma unroll
          for (int kk = 0; kk < HPW; ++kk) {
            const int g = warp + kk * NWARPS;
            if (g < G) {
              float qf[Gm::EPC];
              load_vals<float, Gm::EPC>(q_sh + g * HD + c * Gm::EPC, qf);
#pragma unroll
              for (int e = 0; e < Gm::EPC; ++e)
                sc[kk][(c * Gm::EPC + e) % NACC] = fmaf(qf[e], kf[e], sc[kk][(c * Gm::EPC + e) % NACC]);
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < HPW; ++kk) {
        const int g = warp + kk * NWARPS;
        if (g < G) {
          float dot = sc[kk][0];
#pragma unroll
          for (int a = 1; a < NACC; ++a) dot += sc[kk][a];
          const float x = lane < rows ? dot * p.scale : NEG_INF;
          const float m_new = fmaxf(m_run[kk], warp_max(x));
          const float pr = lane < rows ? expf(x - m_new) : 0.f;
          const float alpha = expf(m_run[kk] - m_new);
          l_run[kk] = l_run[kk] * alpha + warp_sum(pr);
          m_run[kk] = m_new;
          p_sh[lane * GM + g] = pr;
          if (lane == 0) alpha_sh[g] = alpha;
        }
      }
    }
    __syncthreads();                  // p and alpha of tile t are in place

    // weighted sum: warp = every fourth row, lane = hd / 32 columns, all heads
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float a = alpha_sh[g];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[g][d] *= a;
      }
    }
    for (int r = warp; r < rows; r += NWARPS) {
      float vf[D], pr[GM];
      load_vals<TKV, D>(vs + r * Gm::PITCH + lane * D * (int)sizeof(TKV), vf);
      load_vals<float, GM>(p_sh + r * GM, pr);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
#pragma unroll
          for (int d = 0; d < D; ++d) acc[g][d] = fmaf(pr[g], vf[d], acc[g][d]);
        }
      }
    }
  }

  // the warps' accumulators into the ring, summed in warp order
  cp_wait<0>();
  __syncthreads();
  float* acc_sh = reinterpret_cast<float*>(smem);   // [NWARPS][G][HD]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc_sh[(warp * G + g) * HD + lane * D + d] = acc[g][d];
    }
  }
  if (warp < G && lane == 0) {
#pragma unroll
    for (int kk = 0; kk < HPW; ++kk) {
      const int g = warp + kk * NWARPS;
      if (g < G) {
        m_sh[g] = m_run[kk];
        l_sh[g] = l_run[kk];
      }
    }
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out) + row0 * HD;
  if (s.count == 1) {
    for (int e = tid; e < G * HD; e += THREADS) {
      float a = acc_sh[e];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) a += acc_sh[w * G * HD + e];
      out[e] = from_f32<TQ>(a / l_sh[e / HD]);
    }
    return;
  }

  // a span of several: write the partial, take a ticket; the last merges
  const int stride = part_stride(G, HD);
  float* mine = p.part + (long long)i * stride;
  for (int e = tid; e < G * HD; e += THREADS) {
    float a = acc_sh[e];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) a += acc_sh[w * G * HD + e];
    mine[e] = a;
  }
  if (tid < G) {
    mine[G * HD + tid] = m_sh[tid];
    mine[G * HD + G + tid] = l_sh[tid];
  }
  __syncthreads();
  // the ticket: one acq_rel increment by thread 0 after the barrier
  // releases the block's partial (the fence is cumulative over the
  // barrier) and acquires the others'; it wraps to 0 on the last ticket,
  // so the counter is ready for the next call on this stream
  if (tid == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(p.ticket + (long long)s.b * p.Hkv + s.h);
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(ticket), "r"((unsigned)s.count - 1) : "memory");
    flag_sh[1] = old == (unsigned)s.count - 1;
  }
  __syncthreads();
  if (!flag_sh[1]) return;

  // span j's partial is at slot first + j * Hkv.  Up to jcap spans at a
  // time are loaded into the ring in one round of 16-byte loads; the
  // merge keeps a running max m* per head and rescales once a chunk.  Each
  // accumulator element, and each head's l (elements G * HD + g), is
  // summed over the spans in span order.
  const float* first = p.part + (long long)s.first * stride;
  const long long jstride = (long long)p.Hkv * stride;
  const int jcap = min(JMAX, Lay::W_OFF / (stride * 4));
  float* part_sh = reinterpret_cast<float*>(smem);    // [jcap][stride]
  constexpr int PER = (GM * HD + GM + THREADS - 1) / THREADS;
  float a[PER];
  int head[PER], off[PER];              // element k's head and offset in a partial
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS;
    a[k] = 0.f;
    head[k] = e < G * HD ? e / HD : min(e - G * HD, G - 1);
    off[k] = e < G * HD ? e : e + G;    // acc, or l past the m's
  }
  if (tid < G) mstar_sh[tid] = NEG_INF;
  for (int j0 = 0; j0 < s.count; j0 += jcap) {
    const int nj = min(jcap, s.count - j0);
    for (int j = 0; j < nj; ++j)       // all in flight at once
      for (int c = tid * 4; c < stride; c += THREADS * 4)
        cp_async(part_sh + j * stride + c, first + (j0 + j) * jstride + c, 16);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (tid < G) {
      float mx = mstar_sh[tid];
      for (int j = 0; j < nj; ++j) mx = fmaxf(mx, part_sh[j * stride + G * HD + tid]);
      scale_sh[tid] = expf(mstar_sh[tid] - mx);
      mstar_sh[tid] = mx;
    }
    __syncthreads();
    for (int e = tid; e < G * nj; e += THREADS) {
      const int g = e / nj, j = e % nj;
      w_sh[g * JMAX + j] = expf(part_sh[j * stride + G * HD + g] - mstar_sh[g]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (tid + k * THREADS < G * HD + G) a[k] *= scale_sh[head[k]];
    for (int j = 0; j < nj; ++j) {     // the thread's elements side by side
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (tid + k * THREADS < G * HD + G)
          a[k] = fmaf(w_sh[head[k] * JMAX + j], part_sh[j * stride + off[k]], a[k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS;
    if (e >= G * HD && e < G * HD + G) lsum_sh[e - G * HD] = a[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS;
    if (e < G * HD) out[e] = from_f32<TQ>(a[k] / lsum_sh[e / HD]);
  }
}

template <typename TQ, typename TKV, int D, int GM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<TQ, TKV, D, GM>;
  constexpr int smem = Layout<TQ, TKV, D, GM>::BYTES;
  static bool configured[64] = {};    // per device: the attributes are set once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  kernel<<<p.n_blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// GM: the register budget of query heads per group, the least of 2, 4, 8,
// 16 that holds G; GM * D <= 64 keeps the accumulators in registers.
template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  if (G <= 2) return launch<TQ, TKV, D, 2>(p, stream);
  if (G <= 4) return launch<TQ, TKV, D, 4>(p, stream);
  if (G <= 8) return launch<TQ, TKV, D, 8>(p, stream);
  if (G <= 16) return launch<TQ, TKV, D, 16>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch_d(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_g<TQ, TKV, 1>(p, stream);
    case 64: return launch_g<TQ, TKV, 2>(p, stream);
    case 128: return launch_g<TQ, TKV, 4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t (0 when it was accepted;
// cudaErrorInvalidValue for a head_dim other than 32, 64, 128 or a group
// wider than 16 query heads).  Pointers are device pointers; q and out are
// contiguous (B, Hq, hd); k and v are (B, L, Hkv, hd) with unit stride on
// the last axis and the given element strides on the others, every row
// start aligned to `copy_bytes` (16, 8, 4 or 2); pos is (B,) int32.
// n_blocks is a multiple of Hkv and at least B * Hkv
// (kernels/flash_decode.py:grid_blocks).  `part` holds n_blocks *
// part_stride(G, hd) floats from a 16-byte boundary; `ticket` holds
// B * Hkv ints that are 0 before the call and are 0 again after it.
int flash_decode(const void* q, const void* k, const void* v, const int* pos, void* out,
                 float* part, int* ticket, int B, int Hq, int Hkv, int hd, int L,
                 int n_blocks, int copy_bytes, float scale, long long sk_b, long long sk_l,
                 long long sk_h, long long sv_b, long long sv_l, long long sv_h, int q_bf16,
                 int kv_bf16, void* stream) {
  const Params p{q,        k,          v,     pos,  out,  part, ticket, B,    Hq,
                 Hkv,      L,          n_blocks, copy_bytes, scale, sk_b, sk_l, sk_h,
                 sv_b,     sv_l,       sv_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16) err = launch_d<__nv_bfloat16, __nv_bfloat16>(p, hd, st);
  else if (q_bf16) err = launch_d<__nv_bfloat16, float>(p, hd, st);
  else if (kv_bf16) err = launch_d<float, __nv_bfloat16>(p, hd, st);
  else err = launch_d<float, float>(p, hd, st);
  return (int)err;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
