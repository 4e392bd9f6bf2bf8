// The Mamba2 SSD chunked scan (state-space duality), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:76
// ssd_scan (_ssd_kernel).  Computes what
// repro_torch/kernels/ref.py:ssd_chunked_ref computes, over chunks of Q
// rows, with x (B, S, H, P), dt (B, S, H) after softplus, A (H,) negative
// and single-group Bm, Cm (B, S, N):
//     cs_i    = Σ_{k<=i} dt_k·A_h                     (within the chunk)
//     y_i     = Σ_{j<=i} (C_i·B_j)·exp(cs_i − cs_j)·dt_j·x_j
//             + exp(cs_i)·(C_i · stateᵀ)               (state entering the chunk)
//     state'  = exp(cs_end)·state + Σ_j exp(cs_end − cs_j)·dt_j·x_j ⊗ B_j
// y in x's dtype; the state starts at zero, and the state after the last
// chunk is written to `final_state` (the TPU kernel drops it; a prefill
// needs it to prime the decode cache).
//
// Bound: operations.  Counting C·Bᵀ once per (b, chunk), the slice's shape
// (B 4, S 32768, H 32, P 64, N 128, Q 256) needs 210.7 GFLOP against about
// 2.3 GB moved: 1.277 ms at the split-TF32 rate (495/3 TFLOP/s).  Only the
// passing of the (P, N) state from chunk to chunk is serial, so the call is
// three launches on one stream, laid out as the plain version is:
//  1. chunk_state, one block per (b, chunk, two heads): a warp scans the
//     chunk's cumsum of dt·A for a head (kept in the `cs` scratch for the
//     later passes), and the block forms the chunk's own state
//     Σ_j exp(cs_end − cs_j)·dt_j·x_j ⊗ B_j, a (P × Q)·(Q × N) product,
//     into the `states` scratch (B, nc, H, P, N) f32.
//  2. state_pass, one thread per (b, h, p, n): walks the chunks in order,
//     running = exp(cs_end)·running + S_c, overwriting each chunk's slot
//     with the state entering that chunk; the last state goes to
//     `final_state`.  Bound by the scratch's bytes, read and written once.
//  3. chunk_scan, one block per (b, chunk, 64-row tile, head group): forms
//     the tile's rows of C·Bᵀ once (up to 256 columns in shared memory; a
//     longer chunk forms each 256-column window once per four heads) and
//     streams the group's heads past it four at a time, two warps a head:
//     y = exp(cs_i)·C·(entering state)ᵀ + (C·Bᵀ ∘ L_h)·(dt∘x).  L_h's mask
//     is applied before the exp, only in tiles that cross the diagonal,
//     and exp(cs_i − cs_j) is never factored (|cs| reaches about 6,000 at
//     Mamba2's ranges).
// Every product runs on the tensor cores (mma.sync m16n8k8 TF32) in split
// TF32: an f32 operand a = a_hi + a_lo, both rounded to TF32 as cvt.rna
// does, and a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with f32 accumulation,
// which keeps f32's accuracy (plain TF32 reads about 5e-4 of the result
// against a 1e-5 bar; tests/test_torch_ssd_split.py models both).  bf16
// data is exact in TF32 and has no low part, so for bf16 C·Bᵀ is one
// product.  Each term is issued for all of a warp's accumulators before the
// next, so the products in flight do not wait on one another.  Tiles of x,
// B and the states stream through shared memory two deep by cp.async (16
// bytes a copy where rows are aligned), so the next tile's loads overlap
// the current tile's products and hold no registers; the padding of every
// tile keeps the fragment loads free of bank conflicts.  x, Bm and Cm may
// be row-strided views (the conv output's slices): only their innermost
// dims must be dense.  Indices are 64-bit and every grid loops over its
// work, so any B·H is taken.
// Known gains left: wgmma with operands in shared memory (the fragments'
// loads and splits issue about as many instructions as the products), one
// stream across a block's heads, and more warps an SM for the chunk scan,
// which one block of 8 warps fills (its tiles take 178 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps in every kernel
constexpr int MAX_Q = 1024;   // longest chunk (its cumsum lives in shared memory)
constexpr int TM = 64;        // rows of a chunk-scan row tile
constexpr int GW = 256;       // widest window of C·Bᵀ columns kept in shared memory
constexpr int HS = 4;         // heads a chunk-scan block multiplies at once, two warps each
constexpr long long MAX_GRID = 0x7fffffffLL;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- split-TF32 products on the tensor cores (mma.sync m16n8k8) --------
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8, row-major) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k x n) b0
// (t, g), b1 (t + 4, g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).

// v rounded to TF32 as cvt.rna.tf32.f32 does for finite v: to nearest on the
// low 13 mantissa bits, ties away from zero (two integer operations, where
// cvt also handles infinities and NaN)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// 2^v, flushing results below f32's normal range to zero
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

constexpr float LOG2E = 1.4426950408889634f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// EXACT: the values are bf16 data, already TF32 numbers, with no low part
template <bool EXACT, int K>
__device__ __forceinline__ void split(const float (&v)[K], uint32_t (&hi)[K], uint32_t (&lo)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if constexpr (EXACT) {
      hi[e] = __float_as_uint(v[e]);
    } else {
      hi[e] = tf32(v[e]);
      lo[e] = tf32(v[e] - __uint_as_float(hi[e]));
    }
  }
}

template <bool EXACT>
__device__ __forceinline__ void make_a(FragA& f, float a0, float a1, float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
  split<EXACT>(v, f.hi, f.lo);
}

template <bool EXACT>
__device__ __forceinline__ void make_b(FragB& f, float b0, float b1) {
  const float v[2] = {b0, b1};
  split<EXACT>(v, f.hi, f.lo);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Term `term` of d += a·b in split TF32: 0 a_lo·b_hi, 1 a_hi·b_lo (the
// cross terms first), 2 a_hi·b_hi; an exact operand has no low part and no
// cross term of its own.  Callers issue one term for all their
// accumulators before the next, so that the products in flight do not wait
// on one another.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_term(int term, float (&d)[4], const FragA& a, const FragB& b) {
  if (term == 0) {
    if constexpr (!A_EXACT) mma(d, a.lo, b.hi);
  } else if (term == 1) {
    if constexpr (!B_EXACT) mma(d, a.hi, b.lo);
  } else {
    mma(d, a.hi, b.hi);
  }
}

// ---- tiles streamed by cp.async ----------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes (one f32, or two bf16) from `src` to shared `dst`, zeros when
// !valid; asynchronously, or by plain loads when `sync` (bf16 pairs that
// are not 4-byte aligned)
template <typename TT>
__device__ __forceinline__ void copy4(void* dst, const TT* src, bool valid, bool sync) {
  if (!sync) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
  } else {
    uint32_t v = 0;
    if (valid) {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
      v = uint32_t(h[0]) | (uint32_t(h[1]) << 16);
    }
    *reinterpret_cast<uint32_t*>(dst) = v;
  }
}

// 16 bytes from `src` to shared `dst`, zeros when !valid
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Starts the copy of a ROWS x W tile of TT into shared memory: row r from
// src + r·stride to dst + r·ld, zeros for rows r >= `valid`.  BYTES a copy:
// 16 when every row is 16-byte aligned, else 4.  Each thread keeps one
// column and walks the rows, so its addresses cost an add a row.
template <int BYTES, int W, int ROWS, typename TT>
__device__ __forceinline__ void copy_rows(TT* dst, int ld, const TT* src, long long stride,
                                          int valid, bool sync) {
  constexpr int EU = BYTES / (int)sizeof(TT);  // elements a copy
  constexpr int UPR = W / EU;                  // copies a row
  constexpr int RPP = THREADS / UPR;           // rows the block copies at once
  static_assert(UPR * EU == W && UPR <= THREADS && THREADS % UPR == 0, "row split");
  const int c = (threadIdx.x % UPR) * EU, r0 = threadIdx.x / UPR;
#pragma unroll
  for (int e = 0; e < (ROWS + RPP - 1) / RPP; ++e) {
    const int r = r0 + e * RPP;
    if (ROWS % RPP == 0 || r < ROWS) {
      const bool ok = r < valid;
      const TT* from = ok ? src + r * stride + c : src;
      if constexpr (BYTES == 16) {
        copy16(dst + r * ld + c, from, ok);
      } else {
        copy4(dst + r * ld + c, from, ok, sync);
      }
    }
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Two-deep stream of `n` tiles through shared memory: issue(q, buf) starts
// tile q's copies into `buf`, compute(q, buf) multiplies it; tile q + 1's
// copies are in flight while tile q is multiplied, and no register holds
// them.
template <class Issue, class Compute>
__device__ __forceinline__ void pipeline(int n, char* buf, int stage_bytes, Issue issue,
                                         Compute compute) {
  issue(0, buf);
  commit();
  for (int q = 0; q < n; ++q) {
    if (q + 1 < n) issue(q + 1, buf + ((q + 1) & 1) * stage_bytes);
    commit();  // an empty group past the last tile keeps the count uniform
    wait_all_but_newest();
    __syncthreads();  // tile q is in every thread's view
    compute(q, buf + (q & 1) * stage_bytes);
    __syncthreads();  // its buffer is free for tile q + 2
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
  float* states;  // (B, nc, H, P, N): chunk states, then the states entering each chunk
  float* cs;      // (B, nc, H, Q): the within-chunk cumsum of dt·A
  int B, H, S, Q, nc;
  long long x_sb, x_ss;  // x strides in elements: batch, step (head P, p 1)
  long long b_sb, b_ss;  // Bm strides: batch, step (n 1)
  long long c_sb, c_ss;  // Cm strides: batch, step (n 1)
  int vec16;             // every row of x and Bm 16-byte aligned: copy 16 bytes at a time
  int sync_pairs;        // bf16 x or Bm rows not 4-byte aligned: copy them by plain loads
  int ntiles, hpb, ngroups, gw;  // chunk scan: row tiles, heads a block, head groups, window
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---- 1. chunk states ----------------------------------------------------

template <typename TT, int P, int N>
struct StateShape {
  static constexpr int KT = (N + 2 * P > 256) ? 16 : 32;  // chunk rows a tile
  static constexpr int XLD = P + 8, BLD = N + 8;          // k-major rows, no bank conflicts
  // B tile [KT][BLD], then two heads' x tiles [KT][XLD], in TT
  static constexpr int STAGE = round_up(KT * (BLD + 2 * XLD) * (int)sizeof(TT), 16);
};

template <typename TT, int P, int N>
size_t state_smem(int Q) {
  return 4 * (size_t)round_up(Q, 32) * sizeof(float) + 2 * StateShape<TT, P, N>::STAGE;
}

// two blocks an SM where the accumulators leave room (up to 64 x 128 of them)
template <typename TT, int P, int N>
__global__ void __launch_bounds__(THREADS, P * N <= 64 * 128 ? 2 : 1)
    chunk_state_kernel(const Args a) {
  using Sh = StateShape<TT, P, N>;
  constexpr int KT = Sh::KT, XLD = Sh::XLD, BLD = Sh::BLD;
  constexpr int MT = P / 32, NT = N / 16;  // a warp's m-tiles (P/2 rows) and n-tiles (N/2 columns)
  constexpr bool BF = !std::is_same<TT, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, H = a.H, QW = round_up(Q, 32);
  float* wq = smem;             // [2][QW]: dt, then dt·exp(cs_end − cs); 0 past Q
  float* csq = wq + 2 * QW;     // [2][QW]: the cumsum
  char* tiles = reinterpret_cast<char*>(csq + 2 * QW);  // [2][STAGE]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int k = warp / 4, qm = (warp / 2) % 2, qn = warp % 2;  // head of the pair, quadrant
  const int npairs = (H + 1) / 2;
  const long long total = (long long)a.B * a.nc * npairs;
  const bool sync = BF && a.sync_pairs;

  for (long long bid = blockIdx.x; bid < total; bid += gridDim.x) {
    const int pair = (int)(bid % npairs);
    const long long bc = bid / npairs;  // b·nc + c
    const long long b = bc / a.nc, s0 = (bc % a.nc) * Q;
    const int h = 2 * pair + k;
    const bool live = h < H;
    const TT* xb = static_cast<const TT*>(a.x) + b * a.x_sb + s0 * a.x_ss;
    const TT* Bb = static_cast<const TT*>(a.Bm) + b * a.b_sb + s0 * a.b_ss;

    __syncthreads();  // the last block's readers of wq are done
    for (int e = tid; e < 2 * QW; e += THREADS) {
      const int hh = 2 * pair + e / QW, i = e % QW;
      wq[e] = hh < H && i < Q ? a.dt[(b * a.S + s0 + i) * H + hh] : 0.f;
    }
    __syncthreads();
    if (warp < 2 && 2 * pair + warp < H) {  // one warp's inclusive scan of dt·A a head
      const int hh = 2 * pair + warp;
      const float Ah = a.A[hh];
      float* w = wq + warp * QW;
      float* cs = csq + warp * QW;
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? w[i] * Ah : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (i < Q) cs[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      // carry is cs[Q − 1]; each lane reads back only what it wrote
      float* csg = a.cs + (bc * H + hh) * Q;
      for (int i = lane; i < Q; i += 32) {
        csg[i] = cs[i];
        w[i] *= expf(carry - cs[i]);
      }
    }
    __syncthreads();

    // tile q: chunk rows [q·KT, q·KT + KT) of B, then of the two heads' x
    auto issue = [&](int q, char* buf) {
      TT* dst = reinterpret_cast<TT*>(buf);
      const int j0 = q * KT;
      const TT* xs = xb + j0 * a.x_ss + 2 * pair * P;
      const int hv = min(2, H - 2 * pair);  // heads of the pair that exist
      if (a.vec16) {
        copy_rows<16, N, KT>(dst, BLD, Bb + j0 * a.b_ss, a.b_ss, Q - j0, sync);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          copy_rows<16, P, KT>(dst + KT * BLD + kk * KT * XLD, XLD, xs + kk * P, a.x_ss,
                               kk < hv ? Q - j0 : 0, sync);
      } else {
        copy_rows<4, N, KT>(dst, BLD, Bb + j0 * a.b_ss, a.b_ss, Q - j0, sync);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          copy_rows<4, P, KT>(dst + KT * BLD + kk * KT * XLD, XLD, xs + kk * P, a.x_ss,
                              kk < hv ? Q - j0 : 0, sync);
      }
    };
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    // S[p][n] += Σ_j x[j][p]·w[j]·B[j][n]: A = (x·w)ᵀ (P x KT), B = B tile (KT x N)
    auto compute = [&](int q, const char* buf) {
      if (!live) return;
      const TT* Bs = reinterpret_cast<const TT*>(buf);
      const TT* Xs = Bs + KT * BLD + k * KT * XLD;
      const float* w = wq + k * QW + q * KT;
#pragma unroll 1
      for (int kk = 0; kk < KT; kk += 8) {
        FragB fb[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = qn * (N / 2) + nt * 8 + g;
          make_b<BF>(fb[nt], to_f32(Bs[(kk + t) * BLD + n]), to_f32(Bs[(kk + t + 4) * BLD + n]));
        }
        const float wa = w[kk + t], wb = w[kk + t + 4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int p = qm * (P / 2) + mt * 16 + g;
          FragA fa;
          make_a<false>(fa, to_f32(Xs[(kk + t) * XLD + p]) * wa,
                        to_f32(Xs[(kk + t) * XLD + p + 8]) * wa,
                        to_f32(Xs[(kk + t + 4) * XLD + p]) * wb,
                        to_f32(Xs[(kk + t + 4) * XLD + p + 8]) * wb);
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_term<false, BF>(term, acc[mt][nt], fa, fb[nt]);
        }
      }
    };
    pipeline((Q + KT - 1) / KT, tiles, Sh::STAGE, issue, compute);

    if (live) {
      float* out = a.states + (bc * H + h) * (long long)(P * N);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int p = qm * (P / 2) + mt * 16 + g, n = qn * (N / 2) + nt * 8 + 2 * t;
          store2(out + p * N + n, acc[mt][nt][0], acc[mt][nt][1]);
          store2(out + (p + 8) * N + n, acc[mt][nt][2], acc[mt][nt][3]);
        }
    }
  }
}

// ---- 2. state passing ---------------------------------------------------

__global__ void __launch_bounds__(THREADS) state_pass_kernel(const Args a, int PN) {
  constexpr int U = 16;  // chunks whose loads are issued together
  const long long total = (long long)a.B * a.H * PN;
  const long long slot = (long long)a.H * PN, cslot = (long long)a.H * a.Q;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long bh = e / PN, b = bh / a.H;
    const int h = (int)(bh % a.H), r = (int)(e % PN);
    float* sp = a.states + (b * a.nc * a.H + h) * PN + r;
    const float* cp = a.cs + (b * a.nc * a.H + h) * a.Q + (a.Q - 1);
    float run = 0.f;
    int c = 0;
    for (; c + U <= a.nc; c += U) {
      float s[U], d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = sp[(c + u) * slot];
        d[u] = cp[(c + u) * cslot];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sp[(c + u) * slot] = run;
        run = fmaf(expf(d[u]), run, s[u]);
      }
    }
    for (; c < a.nc; ++c) {
      const float s = sp[c * slot], d = cp[c * cslot];
      sp[c * slot] = run;
      run = fmaf(expf(d), run, s);
    }
    a.final_state[e] = run;
  }
}

// ---- 3. chunk scan ------------------------------------------------------

template <typename TT, int P, int N>
struct ScanShape {
  static constexpr int KT = 2048 / P;                    // x rows a tile (64, 32, 16)
  static constexpr int NK = N < 2048 / P ? N : 2048 / P;  // state columns a tile
  static constexpr int XLD = P + 8;                      // Xs[k][j][p] (TT), no bank conflicts
  static constexpr int PLD = NK + 4;                     // Ps[k][p][n] (f32), no bank conflicts
  static constexpr int CLD = N + 4;                      // Cs[i][n], Bt[j][n] (f32)
  static constexpr int XS = HS * KT * XLD * (int)sizeof(TT), PS = HS * P * PLD * 4;
  static constexpr int STAGE = round_up(XS > PS ? XS : PS, 16);
  static_assert(TM * CLD * 4 <= 2 * STAGE, "the B tile of C·Bᵀ fits the stream's buffers");
};

template <typename TT, int P, int N>
size_t scan_smem(int Q, int gw) {
  using Sh = ScanShape<TT, P, N>;
  return ((size_t)TM * Sh::CLD + (size_t)TM * (gw + 4) + 2 * (size_t)HS * round_up(Q, TM)) *
             sizeof(float) + 2 * Sh::STAGE;
}

template <typename TT, int P, int N>
__global__ void __launch_bounds__(THREADS, 1) chunk_scan_kernel(const Args a) {
  using Sh = ScanShape<TT, P, N>;
  constexpr int KT = Sh::KT, NK = Sh::NK, XLD = Sh::XLD, PLD = Sh::PLD, CLD = Sh::CLD;
  constexpr int MT = 2, NT = P / 8;  // a warp's 32 rows and P columns of one head
  constexpr bool BF = !std::is_same<TT, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, H = a.H, gw = a.gw, gld = a.gw + 4, QP = round_up(Q, TM);
  float* Cs = smem;              // [TM][CLD]  C rows of the tile
  float* Gs = Cs + TM * CLD;     // [TM][gld]  C·Bᵀ over the window's columns
  float* csS = Gs + TM * gld;    // [HS][QP]   cumsum of the four heads, 0 past the tile
  float* dS = csS + HS * QP;     // [HS][QP]   dt of the four heads, 0 past the tile
  char* tiles = reinterpret_cast<char*>(dS + HS * QP);  // [2][STAGE]; the B tile for C·Bᵀ
  float* Bt = reinterpret_cast<float*>(tiles);          // [TM][CLD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int k = warp / 2, R0 = 32 * (warp % 2);  // head slot, first row of the warp
  const long long total = (long long)a.B * a.nc * a.ngroups * a.ntiles;
  const bool sync = BF && a.sync_pairs;

  for (long long bid = blockIdx.x; bid < total; bid += gridDim.x) {
    const int it = a.ntiles - 1 - (int)(bid % a.ntiles);  // the longest rows first
    const long long rest = bid / a.ntiles;
    const int grp = (int)(rest % a.ngroups);
    const long long bc = rest / a.ngroups;  // b·nc + c
    const long long b = bc / a.nc, s0 = (bc % a.nc) * Q;
    const int i0 = it * TM, ni = min(TM, Q - i0), J = i0 + ni, JP = round_up(J, TM);
    const int h_lo = grp * a.hpb, h_hi = min(H, h_lo + a.hpb);
    const int nwin = (J + gw - 1) / gw;
    const TT* xb = static_cast<const TT*>(a.x) + b * a.x_sb + s0 * a.x_ss;
    const TT* Bb = static_cast<const TT*>(a.Bm) + b * a.b_sb + s0 * a.b_ss;
    const TT* Cb = static_cast<const TT*>(a.Cm) + b * a.c_sb + (s0 + i0) * a.c_ss;

    __syncthreads();  // the last block's readers of Cs and Gs are done
    for (int e = tid; e < TM * N; e += THREADS) {
      const int i = e / N, n = e % N;
      Cs[i * CLD + n] = i < ni ? to_f32(Cb[(long long)i * a.c_ss + n]) : 0.f;
    }

    // C·Bᵀ for the tile's rows over window w's columns [w0, w1), 64 at a time
    auto form_g = [&](int w) {
      const int w0 = w * gw, w1 = min(J, w0 + gw);
      const int r0 = 16 * (warp / 2), c0 = 32 * (warp % 2);  // the warp's 16 x 32 of 64 x 64
      for (int j0 = w0; j0 < w1; j0 += TM) {
        __syncthreads();  // Cs is written; the tiles' last readers are done
        for (int e = tid; e < TM * N; e += THREADS) {
          const int j = e / N, n = e % N;
          Bt[j * CLD + n] = j0 + j < Q ? to_f32(Bb[(long long)(j0 + j) * a.b_ss + n]) : 0.f;
        }
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
        for (int kk = 0; kk < N; kk += 8) {
          FragA fa;
          make_a<BF>(fa, Cs[(r0 + g) * CLD + kk + t], Cs[(r0 + g + 8) * CLD + kk + t],
                     Cs[(r0 + g) * CLD + kk + t + 4], Cs[(r0 + g + 8) * CLD + kk + t + 4]);
          FragB fb[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = c0 + nt * 8 + g;
            make_b<BF>(fb[nt], Bt[j * CLD + kk + t], Bt[j * CLD + kk + t + 4]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_term<BF, BF>(term, acc[nt], fa, fb[nt]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = j0 - w0 + c0 + nt * 8 + 2 * t;
          Gs[(r0 + g) * gld + col] = acc[nt][0];
          Gs[(r0 + g) * gld + col + 1] = acc[nt][1];
          Gs[(r0 + g + 8) * gld + col] = acc[nt][2];
          Gs[(r0 + g + 8) * gld + col + 1] = acc[nt][3];
        }
      }
      __syncthreads();  // Gs is complete and the tiles are free
    };
    if (nwin == 1) form_g(0);  // once for every head of the block

    for (int hs = h_lo; hs < h_hi; hs += HS) {
      const int h = hs + k;
      const bool live = h < h_hi && R0 < ni;

      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

      // inter-chunk term: C (tile rows x N) · stateᵀ (N x P), NK columns n a tile
      auto issue_p = [&](int q, char* buf) {
        if (q == 0) {  // with the first tile: the heads' cumsum and dt, 0 past the tile
          for (int e = tid; e < HS * JP; e += THREADS) {
            const int kk = e / JP, j = e % JP;
            const bool ok = hs + kk < h_hi && j < J;
            copy4(csS + kk * QP + j, ok ? a.cs + (bc * H + hs + kk) * Q + j : a.cs, ok, false);
          }
          for (int e = tid; e < HS * JP; e += THREADS) {
            const int kk = e % HS, j = e / HS;
            const bool ok = hs + kk < h_hi && j < J;
            copy4(dS + kk * QP + j, ok ? a.dt + (b * a.S + s0 + j) * H + hs + kk : a.dt, ok,
                  false);
          }
        }
        float* dst = reinterpret_cast<float*>(buf);
        const float* st = a.states + (bc * H + hs) * (long long)(P * N) + q * NK;
#pragma unroll
        for (int kk = 0; kk < HS; ++kk)
          copy_rows<16, NK, P>(dst + kk * P * PLD, PLD, st + kk * (long long)(P * N), N,
                               hs + kk < h_hi ? P : 0, false);
      };
      auto compute_p = [&](int q, const char* buf) {
        if (!live) return;
        const float* Ps = reinterpret_cast<const float*>(buf) + k * P * PLD;
        // two steps in flight where the registers allow it
#pragma unroll(P <= 64 ? 2 : 1)
        for (int kk = 0; kk < NK; kk += 8) {
          const int n = q * NK + kk + t;
          FragA fa[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = R0 + mt * 16 + g;
            make_a<BF>(fa[mt], Cs[r * CLD + n], Cs[(r + 8) * CLD + n], Cs[r * CLD + n + 4],
                       Cs[(r + 8) * CLD + n + 4]);
          }
#pragma unroll
          for (int n4 = 0; n4 < NT; n4 += 4) {  // four n-tiles at a time
            FragB fb[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int p = (n4 + v) * 8 + g;
              make_b<false>(fb[v], Ps[p * PLD + kk + t], Ps[p * PLD + kk + t + 4]);
            }
#pragma unroll
            for (int term = 0; term < 3; ++term)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                  mma_term<BF, false>(term, acc[mt][n4 + v], fa[mt], fb[v]);
          }
        }
      };
      pipeline(N / NK, tiles, Sh::STAGE, issue_p, compute_p);

      // times exp(cs_i), and each row's cs_i for the decays below
      float csi[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = R0 + mt * 16 + g + 8 * u;
          csi[mt][u] = csS[k * QP + i0 + r];
          const float e = r < ni ? expf(csi[mt][u]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[mt][nt][2 * u] *= e;
            acc[mt][nt][2 * u + 1] *= e;
          }
        }

      // intra-chunk term: (C·Bᵀ ∘ L_h) (tile rows x J) · (dt∘x) (J x P)
      for (int w = 0; w < nwin; ++w) {
        if (nwin > 1) form_g(w);
        const int w0 = w * gw, w1 = min(J, w0 + gw);
        auto issue_x = [&](int q, char* buf) {
          TT* dst = reinterpret_cast<TT*>(buf);
          const int j0 = w0 + q * KT;
          const TT* xs = xb + j0 * a.x_ss + hs * P;
#pragma unroll
          for (int kk = 0; kk < HS; ++kk) {
            const int rows = hs + kk < h_hi ? w1 - j0 : 0;
            if (a.vec16)
              copy_rows<16, P, KT>(dst + kk * KT * XLD, XLD, xs + kk * P, a.x_ss, rows, sync);
            else
              copy_rows<4, P, KT>(dst + kk * KT * XLD, XLD, xs + kk * P, a.x_ss, rows, sync);
          }
        };
        // one tile of columns; MASKED for a tile that crosses the diagonal
        // or the chunk's end, where entries are set to 0 before the exp
        auto multiply = [&](auto masked, int j0, const TT* Xs) {
          const float* cs = csS + k * QP + j0;
          const float* ds = dS + k * QP + j0;
#pragma unroll 1
          for (int kk = 0; kk < KT; kk += 8) {
            const float cj[2] = {cs[kk + t], cs[kk + t + 4]};
            const float dj[2] = {ds[kk + t], ds[kk + t + 4]};
            FragA fa[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int r = R0 + mt * 16 + g;
              float v[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int rr = r + 8 * (u & 1), jj = kk + t + 4 * (u >> 1);
                float d = csi[mt][u & 1] - cj[u >> 1];
                if constexpr (decltype(masked)::value)
                  d = j0 + jj <= i0 + rr && rr < ni ? d : -CUDART_INF_F;
                v[u] = Gs[rr * gld + j0 - w0 + jj] * exp2_ftz(d * LOG2E) * dj[u >> 1];
              }
              make_a<false>(fa[mt], v[0], v[1], v[2], v[3]);
            }
#pragma unroll
            for (int n4 = 0; n4 < NT; n4 += 4) {  // four n-tiles at a time
              FragB fb[4];
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const int p = (n4 + v) * 8 + g;
                make_b<false>(fb[v], to_f32(Xs[(kk + t) * XLD + p]),
                              to_f32(Xs[(kk + t + 4) * XLD + p]));
              }
#pragma unroll
              for (int term = 0; term < 3; ++term)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                  for (int v = 0; v < 4; ++v)
                    mma_term<false, false>(term, acc[mt][n4 + v], fa[mt], fb[v]);
            }
          }
        };
        auto compute_x = [&](int q, const char* buf) {
          const int j0 = w0 + q * KT;
          // skip a warp whose rows all lie left of the tile's columns
          if (!live || j0 > i0 + R0 + 31) return;
          const TT* Xs = reinterpret_cast<const TT*>(buf) + k * KT * XLD;
          if (j0 + KT - 1 <= i0 + R0 && R0 + 32 <= ni)
            multiply(Flag<false>{}, j0, Xs);
          else
            multiply(Flag<true>{}, j0, Xs);
        };
        pipeline((w1 - w0 + KT - 1) / KT, tiles, Sh::STAGE, issue_x, compute_x);
      }

      if (live) {
        TT* yb = static_cast<TT*>(a.y) + ((b * a.S + s0 + i0) * H + h) * (long long)P;
        const long long y_ss = (long long)H * P;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = R0 + mt * 16 + g, p = nt * 8 + 2 * t;
            if (r < ni) store2(yb + r * y_ss + p, acc[mt][nt][0], acc[mt][nt][1]);
            if (r + 8 < ni) store2(yb + (r + 8) * y_ss + p, acc[mt][nt][2], acc[mt][nt][3]);
          }
      }
    }
  }
}

// ---- launches -----------------------------------------------------------

// the kernels loop over blocks past the grid's limit
int grid_of(long long blocks) { return (int)(blocks < MAX_GRID ? blocks : MAX_GRID); }

template <typename TT, int P, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t s1 = state_smem<TT, P, N>(a.Q), s3 = scan_smem<TT, P, N>(a.Q, a.gw);
  cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<TT, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_scan_kernel<TT, P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.B * a.nc * ((a.H + 1) / 2);
  chunk_state_kernel<TT, P, N><<<grid_of(pairs), THREADS, s1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long entries = (long long)a.B * a.H * P * N;
  state_pass_kernel<<<grid_of((entries + THREADS - 1) / THREADS), THREADS, 0, stream>>>(a, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long tiles = (long long)a.B * a.nc * a.ngroups * a.ntiles;
  chunk_scan_kernel<TT, P, N><<<grid_of(tiles), THREADS, s3, stream>>>(a);
  return cudaGetLastError();
}

template <typename TT, int P>
cudaError_t dispatch_n(const Args& a, int N, cudaStream_t s) {
  switch (N) {
    case 32: return launch<TT, P, 32>(a, s);
    case 64: return launch<TT, P, 64>(a, s);
    case 128: return launch<TT, P, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TT>
cudaError_t dispatch_p(const Args& a, int P, int N, cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<TT, 32>(a, N, s);
    case 64: return dispatch_n<TT, 64>(a, N, s);
    case 128: return dispatch_n<TT, 128>(a, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the three passes on `stream` and returns the cudaError_t of the
// launches (0 when all were accepted; cudaErrorInvalidValue for P or N
// outside {32, 64, 128}, a chunk Q outside [1, 1024] or not dividing S,
// B·H outside [1, 2^31 − 1] or a null pointer).  x (B, S, H, P) with its
// (H, P) dims dense and strides x_sb, x_ss (elements) over batch and step;
// Bm and Cm (B, S, N) with n dense and strides over batch and step; all
// three bf16 when `bf16`, else f32.  dt (B, S, H) and A (H,) dense f32; y a
// dense (B, S, H, P) buffer of x's dtype; final_state a dense (B, H, P, N)
// f32 buffer; states (B, S/Q, H, P, N) and cs (B, S/Q, H, Q) f32 scratch.
int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             void* y, void* final_state, void* states, void* cs, int B, int S, int H, int P,
             int N, int Q, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
             long long c_sb, long long c_ss, int bf16, void* stream) {
  if (B < 1 || H < 1 || S < 1 || Q < 1 || Q > MAX_Q || S % Q != 0 ||
      (long long)B * H > MAX_GRID || final_state == nullptr || states == nullptr ||
      cs == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = static_cast<const float*>(dt); a.A = static_cast<const float*>(A);
  a.Bm = Bm; a.Cm = Cm; a.y = y;
  a.final_state = static_cast<float*>(final_state);
  a.states = static_cast<float*>(states);
  a.cs = static_cast<float*>(cs);
  a.B = B; a.H = H; a.S = S; a.Q = Q; a.nc = S / Q;
  a.x_sb = x_sb; a.x_ss = x_ss; a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  // x and Bm tiles are copied 16 bytes at a time when every row is 16-byte
  // aligned, else 4 (bf16 pairs), by plain loads where a pair is not aligned
  auto rows_aligned = [&](int bytes) {
    const long long e = bytes / (bf16 ? 2 : 4);
    return reinterpret_cast<uintptr_t>(x) % bytes == 0 && x_sb % e == 0 && x_ss % e == 0 &&
           reinterpret_cast<uintptr_t>(Bm) % bytes == 0 && b_sb % e == 0 && b_ss % e == 0;
  };
  a.vec16 = rows_aligned(16);
  a.sync_pairs = bf16 && !rows_aligned(4);
  // the window of C·Bᵀ columns: the chunk rounded up to whole tiles, at most GW
  a.ntiles = (Q + TM - 1) / TM;
  a.gw = a.ntiles * TM < GW ? a.ntiles * TM : GW;
  // heads a chunk-scan block: all of them, unless the (b, chunk, tile)
  // blocks alone would leave SMs idle; a multiple of HS
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long base = (long long)B * a.nc * a.ntiles;
  const long long sets = (H + HS - 1) / HS;
  long long groups = (2LL * sms + base - 1) / base;
  groups = groups < 1 ? 1 : (groups > sets ? sets : groups);
  a.hpb = (int)((sets + groups - 1) / groups) * HS;
  a.ngroups = (H + a.hpb - 1) / a.hpb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)dispatch_p<__nv_bfloat16>(a, P, N, s);
  return (int)dispatch_p<float>(a, P, N, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
