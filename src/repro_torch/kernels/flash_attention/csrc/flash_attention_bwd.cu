// Flash-attention backward for training, sm_90a.
//
// The reference trains attention through layers.blockwise_attention, a
// jax.custom_vjp whose backward, _flash_bwd (src/repro/models/layers.py),
// recomputes each block's scores from the saved (q, k, v, out, lse) instead
// of storing the probabilities.  The Pallas kernel
// src/repro/kernels/flash_attention/kernel.py implements that contract's
// forward; this file is the backward's counterpart.  Contract: q, dout,
// dq (B, S, Hq, D) and k, v, dk, dv (B, Skv, Hkv, D), contiguous in the JAX
// layout; GQA by head index (kv head = h / G, multi-query included);
// causal or bidirectional; a sliding window (key j seen from query i
// where j > i - window, the reference's mask) with the global-layer
// bypass; Skv apart from S where the mask is bidirectional without a
// window (cross-attention: query tiles, rows, lse and delta run over S,
// key tiles, the last key tile's mask and dK/dV over Skv); lengths that
// are not a multiple of the tile; head dims up to 192 whose
// rows are whole 16-byte chunks (192: MLA's q/k head dim, V zero-padded to
// it); fp32 or bf16.  The wrapper raises on a logit cap and key padding.
//
// The window (hymba's sliding layers): each block's tile loop runs over
// only the tiles that hold a pair inside the window (the dK/dV block's
// query tiles end where its last key leaves every query's window, the dQ
// block's key tiles begin where its first query's window begins), and the
// tiles that the window's edge cuts are masked like the diagonal's.  With
// no window (or a global layer) the loops and masks are as before, and
// the results bitwise so.
//
// Arithmetic, as the reference's: s = scale * q.k in fp32; p = exp(s -
// lse); dv += p^T . dout with p rounded to v's dtype; dp = dout . v^T;
// ds = p (dp - delta) with the fp32 p, rounded to k's dtype; dq += ds . k
// and dk += ds^T . q, both times scale; sums in fp32, each output rounded
// once.  delta = rowsum(dout * out) in fp32, as the reference's.
//
// Bound on the H100: operations.  The five products (S recomputed from the
// saved lse, dP, dV, dK and dQ) are 10 D flops per attended (query, key)
// pair; this design recomputes S and dP once more in the dQ launch, 14 D
// in all, on the tensor cores for bf16.
//
// Two launches (three with the fold below), no atomics, so that the result
// is bitwise repeatable: a sum across blocks in atomics would take its
// order from the schedule.
//
// - dQ, first: one block per (batch * query head, 64-query tile), looping
//   over the key tiles at or below the diagonal.  It computes delta for its
//   rows from dout and out and writes it for the dK/dV launch (from the
//   wrapper it took four stock launches: two casts, a product and a sum).
// - dK/dV: one block per (batch, kv head, 64-key tile, head split).  It
//   loops over its split's query heads in order and, for each, over the
//   query tiles at or below the diagonal, so the GQA fold of the group's
//   dK and dV stays in registers.  With n_split > 1 (the wrapper's
//   bwd_plan: too few (batch, kv head, key tile) blocks to fill the card,
//   as under multi-query attention) each split writes fp32 partials to a
//   scratch of (n_split, B, Skv, Hkv, D) for each of dK and dV, and a third
//   launch, flash_bwd_fold, sums them in split order and rounds once.
//
// bf16 (flash_bwd_*_mma): FlashAttention-2's backward with mma.sync
// m16n8k16, bf16 in and fp32 sums, built from the forward's patterns
// (flash_attention.cu).  Four warps, each owning 16 rows of the block's
// fixed tile (keys in dK/dV, queries in dQ).
//
// - The dK/dV block loads its K and V tiles once; the query side (Q, dO,
//   and that tile's lse and delta) streams through a two-stage cp.async
//   ring.  Per step of kQS queries each warp forms S^T = K.Q^T and dP^T =
//   V.dO^T (K and V rows as A operands by ldmatrix, Q and dO rows as B,
//   not transposed), then P^T = exp2(S^T scale log2 e - lse log2 e), the
//   forward's exp2 form with lse in natural units, and dS^T = P^T (dP^T -
//   delta), lse and delta indexing the fragment's columns.  P^T and dS^T
//   are rounded to bf16 in registers and fed straight in as the A operands
//   of dV += P^T.dO and dK += dS^T.Q (the m16n8 accumulator layout is the
//   m16n8k16 A layout), dO and Q through ldmatrix .trans.
// - The dQ block holds its Q and dO tiles; K and V stream through the
//   ring.  S = Q.K^T and dP = dO.V^T, dS = P (dP - delta), dQ += dS.K with
//   K through ldmatrix .trans.
// - Registers: at D 128 the dK and dV accumulators are 128 fp32 a lane.
//   The A fragments of the fixed tiles are read from shared memory at each
//   k-step rather than held, and the dK/dV step is 32 queries there (64 at
//   smaller head dims), so that S^T and dP^T add 32 fp32.
// - Shared rows are padded by 16 bytes (a pitch of DP + 8 bf16), so that
//   ldmatrix reads are free of bank conflicts; head dims are zero-padded to
//   16, 32, 64 or 128 (192 in the eight-warp kernels of head dims above
//   128, whose design is described at them).  Only tiles that cross the
//   diagonal or S are masked,
//   by a second copy of the tile body.  The heaviest causal tiles start
//   first: key tile 0 in dK/dV (every query tile sees it), the last query
//   tile in dQ.
//
// fp32 (flash_bwd_*_simt): on the CUDA cores, since TF32 tensor cores
// would change fp32 numerics, as the forward keeps fp32.  Blocks of 256
// threads, the same grids; tiles sit in shared memory as fp32 rows padded
// by one word, each thread holds a 4 x 4 tile of the scores and a
// 4 x (D / 16) tile of its accumulators (at D 192 the dK/dV block's shared
// memory is 231,424 bytes, just under the 232,448 a block may have).
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kT = 64;      // query or key rows per tile, both dtypes

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;      // the forward's output, (B, S, Hq, D)
  const float* lse;     // (B, S, Hq)
  float* delta;         // (B, S, Hq): written by the dQ launch
  void* dq;
  void* dk;
  void* dv;
  float* partial;       // (2, n_split, B, Skv, Hkv, D) fp32 where n_split > 1
  int B, S, Skv, Hq, Hkv, D, causal, n_split;   // S queries, Skv keys
  float scale;
  int window;           // 0: none (or a global layer)
};

// the end of the query tiles that see key tile k_lo: a query at most
// window - 1 past a key sees it
__device__ inline int window_qt_end(const BwdArgs& a, int k_lo, int nqt) {
  return a.window ? min(nqt, (k_lo + kT + a.window - 2) / kT + 1) : nqt;
}

// the first key tile that query tile q_lo sees
__device__ inline int window_kt_begin(const BwdArgs& a, int q_lo) {
  return a.window ? max(0, q_lo - a.window + 1) / kT : 0;
}

// whether the tile pair holds a (query, key) pair outside the window
__device__ inline bool window_cuts(const BwdArgs& a, int q_lo, int k_lo) {
  return a.window && k_lo + a.window <= q_lo + kT - 1;
}

__device__ inline bool in_window(const BwdArgs& a, int qpos, int kpos) {
  return (a.window == 0) | (kpos > qpos - a.window);
}

template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Two adjacent columns of dK and of dV (row `row` of kv head hk of batch
// b, columns d and d + 1) into split `split`'s fp32 partials.
__device__ inline void store_partial(const BwdArgs& a, int split, int b,
                                     int hk, int row, int d, float k0,
                                     float k1, float v0, float v1) {
  const long long n = static_cast<long long>(a.B) * a.Skv * a.Hkv * a.D;
  float* pk = a.partial + split * n +
              ((static_cast<long long>(b) * a.Skv + row) * a.Hkv + hk) * a.D + d;
  *reinterpret_cast<float2*>(pk) = make_float2(k0, k1);
  *reinterpret_cast<float2*>(pk + a.n_split * n) = make_float2(v0, v1);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;
constexpr int kR = 4;       // tile rows per thread
constexpr int kC = 4;       // score columns per thread: 16 lanes x 4
constexpr int kPP = kT + 1; // pitch of a score tile in shared memory

// kT rows of D values from `src` (row r at src + r * stride) into shared
// memory as fp32 with pitch D + 1; rows at or past `valid` are zero.
__device__ inline void load_tile(float* dst, const float* src,
                                 long long stride, int valid, int D,
                                 int tid) {
  const int P = D + 1;
  for (int c = tid; c < kT * D; c += kSimtThreads) {
    const int r = c / D;
    const int d = c - r * D;
    dst[r * P + d] = r < valid ? src[r * stride + d] : 0.f;
  }
}

// s[i][c] = sum_d A[ty * kR + i][d] B[tx + 16 c][d] and the same for the
// pair (A2, B2) into s2: the scores and dP of one tile pair.
__device__ inline void tile_products(float (&s)[kR][kC], float (&s2)[kR][kC],
                                     const float* A, const float* Bm,
                                     const float* A2, const float* B2,
                                     int D, int ty, int tx) {
  const int P = D + 1;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) s[i][c] = s2[i][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[kR], a2[kR], bb[kC], b2[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      a[i] = A[(ty * kR + i) * P + d];
      a2[i] = A2[(ty * kR + i) * P + d];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      bb[c] = Bm[(tx + 16 * c) * P + d];
      b2[c] = B2[(tx + 16 * c) * P + d];
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s[i][c] = fmaf(a[i], bb[c], s[i][c]);
        s2[i][c] = fmaf(a2[i], b2[c], s2[i][c]);
      }
  }
}

// dK and dV of one 64-key tile of one kv head, summed over its split's
// query heads.
template <int kJ>   // head-dim columns per thread: D <= 16 kJ
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dkdv_simt(BwdArgs a) {
  const int split = blockIdx.x % a.n_split;
  const int bk = blockIdx.x / a.n_split;
  const int b = bk / a.Hkv;
  const int hk = bk - b * a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int gs = G / a.n_split;
  const int k_lo = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int D = a.D;
  const int P = D + 1;

  extern __shared__ float smem_bwd[];
  float* Ks = smem_bwd;
  float* Vs = Ks + kT * P;
  float* Qs = Vs + kT * P;
  float* Os = Qs + kT * P;          // dout
  float* Ps = Os + kT * P;          // p, [key][query]
  float* Ss = Ps + kT * kPP;        // ds, [key][query]
  float* Ls = Ss + kT * kPP;        // lse of the tile's queries
  float* Dl = Ls + kT;              // delta

  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long q_row = static_cast<long long>(a.Hq) * D;
  const int kvalid = min(kT, a.Skv - k_lo);
  const long long kv_off = (static_cast<long long>(b) * a.Skv + k_lo) * kv_row + hk * D;
  load_tile(Ks, static_cast<const float*>(a.k) + kv_off, kv_row, kvalid, D, tid);
  load_tile(Vs, static_cast<const float*>(a.v) + kv_off, kv_row, kvalid, D, tid);

  float dk[kR][kJ], dv[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nqt = (a.S + kT - 1) / kT;
  const int qt0 = a.causal ? blockIdx.y : 0;    // tiles at or below the diagonal
  const int qt_end = window_qt_end(a, k_lo, nqt);
  for (int g = split * gs; g < (split + 1) * gs; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < qt_end; ++qt) {
      const int q_lo = qt * kT;
      const int qvalid = min(kT, a.S - q_lo);
      const long long q_off = (static_cast<long long>(b) * a.S + q_lo) * q_row + h * D;
      __syncthreads();   // the previous tile's readers are done
      load_tile(Qs, static_cast<const float*>(a.q) + q_off, q_row, qvalid, D, tid);
      load_tile(Os, static_cast<const float*>(a.dout) + q_off, q_row, qvalid, D, tid);
      if (tid < kT) {
        const long long r = (static_cast<long long>(b) * a.S + q_lo + tid) * a.Hq + h;
        Ls[tid] = tid < qvalid ? a.lse[r] : 0.f;
        Dl[tid] = tid < qvalid ? a.delta[r] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are keys, columns queries
      float s[kR][kC], dp[kR][kC];
      tile_products(s, dp, Ks, Qs, Vs, Os, D, ty, tx);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kr = ty * kR + i;
        const int kpos = k_lo + kr;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int qc = tx + 16 * c;
          const int qpos = q_lo + qc;
          const bool ok = kr < kvalid && qc < qvalid &&
                          (!a.causal || kpos <= qpos) && in_window(a, qpos, kpos);
          const float p = ok ? expf(s[i][c] * a.scale - Ls[qc]) : 0.f;
          Ps[kr * kPP + qc] = p;
          Ss[kr * kPP + qc] = ok ? p * (dp[i][c] - Dl[qc]) : 0.f;
        }
      }
      __syncthreads();

      // dv += p^T . dout, dk += ds^T . q over the tile's queries
      for (int qr = 0; qr < qvalid; ++qr) {
        float pv[kR], sv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = Ps[(ty * kR + i) * kPP + qr];
          sv[i] = Ss[(ty * kR + i) * kPP + qr];
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int col = tx + 16 * j;
          if (col < D) {
            const float o = Os[qr * P + col];
            const float qq = Qs[qr * P + col];
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              dv[i][j] = fmaf(pv[i], o, dv[i][j]);
              dk[i][j] = fmaf(sv[i], qq, dk[i][j]);
            }
          }
        }
      }
    }
  }

  // a thread's columns are tx + 16 j: one value at a time
  const long long n = static_cast<long long>(a.B) * a.Skv * a.Hkv * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int kr = ty * kR + i;
    if (kr < kvalid) {
      const long long row = kv_off + kr * kv_row;
      float* dkr = a.n_split == 1 ? static_cast<float*>(a.dk) + row
                                  : a.partial + split * n + row;
      float* dvr = a.n_split == 1 ? static_cast<float*>(a.dv) + row
                                  : dkr + a.n_split * n;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) {
          dkr[col] = dk[i][j] * a.scale;
          dvr[col] = dv[i][j];
        }
      }
    }
  }
}

// dQ of one 64-query tile of one query head.
template <int kJ>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dq_simt(BwdArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_lo = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int D = a.D;
  const int P = D + 1;

  extern __shared__ float smem_bwd[];
  float* Qs = smem_bwd;
  float* Os = Qs + kT * P;
  float* Ks = Os + kT * P;
  float* Vs = Ks + kT * P;
  float* Ss = Vs + kT * P;          // ds, [query][key]
  float* Ls = Ss + kT * kPP;
  float* Dl = Ls + kT;

  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long q_row = static_cast<long long>(a.Hq) * D;
  const int qvalid = min(kT, a.S - q_lo);
  const long long q_off = (static_cast<long long>(b) * a.S + q_lo) * q_row + h * D;
  load_tile(Qs, static_cast<const float*>(a.q) + q_off, q_row, qvalid, D, tid);
  load_tile(Os, static_cast<const float*>(a.dout) + q_off, q_row, qvalid, D, tid);
  __syncthreads();
  // delta of the tile's rows, for this block and the dK/dV launch
  if (tid < kT) {
    const long long r = (static_cast<long long>(b) * a.S + q_lo + tid) * a.Hq + h;
    float dl = 0.f;
    if (tid < qvalid) {
      const float* orow = static_cast<const float*>(a.out) + q_off + tid * q_row;
      for (int d = 0; d < D; ++d) dl = fmaf(Os[tid * P + d], orow[d], dl);
      a.delta[r] = dl;
    }
    Ls[tid] = tid < qvalid ? a.lse[r] : 0.f;
    Dl[tid] = dl;
  }

  float dq[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dq[i][j] = 0.f;

  const int nkt = (a.Skv + kT - 1) / kT;
  const int kt_end = a.causal ? min(nkt, blockIdx.y + 1) : nkt;
  for (int kt = window_kt_begin(a, q_lo); kt < kt_end; ++kt) {
    const int k_lo = kt * kT;
    const int kvalid = min(kT, a.Skv - k_lo);
    const long long kv_off = (static_cast<long long>(b) * a.Skv + k_lo) * kv_row + hk * D;
    __syncthreads();   // the previous tile's readers are done
    load_tile(Ks, static_cast<const float*>(a.k) + kv_off, kv_row, kvalid, D, tid);
    load_tile(Vs, static_cast<const float*>(a.v) + kv_off, kv_row, kvalid, D, tid);
    __syncthreads();

    float s[kR][kC], dp[kR][kC];
    tile_products(s, dp, Qs, Ks, Os, Vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qr = ty * kR + i;
      const int qpos = q_lo + qr;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kc = tx + 16 * c;
        const int kpos = k_lo + kc;
        const bool ok = qr < qvalid && kc < kvalid &&
                        (!a.causal || kpos <= qpos) && in_window(a, qpos, kpos);
        const float p = ok ? expf(s[i][c] * a.scale - Ls[qr]) : 0.f;
        Ss[qr * kPP + kc] = ok ? p * (dp[i][c] - Dl[qr]) : 0.f;
      }
    }
    __syncthreads();

    for (int kr = 0; kr < kvalid; ++kr) {
      float sv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) sv[i] = Ss[(ty * kR + i) * kPP + kr];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) {
          const float kk = Ks[kr * P + col];
#pragma unroll
          for (int i = 0; i < kR; ++i) dq[i][j] = fmaf(sv[i], kk, dq[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qr = ty * kR + i;
    if (qr < qvalid) {
      float* row = static_cast<float*>(a.dq) + q_off + qr * q_row;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) row[col] = dq[i][j] * a.scale;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;      // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMmaThreads == 2 * kT, "one lse or delta value per thread");

template <bool B> struct Flag { static constexpr bool value = B; };

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ inline float fast_exp2(float x) {   // 2^x, one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>   // head dim padded to 16, 32, 64 or 128
struct BwdTile {
  static constexpr int kPitch = DP + 8;       // bf16 per shared row
  static constexpr int kChunks = DP / 8;      // 16-byte chunks per row
  static constexpr int kTile = kT * kPitch;   // bf16 per tile
  static constexpr int kQS = DP <= 64 ? 64 : 32;   // dK/dV queries per step
  // two fixed tiles, a two-stage ring of tile pairs, and for dK/dV each
  // stage's lse and delta
  static constexpr size_t kSmem =
      6 * kTile * sizeof(bf16) + 2 * 2 * kT * sizeof(float);
  static constexpr int kRowStep = kMmaThreads / kChunks;
  static_assert(kMmaThreads % kChunks == 0 && kT % kRowStep == 0,
                "whole rows per copy");
  static_assert(kT % kQS == 0, "whole steps per tile");
};

// This thread's share of the cp.async copies of one tile: the same 16-byte
// chunk of every kRowStep-th row, so every offset but the tile's base is
// fixed for the whole kernel.  Rows past the data and chunks past the head
// dim are zero-filled and read nothing.
template <int DP>
struct RowCopy {
  using M = BwdTile<DP>;
  int soff, goff, row;
  bool on;
  __device__ RowCopy(int tid, int chunks) {
    const int ch = tid % M::kChunks;
    row = tid / M::kChunks;
    soff = row * M::kPitch + ch * 8;
    goff = ch * 16;
    on = ch < chunks;
  }
  // kT rows from `src` (its row 0), `row_bytes` apart; `valid_rows` exist;
  // `safe` is any valid address
  __device__ void issue(bf16* dst, const char* src, long long row_bytes,
                        int valid_rows, const void* safe) const {
    const char* g = src + goff + row * row_bytes;
#pragma unroll
    for (int i = 0; i < kT / M::kRowStep; ++i) {
      const int r = row + i * M::kRowStep;
      const bool ok = on && r < valid_rows;
      cp_async16(dst + soff + i * M::kRowStep * M::kPitch, ok ? g : safe, ok);
      g += M::kRowStep * row_bytes;
    }
  }
};

// A x4 fragment of the 16 x 16 block at (row 0, column k0) of a padded
// shared tile, as the A operand (rows) of m16n8k16.
template <int PITCH>
__device__ inline void load_a(uint32_t (&r)[4], const bf16* base, int k0,
                              int lane) {
  ldmatrix_x4(r, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + k0 +
                     (lane >> 4) * 8);
}

// B fragments of two n-tiles (rows n0 .. n0 + 15 of a tile stored [n][k])
// at columns k0 .. k0 + 15: r[0], r[1] for rows n0 .. n0 + 7, r[2], r[3]
// for the next 8.
template <int PITCH>
__device__ inline void load_b(uint32_t (&r)[4], const bf16* tile, int n0,
                              int k0, int lane) {
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * PITCH + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (columns n0 .. n0 + 15 of a tile stored
// [k][n]) at rows k0 .. k0 + 15, through the transposing ldmatrix.
template <int PITCH>
__device__ inline void load_b_trans(uint32_t (&r)[4], const bf16* tile,
                                    int k0, int n0, int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                           n0 + (lane >> 4) * 8);
}

// The A operand of a 16 x 16 block from two m16n8 accumulators side by
// side, rounded to bf16.
__device__ inline void acc_to_a(uint32_t (&r)[4], const float (&lo)[4],
                                const float (&hi)[4]) {
  r[0] = pack_bf16(lo[0], lo[1]);
  r[1] = pack_bf16(lo[2], lo[3]);
  r[2] = pack_bf16(hi[0], hi[1]);
  r[3] = pack_bf16(hi[2], hi[3]);
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma(BwdArgs a) {
  using M = BwdTile<DP>;
  constexpr int kPitch = M::kPitch, kTile = M::kTile, kQS = M::kQS;
  constexpr int kNS = kQS / 8;                 // S^T n-tiles per step
  constexpr int kND = DP / 8;                  // dK / dV n-tiles
  const int split = blockIdx.x % a.n_split;
  const int bk = blockIdx.x / a.n_split;
  const int b = bk / a.Hkv;
  const int hk = bk - b * a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int gs = G / a.n_split;
  // heaviest causal key tiles first: key tile 0 sees every query tile
  const int k_lo = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = warp * 16;                  // this warp's keys
  const int g = lane >> 2;                     // fragment row (and row + 8)
  const int t = lane & 3;                      // fragment column pair

  extern __shared__ uint4 smem_bwd_mma[];
  bf16* sK = reinterpret_cast<bf16*>(smem_bwd_mma);
  bf16* sV = sK + kTile;
  bf16* ring = sV + kTile;                     // stage: Q tile, dO tile
  float* ring_f = reinterpret_cast<float*>(ring + 4 * kTile);  // lse, delta

  const int nqt = (a.S + kT - 1) / kT;
  const int qt0 = a.causal ? blockIdx.y : 0;   // tiles at or below the diagonal
  const int n_qt = window_qt_end(a, k_lo, nqt) - qt0;
  const int n_it = gs * n_qt;                  // (head, query tile) pairs
  const long long es = sizeof(bf16);
  const long long kv_row = static_cast<long long>(a.Hkv) * a.D * es;
  const long long q_row = static_cast<long long>(a.Hq) * a.D * es;
  const RowCopy<DP> copy(tid, a.D / 8);
  const long long kv_off = (static_cast<long long>(b) * a.Skv + k_lo) * kv_row +
                           hk * a.D * es;
  copy.issue(sK, static_cast<const char*>(a.k) + kv_off, kv_row, a.Skv - k_lo, a.k);
  copy.issue(sV, static_cast<const char*>(a.v) + kv_off, kv_row, a.Skv - k_lo, a.v);

  // stage it % 2 holds head split * gs + it / n_qt, query tile qt0 + it % n_qt
  auto load_stage = [&](int it) {
    const int j = it / n_qt;
    const int q_lo = (qt0 + it - j * n_qt) * kT;
    const int h = hk * G + split * gs + j;
    bf16* dst = ring + (it % 2) * 2 * kTile;
    const long long off = (static_cast<long long>(b) * a.S + q_lo) * q_row +
                          h * a.D * es;
    copy.issue(dst, static_cast<const char*>(a.q) + off, q_row, a.S - q_lo, a.q);
    copy.issue(dst + kTile, static_cast<const char*>(a.dout) + off, q_row,
               a.S - q_lo, a.dout);
    // threads 0-63 copy the tile's lse, 64-127 its delta
    const int r = tid & (kT - 1);
    const bool ok = q_lo + r < a.S;
    const float* src = tid < kT ? a.lse : a.delta;
    cp_async4(ring_f + (it % 2) * 2 * kT + tid,
              ok ? src + (static_cast<long long>(b) * a.S + q_lo + r) * a.Hq + h : src,
              ok);
  };
  if (n_it > 0) load_stage(0);
  cp_async_commit();   // K, V and stage 0

  float dk[kND][4], dv[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const float qk_scale = a.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // stage it landed; every warp is done with it - 1
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int q_lo = (qt0 + it % n_qt) * kT;
    const bf16* sQ = ring + (it % 2) * 2 * kTile;
    const bf16* sO = sQ + kTile;
    const float* sL = ring_f + (it % 2) * 2 * kT;
    const float* sD = sL + kT;
    auto tile = [&](auto mask_tag) {
      constexpr bool MASK = decltype(mask_tag)::value;
#pragma unroll 1
      for (int qs = 0; qs < kT; qs += kQS) {
        // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x kQS queries per warp
        float st[kNS][4], dpt[kNS][4];
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          uint32_t ka[4], va[4];
          load_a<kPitch>(ka, sK + wrow * kPitch, kd * 16, lane);
          load_a<kPitch>(va, sV + wrow * kPitch, kd * 16, lane);
#pragma unroll
          for (int nb = 0; nb < kQS / 16; ++nb) {
            uint32_t qb[4], ob[4];
            load_b<kPitch>(qb, sQ, qs + nb * 16, kd * 16, lane);
            load_b<kPitch>(ob, sO, qs + nb * 16, kd * 16, lane);
            mma_bf16(st[2 * nb], ka, qb[0], qb[1]);
            mma_bf16(st[2 * nb + 1], ka, qb[2], qb[3]);
            mma_bf16(dpt[2 * nb], va, ob[0], ob[1]);
            mma_bf16(dpt[2 * nb + 1], va, ob[2], ob[3]);
          }
        }
        // P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T -
        // delta); lse and delta by column (query)
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const int c = qs + j * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
          const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float nl = -((e & 1) ? l2.y : l2.x) * kLog2e;
            const float dl = (e & 1) ? d2.y : d2.x;
            float p = fast_exp2(fmaf(st[j][e], qk_scale, nl));
            if constexpr (MASK) {
              const int kpos = k_lo + wrow + g + (e >> 1) * 8;
              const int qpos = q_lo + c + (e & 1);
              const bool ok = (qpos < a.S) & (!a.causal | (kpos <= qpos)) &
                              in_window(a, qpos, kpos);
              p = ok ? p : 0.f;
            }
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dl);
          }
        }
        // dV += P^T.dO and dK += dS^T.Q, P^T and dS^T rounded to bf16
#pragma unroll
        for (int kk = 0; kk < kQS / 16; ++kk) {
          uint32_t pa[4], sa[4];
          acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int n = 0; n < DP / 16; ++n) {
            uint32_t ob[4], qb[4];
            load_b_trans<kPitch>(ob, sO, qs + kk * 16, n * 16, lane);
            load_b_trans<kPitch>(qb, sQ, qs + kk * 16, n * 16, lane);
            mma_bf16(dv[2 * n], pa, ob[0], ob[1]);
            mma_bf16(dv[2 * n + 1], pa, ob[2], ob[3]);
            mma_bf16(dk[2 * n], sa, qb[0], qb[1]);
            mma_bf16(dk[2 * n + 1], sa, qb[2], qb[3]);
          }
        }
      }
    };
    // only tiles that cross the diagonal or S are masked
    if ((a.causal && k_lo + kT - 1 > q_lo) || q_lo + kT > a.S ||
        window_cuts(a, q_lo, k_lo)) {
      tile(Flag<true>());
    } else {
      tile(Flag<false>());
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k_lo + wrow + g + r * 8;
    if (kpos < a.Skv) {
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < a.D) {
          if (a.n_split == 1) {
            const long long idx =
                ((static_cast<long long>(b) * a.Skv + kpos) * a.Hkv + hk) * a.D + d;
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + idx) =
                pack_bf16(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + idx) =
                pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
          } else {
            store_partial(a, split, b, hk, kpos, d, dk[j][2 * r] * a.scale,
                          dk[j][2 * r + 1] * a.scale, dv[j][2 * r],
                          dv[j][2 * r + 1]);
          }
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma(BwdArgs a) {
  using M = BwdTile<DP>;
  constexpr int kPitch = M::kPitch, kTile = M::kTile;
  constexpr int kNS = kT / 8;                  // score n-tiles per warp
  constexpr int kND = DP / 8;                  // dQ n-tiles
  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  // heaviest causal query tiles first
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = warp * 16;                  // this warp's queries
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ uint4 smem_bwd_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_bwd_mma);
  bf16* sO = sQ + kTile;
  bf16* ring = sO + kTile;                     // stage: K tile, V tile

  const int nkt = (a.Skv + kT - 1) / kT;
  const int kt0 = window_kt_begin(a, q_lo);     // the window's first key tile
  const int n_it = (a.causal ? min(nkt, q_lo / kT + 1) : nkt) - kt0;
  const long long es = sizeof(bf16);
  const long long kv_row = static_cast<long long>(a.Hkv) * a.D * es;
  const long long q_row = static_cast<long long>(a.Hq) * a.D * es;
  const RowCopy<DP> copy(tid, a.D / 8);
  const long long q_off = (static_cast<long long>(b) * a.S + q_lo) * q_row +
                          h * a.D * es;
  copy.issue(sQ, static_cast<const char*>(a.q) + q_off, q_row, a.S - q_lo, a.q);
  copy.issue(sO, static_cast<const char*>(a.dout) + q_off, q_row, a.S - q_lo, a.dout);
  const char* kb = static_cast<const char*>(a.k) + static_cast<long long>(b) * a.Skv * kv_row +
                   hk * a.D * es;
  const char* vb = static_cast<const char*>(a.v) + static_cast<long long>(b) * a.Skv * kv_row +
                   hk * a.D * es;
  auto load_stage = [&](int it) {
    bf16* dst = ring + (it % 2) * 2 * kTile;
    const int k_lo = (kt0 + it) * kT;
    copy.issue(dst, kb + k_lo * kv_row, kv_row, a.Skv - k_lo, a.k);
    copy.issue(dst + kTile, vb + k_lo * kv_row, kv_row, a.Skv - k_lo, a.v);
  };
  if (n_it > 0) load_stage(0);
  cp_async_commit();   // Q, dO and stage 0

  // delta of the tile's rows from global memory, 16 bytes of dout and out
  // a thread (the copy's chunk and rows), summed over the row's threads;
  // for this block and the dK/dV launch
  __shared__ float s_delta[kT];
#pragma unroll
  for (int i = 0; i < kT / M::kRowStep; ++i) {
    const int r = copy.row + i * M::kRowStep;
    const int qpos = q_lo + r;
    const long long idx = (static_cast<long long>(b) * a.S + qpos) * a.Hq + h;
    float dl = 0.f;
    if (copy.on && qpos < a.S) {
      const long long off = idx * a.D + copy.goff / 2;
      uint4 x = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dout) + off);
      uint4 y = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.out) + off);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(xp[j]);
        const float2 fy = __bfloat1622float2(yp[j]);
        dl = fmaf(fx.x, fy.x, dl);
        dl = fmaf(fx.y, fy.y, dl);
      }
    }
    dl = group_sum<M::kChunks>(dl);
    if (tid % M::kChunks == 0) {
      s_delta[r] = dl;
      if (qpos < a.S) a.delta[idx] = dl;
    }
  }
  __syncthreads();
  // this lane's rows g and g + 8: lse in log2 units, negated, and delta
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_lo + wrow + g + r * 8;
    const long long idx = (static_cast<long long>(b) * a.S + qpos) * a.Hq + h;
    nl[r] = qpos < a.S ? -a.lse[idx] * kLog2e : 0.f;
    dl[r] = s_delta[wrow + g + r * 8];
  }
  float dq[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const float qk_scale = a.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // stage it landed; every warp is done with it - 1
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int k_lo = (kt0 + it) * kT;
    const bf16* sK = ring + (it % 2) * 2 * kTile;
    const bf16* sV = sK + kTile;
    auto tile = [&](auto mask_tag) {
      constexpr bool MASK = decltype(mask_tag)::value;
      // S = Q.K^T and dP = dO.V^T: 16 queries x 64 keys per warp
      float s[kNS][4], dp[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t qa[4], oa[4];
        load_a<kPitch>(qa, sQ + wrow * kPitch, kd * 16, lane);
        load_a<kPitch>(oa, sO + wrow * kPitch, kd * 16, lane);
#pragma unroll
        for (int nb = 0; nb < kT / 16; ++nb) {
          uint32_t kf[4], vf[4];
          load_b<kPitch>(kf, sK, nb * 16, kd * 16, lane);
          load_b<kPitch>(vf, sV, nb * 16, kd * 16, lane);
          mma_bf16(s[2 * nb], qa, kf[0], kf[1]);
          mma_bf16(s[2 * nb + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[2 * nb], oa, vf[0], vf[1]);
          mma_bf16(dp[2 * nb + 1], oa, vf[2], vf[3]);
        }
      }
      // dS = P (dP - delta), P = exp2(S scale log2 e - lse log2 e)
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[j][e], qk_scale, nl[e >> 1]));
          if constexpr (MASK) {
            const int qpos = q_lo + wrow + g + (e >> 1) * 8;
            const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
            const bool ok = (kpos < a.Skv) & (!a.causal | (kpos <= qpos)) &
                            in_window(a, qpos, kpos);
            p = ok ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
      // dQ += dS.K, dS rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t sa[4];
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DP / 16; ++n) {
          uint32_t kf[4];
          load_b_trans<kPitch>(kf, sK, kk * 16, n * 16, lane);
          mma_bf16(dq[2 * n], sa, kf[0], kf[1]);
          mma_bf16(dq[2 * n + 1], sa, kf[2], kf[3]);
        }
      }
    };
    // only tiles that cross the diagonal or S are masked
    if ((a.causal && k_lo + kT - 1 > q_lo) || k_lo + kT > a.Skv ||
        window_cuts(a, q_lo, k_lo)) {
      tile(Flag<true>());
    } else {
      tile(Flag<false>());
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_lo + wrow + g + r * 8;
    if (qpos < a.S) {
      bf16* row = static_cast<bf16*>(a.dq) +
                  ((static_cast<long long>(b) * a.S + qpos) * a.Hq + h) * a.D;
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < a.D) {
          *reinterpret_cast<uint32_t*>(row + d) =
              pack_bf16(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dims above 128 (MLA's q/k head dim, 192): eight warps
// ---------------------------------------------------------------------------
//
// At DP 192 the four-warp layout above would hold 192 fp32 of dK and dV a
// lane and spill, and its six tiles (154 KB) leave room for one block per
// SM, four warps.  So a block here has eight warps, and each pair of warps
// (w, w + 4) shares 16 rows of the block's 64-row tile:
//
// - dK/dV: the pair splits the head dim's columns, so each lane holds 96
//   fp32 of dK and dV.  Per step of 32 queries, warp w + 4h forms S^T and
//   dP^T for its 16 keys and the step's queries 16 h .. 16 h + 15 (no
//   product is computed twice), rounds P^T and dS^T to bf16 and writes
//   them to a shared exchange tile; after a barrier of the pair, each
//   warp reads the whole step's P^T and dS^T as A operands by ldmatrix
//   (the values acc_to_a would give) and updates its columns of dV and
//   dK.  The exchange tile is double-buffered, so one pair barrier a step
//   suffices.
// - dQ: the pair splits each 64-key tile, keys 32 h .. 32 h + 31 to warp
//   w + 4h, so each lane holds 96 fp32 of its partial dQ over all its
//   columns.  After the key loop, warps 4-7 leave their partials in the
//   freed ring and warps 0-3 add them, in that fixed order, and store.
//
// Same arithmetic as the four-warp kernels per element (p in fp32, P^T
// and dS^T rounded to bf16 before their products, sums in fp32), same
// grids, the same split and fold.  Shared memory: 175,104 bytes for
// dK/dV, 153,600 for dQ; one block of eight warps per SM.

constexpr int kWideThreads = 256;     // 8 warps: 4 row groups x 2 halves

template <int DP>
struct WideTile {
  static constexpr int kPitch = DP + 8;
  static constexpr int kChunks = DP / 8;
  static constexpr int kTile = kT * kPitch;
  static constexpr int kQS = 32;                  // dK/dV queries per step
  static constexpr int kXPitch = kQS + 8;         // exchange tile pitch
  static constexpr int kXTile = kT * kXPitch;
  static constexpr int kCols = DP / 2;            // dK/dV columns per warp
  static constexpr int kKS = kT / 2;              // dQ keys per warp per tile
  // K, V, a two-stage ring of (Q, dO), each stage's lse and delta, and
  // two buffers of (P^T, dS^T)
  static constexpr size_t kSmemDkdv = 6 * kTile * sizeof(bf16) +
                                      2 * 2 * kT * sizeof(float) +
                                      2 * 2 * kXTile * sizeof(bf16);
  // Q, dO and a two-stage ring of (K, V)
  static constexpr size_t kSmemDq = 6 * kTile * sizeof(bf16);
  static_assert((kT * kChunks) % kWideThreads == 0, "whole chunks a thread");
  static_assert(kCols % 16 == 0 && kT % kQS == 0, "whole fragments");
  static_assert(4 * (DP / 8) * 4 * 32 * sizeof(float) <=
                    4 * kTile * sizeof(bf16),
                "the dQ partials of warps 4-7 fit the ring");
};

// One 64-row tile from `src` (its row 0, rows `row_bytes` apart) into a
// padded shared tile by cp.async, 16 bytes a copy, chunk c = tid + i *
// kWideThreads; rows at or past `valid_rows` and chunks at or past
// `chunks` are zero-filled and read nothing (`safe` is any valid address).
template <int DP>
__device__ inline void wide_issue(bf16* dst, const char* src,
                                  long long row_bytes, int valid_rows,
                                  int chunks, const void* safe, int tid) {
  using M = WideTile<DP>;
#pragma unroll
  for (int i = 0; i < kT * M::kChunks / kWideThreads; ++i) {
    const int c = tid + i * kWideThreads;
    const int r = c / M::kChunks;
    const int ch = c - r * M::kChunks;
    const bool ok = ch < chunks && r < valid_rows;
    cp_async16(dst + r * M::kPitch + ch * 8,
               ok ? src + r * row_bytes + ch * 16 : safe, ok);
  }
}

// The barrier of warps w and w + 4 (64 threads), named barrier 1 + w % 4.
__device__ inline void pair_sync(int warp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + (warp & 3)), "r"(64)
               : "memory");
}

template <int DP>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkdv_mma8(BwdArgs a) {
  using M = WideTile<DP>;
  constexpr int kPitch = M::kPitch, kTile = M::kTile, kQS = M::kQS;
  constexpr int kXP = M::kXPitch, kXTile = M::kXTile;
  constexpr int kND = M::kCols / 8;            // dK / dV n-tiles per warp
  const int split = blockIdx.x % a.n_split;
  const int bk = blockIdx.x / a.n_split;
  const int b = bk / a.Hkv;
  const int hk = bk - b * a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int gs = G / a.n_split;
  const int k_lo = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = (warp & 3) * 16;            // this pair's keys
  const int half = warp >> 2;                  // queries of a step, columns
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ uint4 smem_bwd_mma[];
  bf16* sK = reinterpret_cast<bf16*>(smem_bwd_mma);
  bf16* sV = sK + kTile;
  bf16* ring = sV + kTile;                     // stage: Q tile, dO tile
  float* ring_f = reinterpret_cast<float*>(ring + 4 * kTile);  // lse, delta
  bf16* sX = reinterpret_cast<bf16*>(ring_f + 2 * 2 * kT);     // P^T, dS^T

  const int nqt = (a.S + kT - 1) / kT;
  const int qt0 = a.causal ? blockIdx.y : 0;
  const int n_qt = window_qt_end(a, k_lo, nqt) - qt0;
  const int n_it = gs * n_qt;
  const long long es = sizeof(bf16);
  const long long kv_row = static_cast<long long>(a.Hkv) * a.D * es;
  const long long q_row = static_cast<long long>(a.Hq) * a.D * es;
  const int chunks = a.D / 8;
  const long long kv_off = (static_cast<long long>(b) * a.Skv + k_lo) * kv_row +
                           hk * a.D * es;
  wide_issue<DP>(sK, static_cast<const char*>(a.k) + kv_off, kv_row,
                 a.Skv - k_lo, chunks, a.k, tid);
  wide_issue<DP>(sV, static_cast<const char*>(a.v) + kv_off, kv_row,
                 a.Skv - k_lo, chunks, a.v, tid);

  auto load_stage = [&](int it) {
    const int j = it / n_qt;
    const int q_lo = (qt0 + it - j * n_qt) * kT;
    const int h = hk * G + split * gs + j;
    bf16* dst = ring + (it % 2) * 2 * kTile;
    const long long off = (static_cast<long long>(b) * a.S + q_lo) * q_row +
                          h * a.D * es;
    wide_issue<DP>(dst, static_cast<const char*>(a.q) + off, q_row,
                   a.S - q_lo, chunks, a.q, tid);
    wide_issue<DP>(dst + kTile, static_cast<const char*>(a.dout) + off, q_row,
                   a.S - q_lo, chunks, a.dout, tid);
    // threads 0-63 copy the tile's lse, 64-127 its delta
    if (tid < 2 * kT) {
      const int r = tid & (kT - 1);
      const bool ok = q_lo + r < a.S;
      const float* src = tid < kT ? a.lse : a.delta;
      cp_async4(ring_f + (it % 2) * 2 * kT + tid,
                ok ? src + (static_cast<long long>(b) * a.S + q_lo + r) * a.Hq + h
                   : src,
                ok);
    }
  };
  if (n_it > 0) load_stage(0);
  cp_async_commit();   // K, V and stage 0

  float dk[kND][4], dv[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const float qk_scale = a.scale * kLog2e;
  int xb = 0;                                  // exchange buffer parity

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // stage it landed; every warp is done with it - 1
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int q_lo = (qt0 + it % n_qt) * kT;
    const bf16* sQ = ring + (it % 2) * 2 * kTile;
    const bf16* sO = sQ + kTile;
    const float* sL = ring_f + (it % 2) * 2 * kT;
    const float* sD = sL + kT;
    auto tile = [&](auto mask_tag) {
      constexpr bool MASK = decltype(mask_tag)::value;
#pragma unroll 1
      for (int qs = 0; qs < kT; qs += kQS) {
        // S^T = K.Q^T and dP^T = V.dO^T: this pair's 16 keys x this
        // warp's 16 queries of the step
        const int q0 = qs + half * 16;
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          uint32_t ka[4], va[4], qb[4], ob[4];
          load_a<kPitch>(ka, sK + wrow * kPitch, kd * 16, lane);
          load_a<kPitch>(va, sV + wrow * kPitch, kd * 16, lane);
          load_b<kPitch>(qb, sQ, q0, kd * 16, lane);
          load_b<kPitch>(ob, sO, q0, kd * 16, lane);
          mma_bf16(st[0], ka, qb[0], qb[1]);
          mma_bf16(st[1], ka, qb[2], qb[3]);
          mma_bf16(dpt[0], va, ob[0], ob[1]);
          mma_bf16(dpt[1], va, ob[2], ob[3]);
        }
        // P^T and dS^T as in the four-warp kernel, rounded to bf16 into
        // the exchange tile at (key, query of the step)
        bf16* xP = sX + xb * 2 * kXTile;
        bf16* xS = xP + kXTile;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = q0 + j * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
          const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float nl = -((e & 1) ? l2.y : l2.x) * kLog2e;
            const float dl = (e & 1) ? d2.y : d2.x;
            float p = fast_exp2(fmaf(st[j][e], qk_scale, nl));
            if constexpr (MASK) {
              const int kpos = k_lo + wrow + g + (e >> 1) * 8;
              const int qpos = q_lo + c + (e & 1);
              const bool ok = (qpos < a.S) & (!a.causal | (kpos <= qpos)) &
                              in_window(a, qpos, kpos);
              p = ok ? p : 0.f;
            }
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dl);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = (wrow + g + r * 8) * kXP + half * 16 + j * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(xP + x) =
                pack_bf16(st[j][2 * r], st[j][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(xS + x) =
                pack_bf16(dpt[j][2 * r], dpt[j][2 * r + 1]);
          }
        }
        pair_sync(warp);   // the pair's P^T and dS^T for the step are in
        // dV += P^T.dO and dK += dS^T.Q over the step, this warp's columns
#pragma unroll
        for (int kk = 0; kk < kQS / 16; ++kk) {
          uint32_t pa[4], sa[4];
          load_a<kXP>(pa, xP + wrow * kXP, kk * 16, lane);
          load_a<kXP>(sa, xS + wrow * kXP, kk * 16, lane);
#pragma unroll
          for (int n = 0; n < M::kCols / 16; ++n) {
            const int col = half * M::kCols + n * 16;
            uint32_t ob[4], qb[4];
            load_b_trans<kPitch>(ob, sO, qs + kk * 16, col, lane);
            load_b_trans<kPitch>(qb, sQ, qs + kk * 16, col, lane);
            mma_bf16(dv[2 * n], pa, ob[0], ob[1]);
            mma_bf16(dv[2 * n + 1], pa, ob[2], ob[3]);
            mma_bf16(dk[2 * n], sa, qb[0], qb[1]);
            mma_bf16(dk[2 * n + 1], sa, qb[2], qb[3]);
          }
        }
        xb ^= 1;   // the other buffer next: this one may still be read
      }
    };
    if ((a.causal && k_lo + kT - 1 > q_lo) || q_lo + kT > a.S ||
        window_cuts(a, q_lo, k_lo)) {
      tile(Flag<true>());
    } else {
      tile(Flag<false>());
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k_lo + wrow + g + r * 8;
    if (kpos < a.Skv) {
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        const int d = half * M::kCols + j * 8 + 2 * t;
        if (d < a.D) {
          if (a.n_split == 1) {
            const long long idx =
                ((static_cast<long long>(b) * a.Skv + kpos) * a.Hkv + hk) * a.D + d;
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + idx) =
                pack_bf16(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + idx) =
                pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
          } else {
            store_partial(a, split, b, hk, kpos, d, dk[j][2 * r] * a.scale,
                          dk[j][2 * r + 1] * a.scale, dv[j][2 * r],
                          dv[j][2 * r + 1]);
          }
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_mma8(BwdArgs a) {
  using M = WideTile<DP>;
  constexpr int kPitch = M::kPitch, kTile = M::kTile, kKS = M::kKS;
  constexpr int kNS = kKS / 8;                 // score n-tiles per warp
  constexpr int kND = DP / 8;                  // dQ n-tiles
  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = (warp & 3) * 16;            // this pair's queries
  const int k0 = (warp >> 2) * kKS;            // this warp's keys of a tile
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ uint4 smem_bwd_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_bwd_mma);
  bf16* sO = sQ + kTile;
  bf16* ring = sO + kTile;                     // stage: K tile, V tile

  const int nkt = (a.Skv + kT - 1) / kT;
  const int kt0 = window_kt_begin(a, q_lo);     // the window's first key tile
  const int n_it = (a.causal ? min(nkt, q_lo / kT + 1) : nkt) - kt0;
  const long long es = sizeof(bf16);
  const long long kv_row = static_cast<long long>(a.Hkv) * a.D * es;
  const long long q_row = static_cast<long long>(a.Hq) * a.D * es;
  const int chunks = a.D / 8;
  const long long q_off = (static_cast<long long>(b) * a.S + q_lo) * q_row +
                          h * a.D * es;
  wide_issue<DP>(sQ, static_cast<const char*>(a.q) + q_off, q_row, a.S - q_lo,
                 chunks, a.q, tid);
  wide_issue<DP>(sO, static_cast<const char*>(a.dout) + q_off, q_row,
                 a.S - q_lo, chunks, a.dout, tid);
  const char* kb = static_cast<const char*>(a.k) + static_cast<long long>(b) * a.Skv * kv_row +
                   hk * a.D * es;
  const char* vb = static_cast<const char*>(a.v) + static_cast<long long>(b) * a.Skv * kv_row +
                   hk * a.D * es;
  auto load_stage = [&](int it) {
    bf16* dst = ring + (it % 2) * 2 * kTile;
    const int k_lo = (kt0 + it) * kT;
    wide_issue<DP>(dst, kb + k_lo * kv_row, kv_row, a.Skv - k_lo, chunks, a.k,
                   tid);
    wide_issue<DP>(dst + kTile, vb + k_lo * kv_row, kv_row, a.Skv - k_lo,
                   chunks, a.v, tid);
  };
  if (n_it > 0) load_stage(0);
  cp_async_commit();   // Q, dO and stage 0

  // delta of the tile's rows from global memory: four threads a row, each
  // a quarter of its 16-byte chunks, summed over the four; for this block
  // and the dK/dV launch
  __shared__ float s_delta[kT];
  {
    const int r = tid >> 2;
    const int part = tid & 3;
    const int qpos = q_lo + r;
    const long long idx = (static_cast<long long>(b) * a.S + qpos) * a.Hq + h;
    float dl = 0.f;
    if (qpos < a.S) {
#pragma unroll
      for (int i = 0; i < M::kChunks / 4; ++i) {
        const int ch = part * (M::kChunks / 4) + i;
        if (ch < chunks) {
          const long long off = idx * a.D + ch * 8;
          uint4 x = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dout) + off);
          uint4 y = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.out) + off);
          const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fx = __bfloat1622float2(xp[j]);
            const float2 fy = __bfloat1622float2(yp[j]);
            dl = fmaf(fx.x, fy.x, dl);
            dl = fmaf(fx.y, fy.y, dl);
          }
        }
      }
    }
    dl = group_sum<4>(dl);
    if (part == 0) {
      s_delta[r] = dl;
      if (qpos < a.S) a.delta[idx] = dl;
    }
  }
  __syncthreads();
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_lo + wrow + g + r * 8;
    const long long idx = (static_cast<long long>(b) * a.S + qpos) * a.Hq + h;
    nl[r] = qpos < a.S ? -a.lse[idx] * kLog2e : 0.f;
    dl[r] = s_delta[wrow + g + r * 8];
  }
  float dq[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const float qk_scale = a.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // stage it landed; every warp is done with it - 1
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int k_lo = (kt0 + it) * kT;
    const bf16* sK = ring + (it % 2) * 2 * kTile;
    const bf16* sV = sK + kTile;
    auto tile = [&](auto mask_tag) {
      constexpr bool MASK = decltype(mask_tag)::value;
      // S = Q.K^T and dP = dO.V^T: 16 queries x this warp's 32 keys
      float s[kNS][4], dp[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t qa[4], oa[4];
        load_a<kPitch>(qa, sQ + wrow * kPitch, kd * 16, lane);
        load_a<kPitch>(oa, sO + wrow * kPitch, kd * 16, lane);
#pragma unroll
        for (int nb = 0; nb < kKS / 16; ++nb) {
          uint32_t kf[4], vf[4];
          load_b<kPitch>(kf, sK, k0 + nb * 16, kd * 16, lane);
          load_b<kPitch>(vf, sV, k0 + nb * 16, kd * 16, lane);
          mma_bf16(s[2 * nb], qa, kf[0], kf[1]);
          mma_bf16(s[2 * nb + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[2 * nb], oa, vf[0], vf[1]);
          mma_bf16(dp[2 * nb + 1], oa, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[j][e], qk_scale, nl[e >> 1]));
          if constexpr (MASK) {
            const int qpos = q_lo + wrow + g + (e >> 1) * 8;
            const int kpos = k_lo + k0 + j * 8 + 2 * t + (e & 1);
            const bool ok = (kpos < a.Skv) & (!a.causal | (kpos <= qpos)) &
                            in_window(a, qpos, kpos);
            p = ok ? p : 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
      // dQ += dS.K over this warp's keys, dS rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kKS / 16; ++kk) {
        uint32_t sa[4];
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DP / 16; ++n) {
          uint32_t kf[4];
          load_b_trans<kPitch>(kf, sK, k0 + kk * 16, n * 16, lane);
          mma_bf16(dq[2 * n], sa, kf[0], kf[1]);
          mma_bf16(dq[2 * n + 1], sa, kf[2], kf[3]);
        }
      }
    };
    if ((a.causal && k_lo + kT - 1 > q_lo) || k_lo + kT > a.Skv ||
        window_cuts(a, q_lo, k_lo)) {
      tile(Flag<true>());
    } else {
      tile(Flag<false>());
    }
  }

  // warps 4-7 leave their partial dQ in the ring (every copy has landed
  // and every warp is past its last read of it), warps 0-3 add it
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring) + (warp & 3) * (kND * 4 * 32);
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(j * 4 + e) * 32 + lane] = dq[j][e];
  }
  __syncthreads();
  if (warp >= 4) return;
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] += red[(j * 4 + e) * 32 + lane];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_lo + wrow + g + r * 8;
    if (qpos < a.S) {
      bf16* row = static_cast<bf16*>(a.dq) +
                  ((static_cast<long long>(b) * a.S + qpos) * a.Hq + h) * a.D;
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < a.D) {
          *reinterpret_cast<uint32_t*>(row + d) =
              pack_bf16(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the fold of the split partials, both dtypes
// ---------------------------------------------------------------------------

constexpr int kFoldThreads = 256;

// dk and dv, 4 values a thread: the n_split partials summed in split order
// and rounded once.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
flash_bwd_fold(BwdArgs a) {
  const long long n = static_cast<long long>(a.B) * a.Skv * a.Hkv * a.D;
  const long long i4 = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (i4 >= n / 2) return;                 // n / 4 quads for each of dk, dv
  const int which = i4 >= n / 4;           // 0: dk, 1: dv
  const long long i = (i4 - which * (n / 4)) * 4;
  const float* src = a.partial + which * a.n_split * n + i;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < a.n_split; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(src + sp * n);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  T* dst = static_cast<T*>(which ? a.dv : a.dk) + i;
  dst[0] = from_f<T>(s.x);
  dst[1] = from_f<T>(s.y);
  dst[2] = from_f<T>(s.z);
  dst[3] = from_f<T>(s.w);
}

template <typename T>
cudaError_t launch_fold(const BwdArgs& a, cudaStream_t stream) {
  if (a.n_split == 1) return cudaSuccess;
  const long long quads = static_cast<long long>(a.B) * a.Skv * a.Hkv * a.D / 2;
  const int blocks = static_cast<int>((quads + kFoldThreads - 1) / kFoldThreads);
  flash_bwd_fold<T><<<blocks, kFoldThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int kJ>
cudaError_t launch_simt(const BwdArgs& a, cudaStream_t stream) {
  const int P = a.D + 1;
  const int nq = (a.S + kT - 1) / kT, nk = (a.Skv + kT - 1) / kT;
  const size_t dkdv_bytes =
      sizeof(float) * (4 * kT * P + 2 * kT * kPP + 2 * kT);
  const size_t dq_bytes = sizeof(float) * (4 * kT * P + kT * kPP + 2 * kT);
  cudaError_t err = allow_smem(&flash_bwd_dkdv_simt<kJ>, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(&flash_bwd_dq_simt<kJ>, dq_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_simt<kJ><<<dim3(a.B * a.Hq, nq), kSimtThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_simt<kJ><<<dim3(a.B * a.Hkv * a.n_split, nk), kSimtThreads,
                            dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<float>(a, stream);
}

template <int DP>
cudaError_t launch_mma8(const BwdArgs& a, cudaStream_t stream) {
  using M = WideTile<DP>;
  const int nq = (a.S + kT - 1) / kT, nk = (a.Skv + kT - 1) / kT;
  cudaError_t err = allow_smem(&flash_bwd_dkdv_mma8<DP>, M::kSmemDkdv);
  if (err != cudaSuccess) return err;
  err = allow_smem(&flash_bwd_dq_mma8<DP>, M::kSmemDq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma8<DP><<<dim3(a.B * a.Hq, nq), kWideThreads, M::kSmemDq,
                          stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma8<DP><<<dim3(a.B * a.Hkv * a.n_split, nk), kWideThreads,
                            M::kSmemDkdv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<bf16>(a, stream);
}

template <int DP>
cudaError_t launch_mma(const BwdArgs& a, cudaStream_t stream) {
  using M = BwdTile<DP>;
  const int nq = (a.S + kT - 1) / kT, nk = (a.Skv + kT - 1) / kT;
  cudaError_t err = allow_smem(&flash_bwd_dkdv_mma<DP>, M::kSmem);
  if (err != cudaSuccess) return err;
  err = allow_smem(&flash_bwd_dq_mma<DP>, M::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma<DP><<<dim3(a.B * a.Hq, nq), kMmaThreads, M::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<DP><<<dim3(a.B * a.Hkv * a.n_split, nk), kMmaThreads,
                           M::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<bf16>(a, stream);
}

}  // namespace
}  // namespace repro

// Plain C entry point.  q, dout, out, dq: contiguous (B, S, Hq, D); k, v,
// dk, dv: contiguous (B, Skv, Hkv, D), Skv = S where causal or windowed;
// lse: contiguous (B, S, Hq) fp32, and delta fp32 scratch of the same
// size; window: the sliding window (0: none), ignored where glob; n_split:
// a divisor of Hq / Hkv, and with n_split > 1 partial: fp32 scratch of
// 2 * n_split * B * Skv * Hkv * D.
// Launches the dQ kernel, the dK/dV kernel, then the fold where n_split >
// 1, on `stream`; returns cudaGetLastError() after them.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* partial, int B, int S, int Skv, int Hq, int Hkv, int D,
    int causal, int window, int glob, int n_split, int dtype, void* stream) {
  using namespace repro;
  BwdArgs a{q, k, v, dout, out, lse, delta, dq, dk, dv, partial, B, S, Skv,
            Hq, Hkv, D, causal, n_split, 1.0f / sqrtf(static_cast<float>(D)),
            window > 0 && !glob ? window : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || Skv == 0) return 0;
  if (D <= 0 || D > 192 || Hkv <= 0 || Hq % Hkv || n_split <= 0 ||
      (Hq / Hkv) % n_split || (n_split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 16) return static_cast<int>(launch_mma<16>(a, s));
    if (D <= 32) return static_cast<int>(launch_mma<32>(a, s));
    if (D <= 64) return static_cast<int>(launch_mma<64>(a, s));
    if (D <= 128) return static_cast<int>(launch_mma<128>(a, s));
    return static_cast<int>(launch_mma8<192>(a, s));
  }
  if (dtype == kF32) {
    if (D % 4) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64) return static_cast<int>(launch_simt<4>(a, s));
    if (D <= 128) return static_cast<int>(launch_simt<8>(a, s));
    return static_cast<int>(launch_simt<12>(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
