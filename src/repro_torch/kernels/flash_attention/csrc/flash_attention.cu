// Blockwise (flash) attention for prefill and encoders, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _flash_kernel), and covers the wider contract of the
// reference's layers.blockwise_attention: q (B, S, Hq, D) and k, v
// (B, Skv, Hkv, D) in the JAX layout, GQA by head index (kv head = h / G),
// causal or bidirectional, a sliding window with a global-layer bypass, the
// logit soft-cap, lengths that are not a multiple of the tile, and per-row
// key padding: with kv_len, key j of row b counts only where j < kv_len[b].
// Skv differs from S only where the mask is bidirectional, has no window
// and no key padding (cross-attention over an encoder output; the wrapper
// raises otherwise): the query side (tiles, rows, lse) runs over S, the
// key side (tile loop, last-tile mask) over Skv.  Both kernels take it as
// a template flag (XKV): the launches with Skv = S compile to the code
// they had before it (a runtime Skv cost them 1-2% on an H100).
//
// Key padding ends each block's key loop at its row's last valid tile, so
// a short row of a long bucket reads and multiplies only its own keys.  A
// row of length 0 (a batch row that holds no job) has no key to attend;
// the plain version then scores every key of its padded blocks alike, and
// the kernel gives the same: the sum of V over the S keys, divided by the
// plain version's padded key count (empty_den), never NaN.  Both kernels
// take the padding as a template flag (KV), so that the launches without
// it compile to the code they had before it (each row's length is S).
//
// Training also takes the log-sum-exp of each query row's scaled scores,
// lse (B, S, Hq) in fp32 and natural units, m + log(max(l, 1e-30)) as the
// reference's _flash_fwd_pass saves it for its backward.  It is a template
// flag too (LSE): the launches without it compile to the code they had.
// The bf16 kernel runs its softmax in the log2 domain (scores times
// scale * log2 e), so there lse = (m2 + log2 l) * ln 2.
//
// Bound on the H100: operations (4 * D flops per attended (query, key)
// pair, on the tensor cores for bf16), against bytes that are read once.
//
// bf16 (flash_attention_mma): FlashAttention-2's design with mma.sync.
// One block of 4 warps per (batch * head, 64-query tile); each warp owns
// 16 query rows and keeps its Q fragments, its 16 x 64 score tile and its
// 16 x D output accumulator in registers (two blocks per SM).
//
// - K and V tiles of 64 keys stream through a two-stage cp.async ring in
//   shared memory, rows padded by 16 bytes so that ldmatrix reads are free
//   of bank conflicts.  Every thread copies the same chunk of a fixed set
//   of rows, so a copy costs a few instructions.  The copy of tile j + 1
//   overlaps the products of tile j, with one barrier per tile.
// - S = Q.K^T and O += P.V are m16n8k16 bf16 products with fp32 sums.  The
//   K fragments are loaded a k-step ahead and a row of V fragments at
//   once: left to itself the compiler may issue each ldmatrix just before
//   its product, and the warps then wait on every load.
// - The online softmax runs on the fp32 score fragment in the log2 domain
//   (ex2.approx; max and sum reduced by quad shuffles), each step a
//   straight-line pass.  P is rounded to bf16 in registers and fed straight
//   in as the A operand of P.V: the m16n8 accumulator layout is the
//   m16n8k16 A layout.
// - Only tiles that cross the diagonal, the window edge or S are masked,
//   by a second copy of the tile body (a mask predicated into the one copy
//   ran on every tile).
// - Head dims are zero-padded to 16, 32, 64, 128, 192 or 256 in shared
//   memory; a row is any whole number of 16-byte chunks (MLA's prefill
//   runs 192, and 24 on its reduced config).  Above 128 the registers run
//   short: the output accumulator alone is DP / 2 fp32 per lane.  So the
//   K fragments are loaded per k-step, not one ahead; the V fragments in
//   groups of four; and the Q fragments are read per k-step from a Q tile
//   that keeps its own shared memory, one block per SM.  Held in registers
//   at 192, Q spilled and the kernel ran 1.3x slower on an H100 (outputs
//   bitwise equal).
// - A thread's share of a tile copy is the same chunk of every few rows
//   where the block's threads divide into the row's chunks, and chunks in
//   turn across rows where they do not (24 chunks at 192).
// - The heaviest causal query tiles are launched first.  At B = 1 a causal
//   prefill is then bound by its longest chain, the heaviest tile's loop
//   over the keys.  More rows per warp, more warps per block, deeper
//   rings, three blocks per SM, or a tile's keys split between two warp
//   sets were each slower at minitron's shapes on an H100.  wgmma with TMA
//   is the next step.
//
// fp32 (flash_attention_simt): on the CUDA cores, since TF32 tensor cores
// would change fp32 numerics.  One block of 128
// threads per (batch * head, 64-query tile) loops over the 64-key tiles on
// or below the diagonal and inside the window.  Q, K and V tiles sit in
// shared memory (209 KB at D = 256); each thread keeps a 4 x 8 tile of
// scores and a 4 x D/8 tile of the output accumulator in registers, sized
// for D up to 128 or up to 256.
//
// Mixed precision follows the reference: scores in fp32, p cast to the
// value dtype before P.V (the running sum keeps fp32 p), output cast to
// q's dtype after dividing by max(l, 1e-30).
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;           // query rows per block: 16 row groups x 4
constexpr int kBK = 64;           // key rows per tile: 8 column lanes x 8
constexpr int kRows = 4;          // query rows per thread
constexpr int kCols = 8;          // score columns per thread

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, Skv, Hq, Hkv, D;   // S queries, Skv keys
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, glob;
  float logit_cap, scale;
  const int* kv_len;   // (B,) valid keys per row (Skv = S), or null
  float empty_den;     // a length-0 row's divisor (see the top)
  float* lse;          // (B, S, Hq) fp32, written where LSE
};

// Valid keys of row b: kv_len[b] clamped to [0, S], or all keys (S, or
// Skv where XKV) without padding.
template <bool KV, bool XKV>
__device__ inline int row_keys(const FlashArgs& a, int b) {
  return KV ? min(max(a.kv_len[b], 0), a.S) : XKV ? a.Skv : a.S;
}

template <typename T, bool KV, int kMaxWC,   // output words per thread
          bool LSE, bool XKV>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt(FlashArgs a) {
  constexpr int E = Word<T>::N;
  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_lo = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 8;                      // row group: rows ty*4 + i
  const int tx = tid % 8;                      // column lane
  const int W = a.D / E;
  const int pitch = W + 1;

  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;                         // kBQ x pitch
  uint32_t* ks = qs + kBQ * pitch;             // kBK x pitch
  uint32_t* vs = ks + kBK * pitch;             // kBK x pitch
  float* ps = reinterpret_cast<float*>(vs + kBK * pitch);  // kBQ x (kBK+1)
  constexpr int pp = kBK + 1;

  const char* qb = static_cast<const char*>(a.q) +
                   (b * a.q_sb + q_lo * a.q_ss + h * a.q_sh) * sizeof(T);
  load_rows(qs, pitch, qb, a.q_ss * sizeof(T), kBQ, min(kBQ, a.S - q_lo),
            W, tid, kThreads);

  float m[kRows], l[kRows];
  float acc[kRows][kMaxWC][E];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxWC; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][j][e] = 0.f;
  }

  const int q_hi = min(q_lo + kBQ, a.S) - 1;
  // a length-0 row attends every key alike, as the plain version does
  const int nk = row_keys<KV, XKV>(a, b);
  const bool uniform = KV && nk == 0;
  const int kend = uniform ? a.S : nk;
  const int kt_end = (a.causal && !uniform) ? min(q_hi / kBK + 1, (kend + kBK - 1) / kBK)
                                            : (kend + kBK - 1) / kBK;
  int kt_begin = 0;
  if (!uniform && a.window > 0 && !a.glob && q_lo - a.window + 1 > 0) {
    kt_begin = (q_lo - a.window + 1) / kBK;
  }
  const char* kb = static_cast<const char*>(a.k) + (b * a.k_sb + hk * a.k_sh) * sizeof(T);
  const char* vb = static_cast<const char*>(a.v) + (b * a.v_sb + hk * a.v_sh) * sizeof(T);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBK;
    const int kvalid = min(kBK, kend - k_lo);
    __syncthreads();   // the previous tile's readers are done
    load_rows(ks, pitch, kb + k_lo * a.k_ss * sizeof(T), a.k_ss * sizeof(T),
              kBK, kvalid, W, tid, kThreads);
    load_rows(vs, pitch, vb + k_lo * a.v_ss * sizeof(T), a.v_ss * sizeof(T),
              kBK, kvalid, W, tid, kThreads);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int w = 0; w < W; ++w) {
      float qa[kRows][E], ka[kCols][E];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        Word<T>::unpack(qs[(ty * kRows + i) * pitch + w], qa[i]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Word<T>::unpack(ks[(tx + 8 * j) * pitch + w], ka[j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) s[i][j] = fmaf(qa[i][e], ka[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qpos = q_lo + r;
      unsigned ok = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k_lo + tx + 8 * j;
        float x = s[i][j] * a.scale;
        if (a.logit_cap > 0.f) x = a.logit_cap * tanhf(x / a.logit_cap);
        const bool valid = kpos < kend &&
                           (uniform || ((!a.causal || kpos <= qpos) &&
                                        (a.window == 0 || a.glob || kpos > qpos - a.window)));
        ok |= static_cast<unsigned>(valid) << j;
        s[i][j] = valid ? (uniform ? 0.f : x) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<8>(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[r * pp + tx + 8 * j] = Word<T>::round(p);
      }
      sum = group_sum<8>(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxWC; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][j][e] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < kvalid; ++t) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * pp + t];
#pragma unroll
      for (int j = 0; j < kMaxWC; ++j) {
        if (tx + 8 * j < W) {
          float va[E];
          Word<T>::unpack(vs[t * pitch + tx + 8 * j], va);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i][j][e] = fmaf(pv[i], va[e], acc[i][j][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q_lo + ty * kRows + i;
    if (qpos < a.S) {
      const float d = uniform ? a.empty_den : fmaxf(l[i], 1e-30f);
      if constexpr (LSE) {
        if (tx == 0) a.lse[(b * a.S + qpos) * a.Hq + h] = m[i] + logf(d);
      }
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          static_cast<T*>(a.out) + b * a.o_sb + qpos * a.o_ss + h * a.o_sh);
#pragma unroll
      for (int j = 0; j < kMaxWC; ++j) {
        if (tx + 8 * j < W) {
          float vals[E];
#pragma unroll
          for (int e = 0; e < E; ++e) vals[e] = acc[i][j][e] / d;
          orow[tx + 8 * j] = Word<T>::pack(vals);
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <bool B> struct Flag { static constexpr bool value = B; };

__device__ inline float fast_exp2(float x) {   // 2^x, one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block: 4 warps of 16 query rows each; a two-stage ring of (K, V)
// tile pairs.
template <int DP>   // head dim padded to 16, 32, 64, 128, 192 or 256
struct MmaTile {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;     // query rows per block
  static constexpr int kBK = 64;              // keys per tile
  static constexpr int kStages = 2;
  static constexpr int kPitch = DP + 8;       // bf16 per shared row
  static constexpr int kChunks = DP / 8;      // 16-byte chunks per row
  static constexpr int kTile = kBK * kPitch;  // bf16 per K or V tile
  static constexpr int kStage = 2 * kTile;    // a K tile, then a V tile
  // register budget above 128 (see the top): K fragments one k-step ahead,
  // V fragments in flight per group, Q fragments held for the whole loop
  static constexpr bool kKAhead = DP <= 128;
  static constexpr int kVGroup = DP <= 128 ? DP / 16 : 4;
  static constexpr bool kQRegs = DP <= 128;
  // Q passes through the last stage before its keys arrive, or keeps its
  // own tile after the ring
  static constexpr size_t kSmem =
      (kStages * kStage + (kQRegs ? 0 : kBQ * kPitch)) * sizeof(__nv_bfloat16);
  static_assert(kBQ <= 2 * kBK, "Q fits in one stage");
  static_assert((DP / 16) % kVGroup == 0, "whole V groups");
};

// This thread's share of the cp.async copies of one tile.  Where the
// block's threads divide into a row's chunks, the same 16-byte chunk of
// every (kThreads / kChunks)-th row, so every offset but the tile's base
// is fixed for the whole kernel; else the chunks in turn, row after row.
// Rows past the data and chunks past the head dim are zero-filled and
// read nothing.
template <typename M>
struct TileCopy {
  static constexpr bool kWhole = M::kThreads % M::kChunks == 0;
  static constexpr int kRowStep = kWhole ? M::kThreads / M::kChunks : 1;
  int row, soff, goff;     // first row; shared (elements), global (bytes)
  bool on;                 // the chunk lies inside the head dim
  int tid, chunks;
  __device__ TileCopy(int tid_, int chunks_) : tid(tid_), chunks(chunks_) {
    const int ch = tid % M::kChunks;
    row = tid / M::kChunks;
    soff = row * M::kPitch + ch * 8;
    goff = ch * 16;
    on = ch < chunks;
  }
  // rows [0, ROWS) of a tile from `src` (its row 0) with `row_bytes`
  // between rows; `valid_rows` of them exist; `safe` is any valid address
  template <int ROWS>
  __device__ void issue(__nv_bfloat16* dst, const char* src,
                        long long row_bytes, int valid_rows,
                        const void* safe) const {
    if constexpr (kWhole) {
      const char* g = src + goff + row * row_bytes;
      const long long step = kRowStep * row_bytes;
#pragma unroll
      for (int i = 0; i < (ROWS + kRowStep - 1) / kRowStep; ++i) {
        const int r = row + i * kRowStep;
        if (ROWS % kRowStep == 0 || r < ROWS) {
          const bool ok = on && r < valid_rows;
          cp_async16(dst + soff + i * kRowStep * M::kPitch, ok ? g : safe, ok);
        }
        g += step;
      }
    } else {
      constexpr int kTotal = ROWS * M::kChunks;
#pragma unroll
      for (int i = 0; i < (kTotal + M::kThreads - 1) / M::kThreads; ++i) {
        const int c = tid + i * M::kThreads;
        if (kTotal % M::kThreads == 0 || c < kTotal) {
          const int r = c / M::kChunks;
          const int ch = c - r * M::kChunks;
          const bool ok = ch < chunks && r < valid_rows;
          cp_async16(dst + r * M::kPitch + ch * 8,
                     ok ? src + r * row_bytes + ch * 16 : safe, ok);
        }
      }
    }
  }
};

// A x4 fragment of the 16 x 16 block at (row 0, column k0) of a padded
// shared tile, as the A operand (rows) of m16n8k16.
template <int PITCH>
__device__ inline void load_a(uint32_t (&r)[4], const __nv_bfloat16* base,
                              int k0, int lane) {
  ldmatrix_x4(r, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + k0 +
                     (lane >> 4) * 8);
}

template <int DP, bool KV, bool LSE, bool XKV>
__global__ void __launch_bounds__(MmaTile<DP>::kThreads)
flash_attention_mma(FlashArgs a) {
  using M = MmaTile<DP>;
  constexpr int ST = M::kStages;
  using bf16 = __nv_bfloat16;
  constexpr int kBQ = M::kBQ, kBK = M::kBK, kPitch = M::kPitch;
  constexpr int kNS = kBK / 8;                 // score n-tiles per warp
  constexpr int kNO = DP / 8;                  // output n-tiles per warp
  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  // heaviest causal query tiles first
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = warp * 16;                  // this warp's rows
  const int g = lane >> 2;                     // fragment row (and row + 8)
  const int t = lane & 3;                      // fragment column pair
  const int chunks = a.D / 8;

  extern __shared__ uint4 smem_mma[];
  bf16* ring = reinterpret_cast<bf16*>(smem_mma);
  bf16* sQ = ring + (M::kQRegs ? ST - 1 : ST) * M::kStage;

  const int q_hi = min(q_lo + kBQ, a.S) - 1;
  // a length-0 row attends every key alike, as the plain version does
  const int nk = row_keys<KV, XKV>(a, b);
  const bool uniform = KV && nk == 0;
  const int kend = uniform ? a.S : nk;
  const int kt_end = (a.causal && !uniform) ? min(q_hi / kBK + 1, (kend + kBK - 1) / kBK)
                                            : (kend + kBK - 1) / kBK;
  const bool win = a.window > 0 && !a.glob && !uniform;
  const bool causal = a.causal && !uniform;
  int kt_begin = 0;
  if (win && q_lo - a.window + 1 > 0) kt_begin = (q_lo - a.window + 1) / kBK;
  const int n_it = kt_end - kt_begin;

  const long long es = sizeof(bf16);
  const char* kb = static_cast<const char*>(a.k) + (b * a.k_sb + hk * a.k_sh) * es;
  const char* vb = static_cast<const char*>(a.v) + (b * a.v_sb + hk * a.v_sh) * es;
  const TileCopy<M> copy(tid, chunks);
  // stage `it % ST` holds tile kt_begin + it
  auto load_stage = [&](int it) {
    bf16* dst = ring + (it % ST) * M::kStage;
    const int k_lo = (kt_begin + it) * kBK;
    copy.template issue<kBK>(dst, kb + k_lo * a.k_ss * es, a.k_ss * es,
                             kend - k_lo, a.k);
    copy.template issue<kBK>(dst + M::kTile, vb + k_lo * a.v_ss * es,
                             a.v_ss * es, kend - k_lo, a.v);
  };
  copy.template issue<kBQ>(
      sQ, static_cast<const char*>(a.q) + (b * a.q_sb + q_lo * a.q_ss + h * a.q_sh) * es,
      a.q_ss * es, a.S - q_lo, a.q);
  // one commit group per stage (empty past the last tile, so that the
  // group count stays uniform)
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_it) load_stage(i);
    cp_async_commit();
  }

  uint32_t qf[M::kQRegs ? DP / 16 : 1][4];
  float o[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // running max (log2 domain) and this thread's share of the running sum,
  // for rows g and g + 8 of the warp's 16
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const float qk_scale = a.scale * kLog2e;
  const float inv_cap = a.logit_cap > 0.f ? 1.f / a.logit_cap : 0.f;
  const int row0 = q_lo + wrow + g;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // stage it landed; every warp is done with it - 1
    if (M::kQRegs && it == 0) {
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd)
        load_a<kPitch>(qf[kd], sQ + wrow * kPitch, kd * 16, lane);
      __syncthreads();   // Q is in registers before its stage is refilled
    }
    if (it + ST - 1 < n_it) load_stage(it + ST - 1);
    cp_async_commit();

    const int kt = kt_begin + it;
    const int k_lo = kt * kBK;
    // only tiles that cross the diagonal, the window edge or S are masked:
    // the tile body is compiled once with and once without the mask
    auto tile = [&](auto mask_tag) {
      constexpr bool MASK = decltype(mask_tag)::value;
      const bf16* sK = ring + (it % ST) * M::kStage;
      const bf16* sV = sK + M::kTile;

      // S = Q . K^T: 16 rows x kBK keys per warp
      float s[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // K fragments one k-step ahead of their products (up to DP 128), so
      // that the products do not wait on each ldmatrix in turn
      constexpr int kKBuf = M::kKAhead ? 2 : 1;
      uint32_t kr[kKBuf][kBK / 16][4];
      auto load_k = [&](int kd, uint32_t (&dst)[kBK / 16][4]) {
#pragma unroll
        for (int nb = 0; nb < kBK / 16; ++nb)
          ldmatrix_x4(dst[nb], sK + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * kPitch +
                                   kd * 16 + ((lane >> 3) & 1) * 8);
      };
      auto products = [&](const uint32_t (&qa)[4],
                          const uint32_t (&kf)[kBK / 16][4]) {
#pragma unroll
        for (int nb = 0; nb < kBK / 16; ++nb) {
          mma_bf16(s[2 * nb], qa, kf[nb][0], kf[nb][1]);
          mma_bf16(s[2 * nb + 1], qa, kf[nb][2], kf[nb][3]);
        }
      };
      if constexpr (M::kKAhead) load_k(0, kr[0]);
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        if constexpr (M::kKAhead) {
          if (kd + 1 < DP / 16) load_k(kd + 1, kr[(kd + 1) % kKBuf]);
        } else {
          load_k(kd, kr[0]);
        }
        const int kbuf = M::kKAhead ? (kd & 1) : 0;
        if constexpr (M::kQRegs) {
          products(qf[kd], kr[kbuf]);
        } else {
          uint32_t qs[4];
          load_a<kPitch>(qs, sQ + wrow * kPitch, kd * 16, lane);
          products(qs, kr[kbuf]);
        }
      }

      // scale and cap into the log2 domain, mask, online softmax; each step
      // a straight-line pass over the fragment (the branches are uniform)
      if (a.logit_cap > 0.f) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = a.logit_cap * tanhf(s[j][e] * a.scale * inv_cap) * kLog2e;
      } else {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= qk_scale;
      }
      if constexpr (MASK) {
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = row0 + (e >> 1) * 8;
            const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
            const bool ok = (kpos < kend) & (!causal | (kpos <= qpos)) &
                            (!win | (kpos > qpos - a.window));
            // p = exp2(-inf) = 0; a length-0 row scores its keys alike
            s[j][e] = ok ? (uniform ? 0.f : s[j][e]) : -INFINITY;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = group_max<4>(mx[r]);
        alpha[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fast_exp2(s[j][e] - m[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P . V, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        // a group of this k-step's V fragments (all of them up to DP 128)
        // in flight before its products
#pragma unroll
        for (int ng = 0; ng < DP / 16; ng += M::kVGroup) {
          uint32_t vr[M::kVGroup][4];
#pragma unroll
          for (int n = 0; n < M::kVGroup; ++n)
            ldmatrix_x4_trans(vr[n], sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                                         (ng + n) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < M::kVGroup; ++n) {
            mma_bf16(o[2 * (ng + n)], pa, vr[n][0], vr[n][1]);
            mma_bf16(o[2 * (ng + n) + 1], pa, vr[n][2], vr[n][3]);
          }
        }
      }
    };
    if (uniform || k_lo + kBK > kend || (causal && k_lo + kBK - 1 > q_lo) ||
        (win && k_lo <= q_hi - a.window)) {
      tile(Flag<true>());
    } else {
      tile(Flag<false>());
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / (uniform ? a.empty_den : fmaxf(group_sum<4>(l[r]), 1e-30f));
    const int qpos = row0 + r * 8;
    if constexpr (LSE) {
      constexpr float kLn2 = 0.6931471805599453f;
      if (t == 0 && qpos < a.S)
        a.lse[(b * a.S + qpos) * a.Hq + h] = (m[r] - log2f(inv)) * kLn2;
    }
    if (qpos < a.S) {
      bf16* orow = static_cast<bf16*>(a.out) + b * a.o_sb + qpos * a.o_ss + h * a.o_sh;
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < a.D) {
          *reinterpret_cast<uint32_t*>(orow + d) =
              pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch_mma(const FlashArgs& a, int B, cudaStream_t stream) {
  using M = MmaTile<DP>;
  const bool xkv = a.Skv != a.S;
  auto kernel = a.kv_len ? &flash_attention_mma<DP, true, false, false>
               : a.lse  ? (xkv ? &flash_attention_mma<DP, false, true, true>
                               : &flash_attention_mma<DP, false, true, false>)
                        : (xkv ? &flash_attention_mma<DP, false, false, true>
                               : &flash_attention_mma<DP, false, false, false>);
  cudaError_t err = allow_smem(kernel, M::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * a.Hq, (a.S + M::kBQ - 1) / M::kBQ);
  kernel<<<grid, M::kThreads, M::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int kMaxWC>
cudaError_t launch_simt(const FlashArgs& a, int B, cudaStream_t stream) {
  const int pitch = a.D + 1;
  const size_t bytes = 4 * (static_cast<size_t>(kBQ + 2 * kBK) * pitch +
                            static_cast<size_t>(kBQ) * (kBK + 1));
  using F = float;
  const bool xkv = a.Skv != a.S;
  auto kernel = a.kv_len ? &flash_attention_simt<F, true, kMaxWC, false, false>
               : a.lse  ? (xkv ? &flash_attention_simt<F, false, kMaxWC, true, true>
                               : &flash_attention_simt<F, false, kMaxWC, true, false>)
                        : (xkv ? &flash_attention_simt<F, false, kMaxWC, false, true>
                               : &flash_attention_simt<F, false, kMaxWC, false, false>);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * a.Hq, (a.S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Launch the kernel for `a`'s dtype and head dim.
int dispatch(const FlashArgs& a, int B, int dtype, cudaStream_t s) {
  if (B == 0 || a.S == 0) return 0;
  if (dtype == kBF16) {
    const int D = a.D;
    if (D <= 16) return static_cast<int>(launch_mma<16>(a, B, s));
    if (D <= 32) return static_cast<int>(launch_mma<32>(a, B, s));
    if (D <= 64) return static_cast<int>(launch_mma<64>(a, B, s));
    if (D <= 128) return static_cast<int>(launch_mma<128>(a, B, s));
    if (D <= 192) return static_cast<int>(launch_mma<192>(a, B, s));
    if (D <= 256) return static_cast<int>(launch_mma<256>(a, B, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kF32) {
    // output words per thread: D / 8 up to 16, else up to 32
    if (a.D <= 128) return static_cast<int>(launch_simt<16>(a, B, s));
    if (a.D <= 256) return static_cast<int>(launch_simt<32>(a, B, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// Plain C entry points.  q: (B, S, Hq, D), k, v: (B, Skv, Hkv, D), out:
// (B, S, Hq, D), each with its (batch, seq, head) strides and a unit
// stride on D; Skv = S where causal, windowed or key-padded; kv_len: (B,)
// int32 on the device, or null.  Each returns cudaGetLastError() after
// the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, int causal, int window, int glob, float logit_cap,
    const int* kv_len, float empty_den, int dtype, void* stream) {
  using namespace repro;
  FlashArgs a{q, k, v, out, S, Skv, Hq, Hkv, D,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, causal, window, glob, logit_cap,
              1.0f / sqrtf(static_cast<float>(D)), kv_len, empty_den,
              nullptr};
  return dispatch(a, B, dtype, static_cast<cudaStream_t>(stream));
}

// The same without key padding, writing lse: a contiguous (B, S, Hq) fp32
// tensor (the training forward).
extern "C" int flash_attention_lse(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, int glob,
    float logit_cap, int dtype, void* stream) {
  using namespace repro;
  FlashArgs a{q, k, v, out, S, Skv, Hq, Hkv, D,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, causal, window, glob, logit_cap,
              1.0f / sqrtf(static_cast<float>(D)), nullptr, 0.f, lse};
  return dispatch(a, B, dtype, static_cast<cudaStream_t>(stream));
}
