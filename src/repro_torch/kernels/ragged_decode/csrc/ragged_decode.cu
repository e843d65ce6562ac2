// Ragged single-token GQA decode attention for sm_90a: split-KV
// (flash-decoding) in two launches.
//
// Replaces the Pallas kernel src/repro/kernels/ragged_decode/kernel.py
// (ragged_decode_kernel / _decode_kernel).
//
// Bound on the H100: the KV bytes of the live rows.  With G = Hq / Hkv
// query heads per KV head (3 at minitron's widths) a KV row feeds 4 * G * D
// flops for 4 * D bytes, so tensor cores would fill G of an mma's 16 rows
// and buy nothing: the products stay on the CUDA cores, and the design is
// about keeping enough loads in flight.
//
// Query-head groups.  A block holds at most 8 query heads in registers
// (q and the accumulator: 2 x 8 x E fp32 per lane).  A larger G (48 at
// granite's multi-query widths) is cut into `groups` groups of `gsize`
// heads (the last may be shorter), each its own work item: the blocks of
// one (slot, chunk, KV head) read the same KV rows, and every read after
// the first comes from the L2.
//
// One launch.  The work items are (slot, chunk of KV rows, KV head, head
// group) for the chunks that hold rows to read, packed at the front of the
// grid: the grid is sized from the host's T (the engine's bounded cache
// view) and the wrapper's chunk, never from the lengths, and the blocks
// past the live work exit at once.  Each block reads every slot's length
// and live flag into shared memory (one load each, in parallel), clamps
// the lengths to [1, T], clips the chunks to [window start, length), and
// finds its item by a prefix sum.  A dead slot is one item per KV head
// and head group that writes exact zeros and reads no KV.
//
// Inside a block, a row of D values is spread over a group of lanes, 16
// bytes each, so a warp covers 32 / lanes-per-row rows at once; each such
// row group is an independent stream of rows with its own online softmax.
// Every stream loads U rows of K and V ahead of its arithmetic (U 16-byte
// loads of each in flight per lane), holds its group's query heads in
// registers and sums each score with warp shuffles: no shared memory and no
// barrier in the loop.  The block then merges its streams through shared
// memory and writes its chunk's partial (m, l and the unnormalised fp32
// accumulator) per query head.
//
// Combine: the blocks of one (slot, KV head, head group) take a ticket
// from a counter after writing their partials; the last one merges the
// chunks with weights exp(m_c - M), divides by l only where l > 0, writes
// the output and resets the counter for the next call.  The counters
// live in a buffer the wrapper keeps per device and stream, zeroed once.
//
// Semantics follow the reference: scores in fp32, logit cap before the
// mask, mask pos < len and (window: pos > len-1-window unless global),
// masked positions excluded explicitly (not through exp underflow),
// division by l only where l > 0.  p stays fp32 in P.V.
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* lengths;      // null: every row has len_value
  const void* live;         // null: every row is live
  float* ml;                // (B, Hq, n_split, 2) partial max and sum
  float* acc;               // (B, Hq, n_split, D) partial accumulators
  int* tickets;             // (B, Hkv, groups) zero between calls
  void* out;                // (B, Hq, D)
  int B, Hq, Hkv, D, T, chunk, n_split, lanes;   // lanes per KV row
  int groups, gsize;        // query-head groups per KV head, heads each
  long long q_sb, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long len_stride, live_stride;
  int len_size, len_value, live_size;            // element bytes: 1, 4, 8
  int window, glob;
  float logit_cap, scale;
};

__device__ inline long long read_int(const void* p, int size, long long i) {
  if (size == 8) return static_cast<const long long*>(p)[i];
  if (size == 4) return static_cast<const int*>(p)[i];
  return static_cast<const unsigned char*>(p)[i];
}

__device__ inline int row_len(const DecodeArgs& a, int b) {
  const long long n = a.lengths ? read_int(a.lengths, a.len_size,
                                           b * a.len_stride)
                                : a.len_value;
  return static_cast<int>(min(max(n, 1LL), static_cast<long long>(a.T)));
}

__device__ inline bool row_live(const DecodeArgs& a, int b) {
  return !a.live || read_int(a.live, a.live_size, b * a.live_stride) != 0;
}

template <typename T> struct Vec;   // one 16-byte load as fp32 values
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& w, float* f) {
    Word<__nv_bfloat16>::unpack(w.x, f);
    Word<__nv_bfloat16>::unpack(w.y, f + 2);
    Word<__nv_bfloat16>::unpack(w.z, f + 4);
    Word<__nv_bfloat16>::unpack(w.w, f + 6);
  }
};

template <typename T> __device__ inline T from_f32(float x);
template <> __device__ inline float from_f32<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// KV chunks [c_lo, c_hi) that hold rows to read for a slot of clamped
// length `len`; a dead slot (len -1) gets one item (c_lo = -1) that only
// writes zeros
__device__ inline void slot_chunks(const DecodeArgs& a, int len, int& c_lo,
                                   int& c_hi) {
  if (len < 0) {
    c_lo = -1;
    c_hi = 0;
    return;
  }
  const int start = a.window > 0 && !a.glob ? max(len - a.window, 0) : 0;
  c_lo = start / a.chunk;
  c_hi = (len + a.chunk - 1) / a.chunk;
}

// GM: the largest head group this instance holds (gsize <= GM)
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
ragged_decode_split(DecodeArgs a) {
  constexpr int E = Vec<T>::N;               // values per lane per row
  constexpr int U = GM <= 4 ? 4 : 2;         // rows in flight per stream
  const int tid = threadIdx.x;
  const int G = a.Hq / a.Hkv;
  const int segs = a.D / E;                  // 16-byte segments per row
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & (a.lanes - 1);        // this lane's segment
  const int streams = kWarps * (32 / a.lanes);
  const int stream = tid / a.lanes;
  const bool on = c < segs;

  // shared memory: the slots' clamped lengths (-1: dead), then the merge
  // area of the block's streams or of the last block's chunks
  extern __shared__ float smem[];
  int* s_len = reinterpret_cast<int*>(smem);
  float* work = smem + ((a.B + 3) & ~3);
  for (int i = tid; i < a.B; i += kThreads) {
    const int len = row_len(a, i);           // both loads in flight at once
    s_len[i] = row_live(a, i) ? len : -1;
  }
  __syncthreads();

  // this block's item: (KV head, head group) from the low digits, then the
  // (item)-th chunk over the slots in order
  const int units = a.Hkv * a.groups;
  const int unit = blockIdx.x % units;
  const int hk = unit / a.groups;
  const int grp = unit - hk * a.groups;
  const int Gb = min(a.gsize, G - grp * a.gsize);   // this group's heads
  const int h0 = hk * G + grp * a.gsize;            // its first query head
  int item = blockIdx.x / units;
  int b = 0, c_lo = 0, c_hi = 0;
  for (; b < a.B; ++b) {
    slot_chunks(a, s_len[b], c_lo, c_hi);
    const int n = max(c_hi - c_lo, 1);
    if (item < n) break;
    item -= n;
  }
  if (b == a.B) return;                      // past the live work
  const int len = s_len[b];
  const long long head0 = static_cast<long long>(b) * a.Hq + h0;
  if (len < 0) {                             // dead slot: exact zeros
    T* o = static_cast<T*>(a.out) + head0 * a.D;
    for (int i = tid; i < Gb * a.D; i += kThreads) o[i] = from_f32<T>(0.f);
    return;
  }
  const int split = c_lo + item;
  const long long head_step = static_cast<long long>(a.n_split);
  float* ml = a.ml + (head0 * a.n_split + split) * 2;
  float* pacc = a.acc + (head0 * a.n_split + split) * a.D;
  int lo = split * a.chunk;
  const int hi = min(lo + a.chunk, len);
  if (a.window > 0 && !a.glob) lo = max(lo, len - a.window);

  float qv[GM][E];
  const char* qb = static_cast<const char*>(a.q) +
                   (b * a.q_sb + static_cast<long long>(h0) * a.q_sh) * sizeof(T) +
                   c * 16;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (g < Gb && on) w = __ldg(reinterpret_cast<const uint4*>(qb + g * a.q_sh * sizeof(T)));
    Vec<T>::unpack(w, qv[g]);
  }

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const char* kb = static_cast<const char*>(a.k) +
                   (b * a.k_sb + hk * a.k_sh) * sizeof(T) + c * 16;
  const char* vb = static_cast<const char*>(a.v) +
                   (b * a.v_sb + hk * a.v_sh) * sizeof(T) + c * 16;
  const long long k_row = a.k_st * sizeof(T);
  const long long v_row = a.v_st * sizeof(T);

  // the trip count is the block's, so every lane reaches the shuffles
  for (int r0 = lo; r0 < hi; r0 += streams * U) {
    uint4 kw[U], vw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + stream + u * streams;
      kw[u] = make_uint4(0u, 0u, 0u, 0u);
      vw[u] = kw[u];
      if (r < hi && on) {
        kw[u] = __ldg(reinterpret_cast<const uint4*>(kb + r * k_row));
        vw[u] = __ldg(reinterpret_cast<const uint4*>(vb + r * v_row));
      }
    }
    float sc[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      Vec<T>::unpack(kw[u], kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qv[g][e], kf[e], d);
        sc[u][g] = d;
      }
    }
    // sum each score over the row's lanes (aligned groups of a.lanes)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < a.lanes) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = sc[u][g] * a.scale;
        if (a.logit_cap > 0.f) x = a.logit_cap * tanhf(x / a.logit_cap);
        sc[u][g] = x;
        if (r0 + stream + u * streams < hi) mx = fmaxf(mx, x);
      }
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = r0 + stream + u * streams < hi ? expf(sc[u][g] - mx)
                                                       : 0.f;
        sc[u][g] = p;
        sum += p;
      }
      l[g] = l[g] * alpha + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      Vec<T>::unpack(vw[u], vf);
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(sc[u][g], vf[e], acc[g][e]);
    }
  }

  // merge the block's streams: (m, l) per (stream, head), then the
  // accumulators per (head, value)
  float* s_m = work;                          // streams x GM
  float* s_l = s_m + streams * GM;            // streams x GM
  float* s_acc = s_l + streams * GM;          // streams x GM x D
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < Gb) {
      if (c == 0) {
        s_m[stream * GM + g] = m[g];
        s_l[stream * GM + g] = l[g];
      }
      if (on) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          s_acc[(stream * GM + g) * a.D + c * E + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Gb * a.D; i += kThreads) {
    const int g = i / a.D;
    const int d = i - g * a.D;
    float mx = kNegInf;
    for (int s = 0; s < streams; ++s) mx = fmaxf(mx, s_m[s * GM + g]);
    float sum = 0.f, val = 0.f;
    for (int s = 0; s < streams; ++s) {
      // a stream that saw no row has l = 0 and a zero accumulator
      const float w = s_l[s * GM + g] > 0.f ? expf(s_m[s * GM + g] - mx) : 0.f;
      sum += w * s_l[s * GM + g];
      val += w * s_acc[(s * GM + g) * a.D + d];
    }
    pacc[g * head_step * a.D + d] = val;
    if (d == 0) {
      ml[g * head_step * 2] = mx;
      ml[g * head_step * 2 + 1] = sum;
    }
  }

  // ticket: the last block of this (slot, KV head, head group) merges the
  // chunks
  __shared__ int s_last;
  int* ticket =
      a.tickets + (static_cast<long long>(b) * a.Hkv + hk) * a.groups + grp;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int n = c_hi - c_lo;
    s_last = atomicAdd(ticket, 1) == n - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n = c_hi - c_lo;
  float* s_w = work;                          // GM x n weights
  float* s_sum = work + GM * n;               // GM merged sums
  for (int g = warp; g < Gb; g += kWarps) {
    const float* gml = a.ml + ((head0 + g) * a.n_split + c_lo) * 2;
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, __ldcg(gml + 2 * i));
    mx = group_max<32>(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = expf(__ldcg(gml + 2 * i) - mx);
      s_w[g * n + i] = w;
      sum += w * __ldcg(gml + 2 * i + 1);
    }
    sum = group_sum<32>(sum);
    if (lane == 0) s_sum[g] = sum;
  }
  __syncthreads();
  T* o = static_cast<T*>(a.out) + head0 * a.D;
  for (int i = tid; i < Gb * a.D; i += kThreads) {
    const int g = i / a.D;
    const int d = i - g * a.D;
    const float* src = a.acc + ((head0 + g) * a.n_split + c_lo) * a.D + d;
    const float* w = s_w + g * n;
    float val = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) val = fmaf(w[j], __ldcg(src + j * a.D), val);
    const float l = s_sum[g];
    o[i] = from_f32<T>(val / (l > 0.f ? l : 1.f));
  }
  if (tid == 0) *ticket = 0;                 // ready for the next call
}


template <typename T, int GM>
cudaError_t launch_split(const DecodeArgs& a, cudaStream_t stream) {
  const int streams = kWarps * (32 / a.lanes);
  const size_t merge = max(static_cast<size_t>(streams) * GM * (2 + a.D),
                           static_cast<size_t>(GM) * (a.n_split + 1));
  const size_t bytes = sizeof(float) * (((a.B + 3) & ~3) + merge);
  auto kernel = ragged_decode_split<T, GM>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(a.B) * a.Hkv * a.groups * a.n_split;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  // the groups cover the G heads, and every group holds at least one
  const int G = a.Hq / a.Hkv;
  const int n = a.gsize;
  if (n < 1 || n > 8 || a.groups < 1 || a.groups * n < G ||
      (a.groups - 1) * n >= G) {
    return cudaErrorInvalidValue;
  }
  if (n == 1) return launch_split<T, 1>(a, stream);
  if (n == 2) return launch_split<T, 2>(a, stream);
  if (n == 3) return launch_split<T, 3>(a, stream);
  if (n == 4) return launch_split<T, 4>(a, stream);
  return launch_split<T, 8>(a, stream);
}

}  // namespace
}  // namespace repro

// Plain C entry point.  q: (B, Hq, D) with strides (q_sb, q_sh, 1); k, v:
// (B, T, Hkv, D) with strides (sb, st, sh, 1); lengths: null (every row
// len_value) or (B,) integers of len_size bytes at stride len_stride; live:
// null (all live) or (B,) of live_size bytes at stride live_stride; ml and
// acc: fp32 scratch of (B, Hq, n_split, 2) and (B, Hq, n_split, D);
// tickets: (B, Hkv, groups) int32, zero on entry and on return; out:
// contiguous (B, Hq, D).  chunk * n_split >= T; lanes is a power of two >=
// D * elem / 16 and <= 32; the G = Hq / Hkv heads of a KV head are cut into
// `groups` groups of `gsize` <= 8 (the last one shorter where gsize does
// not divide G).  Returns cudaGetLastError() after the launch.
extern "C" int ragged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* live, void* ml, void* acc, void* tickets, void* out, int B,
    int Hq, int Hkv,
    int D, int T, int chunk, int n_split, int lanes, int groups, int gsize,
    long long q_sb,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long len_stride,
    int len_size, int len_value, long long live_stride, int live_size,
    int window, int glob, float logit_cap, int dtype, void* stream) {
  using namespace repro;
  DecodeArgs a{q, k, v, lengths, live, static_cast<float*>(ml),
               static_cast<float*>(acc), static_cast<int*>(tickets), out, B,
               Hq, Hkv, D, T, chunk,
               n_split, lanes, groups, gsize, q_sb, q_sh, k_sb, k_st,
               k_sh, v_sb, v_st,
               v_sh, len_stride, live_stride, len_size, len_value, live_size,
               window, glob, logit_cap, 1.0f / sqrtf(static_cast<float>(D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(a, s));
  if (dtype == kF32) return static_cast<int>(launch<float>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
