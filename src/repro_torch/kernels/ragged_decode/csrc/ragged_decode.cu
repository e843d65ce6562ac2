// Ragged single-token GQA decode attention for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ragged_decode/kernel.py
// (ragged_decode_kernel / _decode_kernel).  One block per (slot, KV head)
// holds the G = Hq / Hkv query heads of that KV head and walks the KV rows
// [start, len) in tiles of BK rows with an online softmax in fp32.  The
// loop bound cdiv(len, BK) replaces the Pallas kernel's clamped index map,
// a sliding window also moves the start, and dead slots (live == 0) read
// no KV at all and write exact zeros.
//
// Bound on the H100: the KV bytes of the live rows (two tiny products per
// byte).  The design streams each KV row from device memory exactly once
// per (slot, KV head), with 16-byte loads of whole tiles into shared
// memory, and shares it across the G query heads.  Split-KV (more blocks
// than B * Hkv when that is below the SM count), cp.async/TMA pipelining
// and tensor-core products are later work.
//
// Semantics follow the reference: scores in fp32, logit cap before the
// mask, mask pos < len and (window: pos > len-1-window unless global),
// masked positions excluded explicitly (not through exp underflow),
// division by l only where l > 0.
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;           // KV rows per tile
constexpr int kMaxPairs = 8;      // (head, word) outputs per thread

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const int* live;
  void* out;
  int Hq, Hkv, D;
  long long q_sb, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int window, glob;
  float logit_cap, scale;
};

__device__ inline bool in_mask(int pos, int len, int window, int glob) {
  return pos < len && (window == 0 || glob || pos > len - 1 - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(DecodeArgs a) {
  constexpr int E = Word<T>::N;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = a.Hq / a.Hkv;
  const int W = a.D / E;          // words per row
  const int pitch = W + 1;
  const int pairs = G * W;

  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;                        // G x W
  uint32_t* ks = qs + G * W;                  // kBK x pitch
  uint32_t* vs = ks + kBK * pitch;            // kBK x pitch
  float* ps = reinterpret_cast<float*>(vs + kBK * pitch);   // G x kBK
  float* ms = ps + G * kBK;                   // running max per head
  float* ls = ms + G;                         // running sum per head
  float* alpha = ls + G;                      // this tile's rescale

  uint32_t* o = reinterpret_cast<uint32_t*>(
      static_cast<T*>(a.out) + (static_cast<long long>(b) * a.Hq + h * G) * a.D);
  if (a.live[b] == 0) {
    for (int p = tid; p < pairs; p += kThreads) o[p] = 0u;
    return;
  }
  const int len = a.lengths[b];
  const char* qb = static_cast<const char*>(a.q) +
                   (b * a.q_sb + static_cast<long long>(h) * G * a.q_sh) * sizeof(T);
  load_rows(qs, W, qb, a.q_sh * sizeof(T), G, G, W, tid, kThreads);
  if (tid < G) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  int start = 0;
  if (a.window > 0 && !a.glob && len - a.window > 0) {
    start = ((len - a.window) / kBK) * kBK;
  }

  float acc[kMaxPairs][E];
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[n][e] = 0.f;

  const char* kb = static_cast<const char*>(a.k) + (b * a.k_sb + h * a.k_sh) * sizeof(T);
  const char* vb = static_cast<const char*>(a.v) + (b * a.v_sb + h * a.v_sh) * sizeof(T);
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int t0 = start; t0 < len; t0 += kBK) {
    const int nvalid = min(kBK, len - t0);
    __syncthreads();   // the previous tile's readers are done
    load_rows(ks, pitch, kb + t0 * a.k_st * sizeof(T), a.k_st * sizeof(T),
              kBK, nvalid, W, tid, kThreads);
    load_rows(vs, pitch, vb + t0 * a.v_st * sizeof(T), a.v_st * sizeof(T),
              kBK, nvalid, W, tid, kThreads);
    __syncthreads();

    // scores: one (head, row) pair per thread and pass
    for (int i = tid; i < G * kBK; i += kThreads) {
      const int g = i / kBK;
      const int t = i - g * kBK;
      const uint32_t* qr = qs + g * W;
      const uint32_t* kr = ks + t * pitch;
      float s = 0.f;
      for (int w = 0; w < W; ++w) {
        float qa[E], ka[E];
        Word<T>::unpack(qr[w], qa);
        Word<T>::unpack(kr[w], ka);
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qa[e], ka[e], s);
      }
      s *= a.scale;
      if (a.logit_cap > 0.f) s = a.logit_cap * tanhf(s / a.logit_cap);
      ps[i] = in_mask(t0 + t, len, a.window, a.glob) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int t = lane; t < kBK; t += 32) mx = fmaxf(mx, ps[g * kBK + t]);
      mx = group_max<32>(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kBK; t += 32) {
        const bool ok = in_mask(t0 + t, len, a.window, a.glob);
        const float p = ok ? expf(ps[g * kBK + t] - m_new) : 0.f;
        ps[g * kBK + t] = p;
        sum += p;
      }
      sum = group_sum<32>(sum);
      if (lane == 0) {
        const float r = expf(m_prev - m_new);
        alpha[g] = r;
        ls[g] = ls[g] * r + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: each thread owns (head, word) output pairs
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      const int p = tid + n * kThreads;
      if (p < pairs) {
        const int g = p / W;
        const int wc = p - g * W;
        const float r = alpha[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[n][e] *= r;
        const float* pr = ps + g * kBK;
        for (int t = 0; t < nvalid; ++t) {
          float va[E];
          Word<T>::unpack(vs[t * pitch + wc], va);
          const float pt = pr[t];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[n][e] = fmaf(pt, va[e], acc[n][e]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    const int p = tid + n * kThreads;
    if (p < pairs) {
      const int g = p / W;
      const float l = ls[g];
      const float d = l > 0.f ? l : 1.f;
      float vals[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vals[e] = acc[n][e] / d;
      o[p] = Word<T>::pack(vals);
    }
  }
}

template <typename T>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const int W = a.D / Word<T>::N;
  const size_t words = static_cast<size_t>(G) * W + 2 * kBK * (W + 1);
  const size_t floats = static_cast<size_t>(G) * kBK + 3 * G;
  const size_t bytes = 4 * (words + floats);
  cudaError_t err = allow_smem(ragged_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, a.Hkv);
  ragged_decode_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Plain C entry point.  q: (B, Hq, D) with strides (q_sb, q_sh, 1); k, v:
// (B, T, Hkv, D) with strides (sb, st, sh, 1); lengths, live: (B,) int32;
// out: contiguous (B, Hq, D).  Returns cudaGetLastError() after the launch.
extern "C" int ragged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* live, void* out, int B, int Hq, int Hkv, int D,
    long long q_sb, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int window, int glob, float logit_cap, int dtype, void* stream) {
  using namespace repro;
  DecodeArgs a{q, k, v, static_cast<const int*>(lengths),
               static_cast<const int*>(live), out, Hq, Hkv, D,
               q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               window, glob, logit_cap, 1.0f / sqrtf(static_cast<float>(D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(a, B, s));
  if (dtype == kF32) return static_cast<int>(launch<float>(a, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
