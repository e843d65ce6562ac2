// Causal blockwise (flash) attention for prefill, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _flash_kernel), and covers the wider prefill contract
// of the reference's layers.blockwise_attention: q (B, S, Hq, D) and k, v
// (B, S, Hkv, D) in the JAX layout, GQA by head index (kv head = h / G),
// causal masking, a sliding window with a global-layer bypass, the logit
// soft-cap, and S that is not a multiple of the tile.
//
// Bound on the H100: operations (4 * D flops per attended (query, key)
// pair), against bytes that are read once.  This first version computes on
// the CUDA cores in fp32: one block of 128 threads per (batch * head,
// 64-query tile) loops over the 64-key tiles on or below the diagonal and
// inside the window, skipping the rest.  Q, K and V tiles sit in shared
// memory; each thread keeps a 4 x 8 tile of scores and a 4 x D/8 tile of
// the output accumulator in registers, with the running max and sum in
// fp32.  Tensor cores (mma.sync / wgmma) and TMA pipelining are later work.
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
constexpr int kMaxD = 128;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, glob;
  float logit_cap, scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(FlashArgs a) {
  constexpr int E = Word<T>::N;
  constexpr int kMaxWC = kMaxD / E / 8;        // output words per thread
  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_lo = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 8;                      // row group: rows ty*4 + i
  const int tx = tid % 8;                      // column lane
  const int W = a.D / E;
  const int nwc = W / 8;
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
  const int kt_end = a.causal ? q_hi / kBK + 1 : (a.S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (a.window > 0 && !a.glob && q_lo - a.window + 1 > 0) {
    kt_begin = (q_lo - a.window + 1) / kBK;
  }
  const char* kb = static_cast<const char*>(a.k) + (b * a.k_sb + hk * a.k_sh) * sizeof(T);
  const char* vb = static_cast<const char*>(a.v) + (b * a.v_sb + hk * a.v_sh) * sizeof(T);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBK;
    const int kvalid = min(kBK, a.S - k_lo);
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
        const bool valid = kpos < a.S && (!a.causal || kpos <= qpos) &&
                           (a.window == 0 || a.glob || kpos > qpos - a.window);
        ok |= static_cast<unsigned>(valid) << j;
        s[i][j] = valid ? x : kNegInf;
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
        if (j < nwc) {
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
      const float d = fmaxf(l[i], 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          static_cast<T*>(a.out) + b * a.o_sb + qpos * a.o_ss + h * a.o_sh);
#pragma unroll
      for (int j = 0; j < kMaxWC; ++j) {
        if (j < nwc) {
          float vals[E];
#pragma unroll
          for (int e = 0; e < E; ++e) vals[e] = acc[i][j][e] / d;
          orow[tx + 8 * j] = Word<T>::pack(vals);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const int pitch = a.D / Word<T>::N + 1;
  const size_t bytes = 4 * (static_cast<size_t>(kBQ + 2 * kBK) * pitch +
                            static_cast<size_t>(kBQ) * (kBK + 1));
  cudaError_t err = allow_smem(flash_attention_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * a.Hq, (a.S + kBQ - 1) / kBQ);
  flash_attention_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Plain C entry point.  q: (B, S, Hq, D), k, v: (B, S, Hkv, D), out:
// (B, S, Hq, D), each with its (batch, seq, head) strides and a unit
// stride on D.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, int causal, int window, int glob, float logit_cap,
    int dtype, void* stream) {
  using namespace repro;
  FlashArgs a{q, k, v, out, S, Hq, Hkv, D,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              o_sb, o_ss, o_sh, causal, window, glob, logit_cap,
              1.0f / sqrtf(static_cast<float>(D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return 0;
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(a, B, s));
  if (dtype == kF32) return static_cast<int>(launch<float>(a, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
