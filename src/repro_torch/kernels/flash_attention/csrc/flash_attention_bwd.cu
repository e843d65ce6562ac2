// Flash-attention backward for training, sm_90a.
//
// The reference trains attention through layers.blockwise_attention, a
// jax.custom_vjp whose backward, _flash_bwd (src/repro/models/layers.py),
// recomputes each block's scores from the saved (q, k, v, out, lse) instead
// of storing the probabilities.  The Pallas kernel
// src/repro/kernels/flash_attention/kernel.py implements that contract's
// forward; this file is the backward's counterpart.  Contract: q, dout,
// dq (B, S, Hq, D) and k, v, dk, dv (B, S, Hkv, D), contiguous in the JAX
// layout; GQA by head index (kv head = h / G, multi-query included);
// causal or bidirectional; S that is not a multiple of the tile; head dims
// up to 128 whose rows are whole 16-byte chunks; fp32 or bf16.  The
// wrapper raises on a window, a logit cap and key padding.
//
// Arithmetic, as the reference's: s = scale * q.k in fp32; p = exp(s -
// lse); dv += p^T . dout with p rounded to v's dtype; dp = dout . v^T;
// ds = p (dp - delta) with the fp32 p, rounded to k's dtype; dq += ds . k
// and dk += ds^T . q, both times scale; sums in fp32, each output rounded
// once.  delta = rowsum(dout * out) in fp32 comes from the wrapper.
//
// Bound on the H100: operations, about 8 D flops per attended (query,
// key) pair for the four products (the scores are recomputed once more).
// This first version runs on the CUDA cores in fp32 for both dtypes and
// is deterministic, with no atomics, in two launches:
//
// - dk/dv: one block of 256 threads per (batch * kv head, 64-key tile).
//   K and V stay in shared memory; the block loops over the G query heads
//   of its kv head and, for each, over the query tiles at or below the
//   diagonal, so the group's sum is folded in registers.  Each thread
//   holds a 4 x 4 tile of the transposed scores and a 4 x (D / 16) tile of
//   each of dK and dV.
// - dq: one block per (batch * query head, 64-query tile), looping over
//   the key tiles at or below the diagonal.
//
// Tiles sit in shared memory as fp32 rows padded by one word, so that a
// warp reading one column of 16 rows hits 16 banks.  Tensor-core products
// (the forward's mma.sync tiles) are the next step.
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kBwdThreads = 256;
constexpr int kT = 64;      // query or key rows per tile: 16 row groups x 4
constexpr int kR = 4;       // tile rows per thread
constexpr int kC = 4;       // score columns per thread: 16 lanes x 4
constexpr int kPP = kT + 1; // pitch of a score tile in shared memory

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, S, Hq)
  const float* delta;   // (B, S, Hq)
  void* dq;
  void* dk;
  void* dv;
  int S, Hq, Hkv, D, causal;
  float scale;
};

template <typename T> __device__ inline float to_f(T x);
template <> __device__ inline float to_f<float>(float x) { return x; }
template <> __device__ inline float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kT rows of D values from `src` (row r at src + r * stride) into shared
// memory as fp32 with pitch D + 1; rows at or past `valid` are zero.
template <typename T>
__device__ inline void load_tile(float* dst, const T* src, long long stride,
                                 int valid, int D, int tid) {
  const int P = D + 1;
  for (int c = tid; c < kT * D; c += kBwdThreads) {
    const int r = c / D;
    const int d = c - r * D;
    dst[r * P + d] = r < valid ? to_f<T>(src[r * stride + d]) : 0.f;
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

// dK and dV of one 64-key tile of one kv head, summed over its query heads.
template <typename T, int kJ>   // head-dim columns per thread: D <= 16 kJ
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv(BwdArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int hk = bh - b * a.Hkv;
  const int G = a.Hq / a.Hkv;
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
  float* Ps = Os + kT * P;          // p, [key][query], rounded to T
  float* Ss = Ps + kT * kPP;        // ds, [key][query], rounded to T
  float* Ls = Ss + kT * kPP;        // lse of the tile's queries
  float* Dl = Ls + kT;              // delta

  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long q_row = static_cast<long long>(a.Hq) * D;
  const int kvalid = min(kT, a.S - k_lo);
  const long long kv_off = (static_cast<long long>(b) * a.S + k_lo) * kv_row + hk * D;
  load_tile(Ks, static_cast<const T*>(a.k) + kv_off, kv_row, kvalid, D, tid);
  load_tile(Vs, static_cast<const T*>(a.v) + kv_off, kv_row, kvalid, D, tid);

  float dk[kR][kJ], dv[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nqt = (a.S + kT - 1) / kT;
  const int qt0 = a.causal ? blockIdx.y : 0;    // tiles at or below the diagonal
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q_lo = qt * kT;
      const int qvalid = min(kT, a.S - q_lo);
      const long long q_off = (static_cast<long long>(b) * a.S + q_lo) * q_row + h * D;
      __syncthreads();   // the previous tile's readers are done
      load_tile(Qs, static_cast<const T*>(a.q) + q_off, q_row, qvalid, D, tid);
      load_tile(Os, static_cast<const T*>(a.dout) + q_off, q_row, qvalid, D, tid);
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
          const bool ok = kr < kvalid && qc < qvalid && (!a.causal || kpos <= qpos);
          const float p = ok ? expf(s[i][c] * a.scale - Ls[qc]) : 0.f;
          const float ds = ok ? p * (dp[i][c] - Dl[qc]) : 0.f;
          Ps[kr * kPP + qc] = Word<T>::round(p);
          Ss[kr * kPP + qc] = Word<T>::round(ds);
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

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int kr = ty * kR + i;
    if (kr < kvalid) {
      T* dkr = static_cast<T*>(a.dk) + kv_off + kr * kv_row;
      T* dvr = static_cast<T*>(a.dv) + kv_off + kr * kv_row;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) {
          dkr[col] = from_f<T>(dk[i][j] * a.scale);
          dvr[col] = from_f<T>(dv[i][j]);
        }
      }
    }
  }
}

// dQ of one 64-query tile of one query head.
template <typename T, int kJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq(BwdArgs a) {
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
  float* Ss = Vs + kT * P;          // ds, [query][key], rounded to T
  float* Ls = Ss + kT * kPP;
  float* Dl = Ls + kT;

  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long q_row = static_cast<long long>(a.Hq) * D;
  const int qvalid = min(kT, a.S - q_lo);
  const long long q_off = (static_cast<long long>(b) * a.S + q_lo) * q_row + h * D;
  load_tile(Qs, static_cast<const T*>(a.q) + q_off, q_row, qvalid, D, tid);
  load_tile(Os, static_cast<const T*>(a.dout) + q_off, q_row, qvalid, D, tid);
  if (tid < kT) {
    const long long r = (static_cast<long long>(b) * a.S + q_lo + tid) * a.Hq + h;
    Ls[tid] = tid < qvalid ? a.lse[r] : 0.f;
    Dl[tid] = tid < qvalid ? a.delta[r] : 0.f;
  }

  float dq[kR][kJ];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dq[i][j] = 0.f;

  const int nkt = (a.S + kT - 1) / kT;
  const int kt_end = a.causal ? min(nkt, blockIdx.y + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k_lo = kt * kT;
    const int kvalid = min(kT, a.S - k_lo);
    const long long kv_off = (static_cast<long long>(b) * a.S + k_lo) * kv_row + hk * D;
    __syncthreads();   // the previous tile's readers are done
    load_tile(Ks, static_cast<const T*>(a.k) + kv_off, kv_row, kvalid, D, tid);
    load_tile(Vs, static_cast<const T*>(a.v) + kv_off, kv_row, kvalid, D, tid);
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
        const bool ok = qr < qvalid && kc < kvalid && (!a.causal || kpos <= qpos);
        const float p = ok ? expf(s[i][c] * a.scale - Ls[qr]) : 0.f;
        Ss[qr * kPP + kc] = ok ? Word<T>::round(p * (dp[i][c] - Dl[qr])) : 0.f;
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
      T* row = static_cast<T*>(a.dq) + q_off + qr * q_row;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) row[col] = from_f<T>(dq[i][j] * a.scale);
      }
    }
  }
}

template <typename T, int kJ>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  const int P = a.D + 1;
  const int nt = (a.S + kT - 1) / kT;
  const size_t dkdv_bytes =
      sizeof(float) * (4 * kT * P + 2 * kT * kPP + 2 * kT);
  const size_t dq_bytes = sizeof(float) * (4 * kT * P + kT * kPP + 2 * kT);
  cudaError_t err = allow_smem(&flash_bwd_dkdv<T, kJ>, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(&flash_bwd_dq<T, kJ>, dq_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, kJ><<<dim3(B * a.Hkv, nt), kBwdThreads, dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, kJ><<<dim3(B * a.Hq, nt), kBwdThreads, dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Plain C entry point.  q, dout, dq: contiguous (B, S, Hq, D); k, v, dk,
// dv: contiguous (B, S, Hkv, D); lse, delta: contiguous (B, S, Hq) fp32.
// Launches the dk/dv kernel, then the dq kernel, on `stream`; returns
// cudaGetLastError() after them.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int B, int S, int Hq, int Hkv, int D, int causal, int dtype,
    void* stream) {
  using namespace repro;
  BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, S, Hq, Hkv, D, causal,
            1.0f / sqrtf(static_cast<float>(D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return 0;
  if (D <= 0 || D > 128 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (D <= 64) return static_cast<int>(launch_bwd<__nv_bfloat16, 4>(a, B, s));
    return static_cast<int>(launch_bwd<__nv_bfloat16, 8>(a, B, s));
  }
  if (dtype == kF32) {
    if (D <= 64) return static_cast<int>(launch_bwd<float, 4>(a, B, s));
    return static_cast<int>(launch_bwd<float, 8>(a, B, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
