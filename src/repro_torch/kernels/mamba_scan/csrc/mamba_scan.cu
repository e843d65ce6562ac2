// Mamba-1 decode step and prefill selective scan for sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/mamba_scan/kernel.py:
//
// * mamba_step_kernel / _step_kernel, the fused single-token step.  The
//   Pallas kernel keeps every weight whole in VMEM, one slot row per grid
//   step.  At falcon-mamba-7b width the weights are 211 MB per layer in
//   bf16 (in_proj alone 134 MB), so on the H100 the step is bound by the
//   weight bytes (0.063 ms per layer at 3.35 TB/s) and the weights must
//   stream from device memory once for all slot rows together.  The step
//   also has two cross-channel dependencies: x_proj reduces over all d_in
//   channels before dt, B and C exist, and dt_proj expands dt back to d_in
//   channels.  So one call is eight launches on one stream:
//
//     1. in_proj    skinny product, fp32 partial sums per K split
//     2. conv       sum the partials, round xz; conv-window shift (in
//                   place), depthwise conv in fp32, SiLU, round -> x_conv
//     3. x_proj     skinny product of x_conv
//     4. dbc        sum the partials, round -> (dt_raw, B, C)
//     5. dt_proj    skinny product of dt_raw
//     6. ssm        sum, round, + dt_bias, softplus; h = exp(dt A) h +
//                   dt x B on the fp32 state (in place); y = C.h + D x;
//                   gate by SiLU(z), round
//     7. out_proj   skinny product of y
//     8. out        sum the partials, round; dead rows write zeros
//
//   The skinny product streams each weight row once for up to eight slot
//   rows (16-byte loads, neighbouring threads on neighbouring columns),
//   keeps the rows' activations in shared memory and accumulates in fp32.
//   K is split across blocks so that every product fills the card; the
//   partial sums go to scratch and the next launch adds them in a fixed
//   order, so the result does not depend on scheduling.  No library
//   product is called.  Rounding points are the reference's
//   (src/repro/kernels/mamba_scan/ref.py:22-42).  Dead rows (live == 0)
//   read and write no state: their conv window and h stay bit for bit
//   unchanged, and their output is zero.  The caches are updated in place,
//   so a dead row is never written.
//
// * mamba_scan / _scan_kernel, the selective scan of a prefill.  The
//   Pallas kernel walks the sequence as a sequential grid axis with the
//   state in VMEM scratch; here a loop over time inside the block takes its
//   place, so no state crosses blocks.  One block holds 32 channels of one
//   row; each channel's N states are spread over N / 2 lanes, two states
//   in registers each, and y's sum over states is a shuffle reduction.
//   Time steps are staged 64 at a time in shared memory (x, dt, B, C) and
//   y leaves through shared memory, so global accesses stay coalesced.  It
//   takes any S and also returns the last state, which the prefill stores
//   in the cache.  Bound at S = 1024, d_in = 8192, N = 16: 85 MB (0.025
//   ms) against 134 M exponentials on the special-function units (about
//   0.03 ms).
#include <type_traits>

#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// scalar helpers
// ---------------------------------------------------------------------------

template <typename T> __device__ inline float to_f(T v);
template <> __device__ inline float to_f<float>(float v) { return v; }
template <> __device__ inline float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ inline T from_f(float v);
template <> __device__ inline float from_f<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ inline float silu(float x) { return x / (1.f + expf(-x)); }

// jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
__device__ inline float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// ---------------------------------------------------------------------------
// skinny product: part[s, b, n] = sum_{k in split s} x[b, k] * w[k, n]
// ---------------------------------------------------------------------------

constexpr int kRows = 8;          // slot rows per block (grid.z walks more)
constexpr int kColThreads = 8;    // threads across a tile's columns
constexpr int kKGroups = 32;      // threads across K
constexpr int kGemmThreads = kColThreads * kKGroups;
constexpr int kStageK = 1024;     // K rows of x staged in shared memory
constexpr int kLoads = 8;         // weight rows a thread has in flight
constexpr int kGemmWarps = kGemmThreads / 32;

struct GemmArgs {
  const void* x;      // (B, K) rows with stride ldx (elements)
  const void* w;      // (K, N) row-major, contiguous
  float* part;        // (splits, B, N)
  int B, K, N;
  long long ldx;
  int k_per_split;
};

// V columns of a weight row per thread: 16 bytes of T on the vector path
// (read through the non-coherent cache, each weight once), one otherwise.
template <typename T, int V>
using RawCols = std::conditional_t<V == 1, T, uint4>;

template <typename T, int V>
__device__ inline RawCols<T, V> load_raw(const T* p) {
  if constexpr (V == 1) {
    return p[0];
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int V>
__device__ inline void unpack_raw(const RawCols<T, V>& raw, float* out) {
  if constexpr (V == 1) {
    out[0] = to_f<T>(raw);
  } else {
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) Word<T>::unpack(words[i], out + i * Word<T>::N);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kGemmThreads)
mamba_step_gemm_kernel(GemmArgs a) {
  constexpr int TN = kColThreads * V;
  using Raw = RawCols<T, V>;
  static_assert(kStageK * kRows >= kGemmWarps * kRows * TN, "reduction room");
  __shared__ __align__(16) float xs[kStageK * kRows];   // [k][row]

  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int kg = tid / kColThreads;
  const int n0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, a.B - r0);
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int col = n0 + ct * V;
  const bool full = col + V <= a.N;   // a tile's columns are all in or out
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w) + col;

  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  for (int kk = k_begin; kk < k_end; kk += kStageK) {
    const int klen = min(kStageK, k_end - kk);
    __syncthreads();   // the previous stage's readers are done
    for (int i = tid; i < kRows * klen; i += kGemmThreads) {
      const int r = i / klen;
      const int k = i - r * klen;
      xs[k * kRows + r] = r < rows
          ? to_f<T>(x[(r0 + r) * a.ldx + kk + k]) : 0.f;
    }
    __syncthreads();
    // each thread issues kLoads weight rows before it computes on them,
    // so enough bytes are in flight to cover the memory latency
    for (int k0 = kg; k0 < klen; k0 += kKGroups * kLoads) {
      Raw raw[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + u * kKGroups;
        raw[u] = full && k < klen
            ? load_raw<T, V>(w + static_cast<long long>(kk + k) * a.N)
            : Raw{};
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + u * kKGroups;
        if (k >= klen) break;
        float wv[V];
        unpack_raw<T, V>(raw[u], wv);
        const float4 xa = *reinterpret_cast<const float4*>(xs + k * kRows);
        const float4 xb = *reinterpret_cast<const float4*>(xs + k * kRows + 4);
        const float xr[kRows] = {xa.x, xa.y, xa.z, xa.w,
                                 xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xr[r], wv[v], acc[r][v]);
      }
    }
  }

  // sum the four K groups of a warp (lane bits 3 and 4), then the warps
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float s = acc[r][v];
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      acc[r][v] = s;
    }
  __syncthreads();   // xs is reused for the reduction
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (lane < kColThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        xs[(warp * kRows + r) * TN + lane * V + v] = acc[r][v];
  }
  __syncthreads();
  for (int i = tid; i < kRows * TN; i += kGemmThreads) {
    const int r = i / TN;
    const int c = i - r * TN;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kGemmWarps; ++wp) s += xs[(wp * kRows + r) * TN + c];
    const int n = n0 + c;
    if (r < rows && n < a.N) {
      a.part[(static_cast<long long>(split) * a.B + r0 + r) * a.N + n] = s;
    }
  }
}

template <typename T>
cudaError_t skinny_gemm(const void* x, long long ldx, const void* w,
                        float* part, int B, int K, int N, int splits,
                        cudaStream_t stream) {
  GemmArgs a{x, w, part, B, K, N, ldx, (K + splits - 1) / splits};
  const dim3 rows_grid(1, splits, (B + kRows - 1) / kRows);
  constexpr int V = 4 * Word<T>::N;
  if (N % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const dim3 grid((N + kColThreads * V - 1) / (kColThreads * V),
                    rows_grid.y, rows_grid.z);
    mamba_step_gemm_kernel<T, V><<<grid, kGemmThreads, 0, stream>>>(a);
  } else {
    const dim3 grid((N + kColThreads - 1) / kColThreads, rows_grid.y,
                    rows_grid.z);
    mamba_step_gemm_kernel<T, 1><<<grid, kGemmThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// step epilogues: one thread per (row, channel)
// ---------------------------------------------------------------------------

constexpr int kEpiThreads = 256;
constexpr int kMaxConv = 8;       // conv width the kernel takes

__device__ inline float sum_splits(const float* part, int splits, int B,
                                   long long width, int b, long long n) {
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(sp * B + b) * width + n];
  return s;
}

struct ConvArgs {
  const float* part;   // (splits, B, 2 d_in) in_proj partials
  const int* live;
  void* conv;          // (B, w-1, d_in), strides (conv_sb, conv_sw, 1)
  const float* conv_w; // (w, d_in)
  const float* conv_b; // (d_in,)
  void* xconv;         // (B, d_in)
  void* z;             // (B, d_in)
  int splits, B, d_in, w;
  long long conv_sb, conv_sw;
};

template <typename T>
__global__ void __launch_bounds__(kEpiThreads) mamba_step_conv_kernel(ConvArgs a) {
  const int c = blockIdx.x * kEpiThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= a.d_in) return;
  T* xo = static_cast<T*>(a.xconv) + static_cast<long long>(b) * a.d_in + c;
  T* zo = static_cast<T*>(a.z) + static_cast<long long>(b) * a.d_in + c;
  if (a.live[b] == 0) {   // dead row: its conv window is never touched
    *xo = from_f<T>(0.f);
    *zo = from_f<T>(0.f);
    return;
  }
  const long long width = 2LL * a.d_in;
  const float xp = Word<T>::round(sum_splits(a.part, a.splits, a.B, width, b, c));
  const float zs = sum_splits(a.part, a.splits, a.B, width, b, a.d_in + c);
  T* cv = static_cast<T*>(a.conv) + b * a.conv_sb + c;
  float win[kMaxConv];
#pragma unroll
  for (int j = 0; j < kMaxConv; ++j) {
    if (j < a.w - 1) win[j] = to_f<T>(cv[j * a.conv_sw]);
    else if (j == a.w - 1) win[j] = xp;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxConv; ++j) {
    if (j < a.w) acc = fmaf(win[j], a.conv_w[static_cast<long long>(j) * a.d_in + c], acc);
  }
  acc += a.conv_b[c];
  // the window shifts by one and keeps the pre-conv input
#pragma unroll
  for (int j = 0; j < kMaxConv - 1; ++j) {
    if (j < a.w - 1) cv[j * a.conv_sw] = from_f<T>(win[j + 1]);
  }
  *xo = from_f<T>(silu(acc));
  *zo = from_f<T>(zs);
}

struct RoundArgs {
  const float* part;   // (splits, B, width)
  const int* live;     // null: every row
  void* out;           // (B, width)
  int splits, B, width;
};

template <typename T>
__global__ void __launch_bounds__(kEpiThreads) mamba_step_round_kernel(RoundArgs a) {
  const int n = blockIdx.x * kEpiThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= a.width) return;
  T* o = static_cast<T*>(a.out) + static_cast<long long>(b) * a.width + n;
  if (a.live != nullptr && a.live[b] == 0) {
    *o = from_f<T>(0.f);
    return;
  }
  *o = from_f<T>(sum_splits(a.part, a.splits, a.B, a.width, b, n));
}

struct SsmArgs {
  const float* part;   // (splits, B, d_in) dt_proj partials
  const int* live;
  const void* dbc;     // (B, R + 2N)
  const void* xconv;   // (B, d_in)
  const void* z;       // (B, d_in)
  const float* dt_bias;
  const float* a_log;  // (d_in, N)
  const float* d;
  float* h;            // (B, d_in, N), strides (h_sb, N, 1)
  void* y;             // (B, d_in)
  int splits, B, d_in, R;
  long long h_sb;
};

template <typename T, int N>
__global__ void __launch_bounds__(kEpiThreads) mamba_step_ssm_kernel(SsmArgs a) {
  const int c = blockIdx.x * kEpiThreads + threadIdx.x;
  const int b = blockIdx.y;
  T* yo = static_cast<T*>(a.y) + static_cast<long long>(b) * a.d_in + c;
  if (a.live[b] == 0) {   // uniform over the block: the row's h is untouched
    if (c < a.d_in) *yo = from_f<T>(0.f);
    return;
  }
  __shared__ float bc[2 * N];
  const T* dbc = static_cast<const T*>(a.dbc) +
                 static_cast<long long>(b) * (a.R + 2 * N) + a.R;
  if (threadIdx.x < 2 * N) bc[threadIdx.x] = to_f<T>(dbc[threadIdx.x]);
  __syncthreads();
  if (c >= a.d_in) return;
  const float dtp = Word<T>::round(
      sum_splits(a.part, a.splits, a.B, a.d_in, b, c));
  const float dt = softplus(dtp + a.dt_bias[c]);
  const long long bc_off = static_cast<long long>(b) * a.d_in + c;
  const float xc = to_f<T>(static_cast<const T*>(a.xconv)[bc_off]);
  const float zf = to_f<T>(static_cast<const T*>(a.z)[bc_off]);
  const float dx = dt * xc;
  float* hp = a.h + b * a.h_sb + static_cast<long long>(c) * N;
  const float* al = a.a_log + static_cast<long long>(c) * N;
  float hv[N];
  float av[N];
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 hq = *reinterpret_cast<const float4*>(hp + i);
    const float4 aq = *reinterpret_cast<const float4*>(al + i);
    hv[i] = hq.x; hv[i + 1] = hq.y; hv[i + 2] = hq.z; hv[i + 3] = hq.w;
    av[i] = aq.x; av[i + 1] = aq.y; av[i + 2] = aq.z; av[i + 3] = aq.w;
  }
  float y = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float da = expf(dt * -expf(av[n]));
    hv[n] = da * hv[n] + dx * bc[n];
    y = fmaf(hv[n], bc[N + n], y);
  }
  y += a.d[c] * xc;
  *yo = from_f<T>(y * silu(zf));
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    *reinterpret_cast<float4*>(hp + i) =
        make_float4(hv[i], hv[i + 1], hv[i + 2], hv[i + 3]);
  }
}

struct StepArgs {
  const void* x1;       // (B, d_model)
  void* conv;
  float* h;
  const int* live;
  const void* in_proj;  // (d_model, 2 d_in)
  const float* conv_w;
  const float* conv_b;
  const void* x_proj;   // (d_in, R + 2N)
  const void* dt_proj;  // (R, d_in)
  const float* dt_bias;
  const float* a_log;
  const float* d;
  const void* out_proj; // (d_in, d_model)
  void* out;            // (B, d_model)
  float* part;          // fp32 scratch for the partial sums
  void* act;            // scratch: x_conv, z, y (B, d_in) and dbc (B, R+2N)
  int B, d_model, d_in, R, N, w;
  long long conv_sb, conv_sw, h_sb;
  int splits[4];
};

#define REPRO_TRY(expr)                          \
  do {                                           \
    const cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

template <typename T, int N>
cudaError_t step(const StepArgs& a, cudaStream_t s) {
  T* act = static_cast<T*>(a.act);
  T* xconv = act;
  T* z = xconv + static_cast<long long>(a.B) * a.d_in;
  T* y = z + static_cast<long long>(a.B) * a.d_in;
  T* dbc = y + static_cast<long long>(a.B) * a.d_in;
  const int wdbc = a.R + 2 * N;
  const dim3 chan((a.d_in + kEpiThreads - 1) / kEpiThreads, a.B);

  REPRO_TRY(skinny_gemm<T>(a.x1, a.d_model, a.in_proj, a.part, a.B,
                           a.d_model, 2 * a.d_in, a.splits[0], s));
  ConvArgs ca{a.part, a.live, a.conv, a.conv_w, a.conv_b, xconv, z,
              a.splits[0], a.B, a.d_in, a.w, a.conv_sb, a.conv_sw};
  mamba_step_conv_kernel<T><<<chan, kEpiThreads, 0, s>>>(ca);
  REPRO_TRY(cudaGetLastError());

  REPRO_TRY(skinny_gemm<T>(xconv, a.d_in, a.x_proj, a.part, a.B, a.d_in,
                           wdbc, a.splits[1], s));
  RoundArgs ra{a.part, nullptr, dbc, a.splits[1], a.B, wdbc};
  mamba_step_round_kernel<T><<<dim3((wdbc + kEpiThreads - 1) / kEpiThreads, a.B),
                    kEpiThreads, 0, s>>>(ra);
  REPRO_TRY(cudaGetLastError());

  REPRO_TRY(skinny_gemm<T>(dbc, wdbc, a.dt_proj, a.part, a.B, a.R, a.d_in,
                           a.splits[2], s));
  SsmArgs sa{a.part, a.live, dbc, xconv, z, a.dt_bias, a.a_log, a.d, a.h, y,
             a.splits[2], a.B, a.d_in, a.R, a.h_sb};
  mamba_step_ssm_kernel<T, N><<<chan, kEpiThreads, 0, s>>>(sa);
  REPRO_TRY(cudaGetLastError());

  REPRO_TRY(skinny_gemm<T>(y, a.d_in, a.out_proj, a.part, a.B, a.d_in,
                           a.d_model, a.splits[3], s));
  RoundArgs oa{a.part, a.live, a.out, a.splits[3], a.B, a.d_model};
  mamba_step_round_kernel<T><<<dim3((a.d_model + kEpiThreads - 1) / kEpiThreads, a.B),
                    kEpiThreads, 0, s>>>(oa);
  return cudaGetLastError();
}

template <typename T>
cudaError_t step_for_n(const StepArgs& a, cudaStream_t s) {
  switch (a.N) {
    case 4: return step<T, 4>(a, s);
    case 8: return step<T, 8>(a, s);
    case 16: return step<T, 16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// prefill selective scan
// ---------------------------------------------------------------------------

constexpr int kScanChannels = 32;     // channels per block
constexpr int kScanSteps = 64;        // time steps staged per pass
constexpr int kStatesPerLane = 2;    // N / 2 lanes per channel

struct ScanArgs {
  const void* x;        // (B, S, D), strides (x_sb, x_ss, 1)
  const float* dt;      // (B, S, D), strides (dt_sb, dt_ss, 1)
  const void* bm;       // (B, S, N), strides (b_sb, b_ss, 1)
  const void* cm;       // (B, S, N), strides (c_sb, c_ss, 1)
  const float* a_log;   // (D, N)
  const float* d;       // (D,)
  float* y;             // (B, S, D) contiguous
  float* h_last;        // (B, D, N) contiguous
  int S, D;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

template <typename T, int N>
__global__ void __launch_bounds__(kScanChannels * N / kStatesPerLane)
mamba_scan_kernel(ScanArgs a) {
  constexpr int G = N / kStatesPerLane;           // lanes per channel
  constexpr int THREADS = kScanChannels * G;
  __shared__ float xs[kScanSteps][kScanChannels];
  __shared__ float dts[kScanSteps][kScanChannels];
  __shared__ float ys[kScanSteps][kScanChannels];
  __shared__ float bs[kScanSteps][N];
  __shared__ float cs[kScanSteps][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kScanChannels;
  const int tid = threadIdx.x;
  const int cl = tid / G;
  const int g = tid - cl * G;
  const int c = c0 + cl;
  const bool active = c < a.D;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb;
  const float* dt = a.dt + b * a.dt_sb;
  const T* bm = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cm = static_cast<const T*>(a.cm) + b * a.c_sb;

  float A[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int i = 0; i < kStatesPerLane; ++i) {
    const int n = g * kStatesPerLane + i;
    A[i] = active ? -expf(a.a_log[static_cast<long long>(c) * N + n]) : 0.f;
    h[i] = 0.f;
  }
  const float dd = active ? a.d[c] : 0.f;

  for (int t0 = 0; t0 < a.S; t0 += kScanSteps) {
    const int steps = min(kScanSteps, a.S - t0);
    __syncthreads();   // the previous pass's y has left shared memory
    for (int i = tid; i < steps * kScanChannels; i += THREADS) {
      const int t = i / kScanChannels;
      const int j = i - t * kScanChannels;
      const bool ok = c0 + j < a.D;
      const long long tt = t0 + t;
      xs[t][j] = ok ? to_f<T>(x[tt * a.x_ss + c0 + j]) : 0.f;
      dts[t][j] = ok ? dt[tt * a.dt_ss + c0 + j] : 0.f;
    }
    for (int i = tid; i < steps * N; i += THREADS) {
      const int t = i / N;
      const int n = i - t * N;
      const long long tt = t0 + t;
      bs[t][n] = to_f<T>(bm[tt * a.b_ss + n]);
      cs[t][n] = to_f<T>(cm[tt * a.c_ss + n]);
    }
    __syncthreads();
    // unrolled: the exponentials of later steps do not wait on h
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t][cl];
      const float xv = xs[t][cl];
      const float dx = dtv * xv;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kStatesPerLane; ++i) {
        const int n = g * kStatesPerLane + i;
        h[i] = expf(dtv * A[i]) * h[i] + dx * bs[t][n];
        part = fmaf(h[i], cs[t][n], part);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (g == 0) ys[t][cl] = part + dd * xv;
    }
    __syncthreads();
    for (int i = tid; i < steps * kScanChannels; i += THREADS) {
      const int t = i / kScanChannels;
      const int j = i - t * kScanChannels;
      if (c0 + j < a.D) {
        a.y[(static_cast<long long>(b) * a.S + t0 + t) * a.D + c0 + j] = ys[t][j];
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kStatesPerLane; ++i) {
      a.h_last[(static_cast<long long>(b) * a.D + c) * N +
               g * kStatesPerLane + i] = h[i];
    }
  }
}

template <typename T, int N>
cudaError_t scan(const ScanArgs& a, int B, cudaStream_t s) {
  const dim3 grid((a.D + kScanChannels - 1) / kScanChannels, B);
  mamba_scan_kernel<T, N><<<grid, kScanChannels * N / kStatesPerLane, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan_for_n(const ScanArgs& a, int B, int N, cudaStream_t s) {
  switch (N) {
    case 4: return scan<T, 4>(a, B, s);
    case 8: return scan<T, 8>(a, B, s);
    case 16: return scan<T, 16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// Plain C entry points.  Returns cudaGetLastError() of the first launch
// that failed, else of the last.
//
// mamba_step: x1 (B, d_model); conv (B, w-1, d_in) strides (conv_sb,
// conv_sw, 1) and h (B, d_in, N) strides (h_sb, N, 1), both updated in
// place for live rows; live (B,) int32; weights contiguous in the
// activation dtype (in_proj (d_model, 2 d_in), x_proj (d_in, R + 2N),
// dt_proj (R, d_in), out_proj (d_in, d_model)); conv_w (w, d_in), conv_b,
// dt_bias, D (d_in,) and a_log (d_in, N) fp32; out (B, d_model).  part:
// fp32 scratch of max_i splits_i * B * N_i floats; act: activation-dtype
// scratch of B * (3 d_in + R + 2N) values.
extern "C" int mamba_step(
    const void* x1, void* conv, void* h, const void* live,
    const void* in_proj, const void* conv_w, const void* conv_b,
    const void* x_proj, const void* dt_proj, const void* dt_bias,
    const void* a_log, const void* d, const void* out_proj, void* out,
    void* part, void* act, int B, int d_model, int d_in, int R, int N, int w,
    long long conv_sb, long long conv_sw, long long h_sb, int split_in,
    int split_x, int split_dt, int split_out, int dtype, void* stream) {
  using namespace repro;
  if (B == 0) return 0;
  if (w < 1 || w > kMaxConv) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a{x1, conv, static_cast<float*>(h), static_cast<const int*>(live),
             in_proj, static_cast<const float*>(conv_w),
             static_cast<const float*>(conv_b), x_proj, dt_proj,
             static_cast<const float*>(dt_bias),
             static_cast<const float*>(a_log), static_cast<const float*>(d),
             out_proj, out, static_cast<float*>(part), act, B, d_model, d_in,
             R, N, w, conv_sb, conv_sw, h_sb,
             {split_in, split_x, split_dt, split_out}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return static_cast<int>(step_for_n<__nv_bfloat16>(a, s));
  if (dtype == kF32) return static_cast<int>(step_for_n<float>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// mamba_scan: x (B, S, D) in the activation dtype, strides (x_sb, x_ss, 1);
// dt (B, S, D) fp32, strides (dt_sb, dt_ss, 1); b, c (B, S, N) in the
// activation dtype, strides (sb, ss, 1); a_log (D, N) and d (D,) fp32 ->
// y (B, S, D) fp32 and h_last (B, D, N) fp32, both contiguous.
extern "C" int mamba_scan(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d, void* y, void* h_last, int B, int S,
    int D, int N, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, int dtype, void* stream) {
  using namespace repro;
  if (B == 0 || S == 0) return 0;
  ScanArgs a{x, static_cast<const float*>(dt), b, c,
             static_cast<const float*>(a_log), static_cast<const float*>(d),
             static_cast<float*>(y), static_cast<float*>(h_last), S, D,
             x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return static_cast<int>(scan_for_n<__nv_bfloat16>(a, B, N, s));
  if (dtype == kF32) return static_cast<int>(scan_for_n<float>(a, B, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
