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
//     1. in_proj    skinny product
//     2. conv       round xz; conv-window shift (in place), depthwise conv
//                   in fp32, SiLU, round -> x_conv
//     3. x_proj     skinny product of x_conv
//     4. dbc        round -> (dt_raw, B, C)
//     5. dt_proj    skinny product of dt_raw
//     6. ssm        round, + dt_bias, softplus; h = exp(dt A) h + dt x B on
//                   the fp32 state (in place); y = C.h + D x; gate by
//                   SiLU(z), round
//     7. out_proj   skinny product of y
//     8. out        round; dead rows write zeros
//
//   In bf16 each skinny product runs on the tensor cores (mma.sync with
//   the slot rows as the n = 8 operand), fed by a cp.async ring, and
//   streams its weight once for up to 32 slot rows.  The wrapper's plan()
//   cuts it into (64-column strip, K span) items that fill the card in one
//   even wave; K is split only where the strips cannot fill it.  An
//   unsplit product writes its rounded result; a split one writes fp32
//   partials that the next launch adds in split order, so the result does
//   not depend on scheduling (no atomics).  The eight launches are
//   programmatic dependents of each other: a product's weights start
//   streaming while the launch before it runs, and every kernel reads and
//   writes activations, state and scratch only after griddepcontrol.wait.
//   fp32 (the tests' reference check) and bf16 rows that are not 16-byte
//   aligned take a CUDA-core product (FMA on 16-byte loads, 8 slot rows
//   per pass).  No library product is called.  Rounding points are the
//   reference's (src/repro/kernels/mamba_scan/ref.py:22-42).  Dead rows
//   (live == 0) read and write no state: their conv window and h stay bit
//   for bit unchanged, and their output is zero.  The caches are updated
//   in place, so a dead row is never written.
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
// skinny products: out[b, n] = sum_k x[b, k] * w[k, n], one launch each
// ---------------------------------------------------------------------------

// How a product is cut, from the wrapper's plan(): route, K splits (1:
// the result is written rounded, in the activation dtype), K rows per
// split, and blocks (tensor-core route only).
enum Route : int { kFma = 0, kMma = 1 };
struct ProductPlan {
  int route, splits, span, grid;
};

// -- CUDA-core route: fp32, and bf16 whose rows are not 16-byte aligned --

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
  pdl_launch_dependents();
  pdl_wait();

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
cudaError_t skinny_fma(const void* x, long long ldx, const void* w,
                       float* part, int B, int K, int N,
                       const ProductPlan& p, cudaStream_t s, bool overlap) {
  GemmArgs a{x, w, part, B, K, N, ldx, p.span};
  const int row_groups = (B + kRows - 1) / kRows;
  constexpr int V = 4 * Word<T>::N;
  if (N % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const dim3 grid((N + kColThreads * V - 1) / (kColThreads * V), p.splits,
                    row_groups);
    return launch(mamba_step_gemm_kernel<T, V>, grid, dim3(kGemmThreads), 0,
                  s, overlap, a);
  }
  const dim3 grid((N + kColThreads - 1) / kColThreads, p.splits, row_groups);
  return launch(mamba_step_gemm_kernel<T, 1>, grid, dim3(kGemmThreads), 0, s,
                overlap, a);
}

// -- tensor-core route: bf16 with 16-byte aligned rows ---------------------
//
// A work item is (64-column strip, K span).  Its weight tile streams once
// through a ring of (128 x 64) stages in shared memory by
// 16-byte cp.async copies (128 contiguous bytes per weight row, the ragged
// column and K edges zero-filled), with the slot rows' x for the same K
// rows beside it.  The product runs on mma.sync m16n8k16 with A = W^T (16
// columns x 16 K, ldmatrix.trans from the row-major tile; chunks swizzled
// by row so the eight rows of a matrix hit distinct banks) and B = the
// slot rows as n-tiles of 8: NT n-tiles share each A fragment, so up to 8
// NT rows take one pass over the weights.  Four warps take two k-steps of
// each stage; their sums meet in shared memory in warp order.  The weight
// ring is started before pdl_wait(): under programmatic dependent launch
// the weights (which nothing in the step writes) stream while the launch
// before still runs, and x is read, and anything written, only after it.

constexpr int kMmaBN = 64;        // strip width: 128-byte weight rows
constexpr int kMmaBK = 128;       // weight rows per stage
constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaMaxNT = 4;      // up to 32 slot rows per pass
constexpr int kRowChunks = kMmaBN / 8;    // 16-byte chunks per weight row
constexpr int kMTiles = kMmaBN / 16;      // 16-column m-tiles per strip
constexpr int kWarpKSteps = kMmaBK / 16 / kMmaWarps;  // per warp per stage
constexpr int kWTileBytes = kMmaBK * kMmaBN * 2;
constexpr int kXPitch = kMmaBK * 2 + 16;  // bytes per x row (conflict-free)
constexpr int kRedPitch = kMmaBN + 4;     // floats per reduction row

template <int NT>
__host__ __device__ constexpr int mma_stage_bytes() {
  return kWTileBytes + NT * 8 * kXPitch;
}
// ring depth: 5 stages (80 KB of weights) in flight for 8 slot rows, two
// blocks per SM; 3 stages (48 KB) for more rows, still two blocks per SM
template <int NT>
__host__ __device__ constexpr int mma_stages() { return NT == 1 ? 6 : 4; }
template <int NT>
__host__ __device__ constexpr int mma_smem_bytes() {
  return mma_stages<NT>() * mma_stage_bytes<NT>();
}

struct MmaArgs {
  const __nv_bfloat16* x;   // this pass's rows of (B, K), stride ldx
  const __nv_bfloat16* w;   // (K, N) row-major
  float* part;              // (splits, B, N) fp32 partial sums, or
  __nv_bfloat16* out;       // (B, N) rounded result when splits == 1
  int B, r0, rows, K, N;
  long long ldx;
  int span, splits, items;
};

template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
mamba_step_mma_kernel(MmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(kMmaWarps * NT * 8 * kRedPitch * 4 <= mma_smem_bytes<NT>(),
                "reduction room");
  constexpr int kStages = mma_stages<NT>();
  pdl_launch_dependents();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  bool waited = false;

  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int strip = item / a.splits;
    const int split = item - strip * a.splits;
    const int n0 = strip * kMmaBN;
    const int kb = split * a.span;
    const int ke = min(a.K, kb + a.span);
    const int steps = (ke - kb + kMmaBK - 1) / kMmaBK;
    auto stage = [&](int s) {
      return smem + (s % kStages) * mma_stage_bytes<NT>();
    };
    auto load_w = [&](int s) {
      if (s >= steps) return;
      unsigned char* dst = stage(s);
      const int k0 = kb + s * kMmaBK;
      for (int c = tid; c < kMmaBK * kRowChunks; c += kMmaThreads) {
        const int r = c / kRowChunks;
        const int ch = c % kRowChunks;
        const int k = k0 + r;
        const int n = n0 + ch * 8;
        const bool ok = k < ke && n < a.N;
        cp_async16(dst + r * kMmaBN * 2 + ((ch ^ (r & 7)) * 16),
                   ok ? a.w + static_cast<long long>(k) * a.N + n : a.w, ok);
      }
    };
    auto load_x = [&](int s) {
      if (s >= steps) return;
      unsigned char* dst = stage(s) + kWTileBytes;
      const int k0 = kb + s * kMmaBK;
      constexpr int kChunks = kMmaBK / 8;
      for (int c = tid; c < NT * 8 * kChunks; c += kMmaThreads) {
        const int r = c / kChunks;
        const int ch = c % kChunks;
        const int k = k0 + ch * 8;
        const bool ok = r < a.rows && k < ke;
        cp_async16(dst + r * kXPitch + ch * 16,
                   ok ? a.x + r * a.ldx + k : a.x, ok);
      }
    };

    // prologue: weights first, then (after the wait) x; one commit group
    // per load, so the main loop waits on a fixed count
    for (int s = 0; s < kStages - 1; ++s) {
      load_w(s);
      cp_async_commit();
    }
    if (!waited) {
      pdl_wait();
      waited = true;
    }
    for (int s = 0; s < kStages - 1; ++s) {
      load_x(s);
      cp_async_commit();
    }

    float acc[kMTiles][NT][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();   // stage s's weights and x are in
      __syncthreads();                   // and stage s - 1 is consumed
      load_w(s + kStages - 1);
      load_x(s + kStages - 1);
      cp_async_commit();
      const unsigned char* ws = stage(s);
      const unsigned char* xs = ws + kWTileBytes;
#pragma unroll
      for (int j = 0; j < kWarpKSteps; ++j) {
        const int ks = warp * kWarpKSteps + j;
        uint32_t bx[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* p =
              xs + (nt * 8 + g) * kXPitch + (ks * 16 + 2 * t) * 2;
          bx[nt][0] = *reinterpret_cast<const uint32_t*>(p);
          bx[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
        const int mat = lane / 8;
        const int kr = ks * 16 + (lane % 8) + (mat >= 2 ? 8 : 0);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          const int ch = mt * 2 + (mat & 1);
          uint32_t af[4];
          ldmatrix_x4_trans(af,
                            ws + kr * kMmaBN * 2 + ((ch ^ (kr & 7)) * 16));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(acc[mt][nt], af, bx[nt][0], bx[nt][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the reduction

    // d0, d1: column g of the m-tile, rows 2t, 2t + 1; d2, d3: column g + 8
    float* red = reinterpret_cast<float*>(smem);   // [warp][row][col]
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* rw = red + (warp * NT * 8 + nt * 8 + 2 * t) * kRedPitch +
                    mt * 16 + g;
        rw[0] = acc[mt][nt][0];
        rw[kRedPitch] = acc[mt][nt][1];
        rw[8] = acc[mt][nt][2];
        rw[kRedPitch + 8] = acc[mt][nt][3];
      }
    __syncthreads();
    for (int o = tid; o < NT * 8 * kMmaBN; o += kMmaThreads) {
      const int b = o / kMmaBN;
      const int c = o % kMmaBN;
      const int n = n0 + c;
      float sum = 0.f;
#pragma unroll
      for (int wp = 0; wp < kMmaWarps; ++wp) {
        sum += red[(wp * NT * 8 + b) * kRedPitch + c];
      }
      if (b < a.rows && n < a.N) {
        const long long row = a.r0 + b;
        if (a.splits == 1) {
          a.out[row * a.N + n] = __float2bfloat16(sum);
        } else {
          a.part[(static_cast<long long>(split) * a.B + row) * a.N + n] = sum;
        }
      }
    }
    __syncthreads();   // the next item's ring overwrites the reduction
  }
  // a grid completes only after the launch before it, so that the launch
  // after it may wait on this one alone
  if (!waited) pdl_wait();
}

template <int NT>
cudaError_t mma_pass(const MmaArgs& a, int grid, cudaStream_t s,
                     bool overlap) {
  auto kernel = mamba_step_mma_kernel<NT>;
  constexpr int smem = mma_smem_bytes<NT>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(grid), dim3(kMmaThreads), smem, s, overlap, a);
}

cudaError_t skinny_mma(const void* x, long long ldx, const void* w,
                       float* part, void* out, int B, int K, int N,
                       const ProductPlan& p, cudaStream_t s, bool overlap) {
  if (N % 8 != 0 || K % 8 != 0 || ldx % 8 != 0 || p.span % kMmaBK != 0 ||
      p.splits < 1 || p.grid < 1 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int strips = (N + kMmaBN - 1) / kMmaBN;
  for (int r0 = 0; r0 < B; r0 += kMmaMaxNT * 8) {
    const int rows = min(kMmaMaxNT * 8, B - r0);
    const MmaArgs a{static_cast<const __nv_bfloat16*>(x) + r0 * ldx,
                    static_cast<const __nv_bfloat16*>(w), part,
                    static_cast<__nv_bfloat16*>(out), B, r0, rows, K, N, ldx,
                    p.span, p.splits, strips * p.splits};
    const cudaError_t e = rows <= 8    ? mma_pass<1>(a, p.grid, s, overlap)
                          : rows <= 16 ? mma_pass<2>(a, p.grid, s, overlap)
                                       : mma_pass<4>(a, p.grid, s, overlap);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// A product's result as the next launch reads it: fp32 partial sums per
// split, summed in split order, or the rounded activation-dtype output of
// an unsplit tensor-core product.
struct ProdOut {
  const float* part;     // (splits, B, width), or null
  const void* direct;    // (B, width), or null
  int splits;
};

template <typename T>
cudaError_t skinny(const void* x, long long ldx, const void* w, int B, int K,
                   int N, const ProductPlan& p, float*& part, T*& direct,
                   ProdOut& res, cudaStream_t s, bool overlap) {
  if (p.route == kMma && p.splits == 1) {
    res = ProdOut{nullptr, direct, 1};
    T* out = direct;
    direct += (static_cast<long long>(B) * N + 7) / 8 * 8;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return skinny_mma(x, ldx, w, nullptr, out, B, K, N, p, s, overlap);
    }
    return cudaErrorInvalidValue;
  }
  res = ProdOut{part, nullptr, p.splits};
  float* out = part;
  part += static_cast<long long>(p.splits) * B * N;
  if (p.route == kMma) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return skinny_mma(x, ldx, w, out, nullptr, B, K, N, p, s, overlap);
    }
    return cudaErrorInvalidValue;
  }
  return skinny_fma<T>(x, ldx, w, out, B, K, N, p, s, overlap);
}

// ---------------------------------------------------------------------------
// step epilogues: one thread per (row, channel)
// ---------------------------------------------------------------------------

constexpr int kEpiThreads = 256;
constexpr int kMaxConv = 8;       // conv width the kernel takes

template <typename T>
__device__ inline float prod_at(const ProdOut& p, int B, long long width,
                                int b, long long n) {
  if (p.direct != nullptr) {
    return to_f<T>(static_cast<const T*>(p.direct)[b * width + n]);
  }
  float s = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) s += p.part[(sp * B + b) * width + n];
  return s;
}

struct ConvArgs {
  ProdOut xz;          // in_proj's (B, 2 d_in)
  const int* live;
  void* conv;          // (B, w-1, d_in), strides (conv_sb, conv_sw, 1)
  const float* conv_w; // (w, d_in)
  const float* conv_b; // (d_in,)
  void* xconv;         // (B, d_in)
  void* z;             // (B, d_in)
  int B, d_in, w;
  long long conv_sb, conv_sw;
};

template <typename T>
__global__ void __launch_bounds__(kEpiThreads) mamba_step_conv_kernel(ConvArgs a) {
  pdl_launch_dependents();
  pdl_wait();
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
  const float xp = Word<T>::round(prod_at<T>(a.xz, a.B, width, b, c));
  const float zs = prod_at<T>(a.xz, a.B, width, b, a.d_in + c);
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
  ProdOut in;          // (B, width)
  const int* live;     // null: every row
  void* out;           // (B, width)
  int B, width;
};

template <typename T>
__global__ void __launch_bounds__(kEpiThreads) mamba_step_round_kernel(RoundArgs a) {
  pdl_launch_dependents();
  pdl_wait();
  const int n = blockIdx.x * kEpiThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= a.width) return;
  T* o = static_cast<T*>(a.out) + static_cast<long long>(b) * a.width + n;
  if (a.live != nullptr && a.live[b] == 0) {
    *o = from_f<T>(0.f);
    return;
  }
  *o = from_f<T>(prod_at<T>(a.in, a.B, a.width, b, n));
}

struct SsmArgs {
  ProdOut dt;          // dt_proj's (B, d_in)
  const int* live;
  const void* dbc;     // (B, R + 2N)
  const void* xconv;   // (B, d_in)
  const void* z;       // (B, d_in)
  const float* dt_bias;
  const float* a_log;  // (d_in, N)
  const float* d;
  float* h;            // (B, d_in, N), strides (h_sb, N, 1)
  void* y;             // (B, d_in)
  int B, d_in, R;
  long long h_sb;
};

template <typename T, int N>
__global__ void __launch_bounds__(kEpiThreads) mamba_step_ssm_kernel(SsmArgs a) {
  pdl_launch_dependents();
  pdl_wait();
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
  const float dtp = Word<T>::round(prod_at<T>(a.dt, a.B, a.d_in, b, c));
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
  float* part;          // fp32 scratch: the split products' partial sums
  void* prod;           // scratch: the unsplit products' rounded outputs
  void* act;            // scratch: x_conv, z, y (B, d_in) and dbc (B, R+2N)
  int B, d_model, d_in, R, N, w;
  long long conv_sb, conv_sw, h_sb;
  ProductPlan plan[4];  // in_proj, x_proj, dt_proj, out_proj
  bool overlap;
};

#define REPRO_TRY(expr)                          \
  do {                                           \
    const cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

// activation-dtype scratch regions start on 16-byte boundaries
inline long long pad8(long long n) { return (n + 7) / 8 * 8; }

template <typename T, int N>
cudaError_t step(const StepArgs& a, cudaStream_t s) {
  T* xconv = static_cast<T*>(a.act);
  T* z = xconv + pad8(static_cast<long long>(a.B) * a.d_in);
  T* y = z + pad8(static_cast<long long>(a.B) * a.d_in);
  T* dbc = y + pad8(static_cast<long long>(a.B) * a.d_in);
  const int wdbc = a.R + 2 * N;
  const dim3 chan((a.d_in + kEpiThreads - 1) / kEpiThreads, a.B);
  const dim3 epi(kEpiThreads);
  const bool ov = a.overlap;
  float* part = a.part;          // each product takes its own region
  T* direct = static_cast<T*>(a.prod);
  ProdOut r;

  REPRO_TRY(skinny<T>(a.x1, a.d_model, a.in_proj, a.B, a.d_model,
                      2 * a.d_in, a.plan[0], part, direct, r, s, ov));
  const ConvArgs ca{r, a.live, a.conv, a.conv_w, a.conv_b, xconv, z,
                    a.B, a.d_in, a.w, a.conv_sb, a.conv_sw};
  REPRO_TRY(launch(mamba_step_conv_kernel<T>, chan, epi, 0, s, ov, ca));

  REPRO_TRY(skinny<T>(xconv, a.d_in, a.x_proj, a.B, a.d_in, wdbc,
                      a.plan[1], part, direct, r, s, ov));
  const RoundArgs ra{r, nullptr, dbc, a.B, wdbc};
  REPRO_TRY(launch(mamba_step_round_kernel<T>,
                   dim3((wdbc + kEpiThreads - 1) / kEpiThreads, a.B), epi, 0,
                   s, ov, ra));

  REPRO_TRY(skinny<T>(dbc, wdbc, a.dt_proj, a.B, a.R, a.d_in, a.plan[2],
                      part, direct, r, s, ov));
  const SsmArgs sa{r, a.live, dbc, xconv, z, a.dt_bias, a.a_log, a.d, a.h, y,
                   a.B, a.d_in, a.R, a.h_sb};
  REPRO_TRY(launch(mamba_step_ssm_kernel<T, N>, chan, epi, 0, s, ov, sa));

  REPRO_TRY(skinny<T>(y, a.d_in, a.out_proj, a.B, a.d_in, a.d_model,
                      a.plan[3], part, direct, r, s, ov));
  const RoundArgs oa{r, a.live, a.out, a.B, a.d_model};
  return launch(mamba_step_round_kernel<T>,
                dim3((a.d_model + kEpiThreads - 1) / kEpiThreads, a.B), epi,
                0, s, ov, oa);
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

// Plain C entry points.  Returns the error of the first launch that
// failed, else of the last.
//
// mamba_step: x1 (B, d_model); conv (B, w-1, d_in) strides (conv_sb,
// conv_sw, 1) and h (B, d_in, N) strides (h_sb, N, 1), both updated in
// place for live rows; live (B,) int32; weights contiguous in the
// activation dtype (in_proj (d_model, 2 d_in), x_proj (d_in, R + 2N),
// dt_proj (R, d_in), out_proj (d_in, d_model)); conv_w (w, d_in), conv_b,
// dt_bias, D (d_in,) and a_log (d_in, N) fp32; out (B, d_model).  plan:
// host int[16], (route, splits, span, grid) of in_proj, x_proj, dt_proj
// and out_proj.  part: fp32 scratch of the sum of splits_i * B * N_i over
// the split products; prod: activation-dtype scratch of the sum of B * N_i
// rounded up to 8 over the unsplit tensor-core products; act:
// activation-dtype scratch of 3 pad8(B d_in) + B (R + 2N) values.  overlap:
// launch each kernel as a programmatic dependent of the one before.
extern "C" int mamba_step(
    const void* x1, void* conv, void* h, const void* live,
    const void* in_proj, const void* conv_w, const void* conv_b,
    const void* x_proj, const void* dt_proj, const void* dt_bias,
    const void* a_log, const void* d, const void* out_proj, void* out,
    void* part, void* prod, void* act, const int* plan, int B, int d_model,
    int d_in, int R, int N, int w, long long conv_sb, long long conv_sw,
    long long h_sb, int overlap, int dtype, void* stream) {
  using namespace repro;
  if (B == 0) return 0;
  if (w < 1 || w > kMaxConv) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a{x1, conv, static_cast<float*>(h), static_cast<const int*>(live),
             in_proj, static_cast<const float*>(conv_w),
             static_cast<const float*>(conv_b), x_proj, dt_proj,
             static_cast<const float*>(dt_bias),
             static_cast<const float*>(a_log), static_cast<const float*>(d),
             out_proj, out, static_cast<float*>(part), prod, act, B, d_model,
             d_in, R, N, w, conv_sb, conv_sw, h_sb, {}, overlap != 0};
  for (int i = 0; i < 4; ++i) {
    a.plan[i] = ProductPlan{plan[4 * i], plan[4 * i + 1], plan[4 * i + 2],
                            plan[4 * i + 3]};
  }
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
