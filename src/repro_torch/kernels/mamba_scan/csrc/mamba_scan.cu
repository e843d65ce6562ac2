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
//   place, so no state crosses blocks.  At falcon-mamba-7b widths (S =
//   1024, d_in = 8192, N = 16) it moves 85 MB (0.025 ms at 3.35 TB/s) and
//   takes 134 M exponentials, one per state-step: 0.032 ms on the
//   special-function units (16 per clock per SM) alone.  Measured, what
//   held it back was neither: per-thread copies issued in a burst after
//   each barrier, and warps that stall on their own chains (two per SM
//   sub-partition).  The design:
//   - a producer warp stages 64-step tiles of x, dt, B and C into a 3-slot
//     ring, one Tensor Memory Accelerator copy per input and tile from a
//     3-d tensor map (zeros past S and past d_in), on full/empty
//     mbarriers; inputs that no tensor map can describe (B and C views
//     that are not 16-byte aligned) come as its cp.async chunks instead;
//   - the consumer warps hold 4 of a channel's N states per lane in
//     registers, on N / 4 consecutive lanes, so dt, x and the sum over
//     lanes are paid once per 4 states (8 per lane measured slower: one
//     warp per SM sub-partition);
//   - exp(dt A) is one MUFU.EX2 of dt (A log2 e), A prescaled once: a
//     state-step is an FMUL, the MUFU, an FMUL for dt x B and the two
//     FMAs of h and y;
//   - a lane takes 16 steps at a time (only the h FMAs wait on the step
//     before), then sums y over a channel's lanes for all 16 by a fixed
//     xor tree that scatters as it goes, so every lane stores steps of its
//     own straight from registers, branch-free;
//   - the wrapper's scan_plan() picks the channels per block from host
//     ints so that every SM gets as many channels as the others, within one
//     block (128 blocks of 64 channels at B = 1, d_in = 8192);
//   - the time axis is not split: 131 k (channel, state) chains already
//     fill the card, and carrying a state across blocks would cost a
//     second exponential per state-step.
//   It takes any S and also returns the last state, which the prefill
//   stores in the cache.  No atomics: bit-equal from run to run.  The
//   training forward is the same kernel instantiated with kBounds: it also
//   writes the state at the start of every kBwdChunk steps, (nchunk, B, D,
//   N) fp32, the residual of the backward below (the reference's _fss_fwd
//   saves the same).  The stores add no arithmetic, so its y is bitwise
//   the serving instance's, and the serving instance is unchanged.
//
// * mamba_scan_bwd / mamba_scan_bwd_kernel, the scan's gradient.  Replaces
//   no Pallas kernel: the reference's backward is the custom VJP
//   _fss_bwd (src/repro/models/ssm.py), in jnp, which recomputes each
//   chunk's states from its saved boundary and runs the reverse affine
//   scan g_t = gy_t C_t + a_{t+1} g_{t+1} (g = dL/dh_t, a_t = exp(dt_t A))
//   for dx, ddt, dB, dC, dA and dD.  It is the training path's hot loop, so
//   it is a kernel: a materialised (B, S, d_in, N) fp32 state would be 2.1
//   GB per layer at falcon-mamba-7b's widths (B 4, S 1024).  Bound on the
//   H100: at those widths the bytes (x, dt, gy and the boundaries read,
//   dx and ddt written: about 0.17 ms) and the exponentials (two per
//   state-step, one to recompute the state and one to carry g) weigh
//   about alike.  The design, simple first:
//   - a block of 128 threads takes one row and 128 / (N / 4) channels, 4
//     states a lane as in the forward, and walks the chunks in reverse;
//   - per chunk it stages dt, x, gy, B and C in fp32 into shared memory,
//     recomputes the chunk's states from its boundary with the forward's
//     arithmetic (bitwise the forward's states), keeping each step's
//     state in shared memory (32 steps x 16 bytes a lane: 64 KB), then
//     sweeps back in registers, g carried across chunks;
//   - dx and ddt are per channel: a channel's lanes sum their states by
//     xor shuffles, and the chunk's values leave coalesced from shared
//     memory;
//   - dB and dC at (b, t, n) are sums over all d_in channels, so they
//     cross blocks: each warp sums its channels by halving xor exchanges
//     (7 shuffles a step for 8 values), the block its warps in order, and
//     writes fp32 partials per block; dA (d_in, N) and dD (d_in,) are
//     sums over rows and steps, kept in registers and written per row;
//   - a second launch, mamba_scan_bwd_fold, adds the partials in block
//     order (and rows in order) and rounds once.  No atomics, so repeats
//     are bitwise equal.
#include <cuda.h>
#include <cudaTypedefs.h>

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

constexpr int kScanTile = 64;          // time steps per staged tile
constexpr int kScanStages = 3;         // ring slots the producer fills ahead
constexpr int kScanStates = 4;         // of a channel's states per lane
constexpr int kScanGroup = 16;         // time steps a lane takes per group
constexpr int kScanPad = 16;           // a tile's steps round up to this
constexpr int kScanMaxChannels = 64;   // channels per block, at most
constexpr int kBwdChunk = 32;          // steps between saved states
constexpr int kBwdThreads = 128;       // threads of a backward block
static_assert(kBwdChunk % kScanGroup == 0 && kScanTile % kBwdChunk == 0,
              "a saved state starts a group of steps");
constexpr float kLog2e = 1.4426950408889634f;

struct ScanArgs {
  const void* x;        // (B, S, D), strides (x_sb, x_ss, 1)
  const float* dt;      // (B, S, D), strides (dt_sb, dt_ss, 1)
  const void* bm;       // (B, S, N), strides (b_sb, b_ss, 1)
  const void* cm;       // (B, S, N), strides (c_sb, c_ss, 1)
  const float* a_log;   // (D, N)
  const float* d;       // (D,)
  float* y;             // (B, S, D) contiguous
  float* h_last;        // (B, D, N) contiguous
  int S, D, channels;   // channels: per block, a multiple of 8
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int vx, vdt, vb, vc;  // bytes per copy of each input's rows: 16, 8, 4, 2
  int tmx, tmdt, tmb, tmc;   // 1: the input comes by its tensor map
  float* bounds;        // (nchunk, B, D, N) contiguous: the kBounds instance
};

// the four inputs' tensor maps (x, dt, B, C), where ScanArgs says so
struct ScanMaps {
  CUtensorMap x, dt, b, c;
};

// 2^x on the special-function unit: one MUFU.EX2, denormals flushed
__device__ inline float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage `rows` rows of `width` elements from global rows `ss` elements
// apart into shared rows `pitch` elements apart.  Only the first `valid`
// elements of the first `valid_rows` rows are read; the rest is zero.
// `vec` bytes per copy: cp.async of 16, 8 or 4 bytes (the source's rows
// and base aligned to it), or plain loads for 2-byte aligned bf16 rows.
template <typename E>
__device__ inline void stage_rows(E* dst, int pitch, const E* src,
                                  long long ss, int rows, int valid_rows,
                                  int width, int valid, int vec, int tid,
                                  int nthreads) {
  constexpr int es = static_cast<int>(sizeof(E));
  if (vec < 4) {
    for (int i = tid; i < rows * width; i += nthreads) {
      const int r = i / width;
      const int j = i - r * width;
      dst[r * pitch + j] = (r < valid_rows && j < valid)
                               ? src[r * ss + j] : from_f<E>(0.f);
    }
    return;
  }
  // chunk i = r per_row + c of the tile for i = tid, tid + nthreads, ...,
  // walked without a division in the loop
  const int per_row = width * es / vec;
  const int dr = nthreads / per_row;
  const int dc = nthreads - dr * per_row;
  int r = tid / per_row;
  int c = tid - r * per_row;
  const char* base = reinterpret_cast<const char*>(src);
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  while (r < rows) {
    const int off = c * vec;
    const int n = r < valid_rows ? max(0, min(vec, valid * es - off)) : 0;
    const char* p = n > 0 ? base + r * ss * es + off : base;
    const unsigned d = sdst + static_cast<unsigned>(r * pitch * es + off);
    if (vec == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(p), "r"(n));
    } else if (vec == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(d), "l"(p), "r"(n));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(d), "l"(p), "r"(n));
    }
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// store v at p where ok, as one predicated instruction (no branch)
__device__ inline void store_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.f32 [%0], %1;\n}\n"
      :: "l"(p), "f"(v), "r"(static_cast<int>(ok)) : "memory");
}

// y of U steps from G lanes' partials: each step's partials summed over
// the lanes by xor offsets G / 2, ..., 1, scattered as they go.  Lane g
// keeps the upper half of the steps where g has the offset's bit, so it
// ends with the sums of steps [g U / G, (g + 1) U / G) in p[0, U / G).
template <int U, int G>
__device__ inline void sum_scatter(float (&p)[U], int g) {
  if constexpr (G > 1) {
    constexpr int O = G / 2;
    constexpr int H = U / 2;
    const bool hi = (g & O) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = hi ? p[j] : p[j + H];
      const float keep = hi ? p[j + H] : p[j];
      p[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    sum_scatter<H, G / 2>(reinterpret_cast<float(&)[H]>(p), g);
  }
}

// mbarriers in shared memory (sm_90)
__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive on `bar` once every cp.async this thread issued has landed
__device__ inline void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive on `bar` and expect `bytes` more of bulk copies to land there
__device__ inline void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one box of a 3-d tensor map (at channel c, step t, row b) copied by the
// Tensor Memory Accelerator into shared memory, counted on `bar` as it
// lands; elements outside the tensor arrive as zeros
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map, int c,
                                int t, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<unsigned long long>(map)), "r"(c),
         "r"(t), "r"(b), "r"(bar)
      : "memory");
}

__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// the consumer warps alone (the producer warp does not take part)
__device__ inline void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// Shared memory of one scan block: per ring slot x, B and C in the input
// dtype and dt in fp32, each [step][column]; two tiles of B, C in fp32,
// [step][B then C]; a full and an empty mbarrier per slot.  Every region
// starts 128-byte aligned (tensor-map copies).
template <typename T, int N>
constexpr size_t scan_smem(int channels) {
  return static_cast<size_t>(kScanStages) * kScanTile *
             (channels * (sizeof(T) + sizeof(float)) + 2 * N * sizeof(T)) +
         static_cast<size_t>(2) * kScanTile * 2 * N * sizeof(float) +
         2 * kScanStages * sizeof(unsigned long long);
}

// One block scans `channels` channels of one row over all S steps.  Its
// consumer warps hold a channel's N states on G = N / K consecutive lanes,
// K = 4 in registers each (state n = g K + k on lane g); one more warp, the
// producer, stages the tiles.  kBounds: also write the state before every
// kBwdChunk-th step to a.bounds.
template <typename T, int N, bool kBounds>
__global__ void __launch_bounds__(kScanMaxChannels * N / kScanStates + 32, 1)
mamba_scan_kernel(const ScanArgs a, const __grid_constant__ ScanMaps maps) {
  constexpr int K = kScanStates;
  static_assert(K == 4, "a lane's states are one float4 of a.bounds");
  constexpr int G = N / K;
  constexpr int U = kScanGroup;
  constexpr int V = U / G;             // steps of a group a lane stores
  static_assert(N % K == 0 && kScanPad % U == 0 && V >= 1, "N: 4, 8, 16");
  extern __shared__ __align__(128) unsigned char scan_smem_raw[];
  const int CH = a.channels;
  const int threads = CH * G;                                // consumers
  float* dts = reinterpret_cast<float*>(scan_smem_raw);     // [slot][t][CH]
  float* bcf = dts + kScanStages * kScanTile * CH;           // [2][t][2N]
  T* xs = reinterpret_cast<T*>(bcf + 2 * kScanTile * 2 * N);  // [slot][t][CH]
  T* bs = xs + kScanStages * kScanTile * CH;                 // [slot][t][N]
  T* cs = bs + kScanStages * kScanTile * N;                  // [slot][t][N]
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(
      cs + kScanStages * kScanTile * N));
  auto full = [&](int slot) { return bars + 8 * slot; };
  auto empty = [&](int slot) { return bars + 8 * (kScanStages + slot); };

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int cv = min(CH, a.D - c0);
  const int tid = threadIdx.x;
  const int tiles = (a.S + kScanTile - 1) / kScanTile;
  if (tid == 0) {
    for (int i = 0; i < kScanStages; ++i) {
      // lane 0 of the producer with the tensor-map bytes, and its 32
      // lanes once their cp.async chunks have landed
      mbar_init(full(i), 33);
      mbar_init(empty(i), threads);    // every consumer, done with the slot
    }
  }
  __syncthreads();

  if (tid >= threads) {
    // The producer: tile i into slot i % stages once the consumers have
    // left the tile before it there; its copies arrive on the slot's full
    // barrier as they land.  Rows past S (up to a multiple of kScanPad)
    // and channels past d_in are zeros, which leave h as it is (2^0 h + 0).
    const int lane = tid - threads;
    const T* x = static_cast<const T*>(a.x) + b * a.x_sb + c0;
    const float* dt = a.dt + b * a.dt_sb + c0;
    const T* bm = static_cast<const T*>(a.bm) + b * a.b_sb;
    const T* cm = static_cast<const T*>(a.cm) + b * a.c_sb;
    // an input with a tensor map comes as one copy per tile, issued by
    // lane 0; any other as cp.async chunks from all 32 lanes
    const int es = static_cast<int>(sizeof(T));
    const int tile_bytes = kScanTile * (a.tmx * CH * es + a.tmdt * CH * 4 +
                                        (a.tmb + a.tmc) * N * es);
    const auto sh = [](const void* p) {
      return static_cast<uint32_t>(__cvta_generic_to_shared(p));
    };
    for (int i = 0; i < tiles; ++i) {
      const int slot = i % kScanStages;
      if (i >= kScanStages) mbar_wait(empty(slot), (i / kScanStages - 1) & 1);
      const int t0 = i * kScanTile;
      const int rows = min(kScanTile, a.S - t0);
      const int padded = min(kScanTile,
                             (rows + kScanPad - 1) / kScanPad * kScanPad);
      T* xd = xs + slot * kScanTile * CH;
      float* dd = dts + slot * kScanTile * CH;
      T* bd = bs + slot * kScanTile * N;
      T* cd = cs + slot * kScanTile * N;
      const uint32_t bar = full(slot);
      if (lane == 0) {
        mbar_expect(bar, tile_bytes);
        if (a.tmx) tma_load(sh(xd), &maps.x, c0, t0, b, bar);
        if (a.tmdt) tma_load(sh(dd), &maps.dt, c0, t0, b, bar);
        if (a.tmb) tma_load(sh(bd), &maps.b, 0, t0, b, bar);
        if (a.tmc) tma_load(sh(cd), &maps.c, 0, t0, b, bar);
      }
      if (!a.tmx) {
        stage_rows(xd, CH, x + t0 * a.x_ss, a.x_ss, padded, rows, CH, cv,
                   a.vx, lane, 32);
      }
      if (!a.tmdt) {
        stage_rows(dd, CH, dt + t0 * a.dt_ss, a.dt_ss, padded, rows, CH, cv,
                   a.vdt, lane, 32);
      }
      if (!a.tmb) {
        stage_rows(bd, N, bm + t0 * a.b_ss, a.b_ss, padded, rows, N, N, a.vb,
                   lane, 32);
      }
      if (!a.tmc) {
        stage_rows(cd, N, cm + t0 * a.c_ss, a.c_ss, padded, rows, N, N, a.vc,
                   lane, 32);
      }
      __threadfence_block();   // plain-load rows (2-byte bf16) first
      mbar_arrive_on_copies(bar);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int cl = tid / G;
  const int g = tid - cl * G;
  const int c = c0 + cl;
  const bool active = cl < cv;
  // A = -exp(A_log) prescaled by log2(e): exp(dt A) = 2^(dt A log2 e)
  float A2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    A2[k] = active ? -expf(a.a_log[static_cast<long long>(c) * N + g * K + k]) *
                         kLog2e
                   : 0.f;
    h[k] = 0.f;
  }
  // D x enters y as the first term of the channel's lane 0
  const float dl = active && g == 0 ? a.d[c] : 0.f;
  float* yrow = a.y + static_cast<long long>(b) * a.S * a.D + c;

  for (int i = 0; i < tiles; ++i) {
    const int slot = i % kScanStages;
    const int t0 = i * kScanTile;
    const int rows = min(kScanTile, a.S - t0);
    const int padded = min(kScanTile,
                           (rows + kScanPad - 1) / kScanPad * kScanPad);
    mbar_wait(full(slot), (i / kScanStages) & 1);
    // B and C of tile i to fp32, [step][B then C], into the buffer that
    // tile i - 2 used: every consumer left it before the barrier of tile
    // i - 1
    const T* bt = bs + slot * kScanTile * N;
    const T* ct = cs + slot * kScanTile * N;
    float* bcw = bcf + (i & 1) * kScanTile * 2 * N;
    for (int j = tid; j < padded * N; j += threads) {
      const int t = j / N;
      bcw[j + t * N] = to_f<T>(bt[j]);
      bcw[j + t * N + N] = to_f<T>(ct[j]);
    }
    consumers_sync(threads);
    const T* xt = xs + slot * kScanTile * CH + cl;
    const float* dtt = dts + slot * kScanTile * CH + cl;
    for (int t = 0; t < padded; t += U) {
      if constexpr (kBounds) {
        const int step = t0 + t;
        if (step % kBwdChunk == 0 && active && step < a.S) {
          *reinterpret_cast<float4*>(
              a.bounds + ((static_cast<long long>(step / kBwdChunk) *
                               gridDim.y + b) * a.D + c) * N + g * K) =
              make_float4(h[0], h[1], h[2], h[3]);
        }
      }
      // a group of U steps: only the h FMAs wait on the step before, so
      // the loads and exponentials of later steps need not wait
      float part[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float dtv = dtt[(t + u) * CH];
        const float xv = to_f<T>(xt[(t + u) * CH]);
        const float dx = dtv * xv;
        const float* bv = bcw + (t + u) * 2 * N + g * K;
        part[u] = dl * xv;
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 b4 = reinterpret_cast<const float4*>(bv)[q];
          const float4 c4 = reinterpret_cast<const float4*>(bv + N)[q];
          const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = 4 * q + j;
            h[k] = fmaf(ex2_approx(dtv * A2[k]), h[k], dx * bb[j]);
            part[u] = fmaf(h[k], cc[j], part[u]);
          }
        }
      }
      sum_scatter<U, G>(part, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int step = t + g * V + j;
        store_if(yrow + static_cast<long long>(t0 + step) * a.D, part[j],
                 active && step < rows);
      }
    }
    mbar_arrive(empty(slot));   // x, dt and raw B, C of the slot are read
  }
  if (active) {
    float* hl = a.h_last + (static_cast<long long>(b) * a.D + c) * N + g * K;
#pragma unroll
    for (int k = 0; k < K; ++k) hl[k] = h[k];
  }
}

// Largest copy (16, 8, 4 or 2 bytes) that the base `p`, the strides (in
// elements of `es` bytes) and a shared row of `row_bytes` all allow.
inline int copy_bytes(const void* p, long long sb, long long ss, int es,
                      int row_bytes) {
  const unsigned long long m = reinterpret_cast<unsigned long long>(p) |
                               static_cast<unsigned long long>(sb * es) |
                               static_cast<unsigned long long>(ss * es) |
                               static_cast<unsigned long long>(row_bytes);
  for (int v = 16; v >= 4; v >>= 1) {
    if (m % v == 0) return v;
  }
  return 2;
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// the driver's tensor-map encoder, found once through the runtime
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of (B, S, width) rows, strides (sb, ss, 1) in elements of
// `es` bytes, read in boxes of `box` columns by kScanTile steps of one row.
// False where the copy engine cannot take it (16-byte alignment).
bool tile_map(CUtensorMap* m, const void* base, int es, int width, int S,
              int B, long long ss, long long sb, int box) {
  const EncodeTiled enc = tensor_map_encoder();
  const long long row = ss * es, batch = sb * es;
  if (enc == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      row % 16 != 0 || batch % 16 != 0 || box * es % 16 != 0) {
    return false;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row),
                                 static_cast<cuuint64_t>(batch)};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(box),
                               static_cast<cuuint32_t>(kScanTile), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(base), dims, strides, boxes, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int N, bool kBounds>
cudaError_t scan(ScanArgs a, int B, cudaStream_t s) {
  constexpr int es = static_cast<int>(sizeof(T));
  a.vx = copy_bytes(a.x, a.x_sb, a.x_ss, es, a.channels * es);
  a.vdt = copy_bytes(a.dt, a.dt_sb, a.dt_ss, 4, a.channels * 4);
  a.vb = copy_bytes(a.bm, a.b_sb, a.b_ss, es, N * es);
  a.vc = copy_bytes(a.cm, a.c_sb, a.c_ss, es, N * es);
  ScanMaps maps;
  a.tmx = tile_map(&maps.x, a.x, es, a.D, a.S, B, a.x_ss, a.x_sb, a.channels);
  a.tmdt = tile_map(&maps.dt, a.dt, 4, a.D, a.S, B, a.dt_ss, a.dt_sb,
                    a.channels);
  a.tmb = tile_map(&maps.b, a.bm, es, N, a.S, B, a.b_ss, a.b_sb, N);
  a.tmc = tile_map(&maps.c, a.cm, es, N, a.S, B, a.c_ss, a.c_sb, N);
  const size_t smem = scan_smem<T, N>(a.channels);
  REPRO_TRY(allow_smem(mamba_scan_kernel<T, N, kBounds>, smem));
  const dim3 grid((a.D + a.channels - 1) / a.channels, B);
  mamba_scan_kernel<T, N, kBounds>
      <<<grid, a.channels * N / kScanStates + 32, smem, s>>>(a, maps);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t scan_either(const ScanArgs& a, int B, cudaStream_t s) {
  return a.bounds == nullptr ? scan<T, N, false>(a, B, s)
                             : scan<T, N, true>(a, B, s);
}

template <typename T>
cudaError_t scan_for_n(const ScanArgs& a, int B, int N, cudaStream_t s) {
  switch (N) {
    case 4: return scan_either<T, 4>(a, B, s);
    case 8: return scan_either<T, 8>(a, B, s);
    case 16: return scan_either<T, 16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the scan's backward (training)
// ---------------------------------------------------------------------------

struct ScanBwdArgs {
  const void* x;        // (B, S, D), strides (x_sb, x_ss, 1)
  const float* dt;      // (B, S, D), strides (dt_sb, dt_ss, 1)
  const void* bm;       // (B, S, N), strides (b_sb, b_ss, 1)
  const void* cm;       // (B, S, N), strides (c_sb, c_ss, 1)
  const float* a_log;   // (D, N)
  const float* d;       // (D,)
  const float* bounds;  // (nchunk, B, D, N): the forward's saved states
  const float* gy;      // (B, S, D) contiguous
  void* dx;             // (B, S, D) contiguous, x's dtype
  float* ddt;           // (B, S, D) contiguous
  void* db;             // (B, S, N) contiguous, B's dtype
  void* dc;             // (B, S, N) contiguous
  float* da;            // (D, N): with respect to A = -exp(A_log)
  float* dd;            // (D,)
  float* part;          // (B, blocks, S, 2N): a block's dB then dC
  float* dpart;         // (B, D, N + 1): a row's dA then dD
  int B, S, D;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// v[U] summed over the lanes that differ in lane bits O, O / 2, ..., by
// halving exchanges: a lane keeps the upper half of the values where it
// has the offset's bit, so after log2(U) of them v[0] holds the sum of
// value j = the lane's bits at those offsets, read high to low.
template <int U, int O>
__device__ inline void scatter_lanes(float (&v)[U], int lane) {
  if constexpr (U > 1) {
    constexpr int H = U / 2;
    const bool hi = (lane & O) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = hi ? v[j] : v[j + H];
      const float keep = hi ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    scatter_lanes<H, O / 2>(reinterpret_cast<float(&)[H]>(v), lane);
  }
}

// shared memory of a backward block of N states (floats): the chunk's
// states [step][thread] (float4 a lane), the warps' dB/dC sums
// [warp][step][2N], dt, x, gy, dx and ddt [step][channel], B then C
// [step][2N]
template <int N>
constexpr size_t scan_bwd_smem() {
  constexpr int CH = kBwdThreads * kScanStates / N;
  return sizeof(float) * (static_cast<size_t>(kBwdChunk) * kBwdThreads * 4 +
                          (kBwdThreads / 32) * kBwdChunk * 2 * N +
                          5 * kBwdChunk * CH + kBwdChunk * 2 * N);
}

// One block: row blockIdx.y, channels [blockIdx.x CH, + CH), CH = 128 /
// G, a channel's N states on G = N / 4 consecutive lanes as in the
// forward.  Walks the chunks in reverse.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
mamba_scan_bwd_kernel(const ScanBwdArgs a) {
  constexpr int K = kScanStates;
  constexpr int G = N / K;
  constexpr int CH = kBwdThreads / G;
  constexpr int L = kBwdChunk;
  constexpr int W = kBwdThreads / 32;
  constexpr int N2 = 2 * N;
  static_assert(K == 4 && G <= 4, "N: 4, 8, 16");
  extern __shared__ __align__(16) unsigned char scan_bwd_raw[];
  float4* st = reinterpret_cast<float4*>(scan_bwd_raw);     // [L][threads]
  float* red = reinterpret_cast<float*>(st + L * kBwdThreads);  // [W][L][2N]
  float* dts = red + W * L * N2;                            // [L][CH]
  float* xs = dts + L * CH;
  float* gys = xs + L * CH;
  float* dxs = gys + L * CH;
  float* ddts = dxs + L * CH;
  float* bcs = ddts + L * CH;                               // [L][2N]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int c0 = blk * CH;
  const int cl = tid / G;
  const int g = tid - cl * G;
  const int c = c0 + cl;
  const bool active = c < a.D;
  // A natural (ddt, dA) and prescaled by log2 e (the exponentials), as
  // the forward takes it
  float An[K], A2[K], gc[K], dA[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    An[k] = active ? -expf(a.a_log[static_cast<long long>(c) * N + g * K + k])
                   : 0.f;
    A2[k] = active ? An[k] * kLog2e : 0.f;
    gc[k] = 0.f;      // a_{t+1} g_{t+1}, carried in from the step after
    dA[k] = 0.f;
  }
  const float dv = active ? a.d[c] : 0.f;
  float dD = 0.f;
  // the lane's dB/dC sum after scatter_lanes<8, 16>: value j = lane bits
  // 4, 3, 2; the lanes that differ in bits 1 .. G hold the same sum, and
  // the one with those bits clear writes it
  const int vj = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                 ((lane >> 2) & 1);
  const int n2 = (vj < 4 ? 0 : N) + g * K + (vj & 3);
  const bool rep = (lane & (3 & ~(G - 1))) == 0;
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + c0;
  const float* dtg = a.dt + b * a.dt_sb + c0;
  const float* gyg = a.gy + static_cast<long long>(b) * a.S * a.D + c0;
  const T* bg = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cg = static_cast<const T*>(a.cm) + b * a.c_sb;
  const int nchunk = (a.S + L - 1) / L;

  for (int k = nchunk - 1; k >= 0; --k) {
    const int t0 = k * L;
    const int rows = min(L, a.S - t0);
    __syncthreads();   // the chunk after this one is written out
    // steps past S and channels past d_in stage as zeros: dt = 0 leaves
    // h and g as they are (2^0 h + 0) and adds nothing to any sum
    for (int i = tid; i < L * CH; i += kBwdThreads) {
      const int t = i / CH;
      const int j = i - t * CH;
      const bool ok = t < rows && c0 + j < a.D;
      const long long s = t0 + t;
      dts[i] = ok ? dtg[s * a.dt_ss + j] : 0.f;
      xs[i] = ok ? to_f<T>(xg[s * a.x_ss + j]) : 0.f;
      gys[i] = ok ? gyg[s * a.D + j] : 0.f;
    }
    for (int i = tid; i < L * N; i += kBwdThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const bool ok = t < rows;
      const long long s = t0 + t;
      bcs[t * N2 + n] = ok ? to_f<T>(bg[s * a.b_ss + n]) : 0.f;
      bcs[t * N2 + N + n] = ok ? to_f<T>(cg[s * a.c_ss + n]) : 0.f;
    }
    __syncthreads();

    // the chunk's states from its boundary, the forward's arithmetic
    float h[K] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      const float4 h4 = *reinterpret_cast<const float4*>(
          a.bounds + ((static_cast<long long>(k) * a.B + b) * a.D + c) * N +
          g * K);
      h[0] = h4.x;
      h[1] = h4.y;
      h[2] = h4.z;
      h[3] = h4.w;
    }
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      st[t * kBwdThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      const float dtv = dts[t * CH + cl];
      const float dx = dtv * xs[t * CH + cl];
      const float4 b4 = *reinterpret_cast<const float4*>(bcs + t * N2 + g * K);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int j = 0; j < K; ++j) {
        h[j] = fmaf(ex2_approx(dtv * A2[j]), h[j], dx * bb[j]);
      }
    }

    // back through the chunk: hn = h_t, hp = h_{t-1}
    float hn[K] = {h[0], h[1], h[2], h[3]};
#pragma unroll 2
    for (int t = L - 1; t >= 0; --t) {
      const float4 hp4 = st[t * kBwdThreads + tid];
      const float hp[4] = {hp4.x, hp4.y, hp4.z, hp4.w};
      const float dtv = dts[t * CH + cl];
      const float xv = xs[t * CH + cl];
      const float gyv = gys[t * CH + cl];
      const float dx = dtv * xv;
      const float4 b4 = *reinterpret_cast<const float4*>(bcs + t * N2 + g * K);
      const float4 c4 =
          *reinterpret_cast<const float4*>(bcs + t * N2 + N + g * K);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
      float sgb = 0.f;     // sum_n g B
      float sdd = 0.f;     // sum_n g h_{t-1} a_t A
      float v[2 * K];      // dB then dC terms of this lane's states
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float da = ex2_approx(dtv * A2[j]);
        gc[j] = fmaf(gyv, cc[j], gc[j]);                 // g_t
        sgb = fmaf(gc[j], bb[j], sgb);
        const float e = gc[j] * hp[j] * da;
        sdd = fmaf(e, An[j], sdd);
        dA[j] = fmaf(e, dtv, dA[j]);
        v[j] = gc[j] * dx;
        v[K + j] = gyv * hn[j];
        gc[j] *= da;                                     // into step t - 1
        hn[j] = hp[j];
      }
      sgb = group_sum<G>(sgb);
      sdd = group_sum<G>(sdd);
      if (g == 0) {
        dxs[t * CH + cl] = fmaf(dtv, sgb, dv * gyv);
        ddts[t * CH + cl] = fmaf(xv, sgb, sdd);
        dD = fmaf(gyv, xv, dD);
      }
      scatter_lanes<2 * K, 16>(v, lane);
#pragma unroll
      for (int o = 2; o >= G; o >>= 1) {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      }
      if (rep) red[(warp * L + t) * N2 + n2] = v[0];
    }
    __syncthreads();

    // the block's dB/dC of the chunk (its warps in order) and its dx, ddt
    float* pb = a.part + ((static_cast<long long>(b) * gridDim.x + blk) * a.S +
                          t0) * N2;
    for (int i = tid; i < rows * N2; i += kBwdThreads) {
      float sum = red[i];
#pragma unroll
      for (int w = 1; w < W; ++w) sum += red[w * L * N2 + i];
      pb[i] = sum;
    }
    T* dxg = static_cast<T*>(a.dx) + (static_cast<long long>(b) * a.S + t0) *
                                         a.D + c0;
    float* ddtg = a.ddt + (static_cast<long long>(b) * a.S + t0) * a.D + c0;
    for (int i = tid; i < rows * CH; i += kBwdThreads) {
      const int t = i / CH;
      const int j = i - t * CH;
      if (c0 + j < a.D) {
        dxg[static_cast<long long>(t) * a.D + j] = from_f<T>(dxs[i]);
        ddtg[static_cast<long long>(t) * a.D + j] = ddts[i];
      }
    }
  }
  if (active) {
    float* p = a.dpart + (static_cast<long long>(b) * a.D + c) * (N + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) p[g * K + k] = dA[k];
    if (g == 0) p[N] = dD;
  }
}

constexpr int kBwdFoldThreads = 256;

// dB, dC: the blocks' partials summed in block order; dA, dD: the rows'
// partials summed in row order; each rounded once.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdFoldThreads)
mamba_scan_bwd_fold(const ScanBwdArgs a, int blocks) {
  constexpr int N2 = 2 * N;
  const long long i =
      static_cast<long long>(blockIdx.x) * kBwdFoldThreads + threadIdx.x;
  const long long nbc = static_cast<long long>(a.B) * a.S * N2;
  if (i < nbc) {
    const long long bs = i / N2;
    const int n2 = static_cast<int>(i - bs * N2);
    const long long b = bs / a.S;
    const long long s = bs - b * a.S;
    const float* p = a.part + (b * blocks * a.S + s) * N2 + n2;
    const long long stride = static_cast<long long>(a.S) * N2;
    float sum = 0.f;
    for (int k = 0; k < blocks; ++k) sum += p[k * stride];
    T* dst = static_cast<T*>(n2 < N ? a.db : a.dc);
    dst[bs * N + (n2 < N ? n2 : n2 - N)] = from_f<T>(sum);
    return;
  }
  const long long j = i - nbc;
  if (j >= static_cast<long long>(a.D) * (N + 1)) return;
  float sum = 0.f;
  for (int b = 0; b < a.B; ++b) {
    sum += a.dpart[static_cast<long long>(b) * a.D * (N + 1) + j];
  }
  const long long ch = j / (N + 1);
  const int n = static_cast<int>(j - ch * (N + 1));
  if (n < N) {
    a.da[ch * N + n] = sum;
  } else {
    a.dd[ch] = sum;
  }
}

template <typename T, int N>
cudaError_t scan_bwd(const ScanBwdArgs& a, cudaStream_t s) {
  constexpr int CH = kBwdThreads * kScanStates / N;
  const size_t smem = scan_bwd_smem<N>();
  REPRO_TRY(allow_smem(mamba_scan_bwd_kernel<T, N>, smem));
  const int blocks = (a.D + CH - 1) / CH;
  mamba_scan_bwd_kernel<T, N>
      <<<dim3(blocks, a.B), kBwdThreads, smem, s>>>(a);
  REPRO_TRY(cudaGetLastError());
  const long long n = static_cast<long long>(a.B) * a.S * 2 * N +
                      static_cast<long long>(a.D) * (N + 1);
  mamba_scan_bwd_fold<T, N><<<static_cast<int>(
      (n + kBwdFoldThreads - 1) / kBwdFoldThreads), kBwdFoldThreads, 0, s>>>(
      a, blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan_bwd_for_n(const ScanBwdArgs& a, int N, cudaStream_t s) {
  switch (N) {
    case 4: return scan_bwd<T, 4>(a, s);
    case 8: return scan_bwd<T, 8>(a, s);
    case 16: return scan_bwd<T, 16>(a, s);
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
// y (B, S, D) fp32 and h_last (B, D, N) fp32, both contiguous, and where
// bounds is not null the state before every 32nd step (kBwdChunk),
// (ceil(S / 32), B, D, N) fp32 contiguous (training).  channels: per
// block, a multiple of 8 up to 64 that makes whole warps of N / 4 lanes
// per channel (the wrapper's scan_plan()).
extern "C" int mamba_scan(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d, void* y, void* h_last, void* bounds,
    int B, int S,
    int D, int N, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, int channels, int dtype, void* stream) {
  using namespace repro;
  if (B == 0 || S == 0) return 0;
  // whole warps: the sums over a channel's lanes shuffle the full warp
  if (channels < 8 || channels > kScanMaxChannels || channels % 8 != 0 ||
      channels * N / kScanStates % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs a{x, static_cast<const float*>(dt), b, c,
             static_cast<const float*>(a_log), static_cast<const float*>(d),
             static_cast<float*>(y), static_cast<float*>(h_last), S, D,
             channels, x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,
             0, 0, 0, 0, 0, 0, 0, 0, static_cast<float*>(bounds)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return static_cast<int>(scan_for_n<__nv_bfloat16>(a, B, N, s));
  }
  if (dtype == kF32) return static_cast<int>(scan_for_n<float>(a, B, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// mamba_scan_bwd: the gradient of mamba_scan's y for gy (B, S, D) fp32
// contiguous, from the forward's inputs (as mamba_scan takes them) and its
// bounds -> dx (B, S, D) in x's dtype, ddt (B, S, D) fp32, db and dc (B,
// S, N) in b's dtype, da (D, N) fp32 (with respect to A = -exp(A_log)) and
// dd (D,) fp32, all contiguous.  part: fp32 scratch of B * ceil(D / CH) *
// S * 2N, CH = 128 / (N / 4) channels a block; dpart: fp32 scratch of B *
// D * (N + 1).  Two launches.
extern "C" int mamba_scan_bwd(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d, const void* bounds, const void* gy,
    void* dx, void* ddt, void* db, void* dc, void* da, void* dd, void* part,
    void* dpart, int B, int S, int D, int N, long long x_sb, long long x_ss,
    long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, void* stream) {
  using namespace repro;
  if (B == 0 || S == 0 || D == 0) return 0;
  ScanBwdArgs a{x, static_cast<const float*>(dt), b, c,
                static_cast<const float*>(a_log), static_cast<const float*>(d),
                static_cast<const float*>(bounds),
                static_cast<const float*>(gy), dx, static_cast<float*>(ddt),
                db, dc, static_cast<float*>(da), static_cast<float*>(dd),
                static_cast<float*>(part), static_cast<float*>(dpart), B, S,
                D, x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return static_cast<int>(scan_bwd_for_n<__nv_bfloat16>(a, N, s));
  }
  if (dtype == kF32) return static_cast<int>(scan_bwd_for_n<float>(a, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
