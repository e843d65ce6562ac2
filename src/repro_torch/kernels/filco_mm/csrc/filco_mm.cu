// Runtime-flexible tiled matmul (FILCO §2.2) and its static baseline for
// sm_90a, on the tensor cores.
//
// Replaces the Pallas kernels of src/repro/kernels/filco_mm/kernel.py:
// flex_mm (body _flex_mm_kernel) and static_mm (body _static_mm_kernel).
//
//   flex_mm:   C[:m, :n] = A[:m, :k] @ B[:k, :n], zeros elsewhere of the
//              (Mx, Nx) output buffer.  (m, k, n) are read from a device
//              int32[3], never passed at launch: one compiled kernel serves
//              every shape, and reconfiguring costs 12 bytes in device
//              memory with no host sync (the paper's runtime instruction).
//   static_mm: the whole padded product (the CHARM-style baseline): the
//              same kernel with FLEX = false, every tile computed.
//
// A, B and C are row-major with a unit last stride and leading dimensions
// as arguments, so windows of a larger buffer go in as they are.  Both A
// and B are masked beyond k, as the oracle masks them (ref.py): whatever
// lies outside the runtime (m, k, n) or the buffer is zero-filled by the
// copy's source size, never loaded and multiplied by zero, so NaN or Inf in
// the padding cannot reach the output.
//
// What bounds it on the H100.  fp32 products must keep fp32 accuracy (the
// paper path holds every layer to 1e-4 of an fp32 walk), and one TF32
// product does not (about 3e-4 at BERT's widths).  So an fp32 product is
// three TF32 tensor-core products: each operand is split into a TF32 head
// (rounded as cvt.rna rounds) and the TF32 rounding of the remainder, and
// head.head + head.tail + tail.head accumulate in fp32 (mma.sync m16n8k8).
// The least time is 3 x 2mkn at the 495 TFLOP/s TF32 peak (0.104 ms at
// 2048^3, where CUDA cores would need 0.256 ms).  bf16 takes mma.sync
// m16n8k16 with fp32 sums, rounded once.  The skinny passes of the paper
// path (16-128 rows, k 768-3072) are bound by bytes and, before this
// design, by how few blocks a fixed 128x128 tile gave them (2-24 on 132
// SMs).
//
// The design:
//   * Tiles sized to the pass.  The wrapper's plan() picks one of seven
//     compiled (BM, BN) instances, 16x16 to 128x128, and a split count
//     from the buffer extents (Mx, Kx, Nx), never from dims.  In the
//     data-plane simulator the windows are exactly the pass, so a 16-row
//     pass gets a 16-row tile; a deep reduction is split until about 2.5
//     blocks per SM are resident, so every pass of BERT-128 launches 192-
//     384 blocks on 132 SMs.
//   * Split-K in one launch (grid z).  Each split of a live tile writes its
//     fp32 partial tile to a workspace in its registers' own order
//     (coalesced), fences, and takes a ticket; the last one sums the
//     partials in split order (deterministic), masks, rounds once, writes,
//     and puts the ticket back to zero.  A split that lies wholly past the
//     runtime k exits at once and is not counted; a dead output tile
//     (wholly outside [:m, :n]) loads nothing and its split 0 writes its
//     zeros.
//   * A 3-stage cp.async ring of 32-deep k-steps into padded shared tiles:
//     16-byte copies where the wrapper's vec bits say rows are 16-byte
//     aligned (a partial chunk at an edge reads only its valid bytes), else
//     4-byte copies (fp32) or plain loads (bf16), since FMU windows may
//     have any number of columns.
//   * Fragments: A through ldmatrix (a TF32 8x4 block is an 8x8 b16 one),
//     B by 32-bit shared loads (fp32) or ldmatrix.trans (bf16).  The three
//     TF32 products of a k-step are issued product by product over the
//     warp's tiles, so that two products into one sum are never adjacent.
//
// Measured on an H100 (chip_smoke.py; PERF.md has the runs): fp32 2048^3
// in 0.297 ms (torch.matmul without TF32: 0.341), bf16 in 0.075 ms; the
// 309 passes of BERT-128 in 2.42 ms of device time (the CUDA-core kernel
// this replaces: 32.7 ms).  What still holds the large tile back: the
// head/tail split, repeated by every warp that shares a fragment, on the
// integer pipe, and the latency of mma.sync with 16 warps per SM (fp32);
// the L2 traffic of 128x128 tiles (bf16).
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kBK = 32;           // reduction depth of one staged step
constexpr int kStages = 3;
constexpr int kVecA = 1, kVecB = 2, kVecC = 4;

struct MMArgs {
  const void* a;
  const void* b;
  void* c;
  const int* dims;                // flex: [m, k, n] in device memory
  float* ws;                      // splits > 1: (tiles, splits, BM * BN)
  int* tickets;                   // splits > 1: (tiles), zero between calls
  int Mx, Kx, Nx;
  long long lda, ldb, ldc;
  int vec;                        // kVec* bits: 16-byte aligned rows
  int splits;                     // gridDim.z
  int kspan;                      // reduction extent of a split, kBK * j
};

// shared tiles: A (BM x kBK) and B (kBK x BN) with padded rows that keep
// fragment loads off shared bank conflicts and rows 16-byte aligned
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int A = 4, B = 8; };
template <> struct Pad<__nv_bfloat16> { static constexpr int A = 8, B = 8; };

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds; an integer add and mask on the bits
// issues faster than the conversion on sm_90
__device__ inline uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = head + tail, both TF32
__device__ inline void split_tf32(float x, uint32_t& head, uint32_t& tail) {
  head = tf32(x);
  tail = tf32(x - __uint_as_float(head));
}

// d += a (16 x 8, row) . b (8 x 8, col); TF32 in, fp32 sums.  Not
// volatile, so that the products of one k-step may be interleaved.
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> __device__ inline T zero();
template <> __device__ inline float zero<float>() { return 0.f; }
template <> __device__ inline __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// one element of a staged tile when rows are not 16-byte aligned
__device__ inline void copy1(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok);
}
__device__ inline void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src,
                             bool ok) {
  *dst = ok ? *src : zero<__nv_bfloat16>();
}

template <typename T> __device__ inline void store1(T* p, float v);
template <> __device__ inline void store1<float>(float* p, float v) { *p = v; }
template <>
__device__ inline void store1<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// two adjacent values, 8-byte (fp32) or 4-byte (bf16) aligned
__device__ inline void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ inline void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Stage the k-step at k0: A[row0 : row0 + BM, k0 : k0 + kBK] and
// B[k0 : k0 + kBK, col0 : col0 + BN], zero outside (m, k, n).  Thread tid
// takes chunks tid, tid + NT, ... of each tile.
template <typename T, int BM, int BN, int NT>
__device__ inline void stage(T* sA, T* sB, const T* A, const T* B,
                             const MMArgs& p, int row0, int col0, int k0,
                             int m, int k, int n, int tid) {
  constexpr int E = 16 / sizeof(T);               // elements per chunk
  constexpr int PA = kBK + Pad<T>::A, PB = BN + Pad<T>::B;
  if (p.vec & kVecA) {
    constexpr int CPR = kBK / E, N = BM * CPR;
#pragma unroll
    for (int i = 0; i < (N + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (N % NT != 0 && c >= N) break;
      const int r = c / CPR, kc = (c % CPR) * E;
      const int gr = row0 + r, gk = k0 + kc;
      const int valid = gr < m ? min(max(k - gk, 0), E) : 0;
      const T* src = valid ? A + gr * p.lda + gk : A;
      cp_async16_zfill(sA + r * PA + kc, src, valid * int(sizeof(T)));
    }
  } else {
#pragma unroll 4
    for (int c = tid; c < BM * kBK; c += NT) {
      const int r = c / kBK, kc = c % kBK;
      const int gr = row0 + r, gk = k0 + kc;
      const bool ok = gr < m && gk < k;
      copy1(sA + r * PA + kc, ok ? A + gr * p.lda + gk : A, ok);
    }
  }
  if (p.vec & kVecB) {
    constexpr int CPR = BN / E, N = kBK * CPR;
#pragma unroll
    for (int i = 0; i < (N + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (N % NT != 0 && c >= N) break;
      const int r = c / CPR, nc = (c % CPR) * E;
      const int gk = k0 + r, gc = col0 + nc;
      const int valid = gk < k ? min(max(n - gc, 0), E) : 0;
      const T* src = valid ? B + gk * p.ldb + gc : B;
      cp_async16_zfill(sB + r * PB + nc, src, valid * int(sizeof(T)));
    }
  } else {
#pragma unroll 4
    for (int c = tid; c < kBK * BN; c += NT) {
      const int r = c / BN, nc = c % BN;
      const int gk = k0 + r, gc = col0 + nc;
      const bool ok = gk < k && gc < n;
      copy1(sB + r * PB + nc, ok ? B + gk * p.ldb + gc : B, ok);
    }
  }
}

// One staged k-step of a warp's WM x WN tile: MI x NI fragments of 16 x 8.
template <typename T, int BN, int MI, int NI>
__device__ inline void mma_step(float (&acc)[MI][NI][4], const T* sA,
                                const T* sB, int wr0, int wc0, int lane) {
  constexpr int PA = kBK + Pad<T>::A, PB = BN + Pad<T>::B;
  if constexpr (sizeof(T) == 4) {
    // fp32 as 3xTF32, k-steps of 8
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[NI][2], bt[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* bp =
            sB + (kk + (lane & 3)) * PB + wc0 + ni * 8 + (lane >> 2);
        split_tf32(bp[0], bh[ni][0], bt[ni][0]);
        split_tf32(bp[4 * PB], bh[ni][1], bt[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t raw[4], ah[4], at[4];
        ldmatrix_x4(raw, sA + (wr0 + mi * 16 + (lane & 15)) * PA + kk +
                             (lane >> 4) * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_tf32(__uint_as_float(raw[r]), ah[r], at[r]);
        // small terms first; NI independent sums between two products
        // into one sum
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(acc[mi][ni], at, bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(acc[mi][ni], ah, bt[ni][0], bt[ni][1]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(acc[mi][ni], ah, bh[ni][0], bh[ni][1]);
      }
    }
  } else {
    // bf16, k-steps of 16
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bf[NI / 2][4];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj)
        ldmatrix_x4_trans(bf[nj], sB + (kk + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * PB +
                                      wc0 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(af, sA + (wr0 + mi * 16 + (lane & 15)) * PA + kk +
                            (lane >> 4) * 8);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af, bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
  }
}

template <typename T, int BM, int BN>
constexpr int smem_bytes() {
  return kStages * (BM * (kBK + Pad<T>::A) + kBK * (BN + Pad<T>::B)) *
         static_cast<int>(sizeof(T));
}

// The 256-thread 128x128 instance is held to 128 registers, so that two
// blocks share an SM and 256 tiles (2048^2) run in one wave.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool FLEX>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N,
                                  WARPS_M * WARPS_N == 8 ? 2 : 1)
    filco_mm_kernel(MMArgs p) {
  constexpr int NT = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int A_ELEMS = BM * (kBK + Pad<T>::A);
  constexpr int B_ELEMS = kBK * (BN + Pad<T>::B);
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of 16 x 16 steps");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kStages * A_ELEMS;
  __shared__ int s_last;

  // the valid extents: the runtime instruction, clipped to the buffer
  int m = p.Mx, k = p.Kx, n = p.Nx;
  if (FLEX) {
    m = min(max(p.dims[0], 0), p.Mx);
    k = min(max(p.dims[1], 0), p.Kx);
    n = min(max(p.dims[2], 0), p.Nx);
  }
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  T* C = static_cast<T*>(p.c);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;

  if (FLEX && (row0 >= m || col0 >= n)) {
    // dead tile: no loads, no products; split 0 writes its zeros
    if (split != 0) return;
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = row0 + i / BN, c = col0 + i % BN;
      if (r < p.Mx && c < p.Nx) C[r * p.ldc + c] = zero<T>();
    }
    return;
  }
  // splits that hold part of [0, k); the rest exit and take no ticket
  const int live = k > 0 ? min(p.splits, (k + p.kspan - 1) / p.kspan) : 1;
  if (split >= live) return;
  const int kbeg = split * p.kspan;
  const int kext = max(min(k - kbeg, p.kspan), 0);
  const int ktiles = (kext + kBK - 1) / kBK;

  const int lane = tid & 31, warp = tid >> 5;
  const int wr0 = (warp / WARPS_N) * WM, wc0 = (warp % WARPS_N) * WN;
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      stage<T, BM, BN, NT>(sA + s * A_ELEMS, sB + s * B_ELEMS, A, B, p, row0,
                           col0, kbeg + s * kBK, m, k, n, tid);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<kStages - 2>();
    // step t has landed for every thread, and every warp is done with the
    // buffer that step t + kStages - 1 overwrites
    __syncthreads();
    const int nxt = t + kStages - 1;
    if (nxt < ktiles) {
      const int s = nxt % kStages;
      stage<T, BM, BN, NT>(sA + s * A_ELEMS, sB + s * B_ELEMS, A, B, p, row0,
                           col0, kbeg + nxt * kBK, m, k, n, tid);
    }
    cp_async_commit();
    const int cur = t % kStages;
    mma_step<T, BN, MI, NI>(acc, sA + cur * A_ELEMS, sB + cur * B_ELEMS, wr0,
                            wc0, lane);
  }
  cp_async_wait<0>();

  if (live > 1) {
    // partial tile out, in the registers' own order (coalesced); the last
    // split of the tile to arrive sums all of them in split order
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* ws = p.ws + static_cast<size_t>(tile) * p.splits * (BM * BN);
    float* mine = ws + static_cast<size_t>(split) * (BM * BN);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          __stcg(mine + ((mi * NI + ni) * 4 + r) * NT + tid, acc[mi][ni][r]);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(p.tickets + tile, 1) == live - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int s = 0; s < live; ++s) {
      const float* part = ws + static_cast<size_t>(s) * (BM * BN);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v = __ldcg(part + ((mi * NI + ni) * 4 + r) * NT + tid);
            acc[mi][ni][r] = s == 0 ? v : acc[mi][ni][r] + v;
          }
    }
    if (tid == 0) p.tickets[tile] = 0;            // ready for the next call
  }

  // epilogue: valid outputs rounded to T once, zeros elsewhere of the buffer
  const bool vec_c = p.vec & kVecC;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr0 + mi * 16 + (lane >> 2) + h * 8;
      if (r >= p.Mx) continue;
      T* c_row = C + r * p.ldc;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = col0 + wc0 + ni * 8 + (lane & 3) * 2;
        const float v0 = (r < m && c < n) ? acc[mi][ni][2 * h] : 0.f;
        const float v1 = (r < m && c + 1 < n) ? acc[mi][ni][2 * h + 1] : 0.f;
        if (vec_c && c + 1 < p.Nx) {
          store2(c_row + c, v0, v1);
        } else {
          if (c < p.Nx) store1<T>(c_row + c, v0);
          if (c + 1 < p.Nx) store1<T>(c_row + c + 1, v1);
        }
      }
    }
  }
}

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool FLEX>
cudaError_t launch(const MMArgs& a, cudaStream_t stream) {
  auto kernel = filco_mm_kernel<T, BM, BN, WARPS_M, WARPS_N, FLEX>;
  constexpr int bytes = smem_bytes<T, BM, BN>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nx + BN - 1) / BN, (a.Mx + BM - 1) / BM, a.splits);
  kernel<<<grid, 32 * WARPS_M * WARPS_N, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the compiled (BM, BN) instances; ops.py's TILES lists the same
template <typename T, bool FLEX>
cudaError_t launch_tile(const MMArgs& a, int bm, int bn, cudaStream_t s) {
  if (bm == 128 && bn == 128) return launch<T, 128, 128, 2, 4, FLEX>(a, s);
  if (bm == 128 && bn == 64) return launch<T, 128, 64, 2, 2, FLEX>(a, s);
  if (bm == 64 && bn == 64) return launch<T, 64, 64, 2, 2, FLEX>(a, s);
  if (bm == 32 && bn == 64) return launch<T, 32, 64, 2, 2, FLEX>(a, s);
  if (bm == 16 && bn == 64) return launch<T, 16, 64, 1, 4, FLEX>(a, s);
  if (bm == 16 && bn == 32) return launch<T, 16, 32, 1, 2, FLEX>(a, s);
  if (bm == 16 && bn == 16) return launch<T, 16, 16, 1, 1, FLEX>(a, s);
  return cudaErrorInvalidValue;
}

template <bool FLEX>
int dispatch(const MMArgs& a, int bm, int bn, int dtype, void* stream) {
  if (a.Mx == 0 || a.Nx == 0) return 0;
  if (a.splits < 1 || a.kspan < kBK || a.kspan % kBK ||
      (a.splits > 1 && (a.ws == nullptr || a.tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_tile<float, FLEX>(a, bm, bn, s));
  if (dtype == kBF16)
    return static_cast<int>(launch_tile<__nv_bfloat16, FLEX>(a, bm, bn, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// a: (Mx, Kx) leading dim lda; b: (Kx, Nx) ldb; c: (Mx, Nx) ldc, all of
// one dtype (0 fp32, 1 bf16) with a unit last stride; dims: device int32
// [m, k, n].  vec: bit 0/1/2 when A/B/C rows are 16-byte aligned.  The
// plan: a (bm, bn) instance, `splits` reduction splits of `kspan` each;
// with splits > 1, ws holds (tiles, splits, bm * bn) fp32 and tickets
// (tiles) int32 zeros, left at zero.  Returns cudaGetLastError() after the
// launch.
extern "C" int filco_flex_mm(const void* a, const void* b, const void* dims,
                             void* c, int Mx, int Kx, int Nx, long long lda,
                             long long ldb, long long ldc, int vec, int bm,
                             int bn, int splits, int kspan, void* ws,
                             void* tickets, int dtype, void* stream) {
  using namespace repro;
  MMArgs args{a, b, c, static_cast<const int*>(dims),
              static_cast<float*>(ws), static_cast<int*>(tickets),
              Mx, Kx, Nx, lda, ldb, ldc, vec, splits, kspan};
  return dispatch<true>(args, bm, bn, dtype, stream);
}

extern "C" int filco_static_mm(const void* a, const void* b, void* c, int Mx,
                               int Kx, int Nx, long long lda, long long ldb,
                               long long ldc, int vec, int bm, int bn,
                               int splits, int kspan, void* ws, void* tickets,
                               int dtype, void* stream) {
  using namespace repro;
  MMArgs args{a, b, c, nullptr, static_cast<float*>(ws),
              static_cast<int*>(tickets), Mx, Kx, Nx, lda, ldb, ldc, vec,
              splits, kspan};
  return dispatch<false>(args, bm, bn, dtype, stream);
}
