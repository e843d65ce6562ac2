// Runtime-flexible tiled matmul (FILCO §2.2) and its static baseline for
// sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/filco_mm/kernel.py:
// flex_mm (body _flex_mm_kernel) and static_mm (body _static_mm_kernel).
//
//   flex_mm:   C[:m, :n] = A[:m, :k] @ B[:k, :n], zeros elsewhere of the
//              (Mx, Nx) output buffer.  (m, k, n) are read from a device
//              int32[3], never passed at launch: one compiled kernel serves
//              every shape, and reconfiguring costs 12 bytes in device
//              memory with no host sync (the paper's runtime instruction).
//              The grid covers the buffer shape (Mx, Nx).  A block whose
//              output tile lies wholly outside [:m, :n] loads nothing and
//              computes nothing, but still writes zeros over its tile.
//   static_mm: the whole padded product (the CHARM-style baseline): no
//              dims, every tile computed.
//
// A, B and C are row-major with a unit last stride and leading dimensions
// as arguments, so windows of a larger buffer go in as they are.  Loads are
// guarded by (m, k, n) and by the buffer extents, so no padded copy is
// needed.  Both A beyond k and B beyond k are masked, as the oracle masks
// them (ref.py), so NaN or Inf in the padding cannot reach the output.
//
// Bound on the H100: operations.  At the sweep's 2048^3 fp32 buffer the
// product makes 17.2 GFLOP (0.256 ms at 67 TFLOP/s fp32) and moves 50 MB
// (0.015 ms).  The design is the classic register-blocked product on the
// CUDA cores: a block of 256 threads owns a 128 x 128 output tile; tiles of
// A (128 x 8, stored transposed) and B (8 x 128) are staged in shared
// memory in two buffers, the next pair held in registers while the current
// one is consumed; each thread accumulates an 8 x 8 sub-tile in fp32
// registers, so one 16-byte shared load feeds 16 FMAs.  bf16 inputs are
// widened to fp32 on the way into shared memory; the output is rounded to
// A's type once.  Tensor-core products (wgmma) with TMA staging are later
// work: they would change fp32 numerics (TF32) and are the way to the bf16
// peak.
#include "../../common/csrc/common.cuh"

namespace repro {
namespace {

constexpr int kBM = 128;          // output rows of a block
constexpr int kBN = 128;          // output columns of a block
constexpr int kBK = 8;            // reduction depth of one staged tile
constexpr int kPad = 4;           // keeps transposed A stores off one bank
constexpr int kThreads = 256;
constexpr int kVecA = 1, kVecB = 2, kVecC = 4;

struct MMArgs {
  const void* a;
  const void* b;
  void* c;
  const int* dims;                // flex: [m, k, n] in device memory
  int Mx, Kx, Nx;
  long long lda, ldb, ldc;
  int vec;                        // kVec* bits: 4-wide access is aligned
};

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive values, the first 4-element aligned.
__device__ inline void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ inline void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  Word<__nv_bfloat16>::unpack(v.x, out);
  Word<__nv_bfloat16>::unpack(v.y, out + 2);
}
__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(Word<__nv_bfloat16>::pack(v), Word<__nv_bfloat16>::pack(v + 2));
}

template <typename T, bool FLEX>
__global__ void __launch_bounds__(kThreads, 2) filco_mm_kernel(MMArgs p) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

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
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;

  if (FLEX && (row0 >= m || col0 >= n)) {
    // dead tile: no loads, no products, zeros over the tile
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = row0 + i / kBN;
      const int c = col0 + i % kBN;
      if (r < p.Mx && c < p.Nx) C[r * p.ldc + c] = from_f<T>(0.f);
    }
    return;
  }

  // staging: A row ar, reduction columns ac..ac+3; B reduction row br,
  // columns bc..bc+3
  const int ar = tid >> 1, ac = (tid & 1) * 4;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const bool a_live = row0 + ar < m;
  const T* a_row = A + (a_live ? (row0 + ar) * p.lda : 0);
  const int b_col = col0 + bc;
  const bool vec_a = p.vec & kVecA, vec_b = p.vec & kVecB;
  float ra[4], rb[4];

  auto fetch = [&](int k0) {
    const int kc = k0 + ac;
    if (vec_a && a_live && kc + 3 < k) {
      load4(a_row + kc, ra);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = (a_live && kc + i < k) ? to_f(a_row[kc + i]) : 0.f;
    }
    const int kr = k0 + br;
    const T* b_row = B + (kr < k ? kr * p.ldb : 0);
    if (vec_b && kr < k && b_col + 3 < n) {
      load4(b_row + b_col, rb);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[i] = (kr < k && b_col + i < n) ? to_f(b_row[b_col + i]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][ac + i][ar] = ra[i];
    *reinterpret_cast<float4*>(&Bs[buf][br][bc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  // this thread's 8 x 8 outputs: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns likewise from tx
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int tiles = (k + kBK - 1) / kBK;
  if (tiles > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) fetch((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < tiles) stage(cur ^ 1);
    __syncthreads();
  }

  // epilogue: valid outputs rounded to T, zeros elsewhere of the buffer
  const bool vec_c = p.vec & kVecC;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ih * 64 + ty * 4 + i;
      if (r >= p.Mx) continue;
      T* c_row = C + r * p.ldc;
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        const int c = col0 + jh * 64 + tx * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = (r < m && c + j < n) ? acc[ih * 4 + i][jh * 4 + j] : 0.f;
        if (vec_c && c + 3 < p.Nx) {
          store4(c_row + c, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < p.Nx) c_row[c + j] = from_f<T>(v[j]);
        }
      }
    }
  }
}

template <typename T, bool FLEX>
cudaError_t launch(const MMArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Nx + kBN - 1) / kBN, (a.Mx + kBM - 1) / kBM);
  filco_mm_kernel<T, FLEX><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool FLEX>
int dispatch(const MMArgs& a, int dtype, void* stream) {
  if (a.Mx == 0 || a.Nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch<float, FLEX>(a, s));
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16, FLEX>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// a: (Mx, Kx) leading dim lda; b: (Kx, Nx) ldb; c: (Mx, Nx) ldc, all of
// one dtype (0 fp32, 1 bf16) with a unit last stride; dims: device int32
// [m, k, n].  vec: bit 0/1/2 when A/B/C rows take aligned 4-wide access.
// Returns cudaGetLastError() after the launch.
extern "C" int filco_flex_mm(const void* a, const void* b, const void* dims,
                             void* c, int Mx, int Kx, int Nx, long long lda,
                             long long ldb, long long ldc, int vec, int dtype,
                             void* stream) {
  using namespace repro;
  MMArgs args{a, b, c, static_cast<const int*>(dims), Mx, Kx, Nx,
              lda, ldb, ldc, vec};
  return dispatch<true>(args, dtype, stream);
}

extern "C" int filco_static_mm(const void* a, const void* b, void* c, int Mx,
                               int Kx, int Nx, long long lda, long long ldb,
                               long long ldc, int vec, int dtype,
                               void* stream) {
  using namespace repro;
  MMArgs args{a, b, c, nullptr, Mx, Kx, Nx, lda, ldb, ldc, vec};
  return dispatch<false>(args, dtype, stream);
}
