// Helpers shared by the port's kernels.
//
// In the CUDA-core attention kernels tiles live in shared memory as rows of
// 32-bit words: a word holds one fp32 value or two bf16 values.  A row is
// padded by one word, so threads that read the same word index of
// consecutive rows hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;   // the reference's finite mask fill
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> struct Word;

template <> struct Word<float> {
  static constexpr int N = 1;       // values per 32-bit word
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
  __device__ static uint32_t pack(const float* in) {
    return __float_as_uint(in[0]);
  }
  // an fp32 value cast to this type and back (astype before a product)
  __device__ static float round(float x) { return x; }
};

template <> struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  __device__ static void unpack(uint32_t w, float* out) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
    float2 f = __bfloat1622float2(h);
    out[0] = f.x;
    out[1] = f.y;
  }
  __device__ static uint32_t pack(const float* in) {
    __nv_bfloat162 h = __floats2bfloat162_rn(in[0], in[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Copy `rows` rows of `row_words` words from global memory (16-byte loads;
// rows start 16-byte aligned) into shared memory with a row pitch of
// `pitch` words.  Rows at or past `valid_rows` are filled with zeros.
__device__ inline void load_rows(uint32_t* dst, int pitch, const char* src,
                                 long long row_bytes, int rows,
                                 int valid_rows, int row_words, int tid,
                                 int nthreads) {
  const int per_row = row_words / 4;
  const int total = rows * per_row;
  for (int c = tid; c < total; c += nthreads) {
    const int r = c / per_row;
    const int ch = c - r * per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      val = *reinterpret_cast<const uint4*>(src + r * row_bytes + ch * 16);
    }
    uint32_t* d = dst + r * pitch + ch * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int WIDTH>
__device__ inline float group_max(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

template <int WIDTH>
__device__ inline float group_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// ---------------------------------------------------------------------------
// asynchronous copies and tensor-core products (mma.sync)
// ---------------------------------------------------------------------------

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (no global read)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 16 bytes of which the first `bytes` (0..16) are read from global memory
// and the rest zero-filled; src is 16-byte aligned
__device__ inline void cp_async16_zfill(void* dst, const void* src,
                                        int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}

// 4 bytes, or 4 zero bytes when !valid (no global read)
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

template <int N>   // wait until at most N committed groups are in flight
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16 x 16, row) . b (16 x 8, col); bf16 in, fp32 sums
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// programmatic dependent launch (Hopper)
// ---------------------------------------------------------------------------

// Let the next kernel on the stream start launching now; it still waits in
// pdl_wait() for this grid's completion before it touches what we write.
__device__ inline void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Wait until the previous kernel on the stream has completed and its writes
// are visible.  A no-op for a kernel launched without the attribute.
__device__ inline void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launch `kernel` on `stream`; with `overlap`, as a programmatic dependent
// of the kernel before it, so that it may start while that one runs.
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block,
                          size_t smem, cudaStream_t stream, bool overlap,
                          Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
