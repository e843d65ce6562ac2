// C entry points shared by every kernel of the library.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
