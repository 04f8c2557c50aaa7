// Error text for the status codes the kernel launchers return.

#include <cuda_runtime.h>

extern "C" const char* repro_torch_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
