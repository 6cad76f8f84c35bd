// Error text for the codes the kernel entry points return.

#include <cuda_runtime.h>

extern "C" const char* grove_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
