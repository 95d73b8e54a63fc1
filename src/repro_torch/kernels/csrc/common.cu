// Error-string lookup for the ctypes wrappers (the launchers return the
// integer code of cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
