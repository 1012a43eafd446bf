// The message of a cudaError_t returned by one of the library's launch
// functions, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
