// The text of a cudaError_t returned by the launchers, for the Python
// wrappers' error messages.
#include <cuda_runtime.h>

extern "C" const char* amc3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
