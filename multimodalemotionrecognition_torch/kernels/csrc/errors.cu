// Error text for the codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
