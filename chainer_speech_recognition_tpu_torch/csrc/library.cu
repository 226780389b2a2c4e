// Library-wide helpers for the ctypes wrapper.
#include "common.cuh"

CSR_API const char* csr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
