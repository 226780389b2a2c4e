// Shared by the port's kernels: C linkage for the ctypes loader
// (chainer_speech_recognition_tpu_torch/_kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CSR_API extern "C" __attribute__((visibility("default")))

// Every entry point returns the launch status; the Python wrapper raises
// if it is not cudaSuccess.
#define CSR_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
