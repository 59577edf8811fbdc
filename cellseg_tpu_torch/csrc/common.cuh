// Shared definitions for the port's CUDA kernels (one .so per .cu file).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Label of an unreached / unmasked pixel (the JAX package's _INF).
#define CELLSEG_INF 2147483647

// Readable text for the error codes the C entry points return.
extern "C" const char* cellseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
