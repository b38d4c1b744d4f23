// Runs a C entry point's body on a given CUDA device and gives the caller's
// current device back on every return, so that a launch on card 1 does not
// move the current device of a process that works on card 0.

#pragma once

#include <cuda_runtime.h>

namespace pivk {

// body() returns a cudaError_t as int; the first error (of the switch, the body or
// the switch back) is returned.
template <class Body>
int on_device(int device, Body&& body) {
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (caller == device) return body();
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rc = body();
  err = cudaSetDevice(caller);
  return rc != 0 ? rc : (int)err;
}

}  // namespace pivk
