// Host helpers shared by the kernel sources (each includes this file; the
// build hashes it with the source).
#pragma once

#include <cuda_runtime.h>

namespace {

// The SM count of the first device asked; H100s all have 132.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace
