// Device queries shared by the kernel launchers.

#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// the SM count of the current device, asked once a device; 0 if the query
// fails
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return count[dev];
}

}  // namespace repro_torch
