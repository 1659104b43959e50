// Launch helpers shared by the kernels' C entry points.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace zk
