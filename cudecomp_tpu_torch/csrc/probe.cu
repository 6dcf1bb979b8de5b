// K0: the probe copy, compiled into every library of the package.
//
// Replaces the TPU probe of cudecomp_tpu/ops/pallas_kernels.py:
// _platform_supports_pallas (its copy_kernel, launched at :162), which
// proves once per platform that the device builds and runs a kernel before
// a path relies on it.  utils/cuda_build.load launches this copy once per
// loaded library on an (8, 128) float32 tensor, synchronises and compares
// the result bit for bit, so a broken toolkit, driver or fat binary fails at
// load, naming the library, and not in the middle of a path.
//
// 8 KiB of traffic: what bounds it is the launch itself, a few microseconds.
// The empty kernel beside it measures that launch floor: a launch of one
// thread that does nothing, so that K0's time can be held to it.
//
// The file also carries the error-string entry that every library's
// wrapper uses to report a failed launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void probe_copy_kernel(const float* __restrict__ in,
                                  float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) out[i] = in[i];
}

__global__ void probe_empty_kernel() {}

}  // namespace

// Launches the empty kernel (one block of one thread) on the caller's
// stream; returns cudaGetLastError().
extern "C" int cudecomp_probe_empty(void* stream) {
  probe_empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// Copies n floats on the caller's stream; returns cudaGetLastError().
extern "C" int cudecomp_probe_copy(const void* in, void* out, int64_t n,
                                   void* stream) {
  if (n <= 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  probe_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n);
  return cudaGetLastError();
}

extern "C" const char* cudecomp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
