// K5: dense DFT over dims 1 and 2 of a complex64 (X, N1, N2) tensor, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cudecomp_tpu/ops/mxu_fft.py: dft2_fused (:392),
// which contracts the Y then the Z axis of (bx, N1, N2) blocks in VMEM on
// the MXU.  It computes
//
//     out[b, Y, C] = sum_c (sum_y x[b, y, c] * Wy[y, Y]) * Wz[c, C]
//
// with complex weights W = cos + i * (sign) sin from the wrapper
// (ops/dft2.py); the inverse's 1/(N1*N2) scale is already folded into Wz.
//
// What bounds it: this kernel is bound by its own operations.  A dense
// DFT of the pair costs 8 * N1 * N2 * (N1 + N2) float32 flops per x-plane
// (4 real FMAs per complex multiply-add), against 16 bytes per element
// read and written: at N1 = N2 = 256 that is 256 flops per byte, far above
// the card's 20 flops per byte of float32 FMA rate over HBM bandwidth.
// The transform itself needs only 5 * N1 * N2 * log2(N1 * N2) flops per
// plane done as an FFT, so the least time for the function is that of
// its bytes, which cuFFT comes near and a dense DFT cannot.
//
// Design, right and simple first:
//   * one block per (x-plane b, tile of TY = 16 output rows Y), N2
//     threads; the 16 tiles of a plane are neighbours in launch order, so
//     the plane's 16 re-reads come from L2;
//   * stage 1: thread c walks y with coalesced loads of x[b, y, c] and
//     keeps 16 complex sums in registers; the Wy columns of the tile sit in
//     shared memory, read as float4 broadcasts;
//   * stage 2: the 16 x N2 intermediate tile goes to shared memory (over
//     the Wy staging area), and thread C walks c, reading the tile by
//     broadcast and Wz[c, C] coalesced from L2;
//   * full float32 FMAs with the 4-multiply complex product (the JAX
//     kernel pins HIGHEST precision); no TF32, no tensor cores.
// The shared rows are padded to TY + 2 complex values (144 bytes), so the
// float4 stores of the tile are free of bank conflicts.  wgmma with a
// 3xTF32 split and TMA-fed tiles are later work.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (cudecomp_cuda_error_string, in probe.cu, names the code).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 16;                 // TY: output rows per block
constexpr int kStride = kTileRows + 2;        // padded shared row (float2)
constexpr int kMaxThreads = 256;              // N2 <= 256

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 w) {
  acc.x = fmaf(a.x, w.x, acc.x);
  acc.x = fmaf(-a.y, w.y, acc.x);
  acc.y = fmaf(a.x, w.y, acc.y);
  acc.y = fmaf(a.y, w.x, acc.y);
}

__global__ void __launch_bounds__(kMaxThreads)
dft2_kernel(const float2* __restrict__ x, float2* __restrict__ out,
            const float2* __restrict__ wy, const float2* __restrict__ wz,
            int n1, int n2, int tiles) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int64_t b = blockIdx.x / tiles;
  const int y0 = static_cast<int>(blockIdx.x % tiles) * kTileRows;
  const int t = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(n1) * n2;
  const float2* xb = x + b * plane;

  // Wy[:, y0:y0+16] into sm[y * kStride + j]; columns past N1 are zero
  for (int i = t; i < n1 * kTileRows; i += blockDim.x) {
    const int y = i / kTileRows;
    const int j = i % kTileRows;
    sm[y * kStride + j] = (y0 + j < n1)
        ? wy[static_cast<int64_t>(y) * n1 + y0 + j] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // stage 1: acc[j] = sum_y x[b, y, t] * Wy[y, y0 + j]
  float2 acc[kTileRows];
#pragma unroll
  for (int j = 0; j < kTileRows; ++j) acc[j] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int y = 0; y < n1; ++y) {
    const float2 v = xb[static_cast<int64_t>(y) * n2 + t];
    const float4* w4 = reinterpret_cast<const float4*>(sm + y * kStride);
#pragma unroll
    for (int q = 0; q < kTileRows / 2; ++q) {
      const float4 w = w4[q];
      cmac(acc[2 * q], v, make_float2(w.x, w.y));
      cmac(acc[2 * q + 1], v, make_float2(w.z, w.w));
    }
  }
  __syncthreads();  // every thread is done with the Wy staging area

  // the intermediate tile, column-major: sm[c * kStride + j]
  float4* row = reinterpret_cast<float4*>(sm + t * kStride);
#pragma unroll
  for (int q = 0; q < kTileRows / 2; ++q)
    row[q] = make_float4(acc[2 * q].x, acc[2 * q].y, acc[2 * q + 1].x,
                         acc[2 * q + 1].y);
  __syncthreads();

  // stage 2: o[j] = sum_c tile[j, c] * Wz[c, t]
  float2 o[kTileRows];
#pragma unroll
  for (int j = 0; j < kTileRows; ++j) o[j] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < n2; ++c) {
    const float2 w = wz[static_cast<int64_t>(c) * n2 + t];
    const float4* a4 = reinterpret_cast<const float4*>(sm + c * kStride);
#pragma unroll
    for (int q = 0; q < kTileRows / 2; ++q) {
      const float4 a = a4[q];
      cmac(o[2 * q], make_float2(a.x, a.y), w);
      cmac(o[2 * q + 1], make_float2(a.z, a.w), w);
    }
  }

  float2* ob = out + b * plane;
#pragma unroll
  for (int j = 0; j < kTileRows; ++j)
    if (y0 + j < n1) ob[static_cast<int64_t>(y0 + j) * n2 + t] = o[j];
}

// Shared memory a launch needs for extents n1, n2 (bytes).
int64_t smem_bytes(int n1, int n2) {
  const int64_t rows = n1 > n2 ? n1 : n2;
  return rows * kStride * static_cast<int64_t>(sizeof(float2));
}

}  // namespace

// out = the pair DFT of the contiguous complex64 (nx, n1, n2) tensor x with
// the complex64 weights wy (n1, n1) and wz (n2, n2).
extern "C" int cudecomp_dft2(const void* x, void* out, const void* wy,
                             const void* wz, int64_t nx, int n1, int n2,
                             void* stream) {
  if (nx <= 0) return cudaSuccess;
  if (n1 <= 0 || n2 <= 0 || n2 > kMaxThreads) return cudaErrorInvalidValue;
  const int tiles = (n1 + kTileRows - 1) / kTileRows;
  const int64_t blocks = nx * tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const int64_t smem = smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dft2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch check reads it
      return err;
    }
  }
  dft2_kernel<<<static_cast<unsigned>(blocks), n2, static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out),
      static_cast<const float2*>(wy), static_cast<const float2*>(wz), n1, n2,
      tiles);
  return cudaGetLastError();
}
