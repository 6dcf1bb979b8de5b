// The cross product u x w of two 3-component fields in one pass, for Hopper
// (sm_90a): out[x,y,z,:] = u[x,y,z,:] x w[x,y,z,:].
//
// Replaces no TPU kernel.  The JAX package writes Taylor-Green's nonlinear
// term as six products, three differences and a stack
// (cudecomp_tpu/models/taylor_green.py:135-139), which XLA fuses into one
// loop.  In PyTorch the same formula is ten kernels, and the stack's copy
// is a transpose: 17 ms a call at 512^3 f32 on an H100, against a 1.44 ms
// byte bound.
//
// Layout.  The inverse r2c FFT hands over u and w with x innermost and each
// component a plane of its own; the forward FFT is handed the result in the
// layout torch.stack(..., dim=-1) gives: contiguous (X, Y, Z, 3), the
// component innermost and x outermost.  The pass reads each input element
// once and writes each output element once, so it is bound by device-memory
// bandwidth (4.83 GB a 512^3 f32 call).  Design:
//   * one block takes a tile of 32 x values by 32 z values at one y.  Its
//     32x8 threads read each input component along x, so a warp reads 32
//     consecutive elements of a plane; each thread reads 4 z values, the
//     six components of each, so 24 loads are in flight a thread;
//   * the three products go to shared memory as rows z*3 + c of 32 x
//     values, padded by one element so that both phases hit distinct banks;
//   * the write phase walks each x row of the tile, whose 96 outputs are
//     contiguous in the result: a warp writes consecutive addresses;
//   * the arithmetic is rounded as the formula's separate PyTorch kernels
//     round it (a product, then a difference; no fused multiply-add), so
//     the kernel is bit-equal to its plain twin;
//   * any strides are taken, as 64-bit element offsets; the tiling pays
//     off where x is the innermost dim of the inputs.  Ragged edges are
//     masked; the blocks are numbered on gridDim.x alone.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (cudecomp_cuda_error_string, in probe.cu, names the code).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;         // x values and z values of a tile
constexpr int kRows = 8;          // each thread reads kTile / kRows z values
constexpr int kOut = 3 * kTile;   // outputs of one x row of the tile

struct Strides {
  int64_t x, y, z, c;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
cross3_kernel(const T* __restrict__ u, const T* __restrict__ w,
              T* __restrict__ out, int64_t X, int64_t Y, int64_t Z,
              Strides su, Strides sw, int64_t tiles_x, int64_t tiles_z) {
  __shared__ T tile[kOut][kTile + 1];
  int64_t b = blockIdx.x;
  const int64_t x0 = (b % tiles_x) * kTile;
  b /= tiles_x;
  const int64_t z0 = (b % tiles_z) * kTile;
  const int64_t y = b / tiles_z;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  const int64_t x = x0 + tx;
  if (x < X) {
    const T* ub = u + x * su.x + y * su.y;
    const T* wb = w + x * sw.x + y * sw.y;
#pragma unroll
    for (int k = 0; k < kTile; k += kRows) {
      const int zl = ty + k;
      const int64_t z = z0 + zl;
      if (z < Z) {
        const T* up = ub + z * su.z;
        const T* wp = wb + z * sw.z;
        const T u0 = up[0], u1 = up[su.c], u2 = up[2 * su.c];
        const T w0 = wp[0], w1 = wp[sw.c], w2 = wp[2 * sw.c];
        tile[3 * zl + 0][tx] = sub_rn(mul_rn(u1, w2), mul_rn(u2, w1));
        tile[3 * zl + 1][tx] = sub_rn(mul_rn(u2, w0), mul_rn(u0, w2));
        tile[3 * zl + 2][tx] = sub_rn(mul_rn(u0, w1), mul_rn(u1, w0));
      }
    }
  }
  __syncthreads();

  // out[x0 + r, y, z0 + j / 3, j % 3] = tile[j][r]
  const int64_t nx = X - x0 < kTile ? X - x0 : kTile;
  const int64_t nj = 3 * (Z - z0 < kTile ? Z - z0 : kTile);
  T* ob = out + (x0 * Y + y) * Z * 3 + z0 * 3;
  const int64_t row = Y * Z * 3;
#pragma unroll
  for (int e = ty * kTile + tx; e < kTile * kOut; e += kTile * kRows) {
    const int r = e / kOut;
    const int j = e % kOut;
    if (r < nx && j < nj) ob[r * row + j] = tile[j][r];
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* w, void* out, int64_t X,
                   int64_t Y, int64_t Z, Strides su, Strides sw,
                   cudaStream_t stream) {
  const int64_t tiles_x = (X + kTile - 1) / kTile;
  const int64_t tiles_z = (Z + kTile - 1) / kTile;
  if (tiles_x * tiles_z > 2147483647LL / Y)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_z * Y));
  const dim3 block(kTile, kRows);
  cross3_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(w), static_cast<T*>(out),
      X, Y, Z, su, sw, tiles_x, tiles_z);
  return cudaGetLastError();
}

}  // namespace

// out = u x w over the last dim of (X, Y, Z, 3) fields of `elem_bytes`-byte
// floats (4 or 8); u and w at the given element strides (x, y, z, c), out
// contiguous.
extern "C" int cudecomp_cross3(const void* u, const void* w, void* out,
                               int64_t X, int64_t Y, int64_t Z, int64_t ux,
                               int64_t uy, int64_t uz, int64_t uc, int64_t wx,
                               int64_t wy, int64_t wz, int64_t wc,
                               int64_t elem_bytes, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return cudaSuccess;
  const Strides su{ux, uy, uz, uc};
  const Strides sw{wx, wy, wz, wc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4: return launch<float>(u, w, out, X, Y, Z, su, sw, s);
    case 8: return launch<double>(u, w, out, X, Y, Z, su, sw, s);
    default: return cudaErrorInvalidValue;
  }
}
