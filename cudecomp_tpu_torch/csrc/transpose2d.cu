// K1: tiled 2D transpose (M, N) -> (N, M) for Hopper (sm_90a).
//
// Replaces the TPU kernel cudecomp_tpu/ops/pallas_kernels.py:
// pallas_transpose2d (with pallas_cyclic_permute on top).  The transpose
// engine's slab path composes every communication-free transpose into one
// cyclic 3D permute, and a cyclic permute keeps two adjacent dims together:
// (1,2,0) is (I, J*K)^T and (2,0,1) is (I*J, K)^T.  So one 2D transpose
// does every such permute in one read and one write of device memory.
//
// The work is pure data movement, so the bound is device-memory bandwidth.
// Design, right and simple first:
//   * a 32x32 tile staged in shared memory, padded by one element so the
//     column reads of the write phase fall in different banks;
//   * 32x8 threads per block, each moving 4 elements per phase: reads and
//     writes are both row-contiguous across a warp (coalesced);
//   * the element is copied raw as `words` words of 1, 2, 4, 8 or 16 bytes
//     (bf16, f32, f64/c64, c128, or any of them with trailing component
//     dims: a 3-component f32 field is 3 words of 4 bytes).  The common
//     case is one word; a wider element goes through the tile one word at a
//     time, right but with strided accesses;
//   * ragged edges are masked in the kernel, so any (M, N) is accepted;
//   * the dim with more tiles goes on gridDim.x (gridDim.y stops at
//     65535), and offsets are 64-bit (1024^3 c64 is 8 GiB).
// Wider accesses (16 bytes per thread for small elements) and TMA tiles are
// left to later work.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (cudecomp_cuda_error_string, in probe.cu, names the code).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // each thread moves kTile / kRows = 4 elements

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
transpose2d_kernel(const T* __restrict__ in, T* __restrict__ out,
                   int64_t M, int64_t N, int64_t words, bool n_on_x) {
  __shared__ T tile[kTile][kTile + 1];
  const int64_t tile_n = n_on_x ? blockIdx.x : blockIdx.y;
  const int64_t tile_m = n_on_x ? blockIdx.y : blockIdx.x;
  const int64_t m0 = tile_m * kTile;
  const int64_t n0 = tile_n * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  const int64_t col = n0 + tx;
  const int64_t ocol = m0 + tx;
  for (int64_t w = 0; w < words; ++w) {
    if (w > 0) __syncthreads();  // the previous word's tile has been read
    // read input rows m0+ty+k at column n0+tx: a warp reads 32 consecutive
    // elements of one row
#pragma unroll
    for (int k = 0; k < kTile; k += kRows) {
      const int64_t row = m0 + ty + k;
      if (row < M && col < N)
        tile[ty + k][tx] = in[(row * N + col) * words + w];
    }
    __syncthreads();
    // write output rows n0+ty+k at column m0+tx: out[n][m] = in[m][n]
#pragma unroll
    for (int k = 0; k < kTile; k += kRows) {
      const int64_t orow = n0 + ty + k;
      if (orow < N && ocol < M)
        out[(orow * M + ocol) * words + w] = tile[tx][ty + k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, int64_t M, int64_t N,
                   int64_t words, cudaStream_t stream) {
  const int64_t tiles_m = (M + kTile - 1) / kTile;
  const int64_t tiles_n = (N + kTile - 1) / kTile;
  const bool n_on_x = tiles_n >= tiles_m;
  const int64_t gx = n_on_x ? tiles_n : tiles_m;
  const int64_t gy = n_on_x ? tiles_m : tiles_n;
  if (gy > 65535 || gx > 2147483647LL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(kTile, kRows);
  transpose2d_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), M, N, words, n_on_x);
  return cudaGetLastError();
}

}  // namespace

// Transposes (M, N) elements of `words` words of `word_bytes` bytes each.
extern "C" int cudecomp_transpose2d(const void* in, void* out, int64_t M,
                                    int64_t N, int64_t word_bytes,
                                    int64_t words, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (words <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 1: return launch<uint8_t>(in, out, M, N, words, s);
    case 2: return launch<uint16_t>(in, out, M, N, words, s);
    case 4: return launch<uint32_t>(in, out, M, N, words, s);
    case 8: return launch<uint64_t>(in, out, M, N, words, s);
    case 16: return launch<uint4>(in, out, M, N, words, s);
    default: return cudaErrorInvalidValue;
  }
}
