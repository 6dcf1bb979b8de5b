// Two simpler shapes of the 27-point stencil, kept beside K4
// (cudecomp_tpu_torch/csrc/stencil27.cu) only to be timed against it by
// tools/k4_variants.py.  The port never calls them.
//
// Both compute what K4 computes, in K4's two input modes (valid mode over
// the extended block; ghost-plane mode, each dim wrapping or reading its
// ghost planes, a cell in two ghost planes reading 0), with the taps summed
// in K4's order, and read the input through L1 with no shared memory and no
// barrier.  Each is compiled for the face tap set and for the dense one,
// and a launch picks the smallest that holds the nonzero taps:
//
//   * variant 1 ("naive"): one thread per output; each tap of the set is a
//     load, at an offset from the cell's own worked out once per dim (a
//     cell next to a ghost plane takes a slower general path);
//   * variant 2 ("march"): one thread per (y, z) column of kMarch outputs
//     along x, keeping the 3x3 neighbourhood of the last three planes in
//     registers, so each plane's cells are loaded once per column.
//
// Plain C interface for ctypes, as K4's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTZ = 32;
constexpr int kTY = 8;
constexpr int kMarch = 16;
// blocks per SM the march's register budget is cut for
constexpr int kMarchBlocks = 4;

template <typename T>
struct Weights {
  T w[27];  // tap t = 9*(dx+1) + 3*(dy+1) + (dz+1)
};

template <typename T>
struct Args {
  const T* u;
  T* out;
  const T* gx[2];
  const T* gy[2];
  const T* gz[2];
  int64_t mx, my, mz;
  unsigned wrap;
  unsigned taps;
};

__device__ __forceinline__ float madd(float w, float v, float acc) {
  return fmaf(w, v, acc);
}

__device__ __forceinline__ double madd(double w, double v, double acc) {
  return fma(w, v, acc);
}

__device__ __forceinline__ int resolve(int64_t& c, int64_t n, bool wraps) {
  if (c >= 0 && c < n) return -1;
  if (wraps) {
    c += c < 0 ? n : -n;
    return -1;
  }
  return c >= 0;
}

// E(x, y, z): the extended block at output coordinates x, y, z in -1 .. m.
template <typename T, bool kValid>
__device__ __forceinline__ T load_e(const Args<T>& a, int64_t x, int64_t y,
                                    int64_t z) {
  if constexpr (kValid) {
    return __ldg(a.u + ((x + 1) * (a.my + 2) + y + 1) * (a.mz + 2) + z + 1);
  } else {
    const int sx = resolve(x, a.mx, a.wrap & 1u);
    const int sy = resolve(y, a.my, a.wrap & 2u);
    const int sz = resolve(z, a.mz, a.wrap & 4u);
    const int ghosts = (sx >= 0) + (sy >= 0) + (sz >= 0);
    if (ghosts == 0) return __ldg(a.u + (x * a.my + y) * a.mz + z);
    if (ghosts > 1) return T(0);
    // selects, not a.gx[sx]: a runtime index into a parameter array would
    // copy the parameters to local memory in every thread
    if (sx >= 0) return __ldg((sx ? a.gx[1] : a.gx[0]) + y * a.mz + z);
    if (sy >= 0) return __ldg((sy ? a.gy[1] : a.gy[0]) + x * a.mz + z);
    return __ldg((sz ? a.gz[1] : a.gz[0]) + x * a.my + y);
  }
}

// The element offsets of a cell's two neighbours along one dim, from the
// cell's coordinate c of n (stride apart): wrapped where the dim wraps;
// `ghost` where one of them lies in a ghost plane instead.
struct Nbr {
  int64_t lo, hi;
  bool ghost;
};

template <bool kValid>
__device__ __forceinline__ Nbr neighbours(int64_t c, int64_t n,
                                          int64_t stride, bool wraps) {
  Nbr r{-stride, stride, false};
  if (kValid) return r;  // the extended block holds every neighbour
  if (c == 0) {
    if (wraps) r.lo = (n - 1) * stride;
    else r.ghost = true;
  }
  if (c == n - 1) {
    if (wraps) r.hi = -(n - 1) * stride;
    else r.ghost = true;
  }
  return r;
}

__device__ __forceinline__ int64_t pick(int d, const Nbr& nb) {
  return d < 0 ? nb.lo : (d > 0 ? nb.hi : 0);
}

// The cell's own element of the input: E(x, y, z) sits there.
template <typename T, bool kValid>
__device__ __forceinline__ const T* centre(const Args<T>& a, int64_t x,
                                           int64_t y, int64_t z, int64_t sx,
                                           int64_t sy) {
  return kValid ? a.u + (x + 1) * sx + (y + 1) * sy + z + 1
                : a.u + x * sx + y * sy + z;
}

// The taps a variant reads are fixed when it is compiled: the face set (the
// centre and its 6 face neighbours) or all 27.  Loads are unconditional,
// so they are all issued before the first use and their latencies overlap;
// a zero weight still skips its tap's product.
constexpr unsigned kFaceTaps = (1u << 4) | (1u << 10) | (1u << 12) |
                               (1u << 13) | (1u << 14) | (1u << 16) |
                               (1u << 22);

template <bool kDense>
__host__ __device__ constexpr bool reads_tap(int t) {
  return kDense || ((kFaceTaps >> t) & 1u);
}

template <typename T, bool kValid, bool kDense>
__global__ void __launch_bounds__(kTZ * kTY)
naive_kernel(const Args<T> a, const Weights<T> w) {
  const int64_t z = static_cast<int64_t>(blockIdx.x) * kTZ + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kTY + threadIdx.y;
  const int64_t x = blockIdx.z;
  if (z >= a.mz || y >= a.my) return;
  const int64_t sy = kValid ? a.mz + 2 : a.mz;
  const int64_t sx = sy * (kValid ? a.my + 2 : a.my);
  const Nbr nx = neighbours<kValid>(x, a.mx, sx, a.wrap & 1u);
  const Nbr ny = neighbours<kValid>(y, a.my, sy, a.wrap & 2u);
  const Nbr nz = neighbours<kValid>(z, a.mz, 1, a.wrap & 4u);
  T acc = T(0);
  if (!(nx.ghost || ny.ghost || nz.ghost)) {
    const T* c = centre<T, kValid>(a, x, y, z, sx, sy);
    T v[27];
#pragma unroll
    for (int t = 0; t < 27; ++t)
      if (reads_tap<kDense>(t))
        v[t] = __ldg(c + pick(t / 9 - 1, nx) + pick((t / 3) % 3 - 1, ny) +
                     pick(t % 3 - 1, nz));
#pragma unroll
    for (int t = 0; t < 27; ++t)
      if (reads_tap<kDense>(t) && (a.taps & (1u << t)))
        acc = madd(w.w[t], v[t], acc);
  } else {  // next to a ghost plane: rare, so kept small
#pragma unroll 1
    for (int t = 0; t < 27; ++t)
      if (a.taps & (1u << t))
        acc = madd(w.w[t],
                   load_e<T, kValid>(a, x + t / 9 - 1, y + (t / 3) % 3 - 1,
                                     z + t % 3 - 1),
                   acc);
  }
  a.out[(x * a.my + y) * a.mz + z] = acc;
}

template <typename T, bool kValid, bool kDense>
__global__ void __launch_bounds__(kTZ * kTY, kMarchBlocks)
march_kernel(const Args<T> a, const Weights<T> w) {
  const int64_t z = static_cast<int64_t>(blockIdx.x) * kTZ + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kTY + threadIdx.y;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * kMarch;
  const int64_t x1 = x0 + kMarch < a.mx ? x0 + kMarch : a.mx;
  if (z >= a.mz || y >= a.my) return;
  const int64_t sy = kValid ? a.mz + 2 : a.mz;
  const int64_t sx = sy * (kValid ? a.my + 2 : a.my);
  const Nbr ny = neighbours<kValid>(y, a.my, sy, a.wrap & 2u);
  const Nbr nz = neighbours<kValid>(z, a.mz, 1, a.wrap & 4u);
  // cell k = 3*(dy+1) + (dz+1) of a plane is read when its tap on plane x
  // is (every tap of planes x-1 and x+1 has its twin on plane x)
  auto load_plane = [&](int64_t p, T(&dst)[9]) {
    int64_t q = p;  // the plane of the block that p wraps to
    const bool fast =
        !(ny.ghost || nz.ghost) && (kValid || resolve(q, a.mx, a.wrap & 1u) < 0);
    if (fast) {
      const T* c = centre<T, kValid>(a, q, y, z, sx, sy);
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (reads_tap<kDense>(9 + k))
          dst[k] = __ldg(c + pick(k / 3 - 1, ny) + pick(k % 3 - 1, nz));
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (reads_tap<kDense>(9 + k))
          dst[k] = load_e<T, kValid>(a, p, y + k / 3 - 1, z + k % 3 - 1);
    }
  };
  T win[3][9];
  load_plane(x0 - 1, win[1]);
  load_plane(x0, win[2]);
  for (int64_t x = x0; x < x1; ++x) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      win[0][k] = win[1][k];
      win[1][k] = win[2][k];
    }
    load_plane(x + 1, win[2]);
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < 27; ++t)
      if (reads_tap<kDense>(t) && (a.taps & (1u << t)))
        acc = madd(w.w[t], win[t / 9][t % 9], acc);
    a.out[(x * a.my + y) * a.mz + z] = acc;
  }
}

template <typename T, bool kDense>
void launch_variant(int variant, bool valid, dim3 grid, dim3 block,
                    cudaStream_t stream, const Args<T>& a,
                    const Weights<T>& w) {
  if (variant == 1) {
    if (valid)
      naive_kernel<T, true, kDense><<<grid, block, 0, stream>>>(a, w);
    else
      naive_kernel<T, false, kDense><<<grid, block, 0, stream>>>(a, w);
  } else {
    if (valid)
      march_kernel<T, true, kDense><<<grid, block, 0, stream>>>(a, w);
    else
      march_kernel<T, false, kDense><<<grid, block, 0, stream>>>(a, w);
  }
}

template <typename T>
cudaError_t launch(int variant, const void* u, void* out,
                   const void* const* ghosts, int64_t mx, int64_t my,
                   int64_t mz, unsigned wrap, bool valid,
                   const double* weights, cudaStream_t stream) {
  Args<T> a;
  a.u = static_cast<const T*>(u);
  a.out = static_cast<T*>(out);
  for (int s = 0; s < 2; ++s) {
    a.gx[s] = static_cast<const T*>(ghosts[s]);
    a.gy[s] = static_cast<const T*>(ghosts[2 + s]);
    a.gz[s] = static_cast<const T*>(ghosts[4 + s]);
  }
  a.mx = mx;
  a.my = my;
  a.mz = mz;
  a.wrap = wrap;
  a.taps = 0;
  Weights<T> w;
  for (int t = 0; t < 27; ++t) {
    w.w[t] = static_cast<T>(weights[t]);
    if (weights[t] != 0.0) a.taps |= 1u << t;
  }
  if (!valid) {
    for (int d = 0; d < 3; ++d)
      if (!(wrap & (1u << d)) && (!ghosts[2 * d] || !ghosts[2 * d + 1]))
        return cudaErrorInvalidValue;
  }
  const int64_t gx = variant == 1 ? mx : (mx + kMarch - 1) / kMarch;
  const int64_t gy = (my + kTY - 1) / kTY;
  const int64_t gz = (mz + kTZ - 1) / kTZ;
  if (gz > 2147483647LL || gy > 65535 || gx > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gx));
  const dim3 block(kTZ, kTY);
  if (variant != 1 && variant != 2) return cudaErrorInvalidValue;
  if (a.taps & ~kFaceTaps)
    launch_variant<T, true>(variant, valid, grid, block, stream, a, w);
  else
    launch_variant<T, false>(variant, valid, grid, block, stream, a, w);
  return cudaGetLastError();
}

}  // namespace

// The arguments of cudecomp_stencil27, after the variant (1 or 2).
extern "C" int k4_variant_stencil27(int variant, const void* u, void* out,
                                    const void* gxlo, const void* gxhi,
                                    const void* gylo, const void* gyhi,
                                    const void* gzlo, const void* gzhi,
                                    int64_t mx, int64_t my, int64_t mz,
                                    int wrap, int valid,
                                    const double* weights, int elem_bytes,
                                    void* stream) {
  if (mx <= 0 || my <= 0 || mz <= 0) return cudaSuccess;
  const void* ghosts[6] = {gxlo, gxhi, gylo, gyhi, gzlo, gzhi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned wr = static_cast<unsigned>(wrap) & 7u;
  switch (elem_bytes) {
    case 4:
      return launch<float>(variant, u, out, ghosts, mx, my, mz, wr,
                           valid != 0, weights, s);
    case 8:
      return launch<double>(variant, u, out, ghosts, mx, my, mz, wr,
                            valid != 0, weights, s);
    default:
      return cudaErrorInvalidValue;
  }
}
