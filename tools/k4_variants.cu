// The first design of K4 and two simpler shapes of the 27-point stencil,
// kept beside K4 (cudecomp_tpu_torch/csrc/stencil27.cu) only to be timed
// against it by tools/k4_variants.py.  The port never calls them.
//
// All three compute what K4 computes, in K4's two input modes (valid mode
// over the extended block; ghost-plane mode, each dim wrapping or reading
// its ghost planes, a cell in two ghost planes reading 0), with the taps
// summed in K4's order, in float or double:
//
//   * variant 0 ("pr2"): K4 as it was built first: 32 (z) x 16 (y) tiles
//     marching along x through chunks of 32 planes, every plane of the tile
//     and its one-cell ring copied by 4-byte cp.async into a ring of
//     shared-memory buffers, one __syncthreads() per plane, each plane read
//     from shared memory for each of the three output planes it serves.
//     Compiled with one of the macros below, it has one part taken out or
//     changed, for tools/k4_variants.py --ablate (each ablation but
//     K4_VEC16 and K4_XCHUNK computes a wrong result: only its time means
//     something):
//       K4_NO_FMA   no tap arithmetic: each output is its centre cell;
//       K4_NO_SYNC  no per-plane __syncthreads();
//       K4_VEC16    ring rows start 3 cells into a 40-cell row, so the
//                   tile's interior is 16-byte aligned in shared memory,
//                   and, when every dim wraps and mz % 32 == 0, it comes in
//                   as 16-byte copies and only the two ring columns as
//                   4-byte ones;
//       K4_XCHUNK=n x-chunks of n planes (0: one chunk of mx);
//   * variant 1 ("naive"): one thread per output; each tap of the set is a
//     load through L1, at an offset from the cell's own worked out once per
//     dim (a cell next to a ghost plane takes a slower general path);
//   * variant 2 ("march"): one thread per (y, z) column of kMarch outputs
//     along x, keeping the 3x3 neighbourhood of the last three planes in
//     registers, so each plane's cells are loaded once per column.
//
// Variants 1 and 2 are each compiled for the face tap set and for the
// dense one, and a launch picks the smallest that holds the nonzero taps.
// Plain C interface for ctypes, as K4's.

#include <cuda_pipeline.h>
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


// -- variant 0: the first design of K4 --------------------------------------

namespace pr2 {

constexpr int kTZ = 32;      // tile along z, the contiguous dim: one warp
constexpr int kRows = 4;     // thread rows: one warp per row
constexpr int kPer = 4;      // consecutive outputs per thread along y
constexpr int kTY = kRows * kPer;
#ifdef K4_XCHUNK
constexpr int kXChunk = K4_XCHUNK;  // 0: one chunk of mx planes
#else
constexpr int kXChunk = 32;
#endif
#ifdef K4_VEC16
constexpr int kZOff = 3;     // z0 - 1 at cell 3: z0 at a 16-byte boundary
constexpr int kPitch = 40;
#else
constexpr int kZOff = 0;
constexpr int kPitch = kTZ + 2;
#endif
template <typename T>
constexpr int kStages = sizeof(T) == 4 ? 8 : 5;
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 2;
constexpr int kRingY = kTY + 2;
constexpr int kRingZ = kTZ + 2;
constexpr int kThreads = kRows * kTZ;
constexpr int kLoads = (kRingY * kRingZ + kThreads - 1) / kThreads;

enum Kind : int { kBlock, kGyLo, kGyHi, kGzLo, kGzHi, kZero, kNone };

template <typename T, bool kValid>
__device__ __forceinline__ void plan_slots(const Args<T>& a, int64_t y0,
                                           int64_t z0, int (&kind)[kLoads],
                                           int64_t (&off)[kLoads]) {
  const int tid = threadIdx.y * kTZ + threadIdx.x;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int i = tid + l * kThreads;
    kind[l] = kNone;
    off[l] = 0;
    if (i >= kRingY * kRingZ) continue;
    int64_t y = y0 - 1 + i / kRingZ;
    int64_t z = z0 - 1 + i % kRingZ;
    kind[l] = kZero;
    if (y > a.my || z > a.mz) continue;
    if constexpr (kValid) {
      kind[l] = kBlock;
      off[l] = (y + 1) * (a.mz + 2) + z + 1;
    } else {
      const int sy = resolve(y, a.my, a.wrap & 2u);
      const int sz = resolve(z, a.mz, a.wrap & 4u);
      if (sy < 0 && sz < 0) {
        kind[l] = kBlock;
        off[l] = y * a.mz + z;
      } else if (sz < 0) {
        kind[l] = kGyLo + sy;
        off[l] = z;
      } else if (sy < 0) {
        kind[l] = kGzLo + sz;
        off[l] = y;
      }
    }
  }
}

template <typename T, bool kValid>
__device__ __forceinline__ void issue_plane(T (*plane)[kPitch],
                                            const Args<T>& a, int64_t x,
                                            int64_t y0, int64_t z0,
                                            const int (&kind)[kLoads],
                                            const int64_t (&off)[kLoads]) {
  const int tid = threadIdx.y * kTZ + threadIdx.x;
  int sx = -1;
  const T* base = a.u;
  if constexpr (kValid) {
    base = a.u + (x + 1) * (a.my + 2) * (a.mz + 2);
  } else {
    sx = resolve(x, a.mx, a.wrap & 1u);
    base = sx < 0 ? a.u + x * a.my * a.mz : (sx ? a.gx[1] : a.gx[0]);
  }
#ifdef K4_VEC16
  if (!kValid && a.wrap == 7u && a.mz % kTZ == 0 && sizeof(T) == 4) {
    // 16-byte copies of each ring row's interior, 4-byte ones for its two
    // ring columns
    for (int i = tid; i < kRingY * (kTZ / 4 + 2); i += kThreads) {
      const int r = i / (kTZ / 4 + 2);
      const int c = i % (kTZ / 4 + 2);
      int64_t y = y0 - 1 + r;
      if (y > a.my) continue;  // past the ring: never read
      resolve(y, a.my, true);
      if (c < kTZ / 4) {
        const int64_t z = z0 + 4 * c;
        if (z < a.mz)
          __pipeline_memcpy_async(&plane[r][kZOff + 1 + 4 * c],
                                  base + y * a.mz + z, 16);
      } else {
        int64_t z = c == kTZ / 4 ? z0 - 1 : z0 + kTZ;
        if (z <= a.mz) {
          resolve(z, a.mz, true);
          __pipeline_memcpy_async(
              &plane[r][kZOff + (c == kTZ / 4 ? 0 : kTZ + 1)],
              base + y * a.mz + z, sizeof(T));
        }
      }
    }
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    if (kind[l] == kNone) continue;
    const int i = tid + l * kThreads;
    T* dst = &plane[i / kRingZ][kZOff + i % kRingZ];
    const T* src = nullptr;
    switch (kind[l]) {
      case kBlock: src = base + off[l]; break;
      case kGyLo: case kGyHi:
        if (sx < 0)
          src = (kind[l] == kGyHi ? a.gy[1] : a.gy[0]) + x * a.mz + off[l];
        break;
      case kGzLo: case kGzHi:
        if (sx < 0)
          src = (kind[l] == kGzHi ? a.gz[1] : a.gz[0]) + x * a.my + off[l];
        break;
      default: break;
    }
    if (src) __pipeline_memcpy_async(dst, src, sizeof(T));
    else *dst = T(0);
  }
}

template <typename T, bool kValid>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
stencil27_kernel(const Args<T> a, const Weights<T> w) {
  __shared__ __align__(16) T planes[kStages<T>][kRingY][kPitch];
  const int64_t chunk = kXChunk > 0 ? kXChunk : a.mx;
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTZ;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * kTY;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * chunk;
  const int64_t x1 = x0 + chunk < a.mx ? x0 + chunk : a.mx;
  const int ty = threadIdx.y;
  const int tz = threadIdx.x;

  int kind[kLoads];
  int64_t off[kLoads];
  plan_slots<T, kValid>(a, y0, z0, kind, off);
  constexpr int kAhead = kStages<T> - 3;
  auto slot = [&](int64_t p) {
    return static_cast<int>((p - x0 + 1) % kStages<T>);
  };
  auto issue = [&](int64_t p) {
    if (p <= x1)
      issue_plane<T, kValid>(planes[slot(p)], a, p, y0, z0, kind, off);
    __pipeline_commit();
  };
#pragma unroll
  for (int k = 0; k < kAhead + 1; ++k) issue(x0 - 1 + k);

  for (int64_t x = x0; x < x1; ++x) {
    issue(x + kAhead);
    __pipeline_wait_prior(kAhead - 1);
#ifndef K4_NO_SYNC
    __syncthreads();
#endif
    T acc[kPer];
#ifdef K4_NO_FMA
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      acc[q] = planes[slot(x)][ty * kPer + q + 1][kZOff + tz + 1];
#else
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[q] = T(0);
#pragma unroll
    for (int dxi = 0; dxi < 3; ++dxi) {
      const T(*pl)[kPitch] = planes[slot(x - 1 + dxi)];
      T col[3][kPer + 2];
#pragma unroll
      for (int dzi = 0; dzi < 3; ++dzi) {
        if (a.taps & (0x49u << (9 * dxi + dzi))) {
#pragma unroll
          for (int j = 0; j < kPer + 2; ++j)
            col[dzi][j] = pl[ty * kPer + j][kZOff + tz + dzi];
        }
      }
#pragma unroll
      for (int dyi = 0; dyi < 3; ++dyi) {
#pragma unroll
        for (int dzi = 0; dzi < 3; ++dzi) {
          const int t = 9 * dxi + 3 * dyi + dzi;
          if (a.taps & (1u << t)) {
            const T wt = w.w[t];
#pragma unroll
            for (int q = 0; q < kPer; ++q)
              acc[q] = madd(wt, col[dzi][q + dyi], acc[q]);
          }
        }
      }
    }
#endif
    const int64_t z = z0 + tz;
    if (z < a.mz) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int64_t y = y0 + ty * kPer + q;
        if (y < a.my) a.out[(x * a.my + y) * a.mz + z] = acc[q];
      }
    }
  }
  __pipeline_wait_prior(0);
}

template <typename T>
cudaError_t launch(const Args<T>& a, const Weights<T>& w, bool valid,
                   cudaStream_t stream) {
  const int64_t chunk = kXChunk > 0 ? kXChunk : a.mx;
  const int64_t gz = (a.mz + kTZ - 1) / kTZ;
  const int64_t gy = (a.my + kTY - 1) / kTY;
  const int64_t gx = (a.mx + chunk - 1) / chunk;
  if (gz > 2147483647LL || gy > 65535 || gx > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gx));
  const dim3 block(kTZ, kRows);
  if (valid)
    stencil27_kernel<T, true><<<grid, block, 0, stream>>>(a, w);
  else
    stencil27_kernel<T, false><<<grid, block, 0, stream>>>(a, w);
  return cudaGetLastError();
}

}  // namespace pr2

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
  if (variant == 0) return pr2::launch<T>(a, w, valid, stream);
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

// The first design's arguments of cudecomp_stencil27 (elem_bytes 4 or 8),
// after the variant (0, 1 or 2).
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
