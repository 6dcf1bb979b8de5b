// K4: the weighted 3x3x3 (27-point) stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel cudecomp_tpu/ops/stencil.py: _stencil27_kernel,
// launched by _ghost_plane_call.  It computes, in memory-dim order,
//
//   out[i,j,k] = sum over the nonzero taps of
//                w[1+dx,1+dy,1+dz] * E(i+dx, j+dy, k+dz)
//
// with the taps summed in JAX's order (dx, then dy, then dz ascending), in
// the tensor's type (float or double), and E the input extended by one cell
// on each side of each dim, in one of two input modes:
//
//   * valid mode: the input IS the extended block, (mx+2, my+2, mz+2), built
//     by the stencil path's ghost extension (halo_map's form, stencil.py:465);
//   * ghost-plane mode: the input is the (mx, my, mz) block, and for each dim
//     past its edge either the index wraps modulo the extent (a local periodic
//     dim: the TPU's pltpu.roll) or the value comes from a ghost plane of
//     that dim, (1, my, mz), (mx, 1, mz) or (mx, my, 1), sent by the
//     neighbouring rank or zero at a non-periodic edge.  Wrap coordinates are
//     resolved first; a cell that still lies in two ghost planes at once (a
//     ghost edge or corner) reads 0.  The stencil path only sends tap sets
//     that never read such a cell (JAX's tap_ok, stencil.py:433-440).
//
// What bounds it: one read and one write of the field, 8 bytes per f32 cell
// (1.07 GB at 512^3, 0.320 ms at 3.35 TB/s); 27 taps are 54 flops a cell,
// far under the card's FP32 rate.  So the design keeps every input byte to
// one trip from device memory and enough bytes in flight to cover its
// latency:
//
//   * 2.5D blocking: a block owns a 32 (z) x 16 (y) tile of outputs and
//     marches along x through a chunk of 32 planes.  The planes of the
//     tile plus its one-cell ring stream through a ring of kStages
//     shared-memory buffers: three (x-1, x, x+1) are computed on while the
//     next ones arrive by cp.async, with no registers spent on staging, and
//     one barrier per plane.  The ring's cells come mostly from L2, loaded
//     by the neighbouring tiles;
//   * where each of a thread's cells of the ring comes from (the block, a
//     ghost plane, or nothing) depends only on its y and z, so it is worked
//     out once per block; per plane only the x coordinate is resolved;
//   * 128 threads, each computing 4 consecutive outputs along y: a thread
//     reads each needed column of 6 cells of a plane once into registers
//     and uses it for all 4 outputs (54 shared-memory reads per 4 outputs
//     for the dense 27-tap set, not 108);
//   * a warp spans 32 consecutive z, so copies and stores are coalesced;
//   * weights travel by value in the kernel's parameters, zero taps are
//     skipped by uniform branches, and the sum is an FMA chain;
//   * ragged edges are masked, so any extents >= 1 run, and offsets are
//     64-bit.
//
// Measured at 512^3 f32 on one H100 (PERF.md): about half of clone()'s
// rate, the same for 7 and 27 taps.  tools/k4_variants.py times it beside
// two sync-free shapes that read through L1, one thread per output and one
// thread per x-column with the neighbourhood in registers.  For the 7-tap
// set in valid mode both are faster than this kernel, the column shape by
// a third; in the wrap mode of the one-card path, and for 27 taps in every
// mode, both are slower.  Closing the gap is later work.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTZ = 32;      // tile along z, the contiguous dim: one warp
constexpr int kRows = 4;     // thread rows: one warp per row
constexpr int kPer = 4;      // consecutive outputs per thread along y
constexpr int kTY = kRows * kPer;  // tile along y
constexpr int kXChunk = 32;  // x planes one block marches through
// shared-memory plane buffers: 3 computed on, one free, the rest in flight
// (8 for f32, 5 for f64, whose planes are twice the bytes)
template <typename T>
constexpr int kStages = sizeof(T) == 4 ? 8 : 5;
// blocks per SM the register budget is cut for (f32: 6 x 128 threads)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 2;
constexpr int kRingY = kTY + 2;
constexpr int kRingZ = kTZ + 2;
constexpr int kThreads = kRows * kTZ;
constexpr int kLoads = (kRingY * kRingZ + kThreads - 1) / kThreads;

// where a cell of the tile's ring comes from
enum Kind : int { kBlock, kGyLo, kGyHi, kGzLo, kGzHi, kZero, kNone };

template <typename T>
struct Weights {
  T w[27];  // tap t = 9*(dx+1) + 3*(dy+1) + (dz+1)
};

template <typename T>
struct Args {
  const T* u;      // valid mode: (mx+2, my+2, mz+2); else (mx, my, mz)
  T* out;          // (mx, my, mz)
  const T* gx[2];  // (my, mz) planes below / above x; unused when x wraps
  const T* gy[2];  // (mx, mz)
  const T* gz[2];  // (mx, my)
  int64_t mx, my, mz;
  unsigned wrap;   // bit d: memory dim d wraps (ghost-plane mode)
  unsigned taps;   // bit t: tap t is nonzero
};

__device__ __forceinline__ float madd(float w, float v, float acc) {
  return fmaf(w, v, acc);
}

__device__ __forceinline__ double madd(double w, double v, double acc) {
  return fma(w, v, acc);
}

// Resolves one coordinate of E: in range or wrapped (returns -1, c set to
// the index), or in the ghost plane below (0) or above (1).
__device__ __forceinline__ int resolve(int64_t& c, int64_t n, bool wraps) {
  if (c >= 0 && c < n) return -1;
  if (wraps) {
    c += c < 0 ? n : -n;
    return -1;
  }
  return c >= 0;
}

// The source of each of this thread's cells of the ring, from its y and z
// only: the kind, and the offset within a plane of that kind.
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
    if (y > a.my || z > a.mz) continue;  // past the ring: never read
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
      }  // else a ghost edge: zero
    }
  }
}

// Starts the copies of plane x of the tile and its ring into `plane`.
template <typename T, bool kValid>
__device__ __forceinline__ void issue_plane(T (*plane)[kRingZ],
                                            const Args<T>& a, int64_t x,
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
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    if (kind[l] == kNone) continue;
    const int i = tid + l * kThreads;
    T* dst = &plane[i / kRingZ][i % kRingZ];
    const T* src = nullptr;
    switch (kind[l]) {
      case kBlock: src = base + off[l]; break;
      case kGyLo: case kGyHi:  // x off its plane: a ghost edge, zero
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
  __shared__ T planes[kStages<T>][kRingY][kRingZ];
  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTZ;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * kTY;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * kXChunk;
  const int64_t x1 = x0 + kXChunk < a.mx ? x0 + kXChunk : a.mx;
  const int ty = threadIdx.y;
  const int tz = threadIdx.x;

  int kind[kLoads];
  int64_t off[kLoads];
  plan_slots<T, kValid>(a, y0, z0, kind, off);
  // plane x + kAhead is issued at iteration x, into the buffer of plane
  // x - 3, which every thread finished with before this iteration's
  // barrier: so one barrier per plane is enough
  constexpr int kAhead = kStages<T> - 3;
  // plane p lives in buffer (p - x0 + 1) % kStages; planes x0-1 .. x1
  auto slot = [&](int64_t p) {
    return static_cast<int>((p - x0 + 1) % kStages<T>);
  };
  auto issue = [&](int64_t p) {
    if (p <= x1) issue_plane<T, kValid>(planes[slot(p)], a, p, kind, off);
    __pipeline_commit();  // one group per plane, empty past x1
  };
#pragma unroll
  for (int k = 0; k < kAhead + 1; ++k) issue(x0 - 1 + k);

  for (int64_t x = x0; x < x1; ++x) {
    issue(x + kAhead);
    __pipeline_wait_prior(kAhead - 1);  // planes up to x + 1 have landed
    __syncthreads();
    T acc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[q] = T(0);
#pragma unroll
    for (int dxi = 0; dxi < 3; ++dxi) {
      const T(*pl)[kRingZ] = planes[slot(x - 1 + dxi)];
      T col[3][kPer + 2];
#pragma unroll
      for (int dzi = 0; dzi < 3; ++dzi) {
        if (a.taps & (0x49u << (9 * dxi + dzi))) {  // any tap (dx, *, dz)
#pragma unroll
          for (int j = 0; j < kPer + 2; ++j)
            col[dzi][j] = pl[ty * kPer + j][tz + dzi];
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
cudaError_t launch(const void* u, void* out, const void* const* ghosts,
                   int64_t mx, int64_t my, int64_t mz, unsigned wrap,
                   bool valid, const double* weights, cudaStream_t stream) {
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
    // a dim that does not wrap reads its two ghost planes
    for (int d = 0; d < 3; ++d)
      if (!(wrap & (1u << d)) && (!ghosts[2 * d] || !ghosts[2 * d + 1]))
        return cudaErrorInvalidValue;
  }
  const int64_t gz = (mz + kTZ - 1) / kTZ;
  const int64_t gy = (my + kTY - 1) / kTY;
  const int64_t gx = (mx + kXChunk - 1) / kXChunk;
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

}  // namespace

// out (mx, my, mz) <- the stencil of u.  valid != 0: u is the extended
// (mx+2, my+2, mz+2) block and the ghost pointers are unused.  Otherwise u
// is (mx, my, mz), bit d of `wrap` makes memory dim d wrap, and the ghost
// planes (x below, x above, y below, y above, z below, z above) of each dim
// that does not wrap must be given.  weights: 27 doubles in tap order,
// rounded to the element type.  elem_bytes: 4 (float) or 8 (double).
extern "C" int cudecomp_stencil27(const void* u, void* out, const void* gxlo,
                                  const void* gxhi, const void* gylo,
                                  const void* gyhi, const void* gzlo,
                                  const void* gzhi, int64_t mx, int64_t my,
                                  int64_t mz, int wrap, int valid,
                                  const double* weights, int elem_bytes,
                                  void* stream) {
  if (mx <= 0 || my <= 0 || mz <= 0) return cudaSuccess;
  const void* ghosts[6] = {gxlo, gxhi, gylo, gyhi, gzlo, gzhi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned wr = static_cast<unsigned>(wrap) & 7u;
  switch (elem_bytes) {
    case 4:
      return launch<float>(u, out, ghosts, mx, my, mz, wr, valid != 0,
                           weights, s);
    case 8:
      return launch<double>(u, out, ghosts, mx, my, mz, wr, valid != 0,
                            weights, s);
    default:
      return cudaErrorInvalidValue;
  }
}
