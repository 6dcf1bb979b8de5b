// C2: the spectral curl and the masked Leray projection of a complex
// (..., 3) spectral state, one pass each, for Hopper (sm_90a).  The state
// is a complex tensor or an (re, im) pair of real ones (a split-complex
// plan's planes).
//
// Replaces no TPU kernel.  The JAX package writes both operators as
// array expressions (cudecomp_tpu/ops/spectral.py: SpectralOperators.curl
// and project_solenoidal), which XLA fuses into one loop each.  Run
// eagerly in PyTorch, the same formulas are 12-16 elementwise passes over
// the state and a transposing torch.stack, and no single library call
// computes i k x v or m v - k (k . m v) / |k|^2 from per-axis wavenumber
// vectors.
//
// Per spectral point (i0, i1, i2), with kx, ky, kz read from the per-axis
// wavenumber vectors:
//   curl:     w = i k x v
//   project:  u = m v (m a real field, when given);
//             w = u - k (k . u) / |k|^2, with 1/|k|^2 pinned to 0 at k = 0
// in the plain version's order, every operation rounded on its own
// (__fmul_rn and its kin: nothing is contracted into an fma), so the
// kernel gives the plain version's bits.
//
// Bound: device-memory bandwidth.  A call reads the three components of
// each point once, and the mask's field when given, and writes the three
// components once: 2 x 1.617 GB for the (257, 512, 512, 3) complex64
// state of a 512^3 r2c grid, 0.965 ms at 3.35 TB/s (1.046 ms with TG's
// (257, 512, 512) float32 mask).  The wavenumber vectors are a few KB and
// stay in cache.  Design:
//   * every tensor is addressed through its strides, so any layout is
//     served (the two tensors of a plane pair share theirs): the component planes the FFT returns, a component-innermost
//     stack, a pencil whose wavenumbers lie along other dims.  The wrapper
//     orders the spatial dims so that dim 2 has the smallest input stride;
//     the thread index walks dim 2, so a warp's loads and stores coalesce;
//   * one point a thread; blocks of 256 threads as (x: dim 2, y: dim 1),
//     x at least one warp wide; gridDim.z walks dim 0.  Grid-stride loops
//     over dims 1 and 0 take any extents without a division;
//   * 64-bit offsets.
//
// Plain C interface for ctypes: the launch goes on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (cudecomp_cuda_error_string, in probe.cu, names the code).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridYZ = 65535;

// The call's extents and strides, in elements (complex for a complex
// state, real for a plane pair, the wavenumbers and the mask); the
// wrapper packs them as
// kGeometryWords int64 words in this order.
struct Geometry {
  int64_t n[3];     // extents of the spatial dims; dim 2 is walked by x
  int64_t v[4];     // input strides: dims 0-2, then the component dim
  int64_t o[4];     // output strides: dims 0-2, then the component dim
  int64_t k[3][3];  // strides of kx, ky, kz over dims 0-2 (0 where broadcast)
  int64_t m[3];     // strides of the mask over dims 0-2
};
constexpr int kGeometryWords = 23;
static_assert(sizeof(Geometry) == kGeometryWords * sizeof(int64_t),
              "Geometry is packed as int64 words");

template <typename R>
struct Arith;

template <>
struct Arith<float> {
  using C = float2;
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float inv(float a) {
    return __fdiv_rn(1.0f, a);
  }
};

template <>
struct Arith<double> {
  using C = double2;
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double inv(double a) {
    return __ddiv_rn(1.0, a);
  }
};

// real k times complex a
template <typename R>
__device__ __forceinline__ typename Arith<R>::C kmul(R k,
                                                     typename Arith<R>::C a) {
  using A = Arith<R>;
  return {A::mul(k, a.x), A::mul(k, a.y)};
}

template <typename R>
__device__ __forceinline__ typename Arith<R>::C csub(typename Arith<R>::C a,
                                                     typename Arith<R>::C b) {
  using A = Arith<R>;
  return {A::sub(a.x, b.x), A::sub(a.y, b.y)};
}

template <typename R>
__device__ __forceinline__ typename Arith<R>::C cadd(typename Arith<R>::C a,
                                                     typename Arith<R>::C b) {
  using A = Arith<R>;
  return {A::add(a.x, b.x), A::add(a.y, b.y)};
}

// i times a
template <typename R>
__device__ __forceinline__ typename Arith<R>::C muli(typename Arith<R>::C a) {
  return {-a.y, a.x};
}

// One complex value at offset `at`: of the complex array at `re`, or
// of the plane pair (re, im).
template <typename R, bool kPlanes>
__device__ __forceinline__ typename Arith<R>::C load(
    const R* __restrict__ re, const R* __restrict__ im, int64_t at) {
  if constexpr (kPlanes) {
    return {re[at], im[at]};
  } else {
    return reinterpret_cast<const typename Arith<R>::C*>(re)[at];
  }
}

template <typename R, bool kPlanes>
__device__ __forceinline__ void store(R* __restrict__ re,
                                      R* __restrict__ im, int64_t at,
                                      typename Arith<R>::C w) {
  if constexpr (kPlanes) {
    re[at] = w.x;
    im[at] = w.y;
  } else {
    reinterpret_cast<typename Arith<R>::C*>(re)[at] = w;
  }
}

// `v` and `out` are the complex arrays (as R*), or with kPlanes the real
// planes, `vi` and `outi` the imaginary ones (unused otherwise).
template <typename R, bool kProject, bool kMask, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
spectral3_kernel(const R* __restrict__ v, const R* __restrict__ vi,
                 R* __restrict__ out, R* __restrict__ outi,
                 const R* __restrict__ kxs, const R* __restrict__ kys,
                 const R* __restrict__ kzs, const R* __restrict__ mask,
                 const Geometry g) {
  using A = Arith<R>;
  using C = typename A::C;
  const int64_t i2 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (i2 >= g.n[2]) return;
  const int64_t step1 = static_cast<int64_t>(gridDim.y) * blockDim.y;
  for (int64_t i0 = blockIdx.z; i0 < g.n[0]; i0 += gridDim.z) {
    for (int64_t i1 = static_cast<int64_t>(blockIdx.y) * blockDim.y +
                      threadIdx.y;
         i1 < g.n[1]; i1 += step1) {
      const int64_t vo = i0 * g.v[0] + i1 * g.v[1] + i2 * g.v[2];
      C a0 = load<R, kPlanes>(v, vi, vo);
      C a1 = load<R, kPlanes>(v, vi, vo + g.v[3]);
      C a2 = load<R, kPlanes>(v, vi, vo + 2 * g.v[3]);
      const R kx = kxs[i0 * g.k[0][0] + i1 * g.k[0][1] + i2 * g.k[0][2]];
      const R ky = kys[i0 * g.k[1][0] + i1 * g.k[1][1] + i2 * g.k[1][2]];
      const R kz = kzs[i0 * g.k[2][0] + i1 * g.k[2][1] + i2 * g.k[2][2]];
      C w0, w1, w2;
      if constexpr (kProject) {
        if constexpr (kMask) {
          const R m = mask[i0 * g.m[0] + i1 * g.m[1] + i2 * g.m[2]];
          a0 = kmul<R>(m, a0);
          a1 = kmul<R>(m, a1);
          a2 = kmul<R>(m, a2);
        }
        const R k2 = A::add(A::add(A::mul(kx, kx), A::mul(ky, ky)),
                            A::mul(kz, kz));
        const R inv_k2 = k2 > R(0) ? A::inv(k2) : R(0);
        const C div = cadd<R>(cadd<R>(kmul<R>(kx, a0), kmul<R>(ky, a1)),
                              kmul<R>(kz, a2));
        const C s = kmul<R>(inv_k2, div);
        w0 = csub<R>(a0, kmul<R>(kx, s));
        w1 = csub<R>(a1, kmul<R>(ky, s));
        w2 = csub<R>(a2, kmul<R>(kz, s));
      } else {
        w0 = muli<R>(csub<R>(kmul<R>(ky, a2), kmul<R>(kz, a1)));
        w1 = muli<R>(csub<R>(kmul<R>(kz, a0), kmul<R>(kx, a2)));
        w2 = muli<R>(csub<R>(kmul<R>(kx, a1), kmul<R>(ky, a0)));
      }
      const int64_t oo = i0 * g.o[0] + i1 * g.o[1] + i2 * g.o[2];
      store<R, kPlanes>(out, outi, oo, w0);
      store<R, kPlanes>(out, outi, oo + g.o[3], w1);
      store<R, kPlanes>(out, outi, oo + 2 * g.o[3], w2);
    }
  }
}

// The pointers of one call: the state (`vi`, `outi` null for a complex
// one), the wavenumbers and the mask (null for m = 1).
struct Operands {
  const void* v;
  const void* vi;
  void* out;
  void* outi;
  const void* k[3];
  const void* mask;
};

template <typename R, bool kProject, bool kMask, bool kPlanes>
cudaError_t launch(const Operands& p, const Geometry& g,
                   cudaStream_t stream) {
  int bx = 32;
  while (bx < g.n[2] && bx < kThreads) bx *= 2;
  const int by = kThreads / bx;
  const int64_t gx = (g.n[2] + bx - 1) / bx;
  int64_t gy = (g.n[1] + by - 1) / by;
  if (gy > kMaxGridYZ) gy = kMaxGridYZ;
  const int64_t gz = g.n[0] < kMaxGridYZ ? g.n[0] : kMaxGridYZ;
  if (gx > 2147483647LL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  spectral3_kernel<R, kProject, kMask, kPlanes>
      <<<grid, dim3(bx, by), 0, stream>>>(
          static_cast<const R*>(p.v), static_cast<const R*>(p.vi),
          static_cast<R*>(p.out), static_cast<R*>(p.outi),
          static_cast<const R*>(p.k[0]), static_cast<const R*>(p.k[1]),
          static_cast<const R*>(p.k[2]), static_cast<const R*>(p.mask), g);
  return cudaGetLastError();
}

template <typename R, bool kProject, bool kPlanes>
cudaError_t launch_masked(const Operands& p, const Geometry& g,
                          cudaStream_t stream) {
  if constexpr (kProject) {
    if (p.mask != nullptr)
      return launch<R, true, true, kPlanes>(p, g, stream);
  }
  return launch<R, kProject, false, kPlanes>(p, g, stream);
}

template <bool kProject>
int dispatch(const Operands& p, const int64_t* geometry, int dtype,
             void* stream) {
  if (geometry == nullptr) return cudaErrorInvalidValue;
  const bool planes = dtype == 2 || dtype == 3;
  if (planes && (p.vi == nullptr || p.outi == nullptr))
    return cudaErrorInvalidValue;
  Geometry g;
  std::memcpy(&g, geometry, sizeof(g));
  if (g.n[0] <= 0 || g.n[1] <= 0 || g.n[2] <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:  // complex64
      return launch_masked<float, kProject, false>(p, g, s);
    case 1:  // complex128
      return launch_masked<double, kProject, false>(p, g, s);
    case 2:  // float32 planes
      return launch_masked<float, kProject, true>(p, g, s);
    case 3:  // float64 planes
      return launch_masked<double, kProject, true>(p, g, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// w = i k x v.  `v`, `out`: the complex state and its result, or the
// real planes of a pair whose imaginary planes are `vi`, `outi` (null for
// a complex state).  `geometry`: kGeometryWords int64 words (see
// Geometry).  `dtype`: 0 complex64, 1 complex128, 2 float32 planes,
// 3 float64 planes; the wavenumbers are of the state's real type.
extern "C" int cudecomp_spectral_curl(const void* v, const void* vi,
                                      void* out, void* outi, const void* kx,
                                      const void* ky, const void* kz,
                                      const int64_t* geometry, int dtype,
                                      void* stream) {
  const Operands p{v, vi, out, outi, {kx, ky, kz}, nullptr};
  return dispatch<false>(p, geometry, dtype, stream);
}

// w = m v - k (k . m v) / |k|^2, the state as for cudecomp_spectral_curl;
// `mask` (the real field m, of the wavenumbers' type) may be null, and
// then m = 1.
extern "C" int cudecomp_spectral_project(const void* v, const void* vi,
                                         void* out, void* outi,
                                         const void* kx, const void* ky,
                                         const void* kz, const void* mask,
                                         const int64_t* geometry, int dtype,
                                         void* stream) {
  const Operands p{v, vi, out, outi, {kx, ky, kz}, mask};
  return dispatch<true>(p, geometry, dtype, stream);
}
