// C3: the vector passes of a conjugate-gradient iteration, fused, for
// Hopper (sm_90a).  Three entries, each one pass over the grid:
//
//   cudecomp_cg_dot:        sum(a * b)                       (p . Ap)
//   cudecomp_cg_update:     alpha = rs / pAp (guarded),
//                           u' = u + alpha p, r' = r - alpha Ap,
//                           sum(r' * r')
//   cudecomp_cg_direction:  beta = rs' / rs (guarded), p' = r' + beta p
//
// Replaces no TPU kernel.  The JAX package writes the iteration as array
// expressions (cudecomp_tpu/models/poisson.py: solve_cg), which XLA fuses.
// Run eagerly in PyTorch, the same formulas are a product, a sum, two
// products and two adds, a product and a sum, a product and an add, and
// about ten scalar kernels for the guarded divisions: 22 vectors read or
// written an iteration outside the matvec, where these three passes move
// 11 (2 + 6 + 3).
//
// A guarded division is num / den where den > 0, else 0 (a state that
// converged between two host checks stays where it is); the scalars are
// 0-d tensors of the state's type on the device, read by every thread, so
// the host never waits.  The elementwise results are the plain version's
// operations in its order, each rounded on its own (__fmul_rn and its
// kin: nothing is contracted into an fma), so u', r' and p' are its bits
// for the same scalars.  The stored types are float, double, bfloat16 and
// half; the last two compute in float and round each result to the
// stored type, as PyTorch's operators on them do.  The sums take each
// product in float64 and add in float64 (a float32 product is exact
// there), and round once to the stored type at the end.
//
// Bound: device-memory bandwidth.  At 1024^3 float32 (4 GiB a vector) the
// passes move 2, 6 and 3 vectors: 2.56, 7.69 and 3.85 ms at 3.35 TB/s.
// Design:
//   * 16-byte loads and stores (4 floats, 2 doubles, 8 bfloat16 or half
//     values a lane group) where every vector is 16-byte aligned, one
//     element a step otherwise; a grid-stride loop over blocks of 256
//     threads, as many blocks as the card holds at once (the SM count
//     times the kernel's occupancy, no second wave), so that a reducing
//     pass writes one partial a block;
//   * sums without float atomics: each block reduces its threads' sums
//     (warp shuffles, then one warp over the warps' sums) into its slot of
//     a float64 partials buffer, and a second launch of one block
//     (finish_kernel) adds the partials in a fixed order.  The same input
//     gives the same bits on every run.  So dot and update launch two
//     kernels a call, direction one;
//   * 64-bit indices.
//
// Plain C interface for ctypes: the launches go on the caller's stream,
// do not synchronise, allocate nothing, and the entry returns
// cudaGetLastError() (cudecomp_cuda_error_string, in probe.cu, names the
// code).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks of kThreads an SM holds at most (2048 threads): the wrapper's
// partials buffer has sms * kMaxBlocksPerSm values
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
// elements a 16-byte access carries
template <typename S>
constexpr int kVecLanes = static_cast<int>(16 / sizeof(S));

// The type a stored type S computes in: double for double, else float.
template <typename S> struct CalcOf { using type = float; };
template <> struct CalcOf<double> { using type = double; };
template <typename S> using Calc = typename CalcOf<S>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// v rounded to S (to nearest, ties to even)
template <typename S> __device__ __forceinline__ S narrow(Calc<S> v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ double narrow<double>(double v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

// a float64 sum rounded once to S
template <typename S> __device__ __forceinline__ S narrow64(double v);
template <> __device__ __forceinline__ float narrow64<float>(double v) {
  return __double2float_rn(v);
}
template <> __device__ __forceinline__ double narrow64<double>(double v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow64<__nv_bfloat16>(double v) {
  return __double2bfloat16(v);
}
template <> __device__ __forceinline__ __half narrow64<__half>(double v) {
  return __double2half(v);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// The operations on values stored as S, in Calc<S>, each result rounded to
// S (a no-op for float and double).
template <typename S>
struct Arith {
  using T = Calc<S>;
  static __device__ __forceinline__ T rnd(T v) {
    return widen(narrow<S>(v));
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return rnd(mul_rn(a, b));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return rnd(add_rn(a, b));
  }
  static __device__ __forceinline__ T sub(T a, T b) {
    return rnd(sub_rn(a, b));
  }
  static __device__ __forceinline__ T div(T a, T b) {
    return rnd(div_rn(a, b));
  }
};

// num / den where den > 0, else 0 (a NaN den gives 0 too)
template <typename S>
__device__ __forceinline__ Calc<S> guarded_div(Calc<S> num, Calc<S> den) {
  return den > Calc<S>(0) ? Arith<S>::div(num, den) : Calc<S>(0);
}

// the float64 product added to the running sum, each rounded alone
__device__ __forceinline__ double accumulate(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));
}

// kLanes elements, loaded and stored as one access of kLanes * sizeof(S)
// bytes (16 for the vector path)
template <typename S, int kLanes>
struct alignas(sizeof(S) * kLanes) Pack {
  S v[kLanes];
};

template <typename S, int kLanes>
__device__ __forceinline__ Pack<S, kLanes> load(const S* __restrict__ x,
                                                int64_t i) {
  return reinterpret_cast<const Pack<S, kLanes>*>(x)[i];
}

template <typename S, int kLanes>
__device__ __forceinline__ void store(S* __restrict__ x, int64_t i,
                                      const Pack<S, kLanes>& v) {
  reinterpret_cast<Pack<S, kLanes>*>(x)[i] = v;
}

// The block's sum of every thread's `acc` into partials[blockIdx.x]: warp
// shuffles, then the first warp over the warps' sums, in a fixed order.
__device__ __forceinline__ void block_partial(double acc,
                                              double* __restrict__ partials) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, s));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, s));
    if (lane == 0) partials[blockIdx.x] = acc;
  }
}

// The sum of `count` partials into *out, rounded once to S: one block.
template <typename S>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const double* __restrict__ partials, int count,
              S* __restrict__ out) {
  __shared__ double total[1];
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads)
    acc = __dadd_rn(acc, partials[i]);
  block_partial(acc, total);
  if (threadIdx.x == 0) *out = narrow64<S>(total[0]);
}

// Each thread walks the grid's packs of kLanes elements with stride
// gridDim.x * kThreads, calling pack(i) for pack i, then the n % kLanes
// elements past the last pack, thread t of the grid calling one(j) for
// tail element t.
template <int kLanes, typename PackFn, typename OneFn>
__device__ __forceinline__ void walk(int64_t n, PackFn pack, OneFn one) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t packs = n / kLanes;
  for (int64_t i = first; i < packs; i += stride) pack(i);
  if (first < n - packs * kLanes) one(packs * kLanes + first);
}

template <typename S, int kLanes>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const S* __restrict__ a, const S* __restrict__ b, int64_t n,
           double* __restrict__ partials) {
  using P = Pack<S, kLanes>;
  double acc = 0.0;
  walk<kLanes>(
      n,
      [&](int64_t i) {
        const P x = load<S, kLanes>(a, i);
        const P y = load<S, kLanes>(b, i);
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          acc = accumulate(acc, widen(x.v[l]), widen(y.v[l]));
      },
      [&](int64_t j) { acc = accumulate(acc, widen(a[j]), widen(b[j])); });
  block_partial(acc, partials);
}

// u' = u + alpha p, r' = r - alpha ap, and r' r' into the sum
template <typename S>
__device__ __forceinline__ void update_one(Calc<S> alpha, S u, S p, S r,
                                           S ap, S& u_out, S& r_out,
                                           double& acc) {
  using A = Arith<S>;
  const Calc<S> un = A::add(widen(u), A::mul(alpha, widen(p)));
  const Calc<S> rn = A::sub(widen(r), A::mul(alpha, widen(ap)));
  u_out = narrow<S>(un);
  r_out = narrow<S>(rn);
  acc = accumulate(acc, rn, rn);
}

template <typename S, int kLanes>
__global__ void __launch_bounds__(kThreads)
update_kernel(const S* __restrict__ u, const S* __restrict__ p,
              const S* __restrict__ r, const S* __restrict__ ap,
              const S* __restrict__ rs, const S* __restrict__ pap,
              S* __restrict__ u_out, S* __restrict__ r_out,
              S* __restrict__ alpha_out, int64_t n,
              double* __restrict__ partials) {
  using P = Pack<S, kLanes>;
  const Calc<S> alpha = guarded_div<S>(widen(*rs), widen(*pap));
  if (blockIdx.x == 0 && threadIdx.x == 0) *alpha_out = narrow<S>(alpha);
  double acc = 0.0;
  walk<kLanes>(
      n,
      [&](int64_t i) {
        const P uu = load<S, kLanes>(u, i);
        const P pp = load<S, kLanes>(p, i);
        const P rr = load<S, kLanes>(r, i);
        const P aa = load<S, kLanes>(ap, i);
        P un, rn;
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          update_one<S>(alpha, uu.v[l], pp.v[l], rr.v[l], aa.v[l], un.v[l],
                        rn.v[l], acc);
        store<S, kLanes>(u_out, i, un);
        store<S, kLanes>(r_out, i, rn);
      },
      [&](int64_t j) {
        update_one<S>(alpha, u[j], p[j], r[j], ap[j], u_out[j], r_out[j],
                      acc);
      });
  block_partial(acc, partials);
}

template <typename S, int kLanes>
__global__ void __launch_bounds__(kThreads)
direction_kernel(const S* __restrict__ r, const S* __restrict__ p,
                 const S* __restrict__ rs_new, const S* __restrict__ rs,
                 S* __restrict__ p_out, int64_t n) {
  using A = Arith<S>;
  using P = Pack<S, kLanes>;
  const Calc<S> beta = guarded_div<S>(widen(*rs_new), widen(*rs));
  walk<kLanes>(
      n,
      [&](int64_t i) {
        const P rr = load<S, kLanes>(r, i);
        const P pp = load<S, kLanes>(p, i);
        P pn;
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          pn.v[l] = narrow<S>(
              A::add(widen(rr.v[l]), A::mul(beta, widen(pp.v[l]))));
        store<S, kLanes>(p_out, i, pn);
      },
      [&](int64_t j) {
        p_out[j] = narrow<S>(A::add(widen(r[j]), A::mul(beta, widen(p[j]))));
      });
}

// Whether every pointer is 16-byte aligned.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

// Blocks of `kernel` the card holds at once, over `sms` SMs, and no more
// than `work` items need (one a thread); at least 1.
template <typename Kernel>
int grid_blocks(Kernel kernel, int64_t work, int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  const int64_t blocks = need < full ? need : full;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <typename S, int kLanes>
void launch_dot(const S* a, const S* b, int64_t n, int sms,
                double* partials, S* out, cudaStream_t s) {
  const int blocks = grid_blocks(dot_kernel<S, kLanes>, n / kLanes, sms);
  dot_kernel<S, kLanes><<<blocks, kThreads, 0, s>>>(a, b, n, partials);
  finish_kernel<S><<<1, kThreads, 0, s>>>(partials, blocks, out);
}

template <typename S>
cudaError_t dot(const void* a, const void* b, void* out, double* partials,
                int64_t n, int sms, cudaStream_t s) {
  const S* x = static_cast<const S*>(a);
  const S* y = static_cast<const S*>(b);
  S* o = static_cast<S*>(out);
  if (aligned16({a, b}))
    launch_dot<S, kVecLanes<S>>(x, y, n, sms, partials, o, s);
  else
    launch_dot<S, 1>(x, y, n, sms, partials, o, s);
  return cudaGetLastError();
}

template <typename S, int kLanes>
void launch_update(const S* const* in, S* const* out, int64_t n, int sms,
                   double* partials, cudaStream_t s) {
  const int blocks = grid_blocks(update_kernel<S, kLanes>, n / kLanes, sms);
  update_kernel<S, kLanes><<<blocks, kThreads, 0, s>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], n,
      partials);
  finish_kernel<S><<<1, kThreads, 0, s>>>(partials, blocks, out[3]);
}

template <typename S>
cudaError_t update(const void* const* in, void* const* out, double* partials,
                   int64_t n, int sms, cudaStream_t s) {
  const S* x[6];
  S* y[4];
  for (int i = 0; i < 6; ++i) x[i] = static_cast<const S*>(in[i]);
  for (int i = 0; i < 4; ++i) y[i] = static_cast<S*>(out[i]);
  // u, p, r, ap, u_out, r_out
  if (aligned16({in[0], in[1], in[2], in[3], out[0], out[1]}))
    launch_update<S, kVecLanes<S>>(x, y, n, sms, partials, s);
  else
    launch_update<S, 1>(x, y, n, sms, partials, s);
  return cudaGetLastError();
}

template <typename S, int kLanes>
void launch_direction(const S* r, const S* p, const S* rs_new, const S* rs,
                      S* p_out, int64_t n, int sms, cudaStream_t s) {
  const int blocks =
      grid_blocks(direction_kernel<S, kLanes>, n / kLanes, sms);
  direction_kernel<S, kLanes><<<blocks, kThreads, 0, s>>>(r, p, rs_new, rs,
                                                          p_out, n);
}

template <typename S>
cudaError_t direction(const void* r, const void* p, const void* rs_new,
                      const void* rs, void* p_out, int64_t n, int sms,
                      cudaStream_t s) {
  const S* rr = static_cast<const S*>(r);
  const S* pp = static_cast<const S*>(p);
  const S* a = static_cast<const S*>(rs_new);
  const S* b = static_cast<const S*>(rs);
  S* o = static_cast<S*>(p_out);
  if (aligned16({r, p, p_out}))
    launch_direction<S, kVecLanes<S>>(rr, pp, a, b, o, n, sms, s);
  else
    launch_direction<S, 1>(rr, pp, a, b, o, n, sms, s);
  return cudaGetLastError();
}

bool bad_shape(int64_t n, int sms) { return n < 0 || sms < 1; }

}  // namespace

// *out = sum(a * b) over n elements of float32 (dtype 0), float64 (1),
// bfloat16 (2) or float16 (3) vectors on a card of `sms` SMs; `partials`
// a float64 scratch of sms * kMaxBlocksPerSm (8) values.
extern "C" int cudecomp_cg_dot(const void* a, const void* b, void* out,
                               void* partials, int64_t n, int sms,
                               int dtype, void* stream) {
  if (bad_shape(n, sms)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  switch (dtype) {
    case 0:
      return dot<float>(a, b, out, part, n, sms, s);
    case 1:
      return dot<double>(a, b, out, part, n, sms, s);
    case 2:
      return dot<__nv_bfloat16>(a, b, out, part, n, sms, s);
    case 3:
      return dot<__half>(a, b, out, part, n, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// alpha = rs / pap (0 unless pap > 0), u_out = u + alpha p, r_out = r -
// alpha ap, *alpha_out = alpha, *rr_out = sum(r_out * r_out); rs, pap,
// alpha_out and rr_out are single values of the vectors' type; n, sms,
// partials, dtype as for cudecomp_cg_dot.
extern "C" int cudecomp_cg_update(const void* u, const void* p,
                                  const void* r, const void* ap,
                                  const void* rs, const void* pap,
                                  void* u_out, void* r_out, void* alpha_out,
                                  void* rr_out, void* partials, int64_t n,
                                  int sms, int dtype, void* stream) {
  if (bad_shape(n, sms)) return cudaErrorInvalidValue;
  const void* in[] = {u, p, r, ap, rs, pap};
  void* out[] = {u_out, r_out, alpha_out, rr_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  switch (dtype) {
    case 0:
      return update<float>(in, out, part, n, sms, s);
    case 1:
      return update<double>(in, out, part, n, sms, s);
    case 2:
      return update<__nv_bfloat16>(in, out, part, n, sms, s);
    case 3:
      return update<__half>(in, out, part, n, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// beta = rs_new / rs (0 unless rs > 0), p_out = r + beta p; n, sms,
// dtype as for cudecomp_cg_dot.
extern "C" int cudecomp_cg_direction(const void* r, const void* p,
                                     const void* rs_new, const void* rs,
                                     void* p_out, int64_t n, int sms,
                                     int dtype, void* stream) {
  if (bad_shape(n, sms)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return direction<float>(r, p, rs_new, rs, p_out, n, sms, s);
    case 1:
      return direction<double>(r, p, rs_new, rs, p_out, n, sms, s);
    case 2:
      return direction<__nv_bfloat16>(r, p, rs_new, rs, p_out, n, sms, s);
    case 3:
      return direction<__half>(r, p, rs_new, rs, p_out, n, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}
