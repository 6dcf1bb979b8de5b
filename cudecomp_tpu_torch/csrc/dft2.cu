// K5: the 2-axis DFT of each x-plane of a complex64 (X, N1, N2) tensor, as
// one pass of FFTs per plane held in a thread-block cluster, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cudecomp_tpu/ops/mxu_fft.py: dft2_fused (:392,
// pallas_call :457), gated by _dft2_gate (:371).  It contracts the Y then
// the Z axis of (bx, N1, N2) blocks in VMEM with dense DFT matrices, because
// the MXU does matrix products and nothing else; its point is to do both
// axes in one HBM pass.  The function is
//
//     out[b] = fft2(x[b]) over dims (1, 2); the inverse is ifft2, with the
//     1/(N1*N2) scale
//
// on the gate's shapes: N1 <= 256 with N1 % 8 == 0, and N2 in {128, 256}.
//
// What bounds it on this card: bytes.  As FFTs the pair costs
// 5 * N1 * N2 * log2(N1 * N2) flops per plane, 2.5 flops per byte of its
// one read and one write at 256 x 256, far under the ~20 float32 flops per
// byte at which the card's FMA rate meets its HBM bandwidth.  (The TPU
// kernel's dense DFT costs 8 * N1 * N2 * (N1 + N2) flops per plane and is
// bound by them, at 13x the bytes' time.)  So the kernel keeps the TPU
// kernel's one HBM read and one HBM write of each plane, and replaces the
// matrix products by FFTs.
//
// The plane is larger than one block's shared memory: 256 x 256 x 8 bytes
// is 512 KiB against 227 KB.  One cluster of C blocks holds it, and a block
// reads its peers' shares through distributed shared memory.  C is the
// smallest of 1, 2, 4, 8 whose per-block share fits half an SM (113 KiB),
// so that two blocks share each SM; ops/dft2.py (dft2_plan) picks C and the
// chunk width W, and this entry checks them.
//   1. Z pass (rows).  Block r owns rows [r N1/C, (r+1) N1/C).  N2 = 16 B.
//      A thread takes one (row, n_b): it loads x[row, B n_a + n_b] for the
//      16 n_a straight from HBM into registers (16 independent 8-byte loads
//      in flight per thread; the plane's one read), runs a 16-point FFT
//      over n_a, multiplies by W_N2^(n_b k_a) and stores to the row in
//      shared memory at k_a + 16 n_b.  Then a thread takes one (row, k_a)
//      and runs the B-point FFT over n_b in place: it reads and writes the
//      same B slots.  A row keeps one pad slot per 16 values (index
//      k + k / 16), so both stores and loads are free of bank conflicts.
//   2. cluster.sync(): every row of the plane is transformed and visible.
//   3. Y pass (columns).  Block r owns columns [r N2/C, (r+1) N2/C), in
//      chunks of W.  N1 = A M, with A = 16 for N1 = 128 or 256 and A = 8
//      otherwise.  A thread takes one (column, n_b): it gathers rows
//      M n_a + n_b for the A values of n_a from the blocks that own them
//      (ld.shared::cluster, from a table of the rows' cluster addresses
//      made once per block), runs an A-point FFT over n_a, multiplies by
//      W_N1^(n_b k_a) and stores to its block's scratch area.  Then a
//      thread takes one (column, k_a): the M-point transform over n_b, an
//      FFT in registers when M is a power of two and otherwise a dense DFT
//      of length M with weights from the twiddle table (N1 = 24, 40, 200,
//      ...), and writes row k_a + A k_b of the chunk to `out`: W * 8
//      contiguous bytes per row segment across a warp, the plane's one
//      write.  The scale is applied here.
//   4. cluster.sync() before any block exits: a block's shared memory must
//      outlive its peers' reads of it.
// The FFTs are radix-2 decimation in frequency, unrolled in registers; their
// output stays in bit-reversed order and the store index is permuted
// instead.  Every transform is the forward one: the inverse is the
// conjugate of the forward transform of the conjugate, a sign on load and
// on store.  The twiddles W_N^k (k < N, one table per axis) are built on
// the host in float64 and cast once to float32 (ops/dft2.py) and staged in
// shared memory; the in-register FFTs' own twiddles (W_32^j, also from
// float64) sit in constant memory, where an FMA reads them as operands, and
// their 1 and -i cost no multiply.  No __sincosf and no fast math.
//
// What holds it above its bound (measured on an NVIDIA H100 80GB HBM3 at
// 700 W with tools/k5_layouts.py --ablate, PERF.md): not the FFT
// arithmetic, whose removal changes nothing, but the phases that run
// between each block's one read and one write: the rows' pass alone,
// written straight out, already takes 1.4x a clone() of the bytes, and the
// column gather across SMs (7/8 of the plane comes from the peers) is
// about a seventh of the time.
// Two blocks per SM (clusters of 8 at 256 x 256) beat one block per SM with
// wider chunks or fewer, larger blocks (tools/k5_layouts.py).
//
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a), every template instance <N2, A, M>:
// 95 registers, no spills, no stack, whatever C.  Dynamic shared memory per
// block, by C: 11,872 bytes for C = 1 at (N1, N2) = (8, 128); 104,960 for
// C = 2 at (128, 128); 106,496 for C = 4 at (256, 128); 107,520 for C = 8
// at (256, 256), the main path's; two blocks per SM in each case.
//
// Plain C interface for ctypes: the launch goes on the caller's stream, does
// not synchronise, allocates nothing, and returns a cudaError_t
// (cudecomp_cuda_error_string, in probe.cu, names the code).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowRadix = 16;         // N2 = 16 * B
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int64_t kMaxSmem = 232448;  // 227 KB: the most a block may hold
constexpr int kInner = 32;            // the in-register FFTs are <= 32 points

// W_32^j, j < 16 (forward): the in-register FFTs' twiddles, read as
// constant-bank operands.  Set once per device by configure().
__constant__ float2 c_w32[kInner / 2];

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// i with its log2(L) bits reversed
__host__ __device__ constexpr int bitrev(int i, int L) {
  int r = 0;
  for (int b = 1; b < L; b <<= 1, i >>= 1) r = (r << 1) | (i & 1);
  return r;
}

// a row's slot of value k: one pad slot per 16 values
__device__ __forceinline__ int pad(int k) { return k + (k >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `addr` of this block's shared memory, as block `rank` of the cluster
// holds it
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float2 load_cluster(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// The forward L-point DFT of v in registers (L <= 32), left in bit-reversed
// order: v[i] <- sum_n v[n] W_L^(n * bitrev(i, L)).  Radix-2 decimation in
// frequency; every index is a compile-time constant, W_L^j = c_w32[j 32/L]
// is a constant operand, and the twiddles 1 and -i cost no multiply.
template <int L>
__device__ __forceinline__ void fft_regs(float2 (&v)[L]) {
  constexpr int kLog = ilog2(L);
#pragma unroll
  for (int s = 0; s < kLog; ++s) {
    const int half = (L / 2) >> s;
#pragma unroll
    for (int b = 0; b < L / 2; ++b) {
      const int k = b % half;
      const int i = (b / half) * 2 * half + k;
      const float2 a = v[i];
      const float2 c = v[i + half];
      v[i] = make_float2(a.x + c.x, a.y + c.y);
      const float2 d = make_float2(a.x - c.x, a.y - c.y);
      const int j = (k << s) * (kInner / L);  // W_32^j
      if (j == 0) {
        v[i + half] = d;
      } else if (j == kInner / 4) {
        v[i + half] = make_float2(d.y, -d.x);  // times -i
      } else {
        v[i + half] = cmul(d, c_w32[j]);
      }
    }
  }
}

// One cluster per x-plane; see the note at the top.  N1 = CA * m; M = m
// when m is a power of two, 0 for the dense m-point column stage.
template <int N2, int CA, int M>
__global__ void __launch_bounds__(kThreads, 2)
dft2_kernel(const float2* __restrict__ x, float2* __restrict__ out,
            const float2* __restrict__ tw1_g, const float2* __restrict__ tw2_g,
            int n1, int chunk, float sign, float scale) {
  constexpr int B = N2 / kRowRadix;
  constexpr int kPitch = N2 + N2 / 16;  // a row in shared memory, padded
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / C;
  const int m = n1 / CA;
  const int R = n1 / C;  // rows per block
  const int t = threadIdx.x;

  extern __shared__ float2 smem[];
  float2* tw1 = smem;                   // W_N1^k, k < n1
  float2* tw2 = tw1 + n1;               // W_N2^k, k < N2
  float2* rows = tw2 + N2;              // R rows of kPitch
  float2* scratch = rows + R * kPitch;  // n1 x chunk: one column chunk
  // row g of the plane, as its owner block holds it (cluster addresses)
  uint32_t* row_at = reinterpret_cast<uint32_t*>(scratch + n1 * chunk);

  for (int i = t; i < n1; i += kThreads) {
    tw1[i] = tw1_g[i];
    row_at[i] = map_rank(shared_addr(rows + (i % R) * kPitch), i / R);
  }
  for (int i = t; i < N2; i += kThreads) tw2[i] = tw2_g[i];
  __syncthreads();

  // 1. Z pass, stage 1: HBM -> 16-point FFTs over n_a -> shared rows.  The
  //    inverse is the forward transform of the conjugate, conjugated.
  const float2* xb = x + (plane * n1 + static_cast<int64_t>(r) * R) * N2;
  for (int task = t; task < R * B; task += kThreads) {
    const int row = task / B;
    const int nb = task % B;
    const float2* src = xb + static_cast<int64_t>(row) * N2 + nb;
    float2 v[kRowRadix];
#pragma unroll
    for (int na = 0; na < kRowRadix; ++na) {
      v[na] = src[na * B];
      v[na].y *= sign;
    }
    fft_regs<kRowRadix>(v);
    float2* dst = rows + row * kPitch;
#pragma unroll
    for (int i = 0; i < kRowRadix; ++i) {
      const int ka = bitrev(i, kRowRadix);
      dst[pad(ka + kRowRadix * nb)] = cmul(v[i], tw2[nb * ka]);
    }
  }
  __syncthreads();
  // stage 2: B-point FFTs over n_b, in place
  for (int task = t; task < R * kRowRadix; task += kThreads) {
    float2* p = rows + (task / kRowRadix) * kPitch;
    const int ka = task % kRowRadix;
    float2 v[B];
#pragma unroll
    for (int nb = 0; nb < B; ++nb) v[nb] = p[pad(ka + kRowRadix * nb)];
    fft_regs<B>(v);
#pragma unroll
    for (int i = 0; i < B; ++i) p[pad(ka + kRowRadix * bitrev(i, B))] = v[i];
  }

  // 2. every block's rows are done
  cluster.sync();

  // 3. Y pass over this block's columns, chunk by chunk
  const int cols = N2 / C;
  float2* ob = out + plane * n1 * N2;
  const float scale_im = sign * scale;
  for (int c0 = r * cols; c0 < (r + 1) * cols; c0 += chunk) {
    // stage 1: gather from the owners' rows -> CA-point FFTs -> scratch
    for (int task = t; task < chunk * m; task += kThreads) {
      const int c = task % chunk;
      const int nb = task / chunk;
      const uint32_t off = static_cast<uint32_t>(pad(c0 + c)) * 8u;
      float2 v[CA];
#pragma unroll
      for (int na = 0; na < CA; ++na)
        v[na] = load_cluster(row_at[m * na + nb] + off);
      fft_regs<CA>(v);
#pragma unroll
      for (int i = 0; i < CA; ++i) {
        const int ka = bitrev(i, CA);
        scratch[(ka + CA * nb) * chunk + c] = cmul(v[i], tw1[nb * ka]);
      }
    }
    __syncthreads();
    // stage 2: m-point transforms over n_b -> HBM
    for (int task = t; task < chunk * CA; task += kThreads) {
      const int c = task % chunk;
      const int ka = task / chunk;
      const float2* z = scratch + ka * chunk + c;  // n_b at z[n_b CA chunk]
      float2* o = ob + c0 + c;
      if constexpr (M > 0) {
        float2 v[M];
#pragma unroll
        for (int nb = 0; nb < M; ++nb) v[nb] = z[nb * CA * chunk];
        fft_regs<M>(v);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const int k = ka + CA * bitrev(i, M);
          o[static_cast<int64_t>(k) * N2] =
              make_float2(v[i].x * scale, v[i].y * scale_im);
        }
      } else {
        for (int kb = 0; kb < m; ++kb) {
          float2 acc = make_float2(0.f, 0.f);
          int j = 0;  // (n_b * k_b) mod m
          for (int nb = 0; nb < m; ++nb) {
            const float2 p = cmul(z[nb * CA * chunk], tw1[CA * j]);
            acc = make_float2(acc.x + p.x, acc.y + p.y);
            j += kb;
            if (j >= m) j -= m;
          }
          const int k = ka + CA * kb;
          o[static_cast<int64_t>(k) * N2] =
              make_float2(acc.x * scale, acc.y * scale_im);
        }
      }
    }
    __syncthreads();  // the scratch area is free for the next chunk
  }

  // 4. no block leaves while a peer may still read its rows
  cluster.sync();
}

using Kernel = void (*)(const float2*, float2*, const float2*, const float2*,
                        int, int, float, float);

template <int N2>
Kernel kernel_for(int n1) {
  switch (n1) {
    case 8: return dft2_kernel<N2, 8, 1>;
    case 16: return dft2_kernel<N2, 8, 2>;
    case 32: return dft2_kernel<N2, 8, 4>;
    case 64: return dft2_kernel<N2, 8, 8>;
    case 128: return dft2_kernel<N2, 16, 8>;
    case 256: return dft2_kernel<N2, 16, 16>;
    default: return dft2_kernel<N2, 8, 0>;
  }
}

// Shared memory of one block (bytes): the two twiddle tables, its rows, one
// column chunk and the table of row addresses.  ops/dft2.py picks the
// layout with its own smem_bytes; cudecomp_dft2_smem_bytes exports this one
// so that a test holds the two together.
int64_t smem_bytes(int n1, int n2, int cluster, int chunk) {
  const int64_t rows = n1 / cluster;
  return 8 * (rows * (n2 + n2 / 16) + static_cast<int64_t>(n1) * chunk + n1 +
              n2) + 4 * static_cast<int64_t>(n1);
}

// Once per device: the in-register FFTs' twiddles, built in float64 and
// cast once to float32.  Once per (device, kernel, cluster size, shared
// bytes): allow the kernel the most dynamic shared memory, and check that at
// least one cluster of the configuration fits on the card.  No fallback: an
// error is returned.
cudaError_t configure(Kernel kernel, const cudaLaunchConfig_t& cfg, int c) {
  static std::mutex mu;
  static std::set<int> tables;
  static std::set<std::pair<std::pair<int, const void*>,
                            std::pair<int, size_t>>> ready;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(
      std::make_pair(dev, reinterpret_cast<const void*>(kernel)),
      std::make_pair(c, cfg.dynamicSmemBytes));
  std::lock_guard<std::mutex> lock(mu);
  if (!tables.count(dev)) {
    float2 w[kInner / 2];
    for (int j = 0; j < kInner / 2; ++j) {
      const double a = 2.0 * 3.14159265358979323846 * j / kInner;
      w[j] = make_float2(static_cast<float>(std::cos(a)),
                         static_cast<float>(-std::sin(a)));
    }
    err = cudaMemcpyToSymbol(c_w32, w, sizeof(w));
    if (err != cudaSuccess) return err;
    tables.insert(dev);
  }
  if (ready.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reads it
    return err;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  ready.insert(key);
  return cudaSuccess;
}

}  // namespace

// The shared memory (bytes) of one block of a layout, for the test that
// holds ops/dft2.py's smem_bytes to it.
extern "C" int64_t cudecomp_dft2_smem_bytes(int n1, int n2, int cluster,
                                            int chunk) {
  return smem_bytes(n1, n2, cluster, chunk);
}

// out = the 2-axis DFT over dims (1, 2) of the contiguous complex64
// (nx, n1, n2) tensor x: the forward transform, or with `inverse` the
// unnormalised inverse, times `scale` (1 forward and 1/(n1 n2) inverse
// for the FFT pair; the gradients take the other factor); tw1 = W_n1^k (n1 values) and tw2 = W_n2^k (n2
// values) are the forward twiddle tables.  One cluster of `cluster` blocks
// per plane, columns in chunks of `chunk`.
extern "C" int cudecomp_dft2(const void* x, void* out, const void* tw1,
                             const void* tw2, int64_t nx, int n1, int n2,
                             int cluster, int chunk, int inverse, float scale,
                             void* stream) {
  if (nx <= 0) return cudaSuccess;
  if ((n2 != 128 && n2 != 256) || n1 < 8 || n1 > 256 || n1 % 8)
    return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      chunk < 1 || (n2 / cluster) % chunk)
    return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(n1, n2, cluster, chunk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (nx * cluster > 2147483647LL) return cudaErrorInvalidConfiguration;
  const Kernel kernel = n2 == 128 ? kernel_for<128>(n1) : kernel_for<256>(n1);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nx * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = configure(kernel, cfg, cluster);
  if (err != cudaSuccess) return err;
  const float sign = inverse ? -1.f : 1.f;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float2*>(x),
                           static_cast<float2*>(out),
                           static_cast<const float2*>(tw1),
                           static_cast<const float2*>(tw2), n1, chunk, sign,
                           scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
