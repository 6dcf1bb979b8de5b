// The synchronisation of K2 and K3 (csrc/peer.cu) in the shapes that were
// weighed against each other, for tools/peer_sync.py.  The port never
// calls this file.
//
// Every variant runs the same puts and unpacks (the plans of
// ops/peer_kernels.py, one move kernel per side) and differs only in how
// a rank learns that its peers are ready:
//
//   0  the first design: signal_wait(2e+1), puts, signal_wait(2e+2),
//      unpacks; signal_wait is a one-block kernel that writes the epoch
//      into the peers' pads and spins on its own (ld.acquire.sys and
//      __nanosleep, a %globaltimer bound ending in __trap()).  Four
//      kernel launches.
//   1  stream-ordered, with the entry barrier: a batch of stream writes of
//      2e+1 into the peers' pads and a batch of stream waits (>= 2e+1) on
//      the rank's own slots, puts, the same pair at 2e+2, unpacks.  Two
//      kernels, four stream memory operations.
//   2  stream-ordered, double buffered: the receive region has two halves
//      and exchange e uses half e % 2; puts, stream writes of 2e+2, stream
//      waits, unpacks.  Two kernels, two stream memory operations.  Safe
//      when every exchange signals and waits for the same peers (the
//      caller passes every other rank of the group).
//   3  as 2, but the signal is a one-block kernel of release stores (no
//      wait in it) instead of the batch of stream writes.  Three kernels,
//      one stream memory operation.
//
// Beside them, one signal-then-wait round among the peers (ps_round):
// kind 0 the spinning kernel, 1 a batch of stream writes then a batch of
// stream waits, 2 the signal kernel then a batch of stream waits.
//
// The CUDA driver's stream memory operations are reached through
// cudaGetDriverEntryPoint, so the library links no libcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kMaxPeers = 64;
constexpr int64_t kPadBytes = 4096;
constexpr uint64_t kTimeoutNs = 20ull * 1000 * 1000 * 1000;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 2048;
constexpr int kMoveFields = 8;

struct PeerSet {
  int n;
  int ranks[kMaxPeers];
};

__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_acquire_sys(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The first design's barrier kernel, as it was.
__global__ void __launch_bounds__(kMaxPeers)
signal_wait_kernel(const uint64_t* __restrict__ bases, int me, PeerSet set,
                   uint64_t epoch) {
  const int t = threadIdx.x;
  if (t >= set.n) return;
  const int p = set.ranks[t];
  store_release_sys(reinterpret_cast<uint64_t*>(bases[p]) + me, epoch);
  const uint64_t* slot = reinterpret_cast<const uint64_t*>(bases[me]) + p;
  const uint64_t t0 = global_timer_ns();
  while (load_acquire_sys(slot) < epoch) {
    if (global_timer_ns() - t0 > kTimeoutNs) {
      printf("peer_sync variant 0: rank %d waited for rank %d (epoch "
             "%llu)\n", me, p, static_cast<unsigned long long>(epoch));
      __trap();
    }
    __nanosleep(128);
  }
}

// Variant 3's signal: release stores, no wait.
__global__ void __launch_bounds__(kMaxPeers)
signal_kernel(const uint64_t* __restrict__ bases, int me, PeerSet set,
              uint64_t epoch) {
  const int t = threadIdx.x;
  if (t >= set.n) return;
  __threadfence_system();
  store_release_sys(reinterpret_cast<uint64_t*>(bases[set.ranks[t]]) + me,
                    epoch);
}

__device__ __forceinline__ char* region(const uint64_t* bases, char* local,
                                        int64_t rank, int64_t off,
                                        int64_t recv_off) {
  return (rank < 0 ? local
                   : reinterpret_cast<char*>(bases[rank]) + kPadBytes +
                         recv_off) + off;
}

template <typename W>
__device__ __forceinline__ void copy_run(const W* __restrict__ s,
                                         W* __restrict__ d, int64_t words,
                                         int64_t i, int64_t step) {
  for (; i + (kUnroll - 1) * step < words; i += kUnroll * step) {
    W v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = s[i + k * step];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) d[i + k * step] = v[k];
  }
  for (; i < words; i += step) d[i] = s[i];
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
move_kernel(const int64_t* __restrict__ moves,
            const uint64_t* __restrict__ bases, char* src_local,
            char* dst_local, int64_t recv_off) {
  const int64_t* m = moves + kMoveFields * blockIdx.y;
  const char* src = region(bases, src_local, m[0], m[1], recv_off);
  char* dst = region(bases, dst_local, m[3], m[4], recv_off);
  const int64_t rows = m[6];
  const int64_t row_words = m[7] / static_cast<int64_t>(sizeof(W));
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (rows == 1) {
    copy_run(reinterpret_cast<const W*>(src), reinterpret_cast<W*>(dst),
             row_words, i, step);
  } else {
    const int64_t src_stride = m[2];
    const int64_t dst_stride = m[5];
    for (const int64_t n = rows * row_words; i < n; i += step) {
      const int64_t r = i / row_words;
      const int64_t c = (i - r * row_words) * static_cast<int64_t>(sizeof(W));
      *reinterpret_cast<W*>(dst + r * dst_stride + c) =
          *reinterpret_cast<const W*>(src + r * src_stride + c);
    }
  }
  __threadfence_system();
}

unsigned copy_blocks(int64_t words) {
  int64_t blocks = (words + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

// -- the CUDA driver's stream memory operations -------------------------------

using DeviceGetFn = CUresult (*)(CUdevice*, int);
using AttributeFn = CUresult (*)(int*, CUdevice_attribute, CUdevice);
using BatchFn = CUresult (*)(CUstream, unsigned int,
                             CUstreamBatchMemOpParams*, unsigned int);

struct Driver {
  int status = -1;  // -1 not looked up, 0 ready, else the failing step
  BatchFn batch = nullptr;
  int mem_ops_64 = 0, wait_nor = 0, flush_remote = 0;
};

void* entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return fn;
}

Driver& driver() {
  static Driver d;
  if (d.status >= 0) return d;
  auto device_get = reinterpret_cast<DeviceGetFn>(entry("cuDeviceGet"));
  auto attribute =
      reinterpret_cast<AttributeFn>(entry("cuDeviceGetAttribute"));
  d.batch = reinterpret_cast<BatchFn>(entry("cuStreamBatchMemOp"));
  int ordinal = 0;
  CUdevice dev;
  if (!device_get || !attribute || !d.batch) {
    d.status = 1;
  } else if (cudaGetDevice(&ordinal) != cudaSuccess ||
             device_get(&dev, ordinal) != CUDA_SUCCESS ||
             attribute(&d.mem_ops_64,
                       CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
                       dev) != CUDA_SUCCESS ||
             attribute(&d.wait_nor,
                       CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR,
                       dev) != CUDA_SUCCESS ||
             attribute(&d.flush_remote,
                       CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES,
                       dev) != CUDA_SUCCESS) {
    d.status = 2;
  } else {
    d.status = d.mem_ops_64 ? 0 : 3;
  }
  return d;
}

// A batch of 64-bit writes of `value` into slot `me` of every peer's pad.
int write_signals(const uint64_t* bases_host, int me, const PeerSet& set,
                  uint64_t value, cudaStream_t s, int* memops) {
  Driver& d = driver();
  if (d.status) return 1000 + d.status;
  CUstreamBatchMemOpParams ops[kMaxPeers] = {};
  for (int i = 0; i < set.n; ++i) {
    ops[i].writeValue.operation = CU_STREAM_MEM_OP_WRITE_VALUE_64;
    ops[i].writeValue.address = static_cast<CUdeviceptr>(
        bases_host[set.ranks[i]] + 8ull * static_cast<uint64_t>(me));
    ops[i].writeValue.value64 = value;
    ops[i].writeValue.flags = CU_STREAM_WRITE_VALUE_DEFAULT;
  }
  const CUresult r = d.batch(reinterpret_cast<CUstream>(s),
                             static_cast<unsigned>(set.n), ops, 0);
  if (r != CUDA_SUCCESS) return 2000 + static_cast<int>(r);
  ++*memops;
  return 0;
}

// A batch of waits until slot p of this rank's pad is >= `value` for every
// peer p.
int wait_signals(const uint64_t* bases_host, int me, const PeerSet& set,
                 uint64_t value, cudaStream_t s, int* memops) {
  Driver& d = driver();
  if (d.status) return 1000 + d.status;
  const unsigned flags =
      CU_STREAM_WAIT_VALUE_GEQ |
      (d.flush_remote ? CU_STREAM_WAIT_VALUE_FLUSH : 0u);
  CUstreamBatchMemOpParams ops[kMaxPeers] = {};
  for (int i = 0; i < set.n; ++i) {
    ops[i].waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_64;
    ops[i].waitValue.address = static_cast<CUdeviceptr>(
        bases_host[me] + 8ull * static_cast<uint64_t>(set.ranks[i]));
    ops[i].waitValue.value64 = value;
    ops[i].waitValue.flags = flags;
  }
  const CUresult r = d.batch(reinterpret_cast<CUstream>(s),
                             static_cast<unsigned>(set.n), ops, 0);
  if (r != CUDA_SUCCESS) return 2000 + static_cast<int>(r);
  ++*memops;
  return 0;
}

int launched_if_ok(int* kernels) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*kernels;
  return static_cast<int>(err);
}

int make_set(const int* peers, int npeers, PeerSet* set) {
  if (npeers < 1 || npeers > kMaxPeers) return cudaErrorInvalidValue;
  set->n = npeers;
  for (int i = 0; i < npeers; ++i) set->ranks[i] = peers[i];
  return 0;
}

template <typename W>
int move(const void* moves, int nmoves, const void* bases,
         const void* src_local, void* dst_local, int64_t max_words,
         int64_t recv_off, cudaStream_t s, int* kernels) {
  if (nmoves == 0) return 0;
  if (nmoves < 0 || nmoves > 65535) return cudaErrorInvalidValue;
  const dim3 grid(copy_blocks(max_words), static_cast<unsigned>(nmoves));
  move_kernel<W><<<grid, kThreads, 0, s>>>(
      static_cast<const int64_t*>(moves), static_cast<const uint64_t*>(bases),
      const_cast<char*>(static_cast<const char*>(src_local)),
      static_cast<char*>(dst_local), recv_off);
  return launched_if_ok(kernels);
}

template <typename F>
int with_word(int64_t word_bytes, F&& f) {
  switch (word_bytes) {
    case 1: return f(uint8_t{});
    case 2: return f(uint16_t{});
    case 4: return f(uint32_t{});
    case 8: return f(uint64_t{});
    case 16: return f(uint4{});
    default: return cudaErrorInvalidValue;
  }
}

#define PS_TRY(x)            \
  do {                       \
    const int err_ = (x);    \
    if (err_) return err_;   \
  } while (0)

template <typename W>
int exchange(int variant, const void* src, void* dst, const void* bases,
             const uint64_t* bases_host, int me, const PeerSet& set,
             uint64_t e, const void* puts, int nputs, const void* unpacks,
             int nunpacks, int64_t max_words, int64_t half_bytes,
             cudaStream_t s, int* kernels, int* memops) {
  const auto* b = static_cast<const uint64_t*>(bases);
  switch (variant) {
    case 0:
      signal_wait_kernel<<<1, kMaxPeers, 0, s>>>(b, me, set, 2 * e + 1);
      PS_TRY(launched_if_ok(kernels));
      PS_TRY(move<W>(puts, nputs, bases, src, dst, max_words, 0, s,
                     kernels));
      signal_wait_kernel<<<1, kMaxPeers, 0, s>>>(b, me, set, 2 * e + 2);
      PS_TRY(launched_if_ok(kernels));
      return move<W>(unpacks, nunpacks, bases, src, dst, max_words, 0, s,
                     kernels);
    case 1:
      PS_TRY(write_signals(bases_host, me, set, 2 * e + 1, s, memops));
      PS_TRY(wait_signals(bases_host, me, set, 2 * e + 1, s, memops));
      PS_TRY(move<W>(puts, nputs, bases, src, dst, max_words, 0, s,
                     kernels));
      PS_TRY(write_signals(bases_host, me, set, 2 * e + 2, s, memops));
      PS_TRY(wait_signals(bases_host, me, set, 2 * e + 2, s, memops));
      return move<W>(unpacks, nunpacks, bases, src, dst, max_words, 0, s,
                     kernels);
    case 2:
    case 3: {
      const int64_t off = (e % 2) * half_bytes;
      PS_TRY(move<W>(puts, nputs, bases, src, dst, max_words, off, s,
                     kernels));
      if (variant == 2) {
        PS_TRY(write_signals(bases_host, me, set, 2 * e + 2, s, memops));
      } else {
        signal_kernel<<<1, kMaxPeers, 0, s>>>(b, me, set, 2 * e + 2);
        PS_TRY(launched_if_ok(kernels));
      }
      PS_TRY(wait_signals(bases_host, me, set, 2 * e + 2, s, memops));
      return move<W>(unpacks, nunpacks, bases, src, dst, max_words, off, s,
                     kernels);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The device's answers: [64-bit stream memory operations, wait NOR, flush
// of remote writes, lookup status (0 ready)].
extern "C" void ps_caps(int* out) {
  Driver& d = driver();
  out[0] = d.mem_ops_64;
  out[1] = d.wait_nor;
  out[2] = d.flush_remote;
  out[3] = d.status;
}

// One signal-then-wait round at `epoch` among `peers` (see the header).
extern "C" int ps_round(int kind, const void* bases, const void* bases_host,
                        int me, const int* peers, int npeers, uint64_t epoch,
                        void* stream, int* kernels, int* memops) {
  *kernels = *memops = 0;
  PeerSet set;
  PS_TRY(make_set(peers, npeers, &set));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint64_t*>(bases);
  const auto* bh = static_cast<const uint64_t*>(bases_host);
  switch (kind) {
    case 0:
      signal_wait_kernel<<<1, kMaxPeers, 0, s>>>(b, me, set, epoch);
      return launched_if_ok(kernels);
    case 1:
      PS_TRY(write_signals(bh, me, set, epoch, s, memops));
      return wait_signals(bh, me, set, epoch, s, memops);
    case 2:
      signal_kernel<<<1, kMaxPeers, 0, s>>>(b, me, set, epoch);
      PS_TRY(launched_if_ok(kernels));
      return wait_signals(bh, me, set, epoch, s, memops);
    default:
      return cudaErrorInvalidValue;
  }
}

// One exchange of `variant` (see the header); the arguments of
// cudecomp_peer_a2a / cudecomp_peer_halo, plus the host copy of the bases
// and the bytes of half the receive region (variants 2 and 3).  src == dst
// for K3.
extern "C" int ps_exchange(int variant, const void* src, void* dst,
                           const void* bases, const void* bases_host, int me,
                           const int* peers, int npeers, uint64_t e,
                           const void* puts, int nputs, const void* unpacks,
                           int nunpacks, int64_t max_words,
                           int64_t word_bytes, int64_t half_bytes,
                           void* stream, int* kernels, int* memops) {
  *kernels = *memops = 0;
  PeerSet set;
  PS_TRY(make_set(peers, npeers, &set));
  return with_word(word_bytes, [&](auto w) {
    return exchange<decltype(w)>(
        variant, src, dst, bases, static_cast<const uint64_t*>(bases_host),
        me, set, e, puts, nputs, unpacks, nunpacks, max_words, half_bytes,
        static_cast<cudaStream_t>(stream), kernels, memops);
  });
}
