// K2 (the one-sided all-to-all) and K3 (the one-sided halo ring) over one
// process group, for Hopper (sm_90a).  At P = 1 K2 is K2s, the smoke of its
// single-rank program.
//
// Replaces the TPU kernels of cudecomp_tpu/ops/pallas_kernels.py:
//   * K2: exchange_pallas_a2a (:183, pallas_call :219) running _a2a_kernel
//     (:84-138), and mosaic_smoke's P = 1 program (:241, call :261).  Block
//     contract of parallel/collectives.py: the input holds P blocks, block p
//     for group rank p; the output holds in block q what rank q sent.
//   * K3: halo_exchange_pallas (:571, pallas_call :604) running _halo_kernel
//     (:517-568), with the caller's restore of non-periodic edges
//     (:597-628).  Along one array dim, with halo width h, max split m and
//     this rank's valid extent v (per rank, from the splits table), the high
//     interior slab [v, v+h) goes to the right neighbour's low halo [0, h),
//     the low slab [h, 2h) to the left neighbour's high halo [h+m, 2h+m); at
//     a non-periodic edge nothing crosses and that halo keeps its values.
//     The reference's NVSHMEM halo has the same shape: pack into a
//     workspace, put, unpack (include/internal/halo.h:195-305).
//
// Transport.  Every rank of a group owns one workspace
// (parallel/symmetric.py) that the others map: its first kPadBytes hold one
// 8-byte signal slot per group rank, the receive region follows.  `bases` is
// a device array of the workspaces' base addresses, indexed by group rank.
// The signal pad stands in for the Pallas barrier semaphore and the DMA
// receive semaphores (_a2a_kernel :88-102 and :126-138, _halo_kernel
// :533-541).
//
// One exchange over P > 1 ranks is four launches on the caller's stream,
// counted as one K2 or K3 launch by ops/peer_kernels.py:
//   1. signal_wait(2e+1) with the peer set: the entry barrier, so no put
//      lands in a receive region that its owner is still reading;
//   2. the puts of the plan, all in one grid (blockIdx.y = move): K2's self
//      block straight to the output tensor (the JAX kernel's local DMA,
//      :104-110) and block p to rank p's receive region, in the slot of
//      this rank among p's P-1 senders; K3's two slabs, strided when the dim
//      is not the outermost, packed into slot 0 of the right neighbour's
//      region and slot 1 of the left neighbour's;
//   3. signal_wait(2e+2): the peers' puts have landed here;
//   4. the unpacks: K2 copies its P-1 received blocks out to the output
//      tensor, which the caller then owns; K3 writes its slots into its
//      halos, in place.
// e counts the workspace's exchanges, so a slot only grows and the pads are
// never reset; a rank may run ahead of one that it does not wait for, which
// is why a wait compares with >=.  The barrier is a one-block launch between
// the many-block copy launches on the same stream, so no wait depends on a
// block being resident beside another.  Every spin is bounded by
// %globaltimer: a peer that never signals fails the run with __trap() after
// kTimeoutNs instead of holding the card.  The fences are system scope, so
// the same code is right across NVLink.
//
// K2 at P = 1 has no peer: no barrier and no workspace (the JAX kernel's
// `if P > 1 and barrier`, :88).  Its program is one launch of the copy
// kernel, blocks -> out, one pass (cudecomp_peer_copy).
//
// The moves are the plans of ops/peer_kernels.py (a2a_plan, halo_plan),
// uploaded once as a table; the kernel adds nothing to them.  A move is
// `rows` runs of `row_bytes`, copied in the widest word (up to 16 bytes) that
// the plan's offsets and the tensors' addresses allow; the wrapper picks it.
//
// What bounds it on this card: bytes.  K2 reads each rank's P blocks once
// and writes them once, the self block into the output and the others into
// the peers' receive regions, then reads and writes the P-1 received blocks
// once more in the copy-out: (4P - 2) blocks of traffic per rank, a pass the
// port keeps until the puts can target the peers' output tensors.  K3 moves
// four faces per dim (two slabs read, two halos written) plus the packed
// copies; at 512^3 f32 a face is half a megabyte, so its four launches and
// two barriers are the cost.
//
// Plain C interface for ctypes: no synchronisation, no allocation; returns
// the first cudaGetLastError() that is not cudaSuccess, and sets
// *launched to the number of kernels the call launched (each launch adds
// one where it is made, so ops/peer_kernels.py counts what ran).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kMaxPeers = 64;
constexpr int64_t kPadBytes = 4096;  // kMaxPeers slots of 8 bytes, aligned
constexpr uint64_t kTimeoutNs = 20ull * 1000 * 1000 * 1000;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 2048;
// A plan's moves as the kernels read them: one row of 8 int64 per move,
// [src_rank, src_off, src_stride, dst_rank, dst_off, dst_stride, rows,
//  row_bytes]; rank -1 is the caller's tensor.
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

// Rank `me` writes `epoch` into slot `me` of the pad of every rank in its
// peer set, then waits until slot p of its own pad has reached `epoch` for
// every p in the set.  One block of kMaxPeers threads; thread t serves peer
// set.ranks[t].
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
      printf("cudecomp peer exchange: rank %d waited %llu s for rank %d to "
             "reach epoch %llu\n", me,
             static_cast<unsigned long long>(kTimeoutNs / 1000000000ull), p,
             static_cast<unsigned long long>(epoch));
      __trap();
    }
    __nanosleep(128);
  }
}

// The error of the launch just made; adds one to *launched if it launched.
cudaError_t launched_if_ok(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

cudaError_t signal_wait(const void* bases, int me, const int* peers,
                        int npeers, uint64_t epoch, cudaStream_t stream,
                        int* launched) {
  if (npeers < 1 || npeers > kMaxPeers) return cudaErrorInvalidValue;
  PeerSet set;
  set.n = npeers;
  for (int i = 0; i < npeers; ++i) set.ranks[i] = peers[i];
  signal_wait_kernel<<<1, kMaxPeers, 0, stream>>>(
      static_cast<const uint64_t*>(bases), me, set, epoch);
  return launched_if_ok(launched);
}

// Byte address of offset `off` in the receive region of rank `rank`'s
// workspace, or in `local` when rank < 0.
__device__ __forceinline__ char* region(const uint64_t* bases, char* local,
                                        int64_t rank, int64_t off) {
  return (rank < 0 ? local
                   : reinterpret_cast<char*>(bases[rank]) + kPadBytes) + off;
}

// One contiguous run of `words` words: a grid-stride loop with kUnroll loads
// in flight before their stores; thread i of `step` starts at word i.
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

// Move blockIdx.y of the table.  One run (K2's blocks and copy-out) takes
// copy_run; several strided rows (K3's slabs and halos) index row and column
// per word.
template <typename W>
__global__ void __launch_bounds__(kThreads)
move_kernel(const int64_t* __restrict__ moves,
            const uint64_t* __restrict__ bases, char* src_local,
            char* dst_local) {
  const int64_t* m = moves + kMoveFields * blockIdx.y;
  const char* src = region(bases, src_local, m[0], m[1]);
  char* dst = region(bases, dst_local, m[3], m[4]);
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
  __threadfence_system();  // the puts are visible before the next signal
}

// K2's single-rank program: `words` words from src to dst.
template <typename W>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const W* __restrict__ src, W* __restrict__ dst, int64_t words) {
  copy_run(src, dst, words,
           static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
           static_cast<int64_t>(gridDim.x) * blockDim.x);
}

// Blocks of kThreads threads for a copy of `words` words, kUnroll each.
unsigned copy_blocks(int64_t words) {
  int64_t blocks = (words + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

template <typename W>
cudaError_t copy(const void* src, void* dst, int64_t words,
                 cudaStream_t stream, int* launched) {
  copy_kernel<W><<<copy_blocks(words), kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst), words);
  return launched_if_ok(launched);
}

template <typename W>
cudaError_t move(const void* moves, int nmoves, const void* bases,
                 const void* src_local, void* dst_local, int64_t max_words,
                 cudaStream_t stream, int* launched) {
  if (nmoves == 0) return cudaSuccess;  // K3 at a non-periodic edge
  if (nmoves < 0 || nmoves > 65535) return cudaErrorInvalidValue;
  const dim3 grid(copy_blocks(max_words), static_cast<unsigned>(nmoves));
  move_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const int64_t*>(moves), static_cast<const uint64_t*>(bases),
      const_cast<char*>(static_cast<const char*>(src_local)),
      static_cast<char*>(dst_local));
  return launched_if_ok(launched);
}

template <typename W>
cudaError_t exchange(const void* src, void* dst, const void* bases, int me,
                     const int* peers, int npeers, uint64_t e,
                     const void* puts, int nputs, const void* unpacks,
                     int nunpacks, int64_t max_words, cudaStream_t s,
                     int* launched) {
  cudaError_t err =
      signal_wait(bases, me, peers, npeers, 2 * e + 1, s, launched);
  if (err != cudaSuccess) return err;
  err = move<W>(puts, nputs, bases, src, dst, max_words, s, launched);
  if (err != cudaSuccess) return err;
  err = signal_wait(bases, me, peers, npeers, 2 * e + 2, s, launched);
  if (err != cudaSuccess) return err;
  return move<W>(unpacks, nunpacks, bases, src, dst, max_words, s, launched);
}

// f(W{}) for the word type W of `word_bytes` bytes.
template <typename F>
cudaError_t with_word(int64_t word_bytes, F&& f) {
  switch (word_bytes) {
    case 1: return f(uint8_t{});
    case 2: return f(uint16_t{});
    case 4: return f(uint32_t{});
    case 8: return f(uint64_t{});
    case 16: return f(uint4{});
    default: return cudaErrorInvalidValue;
  }
}

// The puts read `src` where a move's source rank is -1, the unpacks write
// `dst` where its destination rank is -1.
int run(const void* src, void* dst, const void* bases, int me,
        const int* peers, int npeers, uint64_t e, const void* puts, int nputs,
        const void* unpacks, int nunpacks, int64_t max_words,
        int64_t word_bytes, void* stream, int* launched) {
  *launched = 0;
  return with_word(word_bytes, [&](auto w) {
    return exchange<decltype(w)>(src, dst, bases, me, peers, npeers, e, puts,
                                 nputs, unpacks, nunpacks, max_words,
                                 static_cast<cudaStream_t>(stream), launched);
  });
}

}  // namespace

// One exchange, e = `exchange_index`, the count of earlier exchanges on this
// workspace.  `puts` and `unpacks` are device tables of moves (rows of 8
// int64, see kMoveFields); `max_words` is the largest move in words of
// `word_bytes` bytes.  *launched: the kernels the call launched.

// K2 over P > 1 ranks: the self block to `out`, the others to the peers'
// receive regions; the received blocks to `out`.
extern "C" int cudecomp_peer_a2a(const void* blocks, void* out,
                                 const void* bases, int me, const int* peers,
                                 int npeers, uint64_t exchange_index,
                                 const void* puts, int nputs,
                                 const void* unpacks, int nunpacks,
                                 int64_t max_words, int64_t word_bytes,
                                 void* stream, int* launched) {
  return run(blocks, out, bases, me, peers, npeers, exchange_index, puts,
             nputs, unpacks, nunpacks, max_words, word_bytes, stream,
             launched);
}

// K2 at P = 1 (K2s's program): one launch, `words` words of `word_bytes`
// bytes from `blocks` to `out`; no barrier, no workspace.
extern "C" int cudecomp_peer_copy(const void* blocks, void* out,
                                  int64_t words, int64_t word_bytes,
                                  void* stream, int* launched) {
  *launched = 0;
  if (words <= 0) return cudaSuccess;
  return with_word(word_bytes, [&](auto w) {
    return copy<decltype(w)>(blocks, out, words,
                             static_cast<cudaStream_t>(stream), launched);
  });
}

// K3: one halo update of one dim of `buf`, in place.
extern "C" int cudecomp_peer_halo(void* buf, const void* bases, int me,
                                  const int* peers, int npeers,
                                  uint64_t exchange_index, const void* puts,
                                  int nputs, const void* unpacks,
                                  int nunpacks, int64_t max_words,
                                  int64_t word_bytes, void* stream,
                                  int* launched) {
  return run(buf, buf, bases, me, peers, npeers, exchange_index, puts, nputs,
             unpacks, nunpacks, max_words, word_bytes, stream, launched);
}
