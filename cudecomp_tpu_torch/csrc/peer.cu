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
// 8-byte signal slot per group rank, the receive region follows, in two
// halves.  `bases` is a device array of the workspaces' base addresses,
// indexed by group rank, and `bases_host` the same addresses in host
// memory.  The signal pad stands in for the DMA receive semaphores of the
// Pallas kernels (_a2a_kernel :88-102 and :126-138, _halo_kernel :533-541).
//
// One exchange e over P > 1 ranks is four operations on the caller's
// stream, the order of ops/peer_kernels.sync_schedule (counted as one K2 or
// K3 launch by ops/peer_kernels.py; two kernels, 2(P-1) stream memory
// operations):
//   1. the puts of the plan, all in one grid (blockIdx.y = move): K2's self
//      block straight to the output tensor (the JAX kernel's local DMA,
//      :104-110) and block p to rank p's receive region, in the slot of
//      this rank among p's P-1 senders; K3's two slabs, strided when the dim
//      is not the outermost, packed into slot 0 of the right neighbour's
//      region and slot 1 of the left neighbour's.  Every put of exchange e
//      lands in half e % 2 of the peer's receive region;
//   2. the signal: one batch of stream writes (cuStreamBatchMemOp) of e + 1
//      into slot `me` of the pad of every other rank of the group.  A write
//      with the default flags is preceded by a fence of the stream's
//      earlier writes at system scope, so a peer that reads the signal sees
//      the puts;
//   3. the wait: one batch of stream waits until slot p of this rank's own
//      pad is >= e + 1 for every other rank p (CU_STREAM_WAIT_VALUE_GEQ,
//      with CU_STREAM_WAIT_VALUE_FLUSH where the device reports
//      CAN_FLUSH_REMOTE_WRITES: across NVLink the flush makes the peers'
//      earlier remote writes visible before the unpack reads them).  No
//      kernel runs while a rank waits: the wait is the front end's, so a
//      card that several processes time-slice switches to one that has
//      work;
//   4. the unpacks from half e % 2: K2 copies its P-1 received blocks out
//      to the output tensor, which the caller then owns; K3 writes its slots
//      into its halos, in place.
// Why two halves and no entry barrier: a put of exchange e into rank q's
// half e % 2 must not land before q has unpacked exchange e - 2 from that
// half.  The put follows this rank's wait of exchange e - 1 on every other
// rank, and q's signal of e - 1 follows q's unpack of e - 2 on q's stream.
// Signalling and waiting for every other rank, and not only for the plan's
// peers, keeps that true when exchanges with other plans (K2 and K3, a
// non-periodic edge) share the workspace.  A slot only grows, so a rank
// that runs ahead of one it does not wait for is harmless, and a wait
// compares with >=.  The first design, a spinning one-block barrier kernel
// before the puts and before the unpacks, was slower on a card that four
// ranks time-slice: a spinning kernel holds the card, a stream wait yields
// it.
//
// A lost peer.  A stream wait has no timer of its own.  ops/peer_kernels.py
// records a CUDA event before each exchange and one after it, and a
// watchdog thread polls them: an exchange whose first event has completed
// and whose second has not within WAIT_BOUND_S (20 s, polled every 0.1 s)
// ends the process with an error naming the group rank, the group size,
// the epoch and the peers it waits for.
//
// The CUDA driver's stream memory operations are reached through
// cudaGetDriverEntryPoint, as csrc/stencil27.cu reaches the tensor-map
// encoder, so the library links no libcuda.  A device without 64-bit stream
// memory operations (CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS), or
// a missing entry point, makes cudecomp_peer_sync_caps report it and every
// exchange fail; ops/peer_kernels.py raises at load.  Nothing falls back to
// a spinning kernel.
//
// K2 at P = 1 has no peer: no signal and no workspace (the JAX kernel's
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
// copies; at 512^3 f32 a face is half a megabyte, so the time is the two
// launches and the stream operations around them.
//
// Plain C interface for ctypes: no synchronisation, no allocation; returns
// 0, the first cudaGetLastError() that is not cudaSuccess, or
// kDriverError + the CUresult of a failed stream memory operation; sets
// *launched to the number of kernels and *memops to the number of stream
// memory operations the call issued (each adds one where it is made, so
// ops/peer_kernels.py counts what ran).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPeers = 64;
constexpr int64_t kPadBytes = 4096;  // kMaxPeers slots of 8 bytes, aligned
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 2048;
constexpr int kMaxDevices = 64;
// returned as kDriverError + the CUresult of a failed memory operation,
// kDriverError + kNoDriver when the device cannot run them
constexpr int kDriverError = 10000;
constexpr int kNoDriver = 9999;
// A plan's moves as the kernels read them: one row of 8 int64 per move,
// [src_rank, src_off, src_stride, dst_rank, dst_off, dst_stride, rows,
//  row_bytes]; rank -1 is the caller's tensor.
constexpr int kMoveFields = 8;

struct PeerSet {
  int n;
  int ranks[kMaxPeers];
};

// -- the stream memory operations ---------------------------------------------

using DeviceGetFn = CUresult (*)(CUdevice*, int);
using AttributeFn = CUresult (*)(int*, CUdevice_attribute, CUdevice);
using BatchFn = CUresult (*)(CUstream, unsigned int,
                             CUstreamBatchMemOpParams*, unsigned int);

// What one device can do, looked up at its first exchange.
struct Caps {
  // -1 not looked up; 0 ready; 1 an entry point is missing; 2 a query
  // failed; 3 no 64-bit stream memory operations
  int status = -1;
  int mem_ops_64 = 0;
  int flush_remote = 0;
};

BatchFn g_batch = nullptr;
Caps g_caps[kMaxDevices];

void* entry_point(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return fn;
}

// The caps of the current device (looked up once per device).
const Caps& caps() {
  static Caps none{1, 0, 0};
  int ordinal = 0;
  if (cudaGetDevice(&ordinal) != cudaSuccess || ordinal < 0 ||
      ordinal >= kMaxDevices)
    return none;
  Caps& c = g_caps[ordinal];
  if (c.status >= 0) return c;
  const auto device_get =
      reinterpret_cast<DeviceGetFn>(entry_point("cuDeviceGet"));
  const auto attribute =
      reinterpret_cast<AttributeFn>(entry_point("cuDeviceGetAttribute"));
  g_batch = reinterpret_cast<BatchFn>(entry_point("cuStreamBatchMemOp"));
  CUdevice dev;
  if (!device_get || !attribute || !g_batch) {
    c.status = 1;
  } else if (device_get(&dev, ordinal) != CUDA_SUCCESS ||
             attribute(&c.mem_ops_64,
                       CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
                       dev) != CUDA_SUCCESS ||
             attribute(&c.flush_remote,
                       CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES,
                       dev) != CUDA_SUCCESS) {
    c.status = 2;
  } else {
    c.status = c.mem_ops_64 ? 0 : 3;
  }
  return c;
}

// One batch of 64-bit stream memory operations on the slots of `set`: with
// `wait`, wait until slot p of this rank's pad is >= value for every p in
// the set; else write value into slot `me` of every peer's pad.
int mem_ops(bool wait, const uint64_t* bases_host, int me,
            const PeerSet& set, uint64_t value, cudaStream_t s,
            int* memops) {
  const Caps& c = caps();
  if (c.status) return kDriverError + kNoDriver;
  CUstreamBatchMemOpParams ops[kMaxPeers] = {};
  for (int i = 0; i < set.n; ++i) {
    const uint64_t p = static_cast<uint64_t>(set.ranks[i]);
    if (wait) {
      ops[i].waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_64;
      ops[i].waitValue.address =
          static_cast<CUdeviceptr>(bases_host[me] + 8 * p);
      ops[i].waitValue.value64 = value;
      ops[i].waitValue.flags =
          CU_STREAM_WAIT_VALUE_GEQ |
          (c.flush_remote ? CU_STREAM_WAIT_VALUE_FLUSH : 0u);
    } else {
      ops[i].writeValue.operation = CU_STREAM_MEM_OP_WRITE_VALUE_64;
      ops[i].writeValue.address = static_cast<CUdeviceptr>(
          bases_host[p] + 8 * static_cast<uint64_t>(me));
      ops[i].writeValue.value64 = value;
      ops[i].writeValue.flags = CU_STREAM_WRITE_VALUE_DEFAULT;
    }
  }
  const CUresult r = g_batch(s, static_cast<unsigned>(set.n), ops, 0);
  if (r != CUDA_SUCCESS) return kDriverError + static_cast<int>(r);
  *memops += set.n;
  return 0;
}

// -- the moves ----------------------------------------------------------------

// The error of the launch just made; adds one to *launched if it launched.
int launched_if_ok(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

// Byte address of offset `off` in the receive region of rank `rank`'s
// workspace, `recv_off` bytes in (the half of the exchange), or in `local`
// when rank < 0.
__device__ __forceinline__ char* region(const uint64_t* bases, char* local,
                                        int64_t rank, int64_t off,
                                        int64_t recv_off) {
  return (rank < 0 ? local
                   : reinterpret_cast<char*>(bases[rank]) + kPadBytes +
                         recv_off) + off;
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
int copy(const void* src, void* dst, int64_t words, cudaStream_t stream,
         int* launched) {
  copy_kernel<W><<<copy_blocks(words), kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst), words);
  return launched_if_ok(launched);
}

template <typename W>
int move(const void* moves, int nmoves, const void* bases,
         const void* src_local, void* dst_local, int64_t max_words,
         int64_t recv_off, cudaStream_t stream, int* launched) {
  if (nmoves == 0) return 0;  // K3 at a non-periodic edge
  if (nmoves < 0 || nmoves > 65535) return cudaErrorInvalidValue;
  const dim3 grid(copy_blocks(max_words), static_cast<unsigned>(nmoves));
  move_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const int64_t*>(moves), static_cast<const uint64_t*>(bases),
      const_cast<char*>(static_cast<const char*>(src_local)),
      static_cast<char*>(dst_local), recv_off);
  return launched_if_ok(launched);
}

#define PEER_TRY(x)          \
  do {                       \
    const int err_ = (x);    \
    if (err_) return err_;   \
  } while (0)

template <typename W>
int exchange(const void* src, void* dst, const void* bases,
             const uint64_t* bases_host, int me, const PeerSet& set,
             uint64_t e, const void* puts, int nputs, const void* unpacks,
             int nunpacks, int64_t max_words, int64_t half_bytes,
             cudaStream_t s, int* launched, int* memops) {
  const int64_t half = static_cast<int64_t>(e & 1) * half_bytes;
  PEER_TRY(move<W>(puts, nputs, bases, src, dst, max_words, half, s,
                   launched));
  PEER_TRY(mem_ops(false, bases_host, me, set, e + 1, s, memops));
  PEER_TRY(mem_ops(true, bases_host, me, set, e + 1, s, memops));
  return move<W>(unpacks, nunpacks, bases, src, dst, max_words, half, s,
                 launched);
}

// f(W{}) for the word type W of `word_bytes` bytes.
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

// The puts read `src` where a move's source rank is -1, the unpacks write
// `dst` where its destination rank is -1.
int run(const void* src, void* dst, const void* bases, const void* bases_host,
        int me, const int* peers, int npeers, uint64_t e, const void* puts,
        int nputs, const void* unpacks, int nunpacks, int64_t max_words,
        int64_t word_bytes, int64_t half_bytes, void* stream, int* launched,
        int* memops) {
  *launched = *memops = 0;
  if (npeers < 1 || npeers > kMaxPeers) return cudaErrorInvalidValue;
  PeerSet set;
  set.n = npeers;
  for (int i = 0; i < npeers; ++i) set.ranks[i] = peers[i];
  return with_word(word_bytes, [&](auto w) {
    return exchange<decltype(w)>(
        src, dst, bases, static_cast<const uint64_t*>(bases_host), me, set, e,
        puts, nputs, unpacks, nunpacks, max_words, half_bytes,
        static_cast<cudaStream_t>(stream), launched, memops);
  });
}

}  // namespace

// What the current device offers the exchanges: out[0] 64-bit stream memory
// operations, out[1] the flush of remote writes; returns 0 when the
// exchanges can run, else 1 (a driver entry point is missing), 2 (a query
// failed) or 3 (no 64-bit stream memory operations).
extern "C" int cudecomp_peer_sync_caps(int* out) {
  const Caps& c = caps();
  out[0] = c.mem_ops_64;
  out[1] = c.flush_remote;
  return c.status;
}

// One exchange, e = `exchange_index`, the count of earlier exchanges on this
// workspace.  `peers`: every other rank of the group, which this rank
// signals and waits for.  `puts` and `unpacks` are device tables of moves
// (rows of 8 int64, see kMoveFields); `max_words` is the largest move in
// words of `word_bytes` bytes; `half_bytes` half the receive region.
// *launched: the kernels the call launched; *memops: the stream memory
// operations it issued.

// K2 over P > 1 ranks: the self block to `out`, the others to the peers'
// receive regions; the received blocks to `out`.
extern "C" int cudecomp_peer_a2a(const void* blocks, void* out,
                                 const void* bases, const void* bases_host,
                                 int me, const int* peers, int npeers,
                                 uint64_t exchange_index, const void* puts,
                                 int nputs, const void* unpacks, int nunpacks,
                                 int64_t max_words, int64_t word_bytes,
                                 int64_t half_bytes, void* stream,
                                 int* launched, int* memops) {
  return run(blocks, out, bases, bases_host, me, peers, npeers,
             exchange_index, puts, nputs, unpacks, nunpacks, max_words,
             word_bytes, half_bytes, stream, launched, memops);
}

// K2 at P = 1 (K2s's program): one launch, `words` words of `word_bytes`
// bytes from `blocks` to `out`; no signal, no workspace.
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
extern "C" int cudecomp_peer_halo(void* buf, const void* bases,
                                  const void* bases_host, int me,
                                  const int* peers, int npeers,
                                  uint64_t exchange_index, const void* puts,
                                  int nputs, const void* unpacks,
                                  int nunpacks, int64_t max_words,
                                  int64_t word_bytes, int64_t half_bytes,
                                  void* stream, int* launched, int* memops) {
  return run(buf, buf, bases, bases_host, me, peers, npeers, exchange_index,
             puts, nputs, unpacks, nunpacks, max_words, word_bytes,
             half_bytes, stream, launched, memops);
}
