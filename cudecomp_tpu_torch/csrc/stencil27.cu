// K4: the weighted 3x3x3 (27-point) stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel cudecomp_tpu/ops/stencil.py: _stencil27_kernel,
// launched by _ghost_plane_call.  It computes, in memory-dim order,
//
//   out[i,j,k] = sum over the nonzero taps of
//                w[1+dx,1+dy,1+dz] * E(i+dx, j+dy, k+dz)
//
// with the taps summed in JAX's order (dx, then dy, then dz ascending) as an
// FMA chain in the tensor's type (float or double; in float for bfloat16
// and half, rounded once), and E the input extended by one cell on each
// side of each dim, in one of two input modes:
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
// far under the card's FP32 rate.
//
// What held the first design (32 x 16 tiles, 4-byte cp.async by every
// thread, one __syncthreads() per plane, four outputs per thread, each plane
// read from shared memory for each of its three output planes) to half of
// clone()'s rate, measured by tools/k4_variants.py --ablate at 512^3 f32
// (PERF.md): taking out the per-plane barrier saved nothing, nor did 16-byte
// copies or longer x-chunks; taking out the compute phase between the
// barriers (three shared-memory reads of each plane and the FMAs) saved a
// third of the time.  So this design reads each plane once, gives each
// thread twice the outputs, and spends no thread instruction and no
// block-wide barrier on moving a plane:
//
//   * one producer warp streams the planes of a 64 (z) x 16 (y) tile and
//     its one-cell ring into a ring of shared-memory stages, several planes
//     ahead: one TMA copy of a 3D box per plane (the tensor map comes from
//     the host as a __grid_constant__ parameter; cells past the block's
//     edges arrive as zeros), completed on the stage's "full" mbarrier with
//     its byte count.  A box must start at a 16-byte boundary of a row, so
//     a stage row holds the tile and 16 bytes on each side (in valid mode,
//     whose source is the extended block, one cell more on the left).
//     Where the block cannot be a TMA source (rows that are no multiple of
//     16 bytes, as the (n+2)-cell rows of valid mode at n = 512), all five
//     warps copy each box by cp.async, a share of its rows each, the
//     consumers S - 1 planes ahead, in chunks of up to 16 bytes with a zero
//     fill past the edges, and arrive on the same barrier when their copies
//     land;
//   * four consumer warps wait on the stage's "full" barrier, read the plane
//     once and release it on its "empty" barrier, which the producer waits
//     on before refilling: no block-wide barrier per plane;
//   * ring cells the box cannot give (a wrapped row or column, a cell of a
//     y or z ghost plane, a ghost corner) exist only in edge tiles.  There
//     the producer lanes load them from device memory (their sources are
//     worked out once per block) one plane ahead into side slots of the
//     stage, and the consumers copy them into the ring behind a named
//     barrier among the consumer warps; the branch is block-uniform, so
//     interior tiles resolve no coordinate per cell;
//   * rolling accumulators: each thread owns 8 outputs along y in one z
//     column and keeps the sums of three output planes.  When plane p lands
//     it reads its 3 x 10 neighbourhood once and adds the dx = +1 slice of
//     the weights to plane p-1 (then complete and stored), the dx = 0 slice
//     to plane p and the dx = -1 slice to plane p+1, so each output takes
//     its dx = -1, 0, +1 taps in JAX's order;
//   * a face instance for tap sets within the centre and its six faces
//     (the diffusion step, laplacian7, the CG matvec) reads only the centre
//     column's 10 cells and the side columns' 8; every other set takes the
//     dense instance.  Zero taps are skipped by uniform branches; weights
//     travel by value in the kernel's parameters;
//   * x-chunks of about 32 planes (ops/stencil_kernel.stencil_plan), so
//     that the grid is several waves and the slower edge tiles spread over
//     the card; ragged edges are masked, so any extents >= 1 run, and
//     offsets are 64-bit.
//
// The layout (instance, loader, x-chunk, stages) comes from the caller,
// which picks it with ops/stencil_kernel.stencil_plan; the entry checks it
// and refuses any other.  cudecomp_stencil27_smem_bytes exports the shared
// memory of a layout, cudecomp_stencil27_encode_map the TMA tensor map of a
// block.  Plain C interface for ctypes: the launch goes on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kTZ = 64;             // tile along z, the contiguous dim
constexpr int kPer = 8;             // consecutive outputs per thread along y
constexpr int kZWarps = kTZ / 32;   // consumer warps across z
constexpr int kYWarps = 2;          // consumer warps across y
constexpr int kTY = kYWarps * kPer;  // tile along y
constexpr int kConsumers = kZWarps * kYWarps;  // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kRows = kTY + 2;      // ring rows of a stage
constexpr int kMinStages = 2;
constexpr int kMaxStages = 16;
constexpr int kMaxSmem = 232448;    // 227 KB, the most a block may hold
// ring cells an edge tile patches (two rows of kTZ + 2, two columns of
// kRows): the side slots of a stage, and the cells each consumer copies
constexpr int kSide = 2 * (kTZ + 2) + 2 * kRows;
constexpr int kPatch = (kSide + 32 * kConsumers - 1) / (32 * kConsumers);

enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

// cells of a stage row: the tile and 16 bytes on each side.  A TMA box
// starts at a 16-byte boundary of the row (an unaligned start is an illegal
// instruction), so a row holds z0 - 16/elem .. z0 + kTZ - 1 + 16/elem, of
// which z0 - 1 and z0 + kTZ are the ring
__host__ __device__ constexpr int halo_of(int elem) { return 16 / elem; }
__host__ __device__ constexpr int pitch_of(int elem) {
  return kTZ + 2 * halo_of(elem);
}

// a stage: the box (kRows rows of pitch_of cells), then kSide side slots,
// rounded up to 128 bytes (a TMA destination's alignment)
__host__ __device__ constexpr int64_t stage_bytes(int elem) {
  return ((static_cast<int64_t>(kRows) * pitch_of(elem) + kSide) * elem +
          127) / 128 * 128;
}

int elem_of(int dtype) {
  switch (dtype) {
    case kF32: return 4;
    case kF64: return 8;
    case kBF16: case kF16: return 2;
    default: return 0;
  }
}

// the stages, then a "full" and an "empty" mbarrier per stage
int64_t smem_bytes(int dtype, int stages) {
  const int elem = elem_of(dtype);
  if (!elem || stages < kMinStages || stages > kMaxStages) return -1;
  return stages * stage_bytes(elem) + 16 * stages;
}

// the taps of the centre and its six faces: t = 9*(dx+1) + 3*(dy+1) + dz+1
constexpr unsigned kFaceTaps = (1u << 4) | (1u << 10) | (1u << 12) |
                               (1u << 13) | (1u << 14) | (1u << 16) |
                               (1u << 22);

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };
template <typename T> using Acc = typename AccOf<T>::type;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_acc(Acc<T> v);
template <> __device__ __forceinline__ float from_acc<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ double from_acc<double>(double v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_acc<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float madd(float w, float v, float acc) {
  return fmaf(w, v, acc);
}
__device__ __forceinline__ double madd(double w, double v, double acc) {
  return fma(w, v, acc);
}

struct Maps {
  CUtensorMap m[3];  // the block (or extended block), x ghost planes lo, hi
};

template <typename T>
struct Args {
  const T* u;      // valid mode: (mx+2, my+2, mz+2); else (mx, my, mz)
  T* out;          // (mx, my, mz)
  const T* gx[2];  // (my, mz) planes below / above x; unused when x wraps
  const T* gy[2];  // (mx, mz)
  const T* gz[2];  // (mx, my)
  int64_t mx, my, mz;
  int64_t xchunk;  // x planes one block marches through
  unsigned wrap;   // bit d: memory dim d wraps (ghost-plane mode)
  unsigned taps;   // bit t: tap t is nonzero
  int stages;
  int tma;         // 1: TMA loads, 0: cp.async by the threads
  int vec;         // cp.async mode: cells per copy (4, 8 or 16 bytes)
};

template <typename A>
struct Weights {
  A w[27];
};

// -- barriers and copies -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// the phase also waits for `bytes` of asynchronous copies (no arrival)
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

// The phase of `bar` also waits for this thread's cp.async copies so far
// (an arrival it adds and makes when they land: no net arrival).
__device__ __forceinline__ void track_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed; traps
// after about 20 s, so a lost arrival fails loudly instead of hanging.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (!start) start = now;
      else if (now - start > 20000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int z, int y, int x, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(z), "r"(y), "r"(x), "r"(bar)
      : "memory");
}

// -- the stencil -------------------------------------------------------------

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

// where a patched ring cell comes from
enum Kind : int { kNone, kPlane, kGyLo, kGyHi, kGzLo, kGzHi, kZero };

// Whether the tile at (y0, z0) is an edge tile of ghost-plane mode: one
// whose ring reaches past the block's y or z edges.
__device__ __forceinline__ bool edge_tile(int64_t my, int64_t mz, int64_t y0,
                                          int64_t z0) {
  return y0 == 0 || y0 + kTY >= my || z0 == 0 || z0 + kTZ >= mz;
}

// Cell i of an edge tile's patch list: its ring row r (y = y0 - 1 + r) and
// ring column c (z = z0 - 1 + c).  The list is the ring rows of y = -1 and
// y = my and the ring columns of z = -1 and z = mz, where the tile holds
// them; false past its end.
__device__ __forceinline__ bool patch_cell(int i, int64_t my, int64_t mz,
                                           int64_t y0, int64_t z0, int& r,
                                           int& c) {
  const int rhi = static_cast<int>(my - y0 + 1);  // ring row of y = my
  const int chi = static_cast<int>(mz - z0 + 1);  // ring column of z = mz
  const int rows = (rhi < kRows - 1 ? rhi : kRows - 1) + 1;
  const int cols = (chi < kTZ + 1 ? chi : kTZ + 1) + 1;
  const int prow0 = y0 == 0 ? 0 : -1;
  const int prow1 = y0 + kTY >= my ? rhi : -1;
  const int pcol0 = z0 == 0 ? 0 : -1;
  const int pcol1 = z0 + kTZ >= mz ? chi : -1;
  r = c = -1;
  if (i < 2 * cols) {  // the two ring rows, whole
    r = i < cols ? prow0 : prow1;
    c = i % cols;
  } else if (i < 2 * cols + 2 * rows) {  // the two ring columns
    const int j = i - 2 * cols;
    c = j < rows ? pcol0 : pcol1;
    r = j % rows;
    if (r == prow0 || r == prow1) r = -1;  // done with the rows
  }
  return r >= 0 && c >= 0;
}

// Plane p of E (p = -1 .. mx) in the source: the block's own plane x (in
// valid mode the extended block's p + 1; in ghost-plane mode p, wrapped),
// or an x ghost plane (src 1 below, 2 above, sx its side).
template <typename T, bool kValid>
__device__ __forceinline__ const T* plane_of(const Args<T>& a, int64_t p,
                                             int64_t& x, int& src, int& sx) {
  x = p;
  src = 0;
  sx = -1;
  if constexpr (kValid) {
    x += 1;
    return a.u + x * (a.my + 2) * (a.mz + 2);
  }
  sx = resolve(x, a.mx, a.wrap & 1u);
  if (sx >= 0) {
    src = 1 + sx;
    return sx ? a.gx[1] : a.gx[0];
  }
  return a.u + x * a.my * a.mz;
}

// A cp.async of B bytes (4, 8 or 16); src_bytes 0 writes zeros.
template <int B>
__device__ __forceinline__ void cp_bytes(uint32_t dst, const void* src,
                                         bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(B), "r"(in ? B : 0) : "memory");
}

// Copies the rows wi, wi + nw, ... of the box of `plane` whose origin is
// (yb, zb) into the stage `st`, each lane the row's chunks lane, lane + 32,
// ...  A chunk is one cp.async of kB bytes (4, 8 or 16), zero-filled past
// the plane's edges (zb and the row length are multiples of a chunk, so
// none straddles an edge); kB = 0 copies one 2-byte cell by plain loads
// and stores.
template <typename T, bool kValid, int kB>
__device__ __forceinline__ void copy_rows(const Args<T>& a, T* st,
                                          const T* plane, int64_t yb,
                                          int64_t zb, int wi, int nw) {
  constexpr int kE = sizeof(T);
  constexpr int kP = pitch_of(kE);
  constexpr int kV = kB ? kB / kE : 1;  // cells per chunk
  constexpr int kCols = (kP / kV + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t nr = kValid ? a.my + 2 : a.my;
  const int64_t nc = kValid ? a.mz + 2 : a.mz;
  bool zin[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t z = zb + (lane + 32 * j) * kV;
    zin[j] = z >= 0 && z < nc;
  }
  for (int r = wi; r < kRows; r += nw) {
    const int64_t y = yb + r;
    const bool yin = y >= 0 && y < nr;
    const T* row = plane + (yin ? y : 0) * nc + zb;
    T* dst = st + r * kP;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = (lane + 32 * j) * kV;
      if (c < kP) {
        const bool in = yin && zin[j];
        if constexpr (kB) {
          cp_bytes<kB>(smem_addr(dst + c), in ? row + c : plane, in);
        } else {
          dst[c] = in ? row[c] : T(0.0f);
        }
      }
    }
  }
}

// copy_rows with the chunk a.vec sets, chosen once per call
template <typename T, bool kValid>
__device__ __forceinline__ void copy_box(const Args<T>& a, T* st,
                                         const T* plane, int64_t yb,
                                         int64_t zb, int wi, int nw) {
  switch (a.vec * static_cast<int>(sizeof(T))) {
    case 4:  // 4-byte chunks of 2- and 4-byte cells
      if constexpr (sizeof(T) <= 4)
        copy_rows<T, kValid, 4>(a, st, plane, yb, zb, wi, nw);
      break;
    case 8: copy_rows<T, kValid, 8>(a, st, plane, yb, zb, wi, nw); break;
    case 16: copy_rows<T, kValid, 16>(a, st, plane, yb, zb, wi, nw); break;
    default: copy_rows<T, kValid, 0>(a, st, plane, yb, zb, wi, nw);
  }
}

// The producer warp: streams planes x0-1 .. x1 into the stages by TMA (in
// cp.async mode it copies one of five row shares of each box, and the
// consumers the others, S - 1 planes ahead).  Each lane arrives once per
// plane on the stage's "full" barrier.  In an edge tile the lanes also
// copy the plane's patch cells from device memory into the stage's side
// slots, by cp.async whose completion the barrier's phase waits for;
// 2-byte cells are loaded into registers and stored at the next plane's
// turn, and the plane's arrivals wait for the stores.
template <typename T, bool kValid>
__device__ __forceinline__ void produce(const Maps& maps, const Args<T>& a,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int64_t x0,
                                        int64_t np, int64_t y0, int64_t z0) {
  constexpr int kE = sizeof(T);
  constexpr int kP = pitch_of(kE);
  constexpr int kH = halo_of(kE);
  constexpr uint32_t kBoxBytes = kRows * kP * kE;
  constexpr int kCells = (kSide + 31) / 32;  // patch cells per lane
  const int lane = threadIdx.x & 31;
  // the box's origin in the source's coordinates
  const int64_t zb = z0 - kH;
  const int64_t yb = kValid ? y0 : y0 - 1;

  // this lane's patch cells: where each comes from (per block, once)
  const bool edge = !kValid && edge_tile(a.my, a.mz, y0, z0);
  int kind[kCells];
  int64_t off[kCells];
#pragma unroll
  for (int l = 0; l < kCells; ++l) {
    kind[l] = kNone;
    off[l] = 0;
    int r, c;
    if (!edge || !patch_cell(lane + 32 * l, a.my, a.mz, y0, z0, r, c))
      continue;
    int64_t y = y0 - 1 + r, z = z0 - 1 + c;
    const int sy = resolve(y, a.my, a.wrap & 2u);
    const int sz = resolve(z, a.mz, a.wrap & 4u);
    if (sy < 0 && sz < 0) {
      kind[l] = kPlane;
      off[l] = y * a.mz + z;
    } else if (sz < 0) {
      kind[l] = kGyLo + sy;
      off[l] = z;
    } else if (sy < 0) {
      kind[l] = kGzLo + sz;
      off[l] = y;
    } else {
      kind[l] = kZero;  // a ghost corner
    }
  }
  T pv[kCells];  // the patch values of the last plane issued

  // stores the patch values of plane k into its stage and arrives
  auto finish = [&](int64_t k) {
    const int s = static_cast<int>(k % a.stages);
    T* side = reinterpret_cast<T*>(smem + s * stage_bytes(kE) + kBoxBytes);
#pragma unroll
    for (int l = 0; l < kCells; ++l)
      if (kind[l] != kNone) side[lane + 32 * l] = pv[l];
    bar_arrive(smem_addr(&full[s]));
  };

  for (int64_t k = 0; k < np; ++k) {
    if (kE < 4 && edge && k) finish(k - 1);
    const int s = static_cast<int>(k % a.stages);
    const int64_t round = k / a.stages;
    if (round) bar_wait(smem_addr(&empty[s]), (round - 1) & 1);
    int64_t x;
    int src, sx;
    const T* plane = plane_of<T, kValid>(a, x0 - 1 + k, x, src, sx);
    unsigned char* stage = smem + s * stage_bytes(kE);
    const uint32_t fb = smem_addr(&full[s]);
    if (!a.tma) {
      // the last of the box's row shares (the consumers copy the others)
      copy_box<T, kValid>(a, reinterpret_cast<T*>(stage), plane, yb, zb,
                          kConsumers, kConsumers + 1);
      track_copies(fb);
    } else if (lane == 0) {
      bar_expect(fb, kBoxBytes);
      // selects, not maps.m[src]: a runtime index into a parameter array
      // copies it to local memory, which TMA cannot read a map from
      const CUtensorMap* map =
          src == 0 ? &maps.m[0] : (src == 1 ? &maps.m[1] : &maps.m[2]);
      tma_load(smem_addr(stage), map, static_cast<int>(zb),
               static_cast<int>(yb), static_cast<int>(src ? 0 : x), fb);
    }
    if (!edge) {
      bar_arrive(fb);
      continue;
    }
    // the patch values of plane k: copied by cp.async (4- and 8-byte types),
    // or loaded now and stored at the next iteration (2-byte types, which
    // cp.async does not copy)
    T* side = reinterpret_cast<T*>(stage + kBoxBytes);
#pragma unroll
    for (int l = 0; l < kCells; ++l) {
      const T* from = nullptr;
      switch (kind[l]) {
        case kPlane: from = plane + off[l]; break;
        case kGyLo: case kGyHi:  // x off the block: a ghost edge, zero
          if (sx < 0)
            from = (kind[l] == kGyHi ? a.gy[1] : a.gy[0]) + x * a.mz + off[l];
          break;
        case kGzLo: case kGzHi:
          if (sx < 0)
            from = (kind[l] == kGzHi ? a.gz[1] : a.gz[0]) + x * a.my + off[l];
          break;
        default: break;
      }
      if constexpr (kE >= 4) {
        if (kind[l] != kNone)
          cp_bytes<kE>(smem_addr(side + lane + 32 * l), from ? from : a.u,
                       from != nullptr);
      } else {
        pv[l] = from ? *from : T(0.0f);
      }
    }
    if constexpr (kE >= 4) {
      track_copies(fb);
      bar_arrive(fb);
    }
  }
  if (kE < 4 && edge) finish(np - 1);
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// acc[q] += the taps of slice dxi (dx = dxi - 1) at output q of the
// thread's column, in the order dy, then dz ascending
template <bool kFace, int kDxi, typename A>
__device__ __forceinline__ void add_slice(A (&acc)[kPer],
                                          const A (&v)[3][kPer + 2],
                                          const Weights<A>& w,
                                          unsigned taps) {
#pragma unroll
  for (int dyi = 0; dyi < 3; ++dyi) {
#pragma unroll
    for (int dzi = 0; dzi < 3; ++dzi) {
      const int t = 9 * kDxi + 3 * dyi + dzi;
      if (kFace && !((kFaceTaps >> t) & 1u)) continue;
      if (taps & (1u << t)) {
        const A wt = w.w[t];
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          acc[q] = madd(wt, v[dzi][q + dyi], acc[q]);
      }
    }
  }
}

template <typename T, bool kValid, bool kFace>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 8 ? 2 : 4)
stencil27_kernel(const __grid_constant__ Maps maps, const Args<T> a,
                 const Weights<Acc<T>> w) {
  using A = Acc<T>;
  constexpr int kE = sizeof(T);
  constexpr int kP = pitch_of(kE);
  constexpr int kH = halo_of(kE);
  // the stage column of E's column z0 - 1: a box starts at source column
  // z0 - kH, which is E's z0 - kH (ghost-plane mode) or z0 - kH - 1 (valid
  // mode, whose source is the extended block)
  constexpr int kC0 = kValid ? kH : kH - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + a.stages * stage_bytes(kE));
  uint64_t* empty = full + a.stages;

  const int64_t z0 = static_cast<int64_t>(blockIdx.x) * kTZ;
  const int64_t y0 = static_cast<int64_t>(blockIdx.y) * kTY;
  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * a.xchunk;
  const int64_t x1 = x0 + a.xchunk < a.mx ? x0 + a.xchunk : a.mx;
  const int64_t np = x1 - x0 + 2;  // planes x0-1 .. x1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      // the producer lanes; in cp.async mode the consumers too
      bar_init(smem_addr(&full[s]), a.tma ? 32 : kThreads);
      bar_init(smem_addr(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist

  if (warp == kConsumers) {
    produce<T, kValid>(maps, a, smem, full, empty, x0, np, y0, z0);
    return;
  }

  // this thread's outputs: z column zl, rows yl .. yl + kPer - 1 of the tile
  const int zl = (warp % kZWarps) * 32 + lane;
  const int yl = (warp / kZWarps) * kPer;
  const int tid = threadIdx.x;  // 0 .. 32 * kConsumers - 1

  // Edge tiles of ghost-plane mode: where this thread copies each of its
  // patch cells from the stage's side slots to (per block, once)
  const bool edge = !kValid && edge_tile(a.my, a.mz, y0, z0);
  int pidx[kPatch];
#pragma unroll
  for (int l = 0; l < kPatch; ++l) {
    int r, c;
    pidx[l] = edge && patch_cell(tid + l * 32 * kConsumers, a.my, a.mz, y0,
                                 z0, r, c)
                  ? r * kP + c + kC0
                  : -1;
  }

  // sums of output planes p-1, p, p+1
  A s0[kPer], s1[kPer], s2[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) s0[q] = s1[q] = s2[q] = A(0);

  // cp.async mode: the consumers copy four of the five row shares of each
  // plane's box, S - 1 planes ahead of the one they compute on, into the
  // stage the plane S earlier has left; the stage's phase waits for them
  const int64_t zb = z0 - kH;
  const int64_t yb = kValid ? y0 : y0 - 1;
  auto refill = [&](int64_t k) {
    const int s = static_cast<int>(k % a.stages);
    int64_t x;
    int src, sx;
    const T* plane = plane_of<T, kValid>(a, x0 - 1 + k, x, src, sx);
    copy_box<T, kValid>(a, reinterpret_cast<T*>(smem + s * stage_bytes(kE)),
                        plane, yb, zb, warp, kConsumers + 1);
    const uint32_t fb = smem_addr(&full[s]);
    track_copies(fb);
    bar_arrive(fb);
  };
  if (!a.tma)
    for (int64_t k = 0; k < a.stages - 1 && k < np; ++k) refill(k);

  const int64_t zg = z0 + zl;
  for (int64_t k = 0; k < np; ++k) {
    const int s = static_cast<int>(k % a.stages);
    const int64_t p = x0 - 1 + k;
    bar_wait(smem_addr(&full[s]), (k / a.stages) & 1);
    T* st = reinterpret_cast<T*>(smem + s * stage_bytes(kE));
    if (edge) {
      const T* side = st + kRows * kP;
#pragma unroll
      for (int l = 0; l < kPatch; ++l)
        if (pidx[l] >= 0) st[pidx[l]] = side[tid + l * 32 * kConsumers];
      // the patched cells, before the next TMA overwrites them
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumers) : "memory");
    }
    // the neighbourhood: z columns zl-1 .. zl+1, rows yl .. yl+kPer+1
    A v[3][kPer + 2];
#pragma unroll
    for (int dzi = 0; dzi < 3; ++dzi) {
      if (kFace ? true : (a.taps & (0x1249249u << dzi)) != 0) {
#pragma unroll
        for (int j = 0; j < kPer + 2; ++j) {
          if (!kFace || dzi == 1 || (j >= 1 && j <= kPer))
            v[dzi][j] = to_acc(st[(yl + j) * kP + zl + dzi + kC0]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(smem_addr(&empty[s]));
    if (!a.tma && k + a.stages - 1 < np) {
      // plane k + S - 1 goes where plane k - 1 was: wait until every
      // consumer warp has read that one
      if (k) bar_wait(smem_addr(&empty[(k - 1) % a.stages]),
                      ((k - 1) / a.stages) & 1);
      refill(k + a.stages - 1);
    }
    // slice dx (dxi = dx + 1) goes to output plane p - dx
    add_slice<kFace, 0>(s2, v, w, a.taps);
    add_slice<kFace, 1>(s1, v, w, a.taps);
    add_slice<kFace, 2>(s0, v, w, a.taps);
    // output plane p-1 is complete
    if (k >= 2 && zg < a.mz) {
      T* o = a.out + ((p - 1) * a.my + y0 + yl) * a.mz + zg;
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (y0 + yl + q < a.my) o[q * a.mz] = from_acc<T>(s0[q]);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      s0[q] = s1[q];
      s1[q] = s2[q];
      s2[q] = A(0);
    }
  }
}

template <typename T, bool kValid, bool kFace>
cudaError_t launch_instance(dim3 grid, int64_t smem, cudaStream_t stream,
                            const Maps& maps, const Args<T>& a,
                            const Weights<Acc<T>>& w) {
  auto kernel = stencil27_kernel<T, kValid, kFace>;
  static bool sized = false;  // the opt-in above 48 KB, once per instance
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(maps, a, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, void* out, const void* const* ghosts,
                   int64_t mx, int64_t my, int64_t mz, unsigned wrap,
                   bool valid, const double* weights, int dtype, bool face,
                   bool tma, int64_t xchunk, int stages, const void* maps,
                   cudaStream_t stream) {
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
  a.xchunk = xchunk;
  a.wrap = wrap;
  a.stages = stages;
  a.tma = tma ? 1 : 0;
  a.taps = 0;
  Weights<Acc<T>> w;
  for (int t = 0; t < 27; ++t) {
    w.w[t] = static_cast<Acc<T>>(weights[t]);
    if (weights[t] != 0.0) a.taps |= 1u << t;
  }
  // the layout: the face instance holds face taps only; the shared memory
  // fits a block; TMA has its tensor maps
  const int64_t smem = smem_bytes(dtype, stages);
  if ((face && (a.taps & ~kFaceTaps)) || smem < 0 || smem > kMaxSmem ||
      xchunk < 1 || (tma && !maps))
    return cudaErrorInvalidValue;
  if (!valid) {
    // a dim that does not wrap reads its two ghost planes
    for (int d = 0; d < 3; ++d)
      if (!(wrap & (1u << d)) && (!ghosts[2 * d] || !ghosts[2 * d + 1]))
        return cudaErrorInvalidValue;
  }
  // cp.async mode: the widest copy (up to 16 bytes) that divides the rows
  // and the addresses of the block and its x ghost planes
  const int elem = elem_of(dtype);
  const int64_t nc = valid ? mz + 2 : mz;
  a.vec = 16 / elem;
  for (; a.vec > 1; a.vec /= 2) {
    const uintptr_t bytes = static_cast<uintptr_t>(a.vec) * elem;
    if (nc % a.vec == 0 && reinterpret_cast<uintptr_t>(u) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(ghosts[0]) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(ghosts[1]) % bytes == 0)
      break;
  }
  Maps m;
  if (tma) std::memcpy(&m, maps, sizeof(m));
  else std::memset(&m, 0, sizeof(m));
  const int64_t gz = (mz + kTZ - 1) / kTZ;
  const int64_t gy = (my + kTY - 1) / kTY;
  const int64_t gx = (mx + xchunk - 1) / xchunk;
  if (gz > 2147483647LL || gy > 65535 || gx > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gx));
  if (valid)
    return face ? launch_instance<T, true, true>(grid, smem, stream, m, a, w)
                : launch_instance<T, true, false>(grid, smem, stream, m, a, w);
  return face ? launch_instance<T, false, true>(grid, smem, stream, m, a, w)
              : launch_instance<T, false, false>(grid, smem, stream, m, a, w);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

}  // namespace

// Shared-memory bytes of one block of the layout with `stages` stages for
// dtype (0 float, 1 double, 2 bfloat16, 3 half); -1 for a layout the entry
// refuses.  ops/stencil_kernel.smem_bytes must agree (a gpu test holds it).
extern "C" int64_t cudecomp_stencil27_smem_bytes(int dtype, int stages) {
  return smem_bytes(dtype, stages);
}

// Writes to `map` (128 bytes) the TMA tensor map of a (d2, d1, d0) block
// of dtype at `ptr` (d0 the contiguous dim), whose box is one plane of a
// stage: a stage row (the tile and 16 bytes on each side) by the tile's rows
// and its ring.  Returns 0, or the driver's error (1 when the
// entry point cannot be found, e.g. an address or stride not a multiple
// of 16 bytes gives CUDA_ERROR_INVALID_VALUE).
extern "C" int cudecomp_stencil27_encode_map(void* map, const void* ptr,
                                             int64_t d0, int64_t d1,
                                             int64_t d2, int dtype) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || !fn)
      return 1;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const int elem = elem_of(dtype);
  if (!elem) return static_cast<int>(CUDA_ERROR_INVALID_VALUE);
  const CUtensorMapDataType types[4] = {
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_DATA_TYPE_FLOAT16};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * elem),
                                 static_cast<cuuint64_t>(d0 * d1 * elem)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(pitch_of(elem)),
                             static_cast<cuuint32_t>(kRows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return static_cast<int>(encode(
      static_cast<CUtensorMap*>(map), types[dtype], 3, const_cast<void*>(ptr),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// out (mx, my, mz) <- the stencil of u.  valid != 0: u is the extended
// (mx+2, my+2, mz+2) block and the ghost pointers are unused.  Otherwise u
// is (mx, my, mz), bit d of `wrap` makes memory dim d wrap, and the ghost
// planes (x below, x above, y below, y above, z below, z above) of each dim
// that does not wrap must be given.  weights: 27 doubles in tap order,
// rounded to the accumulation type.  dtype: 0 float, 1 double, 2 bfloat16,
// 3 half.  The layout: face != 0 takes the face instance (face taps only),
// tma != 0 loads by TMA with `maps` (three 128-byte tensor maps: the block,
// the x ghost planes below and above, from cudecomp_stencil27_encode_map),
// else by cp.async; x-chunks of `xchunk` planes; `stages` stages.
extern "C" int cudecomp_stencil27(const void* u, void* out, const void* gxlo,
                                  const void* gxhi, const void* gylo,
                                  const void* gyhi, const void* gzlo,
                                  const void* gzhi, int64_t mx, int64_t my,
                                  int64_t mz, int wrap, int valid,
                                  const double* weights, int dtype, int face,
                                  int tma, int64_t xchunk, int stages,
                                  const void* maps, void* stream) {
  if (mx <= 0 || my <= 0 || mz <= 0) return cudaSuccess;
  const void* ghosts[6] = {gxlo, gxhi, gylo, gyhi, gzlo, gzhi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned wr = static_cast<unsigned>(wrap) & 7u;
  switch (dtype) {
    case kF32:
      return launch<float>(u, out, ghosts, mx, my, mz, wr, valid != 0,
                           weights, dtype, face, tma, xchunk, stages, maps, s);
    case kF64:
      return launch<double>(u, out, ghosts, mx, my, mz, wr, valid != 0,
                            weights, dtype, face, tma, xchunk, stages, maps,
                            s);
    case kBF16:
      return launch<__nv_bfloat16>(u, out, ghosts, mx, my, mz, wr, valid != 0,
                                   weights, dtype, face, tma, xchunk, stages,
                                   maps, s);
    case kF16:
      return launch<__half>(u, out, ghosts, mx, my, mz, wr, valid != 0,
                            weights, dtype, face, tma, xchunk, stages, maps,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}
