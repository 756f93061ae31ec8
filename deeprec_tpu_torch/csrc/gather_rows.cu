// Embedding row gather with the lookup's default-row select, for Hopper.
//
// Replaces the Pallas TPU kernel `gather_rows` in
// deeprec_tpu/ops/pallas/gather.py (one DMA per row, 1024 rows a tile,
// compiled only for D % 128 == 0). This kernel takes any D >= 1.
//
//   out[i] = values[clamp(slots[i], 0, C)]                 (no select)
//   out[i] = admitted[i] ? values[clamp(slots[i], 0, C)]
//                        : bank[clamp(sel[i], 0, B-1)]     (select)
//
// values is [C+1, D] (row C is the table's sentinel row), bank [B, D],
// out [n, D], all row-major and contiguous. sel may be null: every
// unadmitted row then reads bank row 0.
//
// What bounds it: bytes. A call moves about n*D*esize*2 bytes (each row
// read once from the table, written once to out) and does no
// arithmetic, so the card's memory rate is the limit, and reaching it
// takes many loads in flight. The rows are scattered and awkward: at
// the reference widths (D = 65, 129 float32) a source row starts only
// 4-byte aligned and is one element longer than a multiple of 32.
//
// Design: a warp owns a tile of kRows (16) consecutive output rows.
//   1. Headers: lane i < kRows loads the slot, admitted flag and select
//      index of row base+i in one coalesced read and puts the row's
//      source pointer in shared memory. No per-row load-then-shuffle
//      chain stands before the row loads.
//   2. Loads: the tile's kRows*D output elements are one flat range, cut
//      into equal pieces of at most kPieceBytes, so no lane idles at the
//      end of a 65- or 129-wide row. Consecutive lanes take consecutive
//      elements (coalesced within a source row); row and column of an
//      element are stepped, not divided. Each float32 element is copied
//      into a shared-memory stage by a 4-byte cp.async, so loads hold no
//      registers; bfloat16 rows start on 2-byte boundaries, below
//      cp.async's 4-byte minimum, and are read with plain loads into the
//      same stage. A warp keeps a ring of kStages (3) stages: while one
//      piece is stored, the next two are in flight.
//   3. Stores: the tile is contiguous in out and starts on a 16-byte
//      boundary (kRows*esize is a multiple of 16, out is 16-byte
//      aligned), so the stage is written back with 16-byte stores, whole
//      128-byte lines per 8 lanes; a ragged end is stored element-wise.
//   Rows are read exactly, never as wider aligned spans, so nothing past
//   a row (or the table's end) is touched. Tile, stage count and piece
//   size were chosen on an H100 against tiles of 8 and 32 rows and rings
//   of 2 and 4 stages (PERF.md). Offsets into values and bank are int64:
//   (C+1)*D exceeds 2^31 elements at reference table sizes.
//
// The gather is a copy, so it is templated on the element width only
// (4 bytes: float32; 2 bytes: bfloat16).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRows = 16;          // rows per warp tile; kRows*esize % 16 == 0
constexpr int kStages = 3;         // pieces of a tile in flight per warp
constexpr int kPieceBytes = 1536;  // one stage of a warp's ring
constexpr int kMaxD = (1 << 30) / kRows;  // kRows*D stays an int

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's committed groups are
// still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src);

template <>
__device__ __forceinline__ void copy_elem<uint32_t>(uint32_t* dst,
                                                    const uint32_t* src) {
  cp_async4(dst, src);
}

template <>
__device__ __forceinline__ void copy_elem<uint16_t>(uint16_t* dst,
                                                    const uint16_t* src) {
  *dst = __ldg(src);
}

// Starts the copy of tile elements [start, start+len) into stage[0, len).
// src holds the tile's row pointers (into values or the bank); each lane
// steps by 32 elements.
template <typename T>
__device__ __forceinline__ void load_piece(T* stage, const T* const* src,
                                            int start, int len, int D,
                                            int step_r, int step_c, int lane) {
  const int e = start + lane;
  int r = e / D;
  int c = e - r * D;
  for (int i = lane; i < len; i += 32) {
    copy_elem<T>(stage + i, src[r] + c);
    c += step_c;
    r += step_r;
    if (c >= D) {
      c -= D;
      ++r;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_piece(T* dst, const T* stage, int len,
                                            bool vec, int lane) {
  constexpr int kVec = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int nv = len / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(stage);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int v = lane; v < nv; v += 32) d4[v] = s4[v];
    done = nv * kVec;
  }
  for (int i = done + lane; i < len; i += 32) dst[i] = stage[i];
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    gather_rows_kernel(const T* __restrict__ values, int64_t C, int D,
                       const int32_t* __restrict__ slots, int64_t n,
                       const bool* __restrict__ admitted,
                       const T* __restrict__ bank,
                       const int32_t* __restrict__ sel, int64_t bank_rows,
                       T* __restrict__ out, int64_t num_tiles, bool vec) {
  constexpr int kPiece = kPieceBytes / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(16) T stage[kWarpsPerBlock][kStages][kPiece];
  __shared__ const T* src[kWarpsPerBlock][kRows];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int step_r = 32 / D;
  const int step_c = 32 % D;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (tile >= num_tiles) return;  // uniform across the warp
  const int64_t base = tile * kRows;
  const int rows = static_cast<int>(n - base < kRows ? n - base : kRows);
  if (lane < rows) {
    const int64_t row = base + lane;
    const T* p;
    if (admitted != nullptr && !admitted[row]) {
      int64_t b = sel != nullptr ? static_cast<int64_t>(sel[row]) : 0;
      b = b < 0 ? 0 : (b >= bank_rows ? bank_rows - 1 : b);
      p = bank + b * D;
    } else {
      int64_t s = static_cast<int64_t>(slots[row]);
      s = s < 0 ? 0 : (s > C ? C : s);
      p = values + s * D;
    }
    src[warp][lane] = p;
  }
  __syncwarp();
  // Split the tile into equal pieces of whole 16-byte chunks, so no
  // piece is a short straggler.
  const int len = rows * D;
  const int parts = (len + kPiece - 1) / kPiece;
  int piece = (len + parts - 1) / parts;
  piece = (piece + kVec - 1) / kVec * kVec;
  const int npieces = (len + piece - 1) / piece;
  T* dst = out + base * D;
  // A ring of kStages pieces: piece p+kStages-1 is started before piece
  // p is stored. Every step commits a group, empty or not, so waiting
  // for all but the newest kStages-1 groups waits for piece p.
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < npieces) {
      const int start = p * piece;
      load_piece<T>(stage[warp][p], src[warp], start,
                     len - start < piece ? len - start : piece, D, step_r,
                     step_c, lane);
    }
    cp_async_commit();
  }
  for (int p = 0; p < npieces; ++p) {
    const int ahead = p + kStages - 1;
    if (ahead < npieces) {
      const int start = ahead * piece;
      load_piece<T>(stage[warp][ahead % kStages], src[warp], start,
                     len - start < piece ? len - start : piece, D, step_r,
                     step_c, lane);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int start = p * piece;
    store_piece<T>(dst + start, stage[warp][p % kStages],
                   len - start < piece ? len - start : piece, vec, lane);
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* values, int64_t C1, int64_t D,
                   const int32_t* slots, int64_t n, const bool* admitted,
                   const void* bank, const int32_t* sel, int64_t bank_rows,
                   void* out, cudaStream_t stream) {
  const int64_t tiles = (n + kRows - 1) / kRows;
  const int64_t blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gather_rows_kernel<T><<<static_cast<unsigned int>(blocks),
                          kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(values), C1 - 1, static_cast<int>(D), slots, n,
      admitted, static_cast<const T*>(bank), sel, bank_rows,
      static_cast<T*>(out), tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. esize is the element size in bytes (4 or
// 2). admitted, bank and sel are null for a plain gather; admitted and
// bank are given together; D is at most kMaxD (2^26). Returns the
// cudaError_t of the launch.
extern "C" int deeprec_gather_rows(const void* values, int64_t C1, int64_t D,
                                   const void* slots, int64_t n,
                                   const void* admitted, const void* bank,
                                   const void* sel, int64_t bank_rows,
                                   void* out, int64_t esize, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (C1 < 1 || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((admitted == nullptr) != (bank == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bank != nullptr && bank_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int64_t kRowsPerBlock = kRows * kWarpsPerBlock;
  if ((n + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto s = static_cast<cudaStream_t>(stream);
  auto sl = static_cast<const int32_t*>(slots);
  auto ad = static_cast<const bool*>(admitted);
  auto se = static_cast<const int32_t*>(sel);
  cudaError_t err;
  if (esize == 4) {
    err = launch<uint32_t>(values, C1, D, sl, n, ad, bank, se, bank_rows, out, s);
  } else if (esize == 2) {
    err = launch<uint16_t>(values, C1, D, sl, n, ad, bank, se, bank_rows, out, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
