// The embedding combine of one physical table and its gradient, for
// Hopper: a gather-combine forward and a deterministic, load-balanced
// segmented-sum backward.
//
// Replaces no TPU kernel: the JAX package leaves the gather
// `rows[inverse] * mask` and its bag reduce to XLA, and its gradient is
// XLA's scatter-add from autodiff of the gather. On this card autograd
// ran the same expressions as a sorted scatter in which one warp walks
// each row's whole run of duplicates (`indexing_backward_kernel`), and
// each column's slice of the table's stacked occurrences took a
// zero-filled gradient of the whole stack, summed across the columns.
//
// A table's occurrences o = b * L + j (batch row b, position j of the
// table's L concatenated column positions) index its rows [U + 1, dim]
// through inverse[o] and are real where mask[o]. Column c owns the
// positions [off_c, off_c + width_c). A bag column reduces them to one
// output row a batch row (sum, mean, sqrtn; optional weights); a
// sequence column has one output row a position.
//
//   forward:  bag  out_c[b]    = sum_j rows[inv[b, off+j]] * w_j / den
//             seq  out_c[b, j] = rows[inv[b, off+j]] * mask[b, off+j]
//             with w_j = mask * weight (1 unweighted); den = 1 (sum),
//             max(sum w_j, f) (mean), max(sqrt(sum w_j^2), f) (sqrtn),
//             f = 1 unweighted, 1e-9 weighted; and scale[o] = w_j / den
//             (sum: w_j; seq: mask) for the backward.
//   backward: grad[u] = sum over real o with inv[o] = u of
//             scale[o] * gout_c(o)[slot(o)], every row u in [0, U].
//
// What bounds it: bytes. The forward reads each occurrence's row and
// writes each output row once; the backward reads each occurrence's
// output gradient once and writes each row's gradient once, plus a few
// bytes of indices an occurrence. Both do one multiply-add an element.
//
// Forward design: a warp an output row at a time, the grid's warps
// striding over the rows (kBlocksPerSm blocks an SM, so the column table
// is copied to shared memory once a block). The lanes hold the bag's
// indices and weights (32 at a time) and sweep the row in tiles of 256
// elements, 8 a lane (16-byte loads and stores where dim % 4 == 0 and
// every pointer and stride allows; element loads otherwise, which the
// 65- and 129-wide rows need).
//
// Backward design, in four steps:
//   1. CSR order: the forward writes each occurrence's key, its row
//      inv[o] or U + 1 where it is padding (which sorts last and is
//      skipped); the caller sorts the keys with a stable sort
//      (torch.sort, stable=True) and hands over the sorted keys and
//      their occurrences. Each row's segment then holds its occurrences
//      in occurrence order: fixed by the inputs, never by the timing of
//      atomics.
//   2. Short segments: the sorted order is cut into chunks of kChunk
//      (32) positions, a warp a chunk. The warp takes each segment that
//      starts in its chunk and holds at most kChunk occurrences (so it
//      may run into the next chunk), sums scale[o] * gout over it in
//      order, reading each column's gradient in place (a column without
//      one adds nothing), and writes the row. No warp sums more than
//      2 * kChunk rows.
//   3. Long segments (more than kChunk occurrences: the hot rows, the
//      "split" rows a trace counts): a block a (segment, 32-element
//      slice of the row). Five producer warps stream the segment's
//      gradient rows through shared memory with cp.async, 160 a tile,
//      double buffered and fetched in three stages a tile apart (sorted
//      position, gradient row, the copy), while one warp keeps a
//      running sum an element. A hot
//      row's work is spread over its slices and over the card's SMs,
//      and its sum keeps the order of a plain scatter-add.
//   4. Rows that no real occurrence reads are written as zeros (a flag
//      a row, set by step 2, cleared with a memset first), so the
//      gradient needs no zero fill of its own.
// Every element of a row's gradient is one running float32 sum over its
// occurrences in occurrence order, from zero: the order autograd's
// sorted scatter-add (`indexing_backward_kernel`) sums in, so where the
// scales are 1 (sum, and mean over bags of one) the bits are its bits.
// A launch gives the same bits on the same inputs, eagerly or replayed
// in a CUDA graph. Nothing allocates or synchronizes: the scratch is one
// buffer the caller sizes with deeprec_occ_backward_scratch_bytes.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;      // columns of one launch (kernel parameter space)
constexpr int kWarps = 8;         // warps a block of the row kernels
constexpr int kPerLane = 8;       // elements of a row a lane holds per tile
constexpr int kTileK = 32 * kPerLane;
constexpr int kChunk = 32;        // sorted positions a warp of the segmented sum
constexpr int kLongProducers = 5;  // producer warps of a long-segment block
constexpr int kLongThreads = 32 * (kLongProducers + 1);
constexpr int kLongTile = 32 * kLongProducers;  // rows a tile of a long segment
constexpr int kBlocksPerSm = 4;   // grid of the long-segment and forward kernels
constexpr unsigned kFull = 0xffffffffu;

enum : int32_t { kBag = 0, kSeq = 1 };
enum : int32_t { kSum = 0, kMean = 1, kSqrtn = 2 };

struct Col {
  float* data;            // forward: the output; backward: its gradient (may be null)
  const float* weights;   // [B, width] float32, or null
  int64_t s0;             // elements between batch rows of data
  int64_t s1;             // elements between positions of a sequence column
  int32_t off;            // first position of the column in [0, L)
  int32_t width;
  int32_t item0;          // first output row of the column within a batch row
  int32_t kind;
  int32_t combiner;
  int32_t pad;
};

struct Cols {
  Col c[kMaxCols];
  int32_t n;
  int32_t items;          // output rows a batch row: 1 a bag, width a sequence
};

__device__ __forceinline__ int64_t clamp_row(int64_t u, int64_t U) {
  return u < 0 ? 0 : (u > U ? U : u);
}

// The last column whose `item0` (by_item) or `off` is at most v.
__device__ __forceinline__ int find_col(const Col* cols, int n, int v,
                                        bool by_item) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    const int at = by_item ? cols[mid].item0 : cols[mid].off;
    if (at <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// acc += s * row[tile], the tile starting at element k0.
template <bool kVec>
__device__ __forceinline__ void axpy_tile(float (&acc)[kPerLane],
                                          const float* __restrict__ row,
                                          float s, int k0, int dim, int lane) {
  if (kVec) {
#pragma unroll
    for (int v = 0; v < kPerLane / 4; ++v) {
      const int k = k0 + (v * 32 + lane) * 4;
      if (k < dim) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + k));
        acc[4 * v] = fmaf(s, x.x, acc[4 * v]);
        acc[4 * v + 1] = fmaf(s, x.y, acc[4 * v + 1]);
        acc[4 * v + 2] = fmaf(s, x.z, acc[4 * v + 2]);
        acc[4 * v + 3] = fmaf(s, x.w, acc[4 * v + 3]);
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) {
      const int k = k0 + v * 32 + lane;
      if (k < dim) acc[v] = fmaf(s, __ldg(row + k), acc[v]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float (&acc)[kPerLane],
                                           int k0, int dim, int lane) {
  if (kVec) {
#pragma unroll
    for (int v = 0; v < kPerLane / 4; ++v) {
      const int k = k0 + (v * 32 + lane) * 4;
      if (k < dim)
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                        acc[4 * v + 3]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) {
      const int k = k0 + v * 32 + lane;
      if (k < dim) dst[k] = acc[v];
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kPerLane]) {
#pragma unroll
  for (int v = 0; v < kPerLane; ++v) acc[v] = 0.f;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- forward

// The backward's sort key of occurrence o: its row, or U + 1 where it is
// padding.
__device__ __forceinline__ int32_t sort_key(const int64_t* __restrict__ inv,
                                            const bool* __restrict__ msk,
                                            int64_t U, int64_t o) {
  return static_cast<int32_t>(msk[o] ? clamp_row(inv[o], U) : U + 1);
}

// One output row of occ_combine_fwd_kernel that is a bag of another
// width than 1: item = b * items + r.
template <bool kVec>
__device__ __forceinline__ void fwd_item(const float* __restrict__ rows,
                                         int64_t U, int dim,
                                         const int64_t* __restrict__ inv,
                                         const bool* __restrict__ msk, int L,
                                         const Cols& cols, const Col* sc,
                                         float* __restrict__ scale,
                                         int32_t* __restrict__ keys,
                                         int64_t item) {
  const int lane = threadIdx.x & 31;
  const int64_t b = item / cols.items;
  const int r = static_cast<int>(item - b * cols.items);
  const Col& c = sc[find_col(sc, cols.n, r, true)];
  const int64_t o0 = b * L + c.off;  // the column's first occurrence in row b
  float acc[kPerLane];
  const float* wts = c.weights != nullptr ? c.weights + b * c.width : nullptr;
  // The bag's denominator: a fixed-order warp sum.
  float den = 0.f;
  for (int j = lane; j < c.width; j += 32) {
    const float w = msk[o0 + j] ? (wts != nullptr ? wts[j] : 1.f) : 0.f;
    den += c.combiner == kSqrtn ? w * w : w;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) den += __shfl_xor_sync(kFull, den, d);
  const float least = wts != nullptr ? 1e-9f : 1.f;
  float dv = 1.f;
  if (c.combiner == kMean) dv = fmaxf(den, least);
  else if (c.combiner == kSqrtn) dv = fmaxf(sqrtf(den), least);
  for (int j = lane; j < c.width; j += 32) {
    const float w = msk[o0 + j] ? (wts != nullptr ? wts[j] : 1.f) : 0.f;
    scale[o0 + j] = c.combiner == kSum ? w : w / dv;
    keys[o0 + j] = sort_key(inv, msk, U, o0 + j);
  }
  float* dst = c.data + b * c.s0;
  for (int k0 = 0; k0 < dim; k0 += kTileK) {
    zero(acc);
    for (int g = 0; g < c.width; g += 32) {
      float wj = 0.f;
      int64_t uj = 0;
      if (g + lane < c.width) {
        const int64_t o = o0 + g + lane;
        wj = msk[o] ? (wts != nullptr ? wts[g + lane] : 1.f) : 0.f;
        uj = clamp_row(inv[o], U);
      }
      const int cnt = c.width - g < 32 ? c.width - g : 32;
      for (int t = 0; t < cnt; ++t) {
        const float w = __shfl_sync(kFull, wj, t);
        const long long u = __shfl_sync(kFull, static_cast<long long>(uj), t);
        if (w != 0.f) axpy_tile<kVec>(acc, rows + u * dim, w, k0, dim, lane);
      }
    }
    if (c.combiner != kSum) {
#pragma unroll
      for (int v = 0; v < kPerLane; ++v) acc[v] = acc[v] / dv;
    }
    store_tile<kVec>(dst, acc, k0, dim, lane);
  }
}

// The one-occurrence rows of a warp's 32 (src null: not one), as one
// flat range of cnt * dim elements (kV a load), 8 loads a lane in
// flight: out = fma(w, x, 0), divided by dv where dv is not 0 — the
// arithmetic fwd_item does for such a row.
template <int kV>
__device__ __forceinline__ void fwd_flat(const float* const* src,
                                         float* const* dst, const float* w,
                                         const float* dv, int cnt, int dim,
                                         int lane) {
  using V = typename std::conditional<kV == 4, float4, float>::type;
  const int per = dim / kV;  // loads a row
  const int total = cnt * per;
  const int step_r = 32 / per, step_c = 32 % per;
  for (int e0 = 0; e0 < total; e0 += 32 * 8) {
    int r = (e0 + lane) / per;
    int c = e0 + lane - r * per;
    V x[8];
    int rr[8], cc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rr[i] = r;
      cc[i] = c;
      const bool in = e0 + i * 32 + lane < total;
      const float* sp = in ? src[r] : nullptr;
      if (sp != nullptr && w[r] != 0.f)
        x[i] = __ldg(reinterpret_cast<const V*>(sp) + c);
      else
        x[i] = V{};
      r += step_r;
      c += step_c;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (e0 + i * 32 + lane >= total) break;
      float* dp = dst[rr[i]];
      if (dp == nullptr) continue;
      const float wi = w[rr[i]], di = dv[rr[i]];
      float* xv = reinterpret_cast<float*>(&x[i]);
      V out;
      float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int q = 0; q < kV; ++q) {
        float v = wi != 0.f ? fmaf(wi, xv[q], 0.f) : 0.f;
        if (di != 0.f) v = v / di;
        ov[q] = v;
      }
      reinterpret_cast<V*>(dp)[cc[i]] = out;
    }
  }
}

// A warp takes 32 output rows at a time: the lanes read each row's one
// occurrence (a sequence position, or a bag of width 1) side by side,
// write its scale and sort key and put the row's source, destination,
// weight and divisor in shared memory; the warp then copies those rows
// as one flat range (fwd_flat). A bag of another width goes through
// fwd_item. Both give the same bits for a row.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    occ_combine_fwd_kernel(const float* __restrict__ rows, int64_t U, int dim,
                           const int64_t* __restrict__ inv,
                           const bool* __restrict__ msk, int64_t B, int L,
                           const Cols cols, float* __restrict__ scale,
                           int32_t* __restrict__ keys) {
  __shared__ Col sc[kMaxCols];
  __shared__ const float* m_src[kWarps][32];
  __shared__ float* m_dst[kWarps][32];
  __shared__ float m_w[kWarps][32], m_dv[kWarps][32];
  for (int i = threadIdx.x; i < cols.n; i += blockDim.x) sc[i] = cols.c[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, wp = threadIdx.x / 32;
  const int64_t items = B * cols.items;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * 32;
  for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kWarps + wp) * 32;
       i0 < items; i0 += step) {
    const int64_t item = i0 + lane;
    const float* src = nullptr;
    float* dst = nullptr;
    float w = 0.f, dv = 0.f;
    bool single = false;
    if (item < items) {
      const int64_t b = item / cols.items;
      const int r = static_cast<int>(item - b * cols.items);
      const Col& c = sc[find_col(sc, cols.n, r, true)];
      if (c.kind == kSeq || c.width == 1) {
        single = true;
        const int j = c.kind == kSeq ? r - c.item0 : 0;
        const int64_t o = b * L + c.off + j;
        const bool m = msk[o];
        src = rows + clamp_row(inv[o], U) * dim;
        keys[o] = sort_key(inv, msk, U, o);
        if (c.kind == kSeq) {
          w = m ? 1.f : 0.f;
          dst = c.data + b * c.s0 + static_cast<int64_t>(j) * c.s1;
          scale[o] = w;
        } else {
          w = m ? (c.weights != nullptr ? c.weights[b] : 1.f) : 0.f;
          dst = c.data + b * c.s0;
          const float least = c.weights != nullptr ? 1e-9f : 1.f;
          if (c.combiner == kMean) dv = fmaxf(w, least);
          else if (c.combiner == kSqrtn) dv = fmaxf(sqrtf(w * w), least);
          scale[o] = dv != 0.f ? w / dv : w;
        }
      }
    }
    m_src[wp][lane] = src;
    m_dst[wp][lane] = dst;
    m_w[wp][lane] = w;
    m_dv[wp][lane] = dv;
    __syncwarp();
    const unsigned singles = __ballot_sync(kFull, single);
    const int cnt = static_cast<int>(items - i0 < 32 ? items - i0 : 32);
    if (singles != 0u) {
      if (kVec)
        fwd_flat<4>(m_src[wp], m_dst[wp], m_w[wp], m_dv[wp], cnt, dim, lane);
      else
        fwd_flat<1>(m_src[wp], m_dst[wp], m_w[wp], m_dv[wp], cnt, dim, lane);
    }
    for (int t = 0; t < cnt; ++t)
      if (!((singles >> t) & 1u))
        fwd_item<kVec>(rows, U, dim, inv, msk, L, cols, sc, scale, keys,
                       i0 + t);
    __syncwarp();
  }
}

// ------------------------------------------------- backward: segmented sum

// Sorted position pos: its key, and the gradient row and scale of its
// occurrence (src null: padding, or a column without a gradient).
__device__ __forceinline__ void position(const int32_t* __restrict__ sk,
                                         const int64_t* __restrict__ so,
                                         const float* __restrict__ scale,
                                         int64_t n, int64_t U, int L,
                                         const Col* sc, int ncols, int64_t pos,
                                         int32_t& key, const float*& src,
                                         float& s) {
  key = -1;
  src = nullptr;
  s = 0.f;
  if (pos >= n) return;
  key = sk[pos];
  const int64_t o = so[pos];
  if (key > U) return;
  const int64_t b = o / L;
  const int j = static_cast<int>(o - b * L);
  const Col& c = sc[find_col(sc, ncols, j, false)];
  if (c.data == nullptr) return;
  s = scale[o];
  src = c.data + b * c.s0 +
        (c.kind == kSeq ? static_cast<int64_t>(j - c.off) * c.s1 : 0);
}

// A warp a chunk of kChunk sorted positions: every segment that starts
// in the chunk and holds at most kChunk occurrences, summed in order and
// written to its row; a longer one is listed for occ_long_kernel.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    occ_segsum_kernel(const int32_t* __restrict__ sk,
                      const int64_t* __restrict__ so,
                      const float* __restrict__ scale, int64_t n, int64_t U,
                      int L, int dim, const Cols cols,
                      float* __restrict__ grad, uint8_t* __restrict__ present,
                      int32_t* __restrict__ long_starts,
                      int32_t* __restrict__ long_count, int64_t chunks) {
  __shared__ Col sc[kMaxCols];
  for (int i = threadIdx.x; i < cols.n; i += blockDim.x) sc[i] = cols.c[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t ch =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (ch >= chunks) return;  // uniform across the warp
  const int64_t start = ch * kChunk;
  const int cnt = static_cast<int>(n - start < kChunk ? n - start : kChunk);
  // Lane p holds position start + p (window A) and, once a segment runs
  // past the chunk, start + 32 + p (window B).
  int32_t ka, kb = -1;
  const float *pa, *pb = nullptr;
  float xa, xb = 0.f;
  position(sk, so, scale, n, U, L, sc, cols.n, start + lane, ka, pa, xa);
  const int32_t prev = start > 0 ? sk[start - 1] : -1;
  const int32_t up = __shfl_up_sync(kFull, ka, 1);
  unsigned starts =
      __ballot_sync(kFull, lane < cnt && ka != (lane == 0 ? prev : up));
  bool have_b = false;
  float acc[kPerLane];
  while (starts != 0u) {
    const int p0 = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int32_t u = __shfl_sync(kFull, ka, p0);
    if (u > U) break;  // padding sorts last
    if (lane == 0) present[u] = 1;
    int end;  // past the segment's last position, from start
    if (starts != 0u) {
      end = __ffs(starts) - 1;
    } else if (cnt < kChunk) {
      end = cnt;
    } else {
      if (!have_b) {
        position(sk, so, scale, n, U, L, sc, cols.n, start + 32 + lane, kb,
                 pb, xb);
        have_b = true;
      }
      const unsigned other = __ballot_sync(kFull, kb != u);
      end = other != 0u ? 32 + __ffs(other) - 1 : 64;
    }
    if (end - p0 > kChunk) {
      if (lane == 0) long_starts[atomicAdd(long_count, 1)] =
          static_cast<int32_t>(start + p0);
      continue;
    }
    for (int k0 = 0; k0 < dim; k0 += kTileK) {
      zero(acc);
      for (int p = p0; p < end; ++p) {
        const bool in_a = p < 32;
        const float sp = __shfl_sync(kFull, in_a ? xa : xb, p & 31);
        const float* row = reinterpret_cast<const float*>(__shfl_sync(
            kFull, reinterpret_cast<unsigned long long>(in_a ? pa : pb),
            p & 31));
        if (row != nullptr) axpy_tile<kVec>(acc, row, sp, k0, dim, lane);
      }
      store_tile<kVec>(grad + static_cast<int64_t>(u) * dim, acc, k0, dim,
                       lane);
    }
  }
}

// The producers of occ_long_kernel fetch a tile in three stages, one
// load deep each, a tile apart, so a tile's wait is one load, not three:
// A, a row's sorted position (key and occurrence); B, the occurrence's
// gradient row and scale; C, the row's 32-element slice into shared
// memory. Lane l of producer warp w holds tile row (w - 1) * 32 + l.
struct LongA {
  int32_t key, o;
};

struct LongB {
  const float* src;  // null: past the segment, or a column without one
  float s;
  bool in;           // still the segment's row
};

__device__ __forceinline__ LongA long_a(const int32_t* __restrict__ sk,
                                        const int64_t* __restrict__ so,
                                        int64_t n, int64_t pos) {
  LongA a{-1, 0};
  if (pos < n) {
    a.key = sk[pos];
    a.o = static_cast<int32_t>(so[pos]);
  }
  return a;
}

__device__ __forceinline__ LongB long_b(LongA a, int32_t u,
                                        const float* __restrict__ scale, int L,
                                        const Col* sc, int ncols) {
  LongB b{nullptr, 0.f, a.key == u};
  if (!b.in) return b;
  const int64_t row = a.o / L;
  const int j = static_cast<int>(a.o - row * L);
  const Col& c = sc[find_col(sc, ncols, j, false)];
  if (c.data == nullptr) return b;
  b.s = scale[a.o];
  b.src = c.data + row * c.s0 +
          (c.kind == kSeq ? static_cast<int64_t>(j - c.off) * c.s1 : 0);
  return b;
}

// Stage C: the 32 rows of this warp as 4-byte asynchronous copies
// (cp.async holds no register, so all are in flight at once), committed
// as one group the caller waits for before the block's barrier.
__device__ __forceinline__ void long_c(LongB b, int r, int k0, int dim,
                                       int lane, float (*stage)[32],
                                       float* sst, int* first_invalid,
                                       int base) {
  if (!b.in) atomicMin(first_invalid, r);
  sst[r] = b.s;
  const bool in = k0 + lane < dim;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float* row = reinterpret_cast<const float*>(__shfl_sync(
        kFull, reinterpret_cast<unsigned long long>(b.src), j));
    if (row != nullptr && in)
      cp_async4(&stage[base + j][lane], row + k0 + lane);
    else
      stage[base + j][lane] = 0.f;
  }
  cp_async_commit();
}

// A block a (long segment, 32-element slice of the row): producer warps
// stream the segment's gradient rows through shared memory, a tile of
// kLongTile rows double buffered, while warp 0 sums them in order, one
// running sum an element.
__global__ void __launch_bounds__(kLongThreads)
    occ_long_kernel(const int32_t* __restrict__ sk,
                    const int64_t* __restrict__ so,
                    const float* __restrict__ scale, int64_t n, int64_t U,
                    int L, int dim, const Cols cols, float* __restrict__ grad,
                    const int32_t* __restrict__ long_starts,
                    const int32_t* __restrict__ long_count) {
  __shared__ Col sc[kMaxCols];
  __shared__ float stage[2][kLongTile][32];
  __shared__ float sst[2][kLongTile];
  __shared__ int first_invalid[4];
  for (int i = threadIdx.x; i < cols.n; i += blockDim.x) sc[i] = cols.c[i];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int r = (w - 1) * 32 + lane;  // a producer's tile row
  const int slices = (dim + 31) / 32;
  const int64_t items = static_cast<int64_t>(*long_count) * slices;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t start = long_starts[item / slices];
    const int k0 = static_cast<int>(item % slices) * 32;
    const int32_t u = sk[start];
    if (threadIdx.x < 4) first_invalid[threadIdx.x] = kLongTile;
    __syncthreads();
    LongA a;
    LongB b;
    if (w >= 1) {
      b = long_b(long_a(sk, so, n, start + r), u, scale, L, sc, cols.n);
      LongA a1 = long_a(sk, so, n, start + kLongTile + r);
      a = long_a(sk, so, n, start + 2 * kLongTile + r);
      long_c(b, r, k0, dim, lane, stage[0], sst[0], &first_invalid[0],
             (w - 1) * 32);
      b = long_b(a1, u, scale, L, sc, cols.n);
      cp_async_wait_all();
    }
    __syncthreads();
    float acc = 0.f;
    for (int64_t t = 0;; ++t) {
      const int buf = static_cast<int>(t & 1);
      const int nv = first_invalid[t & 3];
      const bool full = nv == kLongTile;
      if (w == 0) {
        int q = 0;
        for (; q + 8 <= nv; q += 8) {
          float sv[8], gv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sv[i] = sst[buf][q + i];
            gv[i] = stage[buf][q + i][lane];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) acc = fmaf(sv[i], gv[i], acc);
        }
        for (; q < nv; ++q) acc = fmaf(sst[buf][q], stage[buf][q][lane], acc);
        if (lane == 0) first_invalid[(t + 2) & 3] = kLongTile;
      } else if (full) {
        // C of tile t + 1, B of t + 2, A of t + 3: independent loads.
        const LongB b2 = long_b(a, u, scale, L, sc, cols.n);
        a = long_a(sk, so, n, start + (t + 3) * kLongTile + r);
        long_c(b, r, k0, dim, lane, stage[buf ^ 1], sst[buf ^ 1],
               &first_invalid[(t + 1) & 3], (w - 1) * 32);
        b = b2;
        cp_async_wait_all();
      }
      __syncthreads();
      if (!full) break;
    }
    if (w == 0 && k0 + lane < dim)
      grad[static_cast<int64_t>(u) * dim + k0 + lane] = acc;
  }
}

// Rows no real occurrence reads, as zeros; and the long segments into
// the count of split rows.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    occ_zero_rows_kernel(const uint8_t* __restrict__ present, int64_t rows,
                         int dim, float* __restrict__ grad,
                         const int32_t* __restrict__ long_count,
                         unsigned long long* __restrict__ split) {
  if (split != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(split, static_cast<unsigned long long>(*long_count));
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= rows || present[u] != 0) return;
  float acc[kPerLane];
  zero(acc);
  for (int k0 = 0; k0 < dim; k0 += kTileK)
    store_tile<kVec>(grad + u * dim, acc, k0, dim, lane);
}

// ------------------------------------------------------------- host side

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Columns from the caller's table of 8 int64 a column: data pointer,
// weights pointer, s0, s1, off, width, kind, combiner. Returns false on
// a table the kernels do not take; `vec` says whether every pointer and
// stride allows 16-byte accesses.
bool make_cols(const int64_t* desc, int64_t ncols, int64_t L, Cols* cols,
               bool* vec) {
  if (ncols < 1 || ncols > kMaxCols) return false;
  int64_t items = 0, off = 0;
  for (int64_t i = 0; i < ncols; ++i) {
    const int64_t* d = desc + 8 * i;
    Col& c = cols->c[i];
    c.data = reinterpret_cast<float*>(d[0]);
    c.weights = reinterpret_cast<const float*>(d[1]);
    c.s0 = d[2];
    c.s1 = d[3];
    if (d[4] != off || d[5] < 0 || (d[6] != kBag && d[6] != kSeq) ||
        d[7] < kSum || d[7] > kSqrtn)
      return false;
    c.off = static_cast<int32_t>(d[4]);
    c.width = static_cast<int32_t>(d[5]);
    c.item0 = static_cast<int32_t>(items);
    c.kind = static_cast<int32_t>(d[6]);
    c.combiner = static_cast<int32_t>(d[7]);
    c.pad = 0;
    off += c.width;
    items += c.kind == kSeq ? c.width : 1;
    if (c.data != nullptr &&
        (!aligned16(c.data) || c.s0 % 4 != 0 ||
         (c.kind == kSeq && c.s1 % 4 != 0)))
      *vec = false;
  }
  if (off != L || items > 0x7fffffffLL) return false;
  cols->n = static_cast<int32_t>(ncols);
  cols->items = static_cast<int32_t>(items);
  return true;
}

struct Scratch {
  int32_t* long_starts;
  int32_t* long_count;  // then present: the bytes cleared before a launch
  uint8_t* present;
  int64_t cleared;
};

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

int64_t scratch_layout(int64_t n, int64_t U, char* base, Scratch* s) {
  // long segments hold more than kChunk occurrences each
  const int64_t ls = align16((n / (kChunk + 1) + 1) * 4);
  const int64_t cleared = align16(4) + align16(U + 1);
  if (s != nullptr) {
    s->long_starts = reinterpret_cast<int32_t*>(base);
    s->long_count = reinterpret_cast<int32_t*>(base + ls);
    s->present = reinterpret_cast<uint8_t*>(base + ls + align16(4));
    s->cleared = cleared;
  }
  return ls + cleared;
}

unsigned blocks_of(int64_t warps) {
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

// A grid of kBlocksPerSm blocks an SM, at most `most`.
unsigned grid_of(int64_t most) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t g = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<unsigned>(most < g ? (most > 0 ? most : 1) : g);
}

}  // namespace

// Plain C entries for ctypes; each returns the cudaError_t of its
// launches (cudaErrorInvalidValue on arguments it does not take) and
// adds the kernels it launched to *launched.
//
// rows [U + 1, dim] float32; inverse [B, L] int64; mask [B, L] bool;
// desc: ncols columns of 8 int64 (see make_cols), whose widths add up
// to L; scale [B * L] float32 and keys [B * L] int32 (the sort keys),
// written by the forward for the backward.
extern "C" int deeprec_occ_combine_forward(const void* rows, int64_t U,
                                           int64_t dim, const void* inverse,
                                           const void* mask, int64_t B,
                                           int64_t L, const int64_t* desc,
                                           int64_t ncols, void* scale,
                                           void* keys, int64_t* launched,
                                           void* stream) {
  if (U < 0 || U >= 0x7ffffffeLL || dim < 1 || dim > (1 << 30) || B < 0 ||
      L < 0 || B * L >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  bool vec = dim % 4 == 0 && aligned16(rows);
  if (!make_cols(desc, ncols, L, &cols, &vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = B * cols.items;
  if (items == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rows);
  auto inv = static_cast<const int64_t*>(inverse);
  auto msk = static_cast<const bool*>(mask);
  auto sc = static_cast<float*>(scale);
  auto ks = static_cast<int32_t*>(keys);
  const unsigned grid = grid_of(blocks_of(items));
  if (vec)
    occ_combine_fwd_kernel<true><<<grid, kWarps * 32, 0, st>>>(
        r, U, static_cast<int>(dim), inv, msk, B, static_cast<int>(L), cols,
        sc, ks);
  else
    occ_combine_fwd_kernel<false><<<grid, kWarps * 32, 0, st>>>(
        r, U, static_cast<int>(dim), inv, msk, B, static_cast<int>(L), cols,
        sc, ks);
  *launched += 1;
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the backward's scratch for n = B * L occurrences.
extern "C" int64_t deeprec_occ_backward_scratch_bytes(int64_t n, int64_t U) {
  return scratch_layout(n, U, nullptr, nullptr);
}

// sorted_keys [B * L] int32 and sorted_occ [B * L] int64: the forward's
// keys in a stable ascending order, and the occurrence each came from.
// grad [U + 1, dim] float32 is written whole. desc holds each column's
// output gradient (null where autograd gives none) with its strides.
// split, where not null, is an int64 on the card that the long
// segments' count (the rows split over blocks of their own) is added to.
extern "C" int deeprec_occ_combine_backward(
    const void* sorted_keys, const void* sorted_occ, const void* scale,
    int64_t B, int64_t L, int64_t U, int64_t dim, const int64_t* desc,
    int64_t ncols, void* grad, void* scratch, void* split, int64_t* launched,
    void* stream) {
  if (U < 0 || U >= 0x7ffffffeLL || dim < 1 || dim > (1 << 30) || B < 0 ||
      L < 0 || B * L >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  bool vec = dim % 4 == 0 && aligned16(grad);
  if (!make_cols(desc, ncols, L, &cols, &vec))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto g = static_cast<float*>(grad);
  const int64_t n = B * L;
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(g, 0, (U + 1) * dim * 4, st));
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  if ((chunks + kWarps - 1) / kWarps > 0x7fffffffLL ||
      (U + kWarps) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Scratch s;
  scratch_layout(n, U, static_cast<char*>(scratch), &s);
  const cudaError_t e = cudaMemsetAsync(s.long_count, 0, s.cleared, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto sk = static_cast<const int32_t*>(sorted_keys);
  auto so = static_cast<const int64_t*>(sorted_occ);
  auto ull = static_cast<unsigned long long*>(split);
  auto sc = static_cast<const float*>(scale);
  const int Li = static_cast<int>(L), di = static_cast<int>(dim);
  if (vec)
    occ_segsum_kernel<true><<<blocks_of(chunks), kWarps * 32, 0, st>>>(
        sk, so, sc, n, U, Li, di, cols, g, s.present, s.long_starts,
        s.long_count, chunks);
  else
    occ_segsum_kernel<false><<<blocks_of(chunks), kWarps * 32, 0, st>>>(
        sk, so, sc, n, U, Li, di, cols, g, s.present, s.long_starts,
        s.long_count, chunks);
  occ_long_kernel<<<grid_of((n / (kChunk + 1) + 1) * ((dim + 31) / 32)),
                    kLongThreads, 0, st>>>(sk, so, sc, n, U, Li, di, cols, g,
                                           s.long_starts, s.long_count);
  if (vec)
    occ_zero_rows_kernel<true><<<blocks_of(U + 1), kWarps * 32, 0, st>>>(
        s.present, U + 1, di, g, s.long_count, ull);
  else
    occ_zero_rows_kernel<false><<<blocks_of(U + 1), kWarps * 32, 0, st>>>(
        s.present, U + 1, di, g, s.long_count, ull);
  *launched += 3;
  return static_cast<int>(cudaGetLastError());
}
