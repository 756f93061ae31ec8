// Sparse optimizer row applies for Hopper: Adagrad (K2) and lazy Adam
// (K3), in place over the unique rows one training step touched.
//
// Replaces the Pallas TPU kernels `adagrad_apply_rows` and
// `adam_apply_rows` in deeprec_tpu/ops/pallas/sparse_apply.py, extended
// by what `SparseAdagrad.apply` / `SparseAdam.apply` wrap around them in
// deeprec_tpu/optimizers/sparse.py: the update gate (`_gate`: admitted
// rows inside the table) and the fresh-row reset of the slot rows
// (`_fresh`: rows inserted this step start from the initial slot value).
//
// For each i with update[i] and 0 <= s = slots[i] < C, on [C+1, D]
// float32 tables (row C is the table's sentinel row and is never
// written; any other slot is dropped):
//
//   Adagrad: a = is_new[i] ? init_acc : accum[s]
//            a = a + g*g
//            values[s] = w - (lr*g) * rsqrtf(a);  accum[s] = a
//   Adam:    m = is_new[i] ? 0 : m[s];  v = is_new[i] ? 0 : v[s]
//            m = beta1*m + (1-beta1)*g;  v = beta2*v + ((1-beta2)*g)*g
//            values[s] = w - (alpha*m) / (sqrtf(v) + eps)
//
// with g = grads[i] ([n, D] float32) and w = values[s]. Where base_rows
// ([n, D] float32, the training lookup's rows) is given, w is read from
// base_rows[i] instead of values[s]: the rows a dynamic-dimension
// table masked after the fetch (locked blocks read 0, so they are
// written back as 0 - update, and their update is 0) and the seeds an
// adaptive table migrated into its newly hot rows. The rule is one for
// both, and it reads as many bytes as values[s] would; without
// base_rows the kernel takes the path it always took. alpha (the
// bias-corrected step) is read from device memory, once per warp, so
// the step never waits on the host. The slots of one call are unique by contract (the
// representatives of the training lookup), so rows never race and no
// atomics are needed.
//
// What bounds them: bytes. Per element of an updated row Adagrad moves
// 20 bytes (read w, acc, g; write w, acc) and Adam 28 (read w, m, v, g;
// write w, m, v); a fresh row's slot rows are not read, so 16 and 20
// for it. Add a few bytes of slot and flags per u-row, at a few
// operations per element. Reaching the card's memory rate takes many
// loads in flight, and on the training path most u-rows are not
// applied at all: where every occurrence is its own u-row, about three
// in four carry the dropped slot.
//
// One walk for both (apply_kernel, over an optimizer op and K =
// ceil(D/32) up to 8). A warp takes a group of Op::kGroup consecutive
// u-rows. Lane i loads the slot, update flag and is_new flag of row
// base+i in one coalesced read; __ballot_sync over "updated and 0 <=
// slot < C" gives the rows to apply, and the warp walks only the set
// bits, so dropped rows cost a header read and nothing more, with no
// compaction pass and no host sync. Each applied row is one unit of K
// column chunks (wider rows take several units). The warp loads a
// batch of up to Op::kBatch units, every stream of every chunk, the
// slot streams skipped for a fresh row, before it does any unit's
// arithmetic and stores, so 24-64 loads per lane are in flight.
// Consecutive lanes stay on consecutive columns: coalesced for any D
// (65 and 129 included, which the Pallas kernels never compiled for).
// Small groups keep many warps on the card when few rows are applied:
// a group of 32 left the 65-wide Adagrad apply of the training path
// with 2,102 warps, slower than one warp per row.
//
// The op supplies the unit's registers, its loads and its arithmetic
// and stores. K2's unit holds 3 streams (g, w, acc) of K chunks, a
// batch 16 / K units; K3's holds 4 (g, w, m, v), a third more
// registers per unit. Measured on an H100 in turns (PERF.md §6):
// K2 ran as fast through the shared walk as in its own kernel; K3's
// batch of 8 / K units (2 at 65 and 129 wide: 56 and 70 registers, no
// spills) beat 12 / K and 16 / K by 15 % at 65 wide, where the larger
// batches' 102-114 registers halve the warps an SM holds, and tied or
// won at 129 wide; a flat element range over the applied rows (as K1
// walks its tile), which keeps every lane busy at 129 wide, lost at
// both widths to its shuffles and index arithmetic; evict-first loads
// and stores were 39 % slower at 87 % updated.
//
// Offsets are int64: (C+1)*D exceeds 2^31 elements at reference table
// sizes.
//
// The arithmetic follows the plain PyTorch version operation by
// operation, and the library is built with --fmad=false (see
// ops/kernels/build.py) so no multiply-add is contracted into an FMA
// that the plain version would round twice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Blocks of 4 warps: at 70 registers (K3, K = 5) an SM then holds 28
// warps, against 24 in blocks of 8 (PERF.md §6).
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChunks = 8;  // a unit holds up to 32 * 8 = 256 columns

// K3's u-rows per warp (rows of up to 96 columns, wider rows) and the
// loads per stream a lane holds in one batch of kAdamLoads / K units
// (at least 2).
constexpr int kAdamGroupNarrow = 4;
constexpr int kAdamGroupWide = 8;
constexpr int kAdamLoads = 8;

constexpr int clamp_batch(int units) {
  return units < 2 ? 2 : (units > 8 ? 8 : units);
}

struct AdagradArgs {
  float* values;
  float* accum;
  const float* base_rows;  // [n, D] rows to update from, or null
  float lr, init_acc;
};

// K2: 4 u-rows a warp for rows of up to 96 columns, else 8. At the
// training path's update shares (26-40 %) a group then holds one to
// three applied rows, so many warps share the card; measured on an H100
// against groups of 32, 16 and 8 (PERF.md). A batch holds about 48
// values per lane (3 streams of K chunks each), at least 2 units.
template <int K>
struct AdagradOp : AdagradArgs {
  static constexpr int kChunks = K;
  static constexpr int kGroup = K <= 3 ? 4 : 8;
  static constexpr int kBatch = clamp_batch(16 / K);
  struct Unit {
    float g[K], a[K], w[K];
  };

  __device__ __forceinline__ void begin() {}

  __device__ __forceinline__ void load(Unit& u, const float* __restrict__ grads,
                                       int64_t row, int64_t s, int64_t D,
                                       int64_t c0, bool fresh, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c < D) {
        u.g[k] = grads[row * D + c];
        u.w[k] = base_rows != nullptr ? base_rows[row * D + c]
                                      : values[s * D + c];
        u.a[k] = fresh ? init_acc : accum[s * D + c];
      }
    }
  }

  __device__ __forceinline__ void store(const Unit& u, int64_t s, int64_t D,
                                        int64_t c0, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c < D) {
        const float g = u.g[k];
        const float a = u.a[k] + g * g;
        const float step = (lr * g) * rsqrtf(a);
        values[s * D + c] = u.w[k] - step;
        accum[s * D + c] = a;
      }
    }
  }
};

struct AdamArgs {
  float* values;
  float* m;
  float* v;
  const float* base_rows;  // [n, D] rows to update from, or null
  const float* alpha_ptr;
  float beta1, omb1, beta2, omb2, eps;
  float alpha;  // *alpha_ptr, loaded by begin()
};

// K3: four streams (g, w, m, v) of K chunks a unit.
template <int K>
struct AdamOp : AdamArgs {
  static constexpr int kChunks = K;
  static constexpr int kGroup = K <= 3 ? kAdamGroupNarrow : kAdamGroupWide;
  static constexpr int kBatch = clamp_batch(kAdamLoads / K);
  struct Unit {
    float g[K], w[K], m[K], v[K];
  };

  __device__ __forceinline__ void begin() { alpha = *alpha_ptr; }

  __device__ __forceinline__ void load(Unit& u, const float* __restrict__ grads,
                                       int64_t row, int64_t s, int64_t D,
                                       int64_t c0, bool fresh, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c < D) {
        u.g[k] = grads[row * D + c];
        u.w[k] = base_rows != nullptr ? base_rows[row * D + c]
                                      : values[s * D + c];
        u.m[k] = fresh ? 0.0f : m[s * D + c];
        u.v[k] = fresh ? 0.0f : v[s * D + c];
      }
    }
  }

  __device__ __forceinline__ void store(const Unit& u, int64_t s, int64_t D,
                                        int64_t c0, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      if (c < D) {
        const float g = u.g[k];
        const float mc = beta1 * u.m[k] + omb1 * g;
        const float vc = beta2 * u.v[k] + (omb2 * g) * g;
        const float step = (alpha * mc) / (sqrtf(vc) + eps);
        values[s * D + c] = u.w[k] - step;
        m[s * D + c] = mc;
        v[s * D + c] = vc;
      }
    }
  }
};

// A warp takes Op::kGroup consecutive u-rows and applies the updated
// ones, a batch of Op::kBatch units at a time.
template <class Op>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    apply_kernel(Op op, int64_t C, int64_t D,
                 const int32_t* __restrict__ slots,
                 const float* __restrict__ grads, int64_t n,
                 const bool* __restrict__ update,
                 const bool* __restrict__ is_new) {
  constexpr int P = Op::kBatch;
  constexpr int64_t kSpan = 32 * Op::kChunks;
  const int lane = threadIdx.x % 32;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) *
      Op::kGroup;
  if (base >= n) return;  // uniform across the warp
  const int64_t row = base + lane;
  int64_t s = 0;
  bool ok = false;
  bool nw = false;
  if (lane < Op::kGroup && row < n) {
    s = static_cast<int64_t>(slots[row]);
    ok = (update == nullptr || update[row]) && s >= 0 && s < C;
    nw = is_new != nullptr && is_new[row];
  }
  unsigned todo = __ballot_sync(0xffffffffu, ok);
  const unsigned fresh = __ballot_sync(0xffffffffu, nw);
  if (todo == 0) return;
  op.begin();
  // Units in order: each applied row (set bit), each 32*K-column block.
  int j = __ffs(todo) - 1;
  todo &= todo - 1;
  int64_t c0 = 0;
  bool more = true;
  while (more) {  // uniform across the warp
    typename Op::Unit u[P];
    int64_t us[P], uc[P];
    bool uv[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      uv[q] = more;
      if (more) {
        us[q] = __shfl_sync(0xffffffffu, static_cast<long long>(s), j);
        uc[q] = c0;
        op.load(u[q], grads, base + j, us[q], D, c0, (fresh >> j) & 1u, lane);
        c0 += kSpan;
        if (c0 >= D) {
          c0 = 0;
          if (todo == 0) {
            more = false;
          } else {
            j = __ffs(todo) - 1;
            todo &= todo - 1;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (uv[q]) op.store(u[q], us[q], D, uc[q], lane);
  }
}

template <class Op>
void launch(const Op& op, int64_t C1, int64_t D, const int32_t* slots,
            const float* grads, int64_t n, const bool* update,
            const bool* is_new, cudaStream_t stream) {
  const int64_t warps = (n + Op::kGroup - 1) / Op::kGroup;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  apply_kernel<Op><<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32,
                     0, stream>>>(op, C1 - 1, D, slots, grads, n, update,
                                  is_new);
}

// Checks the shape, picks K = min(ceil(D/32), kMaxChunks) and launches
// Op<K>; returns the cudaError_t of the launch.
template <template <int> class Op, class Args>
int apply(const Args& args, int64_t C1, int64_t D, const void* slots_p,
          const void* grads_p, int64_t n, const void* update_p,
          const void* is_new_p, void* stream_p) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (C1 < 1 || D < 1 ||
      (n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](const auto& op) {
    launch(op, C1, D, static_cast<const int32_t*>(slots_p),
           static_cast<const float*>(grads_p), n,
           static_cast<const bool*>(update_p),
           static_cast<const bool*>(is_new_p),
           static_cast<cudaStream_t>(stream_p));
  };
  switch ((D + 31) / 32) {
    case 1: go(Op<1>{args}); break;
    case 2: go(Op<2>{args}); break;
    case 3: go(Op<3>{args}); break;
    case 4: go(Op<4>{args}); break;
    case 5: go(Op<5>{args}); break;
    case 6: go(Op<6>{args}); break;
    case 7: go(Op<7>{args}); break;
    default: go(Op<kMaxChunks>{args}); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. update, is_new and base_rows may be null
// (every row updated; no row fresh; rows updated from values). Each
// returns the cudaError_t of its launch.
extern "C" int deeprec_adagrad_apply_rows(void* values, void* accum,
                                          int64_t C1, int64_t D,
                                          const void* slots, const void* grads,
                                          int64_t n, const void* update,
                                          const void* is_new,
                                          const void* base_rows, float lr,
                                          float init_acc, void* stream) {
  const AdagradArgs args{static_cast<float*>(values),
                         static_cast<float*>(accum),
                         static_cast<const float*>(base_rows), lr, init_acc};
  return apply<AdagradOp>(args, C1, D, slots, grads, n, update, is_new,
                          stream);
}

extern "C" int deeprec_adam_apply_rows(void* values, void* m, void* v,
                                       int64_t C1, int64_t D,
                                       const void* slots, const void* grads,
                                       int64_t n, const void* update,
                                       const void* is_new,
                                       const void* base_rows, const void* alpha,
                                       float beta1, float omb1, float beta2,
                                       float omb2, float eps, void* stream) {
  if (n > 0 && alpha == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const AdamArgs args{static_cast<float*>(values), static_cast<float*>(m),
                      static_cast<float*>(v),
                      static_cast<const float*>(base_rows),
                      static_cast<const float*>(alpha),
                      beta1, omb1, beta2, omb2, eps, 0.0f};
  return apply<AdamOp>(args, C1, D, slots, grads, n, update, is_new, stream);
}
