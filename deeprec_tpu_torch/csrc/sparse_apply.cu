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
//            values[s] = values[s] - (lr*g) * rsqrtf(a);  accum[s] = a
//   Adam:    m = is_new[i] ? 0 : m[s];  v = is_new[i] ? 0 : v[s]
//            m = beta1*m + (1-beta1)*g;  v = beta2*v + (1-beta2)*g*g
//            values[s] = values[s] - (alpha*m) / (sqrtf(v) + eps)
//
// with g = grads[i] ([n, D] float32). alpha (the bias-corrected step)
// is read from device memory, so the step never waits on the host. The
// slots of one call are unique by contract (the representatives of the
// training lookup), so rows never race and no atomics are needed.
//
// What bounds it: bytes. Adagrad moves 20 bytes per element of an
// updated row (read w, acc, g; write w, acc), Adam 28 (w, m, v, g read;
// w, m, v written), plus a few bytes of index and flags per row, at a
// few operations per element. Reaching the card's memory rate takes
// many loads in flight, and on the training path most u-rows are not
// applied at all: where every occurrence is its own u-row, about three
// in four carry the dropped slot.
//
// Adagrad (K2) design: a warp takes a group of kGroup<K> consecutive
// u-rows (4 or 8). Lane i loads the slot, update flag and is_new flag
// of row base+i in one coalesced read; __ballot_sync over "updated and
// 0 <= slot < C" gives the rows to apply, and the warp walks only the
// set bits, so dropped rows cost a header read and nothing more, with
// no compaction pass and no host sync. Each applied row is one unit of
// K = ceil(D/32) column chunks (a template argument up to 8; wider rows
// take several units). The warp loads a batch of up to kBatch<K> units
// (every lane: g, w and acc of each chunk, acc skipped for a fresh row)
// before it does any unit's arithmetic and stores, so up to ~48 loads
// per lane are in flight. Consecutive lanes stay on consecutive
// columns: coalesced for any D (65 and 129 included, which the Pallas
// kernel never compiled for). Small groups keep many warps on the card
// when few rows are applied: a group of 32 left the 65-wide apply of
// the training path with 2,102 warps, slower than one warp per row.
//
// Adam (K3) keeps its first design until it gets K2's: one warp per
// row, lane 0 loads the row's slot and flags and the warp shares them
// by a shuffle, one element of each stream in flight per lane.
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

constexpr int kWarpsPerBlock = 8;

// Row index, its slot, and whether the warp updates it. Uniform across
// the warp.
__device__ __forceinline__ bool row_slot(const int32_t* __restrict__ slots,
                                         const bool* __restrict__ update,
                                         const bool* __restrict__ is_new,
                                         int64_t C, int64_t row,
                                         int64_t* slot, bool* fresh) {
  const int lane = threadIdx.x % 32;
  int32_t packed = 0;  // bit 0: update, bit 1: fresh
  int64_t s = 0;
  if (lane == 0) {
    s = static_cast<int64_t>(slots[row]);
    const bool upd = (update == nullptr || update[row]) && s >= 0 && s < C;
    const bool nw = is_new != nullptr && is_new[row];
    packed = (upd ? 1 : 0) | (nw ? 2 : 0);
  }
  packed = __shfl_sync(0xffffffffu, packed, 0);
  *slot = __shfl_sync(0xffffffffu, static_cast<long long>(s), 0);
  *fresh = (packed & 2) != 0;
  return (packed & 1) != 0;
}

// One K2 work unit: up to 32*K columns of one applied row, held in
// registers between its loads and its arithmetic.
template <int K>
struct AdagradUnit {
  float g[K], a[K], w[K];
};

template <int K>
__device__ __forceinline__ void adagrad_load(
    AdagradUnit<K>& u, const float* values, const float* accum,
    const float* __restrict__ grads,
    int64_t row, int64_t s, int64_t D, int64_t c0, bool fresh,
    float init_acc, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t c = c0 + lane + 32 * k;
    if (c < D) {
      u.g[k] = grads[row * D + c];
      u.w[k] = values[s * D + c];
      u.a[k] = fresh ? init_acc : accum[s * D + c];
    }
  }
}

template <int K>
__device__ __forceinline__ void adagrad_store(
    const AdagradUnit<K>& u, float* values, float* accum, int64_t s,
    int64_t D, int64_t c0, float lr, int lane) {
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

// u-rows a K2 warp takes: 4 for rows of up to 96 columns, else 8. At
// the training path's update shares (26-40 %) a group then holds one to
// three applied rows, so many warps share the card; measured on an H100
// against groups of 32, 16 and 8 (PERF.md).
template <int K>
constexpr int kGroup = K <= 3 ? 4 : 8;

// Units a K2 warp loads before it computes and stores any of them: about
// 48 values per lane (3 streams of K chunks each), at least 2, at most 8.
template <int K>
constexpr int kBatch = 16 / K < 2 ? 2 : (16 / K > 8 ? 8 : 16 / K);

// A warp takes kGroup<K> consecutive u-rows; K = min(ceil(D/32), kMaxChunks).
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    adagrad_kernel(float* __restrict__ values, float* __restrict__ accum,
                   int64_t C, int64_t D, const int32_t* __restrict__ slots,
                   const float* __restrict__ grads, int64_t n,
                   const bool* __restrict__ update,
                   const bool* __restrict__ is_new, float lr, float init_acc) {
  const int lane = threadIdx.x % 32;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) *
      kGroup<K>;
  if (base >= n) return;  // uniform across the warp
  const int64_t row = base + lane;
  int64_t s = 0;
  bool ok = false;
  bool nw = false;
  if (lane < kGroup<K> && row < n) {
    s = static_cast<int64_t>(slots[row]);
    ok = (update == nullptr || update[row]) && s >= 0 && s < C;
    nw = is_new != nullptr && is_new[row];
  }
  unsigned todo = __ballot_sync(0xffffffffu, ok);
  const unsigned fresh = __ballot_sync(0xffffffffu, nw);
  if (todo == 0) return;
  // Units in order: each applied row (set bit), each 32*K-column block.
  // A batch of up to kBatch units is loaded, then computed and stored.
  constexpr int P = kBatch<K>;
  constexpr int64_t kSpan = 32 * K;
  int j = __ffs(todo) - 1;
  todo &= todo - 1;
  int64_t c0 = 0;
  bool more = true;
  while (more) {  // uniform across the warp
    AdagradUnit<K> u[P];
    int64_t us[P], uc[P];
    bool uv[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      uv[q] = more;
      if (more) {
        us[q] = __shfl_sync(0xffffffffu, static_cast<long long>(s), j);
        uc[q] = c0;
        adagrad_load<K>(u[q], values, accum, grads, base + j, us[q], D, c0,
                        (fresh >> j) & 1u, init_acc, lane);
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
      if (uv[q]) adagrad_store<K>(u[q], values, accum, us[q], D, uc[q], lr, lane);
  }
}

constexpr int kMaxChunks = 8;  // a K2 unit holds up to 256 columns

template <int K>
void adagrad_launch(float* values, float* accum, int64_t C1, int64_t D,
                    const int32_t* slots, const float* grads, int64_t n,
                    const bool* update, const bool* is_new, float lr,
                    float init_acc, cudaStream_t stream) {
  const int64_t warps = (n + kGroup<K> - 1) / kGroup<K>;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  adagrad_kernel<K><<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32,
                      0, stream>>>(values, accum, C1 - 1, D, slots, grads, n,
                                   update, is_new, lr, init_acc);
}

__global__ void adam_kernel(float* __restrict__ values, float* __restrict__ m,
                            float* __restrict__ v, int64_t C, int64_t D,
                            const int32_t* __restrict__ slots,
                            const float* __restrict__ grads, int64_t n,
                            const bool* __restrict__ update,
                            const bool* __restrict__ is_new,
                            const float* __restrict__ alpha_ptr, float beta1,
                            float omb1, float beta2, float omb2, float eps) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n) return;  // uniform across the warp
  int64_t s;
  bool fresh;
  if (!row_slot(slots, update, is_new, C, row, &s, &fresh)) return;
  const int lane = threadIdx.x % 32;
  const float alpha = *alpha_ptr;
  float* w = values + s * D;
  float* m_row = m + s * D;
  float* v_row = v + s * D;
  const float* g_row = grads + row * D;
  for (int64_t c = lane; c < D; c += 32) {
    const float g = g_row[c];
    float mc = fresh ? 0.0f : m_row[c];
    float vc = fresh ? 0.0f : v_row[c];
    mc = beta1 * mc + omb1 * g;
    vc = beta2 * vc + omb2 * g * g;
    const float step = (alpha * mc) / (sqrtf(vc) + eps);
    w[c] = w[c] - step;
    m_row[c] = mc;
    v_row[c] = vc;
  }
}

bool bad_shape(int64_t C1, int64_t D, int64_t n) {
  return C1 < 1 || D < 1 ||
         (n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL;
}

}  // namespace

// Plain C entries for ctypes. update and is_new may be null (every row
// updated; no row fresh). Each returns the cudaError_t of its launch.
extern "C" int deeprec_adagrad_apply_rows(void* values, void* accum,
                                          int64_t C1, int64_t D,
                                          const void* slots, const void* grads,
                                          int64_t n, const void* update,
                                          const void* is_new, float lr,
                                          float init_acc, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(C1, D, n)) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = adagrad_launch<kMaxChunks>;
  switch ((D + 31) / 32) {
    case 1: launch = adagrad_launch<1>; break;
    case 2: launch = adagrad_launch<2>; break;
    case 3: launch = adagrad_launch<3>; break;
    case 4: launch = adagrad_launch<4>; break;
    case 5: launch = adagrad_launch<5>; break;
    case 6: launch = adagrad_launch<6>; break;
    case 7: launch = adagrad_launch<7>; break;
    default: break;
  }
  launch(static_cast<float*>(values), static_cast<float*>(accum), C1, D,
         static_cast<const int32_t*>(slots), static_cast<const float*>(grads),
         n, static_cast<const bool*>(update), static_cast<const bool*>(is_new),
         lr, init_acc, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int deeprec_adam_apply_rows(void* values, void* m, void* v,
                                       int64_t C1, int64_t D,
                                       const void* slots, const void* grads,
                                       int64_t n, const void* update,
                                       const void* is_new, const void* alpha,
                                       float beta1, float omb1, float beta2,
                                       float omb2, float eps, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (bad_shape(C1, D, n) || alpha == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  adam_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(values), static_cast<float*>(m),
      static_cast<float*>(v), C1 - 1, D, static_cast<const int32_t*>(slots),
      static_cast<const float*>(grads), n, static_cast<const bool*>(update),
      static_cast<const bool*>(is_new), static_cast<const float*>(alpha),
      beta1, omb1, beta2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}
