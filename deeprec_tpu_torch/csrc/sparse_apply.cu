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
// few operations per element. The design keeps those bytes coalesced:
// one warp per row, consecutive lanes on consecutive columns, so any D
// works (65 and 129 included, which the Pallas kernel never compiled
// for). Lane 0 loads the row's slot and flags once and the warp shares
// them by a shuffle. Offsets are int64: (C+1)*D exceeds 2^31 elements
// at reference table sizes.
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

__global__ void adagrad_kernel(float* __restrict__ values,
                               float* __restrict__ accum, int64_t C,
                               int64_t D, const int32_t* __restrict__ slots,
                               const float* __restrict__ grads, int64_t n,
                               const bool* __restrict__ update,
                               const bool* __restrict__ is_new, float lr,
                               float init_acc) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n) return;  // uniform across the warp
  int64_t s;
  bool fresh;
  if (!row_slot(slots, update, is_new, C, row, &s, &fresh)) return;
  const int lane = threadIdx.x % 32;
  float* w = values + s * D;
  float* acc = accum + s * D;
  const float* g_row = grads + row * D;
  for (int64_t c = lane; c < D; c += 32) {
    const float g = g_row[c];
    float a = fresh ? init_acc : acc[c];
    a = a + g * g;
    const float step = (lr * g) * rsqrtf(a);
    w[c] = w[c] - step;
    acc[c] = a;
  }
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
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  adagrad_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(values), static_cast<float*>(accum), C1 - 1, D,
      static_cast<const int32_t*>(slots), static_cast<const float*>(grads), n,
      static_cast<const bool*>(update), static_cast<const bool*>(is_new), lr,
      init_acc);
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
