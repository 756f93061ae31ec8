// Fresh-row initialization for Hopper (P2): the initializer draw of the
// rows a training lookup inserted.
//
// Replaces the fresh-row while_loops of deeprec_tpu/embedding/variable.py
// `lookup_train_occ` (:424 version-tracked, :446 LightHeader); the JAX
// package has no Pallas kernel for them. The plain version is
// ops/kernels/init_rows.py `init_fresh_reference`, which draws a row for
// every entry (fresh or not) and writes the fresh ones.
//
// Semantics: for every entry i with fresh[i] and 0 <= slots[i] < C,
// values[slots[i], c] = draw(qhi[i], qlo[i], c) for c < D, where draw is
// utils/stateless_random.py `init_rows`: a murmur3-finalized hash of the
// id, the salt and the column, mapped to (0, 1] and then to the
// initializer (zeros, constant, uniform, normal by Box-Muller, normal
// clamped to +-2 sigma). Each multiply and add is a separately rounded
// float32 operation (__fmul_rn/__fadd_rn), in the plain version's order,
// with the scalars rounded to float32 as PyTorch rounds them; log, cos
// and sqrt are the CUDA math library's logf, cosf and sqrtf. Row C and
// the rows of entries that are not fresh are not written. Fresh entries
// that share a slot must be occurrences of one id: they write the same
// values.
//
// What bounds it: bytes. A call reads the fresh flags (one byte an
// entry), the slots and ids of the fresh entries, and writes their rows.
// On a cycled training step almost nothing is fresh, so the flags are
// the whole cost; on a batch of unseen ids the row writes are.
//
// Design: a warp takes 32 consecutive entries, one a lane, and loads
// their flags and (where fresh) slots; __ballot_sync gives the fresh
// ones, and the warp walks their set bits, writing each fresh row with
// its lanes across the columns (coalesced stores), so the cost of the
// draw follows the fresh rows, not the entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr int kThreads = 256;

enum Kind : int { kZeros = 0, kConstant = 1, kUniform = 2, kNormal = 3,
                  kTruncatedNormal = 4 };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// uint32 -> float32 uniform in (0, 1], as stateless_random._to_unit.
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8), 0x1p-24f),
                   0x1p-25f);
}

// One element: a and b are the kind's float32 scalars (constant: a;
// uniform: a = minval, b = maxval - minval; normal kinds: a = stddev),
// mix1/mix2 the salted hash offsets of the (first, second) grid.
__device__ __forceinline__ float draw(int kind, uint32_t base, uint32_t col,
                                      float a, float b, uint32_t mix1,
                                      uint32_t mix2) {
  if (kind == kZeros) return 0.0f;
  if (kind == kConstant) return a;
  const uint32_t c = col * kPhi;
  const float u1 = to_unit(fmix32(base ^ mix1 ^ c));
  if (kind == kUniform) return __fadd_rn(a, __fmul_rn(b, u1));
  const float u2 = to_unit(fmix32(base ^ mix2 ^ c));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float z = __fmul_rn(r, cosf(__fmul_rn(6.28318548202514648f, u2)));
  if (kind == kNormal) return __fmul_rn(a, z);
  return __fmul_rn(a, fminf(fmaxf(z, -2.0f), 2.0f));
}

template <typename T>
__device__ __forceinline__ T cast(float x);
template <>
__device__ __forceinline__ float cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
init_fresh_kernel(T* __restrict__ values, int64_t C, int64_t D,
                  const int32_t* __restrict__ slots,
                  const bool* __restrict__ fresh,
                  const int32_t* __restrict__ qhi,
                  const int32_t* __restrict__ qlo, int64_t n, int kind,
                  float a, float b, uint32_t mix1, uint32_t mix2) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) - lane;
  const int64_t i = first + lane;
  int32_t slot = -1;
  bool on = false;
  if (i < n && fresh[i]) {
    slot = slots[i];
    on = slot >= 0 && slot < C;
  }
  unsigned mask = __ballot_sync(0xffffffffu, on);
  while (mask) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    const int64_t s = __shfl_sync(0xffffffffu, slot, j);
    const uint32_t hi = static_cast<uint32_t>(qhi[first + j]);
    const uint32_t lo = static_cast<uint32_t>(qlo[first + j]);
    const uint32_t base = lo ^ (hi * kPhi);
    T* row = values + s * D;
    for (int64_t c = lane; c < D; c += 32)
      row[c] = cast<T>(draw(kind, base, static_cast<uint32_t>(c), a, b,
                            mix1, mix2));
  }
}

}  // namespace

// values: [C + 1, D] float32 (esize 4) or bfloat16 (esize 2); slots,
// qhi, qlo: [n] int32; fresh: [n] bool. Returns a cudaError_t.
extern "C" int deeprec_init_fresh(void* values, int64_t C, int64_t D,
                                  const void* slots, const void* fresh,
                                  const void* qhi, const void* qlo, int64_t n,
                                  int64_t kind, float a, float b,
                                  uint32_t mix1, uint32_t mix2, int64_t esize,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (C < 0 || D < 1 || kind < kZeros || kind > kTruncatedNormal)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto s = static_cast<cudaStream_t>(stream);
  auto sl = static_cast<const int32_t*>(slots);
  auto fr = static_cast<const bool*>(fresh);
  auto hi = static_cast<const int32_t*>(qhi);
  auto lo = static_cast<const int32_t*>(qlo);
  const int k = static_cast<int>(kind);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (esize == 4) {
    init_fresh_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(values), C, D, sl, fr, hi, lo, n, k, a, b, mix1,
        mix2);
  } else if (esize == 2) {
    init_fresh_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(values), C, D, sl, fr, hi, lo, n, k, a, b,
        mix1, mix2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
