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
// What bounds it: the arithmetic, once rows are fresh. A call reads the
// fresh flags (one byte an entry), the slots and ids of the fresh
// entries, and writes their rows; but every element of a fresh row is a
// chain of some 100+ instructions (two fmix32 hashes, to_unit, logf,
// cosf, sqrtf and the clamp for the normal kinds), so the issue rate of
// the SMs, not the bytes, is the least time of a draw of many rows. On
// a cycled training step almost nothing is fresh, and the flags are the
// whole cost.
//
// Design: a block takes kThreads consecutive entries. Its warps ballot
// over the fresh ones and a block-wide prefix of the warps' counts
// packs their slots and hashed ids, in entry order, into shared memory.
// The block's threads then walk the fresh rows' elements (rows x D) in
// strides of kThreads, kIlp independent elements a thread at a time, so
// every lane has work whatever the width and several draws are in
// flight in each thread. Neighbouring threads take neighbouring
// columns of a row: the stores coalesce. The element's row and column
// advance by adding the stride, not by a division. Which thread draws
// an element does not change its value: each element is a function of
// its id and column alone, computed with the same separately rounded
// operations as before; the kind is a template argument, so the loop
// has no branch on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // entries a block, and its threads
constexpr int kWarps = kThreads / 32;
constexpr int kIlp = 4;        // elements in flight in a thread

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
template <int kKind>
__device__ __forceinline__ float draw(uint32_t base, uint32_t col, float a,
                                      float b, uint32_t mix1, uint32_t mix2) {
  if (kKind == kZeros) return 0.0f;
  if (kKind == kConstant) return a;
  const uint32_t c = col * kPhi;
  const float u1 = to_unit(fmix32(base ^ mix1 ^ c));
  if (kKind == kUniform) return __fadd_rn(a, __fmul_rn(b, u1));
  const float u2 = to_unit(fmix32(base ^ mix2 ^ c));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float z = __fmul_rn(r, cosf(__fmul_rn(6.28318548202514648f, u2)));
  if (kKind == kNormal) return __fmul_rn(a, z);
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

template <typename T, int kKind>
__global__ void __launch_bounds__(kThreads)
init_fresh_kernel(T* __restrict__ values, int64_t C, int32_t D,
                  const int32_t* __restrict__ slots,
                  const bool* __restrict__ fresh,
                  const int32_t* __restrict__ qhi,
                  const int32_t* __restrict__ qlo, int64_t n, float a,
                  float b, uint32_t mix1, uint32_t mix2) {
  __shared__ int32_t s_slot[kThreads];
  __shared__ uint32_t s_base[kThreads];
  __shared__ int s_count[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int32_t slot = -1;
  bool on = false;
  if (i < n && fresh[i]) {
    slot = slots[i];
    on = slot >= 0 && slot < C;
  }
  // The block's fresh entries, packed in entry order.
  const unsigned bits = __ballot_sync(kFull, on);
  if (lane == 0) s_count[warp] = __popc(bits);
  __syncthreads();
  int before = 0, rows = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int k = s_count[w];
    before += w < warp ? k : 0;
    rows += k;
  }
  if (rows == 0) return;  // the same for every thread of the block
  if (on) {
    const int at = before + __popc(bits & ((1u << lane) - 1u));
    s_slot[at] = slot;
    s_base[at] = static_cast<uint32_t>(qlo[i]) ^
                 (static_cast<uint32_t>(qhi[i]) * kPhi);
  }
  __syncthreads();
  // Element e = row * D + col of the packed rows; thread t takes
  // e = t, t + kThreads, ...: kIlp of them at once while the block has
  // kIlp * kThreads left, then one at a time.
  const int dr = kThreads / D, dc = kThreads % D;
  int row = threadIdx.x / D, col = threadIdx.x % D;
  const int total = rows * D;
  for (int e = 0; e + kIlp * kThreads <= total; e += kIlp * kThreads) {
    int rr[kIlp], cc[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      rr[k] = row;
      cc[k] = col;
      row += dr;
      col += dc;
      if (col >= D) {
        col -= D;
        ++row;
      }
    }
    float v[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k)
      v[k] = draw<kKind>(s_base[rr[k]], static_cast<uint32_t>(cc[k]), a, b,
                         mix1, mix2);
#pragma unroll
    for (int k = 0; k < kIlp; ++k)
      values[static_cast<int64_t>(s_slot[rr[k]]) * D + cc[k]] = cast<T>(v[k]);
  }
  for (; row < rows; row += dr) {
    values[static_cast<int64_t>(s_slot[row]) * D + col] = cast<T>(
        draw<kKind>(s_base[row], static_cast<uint32_t>(col), a, b, mix1,
                    mix2));
    col += dc;
    if (col >= D) {
      col -= D;
      ++row;
    }
  }
}

template <typename T, int kKind>
void launch(unsigned blocks, cudaStream_t s, T* values, int64_t C, int32_t D,
            const int32_t* sl, const bool* fr, const int32_t* hi,
            const int32_t* lo, int64_t n, float a, float b, uint32_t mix1,
            uint32_t mix2) {
  init_fresh_kernel<T, kKind><<<blocks, kThreads, 0, s>>>(
      values, C, D, sl, fr, hi, lo, n, a, b, mix1, mix2);
}

template <typename T>
void launch_kind(int kind, unsigned blocks, cudaStream_t s, T* values,
                 int64_t C, int32_t D, const int32_t* sl, const bool* fr,
                 const int32_t* hi, const int32_t* lo, int64_t n, float a,
                 float b, uint32_t mix1, uint32_t mix2) {
  switch (kind) {
    case kZeros:
      return launch<T, kZeros>(blocks, s, values, C, D, sl, fr, hi, lo, n, a,
                               b, mix1, mix2);
    case kConstant:
      return launch<T, kConstant>(blocks, s, values, C, D, sl, fr, hi, lo, n,
                                  a, b, mix1, mix2);
    case kUniform:
      return launch<T, kUniform>(blocks, s, values, C, D, sl, fr, hi, lo, n,
                                 a, b, mix1, mix2);
    case kNormal:
      return launch<T, kNormal>(blocks, s, values, C, D, sl, fr, hi, lo, n, a,
                                b, mix1, mix2);
    default:
      return launch<T, kTruncatedNormal>(blocks, s, values, C, D, sl, fr, hi,
                                         lo, n, a, b, mix1, mix2);
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
  // A block's elements (at most kThreads rows of D) index an int.
  if (C < 0 || D < 1 || D > (1 << 20) || kind < kZeros ||
      kind > kTruncatedNormal)
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
  const auto g = static_cast<unsigned>(blocks);
  const auto d = static_cast<int32_t>(D);
  if (esize == 4) {
    launch_kind(k, g, s, static_cast<float*>(values), C, d, sl, fr, hi, lo, n,
                a, b, mix1, mix2);
  } else if (esize == 2) {
    launch_kind(k, g, s, static_cast<__nv_bfloat16*>(values), C, d, sl, fr,
                hi, lo, n, a, b, mix1, mix2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
