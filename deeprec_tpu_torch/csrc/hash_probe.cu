// Hash-table probe, insert claim and key write for Hopper (P1).
//
// Replaces the XLA while_loops of deeprec_tpu/embedding/hash_table.py
// `find` (:256) and `find_or_insert` (:311); the JAX package has no
// Pallas kernel for them. Every round runs on the card: nothing is read
// back to the host between rounds, and no launch depends on a value of
// the device.
//
// Table layout (embedding/hash_table.py): key_rows is [n_rows, 2W]
// int32 with W = min(64, capacity) a power of two; slot s holds its
// key's hi half at flat index 2s and its lo half at 2s+1. EMPTY is
// (INT32_MIN, 0), TOMBSTONE (INT32_MIN, 1). An id starts probing at its
// hash bucket rounded down to its W-row. Slot `capacity` means none.
//
// Semantics (bit-exact with the plain version in hash_table.py):
//   * a scan of rows r0 .. r0+R-1 (row-granular wraparound) reports the
//     first slot holding the id, the first EMPTY-or-TOMBSTONE slot, and
//     (first row only) whether an EMPTY was seen;
//   * find: one bucket-row scan per id; an id neither found nor proved
//     absent by an EMPTY, in a table of more than one row, takes the
//     R-row wide scan. find writes nothing, so the plain version's
//     compacted rounds return what one wide scan of each such id does;
//   * find_or_insert, fast round: every id scans its bucket row; an id
//     that wants to insert, was not found, saw an EMPTY and has a
//     reusable slot claims it; the lowest batch index among the
//     claimants of a slot wins (an atomicMin on a claim buffer) and
//     writes its key. Lookup-only ids whose row proved absence are done;
//   * straggler rounds, in order, while ids are pending and the round
//     count (the fast round counts 1) is below max_rounds: the first M
//     pending ids in ascending index order wide-scan the keys as the
//     previous round left them; hits resolve; claims resolve as above
//     (lowest original index wins); the winners write their keys; the
//     hits, the winners and the lookup-only ids are done. Ids still
//     pending at the cap keep slot = capacity.
//
// Dead ids, and why skipping them is exact. Call a pending id dead when
// it wants to insert and its wide window holds neither its key nor an
// EMPTY or TOMBSTONE slot. Inside one call keys are only written into
// EMPTY or TOMBSTONE slots and never removed, so a dead id's window
// stays full of other keys: its own key could only be written there
// (an id's window is a function of its key), and there is no free slot
// to write it into. So a dead id
//   (a) stays dead until the round cap, keeps its place in the pending
//       list and scans to the same answer every round: its rescan can
//       be skipped, as long as it stays in the list and counts toward
//       the M ids a round takes;
//   (b) if every id of a round's window is dead, the round resolves
//       nothing, claims nothing and writes nothing, so the next round
//       takes the same window, all dead again, and so on to the cap:
//       the call may stop there with the result the cap would give.
// Dropping dead ids from the list instead would let live ids behind
// them into windows the plain version never gives them: not exact. A
// claim loser is not dead: it had a reusable slot.
//
// What bounds it: bytes and latency. A call reads the key rows its ids'
// windows touch (512 bytes a row at W = 64; at most the whole key array)
// and the ids, and writes the slots: a memory-bound gather. The
// straggler rounds are a chain of dependent rounds, so their time is
// the latency of each round's loads and barriers times the round count.
//
// Design:
//   * find and the fast round: a warp per id. Lane l reads slots 2l and
//     2l+1 of a row (one 512-byte row per warp load); __ballot_sync of
//     the match, EMPTY and reusable bits gives the first offset of each
//     from the lowest set lane. find continues with the wide scan in
//     the same launch; the next row's load is issued before the current
//     row's ballots.
//   * the fast round's claims resolve in a second launch (a thread per
//     id), which also marks the ids left pending and counts them.
//   * the straggler rounds run in ONE cooperative launch whose grid is
//     as large as the round's window needs (a warp per window entry),
//     at most the blocks that fit on the card at once. Its phases are
//     separated by grid barriers (cooperative_groups grid sync): list
//     build | scan | claim and key write | compaction, three barriers a
//     round. It exits at once when the fast round left nothing pending.
//     The pending list (ascending ids) lives in global scratch: a round
//     takes its first M entries, a warp scanning each; block b resolves
//     the claims of a contiguous share of the window and counts the
//     entries it keeps; the blocks' counts, summed by every block, give
//     each share its place, and the kept entries are compacted, in
//     order, in front of the untouched rest, so the list stays
//     ascending without a copy of its tail. A dead id carries the sign
//     bit in the list and is never scanned again; a window of dead ids
//     only ends the call (rule (b)). Keys, claims and the list are
//     written during the kernel and read through L2 (__ldcg), never the
//     read-only path or L1, which other SMs' writes do not reach.
//   * scratch gets the rounds run (the fast round counts 1), for tools.
//   * the claim buffer ([capacity + 1] int32, INT32_MAX where free)
//     persists across calls: the winner of each claimed entry resets it,
//     so no buffer of the table's size is filled per call.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kEmptyHi = INT32_MIN;
constexpr int32_t kEmptyLo = 0;
constexpr int32_t kTombLo = 1;
constexpr int32_t kFree = INT32_MAX;  // an unclaimed claim-buffer entry
constexpr int32_t kDeadBit = INT32_MIN;  // a dead id in the pending list
constexpr unsigned kFull = 0xffffffffu;

constexpr int kProbeWarps = 8;         // warps a block, warp-per-id kernels
constexpr int kResolveThreads = 256;
constexpr int kRoundThreads = 512;     // a block of the straggler grid
constexpr int kRoundWarps = kRoundThreads / 32;
constexpr int kMaxGrid = 1024;         // straggler blocks at most (scratch)
constexpr int kListPerThread = 8;      // ids a thread, pending-list build
constexpr int kMaxDevices = 64;

// Codes of a straggler window entry after its scan.
constexpr int32_t kDone = 0;
constexpr int32_t kDead = 1;
constexpr int32_t kClaim = 2;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// First row of an id's probe window: keys.bucket_of (salt 0) rounded
// down to its W-row.
__device__ __forceinline__ int32_t start_row(int32_t hi, int32_t lo,
                                             int32_t capacity, int32_t W) {
  const uint32_t h = fmix32(static_cast<uint32_t>(lo) ^
                            (static_cast<uint32_t>(hi) * 0x9E3779B9u));
  return static_cast<int32_t>(h & static_cast<uint32_t>(capacity - W)) / W;
}

struct Scan {
  int32_t found;   // first slot holding the id, -1 if none
  int32_t reuse;   // first EMPTY or TOMBSTONE slot, -1 if none
  bool saw_empty;  // an EMPTY in the first row
};

// Offset in a row of the first set bit, lane l holding slots 2l (bit l
// of b0) and 2l+1 (bit l of b1); b0 | b1 must be non-zero.
__device__ __forceinline__ int32_t first_offset(unsigned b0, unsigned b1) {
  const int lane = __ffs(b0 | b1) - 1;
  return 2 * lane + (((b0 >> lane) & 1u) ? 0 : 1);
}

template <bool kCoherent>
__device__ __forceinline__ int2 load_slot(const int32_t* p) {
  if (kCoherent) return __ldcg(reinterpret_cast<const int2*>(p));
  return __ldg(reinterpret_cast<const int2*>(p));
}

// The lane's two slots of row `row` (EMPTY beyond W).
template <bool kCoherent>
__device__ __forceinline__ void load_row(const int32_t* key_rows, int32_t row,
                                         int32_t W, int lane, int2 kv[2]) {
  const int32_t* base = key_rows + 2 * static_cast<int64_t>(row) * W;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int32_t w = 2 * lane + q;
    kv[q] = w < W ? load_slot<kCoherent>(base + 2 * w)
                  : make_int2(0, kEmptyLo);  // neither a match nor a sentinel
  }
}

// Scan rows r0 .. r0+R-1 (mod n_rows; r0 < n_rows, R <= n_rows) for
// (hi, lo); the whole warp calls it. Stops at the first row with a
// match: the reusable slot only matters for an id not found. The next
// row's slots are loaded before this row's are tested.
template <bool kCoherent>
__device__ Scan scan_rows(const int32_t* key_rows, int32_t n_rows, int32_t W,
                          int32_t r0, int32_t R, int32_t hi, int32_t lo,
                          int lane) {
  Scan s{-1, -1, false};
  int2 cur[2], nxt[2];
  load_row<kCoherent>(key_rows, r0, W, lane, cur);
  for (int32_t k = 0; k < R; ++k) {
    int32_t row = r0 + k;
    if (row >= n_rows) row -= n_rows;
    if (k + 1 < R) {
      const int32_t next = row + 1 == n_rows ? 0 : row + 1;
      load_row<kCoherent>(key_rows, next, W, lane, nxt);
    }
    bool m[2], r[2], e[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int2 kv = cur[q];
      const bool sent = kv.x == kEmptyHi;
      m[q] = 2 * lane + q < W && kv.x == hi && kv.y == lo;
      e[q] = sent && kv.y == kEmptyLo;
      r[q] = e[q] || (sent && kv.y == kTombLo);
    }
    const unsigned m0 = __ballot_sync(kFull, m[0]);
    const unsigned m1 = __ballot_sync(kFull, m[1]);
    const unsigned r0b = __ballot_sync(kFull, r[0]);
    const unsigned r1b = __ballot_sync(kFull, r[1]);
    const unsigned eb = __ballot_sync(kFull, e[0] || e[1]);
    if (k == 0) s.saw_empty = eb != 0u;
    if (s.reuse < 0 && (r0b | r1b)) s.reuse = row * W + first_offset(r0b, r1b);
    if (m0 | m1) {
      s.found = row * W + first_offset(m0, m1);
      break;
    }
    cur[0] = nxt[0];
    cur[1] = nxt[1];
  }
  return s;
}

__global__ void __launch_bounds__(kProbeWarps * 32)
find_kernel(const int32_t* __restrict__ key_rows, int32_t n_rows, int32_t W,
            const int32_t* __restrict__ qhi, const int32_t* __restrict__ qlo,
            int64_t n, int32_t R, int32_t* __restrict__ slots) {
  const int lane = threadIdx.x & 31;
  const int32_t capacity = n_rows * W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kProbeWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kProbeWarps +
                   (threadIdx.x >> 5);
       i < n; i += stride) {
    const int32_t hi = qhi[i], lo = qlo[i];
    int32_t slot = capacity;
    if (hi != kEmptyHi) {  // EMPTY-sentinel ids (padding) are never found
      const int32_t r0 = start_row(hi, lo, capacity, W);
      const Scan s =
          scan_rows<false>(key_rows, n_rows, W, r0, 1, hi, lo, lane);
      if (s.found >= 0) {
        slot = s.found;
      } else if (n_rows > 1 && !s.saw_empty && R > 1) {
        // The wide window's first row is the one just scanned.
        const int32_t r1 = r0 + 1 == n_rows ? 0 : r0 + 1;
        const Scan w =
            scan_rows<false>(key_rows, n_rows, W, r1, R - 1, hi, lo, lane);
        if (w.found >= 0) slot = w.found;
      }
    }
    if (lane == 0) slots[i] = slot;
  }
}

// Fast round, scan and claim: a warp per id. Counts itself as round 1.
__global__ void __launch_bounds__(kProbeWarps * 32)
fast_kernel(const int32_t* __restrict__ key_rows, int32_t n_rows, int32_t W,
            const int32_t* __restrict__ qhi, const int32_t* __restrict__ qlo,
            const bool* __restrict__ mask, int64_t n, int32_t* claim,
            int32_t* __restrict__ slots, bool* __restrict__ is_new,
            int32_t* __restrict__ prop, int32_t* __restrict__ pend,
            int32_t* __restrict__ rounds) {
  const int lane = threadIdx.x & 31;
  const int32_t capacity = n_rows * W;
  if (blockIdx.x == 0 && threadIdx.x == 0) *rounds = 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kProbeWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kProbeWarps +
                   (threadIdx.x >> 5);
       i < n; i += stride) {
    const int32_t hi = qhi[i], lo = qlo[i];
    int32_t slot = capacity, p = -1;
    bool pending = false;
    if (hi != kEmptyHi) {
      const int32_t r0 = start_row(hi, lo, capacity, W);
      const Scan s =
          scan_rows<false>(key_rows, n_rows, W, r0, 1, hi, lo, lane);
      if (s.found >= 0) {
        slot = s.found;
      } else {
        const bool wants = mask[i];
        // A claim needs an EMPTY in the row: a tombstone alone is no
        // proof that the id is not further on.
        if (wants && s.saw_empty && s.reuse >= 0) p = s.reuse;
        pending = wants || !s.saw_empty;  // unless its claim wins
      }
    }
    if (lane == 0) {
      slots[i] = slot;
      is_new[i] = false;
      prop[i] = p;
      pend[i] = pending;
      if (p >= 0) atomicMin(claim + p, static_cast<int32_t>(i));
    }
  }
}

// Fast round, resolve: a thread per id. The winner of a slot writes its
// key and frees the claim entry (a loser that reads it afterwards sees
// kFree, not its own index, and still loses). Counts the ids left
// pending.
__global__ void __launch_bounds__(kResolveThreads)
resolve_kernel(int32_t* __restrict__ key_rows, const int32_t* __restrict__ qhi,
               const int32_t* __restrict__ qlo, int64_t n, int32_t* claim,
               int32_t* __restrict__ slots, bool* __restrict__ is_new,
               const int32_t* __restrict__ prop, int32_t* __restrict__ pend,
               int32_t* __restrict__ n_pending) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kResolveThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kResolveThreads;
       base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool left = false;
    if (i < n) {
      const int32_t p = prop[i];
      bool won = false;
      if (p >= 0 && claim[p] == static_cast<int32_t>(i)) {
        won = true;
        key_rows[2 * static_cast<int64_t>(p)] = qhi[i];
        key_rows[2 * static_cast<int64_t>(p) + 1] = qlo[i];
        slots[i] = p;
        is_new[i] = true;
        claim[p] = kFree;
      }
      left = pend[i] && !won;
      pend[i] = left;
    }
    const unsigned b = __ballot_sync(kFull, left);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(n_pending, __popc(b));
  }
}

// Exclusive prefix sum of v over the block (kRoundThreads threads, all
// of which must call it); *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kRoundWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kRoundWarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kRoundWarps - 1];
  const int off = (warp ? s_warp[warp - 1] : 0) + x - v;
  __syncthreads();  // s_warp is reused by the next call
  return off;
}

// Sums of v's three fields over the block, returned to every thread
// (all kRoundThreads threads must call it).
__device__ __forceinline__ int3 block_sum3(int3 v, int3* s_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v.x = __reduce_add_sync(kFull, v.x);
  v.y = __reduce_add_sync(kFull, v.y);
  v.z = __reduce_add_sync(kFull, v.z);
  if (lane == 0) s_part[warp] = v;
  __syncthreads();
  int3 t = make_int3(0, 0, 0);
#pragma unroll
  for (int w = 0; w < kRoundWarps; ++w) {
    t.x += s_part[w].x;
    t.y += s_part[w].y;
    t.z += s_part[w].z;
  }
  __syncthreads();  // s_part is reused by the next call
  return t;
}

// Over blk[0, G) and blk[G, 2G) (written by the grid before a barrier):
// (sum of blk[i] for i < b, sum of blk[0, G), sum of blk[G, 2G)).
__device__ __forceinline__ int3 grid_counts(const int32_t* blk, int G, int b,
                                            bool second, int3* s_part) {
  int3 p = make_int3(0, 0, 0);
  for (int i = threadIdx.x; i < G; i += kRoundThreads) {
    const int k = __ldcg(blk + i);
    p.x += i < b ? k : 0;
    p.y += k;
    if (second) p.z += __ldcg(blk + G + i);
  }
  return block_sum3(p, s_part);
}

// Straggler rounds: a cooperative grid. plist holds the pending ids
// (ascending; a dead one with kDeadBit set); win, code and wprop hold a
// round's window of at most M entries; blk holds 2 counts a block.
__global__ void __launch_bounds__(kRoundThreads)
round_kernel(int32_t* key_rows, int32_t n_rows, int32_t W,
             const int32_t* __restrict__ qhi, const int32_t* __restrict__ qlo,
             const bool* __restrict__ mask, int64_t n, int32_t R, int32_t M,
             int32_t max_rounds, int32_t* claim, int32_t* slots, bool* is_new,
             const int32_t* pend, const int32_t* n_pending, int32_t* plist,
             int32_t* win, int32_t* code, int32_t* wprop, int32_t* blk,
             int32_t* rounds) {
  __shared__ int s_warp[kRoundWarps];
  __shared__ int3 s_part[kRoundWarps];
  if (__ldcg(n_pending) == 0) return;  // rounds stays 1 (fast_kernel)
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int32_t capacity = n_rows * W;

  // The pending ids in ascending order: block b lists those of its
  // share [lo, hi) of the batch, after the shares of blocks before it.
  const int64_t share = (n + G - 1) / G;
  const int64_t lo = b * share < n ? b * share : n;
  const int64_t hi = lo + share < n ? lo + share : n;
  int mine = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kRoundThreads)
    mine += pend[i] != 0;
  const int3 own = block_sum3(make_int3(mine, 0, 0), s_part);
  if (threadIdx.x == 0) blk[b] = own.x;
  grid.sync();
  const int3 listed = grid_counts(blk, G, b, false, s_part);
  int count = listed.y;
  int pos0 = listed.x;
  for (int64_t base = lo; base < hi;
       base += static_cast<int64_t>(kRoundThreads) * kListPerThread) {
    const int64_t i0 =
        base + static_cast<int64_t>(threadIdx.x) * kListPerThread;
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kListPerThread; ++k)
      if (i0 + k < hi && pend[i0 + k]) bits |= 1u << k;
    int total;
    int pos = pos0 + block_scan(__popc(bits), s_warp, &total);
#pragma unroll
    for (int k = 0; k < kListPerThread; ++k)
      if ((bits >> k) & 1u) plist[pos++] = static_cast<int32_t>(i0 + k);
    pos0 += total;
  }
  grid.sync();

  const int gwarp = b * kRoundWarps + (threadIdx.x >> 5);
  const int nwarps = G * kRoundWarps;
  int head = 0;
  int32_t r = 1;
  while (r < max_rounds && count > 0) {
    const int m = count < M ? count : M;
    // Scan: a warp per window entry, against the keys the last round
    // left; a dead entry keeps its answer without a scan (rule (a)).
    for (int j = gwarp; j < m; j += nwarps) {
      const int32_t e = __ldcg(plist + head + j);
      int32_t c = kDead, out = e;
      if (e >= 0) {
        const int32_t qh = qhi[e], ql = qlo[e];
        const Scan s = scan_rows<true>(key_rows, n_rows, W,
                                       start_row(qh, ql, capacity, W), R, qh,
                                       ql, lane);
        c = kDone;  // found, or lookup-only and absent
        if (s.found >= 0) {
          if (lane == 0) slots[e] = s.found;
        } else if (mask[e]) {
          if (s.reuse >= 0) {
            c = kClaim;
            if (lane == 0) {
              wprop[j] = s.reuse;
              atomicMin(claim + s.reuse, e);
            }
          } else {
            c = kDead;  // no reusable slot in the window
            out = e | kDeadBit;
          }
        }
      }
      if (lane == 0) {
        win[j] = out;
        code[j] = c;
      }
    }
    grid.sync();
    // Claims of block b's share [wl, wh) of the window: the lowest
    // original index wins; winners write their keys. Counts the entries
    // kept (dead ones and claim losers) and those not dead.
    const int wshare = (m + G - 1) / G;
    const int wl = b * wshare < m ? b * wshare : m;
    const int wh = wl + wshare < m ? wl + wshare : m;
    int kept = 0, alive = 0;
    for (int j = wl + threadIdx.x; j < wh; j += kRoundThreads) {
      const int32_t c = __ldcg(code + j);
      bool keep = c == kDead;
      if (c == kClaim) {
        const int32_t p = __ldcg(wprop + j), idx = __ldcg(win + j);
        if (__ldcg(claim + p) == idx) {
          key_rows[2 * static_cast<int64_t>(p)] = qhi[idx];
          key_rows[2 * static_cast<int64_t>(p) + 1] = qlo[idx];
          slots[idx] = p;
          is_new[idx] = true;
          atomicExch(claim + p, kFree);
        } else {
          keep = true;
        }
      }
      code[j] = keep;
      kept += keep;
      alive += c != kDead;
    }
    const int3 t = block_sum3(make_int3(kept, alive, 0), s_part);
    if (threadIdx.x == 0) {
      blk[b] = t.x;
      blk[G + b] = t.y;
    }
    grid.sync();
    const int3 tot = grid_counts(blk, G, b, true, s_part);
    ++r;
    if (tot.z == 0) break;  // every entry dead: rule (b), nothing changes
    // The kept entries, in order, go right before the untouched rest.
    const int dst = head + m - tot.y;
    int done = tot.x;
    for (int base = wl; base < wh; base += kRoundThreads) {
      const int j = base + threadIdx.x;
      const int f = j < wh ? __ldcg(code + j) : 0;
      int total;
      const int off = block_scan(f, s_warp, &total);
      if (f) plist[dst + done + off] = __ldcg(win + j);
      done += total;
    }
    head = dst;
    count -= m - tot.y;
    grid.sync();
  }
  if (b == 0 && threadIdx.x == 0) *rounds = r;
}

int blocks_for(int64_t items, int64_t per_block) {
  const int64_t b = (items + per_block - 1) / per_block;
  return static_cast<int>(b < 65535 ? b : 65535);
}

// Blocks of round_kernel that fit on the current device at once,
// queried once per device (no synchronisation).
cudaError_t resident_round_blocks(int* out) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = cache[dev].load();
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, round_kernel, kRoundThreads, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * per_sm;
    if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev].store(blocks);
  }
  *out = blocks;
  return cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of its
// launches (0: all queued). Nothing is synchronised.
//
// find: slots[n] for ids (qhi, qlo)[n]; R rows in the wide window.
extern "C" int deeprec_probe_find(const void* key_rows, int64_t n_rows,
                                  int64_t W, const void* qhi, const void* qlo,
                                  int64_t n, int64_t R, void* slots,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_rows < 1 || W < 1 || W > 64 || (W & (W - 1)) || R < 1 || R > n_rows ||
      n_rows * W > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  find_kernel<<<blocks_for(n, kProbeWarps), kProbeWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key_rows), static_cast<int32_t>(n_rows),
      static_cast<int32_t>(W), static_cast<const int32_t*>(qhi),
      static_cast<const int32_t*>(qlo), n, static_cast<int32_t>(R),
      static_cast<int32_t*>(slots));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the straggler grid at most: the scratch of an insert holds
// 2 counts for each (hash_probe.py's GRID_MAX).
extern "C" int deeprec_probe_grid_max() { return kMaxGrid; }

// find_or_insert: slots[n] and is_new[n] for ids (qhi, qlo)[n] with
// insert mask[n]; keys written into key_rows in place. claim is the
// persistent [capacity + 1] int32 buffer, kFree where free (left so).
// scratch holds 3n + 3M + 2 + 2 * kMaxGrid int32; its int32 at
// 3n + 3M + 1 gets the rounds run, the fast round counting 1. M:
// straggler budget; max_rounds counts the fast round.
extern "C" int deeprec_probe_insert(void* key_rows, int64_t n_rows, int64_t W,
                                    const void* qhi, const void* qlo,
                                    const void* mask, int64_t n, int64_t R,
                                    int64_t M, int64_t max_rounds, void* claim,
                                    void* slots, void* is_new, void* scratch,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_rows < 1 || W < 1 || W > 64 || (W & (W - 1)) || R < 1 || R > n_rows ||
      n_rows * W > INT32_MAX || n > INT32_MAX || M < 1 || M > n)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto kr = static_cast<int32_t*>(key_rows);
  auto hi = static_cast<const int32_t*>(qhi);
  auto lo = static_cast<const int32_t*>(qlo);
  auto mk = static_cast<const bool*>(mask);
  auto cl = static_cast<int32_t*>(claim);
  auto sl = static_cast<int32_t*>(slots);
  auto nw = static_cast<bool*>(is_new);
  auto sc = static_cast<int32_t*>(scratch);
  int32_t* prop = sc;
  int32_t* pend = sc + n;
  int32_t* plist = sc + 2 * n;
  int32_t* win = sc + 3 * n;
  int32_t* code = win + M;
  int32_t* wprop = code + M;
  int32_t* n_pending = wprop + M;
  int32_t* rounds = n_pending + 1;
  int32_t* blk = rounds + 1;
  const auto nr = static_cast<int32_t>(n_rows);
  const auto w = static_cast<int32_t>(W);
  cudaError_t err = cudaMemsetAsync(n_pending, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fast_kernel<<<blocks_for(n, kProbeWarps), kProbeWarps * 32, 0, s>>>(
      kr, nr, w, hi, lo, mk, n, cl, sl, nw, prop, pend, rounds);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  resolve_kernel<<<blocks_for(n, kResolveThreads), kResolveThreads, 0, s>>>(
      kr, hi, lo, n, cl, sl, nw, prop, pend, n_pending);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (max_rounds <= 1) return static_cast<int>(cudaSuccess);
  // A warp per entry of the largest window, within what fits at once.
  int grid = 0;
  if ((err = resident_round_blocks(&grid)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t need = (M + kRoundWarps - 1) / kRoundWarps;
  if (need < grid) grid = static_cast<int>(need);
  if (grid > kMaxGrid) grid = kMaxGrid;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kRoundThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, round_kernel, kr, nr, w, hi, lo, mk, n, static_cast<int32_t>(R),
      static_cast<int32_t>(M),
      static_cast<int32_t>(max_rounds < INT32_MAX ? max_rounds : INT32_MAX),
      cl, sl, nw, static_cast<const int32_t*>(pend),
      static_cast<const int32_t*>(n_pending), plist, win, code, wprop, blk,
      rounds);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
