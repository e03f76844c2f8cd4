// Segment-search kernel for Hopper (sm_90a): the whole segment loop of
// one segment stream in one warp.
//
// Replaces comdb2_tpu/checker/pallas_seg.py `_build_kernel` (the fused
// Pallas TPU kernel), in both its modes: one history per stream, and the
// RESET stream mode that checks many histories in one stream. The
// function is the same — see comdb2_tpu_torch/checker/seg_kernel.py for
// the semantics and its plain PyTorch version `seg_search_reference`.
// The TPU kernel's sequential grid of 1024-segment chunks, its (8|16,
// 128) vreg rows, its row-broadcast table gather and its VMEM-resident
// (b_pad, 128) results tile were Mosaic limits and are not reproduced.
//
// What bounds it: neither bytes (a few hundred KB per stream, read once)
// nor arithmetic, but the serial chain segment x closure iteration and
// the latency of each step in it. So one WARP owns one stream, and the
// chain synchronises with shuffles and __syncwarp only — no block barrier
// after the successor table is loaded:
//
// - The CTA's warps share one copy of the successor table in shared
//   memory; each warp keeps its frontier (<= 128 keys, W words each,
//   sorted ascending) in its own slice of shared memory.
// - A closure iteration does not sort its m = n (P + 1) keys. After the
//   previous segment's fixed point, the only configs a step can add are
//   expansions through newly invoked slots: a handful against m. So each
//   lane expands 4 candidates at a time and looks each up in the sorted
//   frontier with a binary search; one __ballot_sync + __popc per
//   candidate packs the new ones into the warp's buffer. None new: a
//   fixed point, no sort at all.
// - The new keys (<= 256) sort in registers, R = 1, 2, 4 or 8 per lane in
//   blocked order (key i in lane i / R, slot i % R): a bitonic network
//   compare-exchanges within a lane for partner distance < R and through
//   __shfl_xor_sync for distance >= R; duplicates are found against the
//   predecessor (in the lane, or by __shfl_up_sync); positions come from
//   ballots. Every new key and every frontier key then lands at its index
//   plus its rank in the other list (a binary search): the merged union,
//   of which the first 128 are kept, as a sort would keep them.
// - Rarer iterations with more than 256 new candidates sort the union in
//   shared memory, the warp's 32 lanes walking the network with
//   __syncwarp between stages: M = 512 keys in the warp's own buffer, M
//   of 1024 or 2048 (up to next_pow2(128 (P+1))) in one buffer of the
//   CTA, taken under a lock. It is exact and stays in the kernel.
// - Segment rows are staged ahead of use into a per-warp double-buffered
//   ring of RING rows with cp.async, so the head of a segment reads
//   shared memory, not HBM.
// - What a lane decides alone is branch-free; the stage loops are
//   run-time loops, so the code fits the instruction cache.
//
// Shared memory per warp (the frontier, the 512-key buffer and the row
// ring) and registers bound the warp streams an SM holds;
// seg_search_occupancy reports the count. Building with -DSEG_PROFILE
// adds per-phase clock64() counters for stream 0, read back by
// seg_search_profile (scripts/torch_seg_profile.py, which also times
// builds with RING, WARP_KEYS or MIN_CTAS set by -D).
//
// Two optional per-stream counts: `work`, the comparisons the plain
// version counts (sorting and deduplicating all n (P+1) keys of every
// closure iteration), held equal to it as a parity check; and `need`,
// the comparisons the closures need at the least, the roofline bound's
// operation count (see `nd` in the kernel).
//
// Stream mode (results != NULL): a row with ok_proc == RESET (-2) ends
// one history and starts the next. If the history counter is >= 0 it
// writes (status, fail, n) to results[stream][counter]; then the counter
// advances, the frontier is re-seeded with the root key and the status
// resets to (VALID, -1, 1). A history that is INVALID or UNKNOWN skips
// to the next RESET, so it never stops the histories after it.
//
// Keys are W int32 words, word 0 least significant, compared as signed
// ints from the top word down; invalid keys hold the sentinel 1<<30 in
// the top word. Field arithmetic (adding negative deltas shifted into
// place) is done in uint32_t: a left shift of a negative int is undefined
// before C++20.

#include <cuda_runtime.h>
#include <stdint.h>

#define F_CAP 128
#define LANES 128
#define WARP 32
#define MAX_WARPS 8           // warp-streams per CTA
#ifndef RING
#define RING 16               // segment rows per prefetch stage
#endif
#ifndef MIN_CTAS
#define MIN_CTAS 1            // __launch_bounds__' CTAs per SM
#endif
#define SENT_HI (1 << 30)
#define MAX_P 15
#define MAX_W 3
#define MAX_K 8
#define MAX_KEYS 2048
#define MAX_TABLE 8192
#define REG_KEYS 256          // the most new keys merged from registers
#ifndef WARP_KEYS
#define WARP_KEYS 512         // the warp's buffer, in keys (>= REG_KEYS + F_CAP)
#endif
#define FULL 0xffffffffu

#define ST_VALID 0
#define ST_INVALID 1
#define ST_UNKNOWN 2
#define RESET (-2)

extern "C" {
struct SegLayout {
  int P, K, W;
  int slot_bits, state_bits;
  int state_word, state_shift;
  int n_keys;                 // the largest closure, a power of two
  int slot_word[16];
  int slot_shift[16];
  int root[4];                // the empty config's words (RESET re-seed)
};
}

#ifdef SEG_PROFILE
__device__ unsigned long long g_prof[32];
#define PROF_T0(v) long long v = clock64()
#define PROF_ADD(slot, v)                                        \
  if (lane == 0 && b == 0) {                                     \
    atomicAdd(&g_prof[slot], (unsigned long long)(clock64() - v)); \
    atomicAdd(&g_prof[(slot) + 16], 1ull);                       \
  }
#else
#define PROF_T0(v)
#define PROF_ADD(slot, v)
#endif

// --- keys of W words in registers ------------------------------------------
//
// Everything a lane decides on its own is branch-free (bitwise & and | on
// predicates, selects): a short-circuit || or a ternary between two
// comparisons compiles to divergent branches, which a lone warp pays for
// at every compare-exchange.

template <int W>
__device__ __forceinline__ bool key_less(const int (&a)[W], const int (&b)[W]) {
  bool lt = a[0] < b[0];
#pragma unroll
  for (int w = 1; w < W; ++w) lt = (a[w] < b[w]) | ((a[w] == b[w]) & lt);
  return lt;
}

template <int W>
__device__ __forceinline__ bool key_eq(const int (&a)[W], const int (&b)[W]) {
  bool eq = a[0] == b[0];
#pragma unroll
  for (int w = 1; w < W; ++w) eq = eq & (a[w] == b[w]);
  return eq;
}

// k[idx] without indexing a register array at run time
template <int W>
__device__ __forceinline__ int pick(const int (&k)[W], int idx) {
  int v = k[0];
#pragma unroll
  for (int w = 1; w < W; ++w)
    if (idx == w) v = k[w];
  return v;
}

template <int W>
__device__ __forceinline__ void add_at(int (&k)[W], int idx, uint32_t d) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    k[w] = (int)((uint32_t)k[w] + (idx == w ? d : 0u));
}

template <int W>
__device__ __forceinline__ void set_sentinel(int (&k)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) k[w] = w == W - 1 ? SENT_HI : 0;
}

template <int W>
__device__ __forceinline__ void load_key(int (&k)[W], const int* buf,
                                         int cap, int i) {
#pragma unroll
  for (int w = 0; w < W; ++w) k[w] = buf[w * cap + i];
}

template <int W>
__device__ __forceinline__ void store_key(int* buf, int cap, int i,
                                          const int (&k)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) buf[w * cap + i] = k[w];
}

// --- one warp's read-only search context -----------------------------------

struct Ctx {
  const int* table;
  int table_n, stride, P;
  unsigned long long magic;   // c / P == (c * magic) >> 32 for c < 2^16
  int state_word, state_shift;
  uint32_t state_mask, slot_mask;
  const int* slot_word;       // shared copies of the layout
  const int* slot_shift;
};

// Candidate e of a closure over the frontier fr[0, n): e < n is the
// frontier itself; e in [n, total) expands config f = (e - n) / P through
// slot q = (e - n) % P; a dropped candidate or e >= total is a sentinel.
template <int W>
__device__ __forceinline__ void candidate(const Ctx& c, const int* fr, int n,
                                          int total, int e, int (&k)[W]) {
  const bool own = e < n;
  const int cc = own ? 0 : e - n;
  const int f0 = (int)(((unsigned long long)cc * c.magic) >> 32);
  const int q = cc - f0 * c.P;
  load_key<W>(k, fr, LANES, own ? e : min(f0, LANES - 1));
  const int sw = c.slot_word[q], ssh = c.slot_shift[q];
  const int s = (int)(((uint32_t)pick<W>(k, c.state_word) >> c.state_shift) &
                      c.state_mask);
  const int tq = (int)(((uint32_t)pick<W>(k, sw) >> ssh) & c.slot_mask);
  const int idx = s * c.stride + (tq - 2);
  const bool in_table = (tq >= 2) & (idx < c.table_n);
  const int s2 = c.table[in_table ? idx : 0];
  const bool grow = !own & (e < total) & in_table & (s2 >= 0);
  add_at<W>(k, sw, grow ? (uint32_t)(-tq) << ssh : 0u);
  add_at<W>(k, c.state_word, grow ? (uint32_t)(s2 - s) << c.state_shift : 0u);
  const bool valid = own | grow;
#pragma unroll
  for (int w = 0; w < W; ++w)
    k[w] = valid ? k[w] : (w == W - 1 ? SENT_HI : 0);
}

// pos[u] = the keys of the sorted buf[0, len) (stride cap) below k[u],
// for N keys at once: a fixed number of halving steps, the same for every
// lane, each step's N loads independent of each other.
template <int W, int N>
__device__ __forceinline__ void lower_bound(const int* buf, int cap, int len,
                                            const int (&k)[N][W],
                                            int (&pos)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) pos[u] = 0;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int cand = pos[u] + step;
      int m[W];
      load_key<W>(m, buf, cap, min(cand, len) - 1);
      pos[u] = (cand <= len) & key_less<W>(m, k[u]) ? cand : pos[u];
    }
  }
}

// Output positions of the kept elements, blocked order (element i =
// lane * R + r): one ballot per slot counts the kept elements of the
// lanes before this one. Returns the warp's total.
template <int R>
__device__ __forceinline__ int warp_positions(const bool (&keep)[R],
                                              int (&pos)[R], int lane) {
  const uint32_t lt = (1u << lane) - 1u;
  int before = 0, total = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t b = __ballot_sync(FULL, keep[r]);
    before += __popc(b & lt);
    total += __popc(b);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pos[r] = before;
    before += keep[r];
  }
  return total;
}

// One compare-exchange of a bitonic stage whose partner sits in another
// lane: the lower index keeps the min when the run ascends.
template <int W>
__device__ __forceinline__ void cx_shfl(int (&k)[W], int lane_mask,
                                        bool keep_min) {
  int o[W];
#pragma unroll
  for (int w = 0; w < W; ++w) o[w] = __shfl_xor_sync(FULL, k[w], lane_mask);
  const bool take = (keep_min & key_less<W>(o, k)) |
                    (!keep_min & key_less<W>(k, o));
#pragma unroll
  for (int w = 0; w < W; ++w) k[w] = take ? o[w] : k[w];
}

// One stage of partner distance j < R: every pair sits within a lane.
template <int W, int R, int J>
__device__ __forceinline__ void cx_lane(int (&k)[R][W], int lane, int a) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((r & J) == 0) {
      const bool asc = (((lane * R + r) >> a) & 1) == 0;
      const bool swap = key_less<W>(k[r | J], k[r]) == asc;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int x = k[r][w], y = k[r | J][w];
        k[r][w] = swap ? y : x;
        k[r | J][w] = swap ? x : y;
      }
    }
  }
}

// Ascending bitonic sort of the warp's 32 * R register keys, blocked:
// the stages of the first 2^logm keys (all 32 R, or for R = 1 those of
// the first M lanes: the keys past them are sentinels). The stages are a
// run-time loop, only the loop over a lane's keys is unrolled, so the
// code stays small enough for the instruction cache.
template <int W, int R>
__device__ __forceinline__ void warp_sort(int (&k)[R][W], int lane,
                                          int logm) {
  constexpr int LOGR = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : 3;
#pragma unroll 1
  for (int a = 1; a <= logm; ++a) {
#pragma unroll 1
    for (int j = 1 << (a - 1); j > 0; j >>= 1) {
      if (j >= R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = lane * R + r;
          cx_shfl<W>(k[r], j >> LOGR,
                     ((i & j) == 0) == (((i >> a) & 1) == 0));
        }
      } else if constexpr (R > 1) {
        if constexpr (R > 4) {
          if (j == 4) {
            cx_lane<W, R, 4>(k, lane, a);
            continue;
          }
        }
        if constexpr (R > 2) {
          if (j == 2) {
            cx_lane<W, R, 2>(k, lane, a);
            continue;
          }
        }
        cx_lane<W, R, 1>(k, lane, a);
      }
    }
  }
}

// The new candidates of a closure iteration, in the warp's buffer
// wbuf[0, count) (stride WARP_KEYS, in no order; those past WARP_KEYS
// are dropped, and the caller then takes the union path): each lane
// expands 4 candidates at a time, tests them against the frontier, and
// one ballot per candidate places the new ones. Returns the count.
template <int W>
__device__ __forceinline__ int gather_new(const Ctx& c, const int* fr, int n,
                                          int total, int lane, int* wbuf) {
  const uint32_t lt = (1u << lane) - 1u;
  int count = 0;
  for (int e0 = n; e0 < total; e0 += 4 * WARP) {
    int k[4][W], pos[4];
    bool nw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      candidate<W>(c, fr, n, total, e0 + u * WARP + lane, k[u]);
    // new: valid and not in the (sorted) frontier
    lower_bound<W, 4>(fr, LANES, n, k, pos);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int m[W];
      load_key<W>(m, fr, LANES, min(pos[u], max(n - 1, 0)));
      nw[u] = (k[u][W - 1] < SENT_HI) & !((pos[u] < n) & key_eq<W>(m, k[u]));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t bal = __ballot_sync(FULL, nw[u]);
      const int pos = count + __popc(bal & lt);
      if (nw[u] & (pos < WARP_KEYS)) store_key<W>(wbuf, WARP_KEYS, pos, k[u]);
      count += __popc(bal);
    }
  }
  __syncwarp();               // the new keys are visible to every lane
  return count;
}

// Merge `count` (<= 32 R) new candidates from wbuf into the sorted
// frontier fr[0, n): sort them in registers (R per lane), drop duplicates
// against the predecessor, and place every key at its index plus its
// rank in the other list (a binary search), in wbuf[OUT, OUT + 128);
// then copy the first F_CAP of the union back. Returns the union's size.
#define OUT REG_KEYS          // the merge's output, inside wbuf
template <int W, int R>
__device__ __forceinline__ int merge_new(int* fr, int n, int lane, int* wbuf,
                                         int count) {
  constexpr int LOGR = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : 3;
  int uniq;
  {
    int k[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane * R + r;
      load_key<W>(k[r], wbuf, WARP_KEYS, min(i, count - 1));
      if (i >= count) set_sentinel<W>(k[r]);
    }
    warp_sort<W, R>(k, lane, R == 1 ? 32 - __clz(max(count - 1, 1))
                                    : 5 + LOGR);
    int prev[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      prev[w] = __shfl_up_sync(FULL, k[R - 1][w], 1);
    bool keep[R];
    keep[0] = (k[0][W - 1] < SENT_HI) & ((lane == 0) | !key_eq<W>(k[0], prev));
#pragma unroll
    for (int r = 1; r < R; ++r)
      keep[r] = (k[r][W - 1] < SENT_HI) & !key_eq<W>(k[r], k[r - 1]);
    int t[R], lo[R];
    uniq = warp_positions<R>(keep, t, lane);
    lower_bound<W, R>(fr, LANES, n, k, lo);
    __syncwarp();             // every lane has read its new keys
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (keep[r]) {
        store_key<W>(wbuf, WARP_KEYS, t[r], k[r]);
        if (t[r] + lo[r] < F_CAP)
          store_key<W>(wbuf, WARP_KEYS, OUT + t[r] + lo[r], k[r]);
      }
    }
  }
  __syncwarp();               // wbuf[0, uniq) holds the sorted new keys
  {
    int f[4][W], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      load_key<W>(f[q], fr, LANES, min(lane * 4 + q, max(n - 1, 0)));
    lower_bound<W, 4>(wbuf, WARP_KEYS, uniq, f, lo);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = lane * 4 + q;
      if ((i < n) & (i + lo[q] < F_CAP))
        store_key<W>(wbuf, WARP_KEYS, OUT + i + lo[q], f[q]);
    }
  }
  __syncwarp();
  const int n2 = n + uniq;
  for (int i = lane; i < min(n2, F_CAP); i += WARP) {
    int m[W];
    load_key<W>(m, wbuf, WARP_KEYS, OUT + i);
    store_key<W>(fr, LANES, i, m);
  }
  __syncwarp();
  return n2;
}

__device__ __forceinline__ void lock_acquire(int* lock, int lane) {
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) __nanosleep(64);
    __threadfence_block();
  }
  __syncwarp();
}

__device__ __forceinline__ void lock_release(int* lock, int lane) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    atomicExch(lock, 0);
  }
}

// The union path, for an iteration with more than REG_KEYS new keys:
// sort and deduplicate all M = next_pow2(total) candidates in shared
// memory, up to WARP_KEYS in the warp's own buffer `wbuf` (W x WARP_KEYS
// words), else in the CTA's buffer `big` (W x big_cap words), taken
// under `lock`.
template <int W>
__device__ __forceinline__ int closure_smem(const Ctx& c, int* fr, int n,
                                            int lane, int* wbuf, int* big,
                                            int big_cap, int* lock) {
  const int total = n * (c.P + 1);
  int M = 2 * REG_KEYS;
  while (M < total) M <<= 1;
  const bool shared = M > WARP_KEYS;
  int* buf = shared ? big : wbuf;
  const int cap = shared ? big_cap : WARP_KEYS;
  if (shared) lock_acquire(lock, lane);
  for (int e = lane; e < M; e += WARP) {
    int k[W];
    candidate<W>(c, fr, n, total, e, k);
    store_key<W>(buf, cap, e, k);
  }
  __syncwarp();
  // each lane takes 4 of a stage's disjoint pairs at a time, all loads
  // first, so their latencies overlap (M / 2 >= 256 pairs)
  for (int kk = 2; kk <= M; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int p0 = lane; p0 < (M >> 1); p0 += 4 * WARP) {
        int a[4][W], b[4][W], ia[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = p0 + u * WARP;
          ia[u] = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          load_key<W>(a[u], buf, cap, ia[u]);
          load_key<W>(b[u], buf, cap, ia[u] + j);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (key_less<W>(b[u], a[u]) == ((ia[u] & kk) == 0)) {
            store_key<W>(buf, cap, ia[u], b[u]);
            store_key<W>(buf, cap, ia[u] + j, a[u]);
          }
        }
      }
      __syncwarp();
    }
  }
  // dedup and compact: lane owns the M / 32 consecutive keys from b0
  const int per = M / WARP, b0 = lane * per;
  int cnt = 0;
  {
    int prev[W];
    set_sentinel<W>(prev);
    if (b0 > 0) load_key<W>(prev, buf, cap, b0 - 1);
    for (int i = b0; i < b0 + per; ++i) {
      int cur[W];
      load_key<W>(cur, buf, cap, i);
      cnt += (cur[W - 1] < SENT_HI) & ((i == 0) | !key_eq<W>(cur, prev));
#pragma unroll
      for (int w = 0; w < W; ++w) prev[w] = cur[w];
    }
  }
  int x = cnt;
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  const int kept = __shfl_sync(FULL, x, WARP - 1);
  int pos = x - cnt;
  {
    int prev[W];
    set_sentinel<W>(prev);
    if (b0 > 0) load_key<W>(prev, buf, cap, b0 - 1);
    for (int i = b0; i < b0 + per; ++i) {
      int cur[W];
      load_key<W>(cur, buf, cap, i);
      if ((cur[W - 1] < SENT_HI) & ((i == 0) | !key_eq<W>(cur, prev))) {
        if (pos < F_CAP) store_key<W>(fr, LANES, pos, cur);
        ++pos;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) prev[w] = cur[w];
    }
  }
  if (shared) lock_release(lock, lane);
  __syncwarp();
  return kept;
}

// One closure iteration over the frontier fr[0, n); returns the size of
// the union (fr keeps its first F_CAP keys, sorted). `path` says which
// way it went: 0 no new key (a fixed point), 1-4 merging new keys sorted
// R = 1, 2, 4, 8 per lane, 5 the union in shared memory.
template <int W>
__device__ __forceinline__ int closure_iteration(const Ctx& c, int* fr, int n,
                                                 int lane, int* wbuf,
                                                 int* big, int big_cap,
                                                 int* lock, int& path) {
  const int total = n * (c.P + 1);
  const int count = gather_new<W>(c, fr, n, total, lane, wbuf);
  path = count == 0 ? 0 : count <= WARP ? 1 : count <= 2 * WARP ? 2
       : count <= 4 * WARP ? 3 : count <= REG_KEYS ? 4 : 5;
  if (path == 0) return n;
  if (path == 1) return merge_new<W, 1>(fr, n, lane, wbuf, count);
  if (path == 2) return merge_new<W, 2>(fr, n, lane, wbuf, count);
  if (path == 3) return merge_new<W, 4>(fr, n, lane, wbuf, count);
  if (path == 4) return merge_new<W, 8>(fr, n, lane, wbuf, count);
  return closure_smem<W>(c, fr, n, lane, wbuf, big, big_cap, lock);
}

// --- the segment-row ring ----------------------------------------------------

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + RING) of the stream (those below n_seg) into one
// ring slot; one commit group per call, empty or not.
__device__ __forceinline__ void stage_rows(int* dst, const int* rows, int r0,
                                           int n_seg, int width, int lane) {
  const int n = (r0 < n_seg ? min(RING, n_seg - r0) : 0) * width;
  const int* src = rows + (size_t)r0 * width;
  for (int i = lane; i < n; i += WARP) cp_async4(dst + i, src + i);
  cp_commit();
}

// Dynamic shared memory of a CTA of `warps` warps: the table, the CTA's
// large-closure buffer (only when closures can pass WARP_KEYS), and per
// warp a WARP_KEYS-key buffer, the frontier and the row ring.
static size_t smem_bytes(const SegLayout* lay, int table_n, int warps) {
  const size_t big_cap = lay->n_keys > WARP_KEYS ? lay->n_keys : 0;
  const size_t per_warp = (size_t)lay->W * (WARP_KEYS + LANES) +
                          2 * RING * (2 + 2 * (size_t)lay->K);
  return sizeof(int) * (((size_t)table_n + 3) / 4 * 4 +
                        (size_t)lay->W * big_cap + warps * per_warp);
}

static bool layout_ok(const SegLayout* lay, int table_n) {
  return !(lay->P < 1 || lay->P > MAX_P || lay->W < 1 || lay->W > MAX_W ||
           lay->K < 1 || lay->K > MAX_K || lay->n_keys > MAX_KEYS ||
           lay->n_keys < LANES * (lay->P + 1) || table_n < 1 ||
           table_n > MAX_TABLE);
}

// --- the kernel ----------------------------------------------------------------

// seg: [streams, n_seg, 2+2K] rows (ok_proc, depth, inv_proc[K],
// inv_tr[K]); ws: [streams, W, 128] frontier carry; stat: [streams, 4]
// (status, fail, n, counter); table: [table_n] successor table, row
// stride `stride`; results: [streams, res_stride, 3] per-history verdicts
// (stream mode) or NULL; work, need: [streams] this stream's counts of
// comparisons (see `cx` and `nd`), or NULL. Warp w of CTA b runs stream
// b * (blockDim.x / 32) + w.
template <int W>
__global__ void __launch_bounds__(MAX_WARPS * WARP, MIN_CTAS)
seg_search_kernel(const int* __restrict__ seg, int n_seg, int off,
                  int stride, const int* __restrict__ ws_in,
                  const int* __restrict__ stat_in,
                  const int* __restrict__ table_g, int table_n,
                  int* __restrict__ ws_out, int* __restrict__ stat_out,
                  int* __restrict__ results, int res_stride,
                  unsigned long long* __restrict__ work,
                  unsigned long long* __restrict__ need, int n_streams,
                  SegLayout lay) {
  extern __shared__ int smem[];
  __shared__ int slot_word[16], slot_shift[16], root[4];
  __shared__ int big_lock;
  const int lane = threadIdx.x & (WARP - 1), wid = threadIdx.x / WARP;
  const int P = lay.P, K = lay.K, cap = lay.n_keys;
  const int width = 2 + 2 * K;
  const int big_cap = cap > WARP_KEYS ? cap : 0;
  int* table = smem;                                   // [table_n]
  int* big = table + ((table_n + 3) & ~3);             // [W][big_cap]
  int* wbuf = big + W * big_cap +                      // [W][WARP_KEYS]
              wid * (W * (WARP_KEYS + LANES) + 2 * RING * width);
  int* fr = wbuf + W * WARP_KEYS;                      // [W][128]
  int* ring = fr + W * LANES;                          // [2][RING][width]
  if (threadIdx.x < 16) {
    slot_word[threadIdx.x] = lay.slot_word[threadIdx.x];
    slot_shift[threadIdx.x] = lay.slot_shift[threadIdx.x];
  }
  if (threadIdx.x < 4) root[threadIdx.x] = lay.root[threadIdx.x];
  if (threadIdx.x == 0) big_lock = 0;
  for (int i = threadIdx.x; i < table_n; i += blockDim.x) table[i] = table_g[i];
  __syncthreads();  // the only block barrier: all shared state is now set
  const int b = blockIdx.x * (blockDim.x / WARP) + wid;
  if (b >= n_streams) return;

  const int* rows = seg + (size_t)b * n_seg * width;
  ws_in += (size_t)b * W * LANES;
  ws_out += (size_t)b * W * LANES;
  stat_in += b * 4;
  stat_out += b * 4;
  stage_rows(ring, rows, 0, n_seg, width, lane);
  stage_rows(ring + RING * width, rows, RING, n_seg, width, lane);

  Ctx c;
  c.table = table;
  c.table_n = table_n;
  c.stride = stride;
  c.P = P;
  c.magic = (1ull << 32) / (unsigned)P + 1;
  c.state_word = lay.state_word;
  c.state_shift = lay.state_shift;
  c.state_mask = (1u << lay.state_bits) - 1u;
  c.slot_mask = (1u << lay.slot_bits) - 1u;
  c.slot_word = slot_word;
  c.slot_shift = slot_shift;

  // load the carry frontier: its valid lanes, merged into an empty
  // frontier, so that fr is sorted whatever order the carry holds them in
  int n;
  {
    int k[4][W];
    bool keep[4];
    int pos[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      load_key<W>(k[r], ws_in, LANES, lane * 4 + r);
      keep[r] = k[r][W - 1] < SENT_HI;
    }
    const int count = warp_positions<4>(keep, pos, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (keep[r]) store_key<W>(wbuf, WARP_KEYS, pos[r], k[r]);
    __syncwarp();
    n = count > 0 ? merge_new<W, 4>(fr, 0, lane, wbuf, count) : 0;
  }
  int status = stat_in[0], fail = stat_in[1], n_stat = stat_in[2];
  int counter = stat_in[3];
  const bool stream = results != nullptr;
  unsigned long long cx = 0;  // comparisons the plain version counts
  unsigned long long nd = 0;  // comparisons the closures need
  int n_prev = 0x7fffffff;    // n at the previous closure iteration

  // every branch below depends only on values all lanes hold alike (the
  // segment row, status, n), so the warp stays converged
  for (int si = 0; si < n_seg; ++si) {
    const int slot = si % RING;
    const int stage = (si / RING) & 1;
    PROF_T0(t_seg);
    if (slot == 0) {
      if (si >= RING) {
        // the other slot's rows are consumed: refill it RING rows ahead
        __syncwarp();
        stage_rows(ring + (stage ^ 1) * RING * width, rows, si + RING,
                   n_seg, width, lane);
      }
      cp_wait<1>();           // this slot's group has landed
      __syncwarp();
      PROF_ADD(0, t_seg);
    }
    const int* row = ring + (stage * RING + slot) * width;
    const int okp = row[0];
    if (okp == RESET) {
      if (!stream) continue;
      if (lane == 0 && counter >= 0 && counter < res_stride) {
        int* r = results + ((size_t)b * res_stride + counter) * 3;
        r[0] = status;
        r[1] = fail;
        r[2] = n_stat;
      }
      ++counter;
      status = ST_VALID;
      fail = -1;
      n_stat = 1;
      n = 1;
      if (lane < W) fr[lane * LANES] = root[lane];
      __syncwarp();
      continue;
    }
    if (status != ST_VALID) {
      if (stream) continue;   // skip to the next RESET
      break;
    }
    if (okp < 0) continue;    // dead padding segment
    const int depth = row[1];

    // invokes: slot p IDLE(1) -> tr+2 on every config, one additive
    // delta per word
    PROF_T0(t_inv);
    {
      // lane k < K holds invoke k's delta; a butterfly sums them (the
      // adds commute mod 2^32, as the sequential field_plus chain does)
      const int p = lane < K ? row[2 + lane] : -1;
      const bool inv = (p >= 0) & (p < P);
      const int pq = inv ? p : 0;
      const uint32_t dv = inv ? (uint32_t)(row[2 + K + lane] + 1)
                                    << slot_shift[pq] : 0u;
      uint32_t d[W];
#pragma unroll
      for (int w = 0; w < W; ++w) d[w] = slot_word[pq] == w ? dv : 0u;
#pragma unroll
      for (int o = 1; o < MAX_K; o <<= 1)
#pragma unroll
        for (int w = 0; w < W; ++w) d[w] += __shfl_xor_sync(FULL, d[w], o);
#pragma unroll
      for (int w = 0; w < W; ++w) d[w] = __shfl_sync(FULL, d[w], 0);
      for (int f = lane; f < n; f += WARP)
#pragma unroll
        for (int w = 0; w < W; ++w)
          fr[w * LANES + f] = (int)((uint32_t)fr[w * LANES + f] + (uint32_t)d[w]);
      __syncwarp();
    }

    PROF_ADD(1, t_inv);
    // closure: bounded fixed point with exact dedup
    bool ovf = false;
    for (int it = 0; it < depth; ++it) {
      const int total = n * (P + 1);
      if (total > 0) {
        // cx: the plain version's count, sorting all `total` keys and
        // finding their duplicates (total * floor(lg total) + total - 1)
        const int lg = 31 - __clz(total);
        cx += (unsigned long long)total * lg + total - 1;
        // nd: what the closure needs at the least. The n frontier keys
        // are sorted already; each of the n P expansions needs one binary
        // search into them, ceil(lg(n + 1)) comparisons; and the u keys
        // by which this iteration's n exceeds the previous one's (the
        // new keys it added) needed u ceil(lg u) to sort
        const int u = n > n_prev ? n - n_prev : 0;
        nd += (unsigned long long)n * P * (32 - __clz(n)) +
              (unsigned long long)u * (32 - __clz(u > 0 ? u - 1 : 0));
        n_prev = n;
      }
      PROF_T0(t_it);
      int path;
      const int n2 = closure_iteration<W>(c, fr, n, lane, wbuf, big,
                                          big_cap, &big_lock, path);
      PROF_ADD(9 + path, t_it);
      if (n2 > F_CAP) {       // sticky overflow
        ovf = true;
        n = F_CAP;
        break;
      }
      const bool changed = n2 > n;
      n = n2;
      if (!changed) break;
    }

    // ok filter: keep configs whose ok-slot linearized (field 0), and
    // reset that slot to IDLE (+1)
    PROF_T0(t_ok);
    {
      const bool has = okp < P;
      const int ow = has ? slot_word[okp] : 0;
      const int osh = has ? slot_shift[okp] : 0;
      int k[4][W];
      bool keep[4];
      int pos[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = lane * 4 + r;
        load_key<W>(k[r], fr, LANES, min(i, max(n - 1, 0)));
        keep[r] = (i < n) &
                  (!has |
                   ((((uint32_t)pick<W>(k[r], ow) >> osh) & c.slot_mask) == 0));
      }
      const int n2 = warp_positions<4>(keep, pos, lane);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (keep[r]) {
          if (has) add_at<W>(k[r], ow, 1u << osh);
          store_key<W>(fr, LANES, pos[r], k[r]);
        }
      }
      __syncwarp();
      n = n2;
      n_stat = n2;
      status = ovf ? ST_UNKNOWN : (n2 == 0 ? ST_INVALID : ST_VALID);
      if (status != ST_VALID) fail = off + si;
    }
    PROF_ADD(7, t_ok);
    PROF_ADD(8, t_seg);
  }
  cp_wait<0>();

  for (int i = lane; i < LANES; i += WARP)
#pragma unroll
    for (int w = 0; w < W; ++w)
      ws_out[w * LANES + i] =
          i < n ? fr[w * LANES + i] : (w == W - 1 ? SENT_HI : 0);
  if (lane == 0) {
    stat_out[0] = status;
    stat_out[1] = fail;
    stat_out[2] = n_stat;
    stat_out[3] = counter;
    if (work != nullptr) work[b] = cx;
    if (need != nullptr) need[b] = nd;
  }
}

typedef void (*SegKernel)(const int*, int, int, int, const int*, const int*,
                          const int*, int, int*, int*, int*, int,
                          unsigned long long*, unsigned long long*, int,
                          SegLayout);

static SegKernel kernel_for(int W) {
  return W == 1 ? seg_search_kernel<1>
                : W == 2 ? seg_search_kernel<2> : seg_search_kernel<3>;
}

// `batch` streams, one per warp, `warps` warps per CTA; stream b reads
// seg[b], ws_in[b], stat_in[b]. `results` (stream mode), `work` and
// `need` may be NULL.
extern "C" int seg_search_launch(const int* seg, int n_seg, int off,
                                 int stride, const int* ws_in,
                                 const int* stat_in, const int* table,
                                 int table_n, int* ws_out, int* stat_out,
                                 int batch, int warps, const SegLayout* lay,
                                 int* results, int res_stride,
                                 unsigned long long* work,
                                 unsigned long long* need, void* stream) {
  if (!layout_ok(lay, table_n) || n_seg < 0 || batch < 1 || warps < 1 ||
      warps > MAX_WARPS || (results != nullptr && res_stride < 1))
    return (int)cudaErrorInvalidValue;
  const SegKernel fn = kernel_for(lay->W);
  const size_t bytes = smem_bytes(lay, table_n, warps);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (batch + warps - 1) / warps;
  fn<<<ctas, warps * WARP, bytes, (cudaStream_t)stream>>>(
      seg, n_seg, off, stride, ws_in, stat_in, table, table_n, ws_out,
      stat_out, results, res_stride, work, need, batch, *lay);
  return (int)cudaGetLastError();
}

// Warp-streams of this layout one SM holds at once, at MAX_WARPS warps
// per CTA (0 on error): the stream dispatcher sizes its group count to
// fill the card in one wave.
extern "C" int seg_search_occupancy(const SegLayout* lay, int table_n) {
  if (!layout_ok(lay, table_n)) return 0;
  const SegKernel fn = kernel_for(lay->W);
  const size_t bytes = smem_bytes(lay, table_n, MAX_WARPS);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, MAX_WARPS * WARP, bytes) != cudaSuccess)
    return 0;
  return blocks * MAX_WARPS;
}

#ifdef SEG_PROFILE
extern "C" int seg_search_profile(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (reset) {
    unsigned long long z[32] = {0};
    cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)e;
}
#endif

extern "C" const char* seg_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
