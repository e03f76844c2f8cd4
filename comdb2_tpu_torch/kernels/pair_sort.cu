// Pair-sort kernel for Hopper (sm_90a): every row of (hi, lo) int32 pairs
// sorted ascending, lexicographically, comparing signed words with hi
// first.
//
// Replaces comdb2_tpu/checker/pallas_sort.py `_bitonic_kernel` (launched
// by `sort_pairs`), which ran the whole bitonic network over rows kept in
// VMEM and fetched partners with lane rolls. None of that carries over;
// the design here:
//
// - One 64-bit unsigned key per pair, ((hi ^ 2^31) << 32) | (lo ^ 2^31):
//   an unsigned compare of keys is the signed lexicographic compare of
//   pairs, and equal keys are equal pairs, so any correct sort is the
//   stable one. Every compare-exchange is a branch-free select on one
//   key. Converted on load, back on the last store.
// - Block sort (one launch): each CTA of PS_THREADS = 256 threads sorts a
//   tile of T = PS_E * PS_THREADS = 4096 keys, PS_E = 16 a thread (rows of
//   N < T: T / N rows at once).
//   Loads are 16 bytes a thread, staged through padded shared memory
//   into E keys per thread in registers (thread t holds tile positions
//   t E .. t E + E - 1). A bitonic network then runs every stage at
//   partner distance j < E inside the thread, E <= j < 32 E by
//   __shfl_xor_sync between lanes, and j >= 32 E in shared memory. A
//   row of N <= T is finished by this one launch.
// - Merge passes (log2(N / T) launches): pass p merges pairs of sorted
//   runs of L = T 2^(p-1) keys. Every CTA writes a fixed slice of C = T
//   outputs, so the grid is B N / T CTAs whatever B is. Two warps find
//   the slice's ends on the merge-path diagonal (co-rank), each by a
//   32-lane search that narrows the range 33-fold per step; the CTA
//   stages the two input windows in padded shared memory, each thread
//   finds its own sub-diagonal by a binary search there and merges E
//   outputs with branch-free selects; the outputs leave through shared
//   memory in 16-byte stores. Passes ping-pong between two u64 scratch
//   buffers (the wrapper allocates them); the last pass writes hi / lo.
//
// What bounds it: the function needs bytes, 16 per pair read and written
// once; the kernel moves 16 bytes per pair 1 + log2(N / T) times (a row
// set of a few MB stays in the 50 MB L2 between passes). On the card its
// time goes to the block sort's shuffles and selects, log2(T)(log2(T) +
// 1) / 2 stages of E / 2 compare-exchanges per thread, issue-bound at two
// CTAs per SM, and to each merge pass's chain of dependent steps (co-rank
// search, window load, merge, store) and the gap between launches.
//
// PS_PROFILE builds a variant whose thread 0 of every CTA stamps the
// %globaltimer at each phase's end (read by
// scripts/torch_pair_sort_profile.py --stamps).

#include <cuda_runtime.h>
#include <stdint.h>

// keys per thread and threads per CTA (T = 8192 and E = 8 were no faster
// on the card; PERF.md)
#define PS_E 16
#define PS_THREADS 256
#define PS_T (PS_E * PS_THREADS)
// shared memory: the tile plus one spare slot per 16 keys
#define PS_SMEM_KEYS (PS_T + PS_T / 16)

typedef unsigned long long u64;

#define PS_STAMPS 8
#ifdef PS_PROFILE
// [launch][CTA][PS_STAMPS] nanoseconds; launch 0 the block sort, p >= 1
// merge pass p (set by pair_sort_stamps)
__device__ u64* ps_stamps;
__device__ __forceinline__ void stamp(int launch, int slot) {
  if (threadIdx.x == 0 && ps_stamps != nullptr) {
    u64 now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    ps_stamps[((size_t)launch * gridDim.x + blockIdx.x) * PS_STAMPS +
              slot] = now;
  }
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

__device__ __forceinline__ u64 to_key(int h, int l) {
  return ((u64)((unsigned)h ^ 0x80000000u) << 32) |
         (u64)((unsigned)l ^ 0x80000000u);
}
__device__ __forceinline__ int key_hi(u64 u) {
  return (int)((unsigned)(u >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int key_lo(u64 u) {
  return (int)((unsigned)u ^ 0x80000000u);
}

// Shared-memory slot of tile position i: one spare slot after every 16
// keys, so a half-warp's 8-byte accesses at a stride of E keys (a thread's
// registers) fall in 16 different bank pairs.
__device__ __forceinline__ int spos(int i) { return i + (i >> 4); }

// Compare-exchange: (a, b) ascending, or descending when `desc`.
__device__ __forceinline__ void cx(u64& a, u64& b, bool desc) {
  const bool swap = (a > b) != desc;
  const u64 x = swap ? b : a;
  b = swap ? a : b;
  a = x;
}

__device__ __forceinline__ void store_regs(u64* s, const u64 (&v)[PS_E]) {
#pragma unroll
  for (int e = 0; e < PS_E; ++e) s[spos(threadIdx.x * PS_E + e)] = v[e];
}

__device__ __forceinline__ void load_regs(const u64* s, u64 (&v)[PS_E]) {
#pragma unroll
  for (int e = 0; e < PS_E; ++e) v[e] = s[spos(threadIdx.x * PS_E + e)];
}

// The T keys from flat position `base` (of `total`) written to padded
// shared memory; positions past `total` get the largest key.
__device__ __forceinline__ void load_tile(const int* __restrict__ hi,
                                          const int* __restrict__ lo,
                                          long long base, long long total,
                                          u64* s) {
  if (base + PS_T <= total) {
    const int4* h4 = reinterpret_cast<const int4*>(hi + base);
    const int4* l4 = reinterpret_cast<const int4*>(lo + base);
#pragma unroll
    for (int it = 0; it < PS_E / 4; ++it) {
      const int q = it * PS_THREADS + threadIdx.x;
      const int4 h = __ldg(h4 + q), l = __ldg(l4 + q);
      u64* d = s + spos(4 * q);
      d[0] = to_key(h.x, l.x);
      d[1] = to_key(h.y, l.y);
      d[2] = to_key(h.z, l.z);
      d[3] = to_key(h.w, l.w);
    }
  } else {
    for (int i = threadIdx.x; i < PS_T; i += PS_THREADS)
      s[spos(i)] = base + i < total ? to_key(__ldg(hi + base + i),
                                             __ldg(lo + base + i))
                                    : ~0ull;
  }
}

// The T keys in padded shared memory written from flat position `base`
// (of `total`): as u64 keys to `keys`, else as hi / lo words.
__device__ __forceinline__ void store_tile(const u64* s,
                                           u64* __restrict__ keys,
                                           int* __restrict__ hi,
                                           int* __restrict__ lo,
                                           long long base,
                                           long long total) {
  if (keys != nullptr) {
    ulonglong2* k2 = reinterpret_cast<ulonglong2*>(keys + base);
#pragma unroll
    for (int it = 0; it < PS_E / 2; ++it) {
      const int q = it * PS_THREADS + threadIdx.x;
      const u64* x = s + spos(2 * q);
      k2[q] = make_ulonglong2(x[0], x[1]);
    }
  } else if (base + PS_T <= total) {
    int4* h4 = reinterpret_cast<int4*>(hi + base);
    int4* l4 = reinterpret_cast<int4*>(lo + base);
#pragma unroll
    for (int it = 0; it < PS_E / 4; ++it) {
      const int q = it * PS_THREADS + threadIdx.x;
      const u64* x = s + spos(4 * q);
      h4[q] = make_int4(key_hi(x[0]), key_hi(x[1]), key_hi(x[2]),
                        key_hi(x[3]));
      l4[q] = make_int4(key_lo(x[0]), key_lo(x[1]), key_lo(x[2]),
                        key_lo(x[3]));
    }
  } else {
    for (int i = threadIdx.x; i < PS_T && base + i < total;
         i += PS_THREADS) {
      hi[base + i] = key_hi(s[spos(i)]);
      lo[base + i] = key_lo(s[spos(i)]);
    }
  }
}

// Block sort: tile blockIdx.x of the flat B N keys, sorted in units of
// U = min(N, T) keys (a row, or all of a tile of a wider row). Writes u64
// keys to `keys` (wider rows, for the merge passes) or hi / lo words.
__global__ void __launch_bounds__(PS_THREADS)
pair_sort_block(const int* __restrict__ hi, const int* __restrict__ lo,
                u64* __restrict__ keys, int* __restrict__ out_hi,
                int* __restrict__ out_lo, long long total, int U) {
  extern __shared__ u64 s[];
  const long long base = (long long)blockIdx.x * PS_T;
  const int t = threadIdx.x, lane = t & 31;
  stamp(0, 0);
  load_tile(hi, lo, base, total, s);
  __syncthreads();
  stamp(0, 1);
  u64 v[PS_E];
  load_regs(s, v);
  for (int k = 2; k <= U; k <<= 1) {
    // a stage sorts descending where the position's bit k is set, except
    // at the last level (k = U), which sorts every unit ascending
    const int km = k & (U - 1);
    if ((k >> 1) >= 32 * PS_E) {
      __syncthreads();
      store_regs(s, v);
      __syncthreads();
      for (int j = k >> 1; j >= 32 * PS_E; j >>= 1) {
        for (int p = t; p < PS_T / 2; p += PS_THREADS) {
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          u64 a = s[spos(i)], b = s[spos(i + j)];
          cx(a, b, (i & km) != 0);
          s[spos(i)] = a;
          s[spos(i + j)] = b;
        }
        __syncthreads();
      }
      load_regs(s, v);
    }
    // partner distance E m for lane distances m = 16 .. 1: the lower
    // lane of each pair keeps the minimum of every register pair
    // (ascending), the upper the maximum
    const bool desc = ((t * PS_E) & km) != 0;
    for (int m = min(k >> 1, 16 * PS_E) / PS_E; m >= 1; m >>= 1) {
      const bool keep_min = ((lane & m) == 0) != desc;
#pragma unroll
      for (int e = 0; e < PS_E; ++e) {
        const u64 o = __shfl_xor_sync(0xffffffffu, v[e], m);
        v[e] = (keep_min == (o < v[e])) ? o : v[e];
      }
    }
    // partner distance j < E: inside the thread
#pragma unroll
    for (int j = PS_E / 2; j > 0; j >>= 1) {
      if (j < k) {
#pragma unroll
        for (int e = 0; e < PS_E; ++e)
          if ((e & j) == 0) cx(v[e], v[e + j], ((t * PS_E + e) & km) != 0);
      }
    }
    if (k == PS_E) stamp(0, 2);
    if (k == 32 * PS_E) stamp(0, 3);
  }
  stamp(0, 4);
  __syncthreads();
  store_regs(s, v);
  __syncthreads();
  store_tile(s, keys, out_hi, out_lo, base, total);
  stamp(0, 5);
}

// Co-rank of diagonal d in the merge of sorted a[0, L) and b[0, L): the
// number of a's keys among the first d outputs, a's keys first on ties
// (the first i with a[i] > b[d - 1 - i], else the top of the range).
// One warp: each step the 32 lanes probe 32 points of the range and the
// ballot keeps the part between the last probe that is false and the
// first that is true, a 33rd of it.
__device__ __forceinline__ int corank_warp(const u64* __restrict__ a,
                                           const u64* __restrict__ b,
                                           int L, int d, int lane) {
  int lo = max(0, d - L), hi = min(d, L);
  while (hi - lo > 32) {
    const int n = hi - lo;
    const int q = lo + (int)(((long long)(lane + 1) * n) / 33);
    const bool past = __ldg(a + q) > __ldg(b + d - 1 - q);
    const int f = __popc(__ballot_sync(0xffffffffu, !past));
    const int new_lo = f == 0 ? lo : lo + (int)(((long long)f * n) / 33) + 1;
    hi = f == 32 ? hi : lo + (int)(((long long)(f + 1) * n) / 33);
    lo = new_lo;
  }
  const int q = lo + lane;
  const bool before = q < hi && !(__ldg(a + q) > __ldg(b + d - 1 - q));
  return lo + __popc(__ballot_sync(0xffffffffu, before));
}

// Merge pass: the runs of L sorted keys of `src` merged in pairs; this
// CTA writes outputs [blockIdx.x T, + T) of the flat B N, as u64 keys to
// `dst` or, on the last pass, as hi / lo words.
__global__ void __launch_bounds__(PS_THREADS)
pair_sort_merge(const u64* __restrict__ src, u64* __restrict__ dst,
                int* __restrict__ out_hi, int* __restrict__ out_lo, int N,
                int L) {
  extern __shared__ u64 s[];
  __shared__ int split[2];
  const long long g0 = (long long)blockIdx.x * PS_T;
  const long long row = g0 / N;
  const int o = (int)(g0 - row * N);
  const int d0 = o & (2 * L - 1);
  const u64* a = src + row * N + (o - d0);
  const u64* b = a + L;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int pass = __ffs(L / PS_T);      // for the stamps
  stamp(pass, 0);
  if (w < 2) {
    const int c = corank_warp(a, b, L, d0 + w * PS_T, lane);
    if (lane == 0) split[w] = c;
  }
  __syncthreads();
  stamp(pass, 1);
  const int i0 = split[0];
  const int na = split[1] - i0;          // a's keys in this slice
  const int j0 = d0 - i0;
  u64 v[PS_E];
#pragma unroll
  for (int it = 0; it < PS_E; ++it) {
    const int k = it * PS_THREADS + t;
    v[it] = __ldg(k < na ? a + i0 + k : b + j0 + (k - na));
  }
#pragma unroll
  for (int it = 0; it < PS_E; ++it) s[spos(it * PS_THREADS + t)] = v[it];
  __syncthreads();
  stamp(pass, 2);
  // this thread's outputs [t E, t E + E) of the slice: a's window is
  // positions [0, na), b's [na, T), padded (spos): neighbouring threads'
  // windows start about E / 2 keys apart, and unpadded 8-byte reads at
  // that stride would fall in 2 bank pairs. A serial merge, branch-free;
  // a read past b's end is clamped and not used
  const int dt = t * PS_E;
  int lo = max(0, dt - (PS_T - na)), hi = min(dt, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool past = s[spos(mid)] > s[spos(na + dt - 1 - mid)];
    lo = past ? lo : mid + 1;
    hi = past ? mid : hi;
  }
  stamp(pass, 3);
  int i = lo, j = na + dt - lo;
  u64 x = s[spos(i)], y = s[spos(min(j, PS_T - 1))];
#pragma unroll
  for (int e = 0; e < PS_E; ++e) {
    const bool take_a = j >= PS_T || (i < na && x <= y);
    v[e] = take_a ? x : y;
    i += take_a;
    j += !take_a;
    const u64 z = s[spos(min(take_a ? i : j, PS_T - 1))];
    x = take_a ? z : x;
    y = take_a ? y : z;
  }
  stamp(pass, 4);
  __syncthreads();
  store_regs(s, v);
  __syncthreads();
  store_tile(s, dst, out_hi, out_lo, g0, g0 + PS_T);
  stamp(pass, 5);
}

static int merge_passes(int N) {
  int p = 0;
  for (long long L = PS_T; L < N; L <<= 1) ++p;
  return p;
}

static cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Keys a CTA sorts in the block sort, and outputs a CTA writes in a merge
// pass (T).
extern "C" int pair_sort_tile(void) { return PS_T; }

// Dynamic shared memory per CTA, both kernels.
extern "C" int pair_sort_smem_bytes(void) {
  return (int)(PS_SMEM_KEYS * sizeof(u64));
}

// What the loaded library's kernel of phase `phase` (0 the block sort,
// else a merge pass) was compiled to: out[0] registers per thread,
// out[1] local (spill) bytes per thread, out[2] static shared bytes per
// CTA.
extern "C" int pair_sort_attrs(int phase, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, phase == 0 ? (const void*)pair_sort_block
                     : (const void*)pair_sort_merge);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// u64 words of scratch one sort of B rows of N needs: one buffer of B N
// keys for one merge pass, two (ping-pong) for more.
extern "C" long long pair_sort_scratch_words(int B, int N) {
  const int p = merge_passes(N);
  return (long long)(p < 2 ? p : 2) * B * N;
}

// Launch phase `phase` of the sort of B rows of N pairs: 0 the block
// sort, p >= 1 merge pass p. `hi`, `lo`, `out_hi`, `out_lo` and `scratch`
// are 16-byte aligned device pointers; the output does not alias the
// input.
extern "C" int pair_sort_phase(const int* hi, const int* lo, int* out_hi,
                               int* out_lo, u64* scratch, int B, int N,
                               int phase, void* stream) {
  const int passes = merge_passes(N);
  if (B < 1 || N < 1 || (N & (N - 1)) || N > (1 << 30) || phase < 0 ||
      phase > passes ||
      (((uintptr_t)hi | (uintptr_t)lo | (uintptr_t)out_hi |
        (uintptr_t)out_lo | (uintptr_t)scratch) & 15) ||
      (passes > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)B * N;
  const size_t bytes = PS_SMEM_KEYS * sizeof(u64);
  const unsigned grid = (unsigned)((total + PS_T - 1) / PS_T);
  cudaError_t err;
  if (phase == 0) {
    err = smem_attr((const void*)pair_sort_block, bytes);
    if (err != cudaSuccess) return (int)err;
    pair_sort_block<<<grid, PS_THREADS, bytes, st>>>(
        hi, lo, passes ? scratch : nullptr, out_hi, out_lo, total,
        N < PS_T ? N : PS_T);
    return (int)cudaGetLastError();
  }
  err = smem_attr((const void*)pair_sort_merge, bytes);
  if (err != cudaSuccess) return (int)err;
  const bool last = phase == passes;
  pair_sort_merge<<<grid, PS_THREADS, bytes, st>>>(
      scratch + ((phase - 1) & 1) * total,
      last ? nullptr : scratch + (phase & 1) * total,
      last ? out_hi : nullptr, last ? out_lo : nullptr, N,
      PS_T << (phase - 1));
  return (int)cudaGetLastError();
}

// The whole sort: every phase in order on `stream`.
extern "C" int pair_sort_launch(const int* hi, const int* lo, int* out_hi,
                                int* out_lo, u64* scratch, int B, int N,
                                void* stream) {
  for (int p = 0; p <= merge_passes(N); ++p) {
    const int err =
        pair_sort_phase(hi, lo, out_hi, out_lo, scratch, B, N, p, stream);
    if (err != 0) return err;
  }
  return 0;
}

// Where a PS_PROFILE build stamps (u64 [launches][CTAs][PS_STAMPS]), or
// nullptr for nowhere; another build refuses.
extern "C" int pair_sort_stamps(u64* buf) {
#ifdef PS_PROFILE
  return (int)cudaMemcpyToSymbol(ps_stamps, &buf, sizeof(buf));
#else
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" const char* pair_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
