// Pair-sort kernel for Hopper (sm_90a): every row of (hi, lo) int32 pairs
// sorted ascending, lexicographically, comparing signed words with hi
// first.
//
// Replaces comdb2_tpu/checker/pallas_sort.py `_bitonic_kernel` (launched
// by `sort_pairs`): the same bitonic network, log2(N)(log2(N)+1)/2
// compare-exchange stages over each row. The TPU kernel kept L whole
// rows in VMEM and fetched partners with lane rolls; a Hopper block has
// at most 227 KB of shared memory, so here:
//
// - a row of at most `smem_n` pairs sorts in one CTA's shared memory,
//   one __syncthreads per stage (pair_sort_tile);
// - a wider row first sorts each smem_n-pair tile in shared memory,
//   then takes one global-memory launch per merge stage whose partner
//   distance is a tile or more (pair_sort_global) and finishes each
//   merge in shared memory.
//
// Bound: bytes for one pass (16 bytes per pair, read and written once),
// but the network makes log2(N)(log2(N)+1)/2 passes; every pass below
// smem_n stays in shared memory, and only the log2(N/smem_n) widest
// distances of each wide merge go through device memory.
//
// The direction of a compare-exchange is taken from the pair's index in
// its whole row, so a tile sorted in shared memory lands in the same
// state as the full network would leave it.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_THREADS 1024

__device__ __forceinline__ bool pair_less(int ah, int al, int bh, int bl) {
  return ah < bh || (ah == bh && al < bl);
}

// Compare-exchange elements i < m of (h, l): ascending when `asc`.
__device__ __forceinline__ void compare_exchange(int* h, int* l, int i,
                                                 int m, bool asc) {
  const int ah = h[i], al = l[i], bh = h[m], bl = l[m];
  if (pair_less(bh, bl, ah, al) == asc) {
    h[i] = bh;
    l[i] = bl;
    h[m] = ah;
    l[m] = al;
  }
}

// One CTA per tile of T pairs (rows are N pairs, N a multiple of T):
// stages k = k_lo .. k_hi (powers of two), each with partner distances
// j = min(k, T)/2 .. 1, in shared memory.
__global__ void __launch_bounds__(MAX_THREADS)
pair_sort_tile(int* __restrict__ hi, int* __restrict__ lo, int N, int T,
               int k_lo, int k_hi) {
  extern __shared__ int smem[];
  int* sh = smem;
  int* sl = smem + T;
  const size_t base = (size_t)blockIdx.x * T;
  const int g0 = (int)(blockIdx.x % (unsigned)(N / T)) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sh[i] = hi[base + i];
    sl[i] = lo[base + i];
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = min(k, T) >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (T >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        compare_exchange(sh, sl, i, i + j, ((g0 + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    hi[base + i] = sh[i];
    lo[base + i] = sl[i];
  }
}

// One stage (k, j) over every row in device memory; one thread per pair.
__global__ void pair_sort_global(int* __restrict__ hi, int* __restrict__ lo,
                                 int N, int j, int k, long long n_pairs) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int half = N >> 1;
  const long long row = p / half;
  const int q = (int)(p - row * half);
  const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
  compare_exchange(hi + row * N, lo + row * N, i, i + j, (i & k) == 0);
}

// Sort B rows of N pairs in place (N a power of two). `smem_n` (a power
// of two) is the widest row one CTA sorts in shared memory.
extern "C" int pair_sort_launch(int* hi, int* lo, int B, int N, int smem_n,
                                void* stream) {
  if (B < 1 || N < 1 || (N & (N - 1)) || smem_n < 2 ||
      (smem_n & (smem_n - 1)) || smem_n > 16384)
    return (int)cudaErrorInvalidValue;
  if (N == 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = N < smem_n ? N : smem_n;
  const size_t bytes = 2 * sizeof(int) * (size_t)T;
  cudaError_t err = cudaFuncSetAttribute(
      pair_sort_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int threads = T / 2 < MAX_THREADS ? T / 2 : MAX_THREADS;
  const long long tiles = (long long)B * (N / T);
  pair_sort_tile<<<(unsigned)tiles, threads, bytes, s>>>(hi, lo, N, T, 2,
                                                         T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)B * (N / 2);
  const int g_threads = 256;
  const long long g_blocks = (n_pairs + g_threads - 1) / g_threads;
  for (int k = 2 * T; k <= N; k <<= 1) {
    for (int j = k >> 1; j >= T; j >>= 1) {
      pair_sort_global<<<(unsigned)g_blocks, g_threads, 0, s>>>(
          hi, lo, N, j, k, n_pairs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    pair_sort_tile<<<(unsigned)tiles, threads, bytes, s>>>(hi, lo, N, T, k,
                                                           k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* pair_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
