// Segment-search kernel for Hopper (sm_90a): the whole segment loop of
// one history in one CTA.
//
// Replaces comdb2_tpu/checker/pallas_seg.py `_build_kernel` (the fused
// Pallas TPU kernel). The function is the same — see
// comdb2_tpu_torch/checker/seg_kernel.py for the semantics and its plain
// PyTorch version `seg_search_reference`. The TPU kernel's sequential
// grid of 1024-segment chunks, its (8|16, 128) vreg rows and its
// row-broadcast table gather were Mosaic limits and are not reproduced:
// here one CTA per history loops over its segments itself, with the
// frontier, the candidate buffer and the successor table resident in
// shared memory for the whole launch.
//
// Bound: the serial chain segment x closure iteration x bitonic stage
// (a __syncthreads each), not bytes or FLOPs. Each closure iteration
// sorts only next_pow2(n * (P + 1)) keys, n being the live frontier.
//
// Keys are n_words int32 words, word 0 least significant, compared as
// signed ints from the top word down. Field arithmetic (adding negative
// deltas shifted into place) is done in uint32_t: a left shift of a
// negative int is undefined before C++20.

#include <cuda_runtime.h>
#include <stdint.h>

#define F_CAP 128
#define LANES 128
#define THREADS 256
#define SENT_HI (1 << 30)
#define MAX_P 15
#define MAX_W 3
#define MAX_KEYS 2048
#define MAX_TABLE 8192

#define ST_VALID 0
#define ST_INVALID 1
#define ST_UNKNOWN 2

extern "C" {
struct SegLayout {
  int P, K, W;
  int slot_bits, state_bits;
  int state_word, state_shift;
  int n_keys;                 // sort-buffer capacity, a power of two
  int slot_word[16];
  int slot_shift[16];
};
}

__device__ __forceinline__ int field_of(int w, int sh, int bits) {
  return (int)(((uint32_t)w >> sh) & ((1u << bits) - 1u));
}

__device__ __forceinline__ int field_plus(int w, int sh, int delta) {
  return (int)((uint32_t)w + ((uint32_t)delta << sh));
}

__device__ __forceinline__ bool key_less(const int* buf, int cap, int W,
                                         int i, int j) {
  for (int w = W - 1; w >= 0; --w) {
    int a = buf[w * cap + i], b = buf[w * cap + j];
    if (a != b) return a < b;
  }
  return false;
}

__device__ __forceinline__ bool key_eq(const int* buf, int cap, int W,
                                       int i, int j) {
  for (int w = 0; w < W; ++w)
    if (buf[w * cap + i] != buf[w * cap + j]) return false;
  return true;
}

// Block-wide exclusive prefix sum of one count per thread. Every thread
// of the block must call it. `scratch` holds >= 33 ints.
__device__ int block_excl_scan(int count, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = count;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < n_warps ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < n_warps) scratch[lane] = v;
    if (lane == n_warps - 1) scratch[32] = v;
  }
  __syncthreads();
  int base = warp > 0 ? scratch[warp - 1] : 0;
  *total = scratch[32];
  __syncthreads();            // scratch is reused by the next call
  return base + x - count;
}

// Ascending bitonic sort of keys[0, M), M a power of two.
__device__ void bitonic_sort(int* keys, int cap, int W, int M) {
  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (M >> 1); p += blockDim.x) {
        int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        int l = i + j;
        bool asc = (i & k) == 0;
        if (key_less(keys, cap, W, l, i) == asc) {
          for (int w = 0; w < W; ++w) {
            int t = keys[w * cap + i];
            keys[w * cap + i] = keys[w * cap + l];
            keys[w * cap + l] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// After a sort: write the unique valid keys of keys[0, M), in order, to
// fr[0, min(n2, F_CAP)) and return n2, their count.
__device__ int dedup_compact(const int* keys, int cap, int W, int M,
                             int* fr, int* scratch) {
  const int per = (M + blockDim.x - 1) / blockDim.x;
  const int b = threadIdx.x * per;
  const int e = min(b + per, M);
  int cnt = 0;
  for (int i = b; i < e; ++i)
    cnt += keys[(W - 1) * cap + i] < SENT_HI &&
           (i == 0 || !key_eq(keys, cap, W, i, i - 1));
  int total;
  int pos = block_excl_scan(cnt, scratch, &total);
  for (int i = b; i < e; ++i) {
    if (keys[(W - 1) * cap + i] < SENT_HI &&
        (i == 0 || !key_eq(keys, cap, W, i, i - 1))) {
      if (pos < F_CAP)
        for (int w = 0; w < W; ++w) fr[w * LANES + pos] = keys[w * cap + i];
      ++pos;
    }
  }
  __syncthreads();
  return total;
}

// seg: [B, n_seg, 2+2K] rows (ok_proc, depth, inv_proc[K], inv_tr[K]);
// ws: [B, W, 128] frontier carry; stat: [B, 4] (status, fail, n, counter);
// table: [table_n] successor table, row stride `stride`.
__global__ void __launch_bounds__(THREADS)
seg_search_kernel(const int* __restrict__ seg, int n_seg, int off,
                  int stride, const int* __restrict__ ws_in,
                  const int* __restrict__ stat_in,
                  const int* __restrict__ table_g, int table_n,
                  int* __restrict__ ws_out, int* __restrict__ stat_out,
                  SegLayout lay) {
  extern __shared__ int smem[];
  const int W = lay.W, P = lay.P, K = lay.K, cap = lay.n_keys;
  const int width = 2 + 2 * K;
  int* keys = smem;                       // [W][cap]
  int* fr = keys + W * cap;               // [W][128]
  int* table = fr + W * LANES;            // [table_n]
  int* scratch = table + table_n;         // [64]
  __shared__ int slot_word[16], slot_shift[16];
  const int tid = threadIdx.x, T = blockDim.x;
  const int bix = blockIdx.x;
  if (tid < 16) {
    slot_word[tid] = lay.slot_word[tid];
    slot_shift[tid] = lay.slot_shift[tid];
  }
  seg += (size_t)bix * n_seg * width;
  ws_in += bix * W * LANES;
  ws_out += bix * W * LANES;
  stat_in += bix * 4;
  stat_out += bix * 4;

  for (int i = tid; i < table_n; i += T) table[i] = table_g[i];

  // load the carry frontier, compacting its valid lanes to the front
  int n;
  {
    const int per = LANES / T > 0 ? LANES / T : 1;
    const int b = tid * per, e = min(b + per, LANES);
    int cnt = 0;
    for (int i = b; i < e; ++i) cnt += ws_in[(W - 1) * LANES + i] < SENT_HI;
    int pos = block_excl_scan(cnt, scratch, &n);
    for (int i = b; i < e; ++i)
      if (ws_in[(W - 1) * LANES + i] < SENT_HI) {
        for (int w = 0; w < W; ++w) fr[w * LANES + pos] = ws_in[w * LANES + i];
        ++pos;
      }
  }
  int status = stat_in[0], fail = stat_in[1], n_stat = stat_in[2];
  const int counter = stat_in[3];
  __syncthreads();

  const uint32_t slot_mask = (1u << lay.slot_bits) - 1u;
  for (int si = 0; si < n_seg && status == ST_VALID; ++si) {
    const int* row = seg + (size_t)si * width;
    const int okp = row[0];
    if (okp < 0) continue;                  // dead padding segment
    const int depth = row[1];

    // invokes: slot p IDLE(1) -> tr+2, on every frontier config
    for (int f = tid; f < n; f += T) {
      for (int k = 0; k < K; ++k) {
        const int p = row[2 + k];
        if (p >= 0 && p < P) {
          int* wp = fr + slot_word[p] * LANES + f;
          *wp = field_plus(*wp, slot_shift[p], row[2 + K + k] + 1);
        }
      }
    }
    __syncthreads();

    // closure: bounded fixed point with exact dedup
    bool ovf = false;
    for (int it = 0; it < depth; ++it) {
      const int total = n * (P + 1);
      int M = 1;
      while (M < total) M <<= 1;
      for (int e = tid; e < M; e += T) {
        int kw[MAX_W];
        bool valid = e < total;
        if (e < n) {
          for (int w = 0; w < W; ++w) kw[w] = fr[w * LANES + e];
        } else if (valid) {
          const int c = e - n, f = c / P, q = c - f * P;
          for (int w = 0; w < W; ++w) kw[w] = fr[w * LANES + f];
          const int s = field_of(kw[lay.state_word], lay.state_shift,
                                 lay.state_bits);
          const int tq = (int)(((uint32_t)kw[slot_word[q]] >>
                                slot_shift[q]) & slot_mask);
          valid = false;
          if (tq >= 2) {
            const int idx = s * stride + (tq - 2);
            const int s2 = idx < table_n ? table[idx] : -1;
            if (s2 >= 0) {
              valid = true;
              kw[slot_word[q]] =
                  field_plus(kw[slot_word[q]], slot_shift[q], -tq);
              kw[lay.state_word] =
                  field_plus(kw[lay.state_word], lay.state_shift, s2 - s);
            }
          }
        }
        for (int w = 0; w < W; ++w)
          keys[w * cap + e] = valid ? kw[w] : (w == W - 1 ? SENT_HI : 0);
      }
      __syncthreads();
      bitonic_sort(keys, cap, W, M);
      const int n2 = dedup_compact(keys, cap, W, M, fr, scratch);
      if (n2 > F_CAP) {                     // sticky overflow
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
    {
      const bool has = okp < P;
      const int ow = has ? slot_word[okp] : 0;
      const int osh = has ? slot_shift[okp] : 0;
      const int per = (n + T - 1) / T;
      const int b = tid * per, e = min(b + per, n);
      int cnt = 0;
      for (int f = b; f < e; ++f)
        cnt += !has || (((uint32_t)fr[ow * LANES + f] >> osh) & slot_mask) == 0;
      int n2;
      int pos = block_excl_scan(cnt, scratch, &n2);
      for (int f = b; f < e; ++f) {
        if (!has || (((uint32_t)fr[ow * LANES + f] >> osh) & slot_mask) == 0) {
          for (int w = 0; w < W; ++w) keys[w * cap + pos] = fr[w * LANES + f];
          if (has) keys[ow * cap + pos] = field_plus(keys[ow * cap + pos], osh, 1);
          ++pos;
        }
      }
      __syncthreads();
      for (int f = tid; f < n2; f += T)
        for (int w = 0; w < W; ++w) fr[w * LANES + f] = keys[w * cap + f];
      __syncthreads();
      n = n2;
      n_stat = n2;
      status = ovf ? ST_UNKNOWN : (n2 == 0 ? ST_INVALID : ST_VALID);
      if (status != ST_VALID) fail = off + si;
    }
  }

  for (int i = tid; i < LANES; i += T)
    for (int w = 0; w < W; ++w)
      ws_out[w * LANES + i] =
          i < n ? fr[w * LANES + i] : (w == W - 1 ? SENT_HI : 0);
  if (tid == 0) {
    stat_out[0] = status;
    stat_out[1] = fail;
    stat_out[2] = n_stat;
    stat_out[3] = counter;
  }
}

extern "C" int seg_search_launch(const int* seg, int n_seg, int off,
                                 int stride, const int* ws_in,
                                 const int* stat_in, const int* table,
                                 int table_n, int* ws_out, int* stat_out,
                                 int batch, const SegLayout* lay,
                                 void* stream) {
  if (lay->P < 1 || lay->P > MAX_P || lay->W < 1 || lay->W > MAX_W ||
      lay->K < 1 || lay->n_keys > MAX_KEYS ||
      lay->n_keys < LANES * (lay->P + 1) || table_n < 1 ||
      table_n > MAX_TABLE || n_seg < 0 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(int) * ((size_t)lay->W * lay->n_keys +
                                      (size_t)lay->W * LANES + table_n + 64);
  cudaError_t err = cudaFuncSetAttribute(
      seg_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  seg_search_kernel<<<batch, THREADS, bytes, (cudaStream_t)stream>>>(
      seg, n_seg, off, stride, ws_in, stat_in, table, table_n, ws_out,
      stat_out, *lay);
  return (int)cudaGetLastError();
}

extern "C" const char* seg_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
