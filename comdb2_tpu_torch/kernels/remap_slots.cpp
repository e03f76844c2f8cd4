// Slot renaming of a segment stream, the host pass behind
// checker/linear_torch.py remap_slots: one walk over the (S, K) invoke
// rows and the S oks, with the rule remap_slots documents.
//
// - Invokes take the lowest free slot (a min-heap of freed slots), or
//   a fresh one when none is free, in row order.
// - A segment's ok releases its process's slot after the segment's
//   invokes, so the slot is reusable from the next segment on.
// - An ok with no open invocation maps to the smallest free slot, or
//   to a fresh slot that is then left free.
// - A process that invokes while its earlier invocation is open stops
//   the pass: the result is -1, with the segment and the process in
//   err[0] and err[1].
//
// Entries below 0 are padding. Each output pointer may be null, and
// that output is not written. `owners` is an (S, W) row-major map:
// row s holds, after segment s, the original process in each slot, or
// -1 where the slot is free or was never allocated; W is at least the
// P_eff of a pass without the map. The result is the number of slots
// allocated (P_eff).
//
// Process ids are the interned codes of pack_history (0 .. n_procs-1),
// so the open slot of each process lives in a table indexed by id.
//
// Plain C interface, built by kernels/build.py with the host's C++
// compiler and bound with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <vector>

extern "C" int64_t remap_slots(const int32_t* inv_proc,
                               const int32_t* ok_proc, int64_t S, int64_t K,
                               int32_t* out_inv, int32_t* out_ok,
                               int32_t* owners, int64_t W, int64_t* err) {
  int32_t top = -1;
  for (int64_t i = 0; i < S * K; ++i) top = std::max(top, inv_proc[i]);
  for (int64_t s = 0; s < S; ++s) top = std::max(top, ok_proc[s]);
  // slot of each process with an open invocation, -1 when none
  std::vector<int32_t> slot_of(static_cast<size_t>(top) + 1, -1);
  std::priority_queue<int32_t, std::vector<int32_t>, std::greater<int32_t>>
      free_slots;
  std::vector<int32_t> held;  // process in each slot, -1 when free
  int32_t n_slots = 0;
  for (int64_t s = 0; s < S; ++s) {
    const int32_t* row = inv_proc + s * K;
    for (int64_t k = 0; k < K; ++k) {
      const int32_t p = row[k];
      int32_t sl = p;
      if (p >= 0) {
        if (slot_of[p] >= 0) {
          err[0] = s;
          err[1] = p;
          return -1;
        }
        if (!free_slots.empty()) {
          sl = free_slots.top();
          free_slots.pop();
        } else {
          sl = n_slots++;
          held.push_back(-1);
        }
        slot_of[p] = sl;
        held[sl] = p;
      }
      if (out_inv) out_inv[s * K + k] = sl;
    }
    const int32_t o = ok_proc[s];
    int32_t osl = o;
    if (o >= 0) {
      osl = slot_of[o];
      if (osl < 0) {
        // ok without an open invocation: any free slot is IDLE in every
        // config, so the ok filter empties the frontier either way
        if (!free_slots.empty()) {
          osl = free_slots.top();
        } else {
          osl = n_slots++;
          held.push_back(-1);
          free_slots.push(osl);
        }
      } else {
        slot_of[o] = -1;
        held[osl] = -1;
        free_slots.push(osl);
      }
    }
    if (out_ok) out_ok[s] = osl;
    if (owners) {
      int32_t* dst = owners + s * W;
      if (n_slots) std::memcpy(dst, held.data(), n_slots * sizeof(int32_t));
      for (int64_t w = n_slots; w < W; ++w) dst[w] = -1;
    }
  }
  return n_slots;
}
