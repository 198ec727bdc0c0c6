// Block expansion of the LZ4 decode (Hopper, sm_90a).
//
// Replaces smallz4_tpu/ops/decoder.py:28 expand_block (XLA, not Pallas): the
// sequence lookup of every output position (searchsorted), its first
// pointer, the while_loop of synchronous pointer doubling that runs until no
// pointer is live, and the final gather from cat(history, payload).  For
// every row b of a batch, out[b][p] for all p < oc is exactly the
// reference's: a literal position points into the payload, a match position
// at match_start - off + k mod off (the overlap contraction), a chain that
// leaves the block into the right-aligned 64 Ki history, and the padding
// positions past the row's length follow the reference's clipping rule.
// The wrapper passes ends = cumsum(lit_len + match_len) per row (the
// reference's cumsum also sits outside its loop).
//
// Bound: the payload, the four tables, the ends and the output each moved
// once, plus the history a row reads (at most 64 KiB): memory bound, about
// 2 us for a 4 MiB block at 3.35 TB/s.  What limits it is the dependency
// chains: a match's bytes depend on earlier output, and a chain of matches
// of offset 4 is 1M deep in a 4 MiB block, so a fixed number of doubling
// passes would read the pointer array log2(oc) = 22 times on every block,
// and a host-driven loop would sync once a round.
//
// Design: one launch, asynchronous pointer chasing over tiles.  A block
// takes a tile of 8,192 positions of one row, its index from an atomic
// counter in row-major order, so it only ever waits on tiles that already
// run.  Each thread finds the sequence of its 16 consecutive positions (one
// binary search over the ends, then a forward walk) and writes their first
// pointers to shared memory.  Every pointer points strictly backward (a
// match byte at most to match_start - 1), so the block resolves the chains
// that stay inside the tile by in-place doubling in shared memory until a
// round changes nothing (at most log2(8192) + 1 rounds); a chain then ends
// in a terminal or at a "boundary" position of the tile, whose own pointer
// leaves the tile.  The tile publishes every position's pointer to a global
// array and then its status word (release), and only then chases: each
// boundary position follows pointers in earlier tiles (whose status it
// acquires first), one global read a hop, and writes its progress back to
// its own entry, so chases from later tiles that reach it skip ahead
// (path compression).  Positions strictly fall along a chain, so the chase
// ends, and a tile only waits for earlier tiles to publish, which needs
// nothing of later tiles: no deadlock under any schedule.  A tile whose
// earlier tiles have finished resolves a boundary position in about one
// hop.  Then the tile's other positions take their boundary's terminal, the
// tile gathers its bytes from the history or the payload, writes them, and
// writes the terminals of the positions it had published as live pointers.
// Status words carry the call's epoch, so words of earlier calls read as
// "not published" and need no reset; the block that takes the last tile
// index sets the counter back to 0 for the next call on the stream.
//
// Tables must be those of LZ4 sequences (offsets at most 65,535): an offset
// that reaches past the 64 Ki history would make a pointer that need not
// point backward; the kernel ends such a pointer at pool index 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int EX_THREADS = 512;
constexpr int EX_PER = 16;                        // positions a thread
constexpr int EX_TILE = EX_THREADS * EX_PER;      // positions a block
constexpr int HIST_CAP = 65536;
constexpr unsigned EPOCH_MAX = (1u << 30) - 1;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int32_t* p, int v) {
  asm volatile("st.relaxed.gpu.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the first index i with ends[i] > p (sc if none)
__device__ __forceinline__ int upper_bound(const int32_t* ends, int sc,
                                           int p) {
  int lo = 0, hi = sc;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(EX_THREADS)
expand_kernel(const uint8_t* __restrict__ payload,
              const uint8_t* __restrict__ hist,
              const int32_t* __restrict__ ends,
              const int32_t* __restrict__ lit_len,
              const int32_t* __restrict__ match_len,
              const int32_t* __restrict__ match_off,
              const int32_t* __restrict__ lit_src, uint8_t* __restrict__ out,
              int32_t* ptrs, unsigned long long* status, unsigned* counter,
              int pc, int sc, int oc, int tiles_per_row, int tiles,
              unsigned epoch) {
  __shared__ int s_tile;
  __shared__ int S[EX_TILE];  // the tile's pointers
  if (threadIdx.x == 0) {
    const unsigned v = atomicAdd(counter, 1u);
    if (v == (unsigned)tiles - 1) atomicExch(counter, 0u);  // all taken
    s_tile = (int)v;
  }
  __syncthreads();
  const int tile = s_tile;
  const int b = tile / tiles_per_row;
  const int ts = (tile - b * tiles_per_row) * EX_TILE;  // first position
  const int tn = min(EX_TILE, oc - ts);                 // positions here
  const size_t ro = (size_t)b * sc, oo = (size_t)b * oc;
  const int32_t* E = ends + ro;
  int32_t* P = ptrs + oo;
  unsigned long long* row_status = status + (size_t)b * tiles_per_row;
  const int total = E[sc - 1];

  // 1. first pointers: terminals -(pool index + 1), or positions
  int sid = -1;
  for (int k = 0; k < EX_PER; ++k) {
    const int i = threadIdx.x * EX_PER + k;
    if (i >= tn) break;
    const int p = ts + i;
    if (p >= total) {
      sid = sc - 1;  // every end <= p: the reference clips to the last
    } else if (sid < 0) {
      sid = upper_bound(E, sc, p);
    } else {  // the previous position's sequence or a later one
      for (int steps = 0; E[sid] <= p; ++sid) {  // ends[sc-1] > p stops it
        if (++steps == 8) {  // a run of empty sequences: search
          sid = upper_bound(E, sc, p);
          break;
        }
      }
    }
    const int e = E[sid], ll = lit_len[ro + sid], ml = match_len[ro + sid];
    const int off = match_off[ro + sid];
    const int ms = e - ml;  // match start
    int ptr;
    if (p < ms) {
      ptr = -(HIST_CAP + lit_src[ro + sid] + (p - (ms - ll)) + 1);
    } else if (off > 0) {
      const int raw = ms - off + (p - ms) % off;
      ptr = raw >= 0 ? raw : -(HIST_CAP + raw + 1);
      if (ptr >= p) ptr = -1;  // not an LZ4 offset (see the head)
    } else {
      ptr = -1;
    }
    S[i] = ptr;
  }
  __syncthreads();

  // 2. in-tile doubling: a pointer into the tile takes its target's pointer
  // unless the target is a boundary position (whose pointer leaves)
  for (;;) {
    int changed = 0;
    for (int k = 0; k < EX_PER; ++k) {
      const int i = threadIdx.x * EX_PER + k;
      if (i >= tn) break;
      const int v = S[i];
      if (v >= ts) {
        const int w = S[v - ts];
        if (w < 0 || w >= ts) {
          S[i] = w;
          changed = 1;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  // 3. publish: terminals, exits of boundary positions, boundaries
  unsigned live = 0;  // bit j: position j * EX_THREADS + tid published live
  for (int j = 0; j < EX_PER; ++j) {
    const int i = j * EX_THREADS + threadIdx.x;
    if (i >= tn) break;
    const int v = S[i];
    if (v >= 0) live |= 1u << j;
    P[ts + i] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    st_release(row_status + ts / EX_TILE, (unsigned long long)epoch);

  // 4. chase from the boundary positions through earlier tiles
  for (int j = 0; j < EX_PER; ++j) {
    const int i = j * EX_THREADS + threadIdx.x;
    if (i >= tn) break;
    int q = S[i];
    if (q < 0 || q >= ts) continue;  // terminal, or inside the tile
    int seen = -1;
    for (;;) {
      const int u = q / EX_TILE;
      if (u != seen) {
        while (ld_acquire(row_status + u) != (unsigned long long)epoch)
          __nanosleep(64);
        seen = u;
      }
      q = ld_relaxed(P + q);
      if (q < 0) break;
      st_relaxed(P + ts + i, q);  // progress for chases that reach here
    }
    S[i] = q;
  }
  __syncthreads();

  // 5. the other positions take their boundary's terminal
  for (int j = 0; j < EX_PER; ++j) {
    const int i = j * EX_THREADS + threadIdx.x;
    if (i >= tn) break;
    const int v = S[i];
    if (v >= ts) S[i] = S[v - ts];
  }
  __syncthreads();

  // 6. gather the bytes; final terminals for the live entries
  const uint8_t* H = hist + (size_t)b * HIST_CAP;
  const uint8_t* Y = payload + (size_t)b * pc;
  const int pool_max = HIST_CAP + pc - 1;
  for (int j = 0; j < EX_PER; ++j) {
    const int i = j * EX_THREADS + threadIdx.x;
    if (i >= tn) break;
    const int v = S[i];
    const int src = min(max(-v - 1, 0), pool_max);
    out[oo + ts + i] = src < HIST_CAP ? H[src] : Y[src - HIST_CAP];
    if (live >> j & 1u) st_relaxed(P + ts + i, v);
  }
}

}  // namespace

extern "C" {

// output positions a block of s4_expand resolves (no launch)
int s4_expand_tile() { return EX_TILE; }

// Expand every row b < B of a batch of sequence tables into `out` ([B][oc]
// bytes), one launch: `payload` [B][pc] bytes, `hist` [B][65536] bytes
// (right-aligned), `ends` (the rows' inclusive prefix sums of lit_len +
// match_len), `lit_len`, `match_len`, `match_off`, `lit_src` [B][sc] int32,
// `ptrs` [B][oc] int32 scratch.  `state` holds the tile counter (word 0)
// and B * ceil(oc / s4_expand_tile()) status words; it is zeroed before the
// first call and reused by every later call on the stream with epochs
// 1, 2, ... <= 2^30 - 1.
int s4_expand(const uint8_t* payload, const uint8_t* hist,
              const int32_t* ends, const int32_t* lit_len,
              const int32_t* match_len, const int32_t* match_off,
              const int32_t* lit_src, uint8_t* out, int32_t* ptrs,
              unsigned long long* state, int B, int pc, int sc, int oc,
              unsigned epoch, void* stream) {
  if (B < 1 || pc < 1 || sc < 1 || oc < 1 || oc > INT_MAX - EX_TILE ||
      pc > INT_MAX - HIST_CAP || epoch < 1 || epoch > EPOCH_MAX)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_row = (oc + EX_TILE - 1) / EX_TILE;
  const long long tiles = (long long)B * tiles_per_row;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  expand_kernel<<<(unsigned)tiles, EX_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      payload, hist, ends, lit_len, match_len, match_off, lit_src, out, ptrs,
      state + 1, reinterpret_cast<unsigned*>(state), pc, sc, oc,
      tiles_per_row, (int)tiles, epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
