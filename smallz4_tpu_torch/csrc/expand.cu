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
// 2.4 us for a 4 MiB block at 3.35 TB/s.  What limits it is the dependency
// chains: a match's bytes depend on earlier output, and a chain of matches
// of offset 4 is 1M deep in a 4 MiB block, so a fixed number of doubling
// passes would read the pointer array log2(oc) = 22 times on every block,
// and a host-driven loop would sync once a round.
//
// Design: one launch, asynchronous chasing over tiles.  A block of 512
// threads takes a tile of 8,192 positions of one row, its index from an
// atomic counter in row-major order, so it only ever waits on tiles that
// already run.  Warp w owns positions w * 512 + r * 32 + lane (r < 16), so
// every shared-memory pass over the tile is free of bank conflicts.
//
// 1. Lookup, once a tile: warp 0 finds the first sequence over the tile and
//    warp 1 the last by 32-way searches of the ends (four dependent loads for
//    262,144 sequences; the tile where the row ends searches once more for its
//    last real sequence).  The tile's sequences are read once, coalesced: each
//    stamps its local index at its first position (atomicMax) and keeps its
//    match start, offset and literal base in shared memory (LZ4 sequences span
//    at least 4 positions, so a tile holds at most 8,192 / 4 + 2; a table
//    beyond that reads the rest from global memory). Positions at and past the
//    row's length clip to the last sequence, as in the reference.  A block
//    max-scan (warp shuffles, then the warps' maxima) gives every position its
//    sequence; its first pointer follows with no `%` where p - match_start <
//    off.  A tile that lies inside one sequence's literal run (incompressible
//    data) skips 1's scan and 2-4: its bytes are the payload's.
// 2. Pointers strictly point backward, so chains that stay in the tile
//    resolve by pointer doubling in shared memory, over the positions that
//    are still live only (a thread keeps a 16-bit mask), until a round
//    changes nothing.  A chain then ends in a terminal -(pool index + 1) or
//    at a "boundary" position, whose own pointer leaves the tile.
// 3. A tile with boundary positions that is not its row's last publishes
//    its 8,192 pointers (16-byte stores) and then its status word
//    (release): later tiles' chases can reach any of its positions.
//    Nothing is written back after the chases (a chase into a tile whose
//    bytes are written reads the byte, see 4).  A tile without boundary
//    positions publishes nothing.
// 4. Chases that overlap: the block first reads every earlier tile's
//    status word of the row, one acquire a thread, in parallel; then a
//    thread keeps its boundary positions' pointers in registers and
//    advances all of them one hop a round, their loads issued together.
//    A hop into a tile whose bytes are written ends the chase there (its
//    byte is final); into a published tile it reads that tile's
//    pointer and writes the progress to its own published entry, so chases
//    from later tiles that reach it skip ahead (path compression); a tile
//    that is neither is passed over for this round.  The block remembers,
//    in shared bitmasks, which earlier tiles it has seen published or
//    written, so no status word is acquired twice for that.
// 5. The other positions take their boundary's result, each byte comes from
//    the history, the payload or the written output of an earlier tile, the
//    tile's bytes are staged in shared memory and stored as 16-byte words,
//    and the status word says "written" (release).
//
// What holds it back (NVIDIA H100, PERF.md section 6): 64 registers a
// thread and 58 KiB of shared memory a block leave 264 blocks resident, so
// a 4 MiB row runs in two waves of tiles; a real block's tile takes about
// 50 us, more than half of it in the chases' 9 or so dependent rounds of
// about 3 us each, and the other phases are bound by the SMs' issue rate.
//
// Positions strictly fall along a chain, so a chase ends; a tile only waits
// for earlier tiles to publish, which needs nothing of later tiles, or, for
// a tile that publishes nothing, to write its bytes, which needs nothing of
// any other tile: no deadlock under any schedule.  Status words carry the
// call's epoch (2 epoch: published, 2 epoch + 1: written), so words of
// earlier calls read as "neither" and need no reset; the block that takes
// the last tile index sets the counter back to 0 for the next call on the
// stream.
//
// Tables must be those of LZ4 sequences (offsets at most 65,535): an offset
// that reaches past the 64 Ki history would make a pointer that need not
// point backward; the kernel ends such a pointer at pool index 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int EX_THREADS = 512;
constexpr int EX_WARPS = EX_THREADS / 32;
constexpr int EX_PER = 16;                        // positions a thread
constexpr int EX_TILE = EX_THREADS * EX_PER;      // positions a block
constexpr int WARP_SPAN = EX_TILE / EX_WARPS;     // positions a warp
constexpr int SEQ_CAP = EX_TILE / 4 + 4;          // sequences kept a tile
constexpr int SEEN_TILES = 2048;                  // earlier tiles remembered
constexpr int HIST_CAP = 65536;
constexpr unsigned EPOCH_MAX = (1u << 30) - 1;

struct Smem {
  int S[EX_TILE];  // stamps, then sequence indices, then pointers
  union {
    struct {
      int ms[SEQ_CAP];   // match start
      int off[SEQ_CAP];  // match offset
      int lb[SEQ_CAP];   // HIST_CAP + lit_src - sequence start
    } seq;
    uint8_t bytes[EX_TILE];  // the tile's output, staged
  } u;
  unsigned pub[SEEN_TILES / 32];   // bit d: tile tr - 1 - d published
  unsigned done[SEEN_TILES / 32];  // bit d: tile tr - 1 - d written
  int warp_max[EX_WARPS];
  int tile, s0, s1, s2;
};

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

// no "memory" clobber: it follows the acquires across a barrier, and the
// loads of a thread's positions stay in flight together
__device__ __forceinline__ unsigned ld_relaxed_u8(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// the first index i < n with ends[i] > p (n if none), by the whole warp:
// 32 probes a round
__device__ int warp_upper_bound(const int32_t* ends, int n, int p) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned gt = __ballot_sync(~0u, ends[idx] > p);
    if (gt == 0) return hi;
    const int f = __ffs(gt) - 1;
    const int at = min(lo + (f + 1) * step - 1, hi - 1);
    lo = f == 0 ? lo : lo + f * step;
    hi = at;
  }
  const int idx = lo + lane;
  const unsigned gt = __ballot_sync(~0u, idx >= hi || ends[idx] > p);
  return gt ? min(lo + __ffs(gt) - 1, hi) : hi;
}

// 2: tile tr - 1 - d of the row written, 1: published, 0: neither yet
__device__ __forceinline__ int tile_state(
    Smem& sm, const unsigned long long* row_status, int tr, int d,
    unsigned long long pub) {
  const unsigned bit = 1u << (d & 31);
  if (d < SEEN_TILES) {
    if (*(volatile unsigned*)&sm.done[d >> 5] & bit) {
      __threadfence_block();  // pairs with the fence before the atomicOr
      return 2;
    }
    if (*(volatile unsigned*)&sm.pub[d >> 5] & bit) {
      __threadfence_block();
      return 1;
    }
  }
  const unsigned long long s = ld_acquire(row_status + tr - 1 - d);
  const int st = s == pub + 1 ? 2 : s == pub ? 1 : 0;
  if (st && d < SEEN_TILES) {
    __threadfence_block();  // the block's later reads follow this acquire
    atomicOr(st == 2 ? &sm.done[d >> 5] : &sm.pub[d >> 5], bit);
  }
  return st;
}

__global__ void __launch_bounds__(EX_THREADS, 2)
expand_kernel(const uint8_t* __restrict__ payload,
              const uint8_t* __restrict__ hist,
              const int32_t* __restrict__ ends,
              const int32_t* __restrict__ lit_len,
              const int32_t* __restrict__ match_len,
              const int32_t* __restrict__ match_off,
              const int32_t* __restrict__ lit_src, uint8_t* out,
              int32_t* ptrs, unsigned long long* status, unsigned* counter,
              int pc, int sc, int oc, int tiles_per_row, int tiles,
              unsigned epoch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const unsigned v = atomicAdd(counter, 1u);
    if (v == (unsigned)tiles - 1) atomicExch(counter, 0u);  // all taken
    sm.tile = (int)v;
  }
  for (int k = tid; k < EX_TILE; k += EX_THREADS) sm.S[k] = -1;
  for (int k = tid; k < SEEN_TILES / 32; k += EX_THREADS) {
    sm.pub[k] = 0;
    sm.done[k] = 0;
  }
  __syncthreads();
  const int tile = sm.tile;
  const int b = tile / tiles_per_row;
  const int tr = tile - b * tiles_per_row;  // tile index in the row
  const int ts = tr * EX_TILE;              // first position
  const int tn = min(EX_TILE, oc - ts);     // positions here
  const size_t ro = (size_t)b * sc, oo = (size_t)b * oc;
  const int32_t* E = ends + ro;

  // 1. lookup: the tile's sequences [s0, s1]; a row that ends inside the
  // tile ("tail") clips the positions from its length on to its last
  // sequence, as the reference does
  if (warp < 2) {
    const int s = warp_upper_bound(E, sc, warp == 0 ? ts : ts + tn - 1);
    if (lane == 0) (warp == 0 ? sm.s0 : sm.s1) = s;
  }
  __syncthreads();
  int s0 = sm.s0, s1 = sm.s1;
  const bool tail = s1 == sc;
  int total = 0;  // the row's length, needed in a tail tile only
  if (tail) {
    total = E[sc - 1];
    if (s0 < sc) {  // the sequence over position total - 1
      if (warp == 1) {
        const int s = warp_upper_bound(E, sc, total - 1);
        if (lane == 0) sm.s2 = s;
      }
      __syncthreads();
      s1 = sm.s2;
    } else {  // the tile starts at or past the row's length
      s0 = 0;
      s1 = -1;
    }
  }
  const int ns = s1 - s0 + 1;
  const int nstamp = ns + (tail ? 1 : 0);
  for (int k = tid; k < nstamp; k += EX_THREADS) {
    const int i = k < ns ? s0 + k : sc - 1;
    const int e = E[i], ml = match_len[ro + i];
    const int start = e - lit_len[ro + i] - ml;
    if (k < SEQ_CAP) {
      sm.u.seq.ms[k] = e - ml;
      sm.u.seq.off[k] = match_off[ro + i];
      sm.u.seq.lb[k] = HIST_CAP + lit_src[ro + i] - start;
    }
    atomicMax(&sm.S[max(k < ns ? start : total, ts) - ts], k);
  }
  __syncthreads();

  // a tile inside one sequence's literal run (incompressible data) takes
  // its bytes from the payload: no scan, no pointers, no chase
  int32_t* P = ptrs + oo;
  unsigned long long* row_status = status + (size_t)b * tiles_per_row;
  const unsigned long long pub = 2ull * epoch;
  const int lit_lb = sm.u.seq.lb[0];
  const bool lit_tile = ns == 1 && !tail && ts + tn <= sm.u.seq.ms[0] &&
                        lit_lb + ts >= 0;
  if (!lit_tile) {
    // block max-scan of the stamps: each position's sequence
    int run = -1;
    for (int r = 0; r < EX_PER; ++r) {
      const int pos = warp * WARP_SPAN + r * 32 + lane;
      int x = sm.S[pos];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(~0u, x, d);
        if (lane >= d) x = max(x, y);
      }
      x = max(x, run);
      run = __shfl_sync(~0u, x, 31);
      sm.S[pos] = x;
    }
    if (lane == 0) sm.warp_max[warp] = run;
    __syncthreads();
    int before = -1;
    for (int w = 0; w < warp; ++w) before = max(before, sm.warp_max[w]);

    // first pointers: terminals -(pool index + 1), or positions
    unsigned live = 0;  // bit r: position r's pointer stays in the tile
    for (int r = 0; r < EX_PER; ++r) {
      const int pos = warp * WARP_SPAN + r * 32 + lane;
      if (pos >= tn) break;
      const int k = max(sm.S[pos], before);
      int ms, off, lb;
      if (k < SEQ_CAP) {
        ms = sm.u.seq.ms[k];
        off = sm.u.seq.off[k];
        lb = sm.u.seq.lb[k];
      } else {  // not an LZ4 table: more sequences than the tile keeps
        const int i = k < ns ? s0 + k : sc - 1;
        const int e = E[i], ml = match_len[ro + i];
        ms = e - ml;
        off = match_off[ro + i];
        lb = HIST_CAP + lit_src[ro + i] - (ms - lit_len[ro + i]);
      }
      const int p = ts + pos;
      int ptr;
      if (p < ms) {
        ptr = -(lb + p + 1);
      } else if (off > 0) {
        int d = p - ms;
        if (d >= off) d %= off;  // the overlap contraction
        const int raw = ms - off + d;
        ptr = raw >= 0 ? raw : -(HIST_CAP + raw + 1);
        if (ptr >= p) ptr = -1;  // not an LZ4 offset (see the head)
      } else {
        ptr = -1;
      }
      if (ptr >= ts) live |= 1u << r;
      sm.S[pos] = ptr;
    }

    // 2. in-tile doubling over the live positions: a pointer into the tile
    // takes its target's pointer unless the target is a boundary position
    // (the loop's barrier also ends the pass above)
    while (__syncthreads_or(live != 0)) {
      for (int r = 0; r < EX_PER; ++r) {
        if (!(live >> r & 1u)) continue;
        const int pos = warp * WARP_SPAN + r * 32 + lane;
        const int w = sm.S[sm.S[pos] - ts];
        if (w < 0 || w >= ts) sm.S[pos] = w;
        if (w < ts) live &= ~(1u << r);  // a terminal, or at its boundary
      }
    }
    unsigned bnd = 0;  // bit r: position r is a boundary position
    for (int r = 0; r < EX_PER; ++r) {
      const int pos = warp * WARP_SPAN + r * 32 + lane;
      if (pos >= tn) break;
      const int v = sm.S[pos];
      if (v >= 0 && v < ts) bnd |= 1u << r;
    }
    const bool any_bnd = __syncthreads_or(bnd != 0);
    const bool publish = any_bnd && tr + 1 < tiles_per_row;

    // 3. publish the pointers for later tiles' chases
    if (publish) {
      const bool al = ((uintptr_t)(P + ts) & 15) == 0;
      for (int k = tid * 4; k < tn; k += EX_THREADS * 4) {
        if (al && k + 4 <= tn) {
          *reinterpret_cast<int4*>(P + ts + k) =
              *reinterpret_cast<const int4*>(sm.S + k);
        } else {
          for (int j = k; j < min(k + 4, tn); ++j) P[ts + j] = sm.S[j];
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(row_status + tr, pub);
    }

    // 4. chase the boundary positions through earlier tiles, all at once;
    // first the earlier tiles' states, one acquire each, in parallel
    if (any_bnd) {
      for (int d = tid; d < min(tr, SEEN_TILES); d += EX_THREADS) {
        const unsigned long long st = ld_acquire(row_status + tr - 1 - d);
        if (st == pub + 1) atomicOr(&sm.done[d >> 5], 1u << (d & 31));
        else if (st == pub) atomicOr(&sm.pub[d >> 5], 1u << (d & 31));
      }
      __syncthreads();
      int q[EX_PER];
#pragma unroll
      for (int r = 0; r < EX_PER; ++r)
        q[r] = bnd >> r & 1u ? sm.S[warp * WARP_SPAN + r * 32 + lane] : 0;
      unsigned chase = bnd;
      while (__any_sync(~0u, chase)) {
        unsigned ready = 0;
#pragma unroll
        for (int r = 0; r < EX_PER; ++r) {
          if (!(chase >> r & 1u)) continue;
          const int st = tile_state(sm, row_status, tr,
                                    tr - 1 - q[r] / EX_TILE, pub);
          if (st == 2) chase &= ~(1u << r);  // out[q] is final
          else if (st == 1) ready |= 1u << r;
        }
#pragma unroll
        for (int r = 0; r < EX_PER; ++r)  // the loads in flight together
          if (ready >> r & 1u) q[r] = ld_relaxed(P + q[r]);
#pragma unroll
        for (int r = 0; r < EX_PER; ++r) {
          if (!(ready >> r & 1u)) continue;
          if (q[r] < 0) chase &= ~(1u << r);
          if (publish)  // progress for chases that reach here
            st_relaxed(P + ts + warp * WARP_SPAN + r * 32 + lane, q[r]);
        }
        if (!__any_sync(~0u, ready)) __nanosleep(64);
      }
#pragma unroll
      for (int r = 0; r < EX_PER; ++r)
        if (bnd >> r & 1u) sm.S[warp * WARP_SPAN + r * 32 + lane] = q[r];
    }
    __syncthreads();
  }

  // 5. every position's byte: the history, the payload, or the written
  // output of an earlier tile; staged, then stored as 16-byte words
  const uint8_t* H = hist + (size_t)b * HIST_CAP;
  const uint8_t* Y = payload + (size_t)b * pc;
  uint8_t* O = out + oo;
  const int pool_max = HIST_CAP + pc - 1;
#pragma unroll
  for (int h = 0; h < EX_PER; h += 8) {  // 8 loads in flight a thread
    unsigned byte[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pos = warp * WARP_SPAN + (h + j) * 32 + lane;
      byte[j] = 0;
      if (pos < tn) {
        int v = -(lit_lb + ts + pos + 1);
        if (!lit_tile) {
          v = sm.S[pos];
          if (v >= ts) v = sm.S[v - ts];  // its boundary position's result
        }
        if (v < 0) {
          const int src = min(-v - 1, pool_max);
          byte[j] = src < HIST_CAP ? __ldg(H + src)
                                   : __ldg(Y + src - HIST_CAP);
        } else {
          byte[j] = ld_relaxed_u8(O + v);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pos = warp * WARP_SPAN + (h + j) * 32 + lane;
      if (pos < tn) sm.u.bytes[pos] = (uint8_t)byte[j];
    }
  }
  __syncthreads();
  uint8_t* dst = O + ts;
  const bool al = ((uintptr_t)dst & 15) == 0;
  for (int k = tid * 16; k < tn; k += EX_THREADS * 16) {
    if (al && k + 16 <= tn) {
      *reinterpret_cast<uint4*>(dst + k) =
          *reinterpret_cast<const uint4*>(sm.u.bytes + k);
    } else {
      for (int j = k; j < min(k + 16, tn); ++j) dst[j] = sm.u.bytes[j];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) st_release(row_status + tr, pub + 1);
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
  const int smem = (int)sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  expand_kernel<<<(unsigned)tiles, EX_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      payload, hist, ends, lit_len, match_len, match_off, lit_src, out, ptrs,
      state + 1, reinterpret_cast<unsigned*>(state), pc, sc, oc,
      tiles_per_row, (int)tiles, epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
