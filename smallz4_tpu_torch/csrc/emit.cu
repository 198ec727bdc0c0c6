// Sequence emit of the device-resident encode (Hopper, sm_90a).
//
// Replaces smallz4_tpu/ops/emit.py emit_block_device, an XLA function (not
// Pallas) of static rounds: LZ4 block serialization of a final parse
// (lens: 1 = literal, else the match length; dists) into exactly
// native.emit_block's payload, then zeros.  In PyTorch tensor ops it is
// about 330 launches a block: 22 rounds of jump tables for the emit walk's
// orbit, then a cumsum layout and a per-byte search with seven gathers.
// Here it is two launches.
//
// Bound: the block (1 B), lens and dists (4 B each) read once a position
// and the payload written once: 11.52 us at 4 MiB on 3.35 TB/s.  The design
// reads lens once, dists and lens again only at the sequences' matches,
// the literals once, writes 20 B a sequence and the output once.  What
// bounds it on the card is the orbit's serial chain across tiles: one
// handoff through L2 a tile of 16,384 positions (256 at 4 MiB).
//
// Launch 1 (emit_orbit_kernel), a block of 1,024 threads a tile, its index
// from an atomic counter in tile order, so it only waits on tiles that
// already run.  A thread owns a segment of 16 positions, a warp a span of
// 512.  The walk jumps i -> i + max(lens[i], 1), capped at N.
//   1. Each thread resolves its segment's exits (the first position at or
//      past the segment's end that a walk from each position reaches)
//      backwards in registers.  Warp rounds of pointer jumping (5, warp
//      barriers only) give each position its span exit, block rounds (5)
//      its tile exit, all in shared memory (exact exits as int32 offsets
//      from the tile start, which may lie past the tile; segment exits
//      also as uint16 saturated at 0xFFFF).  A match longer than the
//      tile skips whole tiles: its exit lies past them.
//   2. The chain across tiles: F(t), the first orbit position at or past
//      tile t's start, is 0 for tile 0; thread 0 takes F(t) from tile t-1's
//      status word, looks up F(t+1) = its tile exit (or F(t) itself when it
//      lies past the tile: a tile with no entry passes it on) and publishes
//      it at once.  Only the entries are chained.
//   3. The orbit inside the tile: thread 0 walks F(t) over the 32 span
//      exits, each warp over its 32 segment exits, and each thread walks
//      its own segment from its entry, at most 16 hops.
//   4. The layout: each thread folds its segment's matches into an
//      aggregate (matches, bytes of the sequences it closes, first match
//      and its length code, end of its last match); the aggregates compose
//      associatively (the first match's sequence is closed by the end of
//      the match before it), so the block scans them with warp shuffles
//      and the tiles by a single-pass decoupled look-back, status words
//      and payloads in _cuda.tile_state("emit", ...).  A virtual match
//      that ends at 0 starts the scan.  Each thread then walks its segment
//      again and writes its sequences (byte offset; literal start, literal
//      count, match length code, distance) at their ranks; the last tile
//      writes the closing literals-only sequence and n_out.
// Launch 2 (emit_bytes_kernel), a block a 4,096-byte output tile: two
// threads find the sequences that cover the tile by binary search over the
// byte offsets, the block stages them in shared memory, and each thread
// computes 16 consecutive output bytes (token, extension bytes, literals,
// offset) and stores them with one 16-byte store; bytes at or past n_out
// are zeros.  The work follows the output, so a 4 MiB literal run or a
// 65,535-long match spreads over the grid like any other bytes.
//
// Status words carry the call's epoch, so words of earlier calls read as
// "not ready" and need no reset; the block that takes the last tile index
// sets the counter back to 0 for the next call on the stream.  Each tile's
// words sit at the same place whatever N (TileState), so a status word is
// never a word that a call of another size wrote as payload: a payload int
// can look like any epoch's flag.  Nothing syncs with the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int PER = 16;                  // positions a thread (its segment)
constexpr int TILE = THREADS * PER;      // positions a tile
constexpr int WARPS = THREADS / 32;
constexpr int SPAN = 32 * PER;           // positions a warp
constexpr int ROUNDS = 5;                // log2(32): span and tile rounds
constexpr int MIN_MATCH = 4;
constexpr int MAX_N = 1 << 28;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned FLAG_A = 1, FLAG_P = 2;  // status flags
constexpr unsigned EPOCH_MAX = (1u << 30) - 1;
// shared memory of launch 1: span exits, tile exits (int32), segment
// exits (uint16), walk steps (uint8) a position
constexpr int ORBIT_SMEM = TILE * (4 + 4 + 2 + 1);

constexpr int OUT_THREADS = 256;
constexpr int OUT_BYTES = 16;                     // bytes a thread
constexpr int OUT_TILE = OUT_THREADS * OUT_BYTES;  // bytes a block
// sequences that can cover an output tile: all but the last are >= 3 bytes
constexpr int OUT_SEQS = OUT_TILE / 3 + 3;

// a tile's words in the state, after the counter
struct TileState {
  unsigned long long hop;   // F(t+1) for the chain
  unsigned long long scan;  // the look-back's flag
  int pay[10];              // the aggregate (A), then the inclusive prefix (P)
};
static_assert(sizeof(TileState) == 56, "7 int64 words a tile");

struct Agg {
  int cnt;    // matches
  int bytes;  // bytes of the sequences closed inside (not the first's)
  int m0;     // first match position
  int ml0;    // its length code (length - MIN_MATCH)
  int rl;     // end of the last match
};

__device__ __forceinline__ int ext_count(int v) {  // put_ext bytes, v >= 15
  return v >= 15 ? (v - 15) / 255 + 1 : 0;
}

__device__ __forceinline__ int seq_bytes(int num_lit, int ml_code) {
  return 3 + ext_count(num_lit) + num_lit + ext_count(ml_code);
}

// a before b; identity: cnt 0
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  if (b.cnt == 0) return a;
  if (a.cnt == 0) return b;
  return Agg{a.cnt + b.cnt,
             a.bytes + b.bytes + seq_bytes(b.m0 - a.rl, b.ml0), a.m0, a.ml0,
             b.rl};
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int off) {
  return Agg{__shfl_up_sync(FULL, a.cnt, off),
             __shfl_up_sync(FULL, a.bytes, off),
             __shfl_up_sync(FULL, a.m0, off),
             __shfl_up_sync(FULL, a.ml0, off),
             __shfl_up_sync(FULL, a.rl, off)};
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned epoch, unsigned flag,
                                          int value) {
  const unsigned long long v =
      ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)value;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// the status word's flag for this call (0: not ready)
__device__ __forceinline__ unsigned flag_of(unsigned long long s,
                                            unsigned epoch) {
  const unsigned hi = (unsigned)(s >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : 0u;
}

__device__ __forceinline__ void put_agg(int* p, const Agg& a) {
  p[0] = a.cnt; p[1] = a.bytes; p[2] = a.m0; p[3] = a.ml0; p[4] = a.rl;
}

__device__ __forceinline__ Agg get_agg(const int* p) {  // through L2
  return Agg{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3),
             __ldcg(p + 4)};
}

__global__ void __launch_bounds__(THREADS, 1)
emit_orbit_kernel(const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ dists,
                  int32_t* __restrict__ soff, int4* __restrict__ rec,
                  int32_t* __restrict__ meta, TileState* __restrict__ ts,
                  unsigned* __restrict__ counter, int N, int tiles,
                  unsigned epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* wex = reinterpret_cast<int*>(smem);           // span exits
  int* tex = wex + TILE;                              // tile exits
  uint16_t* s16 = reinterpret_cast<uint16_t*>(tex + TILE);  // segment exits
  uint8_t* lb = reinterpret_cast<uint8_t*>(s16 + TILE);  // min(L, 255)
  __shared__ int s_tile, s_f;
  __shared__ int s_went[WARPS];
  __shared__ Agg s_warp[WARPS];
  __shared__ Agg s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const unsigned v = atomicAdd(counter, 1u);
    if (v == (unsigned)tiles - 1) atomicExch(counter, 0u);  // all taken
    s_tile = (int)v;
  }
  __syncthreads();
  const int t = s_tile;
  const int base = t * TILE;
  const int nh = min(TILE, N - base);  // positions of this tile
  const int seg0 = tid * PER;          // the thread's segment (tile offsets)

  // 1. the segment: walk steps, and exits resolved backwards
  int lc[PER];  // steps, capped at the block end
  {
    int raw[PER];
    const int p0 = base + seg0;
    if (p0 + PER <= N) {
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const int4 v = reinterpret_cast<const int4*>(lens + p0)[q];
        raw[4 * q] = v.x; raw[4 * q + 1] = v.y;
        raw[4 * q + 2] = v.z; raw[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) raw[k] = p0 + k < N ? lens[p0 + k] : 1;
    }
    uint32_t packed[PER / 4];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int l = max(raw[k], 1);
      lc[k] = p0 + k < N ? min(l, N - (p0 + k)) : 1;
      const uint32_t b = (uint32_t)min(l, 255);
      if (k % 4 == 0) packed[k / 4] = b;
      else packed[k / 4] |= b << (8 * (k % 4));
    }
    *reinterpret_cast<uint4*>(lb + seg0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  {
    int ex[PER];
#pragma unroll
    for (int k = PER - 1; k >= 0; --k) {
      if (base + seg0 + k >= N) {
        ex[k] = nh;  // past the block end: the end
        continue;
      }
      const int j = k + lc[k];
      int v = seg0 + j;
#pragma unroll
      for (int q = k + 1; q < PER; ++q)
        if (j == q) v = ex[q];
      ex[k] = v;
    }
    uint32_t h[PER / 2];
#pragma unroll
    for (int k = 0; k < PER; k += 2)
      h[k / 2] = (uint32_t)min(ex[k], 0xFFFF) |
                 ((uint32_t)min(ex[k + 1], 0xFFFF) << 16);
    uint4* sp = reinterpret_cast<uint4*>(s16 + seg0);
    sp[0] = make_uint4(h[0], h[1], h[2], h[3]);
    sp[1] = make_uint4(h[4], h[5], h[6], h[7]);
    int4* wp = reinterpret_cast<int4*>(wex + seg0);
#pragma unroll
    for (int q = 0; q < PER / 4; ++q)
      wp[q] = make_int4(ex[4 * q], ex[4 * q + 1], ex[4 * q + 2],
                        ex[4 * q + 3]);
  }
  __syncwarp();

  // 2. span exits: pointer jumping over the warp's segment exits
  const int wlo = warp * SPAN, whi = min(wlo + SPAN, nh);
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    int nv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = wex[wlo + lane + 32 * i];
      nv[i] = v < whi ? wex[v] : v;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) wex[wlo + lane + 32 * i] = nv[i];
    __syncwarp();
  }
  __syncthreads();

  // 3. tile exits: pointer jumping over the span exits
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int x = tid + THREADS * i;
    const int v = wex[x];
    tex[x] = v < nh ? wex[v] : v;
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 1; r < ROUNDS; ++r) {
    int nv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = tex[tid + THREADS * i];
      nv[i] = v < nh ? tex[v] : v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) tex[tid + THREADS * i] = nv[i];
    __syncthreads();
  }

  // 4. the chain: F(t) from tile t-1, F(t+1) published at once
  if (tid == 0) {
    int f = 0;
    if (t > 0) {
      for (;;) {
        const unsigned long long s = ld_status(&ts[t - 1].hop);
        if (flag_of(s, epoch) == FLAG_P) {
          f = (int)(unsigned)s;
          break;
        }
      }
    }
    const int fr = f - base;
    st_status(&ts[t].hop, epoch, FLAG_P, fr < nh ? base + tex[fr] : f);
    s_f = fr;
  }
  __syncthreads();

  // 5. the orbit in the tile: span entries, segment entries, segment walks
  if (tid == 0) {
    int e = s_f;
    for (int w = 0; w < WARPS; ++w) {
      s_went[w] = e;
      if (e < min((w + 1) * SPAN, nh)) e = wex[e];
    }
  }
  __syncthreads();
  int mine = 0;  // the first orbit position at or past seg0
  {
    int e = s_went[warp];
#pragma unroll 1
    for (int k = 0; k < 32; ++k) {
      if (lane == k) mine = e;
      if (e < min(wlo + (k + 1) * PER, nh)) e = s16[e];
    }
  }
  const int lim = min(seg0 + PER, nh);
  Agg a{0, 0, 0, 0, 0};
  for (int x = mine; x < lim;) {
    const int l = lb[x];
    if (l > 1) {
      const int m = base + x;
      const int L = lens[m];
      if (a.cnt == 0) {
        a.m0 = m;
        a.ml0 = L - MIN_MATCH;
      } else {
        a.bytes += seq_bytes(m - a.rl, L - MIN_MATCH);
      }
      a.rl = m + L;
      ++a.cnt;
    }
    x += l;
  }

  // 6. the layout: block scan of the segments' aggregates
  Agg inc = a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Agg o = shfl_up(inc, off);
    if (lane >= off) inc = combine(o, inc);
  }
  Agg before = shfl_up(inc, 1);  // the warp's segments before this one
  if (lane == 0) before = Agg{0, 0, 0, 0, 0};
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Agg w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Agg o = shfl_up(w, off);
      if (lane >= off) w = combine(o, w);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) before = combine(s_warp[warp - 1], before);

  // ... and across tiles: decoupled look-back
  if (tid == 0) {
    const Agg tile_agg = s_warp[WARPS - 1];
    Agg excl{1, 0, 0, 0, 0};  // the virtual match that ends at 0
    if (t > 0) {
      put_agg(ts[t].pay, tile_agg);
      __threadfence();
      st_status(&ts[t].scan, epoch, FLAG_A, 0);
      excl = Agg{0, 0, 0, 0, 0};
      for (int u = t - 1;;) {
        const unsigned f = flag_of(ld_status(&ts[u].scan), epoch);
        if (f == 0) continue;
        __threadfence();
        if (f == FLAG_P) {
          excl = combine(get_agg(ts[u].pay + 5), excl);
          break;
        }
        excl = combine(get_agg(ts[u].pay), excl);
        --u;
      }
    }
    const Agg incl = combine(excl, tile_agg);
    put_agg(ts[t].pay + 5, incl);
    __threadfence();
    st_status(&ts[t].scan, epoch, FLAG_P, 0);
    s_prefix = excl;
    if (t == tiles - 1) {  // the closing literals-only sequence
      const int cnt = incl.cnt - 1, nl = N - incl.rl;
      soff[cnt] = incl.bytes;
      rec[cnt] = make_int4(incl.rl, nl, 0, 0);
      meta[0] = incl.bytes + 1 + ext_count(nl) + nl;
      meta[1] = cnt + 1;
    }
  }
  __syncthreads();

  // 7. the segment's sequences at their ranks
  const Agg p = combine(s_prefix, before);
  int cnt = p.cnt - 1, bytes = p.bytes, rl = p.rl;
  for (int x = mine; x < lim;) {
    const int l = lb[x];
    if (l > 1) {
      const int m = base + x;
      const int L = lens[m];
      const int nl = m - rl, mlc = L - MIN_MATCH;
      soff[cnt] = bytes;
      rec[cnt] = make_int4(rl, nl, mlc, dists[m]);
      bytes += seq_bytes(nl, mlc);
      rl = m + L;
      ++cnt;
    }
    x += l;
  }
}

__device__ __forceinline__ int ext_byte(int v, int k) {  // k-th of put_ext(v)
  return k < v / 255 ? 255 : v - 255 * k;
}

// byte `rel` of a sequence (lit_from, num_lit, ml_code, dist)
__device__ __forceinline__ uint8_t seq_byte(
    const int4 r, int rel, bool last, const uint8_t* __restrict__ block) {
  const int nl = r.y, mlc = r.z;
  const int a_len = 1 + ext_count(nl);
  if (rel == 0)
    return (uint8_t)((min(nl, 15) << 4) | (last ? 0 : min(mlc, 15)));
  if (rel < a_len) return (uint8_t)ext_byte(nl - 15, rel - 1);
  rel -= a_len;
  if (rel < nl) return __ldg(block + r.x + rel);
  rel -= nl;
  if (rel == 0) return (uint8_t)(r.w & 0xFF);
  if (rel == 1) return (uint8_t)((r.w >> 8) & 0xFF);
  return (uint8_t)ext_byte(mlc - 15, rel - 2);
}

__global__ void __launch_bounds__(OUT_THREADS)
emit_bytes_kernel(const uint8_t* __restrict__ block,
                  const int32_t* __restrict__ soff,
                  const int4* __restrict__ rec,
                  const int32_t* __restrict__ meta, uint8_t* __restrict__ out,
                  int cap) {
  __shared__ int s_lo, s_hi;
  __shared__ int s_off[OUT_SEQS];
  __shared__ int4 s_rec[OUT_SEQS];
  const int n_out = meta[0], S = meta[1];
  const int o0 = blockIdx.x * OUT_TILE;
  const int o = o0 + threadIdx.x * OUT_BYTES;
  uint32_t w[OUT_BYTES / 4] = {0, 0, 0, 0};
  if (o0 < n_out) {  // the same for the whole block
    if (threadIdx.x < 2) {  // the last sequence at or before the tile's ends
      const int target =
          threadIdx.x == 0 ? o0 : min(o0 + OUT_TILE, n_out) - 1;
      int lo = 0, hi = S - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (soff[mid] <= target) lo = mid;
        else hi = mid - 1;
      }
      if (threadIdx.x == 0) s_lo = lo;
      else s_hi = lo;
    }
    __syncthreads();
    const int lo = s_lo, cnt = min(s_hi - s_lo + 1, OUT_SEQS);
    for (int i = threadIdx.x; i < cnt; i += OUT_THREADS) {
      s_off[i] = soff[lo + i];
      s_rec[i] = rec[lo + i];
    }
    __syncthreads();
    if (o < n_out) {
      int k = 0, hi = cnt - 1;  // the last staged sequence at or before o
      while (k < hi) {
        const int mid = (k + hi + 1) >> 1;
        if (s_off[mid] <= o) k = mid;
        else hi = mid - 1;
      }
#pragma unroll
      for (int j = 0; j < OUT_BYTES; ++j) {
        const int oj = o + j;
        if (oj >= n_out) break;
        while (k + 1 < cnt && s_off[k + 1] <= oj) ++k;
        w[j / 4] |= (uint32_t)seq_byte(s_rec[k], oj - s_off[k],
                                       lo + k == S - 1, block)
                    << (8 * (j % 4));
      }
    }
  }
  if (o + OUT_BYTES <= cap) {
    *reinterpret_cast<uint4*>(out + o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int j = 0; o + j < cap; ++j)
      out[o + j] = (uint8_t)(w[j / 4] >> (8 * (j % 4)));
  }
}

int tiles_of(int N) { return (N + TILE - 1) / TILE; }
int seq_cap(int N) { return N / 2 + 3; }  // matches are >= 2 positions

}  // namespace

extern "C" {

// -> the most positions of s4_emit (no launch)
int s4_emit_max_n() { return MAX_N; }

// N -> int64 status words of s4_emit's state after the counter (no launch)
int s4_emit_status_words(int N) {
  return tiles_of(N) * (int)(sizeof(TileState) / 8);
}

// N -> int32 words of s4_emit's scratch (no launch)
int s4_emit_scratch_words(int N) { return 5 * seq_cap(N); }

// Serialize one block's final parse: `block` [N] bytes, `lens` [N] int32
// (16-byte aligned; 1 = literal, else the match length) and `dists` [N]
// int32 into `out` [N + N/255 + 16] bytes (16-byte aligned): the payload
// of native.emit_block, then zeros; `meta` [2] int32 receives n_out and
// the sequence count.  `scratch` (s4_emit_scratch_words(N) int32, 16-byte
// aligned) holds the sequence table.  `state` holds the tile counter
// (word 0) and s4_emit_status_words(N) status words; it is zeroed before
// the first call and reused by every later call on the stream with epochs
// 1, 2, ... <= 2^30 - 1: 7 words a tile (the chain's status, the
// look-back's status, 5 words of payload).  Two launches on `stream`.
int s4_emit(const uint8_t* block, const int32_t* lens, const int32_t* dists,
            uint8_t* out, int32_t* meta, int32_t* scratch,
            unsigned long long* state, int N, unsigned epoch, void* stream) {
  if (N < 1 || N > MAX_N || epoch < 1 || epoch > EPOCH_MAX ||
      ((uintptr_t)lens & 15) || ((uintptr_t)out & 15) ||
      ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(N), sc = seq_cap(N);
  int4* rec = reinterpret_cast<int4*>(scratch);
  int32_t* soff = scratch + 4 * sc;
  const cudaError_t err = cudaFuncSetAttribute(
      emit_orbit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ORBIT_SMEM);
  if (err != cudaSuccess) return (int)err;
  emit_orbit_kernel<<<tiles, THREADS, ORBIT_SMEM, st>>>(
      lens, dists, soff, rec, meta, reinterpret_cast<TileState*>(state + 1),
      reinterpret_cast<unsigned*>(state), N, tiles, epoch);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const int cap = N + N / 255 + 16;
  emit_bytes_kernel<<<(cap + OUT_TILE - 1) / OUT_TILE, OUT_THREADS, 0, st>>>(
      block, soff, rec, meta, out, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
