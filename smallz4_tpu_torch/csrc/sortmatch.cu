// Neighbour scan and same-distance chain of the sort search (Hopper, sm_90a).
//
// Replaces the TPU kernels of smallz4_tpu/ops/sortmatch.py:
//   * s4_scan  -> _scan_kernel (_neighbor_scan), and the unsort that follows
//     it there (the second sort_records call, keyed by the raw position);
//   * s4_chain -> _chain_kernel (_chain).
//
// Scan.  `rec` holds a batch of sorted record rows laid out [B][5][n] int32:
// planes k1 (4-byte gram), k2 (prefix hash, unused here), pos_t (position,
// +2^30 for records that may not match), e1 and e2 (the next two 4-byte
// little-endian words).  Every sorted slot probes the slots at +-{1..8, 12,
// 16, 24, 32, 48, 64} of its own row.  A neighbour with the same gram at a
// distance of 1..65535 is a candidate; its length is 4 plus the equal
// leading bytes of the two payload words (4..12, byte-verified); the longest
// wins and the nearest breaks a tie.  Flags: bit 0, the length reached the
// 12-byte verification reach; bit 1, a neighbour at +-8 shares the gram
// (the group may extend beyond the contiguous probes), whatever its
// distance.  The raw positions (pos_t & (2^30 - 1)) of a row are a
// permutation of [0, n), so storing each result at its raw position is the
// reference's unsort.
//
// Bound at the dispatch shape [8, 5, 2^17]: 16 bytes read and 12 written a
// record, 29.36 MB, 8.76 us at 3.35 TB/s.  The operations its data needs,
// counted by chip_smoke.scan_work on the fixture's dispatch records:
// 20.9M probes compared up to the first other gram, 19.7M that meet their
// gram, 8.8M candidates, 173M integer operations: 2.6 us at 67 TOP/s, but
// compares, logic and shifts issue at a quarter of that rate on an SM
// (16 lanes a scheduler), so about 10 us.  The numbers below are device
// times on an H100 80GB HBM3 at 700 W (scripts/torch_scan_times.py).
//
// The first design, kept as history: one thread a sorted slot; a block
// staged its 256-slot tile and a +-64-slot halo of the four planes (1.5x
// the reads), ran all 28 probes with a per-row range test each, and stored
// its three results at the record's raw position: three scattered 4-byte
// stores a record, each in its own 32-byte sector.  0.0494 ms on the
// dispatch records, 18% of the bound.  Copies cut after each phase:
// staging alone 0.0060 ms, staging and probes with coalesced stores
// 0.0396, staging and the scatter of constants 0.0427: the probes and the
// scatter each cost about 0.035 ms, overlapped.
//
// Design: two kernels (s4_scan), so that the probes run on the whole card
// and the unsort coalesces.
//   * scan_probe_kernel: a block stages a tile of 1,984 sorted slots and 64
//     either side as {k1, pos, e1, e2} records (1.06x the reads); 512
//     threads, 4 slots a thread; 67 tiles a row, 536 blocks at 3 an SM (40
//     registers, 42 KiB): all 132 SMs busy, 1.35 waves.  A
//     pair (i, i + k) is probed once, by slot i going forward: its LCP
//     serves both ends, and it is a candidate of at most one of them (d and
//     -d cannot both lie in 1..65535): of i in a register, or of i + k by a
//     shared-memory max into an array that covers every staged slot.  The
//     best is one packed score, the max of lcp << 16 | (0xFFFF - d): the
//     longest wins and the nearest breaks a tie, as the reference's rule
//     does, since a slot's distances are distinct.  The LCP is the leading
//     zero bytes of the byte-swapped xor of e1 (of e2 where e1 agrees).  A
//     warp stops probing at the first offset where none of its slots meets
//     its gram.  That needs equal grams contiguous in each row, as
//     sort_records(rec, n_keys=2) sorts by k1 first: a farther probe then
//     never meets it either (tests/test_torch_sortmatch.py holds the
//     sorted segment records to it).  Only a row's last tiles test its end.
//     A slot's result is one 21-bit word (dist | group << 16 | len << 17):
//     a warp whose records hold consecutive positions stores its planes in
//     place (coalesced); the others' words go out grouped by owner, the
//     2,048-position span their position falls in, at the tile's slots of
//     `entries` (a warp-wide rank where the warp's records share an owner,
//     else a shared-memory add a record), with the groups' starts in
//     `table`.
//   * scan_unsort_kernel, one block an owner span of a row (64 x 8 = 512
//     blocks of 256 threads, all resident on the 132 SMs): it reads the
//     span's segment of every tile from `table`, gathers its entries (all
//     of a thread's loads in flight at once), places them in shared
//     memory, and writes the positions it received to the three planes,
//     16 bytes a store.
//     No cluster: 16-block clusters of 8 rows fit only 7 at a time on the
//     card (cudaOccupancyMaxActiveClusters), and distributed shared memory
//     took one remote 4-byte store per record at about one an SM every
//     4-5 cycles: an unsort through 16-block clusters ran 0.0278 ms, this
//     one 0.0090.
// On the dispatch records: probe kernel 0.0271 ms, unsort 0.0090, 0.0361
// in all, 24% of the bound.  What holds it: the probe loop issues about 24
// instructions a live pair (load, compare and warp vote, two range tests,
// the byte count, the score and two maxes) at the integer issue rate, and
// the unsort pays two dependent trips to memory (table, then entries).
// Batches of at most 2^18 records and rows past s4_scan_row_max()
// (524,288) take s4_scan_direct: the probe kernel on 448-slot tiles (more
// blocks for a small batch), storing every result in place, one launch.
//
// Chain.  Position-order lengths and distances [B][n]: `steps` doubling
// steps len[p] = max(len[p], s + len[p+s]) where p + s < n, dist[p] ==
// dist[p+s] >= 1 and len[p] >= s, s = 1, 2, 4, ...  Each step reads the
// previous step's lengths (the reference rebinds the whole array per step);
// a step with s >= n changes nothing and is skipped.
//
// Bound: one read of lens and dists and one write of the result, 12 bytes
// a position (3.76 us at [8, 131072] and 15.0 us at [64, 65536] on
// 3.35 TB/s).  A launch per step streams the row through L2 once a step,
// so the design keeps a row on chip for all its steps, in one launch: a
// row is split over a thread-block cluster of C <= 8 blocks (the portable
// size; 16-block clusters do not all fit on the card at once), each
// holding a slice of L = 2^k <= 16,384 positions in shared memory: its
// distances and two length buffers (192 KiB at L = 16,384).  Slices are as
// large as they go, since a row takes C SMs and the 64 rows of a chunk
// group then run in two waves.  Step k reads buffer k & 1 and writes
// buffer ~k & 1, from its own slice or a peer's through distributed shared
// memory, so one cluster barrier a step orders it (no thread sees a
// half-updated step).  A thread owns groups of 4 consecutive positions,
// 1,024 groups apart, and keeps their lengths, their distances and the
// longest length among their positions that may grow (dist >= 1) in
// registers.  A group reads its neighbour group (16 bytes of each plane)
// only when that length is at least s, and stores its lengths only where
// they differ from what the buffer already holds (the lengths of two
// steps back; lengths only grow).  Positions past n hold dist 0, so the
// test dist[p] == dist[p+s] >= 1 also covers p + s < n.  What remains is
// a few microseconds a step: the SM's instruction and shared-memory rate
// over the slice's active groups, then the cluster barrier.  Rows longer
// than 131,072 take s4_chain_wide: one launch a step, ping-pong between
// the output and a scratch buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_PROBE = 64;
constexpr int N_PROBES = 14;
constexpr int MAX_DISTANCE = 65535;
constexpr int EXT_REACH = 12;
constexpr uint32_t POS_MASK = (1u << 30) - 1;
constexpr int MAX_ROWS = 65535;       // the grid's y dimension, a row each
constexpr int SCAN_THREADS = 512;     // probe kernel
constexpr int SCAN_HALO = MAX_PROBE;  // slots staged either side of a tile

// Sorted slots a probe block owns when a thread probes `passes` slots:
// with the halo before it, one slot a thread in each pass.
__host__ __device__ constexpr int scan_tile(int passes) {
  return passes * SCAN_THREADS - SCAN_HALO;
}

constexpr int SPREAD_PASSES = 4;      // s4_scan: 1,984-slot tiles
constexpr int DIRECT_PASSES = 1;      // s4_scan_direct: 448-slot tiles
constexpr int OWNER_LOG = 11;         // positions an unsort block owns:
constexpr int OWNER_SPAN = 1 << OWNER_LOG;  // 11 bits of an entry
constexpr int MAX_OWNERS = 256;
constexpr int SCAN_ROW_MAX = MAX_OWNERS * OWNER_SPAN;
constexpr int MAX_TILES =
    (SCAN_ROW_MAX + scan_tile(SPREAD_PASSES) - 1) / scan_tile(SPREAD_PASSES);
constexpr int UNSORT_THREADS = 256;
constexpr int UNSORT_PER = OWNER_SPAN / UNSORT_THREADS;  // entries a thread
// batches of at most this many records take s4_scan_direct
constexpr int DIRECT_MAX_RECORDS = 1 << 18;
constexpr int STEP_THREADS = 256;     // s4_chain_wide
constexpr int CHAIN_THREADS = 1024;   // s4_chain: one block a slice
constexpr int CHAIN_SLICE = 16384;    // most positions a block holds
constexpr int CHAIN_CLUSTER = 8;      // most blocks a row (portable)
constexpr int CHAIN_ROW_MAX = CHAIN_CLUSTER * CHAIN_SLICE;

// The forward probes of the slot at staged index c (slot i of the row, i =
// t0 - SCAN_HALO + c): pairs (i, i + k) for k in PROBES up to the first
// other gram.  A pair with equal grams at a distance of 1..65535 is a
// candidate of the end with the larger position: of slot i (returned as
// its best score, which only a tile slot keeps), else of slot i + k (a
// shared-memory max into acc[c + k]; every probe stores, 0 where it has no
// candidate, and acc covers every staged slot, so no test of the tile's
// bounds).  A score is lcp << 16 | (0xFFFF - d), 0 for none.  `gm8`: the
// gram of i + 8 equals i's.  EDGE: the row may end within 64 slots of i
// (`lim` = n - 1 - i, the farthest offset inside the row).  Every lane of
// the warp calls it.
template <bool EDGE>
__device__ __forceinline__ int probe_forward(const int4* __restrict__ s_rec,
                                             int* s_acc, int c, bool active,
                                             int lim, bool& gm8) {
  const int probes[N_PROBES] = {1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, 48, 64};
  const int4 me = s_rec[c];
  bool alive = active;
  int best = 0;
  gm8 = false;
#pragma unroll
  for (int q = 0; q < N_PROBES; ++q) {
    const int k = probes[q];
    const int4 nb = s_rec[c + k];
    alive = alive && nb.x == me.x && (!EDGE || k <= lim);
    if (!__any_sync(0xffffffffu, alive)) break;  // the warp's groups ended
    if (k == 8) gm8 = alive;
    const int u = me.y - nb.y;  // the distance seen from slot i
    const bool mine = alive && (unsigned)(u - 1) < (unsigned)MAX_DISTANCE;
    const bool theirs =
        alive && (unsigned)(u + MAX_DISTANCE) < (unsigned)MAX_DISTANCE;
    // equal leading payload bytes: the trailing zero bytes of the xor of
    // e1, then of e2 (little-endian words), as leading zero bytes of the
    // byte-swapped word
    const uint32_t x1 = (uint32_t)(me.z ^ nb.z);
    const uint32_t v = x1 ? x1 : (uint32_t)(me.w ^ nb.w);
    const int bytes = ((x1 ? 0 : 32) + __clz(__byte_perm(v, 0, 0x0123))) >> 3;
    const int score = ((4 + bytes) << 16) + (0xFFFF - abs(u));
    best = max(best, mine ? score : 0);
    atomicMax(&s_acc[c + k], theirs ? score : 0);
  }
  return best;
}

// Inclusive prefix sums of a[0..m) in shared memory, by one warp: lane l
// sums its run of ceil(m / 32) elements, the warp scans the runs' sums.
__device__ void warp_scan(int* a, int m) {
  const int lane = threadIdx.x & 31;
  const int per = (m + 31) / 32;
  const int lo = min(lane * per, m), hi = min(lo + per, m);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  int run = incl - sum;
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
}

// A slot's result word (21 bits): dist | group_more << 16 | len << 17.
__device__ __forceinline__ int result_word(int score, bool gm) {
  const int dist = score ? 0xFFFF - (score & 0xFFFF) : 0;
  return dist | (int)gm << 16 | (score >> 16) << 17;
}

__device__ __forceinline__ int4 word_planes(int w) {  // len, dist, flags
  const int len = w >> 17;
  return make_int4(len, w & 0xFFFF,
                   (len >= EXT_REACH ? 1 : 0) | (w >> 16 & 1) << 1, 0);
}

// One tile of scan_tile(PASSES) sorted slots a block: stage the tile and
// SCAN_HALO slots either side as {k1, pos, e1, e2} records, probe every
// slot of the tile and of the halo before it forward, and give out each
// tile slot's result: as the three planes at the slot's raw position
// (without SPREAD, or where a warp's records are in position order), else
// as entries (position within its owner's span << 21 | word) grouped by
// owner (position >> OWNER_LOG) at the tile's slots of `entries`, with
// the owners' starts (owners + 1 offsets) in the tile's row of `table`.
template <int PASSES, bool SPREAD, bool EDGE>
__device__ __forceinline__ void probe_tile(int4* s_rec, int* s_acc,
                                           int* s_hist, int32_t* olen,
                                           int32_t* odist, int32_t* oflag,
                                           int32_t* entries, int32_t* table,
                                           int t0, int n, int owners) {
  const int tile = min(scan_tile(PASSES), n - t0);
  int best[PASSES];
  unsigned gm = 0;  // bit p: slot of pass p shares its gram at +-8
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int c = p * SCAN_THREADS + (int)threadIdx.x;
    const int i = t0 - SCAN_HALO + c;
    const bool active = i >= 0 && c < SCAN_HALO + tile;
    bool gm8;
    best[p] = probe_forward<EDGE>(s_rec, s_acc, c, active, n - 1 - i, gm8);
    // the slot 8 back (staged: c - 8 >= 56 for a tile slot)
    const bool back8 = c >= SCAN_HALO && i >= 8 && s_rec[c - 8].x == s_rec[c].x;
    gm |= (unsigned)(gm8 || back8) << p;
  }
  __syncthreads();  // every pair's max is in acc
  int word[PASSES], raw[PASSES], rank[PASSES];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int c = p * SCAN_THREADS + (int)threadIdx.x;
    // a tile slot of a permutation row (raw >= n: dropped)
    raw[p] = (int)((uint32_t)s_rec[c].y & POS_MASK);
    const bool kept = c >= SCAN_HALO && c < SCAN_HALO + tile && raw[p] < n;
    word[p] = result_word(max(best[p], s_acc[c]), gm >> p & 1);
    // in place: every result of the direct route, and the warp's results
    // where its kept records hold consecutive positions (records in
    // position order: the stores coalesce)
    const unsigned act = __ballot_sync(0xffffffffu, kept);
    const int leader = act ? __ffs(act) - 1 : 0;
    const int r0 = __shfl_sync(0xffffffffu, raw[p], leader) - leader;
    rank[p] = -1;
    if (!SPREAD || __all_sync(0xffffffffu, !kept || raw[p] == r0 + lane)) {
      if (kept) {
        const size_t o = (size_t)blockIdx.y * n + raw[p];
        const int4 v = word_planes(word[p]);
        olen[o] = v.x;
        odist[o] = v.y;
        oflag[o] = v.z;
      }
      continue;
    }
    // rank among the tile's records of its owner: a shared-memory add a
    // record, or one a warp whose records share an owner (records in
    // position order)
    const int o = raw[p] >> OWNER_LOG;
    const int o0 = __shfl_sync(0xffffffffu, o, leader);
    if (__all_sync(0xffffffffu, !kept || o == o0)) {
      int base = 0;
      if (act && lane == leader) base = atomicAdd(&s_hist[o0], __popc(act));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (kept) rank[p] = base + __popc(act & ((1u << lane) - 1));
    } else if (kept) {
      rank[p] = atomicAdd(&s_hist[o], 1);
    }
  }
  if (!SPREAD) return;
  __syncthreads();  // the counts are in; s_rec is read
  if (threadIdx.x < 32) warp_scan(s_hist, owners);
  __syncthreads();
  // the owners' starts: 0, then the inclusive sums
  for (int o = threadIdx.x; o <= owners; o += SCAN_THREADS)
    table[o] = o ? s_hist[o - 1] : 0;
  int* stage = reinterpret_cast<int*>(s_rec);
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (rank[p] < 0) continue;
    const int o = raw[p] >> OWNER_LOG;
    stage[(o ? s_hist[o - 1] : 0) + rank[p]] =
        (raw[p] & (OWNER_SPAN - 1)) << 21 | word[p];
  }
  __syncthreads();
  const int kept = s_hist[owners - 1];
  for (int x = threadIdx.x; x < kept; x += SCAN_THREADS)
    entries[t0 + x] = stage[x];
}

template <int PASSES, bool SPREAD>
__global__ void __launch_bounds__(SCAN_THREADS, 3)
scan_probe_kernel(const int32_t* __restrict__ rec, int32_t* olen,
                  int32_t* odist, int32_t* oflag, int32_t* entries,
                  int32_t* table, int n, int owners) {
  constexpr int TILE = scan_tile(PASSES);
  constexpr int STAGED = TILE + 2 * SCAN_HALO;
  __shared__ int4 s_rec[STAGED];
  __shared__ int s_acc[STAGED];
  __shared__ int s_hist[SPREAD ? MAX_OWNERS : 1];
  const int t0 = blockIdx.x * TILE;
  const int32_t* k1 = rec + (size_t)blockIdx.y * 5 * n;
  const int32_t* pos = k1 + 2 * (size_t)n;
  const int32_t* e1 = k1 + 3 * (size_t)n;
  const int32_t* e2 = k1 + 4 * (size_t)n;
#pragma unroll
  for (int x = threadIdx.x; x < STAGED; x += SCAN_THREADS) {
    const int g = t0 - SCAN_HALO + x;
    s_rec[x] = g >= 0 && g < n ? make_int4(k1[g], pos[g], e1[g], e2[g])
                               : make_int4(0, 0, 0, 0);
    s_acc[x] = 0;
  }
  if (SPREAD)
    for (int o = threadIdx.x; o < owners; o += SCAN_THREADS) s_hist[o] = 0;
  __syncthreads();
  int32_t* erow = SPREAD ? entries + (size_t)blockIdx.y * n : nullptr;
  int32_t* trow =
      SPREAD ? table + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                           (owners + 1)
             : nullptr;
  if (t0 + TILE + SCAN_HALO <= n)  // interior: no range test
    probe_tile<PASSES, SPREAD, false>(s_rec, s_acc, s_hist, olen, odist,
                                      oflag, erow, trow, t0, n, owners);
  else
    probe_tile<PASSES, SPREAD, true>(s_rec, s_acc, s_hist, olen, odist,
                                     oflag, erow, trow, t0, n, owners);
}

// One owner's span of OWNER_SPAN positions of one row a block: gather its
// entries from every tile of the row (the tiles' segments for this owner,
// laid end to end; every load of a thread in flight at once), place each
// word at its position in shared memory, and write the positions that
// received one to the three planes, with 16-byte stores where four in a
// row did (`vec`: n % 4 == 0 and 16-byte aligned planes).
__global__ void __launch_bounds__(UNSORT_THREADS)
scan_unsort_kernel(const int32_t* __restrict__ entries,
                   const int32_t* __restrict__ table, int32_t* olen,
                   int32_t* odist, int32_t* oflag, int n, int tiles,
                   int owners, bool vec) {
  constexpr int TILE = scan_tile(SPREAD_PASSES);
  __shared__ __align__(16) int slice[OWNER_SPAN];
  __shared__ int s_from[MAX_TILES];  // the segment's first entry
  __shared__ int s_end[MAX_TILES];   // entries of segments 0..t (sums)
  const int o = blockIdx.x;
  const size_t row = (size_t)blockIdx.y * n;
  const int32_t* trow = table + (size_t)blockIdx.y * tiles * (owners + 1);
  for (int t = threadIdx.x; t < tiles; t += UNSORT_THREADS) {
    const int lo = trow[t * (owners + 1) + o];
    s_from[t] = t * TILE + lo;
    s_end[t] = trow[t * (owners + 1) + o + 1] - lo;
  }
  // -1: no entry (the probe kernel stored the position in place)
  for (int i = threadIdx.x; i < OWNER_SPAN; i += UNSORT_THREADS) slice[i] = -1;
  __syncthreads();
  if (threadIdx.x < 32) warp_scan(s_end, tiles);
  __syncthreads();
  const int total = s_end[tiles - 1];  // OWNER_SPAN but in a row's last span
  int at[UNSORT_PER], v[UNSORT_PER];
#pragma unroll
  for (int j = 0; j < UNSORT_PER; ++j) {
    const int e = (int)threadIdx.x + j * UNSORT_THREADS;
    at[j] = -1;
    if (e >= total) continue;
    int lo = 0, hi = tiles - 1;  // the first segment ending past e
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_end[mid] > e) hi = mid; else lo = mid + 1;
    }
    at[j] = s_from[lo] + e - (lo ? s_end[lo - 1] : 0);
  }
#pragma unroll
  for (int j = 0; j < UNSORT_PER; ++j)
    v[j] = at[j] >= 0 ? entries[row + at[j]] : 0;
#pragma unroll
  for (int j = 0; j < UNSORT_PER; ++j)
    if (at[j] >= 0) slice[(uint32_t)v[j] >> 21] = v[j] & 0x1FFFFF;
  __syncthreads();
  const int p0 = o * OWNER_SPAN;
  const int span = min(OWNER_SPAN, n - p0);
  for (int i = 4 * (int)threadIdx.x; i < span; i += 4 * UNSORT_THREADS) {
    const int4 w = *reinterpret_cast<const int4*>(slice + i);
    if (vec && (w.x | w.y | w.z | w.w) >= 0) {  // all four received
      const int4 a = word_planes(w.x), b = word_planes(w.y),
                 c = word_planes(w.z), d = word_planes(w.w);
      *reinterpret_cast<int4*>(olen + row + p0 + i) =
          make_int4(a.x, b.x, c.x, d.x);
      *reinterpret_cast<int4*>(odist + row + p0 + i) =
          make_int4(a.y, b.y, c.y, d.y);
      *reinterpret_cast<int4*>(oflag + row + p0 + i) =
          make_int4(a.z, b.z, c.z, d.z);
      continue;
    }
    const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ws[j] < 0 || i + j >= span) continue;
      const int4 a = word_planes(ws[j]);
      olen[row + p0 + i + j] = a.x;
      odist[row + p0 + i + j] = a.y;
      oflag[row + p0 + i + j] = a.z;
    }
  }
}

__global__ void chain_step_kernel(const int32_t* __restrict__ len_in,
                                  const int32_t* __restrict__ dist,
                                  int32_t* __restrict__ len_out, int n,
                                  int s, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int p = (int)(i % n);
  int ln = len_in[i];
  const int d = dist[i];
  if (p + s < n && d >= 1 && ln >= s && dist[i + s] == d) {
    const int ext = (int)((unsigned)s + (unsigned)len_in[i + s]);
    ln = ext > ln ? ext : ln;
  }
  len_out[i] = ln;
}

__device__ __forceinline__ int4 load4(const int32_t* row, int p, int n,
                                      bool vec) {
  if (vec && p + 4 <= n) return *reinterpret_cast<const int4*>(row + p);
  return make_int4(p < n ? row[p] : 0, p + 1 < n ? row[p + 1] : 0,
                   p + 2 < n ? row[p + 2] : 0, p + 3 < n ? row[p + 3] : 0);
}

__device__ __forceinline__ int grow(int l, int d, int nl, int nd, int s) {
  const int ext = (int)((unsigned)s + (unsigned)nl);  // wraps like int32
  return d >= 1 && l >= s && nd == d ? max(l, ext) : l;
}

// the longest length of a group's positions that may grow (dist >= 1)
__device__ __forceinline__ int may_grow(int4 l, int4 d) {
  return max(max(d.x >= 1 ? l.x : INT_MIN, d.y >= 1 ? l.y : INT_MIN),
             max(d.z >= 1 ? l.z : INT_MIN, d.w >= 1 ? l.w : INT_MIN));
}

// One row a cluster, one slice of 4 << log_gl positions a block; G groups
// of 4 positions a thread.  Shared memory: dist, length buffers 0 and 1,
// each 1 << log_gl int4.
template <int G>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
chain_cluster_kernel(const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ dists,
                     int32_t* __restrict__ out, int n, int log_gl,
                     int steps, bool vec) {
  extern __shared__ int4 sm4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int GL = 1 << log_gl;
  int4* sd = sm4;
  int4* buf0 = sm4 + GL;
  int4* buf1 = sm4 + 2 * GL;
  const int r = (int)cluster.block_rank();
  const int total = (int)cluster.num_blocks() << log_gl;  // groups held
  const size_t row = (size_t)blockIdx.y * n;
  // per group: lengths after the last step, distances, may_grow of them;
  // bit j of `moved`: group j changed in the last step
  int4 ln[G], dd[G];
  int mg[G];
  unsigned moved = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int gl = threadIdx.x + j * CHAIN_THREADS;
    if (gl >= GL) break;
    const int p = ((r << log_gl) + gl) * 4;
    ln[j] = load4(lens + row, p, n, vec);
    dd[j] = load4(dists + row, p, n, vec);
    mg[j] = may_grow(ln[j], dd[j]);
    sd[gl] = dd[j];
    buf0[gl] = ln[j];
    buf1[gl] = ln[j];
  }
  cluster.sync();  // every slice is loaded before a peer reads it
  for (int k = 0; k < steps; ++k) {
    const int s = 1 << k;
    const int4* cur = (k & 1) ? buf1 : buf0;  // holds step k's input
    int4* nxt = (k & 1) ? buf0 : buf1;        // holds step k - 1's input
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int gl = threadIdx.x + j * CHAIN_THREADS;
      if (gl >= GL) break;
      bool changed = false;
      if (mg[j] >= s) {  // some position may grow: read its neighbours
        const int4 l = ln[j], d = dd[j];
        int4 nl = make_int4(0, 0, 0, 0), nd = nl;  // dist 0: no growth
        // the group holding p + s (s >= 4) or the next group (s = 1, 2)
        const int gq = (r << log_gl) + gl + (s >= 4 ? s >> 2 : 1);
        if (gq < total) {
          const int rq = gq >> log_gl, lq = gq & (GL - 1);
          const int4* ql = rq == r ? cur : cluster.map_shared_rank(cur, rq);
          const int4* qd = rq == r ? sd : cluster.map_shared_rank(sd, rq);
          nl = ql[lq];
          nd = qd[lq];
        }
        if (s == 1) {
          nl = make_int4(l.y, l.z, l.w, nl.x);
          nd = make_int4(d.y, d.z, d.w, nd.x);
        } else if (s == 2) {
          nl = make_int4(l.z, l.w, nl.x, nl.y);
          nd = make_int4(d.z, d.w, nd.x, nd.y);
        }
        const int4 v = make_int4(grow(l.x, d.x, nl.x, nd.x, s),
                                 grow(l.y, d.y, nl.y, nd.y, s),
                                 grow(l.z, d.z, nl.z, nd.z, s),
                                 grow(l.w, d.w, nl.w, nd.w, s));
        changed = v.x != l.x || v.y != l.y || v.z != l.z || v.w != l.w;
        if (changed) {
          ln[j] = v;
          mg[j] = may_grow(v, d);
        }
      }
      // lengths only grow, so the buffer (two steps back) differs from the
      // new lengths exactly when this step or the last one changed them
      if (k + 1 < steps && (changed || (moved >> j & 1))) nxt[gl] = ln[j];
      moved = (moved & ~(1u << j)) | ((unsigned)changed << j);
    }
    cluster.sync();  // step k's reads and writes are done; a block leaves
                     // only after its peers' last reads of its slice
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int gl = threadIdx.x + j * CHAIN_THREADS;
    if (gl >= GL) break;
    const int p = ((r << log_gl) + gl) * 4;
    int32_t* o = out + row;
    if (vec && p + 4 <= n) {
      *reinterpret_cast<int4*>(o + p) = ln[j];
    } else {
      const int v[4] = {ln[j].x, ln[j].y, ln[j].z, ln[j].w};
      for (int e = 0; e < 4 && p + e < n; ++e) o[p + e] = v[e];
    }
  }
}

template <int G>
cudaError_t launch_chain(const int32_t* lens, const int32_t* dists,
                         int32_t* out, int B, int n, int C, int log_gl,
                         int steps, cudaStream_t stream) {
  const auto kern = chain_cluster_kernel<G>;
  const int smem = (int)(3 * sizeof(int4)) << log_gl;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(CHAIN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // 16-byte loads and stores where every row starts on 16 bytes
  const bool vec = (n & 3) == 0 && ((uintptr_t)lens & 15) == 0 &&
                   ((uintptr_t)dists & 15) == 0 && ((uintptr_t)out & 15) == 0;
  return cudaLaunchKernelEx(&cfg, kern, lens, dists, out, n, log_gl, steps,
                            vec);
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Longest row and most rows of s4_scan, and the most records (B * n) a
// call of the wrapper sends to s4_scan_direct (no launch).
int s4_scan_row_max() { return SCAN_ROW_MAX; }
int s4_scan_max_rows() { return MAX_ROWS; }
int s4_scan_direct_max() { return DIRECT_MAX_RECORDS; }

// int32 words of s4_scan's `table` a row (no launch).
int s4_scan_table_row(int n) {
  if (n < 1 || n > SCAN_ROW_MAX) return -1;
  constexpr int TILE = scan_tile(SPREAD_PASSES);
  return (n + TILE - 1) / TILE * ((n + OWNER_SPAN - 1) / OWNER_SPAN + 1);
}

// Probe every sorted slot of `rec` ([B][5][n], n <= SCAN_ROW_MAX) and store
// (len, dist, flags) at each record's raw position in `olen`, `odist`,
// `oflag` ([B][n]).  Scratch: `entries` [B][n] and `table` [B][table_row]
// int32.  Two launches: the probe kernel (entries grouped by owner, and
// the table of the groups' starts), then the unsort kernel.
int s4_scan(const int32_t* rec, int32_t* olen, int32_t* odist, int32_t* oflag,
            int32_t* entries, int32_t* table, int B, int n, void* stream) {
  if (B < 1 || B > MAX_ROWS || n < 1 || n > SCAN_ROW_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int TILE = scan_tile(SPREAD_PASSES);
  const int tiles = (n + TILE - 1) / TILE;
  const int owners = (n + OWNER_SPAN - 1) / OWNER_SPAN;
  scan_probe_kernel<SPREAD_PASSES, true>
      <<<dim3(tiles, B), SCAN_THREADS, 0, st>>>(rec, olen, odist, oflag,
                                                entries, table, n, owners);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool vec = (n & 3) == 0 && ((uintptr_t)olen & 15) == 0 &&
                   ((uintptr_t)odist & 15) == 0 && ((uintptr_t)oflag & 15) == 0;
  scan_unsort_kernel<<<dim3(owners, B), UNSORT_THREADS, 0, st>>>(
      entries, table, olen, odist, oflag, n, tiles, owners, vec);
  return (int)cudaGetLastError();
}

// The same in one launch for rows of any length: the probe kernel on
// 448-slot tiles stores each result at its raw position (scattered
// stores).
int s4_scan_direct(const int32_t* rec, int32_t* olen, int32_t* odist,
                   int32_t* oflag, int B, int n, void* stream) {
  if (B < 1 || B > MAX_ROWS || n < 1) return (int)cudaErrorInvalidValue;
  constexpr int TILE = scan_tile(DIRECT_PASSES);
  scan_probe_kernel<DIRECT_PASSES, false>
      <<<dim3((n + TILE - 1) / TILE, B), SCAN_THREADS, 0,
          static_cast<cudaStream_t>(stream)>>>(rec, olen, odist, oflag,
                                               nullptr, nullptr, n, 0);
  return (int)cudaGetLastError();
}

// Longest row s4_chain takes (no launch); longer rows take s4_chain_wide.
int s4_chain_row_max() { return CHAIN_ROW_MAX; }

// `steps` doubling steps over `lens`/`dists` ([B][n], n <= CHAIN_ROW_MAX)
// into `out`, one launch.  `lens` is not modified.
int s4_chain(const int32_t* lens, const int32_t* dists, int32_t* out, int B,
             int n, int steps, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || n > CHAIN_ROW_MAX || steps < 0 ||
      steps > 30)
    return (int)cudaErrorInvalidValue;
  int live = 0;  // steps with s < n
  while (live < steps && (1 << live) < n) ++live;
  // the largest slices (the fewest clusters: a wave holds 132 blocks)
  const int L = min(next_pow2(n < 4 ? 4 : n), CHAIN_SLICE);
  const int C = next_pow2((n + L - 1) / L);
  const int log_gl = 31 - __builtin_clz((unsigned)(L / 4));
  const int groups = (L / 4 + CHAIN_THREADS - 1) / CHAIN_THREADS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (groups <= 1)
    e = launch_chain<1>(lens, dists, out, B, n, C, log_gl, live, st);
  else if (groups == 2)
    e = launch_chain<2>(lens, dists, out, B, n, C, log_gl, live, st);
  else
    e = launch_chain<4>(lens, dists, out, B, n, C, log_gl, live, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The same for rows of any length: one launch a step with s < n, over
// `out` and `tmp` (scratch of the same size); a copy when no step is left.
int s4_chain_wide(const int32_t* lens, const int32_t* dists, int32_t* out,
                  int32_t* tmp, int B, int n, int steps, void* stream) {
  if (B < 1 || n < 1 || steps < 0 || steps > 30)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * n;
  int live = 0;
  while (live < steps && (1 << live) < n) ++live;
  if (live == 0) {
    return (int)cudaMemcpyAsync(out, lens, total * sizeof(int32_t),
                                cudaMemcpyDeviceToDevice, s);
  }
  const unsigned blocks = (unsigned)((total + STEP_THREADS - 1) / STEP_THREADS);
  const int32_t* src = lens;
  for (int i = 0; i < live; ++i) {
    // ping-pong so that the last step lands in `out`
    int32_t* dst = ((live - 1 - i) % 2 == 0) ? out : tmp;
    chain_step_kernel<<<blocks, STEP_THREADS, 0, s>>>(src, dists, dst, n,
                                                      1 << i, total);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    src = dst;
  }
  return 0;
}

}  // extern "C"
