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
// Bound: the scan reads 16 bytes and writes 12 per record; its 28 probes
// take some 20 integer operations each, which puts it at the border of the
// memory and the instruction rate.  Design: one thread per sorted slot; a
// block stages its 256-slot tile and a +-64-slot halo of the four planes in
// shared memory, so the probes read shared memory only; the stores are
// scattered.
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

constexpr int SCAN_THREADS = 256;
constexpr int MAX_PROBE = 64;
constexpr int N_PROBES = 14;
constexpr int MAX_DISTANCE = 65535;
constexpr int EXT_REACH = 12;
constexpr uint32_t POS_MASK = (1u << 30) - 1;
constexpr int STEP_THREADS = 256;     // s4_chain_wide
constexpr int CHAIN_THREADS = 1024;   // s4_chain: one block a slice
constexpr int CHAIN_SLICE = 16384;    // most positions a block holds
constexpr int CHAIN_CLUSTER = 8;      // most blocks a row (portable)
constexpr int CHAIN_ROW_MAX = CHAIN_CLUSTER * CHAIN_SLICE;

// equal leading bytes of a little-endian xor word: its trailing zero bytes,
// 4 when the words are equal (__clz(0) == 32)
__device__ __forceinline__ int zero_bytes(uint32_t x) {
  return __clz(__brev(x)) >> 3;
}

__global__ void scan_kernel(const int32_t* __restrict__ rec,
                            int32_t* __restrict__ olen,
                            int32_t* __restrict__ odist,
                            int32_t* __restrict__ oflag, int n) {
  constexpr int W = SCAN_THREADS + 2 * MAX_PROBE;
  __shared__ int32_t s_k1[W];
  __shared__ int32_t s_pos[W];
  __shared__ uint32_t s_e1[W];
  __shared__ uint32_t s_e2[W];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * SCAN_THREADS;
  const int32_t* k1 = rec + (size_t)b * 5 * n;
  const int32_t* pos = k1 + 2 * (size_t)n;
  const int32_t* e1 = k1 + 3 * (size_t)n;
  const int32_t* e2 = k1 + 4 * (size_t)n;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int g = t0 - MAX_PROBE + i;
    if (g >= 0 && g < n) {
      s_k1[i] = k1[g];
      s_pos[i] = pos[g];
      s_e1[i] = static_cast<uint32_t>(e1[g]);
      s_e2[i] = static_cast<uint32_t>(e2[g]);
    }
  }
  __syncthreads();
  const int slot = t0 + threadIdx.x;
  if (slot >= n) return;
  const int c = threadIdx.x + MAX_PROBE;
  const int32_t mk = s_k1[c];
  const int32_t mp = s_pos[c];
  const uint32_t me1 = s_e1[c];
  const uint32_t me2 = s_e2[c];
  const int probes[N_PROBES] = {1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, 48, 64};
  int best_len = 0, best_dist = 0;
  bool group_more = false;
#pragma unroll
  for (int q = 0; q < N_PROBES; ++q) {
#pragma unroll
    for (int sgn = 1; sgn >= -1; sgn -= 2) {
      const int k = probes[q] * sgn;
      if (slot + k < 0 || slot + k >= n) continue;  // per-row range
      const int cj = c + k;
      if (s_k1[cj] != mk) continue;
      if (probes[q] == 8) group_more = true;
      const int d = mp - s_pos[cj];
      if (d < 1 || d > MAX_DISTANCE) continue;
      const uint32_t x1 = me1 ^ s_e1[cj];
      const int w1 = zero_bytes(x1);
      const int lcp = 4 + (w1 < 4 ? w1 : 4 + zero_bytes(me2 ^ s_e2[cj]));
      if (lcp > best_len || (lcp == best_len && d < best_dist)) {
        best_len = lcp;
        best_dist = d;
      }
    }
  }
  const uint32_t dst = static_cast<uint32_t>(mp) & POS_MASK;
  if (dst >= static_cast<uint32_t>(n)) return;  // not a permutation row
  const size_t o = (size_t)b * n + dst;
  olen[o] = best_len;
  odist[o] = best_dist;
  oflag[o] = (best_len >= EXT_REACH ? 1 : 0) | (group_more ? 2 : 0);
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

// Probe every sorted slot of `rec` ([B][5][n]) and store (len, dist, flags)
// at each record's raw position in `olen`, `odist`, `oflag` ([B][n]).
int s4_scan(const int32_t* rec, int32_t* olen, int32_t* odist, int32_t* oflag,
            int B, int n, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((n + SCAN_THREADS - 1) / SCAN_THREADS, B);
  scan_kernel<<<grid, SCAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, olen, odist, oflag, n);
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
