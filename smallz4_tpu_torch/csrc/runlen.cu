// Equal-byte run lengths (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/pallas_kernels.py
// _run_lengths_kernel (run_lengths): for every row of a batch of byte rows
// [B][n], R[i] = the length of the maximal run of equal bytes that starts at
// i, that is nb(i) - i + 1 where nb(i) is the nearest run boundary at or
// after i (i is a boundary when x[i] != x[i+1]; the last byte of a row
// always is).
//
// Bound: one byte in and four out per element, a few operations each:
// memory bound (1.57 us at [8, 131072] on 3.35 TB/s).  A forward search per
// tile for its trailing run would be quadratic on a row that is one run, so
// the kernel is a single-pass suffix-min scan of boundary indices with
// decoupled look-back, right to left, in one launch.  The batch is scanned
// as one flat array in which the last byte of every row is a boundary, so
// no run crosses a row.  A block takes a 4,096-byte tile, its index from an
// atomic counter in right-to-left order, so it only ever waits on tiles
// that already run.  A thread loads 16 bytes with one 16-byte load, finds
// its boundaries with byte compares in registers, and the block takes the
// suffix minimum of its threads' first boundaries with warp shuffles.  The
// tile publishes a status word at once: P with its first boundary when it
// has one (nothing to its right can be nearer), A ("none here") when it has
// none.  Then warp 0 looks right over windows of 32 status words, skips A
// tiles and takes the first P; a tile without a boundary then publishes P
// with what it found.  The last tile of the batch always holds a boundary,
// so the look-back ends; on a row that is one run every tile skips the A
// tiles up to the row's last tile, 32 a window.  Results go out through
// shared memory as 16-byte stores.  Status words carry the call's epoch, so
// words of earlier calls read as "not ready" and need no reset; the block
// that takes the last tile index sets the counter back to 0 for the next
// call on the stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int RL_THREADS = 256;
constexpr int RL_BYTES = 16;                      // bytes a thread
constexpr int RL_TILE = RL_THREADS * RL_BYTES;    // bytes a block
constexpr int RL_WARPS = RL_THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NONE = INT_MAX;
constexpr unsigned FLAG_A = 1, FLAG_P = 2;        // status flags
constexpr unsigned EPOCH_MAX = (1u << 30) - 1;

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

// bits 0..3: which of the 4 bytes of a __vcmpne4 result are set
__device__ __forceinline__ unsigned nibble(unsigned ne) {
  return (((ne & 0x01010101u) * 0x01020408u) >> 24) & 0xFu;
}

__global__ void __launch_bounds__(RL_THREADS)
run_lengths_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                   unsigned long long* __restrict__ status,
                   unsigned* __restrict__ counter, int N, int n, int tiles,
                   unsigned epoch) {
  __shared__ int s_tile, s_carry;
  __shared__ int s_warp[RL_WARPS];
  __shared__ int4 s_out[RL_TILE / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned v = atomicAdd(counter, 1u);
    if (v == (unsigned)tiles - 1) atomicExch(counter, 0u);  // all taken
    s_tile = tiles - 1 - (int)v;
  }
  __syncthreads();
  const int t = s_tile;
  const int f0 = t * RL_TILE + threadIdx.x * RL_BYTES;  // flat position

  // the thread's 16 bytes as 4 little-endian words, and the byte after them
  uint32_t w[5];
  if (f0 + RL_BYTES <= N) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + f0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int f = f0 + 4 * i + b;
        word |= (uint32_t)(f < N ? x[f] : 0) << (8 * b);
      }
      w[i] = word;
    }
  }
  w[4] = f0 + RL_BYTES < N ? x[f0 + RL_BYTES] : 0;
  // bit k: position f0 + k is a boundary
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m |= nibble(__vcmpne4(w[i], __funnelshift_r(w[i], w[i + 1], 8)))
         << (4 * i);
  for (long long re = ((long long)f0 / n + 1) * n - 1; re < f0 + RL_BYTES;
       re += n)
    m |= 1u << (int)(re - f0);  // the last byte of a row
  if (f0 + RL_BYTES > N) m &= f0 < N ? (1u << (N - f0)) - 1 : 0u;

  // suffix minimum of the threads' first boundaries: within the warp, then
  // over the later warps
  const int first = m ? f0 + __ffs(m) - 1 : NONE;
  int incl = first;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl = min(incl, o);
  }
  int later = __shfl_down_sync(FULL, incl, 1);
  if (lane == 31) later = NONE;
  if (lane == 0) s_warp[warp] = incl;
  __syncthreads();
  int tile_min = NONE;
#pragma unroll
  for (int i = 0; i < RL_WARPS; ++i) {
    if (i > warp) later = min(later, s_warp[i]);
    tile_min = min(tile_min, s_warp[i]);
  }

  if (warp == 0) {
    if (lane == 0)
      st_status(status + t, epoch, tile_min != NONE ? FLAG_P : FLAG_A,
                tile_min);
    int carry = NONE;  // the nearest boundary right of the tile
    for (int j = t + 1; j < tiles;) {
      const int idx = j + lane;
      unsigned flag = FLAG_P;  // past the last tile: never reached
      int value = NONE;
      if (idx < tiles) {
        const unsigned long long s = ld_status(status + idx);
        const unsigned hi = (unsigned)(s >> 32);
        flag = (hi >> 2) == epoch ? (hi & 3u) : 0u;  // other epochs: not ready
        value = (int)(unsigned)s;
      }
      const unsigned stop = __ballot_sync(FULL, flag != FLAG_A);
      if (stop == 0) {  // 32 tiles without a boundary
        j += 32;
        continue;
      }
      const int at = __ffs(stop) - 1;
      if (__shfl_sync(FULL, flag, at) == FLAG_P) {
        carry = __shfl_sync(FULL, value, at);
        break;
      }
      j += at;  // wait on the first tile that has not published yet
      __nanosleep(32);
    }
    if (lane == 0) {
      if (tile_min == NONE) st_status(status + t, epoch, FLAG_P, carry);
      s_carry = carry;
    }
  }
  __syncthreads();
  later = min(later, s_carry);

  int32_t* so = reinterpret_cast<int32_t*>(s_out) + threadIdx.x * RL_BYTES;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const unsigned mk = m >> k;
      const int nb = mk ? f0 + k + __ffs(mk) - 1 : later;
      r[e] = nb - (f0 + k) + 1;
    }
    *reinterpret_cast<int4*>(so + 4 * q) = make_int4(r[0], r[1], r[2], r[3]);
  }
  __syncthreads();
  const int base = t * RL_TILE;
  const int4* src = s_out;
#pragma unroll
  for (int q = 0; q < RL_BYTES / 4; ++q) {
    const int i = threadIdx.x + q * RL_THREADS;  // int4 index in the tile
    const int f = base + 4 * i;
    if (f + 4 <= N) {
      reinterpret_cast<int4*>(out + f)[0] = src[i];
    } else {
      const int32_t* v = reinterpret_cast<const int32_t*>(src + i);
      for (int e = 0; f + e < N && e < 4; ++e) out[f + e] = v[e];
    }
  }
}

}  // namespace

extern "C" {

// bytes a block of s4_run_lengths scans (no launch)
int s4_run_lengths_tile() { return RL_TILE; }

// Run lengths of every row of `x` ([B][n] bytes, 16-byte aligned) into
// `out` ([B][n] int32, 16-byte aligned), one launch.  `state` holds the
// tile counter (word 0) and ceil(B * n / tile) status words; it is zeroed
// before the first call and reused by every later call on the stream with
// epochs 1, 2, ... <= 2^30 - 1.
int s4_run_lengths(const uint8_t* x, int32_t* out, unsigned long long* state,
                   int B, int n, unsigned epoch, void* stream) {
  const long long N = (long long)B * n;
  if (B < 1 || n < 1 || N > INT_MAX - RL_TILE || epoch < 1 ||
      epoch > EPOCH_MAX || ((uintptr_t)x & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)((N + RL_TILE - 1) / RL_TILE);
  run_lengths_kernel<<<tiles, RL_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, out, state + 1, reinterpret_cast<unsigned*>(state), (int)N, n,
      tiles, epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
