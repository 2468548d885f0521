// Per-lane row gathers from a float table, and their backward, the
// scatter-add of the lanes' gradients into the table's rows, for NVIDIA
// Hopper (sm_90a).  Bound in ops/gather_cuda.py (gather_rows,
// scatter_rows), which the renderer's per-lane fetches go through: the face
// rows of the hit triangles, the material rows, the light intensities.
//
// These replace no TPU kernel.  The JAX package selects the rows of a
// small table with a one-hot product on the TPU's matrix unit and leaves
// the other gathers, and their scatter-add transposes, to XLA.  They were
// added because of PyTorch's backward of table[idx] on the card
// (index_put_ with accumulate): it sorts the ids, then walks each run of
// equal ids serially, one warp per distinct row.  With one area light
// every lane of a pass adds into one row of the light table, and a floor
// of two triangles sends a large share of the screen to two rows of the
// face table, so those walks are tens of thousands of dependent steps.
//
// What bounds them: bytes.  The gather reads n ids and n rows of C values
// and writes n x C values; the scatter reads the n ids and the n x C
// upstream gradients and writes the R x C table once.  For a 65,536-lane
// pass over the 15,752 x 34 face table that is 8.9 MB in and 2.1 MB out,
// a few microseconds at 3.35 TB/s.
//
// Design, against that bound:
//   * ids are clamped to [0, R-1] here, so callers launch no clamp;
//   * gather: one thread per output value, neighbouring threads on
//     neighbouring columns of a row;
//   * scatter: a warp takes 32 consecutive lanes (neighbouring pixels of
//     render.swizzle_order's screen blocks, which mostly share rows),
//     groups equal ids with __match_any_sync, and sums each group per
//     column by a fixed tree of shuffles into its lowest lane, so 32 lanes
//     on one row make one update.  Two variants, by the table's size, which
//     the wrapper sees:
//       - block (a table of at most BLOCK_TABLE_BYTES: a light or material
//         table): each warp adds its groups' sums into its own copy of the
//         table in shared memory; the block sums its warps' copies in warp
//         order into its slot of a partials buffer, and a one-block second
//         pass sums the slots in block order into the table.  Device memory
//         sees R x C writes a block, and the result does not depend on the
//         order the blocks ran in;
//       - warp (larger tables: the face table): the wrapper sorts the
//         ids (a stable sort, so equal ids keep their lanes' order), and
//         each warp reduces 32 consecutive sorted lanes, whose equal ids
//         now sit side by side.  A run of equal ids strictly inside the
//         tile is whole, and its sum is stored in the table; the tile's
//         first and last runs, which may go on in the tiles beside it,
//         become two entries of a sequence 16 times shorter, sorted too,
//         which the next level reduces the same way, until one tile is
//         left.  Every row is written once, by plain stores, and every sum
//         is taken in an order fixed by the sorted lanes: the result does
//         not depend on scheduling either;
//   * with a work pointer (tracing on), a launch adds the lane-columns it
//     scattered and its updates (the values it writes: the table's rows and
//     the partials) to two device counters: their ratio is the merge
//     factor.
//   * nothing is allocated here: the wrapper passes the table (zeroed for
//     the warp variant, whose untouched rows are never written), the sort
//     and the partials buffers.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename I>
__device__ __forceinline__ int clamp_row(I id, int rows) {
  return id < 0 ? 0 : (id >= rows ? rows - 1 : static_cast<int>(id));
}

// The fixed binomial tree that sums a group of lanes (peers: the group's
// mask, this lane's bit included) into its lowest lane.  At level k every
// lane still in the tree adds the partial sum of the next lane above it
// that is still in it, and the lanes whose rank in the group has bit k set
// leave.  src[k] is the lane read at level k, -1 for none.  Depends only on
// the masks, so the sums do not change from run to run.
struct Tree {
  int src[5];
  int levels;
};

__device__ __forceinline__ Tree make_tree(unsigned peers, int lane) {
  Tree t;
  t.levels = 0;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    t.src[k] = -1;
    if (!__any_sync(FULL, above != 0u)) continue;
    t.src[k] = __ffs(above) - 1;
    above &= ~__ballot_sync(FULL, (rank >> k) & 1);
    t.levels = k + 1;
  }
  return t;
}

template <typename T>
__device__ __forceinline__ T tree_sum(const Tree& t, T v, int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k >= t.levels) break;
    const int s = t.src[k];
    const T o = __shfl_sync(FULL, v, s < 0 ? lane : s);
    if (s >= 0) v += o;
  }
  return v;
}

// A lane's values of columns [c0, c0 + UNROLL), 0 past cols or on a dead
// lane, all loaded before any is summed, so that their loads overlap.
constexpr int UNROLL = 4;

template <typename T>
__device__ __forceinline__ void load_columns(const T* in, int c0, int cols,
                                             bool live, T (&v)[UNROLL]) {
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    v[k] = live && c0 + k < cols ? in[c0 + k] : T(0);
}

// Adds (lane-columns, updates) of a block to work[0], work[1]: one atomic
// each a block.
__device__ __forceinline__ void count_work(unsigned long long cols_done,
                                           unsigned long long updates,
                                           unsigned long long* work) {
  __shared__ unsigned long long s_cols[WARPS], s_upd[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cols_done += __shfl_down_sync(FULL, cols_done, off);
    updates += __shfl_down_sync(FULL, updates, off);
  }
  if (lane == 0) {
    s_cols[warp] = cols_done;
    s_upd[warp] = updates;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long c = 0, u = 0;
    for (int w = 0; w < WARPS; ++w) {
      c += s_cols[w];
      u += s_upd[w];
    }
    atomicAdd(work, c);
    atomicAdd(work + 1, u);
  }
}

template <typename T, typename I, typename E>
__global__ void __launch_bounds__(BLOCK)
    gather_rows_kernel(const T* __restrict__ table, const I* __restrict__ ids,
                       E total, int rows, int cols, T* __restrict__ out) {
  const E step = static_cast<E>(gridDim.x) * BLOCK;
  for (E e = static_cast<E>(blockIdx.x) * BLOCK + threadIdx.x; e < total;
       e += step) {
    const E i = e / static_cast<E>(cols);
    const int c = static_cast<int>(e - i * static_cast<E>(cols));
    const long long r = clamp_row(ids[i], rows);
    out[e] = table[r * cols + c];
  }
}

// Warp variant, one level: warp w reduces entries [32w, 32w + 32) of a
// sequence sorted by key (level 0: the lanes in the stable order of their
// ids, values read through perm; later levels: the entries the level before
// emitted).  A group strictly inside the tile is whole and goes to the
// table; the tile's first and last groups become the next level's entries
// 2w and 2w + 1 (a tile of one group sends its sum and a zero); at the last
// level (one tile) every group goes to the table.
template <typename T, typename K>
__global__ void __launch_bounds__(BLOCK)
    reduce_runs_kernel(const T* __restrict__ vals, const K* __restrict__ keys,
                       const long long* __restrict__ perm, long long n,
                       int rows, int cols, bool last, T* __restrict__ table,
                       T* __restrict__ next_vals, int* __restrict__ next_keys,
                       unsigned long long lane_cols,
                       unsigned long long* work) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x) >> 5;
  const long long j = w * 32 + lane;
  const bool live = j < n;
  const int key = live ? clamp_row(keys[j], rows) : -1;
  const unsigned peers = __match_any_sync(FULL, key);
  const Tree tree = make_tree(peers, lane);
  const bool lead = live && lane == __ffs(peers) - 1;
  const long long span = n - w * 32;
  const int last_lane = span >= 32 ? 31 : (span > 0 ? int(span) - 1 : 0);
  const bool first = key == __shfl_sync(FULL, key, 0);
  const bool at_end = key == __shfl_sync(FULL, key, last_lane);
  const bool whole = last || (!first && !at_end);
  const long long slot = 2 * w + (first ? 0 : 1);
  const T* in = vals + (live ? (perm != nullptr ? perm[j] : j) : 0) * cols;
  unsigned updates = 0;
  for (int c0 = 0; c0 < cols; c0 += UNROLL) {
    T v[UNROLL];
    load_columns(in, c0, cols, live, v);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int c = c0 + k;
      if (c >= cols) break;
      const T sum = tree_sum(tree, v[k], lane);
      if (!lead) continue;
      if (whole) {
        table[static_cast<long long>(key) * cols + c] = sum;
      } else {
        next_vals[slot * cols + c] = sum;
        if (first && at_end) next_vals[(slot + 1) * cols + c] = T(0);
      }
      ++updates;
    }
  }
  if (lead && !whole) {
    next_keys[slot] = key;
    if (first && at_end) next_keys[slot + 1] = key;
  }
  if (work != nullptr) {
    count_work(0ull, updates, work);
    if (threadIdx.x == 0 && blockIdx.x == 0) atomicAdd(work, lane_cols);
  }
}

// Block variant, first pass: lanes [blockIdx.x * per_block, + per_block) into
// partial[blockIdx.x] (R x C values).  Shared memory: WARPS copies of the
// table.
template <typename T, typename I>
__global__ void __launch_bounds__(BLOCK)
    scatter_block_kernel(const T* __restrict__ src, const I* __restrict__ ids,
                         long long n, int rows, int cols, long long per_block,
                         T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* copies = reinterpret_cast<T*>(smem);
  const int size = rows * cols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < WARPS * size; e += BLOCK) copies[e] = T(0);
  __syncthreads();
  T* mine = copies + warp * size;
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = min(n, begin + per_block);
  for (long long base = begin + warp * 32; base < end; base += BLOCK) {
    const long long i = base + lane;
    const bool live = i < end;
    const int row = live ? clamp_row(ids[i], rows) : -1;
    const unsigned peers = __match_any_sync(FULL, row);
    const Tree tree = make_tree(peers, lane);
    const bool lead = live && lane == __ffs(peers) - 1;
    for (int c0 = 0; c0 < cols; c0 += UNROLL) {
      T v[UNROLL];
      load_columns(src + (live ? i : 0) * cols, c0, cols, live, v);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (c0 + k >= cols) break;
        const T sum = tree_sum(tree, v[k], lane);
        if (lead) mine[row * cols + c0 + k] += sum;
      }
    }
    __syncwarp();
  }
  __syncthreads();
  T* out = partial + static_cast<long long>(blockIdx.x) * size;
  for (int e = threadIdx.x; e < size; e += BLOCK) {
    T s = copies[e];
    for (int w = 1; w < WARPS; ++w) s += copies[w * size + e];
    out[e] = s;
  }
}

// Block variant, second pass (one block): the table is the sum of the
// partials in block order.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    sum_partials_kernel(const T* __restrict__ partial, int blocks, int size,
                        T* __restrict__ table, unsigned long long lane_cols,
                        unsigned long long* work) {
  for (int e = threadIdx.x; e < size; e += BLOCK) {
    T s = partial[e];
    for (int b = 1; b < blocks; ++b)
      s += partial[static_cast<long long>(b) * size + e];
    table[e] = s;
  }
  if (work != nullptr && threadIdx.x == 0) {
    atomicAdd(work, lane_cols);
    atomicAdd(work + 1, static_cast<unsigned long long>(blocks) * size);
  }
}

int blocks_for(long long items) {
  const long long b = (items + BLOCK - 1) / BLOCK;
  return static_cast<int>(b < (1ll << 30) ? b : (1ll << 30));
}

template <typename T, typename I>
cudaError_t gather(const void* table, const void* ids, long long n, int rows,
                   int cols, void* out, cudaStream_t stream) {
  const long long total = n * cols;
  const int grid = blocks_for(total);
  if (total <= 0xffffffffll)
    gather_rows_kernel<T, I, unsigned><<<grid, BLOCK, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const I*>(ids),
        static_cast<unsigned>(total), rows, cols, static_cast<T*>(out));
  else
    gather_rows_kernel<T, I, unsigned long long><<<grid, BLOCK, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const I*>(ids),
        static_cast<unsigned long long>(total), rows, cols,
        static_cast<T*>(out));
  return cudaGetLastError();
}

// Entries of the level after a level of n entries (0: none, n fits a tile).
long long next_level(long long n) { return n > 32 ? 2 * ((n + 31) / 32) : 0; }

template <typename T, typename I>
cudaError_t scatter_warp(const void* src, const void* sorted_ids,
                         const long long* perm, long long n, int rows,
                         int cols, void* table, void* vals_a, int* keys_a,
                         void* vals_b, int* keys_b, void* work,
                         cudaStream_t stream) {
  T* out = static_cast<T*>(table);
  unsigned long long* wk = static_cast<unsigned long long*>(work);
  const unsigned long long lane_cols = static_cast<unsigned long long>(n) * cols;
  long long m = next_level(n);
  reduce_runs_kernel<T, I><<<blocks_for(n), BLOCK, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const I*>(sorted_ids), perm, n,
      rows, cols, m == 0, out, static_cast<T*>(vals_a), keys_a, lane_cols,
      wk);
  cudaError_t e = cudaGetLastError();
  // Level l writes the (l + 1)-th sequence, to a when l + 1 is odd and to
  // b when it is even, and level l + 1 reads it there; the sequences
  // shorten 16-fold a level, so a (the first) and b (the second) hold them.
  for (int level = 1; e == cudaSuccess && m > 0; ++level) {
    const long long next = next_level(m);
    const bool odd = level & 1;
    reduce_runs_kernel<T, int><<<blocks_for(m), BLOCK, 0, stream>>>(
        static_cast<const T*>(odd ? vals_a : vals_b), odd ? keys_a : keys_b,
        nullptr, m, rows, cols, next == 0, out,
        static_cast<T*>(odd ? vals_b : vals_a), odd ? keys_b : keys_a, 0ull,
        wk);
    e = cudaGetLastError();
    m = next;
  }
  return e;
}

template <typename T, typename I>
cudaError_t scatter_block(const void* src, const void* ids, long long n,
                          int rows, int cols, int blocks, long long per_block,
                          void* partial, void* table, void* work,
                          cudaStream_t stream) {
  const size_t smem = sizeof(T) * WARPS * rows * cols;
  scatter_block_kernel<T, I><<<blocks, BLOCK, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const I*>(ids), n, rows, cols,
      per_block, static_cast<T*>(partial));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_partials_kernel<T><<<1, BLOCK, 0, stream>>>(
      static_cast<const T*>(partial), blocks, rows * cols,
      static_cast<T*>(table), static_cast<unsigned long long>(n) * cols,
      static_cast<unsigned long long*>(work));
  return cudaGetLastError();
}

// dtype: 0 float32, 1 float64; idtype: 0 int32, 1 int64.
#define RT_DISPATCH(FN, ...)                                             \
  do {                                                                   \
    cudaError_t e_ = cudaErrorInvalidValue;                              \
    if (dtype == 0 && idtype == 0) e_ = FN<float, int>(__VA_ARGS__);     \
    if (dtype == 0 && idtype == 1) e_ = FN<float, long long>(__VA_ARGS__); \
    if (dtype == 1 && idtype == 0) e_ = FN<double, int>(__VA_ARGS__);    \
    if (dtype == 1 && idtype == 1)                                       \
      e_ = FN<double, long long>(__VA_ARGS__);                           \
    return static_cast<int>(e_);                                         \
  } while (0)

}  // namespace

// out (n, cols) = table[clamp(ids, 0, rows - 1)].
extern "C" int rt_gather_rows(const void* table, const void* ids, int dtype,
                              int idtype, long long n, int rows, int cols,
                              void* out, void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  RT_DISPATCH(gather, table, ids, n, rows, cols, out,
              static_cast<cudaStream_t>(stream));
}

// table (rows, cols), zeroed by the caller, += src (n, cols) by row
// clamp(ids, 0, rows - 1), given the ids stably sorted and perm, the lane of
// each sorted id; vals_a/keys_a hold next_level(n) entries, vals_b/keys_b
// next_level(next_level(n)); work: null, or two int64 counters.
extern "C" int rt_scatter_rows_warp(const void* src, const void* sorted_ids,
                                    const long long* perm, int dtype,
                                    int idtype, long long n, int rows,
                                    int cols, void* table, void* vals_a,
                                    int* keys_a, void* vals_b, int* keys_b,
                                    void* work, void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  RT_DISPATCH(scatter_warp, src, sorted_ids, perm, n, rows, cols, table,
              vals_a, keys_a, vals_b, keys_b, work,
              static_cast<cudaStream_t>(stream));
}

// table (rows, cols) = the sum of src (n, cols) by row clamp(ids, 0,
// rows - 1), through partial (blocks, rows, cols); every value of table is
// written.  blocks x per_block covers the n lanes.
extern "C" int rt_scatter_rows_block(const void* src, const void* ids,
                                     int dtype, int idtype, long long n,
                                     int rows, int cols, int blocks,
                                     long long per_block, void* partial,
                                     void* table, void* work, void* stream) {
  if (n <= 0 || cols <= 0 || blocks <= 0) return 0;
  RT_DISPATCH(scatter_block, src, ids, n, rows, cols, blocks, per_block,
              partial, table, work, static_cast<cudaStream_t>(stream));
}
