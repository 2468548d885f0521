// Ray-triangle closest-hit and any-hit kernels for NVIDIA Hopper (sm_90a).
//
// These replace the two Pallas TPU kernels of
// redner_tpu/ops/pallas_intersect.py:
//   closest_hit_kernel  <- _closest_kernel (pallas_intersect.py:164), body
//                          _closest_body -> _mt_terms/_exact_hit/_closest_update
//   any_hit_kernel      <- _anyhit_kernel  (pallas_intersect.py:323), body
//                          _anyhit_body
//
// Work: for every active (ray tile, triangle chunk) pair, the four
// Moller-Trumbore numerators [det, u, v, t] = R . T of each (ray, triangle)
// pair, with R = [d, d x org, org, 1] (10 features per ray) and T the
// triangle's (10, 4) coefficient block (ops/intersect.py
// triangle_coefficients), then the division-free hit test of
// pallas_intersect.py:196-204 and t = s*t_num / |det| for hits.
//
// What bounds it: FP32 operations.  A test is the 19 nonzero coefficients
// of T (det: rows 0-2, u and v: rows 0-5, t: rows 6-9) as 4 MUL + 15 FMA,
// then the compare chain, all on the CUDA cores in exact f32: the TPU kernel
// ran the products on its bf16 matrix unit with split-precision tricks, and
// TF32 tensor cores would erase the ~1e-5 split of edge-sampling ray pairs
// just the same.  Coefficients (80 bytes a triangle) are read from L2 by
// every tile that culls the chunk in; rays are read once per work item.
//
// Design, against that bound:
//   * balanced work: the launcher's flat list of active (tile, chunk) pairs
//     (ops/intersect_cuda._active_lists) is cut into items of one tile x one
//     128-triangle quarter chunk, all of the same size.  A persistent grid
//     sized by the occupancy calculator fills every SM; each warp claims
//     items from a global counter (zeroed by the wrapper), so no tile's
//     chunk list sets the launch time;
//   * the list's length never reaches the host: the launch is sized by the
//     list's capacity, and the kernels read its count from device memory,
//     so a launch can be captured in a CUDA graph and replayed on other
//     rays (a count of 0 is a launch that does no work);
//   * one warp holds a whole 128-ray tile, 4 rays a thread in registers:
//     each staged triangle is five 16-byte broadcast reads from shared
//     memory that feed 4 tests, and the 4 x 4 independent FMA chains hide
//     the FMA latency;
//   * fewer instructions per test: the test runs in two parts, det, u and v
//     first (15 of the 19 products), then the t numerator, the t bounds and
//     (closest hit) the division, only where some ray of the thread passed
//     the first part.  Most triangles of an active chunk miss every ray of
//     a tile, so the warp mostly skips the second part.  The sign flip is
//     one lop3 per value;
//   * staging: the coefficients are packed per triangle (CoeffLayout.Tp,
//     20 floats: the 19 nonzero ones in test order + a pad), so a
//     64-triangle piece is one contiguous 5,120-byte block, copied with
//     16-byte cp.async into a two-piece ring per warp while the other piece
//     is tested; no block-wide barrier anywhere;
//   * closest hit: each thread keeps (best t, index) per ray over its item
//     with a strictly-smaller update in increasing index, then merges one
//     64-bit key per ray with atomicMin: order-preserving t bits in the high
//     word, sorted triangle index in the low word.  Equal t resolves to the
//     lower index, i.e. the earliest (chunk, index), exactly the Pallas
//     kernel's argmin + strict update (and closest_plain's); the wrapper
//     fills "no hit" first and unpacks after (ops/intersect_cuda
//     pack_hit_key / unpack_hit_key);
//   * any hit: the work list is rank-major (every tile's first active chunk,
//     then every tile's second, ...), so a tile's later chunks are claimed
//     after its earlier ones have run.  A lane that hits stores blocked = 1
//     (idempotent, no atomic); a warp reads its tile's flags when it starts
//     an item and skips it, or leaves it part-way, once all 128 rays are
//     settled (blocked, or tmax < tmin: dead or padding).  blocked is an OR
//     over the active pairs, so it does not depend on the order;
//   * the tail chunk's padded duplicates of the last sorted triangle are
//     not tested: a duplicate's test equals its original's, and the
//     original has the lower index, so neither result can change.
//
// Exactness: the FMA chains are those of the plain version's products
// (ops/intersect.py); the compares use __fadd_rn/__fmul_rn so no contraction
// changes them; t uses IEEE division.  The sign flip s*x with s = +-1 is
// done on the sign bit, which equals s*x exactly wherever |det| > 1e-8 (the
// only place the result is used).  Compiled without --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 128;                  // rays per tile (ops/intersect.TILE_N)
constexpr int CHUNK = 512;                 // triangles per coefficient chunk
constexpr int QUART = 128;                 // triangles per work item
constexpr int ITEMS_PER_PAIR = CHUNK / QUART;
constexpr int PIECE = 64;                  // triangles per staged piece
constexpr int STRIDE4 = 5;                 // float4s per packed triangle
constexpr int PIECE_F4 = PIECE * STRIDE4;  // 16-byte copies per piece
constexpr int RPT = TILE / 32;             // rays per thread: a warp holds a tile
constexpr int WARPS = 4;                   // independent warps per block
constexpr int BLOCK = WARPS * 32;
constexpr int MIN_BLOCKS = 3;              // per SM, for __launch_bounds__
constexpr int CHECK = 16;                  // any hit: triangles between votes
constexpr unsigned FULL = 0xffffffffu;
constexpr float MT_EPS = 1e-8f;
static_assert(QUART == 2 * PIECE, "the ring holds the two pieces of an item");
static_assert(PIECE_F4 % 32 == 0, "a piece is whole 16-byte copies per lane");

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the PIECE packed triangles from sorted index tri0 into dst.
__device__ __forceinline__ void stage(float4* dst, const float4* __restrict__ Tp,
                                      int tri0, int lane) {
  const float4* src = Tp + static_cast<size_t>(tri0) * STRIDE4;
#pragma unroll
  for (int e = lane; e < PIECE_F4; e += 32) cp_async16(dst + e, src + e);
}

// -------------------------------------------------------------- the test

struct Tri {
  float4 c0, c1, c2, c3, c4;
};

__device__ __forceinline__ Tri load_tri(const float4* p) {
  return Tri{p[0], p[1], p[2], p[3], p[4]};
}

struct Rays {
  float r[RPT][10];
  float lo[RPT], hi[RPT];
};

// The tile's rays: thread `lane` holds rays base + lane + 32 i.
__device__ __forceinline__ void load_rays(Rays& q, const float* __restrict__ R,
                                          const float* __restrict__ tmin,
                                          const float* __restrict__ tmax,
                                          int base) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int ray = base + 32 * i;
    const float2* p =
        reinterpret_cast<const float2*>(R + static_cast<size_t>(ray) * 10);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float2 v = __ldg(p + k);
      q.r[i][2 * k] = v.x;
      q.r[i][2 * k + 1] = v.y;
    }
    q.lo[i] = __ldg(tmin + ray);
    q.hi[i] = __ldg(tmax + ray);
  }
}

// x * s for s = (det >= 0 ? 1 : -1), as a sign-bit flip: one lop3,
// x ^ (det & 0x80000000).
__device__ __forceinline__ float flip(float x, float det) {
  unsigned y;
  asm("lop3.b32 %0, %1, %2, 0x80000000, 0x78;"
      : "=r"(y)
      : "r"(__float_as_uint(x)), "r"(__float_as_uint(det)));
  return __uint_as_float(y);
}

// The hit test in two parts.  bary_test: det and the barycentric bounds
// (adet > eps, u >= 0, v >= 0, u + v <= adet).  t_test: the t bounds
// (tmin*adet < ts < tmax*adet) and ts, so that t = ts / adet on a hit.  A
// hit passes both; the two are the one test of the plain version, split so
// that the t part runs only where some ray passed the first.
// c0 = D0 D1 D2 U0 | c1 = U1 U2 U3 U4 | c2 = U5 V0 V1 V2
// c3 = V3 V4 V5 T6 | c4 = T7 T8 T9 pad
__device__ __forceinline__ bool bary_test(const float* r, const Tri& c,
                                          float& det) {
  det = r[0] * c.c0.x;
  det = fmaf(r[1], c.c0.y, det);
  det = fmaf(r[2], c.c0.z, det);
  float un = r[0] * c.c0.w;
  un = fmaf(r[1], c.c1.x, un);
  un = fmaf(r[2], c.c1.y, un);
  un = fmaf(r[3], c.c1.z, un);
  un = fmaf(r[4], c.c1.w, un);
  un = fmaf(r[5], c.c2.x, un);
  float vn = r[0] * c.c2.y;
  vn = fmaf(r[1], c.c2.z, vn);
  vn = fmaf(r[2], c.c2.w, vn);
  vn = fmaf(r[3], c.c3.x, vn);
  vn = fmaf(r[4], c.c3.y, vn);
  vn = fmaf(r[5], c.c3.z, vn);
  const float adet = fabsf(det);
  const float u = flip(un, det);
  const float v = flip(vn, det);
  return (adet > MT_EPS) & (u >= 0.f) & (v >= 0.f) & (__fadd_rn(u, v) <= adet);
}

__device__ __forceinline__ bool t_test(const float* r, float lo, float hi,
                                       const Tri& c, float det, float& ts) {
  float tn = r[6] * c.c3.w;
  tn = fmaf(r[7], c.c4.x, tn);
  tn = fmaf(r[8], c.c4.y, tn);
  tn = fmaf(r[9], c.c4.z, tn);
  const float adet = fabsf(det);
  ts = flip(tn, det);
  return (ts > __fmul_rn(lo, adet)) & (ts < __fmul_rn(hi, adet));
}

// The closest-hit merge key (ops/intersect_cuda.pack_hit_key): signed
// order-preserving bits of t (-0 as +0) over the sorted triangle index.
__device__ __forceinline__ long long pack_key(float t, int idx) {
  int b = __float_as_int(t);
  if (b == static_cast<int>(0x80000000u)) b = 0;
  if (b < 0) b ^= 0x7fffffff;
  return static_cast<long long>(b) * 4294967296LL +
         static_cast<long long>(idx);
}

// ---------------------------------------------------------- per-item work

struct ClosestItem {
  float bt[RPT];
  int bi[RPT];
  bool skip;

  __device__ __forceinline__ void begin(const Rays& q, const int*, int) {
    bool dead = true;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bt[i] = CUDART_INF_F;
      bi[i] = -1;
      dead &= !(q.hi[i] >= q.lo[i]);
    }
    skip = __all_sync(FULL, dead);
  }

  // Tests triangles [idx0, idx0 + cnt) staged at buf.
  __device__ __forceinline__ void piece(const Rays& q, const float4* buf,
                                        int idx0, int cnt) {
    if (skip) return;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const Tri c = load_tri(buf + j * STRIDE4);
      float det[RPT];
      bool b[RPT];
      bool any = false;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        b[i] = bary_test(q.r[i], c, det[i]);
        any |= b[i];
      }
      if (!any) continue;
      float ts[RPT];
      any = false;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        b[i] &= t_test(q.r[i], q.lo[i], q.hi[i], c, det[i], ts[i]);
        any |= b[i];
      }
      if (!any) continue;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (b[i]) {
          const float t = __fdiv_rn(ts[i], fmaxf(fabsf(det[i]), MT_EPS));
          if (t < bt[i]) {
            bt[i] = t;
            bi[i] = idx0 + j;
          }
        }
      }
    }
  }

  __device__ __forceinline__ void end(long long* __restrict__ keys, int base) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (bi[i] >= 0) atomicMin(keys + base + 32 * i, pack_key(bt[i], bi[i]));
  }
};

struct AnyItem {
  bool settled[RPT];  // blocked before this item, dead or padding
  bool hit[RPT];      // blocked by this item
  bool skip;

  __device__ __forceinline__ void begin(const Rays& q,
                                        const int* __restrict__ blocked,
                                        int base) {
    bool all = true;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      settled[i] = !(q.hi[i] >= q.lo[i]) || __ldcg(blocked + base + 32 * i) != 0;
      hit[i] = false;
      all &= settled[i];
    }
    skip = __all_sync(FULL, all);
  }

  __device__ __forceinline__ void piece(const Rays& q, const float4* buf, int,
                                        int cnt) {
    for (int j0 = 0; j0 < cnt && !skip; j0 += CHECK) {
      const int j1 = min(j0 + CHECK, cnt);
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const Tri c = load_tri(buf + j * STRIDE4);
        float det[RPT];
        bool b[RPT];
        bool any = false;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          b[i] = bary_test(q.r[i], c, det[i]);
          any |= b[i];
        }
        if (any) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            float ts;
            hit[i] |= t_test(q.r[i], q.lo[i], q.hi[i], c, det[i], ts) & b[i];
          }
        }
      }
      bool all = true;
#pragma unroll
      for (int i = 0; i < RPT; ++i) all &= settled[i] | hit[i];
      skip = __all_sync(FULL, all);
    }
  }

  __device__ __forceinline__ void end(int* __restrict__ blocked, int base) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (hit[i]) blocked[base + 32 * i] = 1;
  }
};

// -------------------------------------------------------- persistent loop

__device__ __forceinline__ int claim(int* counter, int lane) {
  return lane == 0 ? atomicAdd(counter, 1) : 0;
}

// Item it: the first ray of its tile, and the sorted index of its first
// triangle.
__device__ __forceinline__ int2 item_of(const int2* __restrict__ pairs, int it) {
  const int2 p = pairs[it / ITEMS_PER_PAIR];
  return make_int2(p.x * TILE, p.y * CHUNK + (it % ITEMS_PER_PAIR) * QUART);
}

// Each warp claims items until the list is used up.  Piece 0 of the next
// item is copied while piece 1 of the current one is tested, and piece 1
// while piece 0 is tested.  Out is long long keys (closest) or int blocked.
template <class Item, class Out>
__device__ __forceinline__ void run_items(
    float4 (*ring)[PIECE_F4], const float* __restrict__ R,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float4* __restrict__ Tp, const int2* __restrict__ pairs,
    const int* __restrict__ count, int ntri, int* counter, Out* out) {
  const int nitems = __ldg(count) * ITEMS_PER_PAIR;
  const int lane = threadIdx.x & 31;
  int cur = __shfl_sync(FULL, claim(counter, lane), 0);
  if (cur < nitems) stage(ring[0], Tp, item_of(pairs, cur).y, lane);
  cp_commit();
  int next = claim(counter, lane);  // read after piece 0 has been tested
  while (cur < nitems) {
    const int2 it = item_of(pairs, cur);
    const int base = it.x + lane;
    stage(ring[1], Tp, it.y + PIECE, lane);
    cp_commit();
    Rays q;
    load_rays(q, R, tmin, tmax, base);
    Item w;
    w.begin(q, reinterpret_cast<const int*>(out), base);

    cp_wait<1>();
    __syncwarp();
    w.piece(q, ring[0], it.y, min(PIECE, ntri - it.y));
    __syncwarp();
    next = __shfl_sync(FULL, next, 0);
    if (next < nitems) stage(ring[0], Tp, item_of(pairs, next).y, lane);
    cp_commit();

    cp_wait<1>();
    __syncwarp();
    w.piece(q, ring[1], it.y + PIECE, min(PIECE, ntri - it.y - PIECE));
    __syncwarp();
    w.end(out, base);
    cur = next;
    next = claim(counter, lane);
  }
  cp_wait<0>();
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
closest_hit_kernel(const float* __restrict__ R, const float* __restrict__ tmin,
                   const float* __restrict__ tmax,
                   const float4* __restrict__ Tp,
                   const int2* __restrict__ pairs,
                   const int* __restrict__ count, int ntri, int* counter,
                   long long* keys) {
  __shared__ __align__(16) float4 ring[WARPS][2][PIECE_F4];
  run_items<ClosestItem>(ring[threadIdx.x >> 5], R, tmin, tmax, Tp, pairs,
                         count, ntri, counter, keys);
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
any_hit_kernel(const float* __restrict__ R, const float* __restrict__ tmin,
               const float* __restrict__ tmax, const float4* __restrict__ Tp,
               const int2* __restrict__ pairs, const int* __restrict__ count,
               int ntri, int* counter, int* blocked) {
  __shared__ __align__(16) float4 ring[WARPS][2][PIECE_F4];
  run_items<AnyItem>(ring[threadIdx.x >> 5], R, tmin, tmax, Tp, pairs, count,
                     ntri, counter, blocked);
}

// Blocks of a persistent grid: every SM filled at the occupancy the
// compiled kernel allows, and no more blocks than a full list's items
// (the capacity's) need.
template <class Kernel>
cudaError_t grid_for(Kernel kernel, int nitems, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
  const int want = (nitems + WARPS - 1) / WARPS;
  const int fill = sms * (per_sm > 0 ? per_sm : 1);
  *grid = want < fill ? want : fill;
  return e;
}

}  // namespace

// C interface, bound with ctypes by redner_tpu_torch/ops/intersect_cuda.py.
// R (ntile*128, 10), tmin/tmax (ntile*128,), Tp (nchunks*512, 20) f32;
// pairs (capacity, 2) int32 (tile, chunk), of which the first *count rows
// (count: one int32 in device memory, at most capacity) are the work;
// ntri real triangles (sorted slots at or above it are padding); counter
// one int32 set to 0.  Outputs: keys (ntile*128,) int64 filled with "no
// hit" (closest), or blocked (ntile*128,) int32 filled with 0 (any hit).
// Launches on `stream` (nothing for a capacity of 0), allocates nothing,
// never reads *count on the host, returns the first cudaError_t met.
extern "C" int rt_closest_hit(const float* R, const float* tmin,
                              const float* tmax, const float* Tp,
                              const int* pairs, int capacity, const int* count,
                              int ntri, int* counter, long long* keys,
                              void* stream) {
  if (capacity <= 0) return 0;
  int grid = 0;
  const cudaError_t e =
      grid_for(closest_hit_kernel, capacity * ITEMS_PER_PAIR, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  closest_hit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      R, tmin, tmax, reinterpret_cast<const float4*>(Tp),
      reinterpret_cast<const int2*>(pairs), count, ntri, counter, keys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_any_hit(const float* R, const float* tmin, const float* tmax,
                          const float* Tp, const int* pairs, int capacity,
                          const int* count, int ntri, int* counter,
                          int* blocked, void* stream) {
  if (capacity <= 0) return 0;
  int grid = 0;
  const cudaError_t e =
      grid_for(any_hit_kernel, capacity * ITEMS_PER_PAIR, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  any_hit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      R, tmin, tmax, reinterpret_cast<const float4*>(Tp),
      reinterpret_cast<const int2*>(pairs), count, ntri, counter, blocked);
  return static_cast<int>(cudaGetLastError());
}
