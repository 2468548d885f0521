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
// What bounds it: ray-triangle tests at the FP32 CUDA-core rate.  The TPU
// kernel ran the products on its bf16 matrix unit with split-precision
// tricks; on Hopper every precision mode reduces to one exact-f32 path on
// the CUDA cores (TF32 tensor cores would erase the ~1e-5 split of
// edge-sampling ray pairs).  Of the 40 coefficients only 19 are nonzero by
// construction (det: rows 0-2, u and v: rows 0-5, t: rows 6-9), so a test
// is 19 FMAs plus the compare chain.  Coefficient bytes are small and are
// reread from L2 by every tile that culls the chunk in.
//
// Design (simple and exact first; wgmma/TMA variants come later):
//   * one block per 128-ray tile, one thread per ray; the thread keeps its
//     10 features, tmin and tmax in registers;
//   * the block walks its tile's CSR list of active chunks in increasing
//     chunk order (the launcher's conservative AABB culling);
//   * each 512-triangle chunk is staged through shared memory 128
//     triangles at a time (20 floats per triangle: the 19 nonzero
//     coefficients + 1 pad, read as five float4 broadcasts: every thread
//     reads the same triangle at the same time);
//   * closest hit keeps (best_t, best index) and replaces it only on a
//     strictly smaller t, so ties resolve to the earliest (chunk, index),
//     exactly as the Pallas kernel's per-chunk argmin + strict update does,
//     and the launcher's padded duplicates of the last triangle never win;
//   * any hit: a thread stops testing at its first hit; the block leaves
//     once every lane is settled (blocked, or tmax < tmin: dead/padding);
//   * tiles with no active chunk still write inf / -1 / not blocked.
//
// Compiled without --use_fast_math: t needs IEEE division.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 128;        // rays per block (ops/intersect.TILE_N)
constexpr int CHUNK = 512;       // triangles per coefficient chunk
constexpr int NCOL = 4 * CHUNK;  // columns of one chunk: [det|u|v|t] groups
constexpr int SUB = 128;         // triangles staged per shared-memory pass
constexpr int ROWS = 19;         // nonzero coefficients per triangle
constexpr int STRIDE = 20;       // floats per staged triangle (16-byte rows)
constexpr float MT_EPS = 1e-8f;

// Staged row r of a triangle -> (k, g) = (feature row, column group) in the
// chunk's (10, 4*CHUNK) block.
__device__ __forceinline__ int src_offset(int r) {
  if (r < 3) return r * NCOL;                          // det: k = 0..2
  if (r < 9) return (r - 3) * NCOL + CHUNK;            // u:   k = 0..5
  if (r < 15) return (r - 9) * NCOL + 2 * CHUNK;       // v:   k = 0..5
  return (r - 15 + 6) * NCOL + 3 * CHUNK;              // t:   k = 6..9
}

// Cooperative load of triangles [base, base + SUB) of chunk Tch into sT.
__device__ __forceinline__ void stage(float* sT, const float* __restrict__ Tch,
                                      int base) {
  for (int e = threadIdx.x; e < ROWS * SUB; e += TILE) {
    const int r = e / SUB;
    const int j = e - r * SUB;
    sT[j * STRIDE + r] = Tch[src_offset(r) + base + j];
  }
}

struct RayRegs {
  float r[10];
  float lo, hi;
};

__device__ __forceinline__ RayRegs load_ray(const float* __restrict__ R,
                                            const float* __restrict__ tmin,
                                            const float* __restrict__ tmax,
                                            int lane) {
  RayRegs q;
#pragma unroll
  for (int k = 0; k < 10; ++k) q.r[k] = R[lane * 10 + k];
  q.lo = tmin[lane];
  q.hi = tmax[lane];
  return q;
}

// Hit test of one staged triangle; returns true and t on a hit.
__device__ __forceinline__ bool test_tri(const RayRegs& q, const float* tri,
                                         float* t_out) {
  const float4 c0 = *reinterpret_cast<const float4*>(tri + 0);
  const float4 c1 = *reinterpret_cast<const float4*>(tri + 4);
  const float4 c2 = *reinterpret_cast<const float4*>(tri + 8);
  const float4 c3 = *reinterpret_cast<const float4*>(tri + 12);
  const float4 c4 = *reinterpret_cast<const float4*>(tri + 16);
  // rows: c0 = D0 D1 D2 U0 | c1 = U1 U2 U3 U4 | c2 = U5 V0 V1 V2
  //       c3 = V3 V4 V5 T6 | c4 = T7 T8 T9 pad
  const float* r = q.r;
  float det = r[0] * c0.x;
  det = fmaf(r[1], c0.y, det);
  det = fmaf(r[2], c0.z, det);
  float un = r[0] * c0.w;
  un = fmaf(r[1], c1.x, un);
  un = fmaf(r[2], c1.y, un);
  un = fmaf(r[3], c1.z, un);
  un = fmaf(r[4], c1.w, un);
  un = fmaf(r[5], c2.x, un);
  float vn = r[0] * c2.y;
  vn = fmaf(r[1], c2.z, vn);
  vn = fmaf(r[2], c2.w, vn);
  vn = fmaf(r[3], c3.x, vn);
  vn = fmaf(r[4], c3.y, vn);
  vn = fmaf(r[5], c3.z, vn);
  float tn = r[6] * c3.w;
  tn = fmaf(r[7], c4.x, tn);
  tn = fmaf(r[8], c4.y, tn);
  tn = fmaf(r[9], c4.z, tn);
  const float s = det >= 0.f ? 1.f : -1.f;
  const float adet = fabsf(det);
  const float u = s * un;
  const float v = s * vn;
  const float ts = s * tn;
  const bool hit = (adet > MT_EPS) & (u >= 0.f) & (v >= 0.f) &
                   (__fadd_rn(u, v) <= adet) & (ts > __fmul_rn(q.lo, adet)) &
                   (ts < __fmul_rn(q.hi, adet));
  if (hit) *t_out = __fdiv_rn(ts, fmaxf(adet, MT_EPS));
  return hit;
}

__global__ void __launch_bounds__(TILE)
closest_hit_kernel(const float* __restrict__ R, const float* __restrict__ tmin,
                   const float* __restrict__ tmax, const float* __restrict__ Tc,
                   const int* __restrict__ tile_ptr,
                   const int* __restrict__ tile_chunks,
                   float* __restrict__ best_t, int* __restrict__ best_i) {
  __shared__ __align__(16) float sT[SUB * STRIDE];
  const int tile = blockIdx.x;
  const int lane = tile * TILE + threadIdx.x;
  const RayRegs q = load_ray(R, tmin, tmax, lane);
  float bt = CUDART_INF_F;
  int bi = -1;
  const int p0 = tile_ptr[tile];
  const int p1 = tile_ptr[tile + 1];
  for (int p = p0; p < p1; ++p) {
    const int c = tile_chunks[p];
    const float* Tch = Tc + static_cast<size_t>(c) * 10 * NCOL;
    for (int base = 0; base < CHUNK; base += SUB) {
      __syncthreads();
      stage(sT, Tch, base);
      __syncthreads();
      const int idx0 = c * CHUNK + base;
#pragma unroll 4
      for (int j = 0; j < SUB; ++j) {
        float t;
        if (test_tri(q, sT + j * STRIDE, &t) && t < bt) {
          bt = t;
          bi = idx0 + j;
        }
      }
    }
  }
  best_t[lane] = bt;
  best_i[lane] = bi;
}

__global__ void __launch_bounds__(TILE)
any_hit_kernel(const float* __restrict__ R, const float* __restrict__ tmin,
               const float* __restrict__ tmax, const float* __restrict__ Tc,
               const int* __restrict__ tile_ptr,
               const int* __restrict__ tile_chunks, int* __restrict__ blocked,
               int* __restrict__ steps) {
  __shared__ __align__(16) float sT[SUB * STRIDE];
  const int tile = blockIdx.x;
  const int lane = tile * TILE + threadIdx.x;
  const RayRegs q = load_ray(R, tmin, tmax, lane);
  const bool dead = !(q.hi >= q.lo);
  bool hit_any = false;
  int visited = 0;
  const int p0 = tile_ptr[tile];
  const int p1 = tile_ptr[tile + 1];
  for (int p = p0; p < p1; ++p) {
    if (__syncthreads_and(hit_any || dead)) break;  // uniform per block
    ++visited;
    const int c = tile_chunks[p];
    const float* Tch = Tc + static_cast<size_t>(c) * 10 * NCOL;
    for (int base = 0; base < CHUNK; base += SUB) {
      __syncthreads();
      stage(sT, Tch, base);
      __syncthreads();
      if (!hit_any && !dead) {
        for (int j = 0; j < SUB; ++j) {
          float t;
          if (test_tri(q, sT + j * STRIDE, &t)) {
            hit_any = true;
            break;
          }
        }
      }
    }
  }
  blocked[lane] = hit_any ? 1 : 0;
  if (threadIdx.x == 0) steps[tile] = visited;
}

}  // namespace

// C interface, bound with ctypes by redner_tpu_torch/ops/intersect_cuda.py.
// R (ntile*128, 10), tmin/tmax (ntile*128,), Tc (nchunks, 10, 2048) f32;
// tile_ptr (ntile+1,), tile_chunks (nnz,) int32.  Launches on `stream`,
// allocates nothing, returns the cudaError_t of the launch.
extern "C" int rt_closest_hit(const float* R, const float* tmin,
                              const float* tmax, const float* Tc,
                              const int* tile_ptr, const int* tile_chunks,
                              int ntile, float* best_t, int* best_i,
                              void* stream) {
  if (ntile <= 0) return 0;
  closest_hit_kernel<<<ntile, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      R, tmin, tmax, Tc, tile_ptr, tile_chunks, best_t, best_i);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_any_hit(const float* R, const float* tmin, const float* tmax,
                          const float* Tc, const int* tile_ptr,
                          const int* tile_chunks, int ntile, int* blocked,
                          int* steps, void* stream) {
  if (ntile <= 0) return 0;
  any_hit_kernel<<<ntile, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      R, tmin, tmax, Tc, tile_ptr, tile_chunks, blocked, steps);
  return static_cast<int>(cudaGetLastError());
}
