// K1: one full 3-D eikonal sweep cycle over a batch of fields, for sm_90a.
//
// Replaces the Pallas TPU kernel `_sweep_axes012_fused_kernel` /
// `sweep_axes012_fused` (mceik_tpu/eikonal/pallas_sweep.py:343, :372), the
// body of `sweep_solve_pallas_packed` on cube grids; and on non-cube grids
// with n_x == n_y (config 3's 48x48x32) the pair that packed route takes
// instead, `_sweep_axes01_fused_kernel` / `sweep_axes01_fused` (:196, :222,
// call :230) for axes 0 and 1 and `_sweep_axis0_kernel` / `sweep_axis0`
// (:82, :132, call :139) for axis 2. The TPU splits a cycle across those
// two calls for its VMEM layouts; here one launch marches all three axes of
// any 3-D shape whose three largest planes fit in shared memory (27.6 KB at
// 48x48x32). It computes the plain
// reference `sweep_cycle_plain` (mceik_tpu_torch/eikonal/solve.py, itself
// the port of mceik_tpu/eikonal/solve.py:_sweep_cycle) operation for
// operation: for axis 0, 1, 2 in turn, march the planes forward and then
// backward; each plane takes a_ax = min(T[i-1], T[i+1]) (T[i-1] already
// updated in this march, edges read BIG) and then n_inner in-plane Jacobi
// steps T = max(min(T, local_solve(a)), floor).
//
// Design. One CTA owns one field (B = 128 fields of 64^3 fill 128 of the
// H100's 132 SMs) and walks the whole cycle on it; the plane march is
// sequential, so there is nothing to split across CTAs without a grid-wide
// barrier. Shared memory holds three plane buffers: the axial minimum a_ax
// (built in place over the previous plane's final values) and the current
// plane double-buffered for the Jacobi steps, with __syncthreads() between
// micro-iterations and planes. A 64^2 plane is 16 KB, so 48 KB in all.
// T is updated in place in global memory; the caller keeps the cycle's
// input to measure convergence. The seed floor is an operand, not rebuilt
// from the source coordinates as the TPU kernel does to save VMEM.
//
// What bounds it. Each plane visit loads the current and the downstream
// plane of T, reads s and floor once per Jacobi step, stores the plane, and
// crosses n_inner + 2 block barriers; the ~40 flops per node and step are
// small beside that, so the kernel is bound by global-load latency and
// barrier count, with one CTA of 1024 threads per SM to hide them. The
// axis-0 and axis-1 sweeps walk planes whose rows run along z and load
// coalesced; the axis-2 sweep's planes are (x, y) slices whose rows are
// strided by nz floats, so its loads do not coalesce. Transposed layouts,
// clusters and TMA are later work.
//
// K7 is the same kernel with kSeeded = true. It replaces the Pallas TPU
// kernel `_sweep_axis0_seeded_kernel` / `sweep_axis0_gridbatch`
// (pallas_sweep.py:667, :740, call :762), the opt-in gridbatch route
// (`solve_eikonal_batched(..., impl="gridbatch")`), which marches a whole
// batch per launch and rebuilds the seed floor in the kernel instead of
// reading a floor field. K7 takes no floor operand: it reads four floats
// per field, the source's fractional index coordinates (a, b, c) and its
// slowness s_src, and computes at each node of each Jacobi step
//   dist = sqrtf(((((i-a)*h0)^2 + ((j-b)*h1)^2) + ((k-c)*h2)^2) + 1e-12f),
//   floor = dist <= radius ? s_src * dist : 0,
// summed in the grid's own axis order whatever the swept axis (the TPU
// kernel's `floor_at` sums in its permuted order, a different rounding the
// port does not copy), so its floor is bitwise the `seed_floor` K1 reads.
// That saves K1's floor read, 4 of its 16 bytes per node and cycle, for
// ~12 flops and a sqrt per node and step. The floor depends on the node
// alone, so the function needs it once per node and cycle; recomputing it
// at each of the 6 * n_inner steps costs more operations than that (the
// bound counts it once) but no shared memory, which K7 keeps at K1's three
// planes. K1 is bound by latency and barriers, so little speed is expected. The TPU kernel's lane packing, its
// done flag in `scal` column 4 and its per-block convergence are left out:
// done flags are per field, as K1's.
//
// Arithmetic matches mceik_tpu_torch/eikonal/godunov.py (and the JAX
// package) in operation order; build with --fmad=false so that no product
// is contracted into an FMA the reference does not have.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e10f;
constexpr float kDiscFloor = 1e-12f;

struct SweepConsts {
  float h[3];   // spacing per grid axis
  float hh[3];  // h*h, rounded once from double (as JAX's weak-typed h*h)
  float w[3];   // 1/(h*h), rounded once from double
  int iso;      // all spacings equal -> closed form (godunov.py's choice)
  int n_inner;
  float radius;  // K7: seed ball radius, seed_radius * max(h), in fp32
};

// K7's floor at node (i0, i1, i2) from the field's (a, b, c, s_src):
// solve.seeded_floor_plain's operations in its order.
__device__ __forceinline__ float seeded_floor(const float* sc, int i0, int i1,
                                              int i2, const SweepConsts& c) {
  const float d0 = ((float)i0 - sc[0]) * c.h[0];
  const float d1 = ((float)i1 - sc[1]) * c.h[1];
  const float d2 = ((float)i2 - sc[2]) * c.h[2];
  const float dist = sqrtf(((d0 * d0 + d1 * d1) + d2 * d2) + 1e-12f);
  return dist <= c.radius ? sc[3] * dist : 0.0f;
}

__device__ __forceinline__ float sqrt_floored(float x) {
  return sqrtf(fmaxf(x, kDiscFloor));
}

// godunov._local_solve_iso, D = 3.
__device__ __forceinline__ float local_iso(float x0, float x1, float x2,
                                           float s, float h, float hh) {
  float lo = fminf(x0, x1), hi = fmaxf(x0, x1);
  float m = fminf(x2, hi);
  hi = fmaxf(x2, hi);
  float a1 = fminf(lo, m), a2 = fmaxf(lo, m), a3 = hi;
  float s2h2 = (s * s) * hh;
  float t1 = a1 + s * h;
  float d12 = a1 - a2;
  float t2 = 0.5f * ((a1 + a2) + sqrt_floored(2.0f * s2h2 - d12 * d12));
  float d13 = a1 - a3, d23 = a2 - a3;
  float t3 = (1.0f / 3.0f) *
             ((a1 + a2 + a3) +
              sqrt_floored(3.0f * s2h2 - (d12 * d12 + d13 * d13 + d23 * d23)));
  return t1 <= a2 ? t1 : (t2 <= a3 ? t2 : t3);
}

__device__ __forceinline__ void cswap(float& ax, float& wx, float& ay, float& wy) {
  if (ay < ax) {
    float t = ax; ax = ay; ay = t;
    t = wx; wx = wy; wy = t;
  }
}

// godunov.local_solve's weighted sorted-subset form, D = 3.
__device__ __forceinline__ float local_weighted(float a1, float a2, float a3,
                                                float w1, float w2, float w3,
                                                float s) {
  cswap(a1, w1, a2, w2);
  cswap(a2, w2, a3, w3);
  cswap(a1, w1, a2, w2);
  float s2 = s * s;
  float t1 = a1 + s * sqrtf(1.0f / w1);
  float A2 = w1 + w2;
  float B2 = w1 * a1 + w2 * a2;
  float d12 = a1 - a2;
  float disc2 = A2 * s2 - w1 * w2 * (d12 * d12);
  float t2 = (B2 + sqrt_floored(disc2)) / A2;
  float A3 = A2 + w3;
  float B3 = B2 + w3 * a3;
  float d13 = a1 - a3, d23 = a2 - a3;
  float disc3 = A3 * s2 - (w1 * w2 * (d12 * d12) + w1 * w3 * (d13 * d13) +
                           w2 * w3 * (d23 * d23));
  float t3 = (B3 + sqrt_floored(disc3)) / A3;
  return t1 <= a2 ? t1 : (t2 <= a3 ? t2 : t3);
}

// T is read and written by the CTA (no __restrict__/read-only path: later
// plane visits must see earlier stores of the same CTA). K1 reads the floor
// field F; K7 (kSeeded) the field's four seed scalars at F + 4 b.
template <bool kSeeded>
__global__ void __launch_bounds__(1024)
sweep3d_cycle_kernel(float* T, const float* __restrict__ S,
                     const float* __restrict__ F,
                     const uint8_t* __restrict__ done, int n0, int n1, int n2,
                     SweepConsts c) {
  const int b = blockIdx.x;
  if (done[b]) return;  // uniform per CTA: no barrier is skipped by half
  const int64_t field = (int64_t)n0 * n1 * n2;
  T += b * field;
  S += b * field;
  F += kSeeded ? 4 * (int64_t)b : b * field;
  float sc[4];
  if (kSeeded)
    for (int e = 0; e < 4; ++e) sc[e] = F[e];

  extern __shared__ float smem[];
  const int n[3] = {n0, n1, n2};
  const int64_t stride[3] = {(int64_t)n1 * n2, n2, 1};
  const int max_plane = max(n1 * n2, max(n0 * n2, n0 * n1));
  float* buf0 = smem;
  float* buf1 = smem + max_plane;
  float* buf2 = smem + 2 * max_plane;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int ax = 0; ax < 3; ++ax) {
    // Plane axes in grid order; spacing order (swept, p, q) as the
    // reference's moveaxis layout.
    const int p = ax == 0 ? 1 : 0;
    const int q = ax == 2 ? 1 : 2;
    const int np_ = n[p], nq = n[q], nax = n[ax];
    const int plane = np_ * nq;
    const int64_t sa = stride[ax], sp = stride[p], sq = stride[q];
    const float h = c.h[ax], hh = c.hh[ax];
    const float w0 = c.w[ax], w1 = c.w[p], w2 = c.w[q];

    for (int dir = 0; dir < 2; ++dir) {
      const int step = dir == 0 ? 1 : -1;
      const int first = dir == 0 ? 0 : nax - 1;
      float* aax = buf0;
      float* cur = buf1;
      float* nxt = buf2;
      // a_ax for the first plane: prev is BIG, so min(BIG, T[next]).
      {
        const int inx = first + step;
        const bool has = inx >= 0 && inx < nax;
        for (int m = tid; m < plane; m += nthr) {
          const int ip = m / nq, iq = m - ip * nq;
          aax[m] = has ? fminf(kBig, T[inx * sa + ip * sp + iq * sq]) : kBig;
        }
      }
      for (int k = 0; k < nax; ++k) {
        const int i = first + step * k;
        const int64_t base = i * sa;
        for (int m = tid; m < plane; m += nthr) {
          const int ip = m / nq, iq = m - ip * nq;
          cur[m] = T[base + ip * sp + iq * sq];
        }
        __syncthreads();
        for (int it = 0; it < c.n_inner; ++it) {
          for (int m = tid; m < plane; m += nthr) {
            const int ip = m / nq, iq = m - ip * nq;
            const int64_t off = base + ip * sp + iq * sq;
            const float tc = cur[m];
            const float ap = fminf(ip + 1 < np_ ? cur[m + nq] : kBig,
                                   ip > 0 ? cur[m - nq] : kBig);
            const float aq = fminf(iq + 1 < nq ? cur[m + 1] : kBig,
                                   iq > 0 ? cur[m - 1] : kBig);
            const float s = S[off];
            const float t = c.iso ? local_iso(aax[m], ap, aq, s, h, hh)
                                  : local_weighted(aax[m], ap, aq, w0, w1, w2, s);
            float fl;
            if (kSeeded) {
              // The node's grid indices: i on the swept axis, ip and iq on
              // the plane axes p < q.
              const int g0 = ax == 0 ? i : ip;
              const int g1 = ax == 1 ? i : (ax == 0 ? ip : iq);
              const int g2 = ax == 2 ? i : iq;
              fl = seeded_floor(sc, g0, g1, g2, c);
            } else {
              fl = F[off];
            }
            nxt[m] = fmaxf(fminf(tc, t), fl);
          }
          __syncthreads();
          float* tmp = cur; cur = nxt; nxt = tmp;
        }
        // Store the plane; fold it into the next plane's a_ax in place
        // (each thread touches only its own nodes here).
        const int inx2 = i + 2 * step;  // the next plane's downstream plane
        const bool more = k + 1 < nax;
        const bool has2 = inx2 >= 0 && inx2 < nax;
        for (int m = tid; m < plane; m += nthr) {
          const int ip = m / nq, iq = m - ip * nq;
          const float v = cur[m];
          T[base + ip * sp + iq * sq] = v;
          if (more)
            cur[m] = fminf(v, has2 ? T[inx2 * sa + ip * sp + iq * sq] : kBig);
        }
        float* tmp = aax; aax = cur; cur = tmp;
        __syncthreads();
      }
    }
  }
}

template <bool kSeeded>
int launch(float* T, const float* S, const float* F, const uint8_t* done,
           int B, int n0, int n1, int n2, const float* consts, int iso,
           int n_inner, float radius, int threads, int device, void* stream) {
  SweepConsts c;
  for (int d = 0; d < 3; ++d) {
    c.h[d] = consts[d];
    c.hh[d] = consts[3 + d];
    c.w[d] = consts[6 + d];
  }
  c.iso = iso;
  c.n_inner = n_inner;
  c.radius = radius;
  int max_plane = n1 * n2;
  if (n0 * n2 > max_plane) max_plane = n0 * n2;
  if (n0 * n1 > max_plane) max_plane = n0 * n1;
  const size_t smem = 3 * (size_t)max_plane * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      sweep3d_cycle_kernel<kSeeded>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep3d_cycle_kernel<kSeeded><<<B, threads, smem, (cudaStream_t)stream>>>(
      T, S, F, done, n0, n1, n2, c);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, loaded with ctypes: K1 (floor field F, (B, n0, n1, n2)) and K7
// (seed scalars, (B, 4) rows (a, b, c, s_src), and the seed radius).
// `consts` is a host array of 9 floats (h[3], hh[3], w[3]). Each launches
// on `stream` of `device` and returns the CUDA error code of the set-up
// calls or of cudaGetLastError() after the launch (0 = launched). Neither
// synchronises.
extern "C" int sweep3d_cycle(float* T, const float* S, const float* F,
                             const uint8_t* done, int B, int n0, int n1,
                             int n2, const float* consts, int iso, int n_inner,
                             int threads, int device, void* stream) {
  return launch<false>(T, S, F, done, B, n0, n1, n2, consts, iso, n_inner,
                       0.0f, threads, device, stream);
}

extern "C" int sweep3d_seeded_cycle(float* T, const float* S,
                                    const float* scal, const uint8_t* done,
                                    int B, int n0, int n1, int n2,
                                    const float* consts, int iso, int n_inner,
                                    float radius, int threads, int device,
                                    void* stream) {
  return launch<true>(T, S, scal, done, B, n0, n1, n2, consts, iso, n_inner,
                      radius, threads, device, stream);
}
