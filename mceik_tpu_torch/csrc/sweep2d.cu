// K3: the 2-D eikonal sweep over a batch of fields, for sm_90a: one cycle
// per field, or each field's whole solve, in one launch.
//
// Replaces the Pallas TPU kernel `_sweep2d_axis0_kernel` / `_sweep2d_axis0`
// (mceik_tpu/eikonal/pallas_sweep.py:849, :890) as
// `sweep_solve_pallas_2d_lanebatched` (:907) drives it under its
// `lax.while_loop`: the row march, then the same kernel on the transposed
// batch with the spacing swapped for the column march, until convergence.
// One cycle computes the plain reference `sweep_seeded_cycle_plain` on a
// (B, n0, n1) batch (mceik_tpu_torch/eikonal/solve.py) operation for
// operation: for axis 0 and then axis 1, march the lines low -> high and
// then high -> low; each line takes a_ax = min(prev, next) (prev the line
// just updated, edges read BIG) and then n_inner Jacobi steps along the line
// T = max(min(T, local_solve(a_ax, a_line)), floor), a_line the minimum of
// the two line neighbours (edges read BIG). min and max are torch's, NaN if
// either operand is (line2d.cuh), so a field with a NaN in s comes out as
// the plain cycle's. The floor is computed from the field's source scalars
// (a, b, s_src) with `seeded_floor_plain`'s operations, as K1 does (see
// csrc/sweep3d.cu): dist = sqrt(((i-a)h0)^2 + ((j-b)h1)^2 + 1e-12f),
// floor = dist <= radius ? s_src dist : 0, the bits of `seed_floor`.
//
// The solve (`solve` set) is `solve.sweep_solve` per field: cycles until
// !(max |T_new - T_old| > tol) or max_cycles, the max NaN-propagating as
// torch.amax, so a field whose residual is NaN stops where the host loop
// marks it done; each field's cycle count is written out.
//
// Design. One warp owns one field (one warp per CTA, line2d.cuh): T and s
// in shared memory at an odd row stride ld = n1 | 1 (18.8 KB at 48^2, so
// ~11 fields per SM; 33.8 KB at 65^2). A line being marched lives in
// registers, NPL consecutive nodes per lane (2 at 48^2, 3 at 65^2), with
// its a_ax, s and floor; a Jacobi step takes in-lane neighbours from
// registers and the two lane-edge ones by shuffles, and computes every node
// from the previous step's values, so a step waits on no block barrier.
// ISO (equal spacings) is a template argument and node loads select rather
// than branch, and the square root is sqrtf's branch-free fast path
// (line2d::sqrt_rn, held to sqrtf on every input it takes), so that a
// lane's NPL node updates are one block the compiler interleaves. a_ax's
// prev is the lane's own registers from the line before; next is read from
// shared memory, where only this warp writes. __syncwarp() orders the axis
// swap (the column march reads what other lanes wrote) and the residual
// pass. The column march reads the field in place at the odd stride, with
// no transpose. The lanes' k-th nodes of a line lie NPL nodes apart, in a
// row or (the stride being odd) in a column, so gcd(NPL, 32) lanes share a
// bank: none when NPL is odd (65^2: NPL 3), two at 48^2 (NPL 2), a 2-way
// conflict on every line load and store of config 4's march. A solve
// keeps the field on chip from its load to its last cycle: device memory
// sees T and s once, and per
// cycle one read of the cycle-start copy (T_in at the first cycle, then
// the output, which each residual pass rewrites) and one write, 16 bytes
// per lane where the field allows.
//
// What bounds it. A field is a dependent chain of 2 (n0 + n1) n_inner line
// steps per cycle (384 at 48^2), each two shuffles and ~22 operations per
// node with a root: latency per warp, hidden only by the other fields an
// SM holds (shared memory caps them at ~11 at 48^2; two fields per warp,
// which fills the lanes, halved the warps and was slower). Config 4's
// 80,000 fields fill the card many times over. Bytes are far below that
// (37 KB per 48^2 field and cycle).
//
// Two routes. That warp route is for batches that fill the card. A batch
// with no more fields than the card has SMs (config 1's 32) leaves each
// field's warp alone on its SM, where a step is bound by one warp issuing
// NPL node updates; there the block route (sweep2d_block_kernel) gives a
// field a CTA of one thread per node of a line, a block barrier per Jacobi
// step and the same solve loop, and is faster. The wrapper picks the route
// (cuda_sweep2d.route_for); both compute the same bits.
//
// Left out as TPU workarounds: the (n0, n1, B) lane layout and its
// transposes, the VMEM chunk gate and padding, the `i >= 1` spelling, and
// the joint convergence of the lane batch (each field stops on its own).
//
// Build with --fmad=false so that no product is contracted into an FMA the
// reference does not have; division is the IEEE one, and the square root
// rounds as sqrtf does.

#include "line2d.cuh"

namespace {

using line2d::nan_max;
using line2d::nan_min;

constexpr float kBig = 1e10f;
constexpr float kDiscFloor = 1e-12f;

struct Sweep2dConsts {
  float h[2];    // spacing per grid axis
  float hh[2];   // h*h, rounded once from double (as torch's h*h scalar)
  float w[2];    // 1/(h*h), rounded once from double
  int n_inner;
  float radius;  // seed ball radius, seed_radius * max(h), in fp32
};

__device__ __forceinline__ float sqrt_floored(float x) {
  return line2d::sqrt_rn(nan_max(x, kDiscFloor));
}

// godunov.local_solve, D = 2: a_ax along the swept axis, a_ln along the
// line; h, hh and w_ax belong to the swept axis, w_ln to the line's. ISO
// (equal spacings: godunov._local_solve_iso's closed form) is a template
// argument, so that a lane's NPL node updates are one branch-free block the
// compiler can interleave.
template <bool ISO>
__device__ __forceinline__ float local2(float a_ax, float a_ln, float s,
                                        float h, float hh, float w_ax,
                                        float w_ln) {
  if constexpr (ISO) {
    const float s2h2 = (s * s) * hh;
    const float a1 = nan_min(a_ax, a_ln), a2 = nan_max(a_ax, a_ln);
    const float t1 = a1 + s * h;
    const float d12 = a1 - a2;
    const float t2 = 0.5f * ((a1 + a2) + sqrt_floored(2.0f * s2h2 - d12 * d12));
    return t1 <= a2 ? t1 : t2;
  } else {
    const bool swap = a_ln < a_ax;
    const float a1 = swap ? a_ln : a_ax, a2 = swap ? a_ax : a_ln;
    const float w1 = swap ? w_ln : w_ax, w2 = swap ? w_ax : w_ln;
    const float s2 = s * s;
    const float t1 = a1 + s * line2d::sqrt_rn(1.0f / w1);
    const float A2 = w1 + w2;
    const float B2 = w1 * a1 + w2 * a2;
    const float d12 = a1 - a2;
    const float disc2 = A2 * s2 - w1 * w2 * (d12 * d12);
    const float t2 = (B2 + sqrt_floored(disc2)) / A2;
    return t1 <= a2 ? t1 : t2;
  }
}

// The floor at node (i, j) from the field's source (a, b, s_src):
// solve.seeded_floor_plain's operations in its order.
__device__ __forceinline__ float seeded_floor(float a, float b, float s_src,
                                              int i, int j,
                                              const Sweep2dConsts& c) {
  const float d0 = ((float)i - a) * c.h[0];
  const float d1 = ((float)j - b) * c.h[1];
  const float dist = line2d::sqrt_rn((d0 * d0 + d1 * d1) + 1e-12f);
  return dist <= c.radius ? s_src * dist : 0.0f;
}

// One full cycle of the warp's field in shared memory (sT, sS). Node loads
// read a clamped index and select, so that the loops over a lane's nodes
// have no branch.
template <int NPL, bool ISO>
__device__ __forceinline__ void sweep_cycle(float* sT, const float* sS,
                                            int n0, int n1, int ld,
                                            float sa, float sb, float s_src,
                                            const Sweep2dConsts& c, int lane) {
  for (int ax = 0; ax < 2; ++ax) {
    // Axis 0 marches the rows (line k = row k, node p at (k, p)); axis 1
    // the columns (line k = column k, node p at (p, k)).
    const int n_lines = ax == 0 ? n0 : n1;
    const int len = ax == 0 ? n1 : n0;
    const int ls = ax == 0 ? ld : 1;
    const int ns = ax == 0 ? 1 : ld;
    const float h = c.h[ax], hh = c.hh[ax], w_ax = c.w[ax], w_ln = c.w[1 - ax];
    const float src_ax = ax == 0 ? sa : sb;
    // This lane's node offsets along a line, clamped into it; past the
    // line's end a node holds BIG (the last node's neighbour) and is not
    // stored.
    int po[NPL];
    bool in[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int p = lane * NPL + k;
      in[k] = p < len;
      po[k] = (in[k] ? p : len - 1) * ns;
    }
    for (int dir = 0; dir < 2; ++dir) {
      float prev[NPL];  // the line just updated, at this lane's nodes
#pragma unroll
      for (int k = 0; k < NPL; ++k) prev[k] = kBig;
      for (int q = 0; q < n_lines; ++q) {
        const int line = dir == 0 ? q : n_lines - 1 - q;
        const int nxt = dir == 0 ? line + 1 : line - 1;
        const bool has_next = nxt >= 0 && nxt < n_lines;
        const int lo = line * ls, nlo = (has_next ? nxt : line) * ls;
        float t[NPL], s[NPL], a[NPL], f[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
          const float tv = sT[lo + po[k]];
          const float nv = sT[nlo + po[k]];
          s[k] = sS[lo + po[k]];
          t[k] = in[k] ? tv : kBig;
          a[k] = nan_min(prev[k], has_next ? nv : kBig);
          f[k] = 0.0f;
        }
        // Off the seed ball every floor is exactly 0: the rounded distance
        // is at least the swept axis's |d| to within 2^-22 of it (K1's
        // argument), so a warp-uniform test of the line skips the floor.
        if (fabsf(((float)line - src_ax) * h) <= c.radius * 1.0001f) {
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            const int p = lane * NPL + k;
            f[k] = ax == 0 ? seeded_floor(sa, sb, s_src, line, p, c)
                           : seeded_floor(sa, sb, s_src, p, line, c);
          }
        }
        for (int it = 0; it < c.n_inner; ++it) {
          float dn, up;
          line2d::lane_edges(t[0], t[NPL - 1], lane, kBig, dn, up);
          float u[NPL];
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            const float nu = k + 1 < NPL ? t[k + 1] : up;
            const float nd = k > 0 ? t[k - 1] : dn;
            const float loc = local2<ISO>(a[k], nan_min(nu, nd), s[k], h, hh,
                                          w_ax, w_ln);
            u[k] = in[k] ? nan_max(nan_min(t[k], loc), f[k]) : kBig;
          }
#pragma unroll
          for (int k = 0; k < NPL; ++k) t[k] = u[k];
        }
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
          if (in[k]) sT[lo + po[k]] = t[k];
          prev[k] = t[k];
        }
      }
    }
    __syncwarp();
  }
}

// One warp per CTA, one field per warp. Shared memory: T and s of the
// field at row stride ld. `done` (cycle mode only, may be null) leaves a
// field's T as it came; `cycles` (may be null) gets each field's cycle
// count, `count` (may be null) their sum, atomically.
template <int NPL, bool ISO>
__global__ void __launch_bounds__(32)
sweep2d_kernel(const float* Tin, float* Tout, const float* __restrict__ S,
               const float* __restrict__ scal,
               const uint8_t* __restrict__ done, int* __restrict__ cycles,
               unsigned long long* __restrict__ count, int n0, int n1, int ld,
               Sweep2dConsts c, int max_cycles, float tol, int solve) {
  const int64_t base = (int64_t)blockIdx.x * n0 * n1;
  const int lane = threadIdx.x;
  Tin += base;
  Tout += base;
  S += base;
  if (done != nullptr && done[blockIdx.x]) {
    line2d::copy_field(Tout, Tin, n0 * n1, lane);
    if (lane == 0 && cycles != nullptr) cycles[blockIdx.x] = 0;
    return;
  }
  extern __shared__ float smem[];
  float* sT = smem;
  float* sS = smem + n0 * ld;
  line2d::load_field(sT, Tin, n0, n1, ld, lane);
  line2d::load_field(sS, S, n0, n1, ld, lane);
  const float sa = scal[3 * blockIdx.x], sb = scal[3 * blockIdx.x + 1];
  const float s_src = scal[3 * blockIdx.x + 2];
  __syncwarp();

  int cyc = 0;
  const float* old = Tin;  // the cycle-start field in device memory
  while (cyc < max_cycles) {
    sweep_cycle<NPL, ISO>(sT, sS, n0, n1, ld, sa, sb, s_src, c, lane);
    ++cyc;
    if (!solve) break;
    const float r = line2d::residual_pass(sT, old, Tout, n0, n1, ld, lane);
    old = Tout;
    if (!(r > tol)) break;
  }
  // A solve wrote T at its last residual pass; a cycle, or no cycle, now.
  if (!solve || cyc == 0) line2d::store_field(Tout, sT, n0, n1, ld, lane);
  if (lane == 0) {
    if (cycles != nullptr) cycles[blockIdx.x] = cyc;
    if (count != nullptr) atomicAdd(count, (unsigned long long)cyc);
  }
}

// The block route: one CTA per field, one thread per node of the line
// being marched (blockDim.x >= max(n0, n1), whole warps), a block barrier
// per Jacobi step. The same operations as sweep_cycle on the same values:
// a step computes every node from the previous step's line, read from the
// field (step 0) or from one of two line buffers; the floor is computed as
// there, on the lines that meet the seed ball.
template <bool ISO>
__device__ __forceinline__ void block_cycle(float* sT, const float* sS,
                                            float* lb0, float* lb1, int n0,
                                            int n1, int ld, float sa,
                                            float sb, float s_src,
                                            const Sweep2dConsts& c, int tid) {
  for (int ax = 0; ax < 2; ++ax) {
    const int n_lines = ax == 0 ? n0 : n1;
    const int len = ax == 0 ? n1 : n0;
    const int ls = ax == 0 ? ld : 1;
    const int ns = ax == 0 ? 1 : ld;
    const bool active = tid < len;
    const int po = (active ? tid : 0) * ns;
    const float h = c.h[ax], hh = c.hh[ax], w_ax = c.w[ax], w_ln = c.w[1 - ax];
    const float src_ax = ax == 0 ? sa : sb;
    for (int dir = 0; dir < 2; ++dir) {
      float prev = kBig;  // the line just updated, at this thread's node
      for (int q = 0; q < n_lines; ++q) {
        const int line = dir == 0 ? q : n_lines - 1 - q;
        const int nxt = dir == 0 ? line + 1 : line - 1;
        const bool has_next = nxt >= 0 && nxt < n_lines;
        const int off = line * ls + po;
        float t = kBig, s = 0.0f, a = kBig, f = 0.0f;
        if (active) {
          a = nan_min(prev, has_next ? sT[nxt * ls + po] : kBig);
          t = sT[off];
          s = sS[off];
          if (fabsf(((float)line - src_ax) * h) <= c.radius * 1.0001f)
            f = ax == 0 ? seeded_floor(sa, sb, s_src, line, tid, c)
                        : seeded_floor(sa, sb, s_src, tid, line, c);
        }
        const float* src = sT + line * ls;
        int ss = ns;
        for (int it = 0; it < c.n_inner; ++it) {
          if (active) {
            const float up = tid + 1 < len ? src[(tid + 1) * ss] : kBig;
            const float dn = tid > 0 ? src[(tid - 1) * ss] : kBig;
            const float loc = local2<ISO>(a, nan_min(up, dn), s, h, hh, w_ax,
                                          w_ln);
            t = nan_max(nan_min(t, loc), f);
          }
          float* dst = (it & 1) ? lb1 : lb0;
          if (it + 1 < c.n_inner) {
            if (active) dst[tid] = t;
          } else {
            // The last step writes the node in place; with one step, its
            // neighbour reads came from the field, so wait for them.
            if (it == 0) __syncthreads();
            if (active) sT[off] = t;
          }
          __syncthreads();
          src = dst;
          ss = 1;
        }
        prev = t;
      }
    }
  }
}

// The maximum over the block of each warp's warp-wide r, NaN if any is;
// red holds one float per warp.
__device__ __forceinline__ float block_max(float r, float* red, int tid,
                                           int nt) {
  if ((tid & (line2d::kWarp - 1)) == 0) red[tid / line2d::kWarp] = r;
  __syncthreads();
  r = red[0];
  for (int w = 1; w < nt / line2d::kWarp; ++w) r = nan_max(r, red[w]);
  __syncthreads();
  return r;
}

// Shared memory: T and s at row stride ld, two line buffers of blockDim.x
// floats, one float per warp for the residual's maximum. Arguments as
// sweep2d_kernel's.
template <bool ISO>
__global__ void __launch_bounds__(1024)
sweep2d_block_kernel(const float* Tin, float* Tout,
                     const float* __restrict__ S,
                     const float* __restrict__ scal,
                     const uint8_t* __restrict__ done,
                     int* __restrict__ cycles,
                     unsigned long long* __restrict__ count, int n0, int n1,
                     int ld, Sweep2dConsts c, int max_cycles, float tol,
                     int solve) {
  const int64_t base = (int64_t)blockIdx.x * n0 * n1;
  const int tid = threadIdx.x, nt = blockDim.x;
  Tin += base;
  Tout += base;
  S += base;
  if (done != nullptr && done[blockIdx.x]) {
    line2d::copy_field(Tout, Tin, n0 * n1, tid, nt);
    if (tid == 0 && cycles != nullptr) cycles[blockIdx.x] = 0;
    return;
  }
  extern __shared__ float smem[];
  float* sT = smem;
  float* sS = smem + n0 * ld;
  float* lb0 = smem + 2 * n0 * ld;
  float* lb1 = lb0 + nt;
  float* red = lb1 + nt;
  line2d::load_field(sT, Tin, n0, n1, ld, tid, nt);
  line2d::load_field(sS, S, n0, n1, ld, tid, nt);
  const float sa = scal[3 * blockIdx.x], sb = scal[3 * blockIdx.x + 1];
  const float s_src = scal[3 * blockIdx.x + 2];
  __syncthreads();

  int cyc = 0;
  const float* old = Tin;  // the cycle-start field in device memory
  while (cyc < max_cycles) {
    block_cycle<ISO>(sT, sS, lb0, lb1, n0, n1, ld, sa, sb, s_src, c, tid);
    ++cyc;
    if (!solve) break;
    __syncthreads();
    const float r = block_max(
        line2d::residual_pass(sT, old, Tout, n0, n1, ld, tid, nt), red, tid,
        nt);
    old = Tout;
    if (!(r > tol)) break;
  }
  if (!solve || cyc == 0) {
    __syncthreads();
    line2d::store_field(Tout, sT, n0, n1, ld, tid, nt);
  }
  if (tid == 0) {
    if (cycles != nullptr) cycles[blockIdx.x] = cyc;
    if (count != nullptr) atomicAdd(count, (unsigned long long)cyc);
  }
}

}  // namespace

// C entry, loaded with ctypes. `consts` is a host array of 6 floats
// (h[2], hh[2], w[2]); `scal` the (B, 3) rows (a, b, s_src); `ld` the
// padded row stride and `smem` the dynamic shared memory in bytes (2 n0 ld
// floats, and with `block` set 2 threads + 32 more), both computed by the
// wrapper. `block` 0 launches the warp route, 1 the block route with
// `threads` (max(n0, n1) rounded up to whole warps, at most 1024). With
// `solve` 0: one cycle of every field whose `done` flag is clear (done may
// be null); with `solve` 1: each
// field's solve from Tin, at most max_cycles cycles, convergence at tol
// (done must be null). Reads Tin, writes Tout (distinct buffers); `cycles`
// and `count` may be null. Launches on `stream` of `device`; returns the
// CUDA error code of the set-up calls or of cudaGetLastError() after the
// launch (0 = launched), or -1 for a line longer than 1024 nodes. Does not
// synchronise.
extern "C" int sweep2d_solve(const float* Tin, float* Tout, const float* S,
                             const float* scal, const uint8_t* done,
                             int* cycles, unsigned long long* count, int B,
                             int n0, int n1, int ld, const float* consts,
                             int iso, int n_inner, float radius,
                             int max_cycles, float tol, int solve, int block,
                             int threads, int smem, int device,
                             void* stream) {
  Sweep2dConsts c;
  for (int d = 0; d < 2; ++d) {
    c.h[d] = consts[d];
    c.hh[d] = consts[2 + d];
    c.w[d] = consts[4 + d];
  }
  c.n_inner = n_inner;
  c.radius = radius;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (block) {
    if (threads < (n0 > n1 ? n0 : n1) || threads > 1024 ||
        threads % line2d::kWarp)
      return -1;
#define SWEEP2D_BLOCK_LAUNCH(ISO)                                            \
  do {                                                                       \
    err = cudaFuncSetAttribute(sweep2d_block_kernel<ISO>,                    \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               smem);                                        \
    if (err != cudaSuccess) return (int)err;                                 \
    sweep2d_block_kernel<ISO><<<B, threads, smem, (cudaStream_t)stream>>>(   \
        Tin, Tout, S, scal, done, cycles, count, n0, n1, ld, c, max_cycles,  \
        tol, solve);                                                         \
  } while (0)
    if (iso)
      SWEEP2D_BLOCK_LAUNCH(true);
    else
      SWEEP2D_BLOCK_LAUNCH(false);
#undef SWEEP2D_BLOCK_LAUNCH
    return (int)cudaGetLastError();
  }
  const int npl = line2d::npl_for(n0 > n1 ? n0 : n1);
  switch (npl) {
#define SWEEP2D_LAUNCH(N, ISO)                                               \
  do {                                                                       \
    err = cudaFuncSetAttribute(sweep2d_kernel<N, ISO>,                       \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               smem);                                        \
    if (err == cudaSuccess)                                                  \
      err = cudaFuncSetAttribute(                                            \
          sweep2d_kernel<N, ISO>,                                            \
          cudaFuncAttributePreferredSharedMemoryCarveout,                    \
          (int)cudaSharedmemCarveoutMaxShared);                              \
    if (err != cudaSuccess) return (int)err;                                 \
    sweep2d_kernel<N, ISO><<<B, line2d::kWarp, smem,                         \
                             (cudaStream_t)stream>>>(                        \
        Tin, Tout, S, scal, done, cycles, count, n0, n1, ld, c, max_cycles,  \
        tol, solve);                                                         \
  } while (0)
#define SWEEP2D_CASE(N)        \
  case N:                      \
    if (iso)                   \
      SWEEP2D_LAUNCH(N, true); \
    else                       \
      SWEEP2D_LAUNCH(N, false);\
    break;
    LINE2D_NPL_CASES(SWEEP2D_CASE)
#undef SWEEP2D_CASE
#undef SWEEP2D_LAUNCH
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// The kernels' square root against sqrtf on the floats whose bit patterns
// are lo .. lo + n - 1, NaN results on both sides counting as equal: adds
// the number of other differences to *bad. A check for the card's tests.
__global__ void sqrt_check_kernel(uint32_t lo, uint32_t n,
                                  unsigned long long* bad) {
  unsigned long long local = 0;
  for (uint32_t k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + k);
    const float a = line2d::sqrt_rn(x), b = sqrtf(x);
    local += __float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b);
  }
  if (local) atomicAdd(bad, local);
}

extern "C" int sweep2d_sqrt_mismatches(uint32_t lo, uint32_t n,
                                       unsigned long long* bad, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sqrt_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(lo, n, bad);
  return (int)cudaGetLastError();
}
