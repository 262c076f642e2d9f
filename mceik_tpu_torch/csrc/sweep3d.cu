// K1: the 3-D eikonal sweep solve of a batch of fields, for sm_90a, with
// the seed floor computed in the kernel: each field's whole solve in one
// launch.
//
// Replaces four Pallas TPU kernels, all of which march one 3-D cycle:
// `_sweep_axes012_fused_kernel` / `sweep_axes012_fused`
// (mceik_tpu/eikonal/pallas_sweep.py:343, :372), the body of
// `sweep_solve_pallas_packed` on cube grids; on non-cube grids with
// n_x == n_y (config 3's 48x48x32) the pair that packed route takes
// instead, `_sweep_axes01_fused_kernel` / `sweep_axes01_fused` (:196, :222,
// call :230) for axes 0 and 1 and `_sweep_axis0_kernel` / `sweep_axis0`
// (:82, :132, call :139) for axis 2 (also the blocked 128^3 route, :961,
// :1003); and `_sweep_axis0_seeded_kernel` / `sweep_axis0_gridbatch`
// (:667, :740, call :762), the gridbatch route. The TPU splits a cycle
// across those calls for its VMEM layouts; here one launch marches all three
// axes of any 3-D shape whose planes fit in shared memory. It computes the
// plain reference `sweep_seeded_cycle_plain` (mceik_tpu_torch/eikonal/
// solve.py) operation for operation: for axis 0, 1, 2 in turn, march the
// planes forward and then backward; each plane takes a_ax = min(T[i-1],
// T[i+1]) (T[i-1] already updated in this march, edges read BIG) and then
// n_inner in-plane Jacobi steps T = max(min(T, local_solve(a)), floor).
// min and max are torch's, NaN if either operand is (line2d.cuh), so a
// field with a NaN in s comes out as the plain cycle's.
//
// The solve is `solve.sweep_solve` per field: counted iterations of
// per_iter cycles (2 on the blocked route, else 1) until
// !(max |T_end - T_start| > tol) over the iteration or max_iters of them,
// the max NaN-propagating as torch.amax, so a field whose residual is NaN
// stops where the host loop marks it done; each field's cycle count is
// written out. The CTA loops over its own field's cycles; K1 marches in
// place, and a 64^3 field does not fit on chip, so an iteration's start
// values stay in device memory: the copy back after the axis-2 march that
// ends an iteration reads them (T0 at the first iteration, then a third
// scratch field), reduces the residual and writes the end values there as
// the next start, 8 bytes per node and iteration where the host loop paid
// a clone, a subtraction, an abs and an amax (~32). The transposed s is
// made once per launch.
//
// The floor. The kernel reads four floats per field, the source's
// fractional index coordinates (a, b, c) and its slowness s_src, as the
// TPU's gridbatch kernel does, and computes at each node
//   dist = sqrtf(((((i-a)*h0)^2 + ((j-b)*h1)^2) + ((k-c)*h2)^2) + 1e-12f),
//   floor = dist <= radius ? s_src * dist : 0,
// summed in the grid's own axis order whatever the swept axis (the TPU
// kernel's `floor_at` sums in its permuted order, a different rounding the
// port does not copy), so the floor is bitwise `seed_floor`'s. No
// (B,) + grid floor tensor is read or built.
//
// Design. One CTA owns one field (B = 128 fields of 64^3 fill 128 of the
// H100's 132 SMs) and walks the whole solve on it; the plane march is
// sequential, so there is nothing to split across CTAs without a grid-wide
// barrier. Thread t owns the in-plane nodes t, t + nthr, ... of every plane
// of an axis: NPT of them, a template constant (1-4, and 8, 12, 16, 20 for
// larger planes, the unused slots masked), so the per-node state lives in
// registers and the node coordinates are divided out once per axis, not per
// step (kRowQ: where the thread count is a multiple of every plane's row,
// as at 64^3 and 128^3, a thread's nodes share a column and no coordinate
// is kept per node at all). Shared memory holds the plane double-buffered
// for the neighbour exchange between Jacobi steps (on the register path
// with a one-node halo of BIG, so the neighbour reads need no edge guards:
// 2 x 66^2 floats at 64^2). Per plane visit each thread reads its nodes' T and s and the
// downstream T once, stores its nodes once, and between them runs the
// n_inner steps on registers and the exchange buffer alone: no global load
// and no division inside the Jacobi loop.
//   Up to 4 nodes per thread (planes up to 4096 nodes: configs 2 and 3), T,
// a_ax, s and the floor stay in registers for the whole visit, and the next
// plane's s and its downstream T are loaded at the start of the visit (into
// registers) and used at its end, so their latency hides behind the Jacobi
// steps. The T of the plane after the current one was loaded a visit
// earlier as that visit's downstream plane (it is unchanged until the march
// reaches it).
//   Above (128^2 planes: config 5's 16 nodes per thread), four values per
// node would take the whole 64-register budget of a 1024-thread block, so
// only a_ax stays in registers: s is staged in a third shared plane once per
// visit, T is read from the exchange buffer, the floor is recomputed at each
// step (3 planes: 192 KB at 128^2), and nothing is prefetched.
//   The floor is 0 off the seed ball, so it is computed only on the planes
// that meet the ball (a uniform test per visit, exact: see in_ball), once
// per visit (register path) or per step (staged path).
//   Axis 2. Its (x, y) planes are strided by nz floats in T's layout, so a
// warp's access to 32 nodes of a plane touches 32 sectors, and the next
// visits' sectors do not stay in L1: the axis-2 march took 8.6 of a
// cycle's 10.0 ms at 64^3 before this, against 0.8 ms for each other axis.
// So before the axis-2 march the CTA copies its field's T and s into a
// scratch pair laid out (nz, nx, ny), 32x32 tiles through shared memory
// with reads and writes both along a contiguous axis, marches axis 2 there
// exactly as axes 0 and 1 (planes contiguous), and copies T back. That
// covers T as well as s at every size, where a z-major s alone would leave
// T's loads and stores strided and a staged slab of z-planes does not fit
// beside 128^2 planes. The copies cost 8 bytes per node each way, the
// scratch 3 fields per field (the caller allocates it), and
// the shared memory one 32 x 33 tile per warp (132 KB at 1024 threads),
// which the plane buffers reuse.
//
// What bounds it. The ~46 operations per node and step (two correctly
// rounded square roots among them) and the n_inner + 1 block barriers per
// plane visit: the global traffic is each node's T and s read once and T
// written once per visit, coalesced on every axis. Every instance uses the
// 64 registers a 1024-thread block allows, and spills (ptxas -v, bytes of
// spill stores: 448 at config 2's 4 nodes per thread, 348 at config 3's 3,
// 596 at config 5's 16). At config 2 the Jacobi steps hold no spill code
// and a plane visit 29 stores; the rest sits in the residual copy back,
// run once per counted iteration.
//
// Arithmetic matches mceik_tpu_torch/eikonal/godunov.py (and the JAX
// package) in operation order; build with --fmad=false so that no product
// is contracted into an FMA the reference does not have.

#include "line2d.cuh"

namespace {

using line2d::nan_max;
using line2d::nan_min;

constexpr float kBig = 1e10f;
constexpr float kDiscFloor = 1e-12f;
constexpr int kMaxThreads = 1024;
// Nodes per thread up to which T, s and the floor stay in registers.
constexpr int kRegNodes = 4;
// One warp's transposition tile, 32 x 33 floats (padded: no bank conflicts).
constexpr int kTileFloats = 32 * 33;
// Rows of a tile whose start values a residual copy-back loads at a time.
constexpr int kResidRows = 8;

struct SweepConsts {
  float h[3];    // spacing per grid axis
  float hh[3];   // h*h, rounded once from double (as JAX's weak-typed h*h)
  float w[3];    // 1/(h*h), rounded once from double
  int iso;       // all spacings equal -> closed form (godunov.py's choice)
  int n_inner;
  float radius;  // seed ball radius, seed_radius * max(h), in fp32
};

// The floor at node (i0, i1, i2) from the field's (a, b, c, s_src):
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
  return sqrtf(nan_max(x, kDiscFloor));
}

// godunov._local_solve_iso, D = 3.
__device__ __forceinline__ float local_iso(float x0, float x1, float x2,
                                           float s, float h, float hh) {
  float lo = nan_min(x0, x1), hi = nan_max(x0, x1);
  float m = nan_min(x2, hi);
  hi = nan_max(x2, hi);
  float a1 = nan_min(lo, m), a2 = nan_max(lo, m), a3 = hi;
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

// One plane axis layout: the swept axis `ax`, the plane axes p < q.
struct Axis {
  int np, nq, nax, plane;
  int sa, sp, sq;  // element strides of the swept and plane axes
  float h, hh, w0, w1, w2;
};

// The local update of the node at `k` of the exchange buffer `cur`:
// neighbour minima (edges BIG: from a BIG halo around the plane (kHalo),
// rows nq + 2 long, or by guards on (ip, iq)), the local solve, the
// monotone min and the floor.
template <bool kHalo>
__device__ __forceinline__ float node_update(const float* cur, int k, int ip,
                                             int iq, float tc, float aax,
                                             float s, float fl,
                                             const Axis& A,
                                             const SweepConsts& c) {
  float ap, aq;
  if constexpr (kHalo) {
    ap = nan_min(cur[k + A.nq + 2], cur[k - A.nq - 2]);
    aq = nan_min(cur[k + 1], cur[k - 1]);
  } else {
    ap = nan_min(ip + 1 < A.np ? cur[k + A.nq] : kBig,
                 ip > 0 ? cur[k - A.nq] : kBig);
    aq = nan_min(iq + 1 < A.nq ? cur[k + 1] : kBig,
                 iq > 0 ? cur[k - 1] : kBig);
  }
  const float t = c.iso ? local_iso(aax, ap, aq, s, A.h, A.hh)
                        : local_weighted(aax, ap, aq, A.w0, A.w1, A.w2, s);
  return nan_max(nan_min(tc, t), fl);
}

// Copies the field src, laid out (n0, n1, n2), into dst laid out
// (n2, n0, n1) (to_z) or back (!to_z): 32x32 tiles of (y, z) at one x, one
// tile per warp at a time through the warp's padded tile in shared memory,
// so that both the reads and the writes run along a contiguous axis.
//   kResid (a copy back that ends a solve's counted iteration): each node's
// value v also goes to `keep`, the next iteration's start, and the thread's
// max |v - old| over its nodes is returned, `old` being this iteration's
// start in T's layout (`keep` itself after the first iteration: each node
// is read before it is written, by the same thread). The max is NaN if any
// term is, as torch.amax; the subtraction is the host loop's fp32 one.
template <bool kResid>
__device__ float transpose_field(const float* src, float* dst, int n0,
                                 int n1, int n2, bool to_z, float* tiles,
                                 const float* old = nullptr,
                                 float* keep = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* tile = tiles + warp * kTileFloats;
  const int ty = (n1 + 31) / 32, tz = (n2 + 31) / 32;
  const int ntiles = n0 * ty * tz;
  float res = 0.0f;
  for (int t = warp; t < ntiles; t += nw) {
    const int x = t / (ty * tz);
    const int rem = t - x * ty * tz;
    const int y0 = (rem / tz) * 32, z0 = (rem % tz) * 32;
    // Read rows of the source's contiguous axis (z, or y when !to_z).
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int y = to_z ? y0 + r : y0 + lane;
      const int z = to_z ? z0 + lane : z0 + r;
      const int off = to_z ? (x * n1 + y) * n2 + z : (z * n0 + x) * n1 + y;
      tile[r * 33 + lane] = (y < n1 && z < n2) ? src[off] : 0.0f;
    }
    __syncwarp();
    if constexpr (kResid) {
      // !to_z: z along the lanes; the start values of kResidRows rows are
      // loaded before any of them is stored.
#pragma unroll
      for (int r0 = 0; r0 < 32; r0 += kResidRows) {
        float o[kResidRows];
#pragma unroll
        for (int u = 0; u < kResidRows; ++u) {
          const int y = y0 + r0 + u, z = z0 + lane;
          o[u] = (y < n1 && z < n2) ? old[(x * n1 + y) * n2 + z] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kResidRows; ++u) {
          const int y = y0 + r0 + u, z = z0 + lane;
          if (y < n1 && z < n2) {
            const int off = (x * n1 + y) * n2 + z;
            const float v = tile[lane * 33 + r0 + u];
            dst[off] = v;
            keep[off] = v;
            res = nan_max(res, fabsf(v - o[u]));
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int y = to_z ? y0 + lane : y0 + r;
        const int z = to_z ? z0 + r : z0 + lane;
        const int off = to_z ? (z * n0 + x) * n1 + y : (x * n1 + y) * n2 + z;
        if (y < n1 && z < n2) dst[off] = tile[lane * 33 + r];
      }
    }
    __syncwarp();
  }
  return res;
}

// The maximum of r over the block, NaN if any thread's is, the same value
// in every thread. `red` holds one float per warp (shared memory no warp
// still reads: the caller has passed a block barrier since).
__device__ __forceinline__ float block_max(float r, float* red) {
  r = line2d::warp_max(r);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = r;
  __syncthreads();
  r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = nan_max(r, red[w]);
  __syncthreads();
  return r;
}

// The CTA's index, read anew at each call: neither it nor a pointer made
// from it can be kept in a register from one use to the next, so the
// field's pointers cost no register across a march, where all 64 are taken.
__device__ __forceinline__ int64_t cta() {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

// The batch's buffers (kernel parameters) and the CTA's field in each,
// made at each use (cta()). scratch holds per field the axis-2 march's
// copies of T and s laid out (n2, n0, n1), z(0) and z(1), and the counted
// iteration's start values, z(2).
struct Fields {
  const float* T0;
  float* T;
  const float* S;
  float* scratch;
  int64_t field;  // nodes per field
  __device__ float* t() const { return T + cta() * field; }
  __device__ const float* s() const { return S + cta() * field; }
  __device__ const float* t0() const { return T0 + cta() * field; }
  __device__ float* z(int k) const {
    return scratch + (3 * cta() + k) * field;
  }
};

// Cycle `cyc` (from 0) of the CTA's field, in place (source scalars sc),
// ending with a block barrier. The axis-2 march runs on z(0) and z(1); s
// is copied to z(1) at cycle 0 only (it does not change within a launch).
// The cycle that ends a solve's counted iteration of per_iter cycles copies
// T back with the residual (transpose_field<true>: the start values are T0
// at the first iteration, then z(2)) and returns the thread's
// max |T_end - T_start|; any other cycle returns 0.
// T is read and written by the CTA (no __restrict__/read-only path: later
// plane visits must see earlier stores of the same CTA).
template <int NPT, bool kRowQ>
__device__ __forceinline__ float sweep_cycle(const Fields& F, int cyc,
                                             int per_iter, const float* sc,
                                             int n0, int n1, int n2,
                                             const SweepConsts& c,
                                             float* smem) {
  constexpr bool kStageS = NPT > kRegNodes;
  // The register path's exchange buffers carry a BIG halo (no guards).
  constexpr bool kHalo = !kStageS;
  float res = 0.0f;
  const int max_plane =
      kHalo ? max((n1 + 2) * (n2 + 2),
                  max((n0 + 2) * (n2 + 2), (n0 + 2) * (n1 + 2)))
            : max(n1 * n2, max(n0 * n2, n0 * n1));
  float* const bufA = smem;
  float* const bufB = smem + max_plane;
  float* const sbuf = smem + 2 * max_plane;  // kStageS only
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int ax = 0; ax < 3; ++ax) {
    // Plane axes in grid order; spacing order (swept, p, q) as the
    // reference's moveaxis layout.
    const int p = ax == 0 ? 1 : 0;
    const int q = ax == 2 ? 1 : 2;
    Axis A;
    A.np = p == 0 ? n0 : n1;
    A.nq = q == 1 ? n1 : n2;
    A.nax = ax == 0 ? n0 : (ax == 1 ? n1 : n2);
    A.plane = A.np * A.nq;
    A.sa = ax == 0 ? n1 * n2 : (ax == 1 ? n2 : 1);
    A.sp = p == 0 ? n1 * n2 : n2;
    A.sq = q == 1 ? n2 : 1;
    float* Tm = F.t();
    const float* Sm = F.s();
    if (ax == 2) {
      // The (x, y) planes of axis 2 are strided by n2 in T's layout: march
      // them in the transposed copies, whose (x, y) planes are contiguous.
      transpose_field<false>(F.t(), F.z(0), n0, n1, n2, true, smem);
      if (cyc == 0)
        transpose_field<false>(F.s(), F.z(1), n0, n1, n2, true, smem);
      __syncthreads();
      Tm = F.z(0);
      Sm = F.z(1);
      A.sa = n0 * n1;
      A.sp = n1;
      A.sq = 1;
    }
    A.h = c.h[ax];
    A.hh = c.hh[ax];
    A.w0 = c.w[ax];
    A.w1 = c.w[p];
    A.w2 = c.w[q];

    if constexpr (kHalo) {
      for (int e = tid; e < (A.np + 2) * (A.nq + 2); e += nthr) {
        bufA[e] = kBig;
        bufB[e] = kBig;
      }
      __syncthreads();
    }
    // The owned nodes' in-plane coordinates, divided out once per axis.
    // kRowQ (nthr a multiple of every plane's row length nq): a thread's
    // nodes share iq and step ip by nthr / nq, so nothing is kept per node.
    // Otherwise one register per node holds ip << 16 | iq (-1 past the
    // plane; sides are below 2^15: a plane holds a whole side, and planes
    // hold at most 20 * 1024 nodes).
    const int ip0 = tid / A.nq, iq0 = tid - ip0 * A.nq, dip = nthr / A.nq;
    int ipq[kRowQ ? 1 : NPT];
    if constexpr (!kRowQ) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int m = tid + j * nthr;
        const int ip = m / A.nq;
        ipq[j] = m < A.plane ? (ip << 16) | (m - ip * A.nq) : -1;
      }
    }
    auto ip_of = [&](int j) {
      if constexpr (kRowQ) return ip0 + j * dip; else return ipq[j] >> 16;
    };
    auto iq_of = [&](int j) {
      if constexpr (kRowQ) return iq0; else return ipq[j] & 0xffff;
    };
    auto owns = [&](int j) {
      if constexpr (kRowQ) return ip0 + j * dip < A.np; else return ipq[j] >= 0;
    };
    auto po = [&](int j) { return ip_of(j) * A.sp + iq_of(j) * A.sq; };
    // The owned node's place in the shared-memory buffers.
    auto at = [&](int j) {
      if constexpr (kHalo) return (ip_of(j) + 1) * (A.nq + 2) + iq_of(j) + 1;
      else return tid + j * nthr;
    };
    // The node's grid indices: i on the swept axis, ip and iq on p < q.
    auto floor_at = [&](int i, int j) {
      const int g0 = ax == 0 ? i : ip_of(j);
      const int g1 = ax == 1 ? i : (ax == 0 ? ip_of(j) : iq_of(j));
      const int g2 = ax == 2 ? i : iq_of(j);
      return seeded_floor(sc, g0, g1, g2, c);
    };
    // Whether plane i meets the seed ball. Off it every floor is exactly 0:
    // the rounded distance is at least the swept axis's |d| (the other
    // terms are >= 0 and fp32 rounding is monotone) to within 2^-22 of it.
    const float src_ax = ax == 0 ? sc[0] : (ax == 1 ? sc[1] : sc[2]);
    auto in_ball = [&](int i) {
      return fabsf(((float)i - src_ax) * A.h) <= c.radius * 1.0001f;
    };

    for (int dir = 0; dir < 2; ++dir) {
      const int step = dir == 0 ? 1 : -1;
      const int first = dir == 0 ? 0 : A.nax - 1;
      float* cur = bufA;
      float* nxt = bufB;
      // Per owned node: a_ax, and (register path) this plane's T, s and
      // floor, the next plane's T and s, the downstream plane's T.
      float aax[NPT], tc[NPT], sv[NPT], fl[NPT], t1[NPT], t2[NPT], s1[NPT];
      {
        const int inx = first + step;
        const bool has = inx >= 0 && inx < A.nax;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          if (!owns(j)) continue;
          const int m = at(j);
          const int off = first * A.sa + po(j);
          const float tn = has ? Tm[inx * A.sa + po(j)] : kBig;
          // First plane: the previous plane is BIG.
          aax[j] = nan_min(kBig, tn);
          const float t0 = Tm[off];
          cur[m] = t0;
          if constexpr (kStageS) {
            sbuf[m] = Sm[off];
          } else {
            tc[j] = t0;
            t1[j] = tn;
            sv[j] = Sm[off];
          }
        }
      }
      __syncthreads();
      for (int k = 0; k < A.nax; ++k) {
        const int i = first + step * k;
        const int inx2 = i + 2 * step;  // the next plane's downstream plane
        const bool more = k + 1 < A.nax;
        const bool has2 = inx2 >= 0 && inx2 < A.nax;
        const bool ball = in_ball(i);
        if constexpr (!kStageS) {
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            if (!owns(j)) continue;
            // Loads for the next visit, used after the Jacobi steps.
            t2[j] = has2 ? Tm[inx2 * A.sa + po(j)] : kBig;
            s1[j] = more ? Sm[(i + step) * A.sa + po(j)] : 0.0f;
          }
          if (ball) {
#pragma unroll
            for (int j = 0; j < NPT; ++j) fl[j] = floor_at(i, j);
          } else {
#pragma unroll
            for (int j = 0; j < NPT; ++j) fl[j] = 0.0f;
          }
        }
        // The n_inner Jacobi steps, with the floor of owned node j from
        // floor_of(j).
        auto jacobi = [&](auto floor_of) {
          for (int it = 0; it < c.n_inner; ++it) {
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int m = at(j);
              if constexpr (kStageS) {
                nxt[m] = node_update<kHalo>(cur, m, ip_of(j), iq_of(j),
                                            cur[m], aax[j], sbuf[m],
                                            floor_of(j), A, c);
              } else {
                tc[j] = node_update<kHalo>(cur, m, ip_of(j), iq_of(j),
                                           tc[j], aax[j], sv[j],
                                           floor_of(j), A, c);
                nxt[m] = tc[j];
              }
            }
            __syncthreads();
            float* tmp = cur; cur = nxt; nxt = tmp;
          }
        };
        if constexpr (kStageS) {
          // A uniform branch, so that planes off the ball skip the floor.
          if (ball) {
            jacobi([&](int j) { return floor_at(i, j); });
          } else {
            jacobi([](int) { return 0.0f; });
          }
        } else {
          jacobi([&](int j) { return fl[j]; });
        }
        // Store the plane and fold it into the next plane's a_ax; load the
        // next plane into the exchange buffer (each thread touches only its
        // own nodes here).
        const int off_i = i * A.sa;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          if (!owns(j)) continue;
          const int m = at(j);
          if constexpr (kStageS) {
            const float v = cur[m];
            Tm[off_i + po(j)] = v;
            if (more) {
              const int off_n = (i + step) * A.sa + po(j);
              aax[j] = nan_min(v, has2 ? Tm[inx2 * A.sa + po(j)] : kBig);
              cur[m] = Tm[off_n];
              sbuf[m] = Sm[off_n];
            }
          } else {
            const float v = tc[j];
            Tm[off_i + po(j)] = v;
            if (more) {
              aax[j] = nan_min(v, t2[j]);
              tc[j] = t1[j];
              t1[j] = t2[j];
              sv[j] = s1[j];
              nxt[m] = tc[j];
            }
          }
        }
        if constexpr (!kStageS) {
          float* tmp = cur; cur = nxt; nxt = tmp;
        }
        __syncthreads();
      }
    }
    if (ax == 2) {
      if ((cyc + 1) % per_iter == 0) {
        res = transpose_field<true>(
            F.z(0), F.t(), n0, n1, n2, false, smem,
            cyc + 1 == per_iter ? F.t0() : F.z(2), F.z(2));
      } else {
        transpose_field<false>(F.z(0), F.t(), n0, n1, n2, false, smem);
      }
    }
  }
  // The next cycle's planes reuse the tiles, and its marches read T.
  __syncthreads();
  return res;
}

// One CTA per field, F.T holding a copy of F.T0: counted iterations of
// per_iter cycles each until the field's max |T_end - T_start| over an
// iteration is not above tol (a NaN residual stops it, as not (NaN > tol))
// or after max_cycles cycles (a whole number of iterations); `cycles` (may
// be null) gets the field's cycle count, `count` (may be null) adds it.
// The name is the one the benchmark's trace readers look for.
template <int NPT, bool kRowQ>
__global__ void __launch_bounds__(kMaxThreads)
sweep3d_cycle_kernel(Fields F, const float* __restrict__ scal,
                     int* __restrict__ cycles,
                     unsigned long long* __restrict__ count, int n0, int n1,
                     int n2, SweepConsts c, int max_cycles, int per_iter,
                     float tol) {
  const int b = blockIdx.x;
  float sc[4];
  for (int e = 0; e < 4; ++e) sc[e] = scal[4 * b + e];
  extern __shared__ float smem[];
  int cyc = 0;
  while (cyc < max_cycles) {
    const float res =
        sweep_cycle<NPT, kRowQ>(F, cyc, per_iter, sc, n0, n1, n2, c, smem);
    ++cyc;
    if (cyc % per_iter == 0 && !(block_max(res, smem) > tol))
      break;
  }
  if (threadIdx.x == 0) {
    if (cycles != nullptr) cycles[b] = cyc;
    if (count != nullptr) atomicAdd(count, (unsigned long long)cyc);
  }
}

template <int NPT, bool kRowQ>
int launch_npt(const Fields& F, const float* scal, int* cycles,
               unsigned long long* count, int B, int n0, int n1, int n2,
               const SweepConsts& c, int max_cycles, int per_iter, float tol,
               int threads, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep3d_cycle_kernel<NPT, kRowQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep3d_cycle_kernel<NPT, kRowQ><<<B, threads, smem,
                                     (cudaStream_t)stream>>>(
      F, scal, cycles, count, n0, n1, n2, c, max_cycles, per_iter, tol);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, loaded with ctypes: each field's solve on the (B, n0, n1, n2)
// batch T, a copy of T0 (distinct buffers) marched in place, slowness S of
// the same shape, `scal` the (B, 4) rows (a, b, c, s_src) of each field's
// source, `radius` the seed ball's radius, `consts` a host array of 9
// floats (h[3], hh[3], w[3]): iterations of per_iter cycles until the
// field's max |T_end - T_start| over one is not above tol, at most
// max_iters of them. `scratch` holds 3 * B * n0 * n1 * n2 floats,
// `cycles` (may be null) gets each field's cycle count, `count` is null or
// a counter each field adds its cycles to (its field-cycles). Launches on
// `stream` of `device` and returns the CUDA error code of the set-up calls
// or of cudaGetLastError() after the launch (0 = launched; -1 = a plane
// larger than 20 nodes per thread, or counts out of range). Does not
// synchronise.
extern "C" int sweep3d_solve(const float* T0, float* T, const float* S,
                             const float* scal, float* scratch, int* cycles,
                             unsigned long long* count, int B, int n0, int n1,
                             int n2, const float* consts, int iso,
                             int n_inner, float radius, int max_iters,
                             int per_iter, float tol, int threads, int device,
                             void* stream) {
  if (max_iters < 0 || per_iter < 1 ||
      (int64_t)max_iters * per_iter > 0x7fffffff)
    return -1;
  const Fields F{T0, T, S, scratch, (int64_t)n0 * n1 * n2};
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
  const int npt = (max_plane + threads - 1) / threads;
  // The plane buffers (two with a one-node halo up to kRegNodes nodes per
  // thread, else three), or the warps' transposition tiles if larger.
  int padded = (n1 + 2) * (n2 + 2);
  if ((n0 + 2) * (n2 + 2) > padded) padded = (n0 + 2) * (n2 + 2);
  if ((n0 + 2) * (n1 + 2) > padded) padded = (n0 + 2) * (n1 + 2);
  size_t smem = (npt > kRegNodes ? 3 * (size_t)max_plane : 2 * (size_t)padded) *
                sizeof(float);
  const size_t tiles = (size_t)(threads / 32) * kTileFloats * sizeof(float);
  if (tiles > smem) smem = tiles;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // Row-aligned ownership where every plane's rows (n2 for axes 0 and 1,
  // n1 for the transposed axis 2) divide the thread count.
  const bool row_q = threads % n2 == 0 && threads % n1 == 0;
#define K1_LAUNCH(N)                                                      \
  (row_q ? launch_npt<N, true>(F, scal, cycles, count, B, n0, n1, n2, c,  \
                               max_iters * per_iter, per_iter, tol,        \
                               threads, smem, stream)                      \
         : launch_npt<N, false>(F, scal, cycles, count, B, n0, n1, n2, c,  \
                                max_iters * per_iter, per_iter, tol,       \
                                threads, smem, stream))
  switch (npt) {
    case 1: return K1_LAUNCH(1);
    case 2: return K1_LAUNCH(2);
    case 3: return K1_LAUNCH(3);
    case 4: return K1_LAUNCH(4);
    case 5: case 6: case 7: case 8: return K1_LAUNCH(8);
    case 9: case 10: case 11: case 12: return K1_LAUNCH(12);
    case 13: case 14: case 15: case 16: return K1_LAUNCH(16);
    case 17: case 18: case 19: case 20: return K1_LAUNCH(20);
    default: return -1;
  }
#undef K1_LAUNCH
}
