// K4 and K5: one full 3-D adjoint transport sweep cycle over a batch of
// fields, for sm_90a. K4 holds each thread's nodes in registers (planes up
// to 4096 nodes: configs 2 and 3); K5 stages them in shared memory, for the
// larger cross-sections K4 cannot hold (config 5's 128^2).
//
// Replaces the Pallas TPU kernel `_transport_axis0_kernel` /
// `transport_axis0` (mceik_tpu/eikonal/pallas_transport.py:61, :132), which
// `transport_solve_pallas_packed` drives once per axis per cycle, and K5 its
// blocked route (`transport_solve_pallas_blocked` :216 through
// `_transport_block_pass` :181 and `_transport_block_cycle` :164), whose
// blocks, halo planes and pinned rows exist for the TPU's 2 MB of VMEM:
// here one CTA marches a whole field, so the fixed point is the unblocked
// one. It computes the plain reference `transport_cycle_plain`
// (mceik_tpu_torch/eikonal/adjoint_sweep.py, the port of
// mceik_tpu/eikonal/adjoint_sweep.py:_transport_sweep_axis) operation for
// operation. The system is lam = W^T lam + g, with W^T given by three
// signed upwind weight fields (w > 0: the node's argmin neighbour on that
// axis is the low side, w < 0 the high side). For axis 0, 1, 2 in turn,
// march the planes forward and then backward; plane i takes
//
//   base = g[i] + (from_prev + from_next),
//     from_prev = max(-w_ax[i-1], 0) * lam[i-1]   (already updated here)
//     from_next = max( w_ax[i+1], 0) * lam[i+1]
//
// and then n_inner in-plane Jacobi steps lam = base + inplane(lam), where
// each plane dim d collects max(w_d[j+1], 0) * lam[j+1] and
// max(-w_d[j-1], 0) * lam[j-1], summed in the order lo_p, hi_p, lo_q, hi_q
// (the reference's `out += lo; out += hi` per dim). Past an edge the
// reference gathers exactly 0.0 (`shift_filled(..., 0.0)`): here the
// shared buffers carry a one-node halo of zero lam and zero weight, and
// max(0, 0) * 0 is +0.0, the same bits with no edge guard.
//
// Design, K1's (csrc/sweep3d.cu). One CTA owns one field (B = 128 fields
// of 64^3 fill 128 of the H100's 132 SMs) and walks the whole cycle: the
// plane march is sequential. Thread t owns the in-plane nodes t, t + nthr,
// ... of every plane of an axis (NPT of them, a template constant), so
// node coordinates are divided out once per axis (none at all where the
// thread count is a multiple of every plane's row: kRowQ); a thread reads
// and writes only its own nodes' lam, g and weights in global memory, and
// the neighbour exchange goes through shared memory. No division, global
// load or edge guard is inside the Jacobi loop.
//   K4 (up to 4 nodes per thread: planes of 4096 nodes, configs 2 and 3).
// lam and base stay in registers for the visit; a step reads its four
// neighbours and their weights from the staged planes. The next plane's
// lam and in-plane weights, its g and the two w_ax and lam values of its
// axial inflow go to shared memory by cp.async as the visit starts (no
// registers), so their latency hides behind the Jacobi steps; lam[i-1] is
// the register the visit just computed. Shared memory: three exchange
// buffers (two for the steps, one filling), two pairs of weight planes and
// four planes of the thread's own staged values, each with its halo (11 x
// 66^2 floats, 192 KB at 64^2). n_inner barriers per visit. The axis loop
// is unrolled, so that ptxas allocates each march's registers apart.
//   K5 (5-20 nodes per thread, 128^2 at 16). Four planes of 130^2 do not fit
// in 227 KB and the registers hold two values per node, so base and the
// step's result stay in registers, the lam exchange buffer and the two
// in-plane weight planes in shared memory (3 x 130^2 floats, 203 KB); a
// step reads its neighbours and their weights there and writes its result
// after a barrier (two per step). The next plane is staged, then its base
// loaded, in two passes. __launch_bounds__(1024, 1): without the 1, ptxas
// gives the 16-node instance 32 registers and spills (86 against 66 ms).
//   Axis 2. Its (x, y) planes are strided by nz floats in the field's
// layout (a warp's access to 32 nodes of a plane touches 32 sectors, which
// the next visits do not find in L1), so the axis-2 march runs on a ring
// of z-planes laid out (z, x, y), the wrapper's scratch, marched exactly
// as axes 0 and 1. K4's ring holds the whole axis of the
// five operands (lam, g, w_2, w_0, w_1: five fields per field), copied in
// as the axis starts and lam out as it ends, through one 32 x 33 tile per
// warp in the then free shared memory (K1's transposition). g and the
// weights do not change during a solve: where the caller keeps the ring
// from cycle to cycle, with a per-field flag `ready` (set here once a
// field's ring holds them), only lam is copied in after a field's first
// cycle (six field copies per cycle become two). K5's ring holds
// two chunks of 8 z-planes (0.625 fields at 128^3, so config 5's chain count
// stays): before a chunk's march each thread copies its own (x, y) columns
// of the chunk ahead (8 floats, one sector, per column and operand), and
// lam back as a chunk ends; no barrier guards these copies, since each
// column is the copying thread's own.
//
// What bounds it. The bound is the bytes, 24 per node (lam, g and three
// weights read, lam written). K4 on axes 0 and 1 moves 32 bytes per node
// and visit (two of them L2 rereads) near the card's memory rate; its
// axis 2 adds six field copies for the ring, two where it is kept. K5 is
// bound by latency: 16 nodes per thread, 2 n_inner barriers per visit,
// each visit's loads issued after its steps, and spills (384 bytes of
// stack at 16 nodes).
//
// NaN and inf propagate as in the reference: a zero weight still multiplies
// lam (0 * NaN = NaN), so a diverged field stays poisoned. Build with
// --fmad=false so that no product is contracted into an FMA the reference
// does not have.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
// Nodes per thread up to which K4 keeps its nodes' state in registers, and
// K5 stages them.
constexpr int kRegNodes = 4;
constexpr int kLargeNodes = 20;
// Axis 2: K5's ring holds two chunks of kChunk z-planes (0.625 fields at
// 128^3); K4's holds the whole axis, copied through one padded 32 x 33 tile
// per warp.
constexpr int kChunk = 8;
constexpr int kTileFloats = 32 * 33;
// Ring operands: lam, g, w_2 (axial), w_0 and w_1 (in-plane).
constexpr int kOps = 5;
// K4's shared planes: three lam exchange buffers, two pairs of weight
// planes, and the next plane's g and three axial values staged per thread.
constexpr int kK4Planes = 11;

// Ring slots per operand and field for n2 z-planes: K4 the whole axis; K5
// two chunks, or one where a chunk holds the axis.
__host__ __device__ __forceinline__ int ring_slots(int n2, bool large) {
  return !large ? n2 : (n2 > kChunk ? 2 * kChunk : kChunk);
}

__device__ __forceinline__ float pos(float w) { return w > 0.0f ? w : 0.0f; }
__device__ __forceinline__ float neg(float w) { return w < 0.0f ? -w : 0.0f; }

// One swept axis: the plane axes p < q, and where plane i lives in the
// arrays marched (the field on axes 0 and 1, a ring slot on axis 2).
struct Axis {
  int np, nq, nax, plane;
  int sa, sp, sq;  // element strides of the swept and plane axes
  int ring;        // planes are ring slots, `plane` floats apart
  int ring_mask;   // slot of plane i: i & ring_mask (two chunks)
  int row;         // row of the shared buffers, nq + 2 (the halo)
  __device__ __forceinline__ int off(int i) const {
    return ring ? (i & ring_mask) * plane : i * sa;
  }
};

// The axial inflow of the plane after plane i in a march of direction
// `step`, from_prev + from_next in the reference's order and with its edge
// cases (only one side: that side alone), in two parts: near_term, plane
// i's (just updated: lam `near`, weight `w_near`), and axial_sum, which adds
// plane i + 2 step's (not yet updated in this march: `far`, `w_far`) where
// it exists (`has_far`).
__device__ __forceinline__ float near_term(int step, float near,
                                           float w_near) {
  return step > 0 ? neg(w_near) * near : pos(w_near) * near;
}

__device__ __forceinline__ float axial_sum(int step, bool has_far, float nt,
                                           float far, float w_far) {
  if (!has_far) return nt;
  return step > 0 ? nt + pos(w_far) * far : neg(w_far) * far + nt;
}

// K4's ring copies: the field src (n0, n1, n2) into the ring dst laid out
// (z, x, y) (to_ring), or back (!to_ring), in 32 x 32 tiles of (y, z) at
// one x, one per warp at a time, through the warp's padded tile in shared
// memory, so that both sides run along a contiguous axis (K1's transpose).
__device__ void ring_tiles(const float* src, float* dst, int n0, int n1,
                           int n2, bool to_ring, float* tiles) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* tile = tiles + warp * kTileFloats;
  const int plane2 = n0 * n1;
  const int ty = (n1 + 31) / 32, tz = (n2 + 31) / 32;
  for (int t = warp; t < n0 * ty * tz; t += nw) {
    const int x = t / (ty * tz);
    const int rem = t - x * ty * tz;
    const int y0 = (rem / tz) * 32, z0 = (rem % tz) * 32;
    // Read rows along the source's contiguous axis (z, or y from the ring).
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int y = to_ring ? y0 + r : y0 + lane;
      const int z = to_ring ? z0 + lane : z0 + r;
      const int off = to_ring ? (x * n1 + y) * n2 + z : z * plane2 + x * n1 + y;
      tile[r * 33 + lane] = (y < n1 && z < n2) ? src[off] : 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int y = to_ring ? y0 + lane : y0 + r;
      const int z = to_ring ? z0 + r : z0 + lane;
      const int off = to_ring ? z * plane2 + x * n1 + y : (x * n1 + y) * n2 + z;
      if (y < n1 && z < n2) dst[off] = tile[lane * 33 + r];
    }
    __syncwarp();
  }
}

// K5's ring copies on axis 2, per thread and out of line (their 40 live
// values per column would otherwise set the register budget of the march):
// ring_copy_in copies z-planes [c kChunk, (c + 1) kChunk) of the thread's
// own (x, y) columns m = tid + j nthr (j < npt, m < plane2) of the five
// operands into ring slots z % nring (8 consecutive floats, one sector, per
// column and operand: two float4 loads where aligned); ring_copy_out copies
// lam back. The march reads and writes only its own nodes, the same
// columns, so no barrier guards these copies.
__device__ __noinline__ void ring_copy_in(const float* const* src, float* ring,
                                          int c, int n2, int plane2, int nring,
                                          int npt) {
  const int z0 = c * kChunk, nz = min(kChunk, n2 - z0);
  const bool vec = n2 % 4 == 0 && nz == kChunk &&
                   (((uintptr_t)src[0] | (uintptr_t)src[1] | (uintptr_t)src[2] |
                     (uintptr_t)src[3] | (uintptr_t)src[4]) & 15) == 0;
  for (int j = 0; j < npt; ++j) {
    const int m = threadIdx.x + j * blockDim.x;
    if (m >= plane2) break;
    const int col = m * n2 + z0;
    float v[kOps][kChunk];
#pragma unroll
    for (int o = 0; o < kOps; ++o) {
      if (vec) {
        const float4 a = *reinterpret_cast<const float4*>(src[o] + col);
        const float4 b = *reinterpret_cast<const float4*>(src[o] + col + 4);
        v[o][0] = a.x; v[o][1] = a.y; v[o][2] = a.z; v[o][3] = a.w;
        v[o][4] = b.x; v[o][5] = b.y; v[o][6] = b.z; v[o][7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          v[o][e] = e < nz ? src[o][col + e] : 0.0f;
      }
    }
#pragma unroll
    for (int o = 0; o < kOps; ++o)
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (e < nz) ring[(o * nring + (z0 + e) % nring) * plane2 + m] = v[o][e];
  }
}

__device__ __noinline__ void ring_copy_out(float* lam, const float* ring, int c,
                                           int n2, int plane2, int nring,
                                           int npt) {
  const int z0 = c * kChunk, nz = min(kChunk, n2 - z0);
  for (int j = 0; j < npt; ++j) {
    const int m = threadIdx.x + j * blockDim.x;
    if (m >= plane2) break;
    const int col = m * n2 + z0;
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < nz) lam[col + e] = ring[((z0 + e) % nring) * plane2 + m];
  }
}

// lam and the ring are read and written by the CTA: plain coherent loads
// and cp.async (no __restrict__/read-only path), so later visits see
// earlier stores.
template <int NPT, bool kRowQ, bool kLarge>
__global__ void __launch_bounds__(kMaxThreads, 1)
transport3d_cycle_kernel(float* lam, const float* G, const float* W0,
                         const float* W1, const float* W2, float* ring,
                         uint8_t* ready, const uint8_t* __restrict__ done,
                         unsigned long long* __restrict__ count, int n0, int n1,
                         int n2, int n_inner) {
  const int b = blockIdx.x;
  if (done[b]) return;  // uniform per CTA: no barrier is skipped by half
  // One field-cycle per active field and launch.
  if (count != nullptr && threadIdx.x == 0) atomicAdd(count, 1ULL);
  // K4: this field's ring already holds g and the weights (read by every
  // thread before any barrier; thread 0 sets the flag after one).
  const bool kept = !kLarge && ready != nullptr && ready[b];
  const int64_t field = (int64_t)n0 * n1 * n2;
  lam += b * field;
  G += b * field;
  W0 += b * field;
  W1 += b * field;
  W2 += b * field;
  const int plane2 = n0 * n1;
  const int nring = ring_slots(n2, kLarge);
  ring += (int64_t)b * kOps * nring * plane2;
  const int nchunks = (n2 + kChunk - 1) / kChunk;

  extern __shared__ float smem[];
  const int maxpad = max((n1 + 2) * (n2 + 2),
                         max((n0 + 2) * (n2 + 2), (n0 + 2) * (n1 + 2)));
  // K4: three exchange buffers (two for the Jacobi steps, one filling with
  // the next plane), two pairs of weight planes (this plane's, the next
  // one's) and four planes of the thread's own staged values; K5: one
  // exchange buffer and the two weight planes.
  constexpr int kBufs = kLarge ? 3 : kK4Planes;
  float* const bufA = smem;
  float* const wps = smem + (kLarge ? 1 : 3) * maxpad;
  float* const wqs = wps + maxpad;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // K4's ring copies (all threads, shared memory free): the whole axis of
  // the five operands in, or of lam alone where the ring is kept; of lam
  // out.
  const float* const src[kOps] = {lam, G, W2, W0, W1};
  auto ring_in = [&]() {
#pragma unroll
    for (int o = 0; o < kOps; ++o)
      if (o == 0 || !kept)
        ring_tiles(src[o], ring + o * nring * plane2, n0, n1, n2, true, smem);
  };
  auto ring_out = [&]() {
    ring_tiles(ring, lam, n0, n1, n2, false, smem);
  };

  // K4 marches each axis in code of its own (ptxas then allocates each
  // march's registers apart); K5's register budget is set by its 16 nodes
  // per thread, and three copies of its march cost it time.
  constexpr int kAxisCopies = kLarge ? 1 : 3;
#pragma unroll kAxisCopies
  for (int ax = 0; ax < 3; ++ax) {
    // Plane axes in grid order, as the reference's moveaxis layout.
    const int p = ax == 0 ? 1 : 0;
    const int q = ax == 2 ? 1 : 2;
    Axis A;
    A.np = p == 0 ? n0 : n1;
    A.nq = q == 1 ? n1 : n2;
    A.nax = ax == 0 ? n0 : (ax == 1 ? n1 : n2);
    A.plane = A.np * A.nq;
    A.row = A.nq + 2;
    float* L = lam;
    const float* Gm = G;
    const float* Wax = ax == 0 ? W0 : (ax == 1 ? W1 : W2);
    const float* Wp = p == 0 ? W0 : W1;
    const float* Wq = q == 1 ? W1 : W2;
    A.ring = 0;
    A.ring_mask = nring - 1;
    if (ax == 2) {
      // The (x, y) planes of axis 2 are strided by n2 in the field's
      // layout: march them in the ring, where each is contiguous. K4 copies
      // the whole axis in now; K5 its first chunk (the rest as the march
      // goes, A.ring).
      const int s = nring * plane2;
      L = ring;
      Gm = ring + s;
      Wax = ring + 2 * s;
      Wp = ring + 3 * s;
      Wq = ring + 4 * s;
      A.sa = plane2;
      A.sp = n1;
      A.sq = 1;
      if constexpr (kLarge) {
        A.ring = 1;
        ring_copy_in(src, ring, 0, n2, plane2, nring, NPT);
      } else {
        ring_in();
      }
      __syncthreads();
      if (!kLarge && ready != nullptr && tid == 0) ready[b] = 1;
    } else {
      A.sa = ax == 0 ? n1 * n2 : n2;
      A.sp = p == 0 ? n1 * n2 : n2;
      A.sq = 1;
    }
    // Zero buffers: their halo stays zero for the whole march.
    for (int e = tid; e < kBufs * maxpad; e += nthr) smem[e] = 0.0f;
    __syncthreads();

    // The owned nodes' in-plane coordinates, divided out once per axis.
    // kRowQ (nthr a multiple of every plane's row length nq): a thread's
    // nodes share iq and step ip by nthr / nq, so nothing is kept per node.
    // Otherwise one register per node holds ip << 16 | iq (-1 past the
    // plane; sides are below 2^15).
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
    auto at = [&](int j) { return (ip_of(j) + 1) * A.row + iq_of(j) + 1; };

    for (int dir = 0; dir < 2; ++dir) {
      const int step = dir == 0 ? 1 : -1;
      const int first = dir == 0 ? 0 : A.nax - 1;
      // K5's ring on axis 2, each thread its own columns: as a chunk starts
      // (in march order) the next one comes in, into the slots of the one
      // before, which went back to the field as it ended. The forward march
      // keeps the last two chunks, which the backward march takes first.
      auto chunk_start = [&](int i) {
        const int c = i / kChunk;
        if (dir == 0) {
          if (i % kChunk == 0 && c + 1 < nchunks)
            ring_copy_in(src, ring, c + 1, n2, plane2, nring, NPT);
        } else if ((i == n2 - 1 || i % kChunk == kChunk - 1) && c >= 1 &&
                   c - 1 < nchunks - 2) {
          ring_copy_in(src, ring, c - 1, n2, plane2, nring, NPT);
        }
      };
      auto chunk_end = [&](int i) {
        const int c = i / kChunk;
        if (dir == 0) {
          if ((i % kChunk == kChunk - 1 || i == n2 - 1) && c < nchunks - 2)
            ring_copy_out(lam, ring, c, n2, plane2, nring, NPT);
        } else if (i % kChunk == 0) {
          ring_copy_out(lam, ring, c, n2, plane2, nring, NPT);
        }
      };

      float base[NPT], tc[NPT];
      float* cur = bufA;  // K5's exchange buffer, K4's first
      int xa = 0, wa = 0;  // K4: the exchange buffer and weight pair in use
      // The first plane: stage lam and the in-plane weights, and its base
      // (one axial neighbour, none on a one-plane axis).
      {
        const int o0 = A.off(first);
        const bool hasn = A.nax > 1;
        const int o1 = hasn ? A.off(first + step) : 0;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          if (!owns(j)) continue;
          const int m = at(j), pj = po(j);
          cur[m] = L[o0 + pj];
          wps[m] = Wp[o0 + pj];
          wqs[m] = Wq[o0 + pj];
          float axial = 0.0f;
          if (hasn) {
            const float w = Wax[o1 + pj], l = L[o1 + pj];
            axial = dir == 0 ? pos(w) * l : neg(w) * l;
          }
          base[j] = Gm[o0 + pj] + axial;
        }
      }
      __syncthreads();

      for (int k = 0; k < A.nax; ++k) {
        const int i = first + step * k;
        const bool more = k + 1 < A.nax, has2 = k + 2 < A.nax;
        const int oi = A.off(i);
        const int o1 = more ? A.off(i + step) : 0;
        const int o2 = has2 ? A.off(i + 2 * step) : 0;
        if constexpr (!kLarge) {
          // K4. The next plane's lam and weights and the values of its base
          // go to shared memory by cp.async (no registers) while the Jacobi
          // steps run; lam and base stay in registers.
          float* const xc = bufA + xa * maxpad;
          float* const xn = bufA + (xa == 2 ? 0 : xa + 1) * maxpad;
          float* const xp = bufA + (xa == 0 ? 2 : xa - 1) * maxpad;
          const float* const wpc = wps + 2 * wa * maxpad;
          const float* const wqc = wpc + maxpad;
          float* const wpx = wps + 2 * (1 - wa) * maxpad;
          float* const wqx = wpx + maxpad;
          float* const sg = wps + 4 * maxpad;
          float* const sl2 = sg + maxpad;
          float* const sw0 = sl2 + maxpad;
          float* const sw2 = sw0 + maxpad;
          if (more) {
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int m = at(j), pj = po(j);
              __pipeline_memcpy_async(xp + m, L + o1 + pj, 4);
              __pipeline_memcpy_async(wpx + m, Wp + o1 + pj, 4);
              __pipeline_memcpy_async(wqx + m, Wq + o1 + pj, 4);
              __pipeline_memcpy_async(sg + m, Gm + o1 + pj, 4);
              __pipeline_memcpy_async(sw0 + m, Wax + oi + pj, 4);
              if (has2) {
                __pipeline_memcpy_async(sl2 + m, L + o2 + pj, 4);
                __pipeline_memcpy_async(sw2 + m, Wax + o2 + pj, 4);
              }
            }
            __pipeline_commit();
          }
          const float* src = xc;
          float* dst = xn;
          for (int it = 0; it < n_inner; ++it) {
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int m = at(j);
              float acc = pos(wpc[m + A.row]) * src[m + A.row];
              acc = acc + neg(wpc[m - A.row]) * src[m - A.row];
              acc = acc + pos(wqc[m + 1]) * src[m + 1];
              acc = acc + neg(wqc[m - 1]) * src[m - 1];
              tc[j] = base[j] + acc;
            }
            if (it + 1 < n_inner) {
#pragma unroll
              for (int j = 0; j < NPT; ++j)
                if (owns(j)) dst[at(j)] = tc[j];
              __syncthreads();
              float* const tmp = const_cast<float*>(src);
              src = dst;
              dst = tmp;
            }
          }
          if (n_inner == 0) {
#pragma unroll
            for (int j = 0; j < NPT; ++j)
              if (owns(j)) tc[j] = src[at(j)];
          }
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            if (owns(j)) L[oi + po(j)] = tc[j];
          if (more) {
            __pipeline_wait_prior(0);  // this thread's copies have landed
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int m = at(j);
              base[j] = sg[m] + axial_sum(step, has2,
                                          near_term(step, tc[j], sw0[m]),
                                          has2 ? sl2[m] : 0.0f,
                                          has2 ? sw2[m] : 0.0f);
            }
          }
          // The next plane's buffers are complete for every thread, and
          // this visit's reads are done before its buffers are refilled.
          __syncthreads();
          xa = xa == 0 ? 2 : xa - 1;
          wa = 1 - wa;
        } else {
          if (A.ring) chunk_start(i);
          // K5: one exchange buffer; a step reads every neighbour before
          // any thread writes its result.
          for (int it = 0; it < n_inner; ++it) {
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int m = at(j);
              float acc = pos(wps[m + A.row]) * cur[m + A.row];
              acc = acc + neg(wps[m - A.row]) * cur[m - A.row];
              acc = acc + pos(wqs[m + 1]) * cur[m + 1];
              acc = acc + neg(wqs[m - 1]) * cur[m - 1];
              tc[j] = base[j] + acc;
            }
            if (it + 1 < n_inner) {
              __syncthreads();
#pragma unroll
              for (int j = 0; j < NPT; ++j)
                if (owns(j)) cur[at(j)] = tc[j];
              __syncthreads();
            }
          }
          if (n_inner == 0) {
#pragma unroll
            for (int j = 0; j < NPT; ++j)
              if (owns(j)) tc[j] = cur[at(j)];
          }
          // Store the plane, and keep of it only its share of the next
          // plane's inflow.
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            if (!owns(j)) continue;
            L[oi + po(j)] = tc[j];
            tc[j] = near_term(step, tc[j], Wax[oi + po(j)]);
          }
          // Every read of the buffers is done before the next plane's
          // values overwrite them.
          __syncthreads();
          if (A.ring) chunk_end(i);
          if (more) {
            // Stage the next plane, then its base: two passes, so that
            // fewer loads are in flight at once (16 nodes per thread).
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int m = at(j), pj = po(j);
              cur[m] = L[o1 + pj];
              wps[m] = Wp[o1 + pj];
              wqs[m] = Wq[o1 + pj];
            }
#pragma unroll
            for (int j = 0; j < NPT; ++j) {
              if (!owns(j)) continue;
              const int pj = po(j);
              const float l2 = has2 ? L[o2 + pj] : 0.0f;
              const float w2 = has2 ? Wax[o2 + pj] : 0.0f;
              base[j] = Gm[o1 + pj] + axial_sum(step, has2, tc[j], l2, w2);
            }
            __syncthreads();
          }
        }
      }
    }
    // K4: axis 2's lam back to the field (the buffers are free).
    if (!kLarge && ax == 2) ring_out();
  }
}

template <int NPT, bool kRowQ, bool kLarge>
int launch_npt(float* lam, const float* G, const float* W0, const float* W1,
               const float* W2, float* ring, uint8_t* ready,
               const uint8_t* done, unsigned long long* count, int B,
               int n0, int n1, int n2, int n_inner, int threads,
               size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      transport3d_cycle_kernel<NPT, kRowQ, kLarge>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  transport3d_cycle_kernel<NPT, kRowQ, kLarge>
      <<<B, threads, smem, (cudaStream_t)stream>>>(
          lam, G, W0, W1, W2, ring, ready, done, count, n0, n1, n2,
          n_inner);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one CTA: the haloed plane buffers, or K4's
// warps' ring tiles where larger (they reuse the same memory).
size_t smem_bytes(int n0, int n1, int n2, int threads, bool large) {
  int maxpad = (n1 + 2) * (n2 + 2);
  if ((n0 + 2) * (n2 + 2) > maxpad) maxpad = (n0 + 2) * (n2 + 2);
  if ((n0 + 2) * (n1 + 2) > maxpad) maxpad = (n0 + 2) * (n1 + 2);
  const size_t planes =
      (large ? 3 : kK4Planes) * (size_t)maxpad * sizeof(float);
  const size_t tiles =
      large ? 0 : (size_t)(threads / 32) * kTileFloats * sizeof(float);
  return tiles > planes ? tiles : planes;
}

template <bool kLarge>
int launch(float* lam, const float* G, const float* W0, const float* W1,
           const float* W2, float* ring, uint8_t* ready, const uint8_t* done,
           unsigned long long* count, int B, int n0,
           int n1, int n2, int n_inner, int threads, int device,
           void* stream) {
  int max_plane = n1 * n2;
  if (n0 * n2 > max_plane) max_plane = n0 * n2;
  if (n0 * n1 > max_plane) max_plane = n0 * n1;
  const size_t smem = smem_bytes(n0, n1, n2, threads, kLarge);
  const int npt = (max_plane + threads - 1) / threads;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // Row-aligned ownership where every plane's rows (n2 for axes 0 and 1,
  // n1 for axis 2) divide the thread count.
  const bool row_q = threads % n2 == 0 && threads % n1 == 0;
#define T3_LAUNCH(N)                                                          \
  (row_q ? launch_npt<N, true, kLarge>(lam, G, W0, W1, W2, ring, ready, done, \
                                       count, B, n0, n1, n2, n_inner, threads, \
                                       smem, stream)                          \
         : launch_npt<N, false, kLarge>(lam, G, W0, W1, W2, ring, ready, done, \
                                        count, B, n0, n1, n2, n_inner,        \
                                        threads, smem, stream))
  static_assert(kRegNodes == 4 && kLargeNodes == 20,
                "K4's instances hold 1-4 nodes per thread, K5's 4-20");
  if constexpr (!kLarge) {
    switch (npt) {
      case 1: return T3_LAUNCH(1);
      case 2: return T3_LAUNCH(2);
      case 3: return T3_LAUNCH(3);
      case 4: return T3_LAUNCH(4);
      default: return -1;
    }
  } else {
    switch (npt) {
      case 1: case 2: case 3: case 4: return T3_LAUNCH(4);
      case 5: case 6: case 7: case 8: return T3_LAUNCH(8);
      case 9: case 10: case 11: case 12: return T3_LAUNCH(12);
      case 13: case 14: case 15: case 16: return T3_LAUNCH(16);
      case 17: case 18: case 19: case 20: return T3_LAUNCH(20);
      default: return -1;
    }
  }
#undef T3_LAUNCH
}

}  // namespace

// The axis-2 ring's slots per operand and field, R, of K4 and of K5: the
// ring the entries below take is B * 5 * R * n0 * n1 floats.
extern "C" int transport3d_ring_planes(int n2) { return ring_slots(n2, false); }
extern "C" int transport3d_large_ring_planes(int n2) {
  return ring_slots(n2, true);
}

// What each entry takes: its shared memory per CTA for an (n0, n1, n2)
// field at `threads` threads, and its nodes per thread. The wrapper holds
// the same rules, so that it chooses and refuses on the CPU too;
// tests/test_torch_cuda.py holds the two equal.
extern "C" int transport3d_smem_bytes(int n0, int n1, int n2, int threads) {
  return (int)smem_bytes(n0, n1, n2, threads, false);
}
extern "C" int transport3d_large_smem_bytes(int n0, int n1, int n2,
                                            int threads) {
  return (int)smem_bytes(n0, n1, n2, threads, true);
}
extern "C" int transport3d_nodes_per_thread() { return kRegNodes; }
extern "C" int transport3d_large_nodes_per_thread() { return kLargeNodes; }

// C entries, loaded with ctypes: one cycle on the (B, n0, n1, n2) batch lam
// in place, with g and the signed weights W0, W1, W2 of the same shape, and
// `ring` the axis-2 scratch (the ring_planes entries above). `ready` is
// NULL, or B flags of a ring kept from cycle to cycle with the same g and
// weights: K4 copies them into a field's ring where its flag is clear and
// sets the flag; K5 refills its ring every cycle and ignores it. `count` is
// null or a counter that each field not done adds 1 to (its field-cycles). K4
// (`transport3d_cycle`, up to 4 nodes per thread in registers, eleven
// shared planes) and K5 (`transport3d_large_cycle`, up to 20 nodes per
// thread, three shared planes). Each launches on `stream` of `device` and
// returns the CUDA error code of the set-up calls or of cudaGetLastError()
// after the launch (0 = launched; -1 = a plane with more nodes per thread
// than the entry takes). Neither synchronises.
extern "C" int transport3d_cycle(float* lam, const float* G, const float* W0,
                                 const float* W1, const float* W2, float* ring,
                                 uint8_t* ready, const uint8_t* done,
                                 unsigned long long* count, int B, int n0,
                                 int n1, int n2, int n_inner, int threads,
                                 int device, void* stream) {
  return launch<false>(lam, G, W0, W1, W2, ring, ready, done, count, B, n0,
                       n1, n2, n_inner, threads, device, stream);
}

extern "C" int transport3d_large_cycle(float* lam, const float* G,
                                       const float* W0, const float* W1,
                                       const float* W2, float* ring,
                                       uint8_t* ready, const uint8_t* done,
                                       unsigned long long* count, int B,
                                       int n0, int n1, int n2, int n_inner,
                                       int threads, int device, void* stream) {
  return launch<true>(lam, G, W0, W1, W2, ring, ready, done, count, B, n0, n1,
                      n2, n_inner, threads, device, stream);
}
