// K6: the 2-D adjoint transport sweep over a batch of fields, for sm_90a:
// one cycle per field, or each field's whole solve, in one launch.
//
// Replaces the Pallas TPU kernel `_transport_axis0_kernel` /
// `transport_axis0` (mceik_tpu/eikonal/pallas_transport.py:61, :132) on 2-D
// fields, as `transport_cycle_pallas` (:148) drives it in the reference's
// per-field cycle loop: the axis-0 march, then the same kernel on the
// transposed field for axis 1. One cycle computes the plain reference
// `transport_cycle_plain` on a (B, n0, n1) batch
// (mceik_tpu_torch/eikonal/adjoint_sweep.py) operation for operation. The
// system is lam = W^T lam + g with two signed upwind weight fields (w > 0:
// the node's argmin neighbour on that axis is the low side, w < 0 the high
// side). For axis 0 and then axis 1, march the lines low -> high and then
// high -> low; line i takes
//
//   base = g[i] + (from_prev + from_next),
//     from_prev = max(-w_ax[i-1], 0) * lam[i-1]   (already updated here)
//     from_next = max( w_ax[i+1], 0) * lam[i+1]
//
// and then n_inner Jacobi steps along the line lam = base + collect(lam),
// collect[j] = max(w_ln[j+1], 0) * lam[j+1] + max(-w_ln[j-1], 0) * lam[j-1]
// (the reference's `lo + hi`), w_ln the weight of the line's own axis.
// Past an edge nothing is read and the term is an exact 0: a self-read
// would corrupt this linear system. NaN and inf propagate as in the
// reference: a zero weight still multiplies lam (0 * NaN = NaN).
//
// The solve (`solve` set) is `adjoint_sweep.transport_solve` per field,
// from lam = g: tol_eff = tol * (1e-3f + max|g|) in fp32 as the host loop
// rounds it; after each cycle the residual d = max |lam_new - lam_old|
// (NaN-propagating, as torch.amax), d0 the first; the field diverges when d
// is not finite or d > 10 d0 (DIVERGENCE_FACTOR) and then comes back all
// NaN (the bits of float("nan")); it stops when !(d > tol_eff) or after
// max_cycles. Each field's cycle count is written out.
//
// Design, K3's (csrc/sweep2d.cu, line2d.cuh): one warp owns one field, one
// warp per CTA; lam, g, w0 and w1 in shared memory at an odd row stride ld
// = n1 | 1 (67.6 KB at 65^2, 36.9 KB at 48^2; up to 120^2); the line being
// marched in registers, NPL consecutive nodes per lane, with its base and
// the in-line weights of its neighbours (taken once per line, the lane-edge
// ones by shuffles); a Jacobi step takes lam's in-lane neighbours from
// registers and the two lane-edge ones by shuffles, so it waits on no
// barrier. Node loads select rather than branch. The axial terms read the
// lines either side from shared memory, written by this warp; the line
// loads share K3's bank conflicts (gcd(NPL, 32) lanes per bank). A solve
// keeps the field on chip from its load to its last cycle; per cycle,
// device memory sees one read of the cycle-start copy and one write.
//
// What bounds it. A field is a dependent chain of 2 (n0 + n1) n_inner line
// steps per cycle (520 at 65^2), each two shuffles and ~6 operations per
// node, and each line visit seven shared-memory loads per node: latency
// per warp, with only ~6 fields of 48^2 per SM (four fields of shared
// memory each). Config 1's 32 fields use 32 of the 132 SMs.
//
// Left out as TPU workarounds: the transposes between the axis marches,
// lane packing and seam masks, and the `i >= 1` guard spelling.
//
// Build with --fmad=false so that no product is contracted into an FMA the
// reference does not have.

#include "line2d.cuh"

namespace {

__device__ __forceinline__ float pos(float w) { return w > 0.0f ? w : 0.0f; }
__device__ __forceinline__ float neg(float w) { return w < 0.0f ? -w : 0.0f; }

constexpr float kDivergenceFactor = 10.0f;

// One full cycle of the warp's field in shared memory. Node loads read a
// clamped index and select, so that the loops over a lane's nodes have no
// branch.
template <int NPL>
__device__ __forceinline__ void transport_cycle(float* sL, const float* sG,
                                                const float* sW0,
                                                const float* sW1, int n0,
                                                int n1, int ld, int n_inner,
                                                int lane) {
  for (int ax = 0; ax < 2; ++ax) {
    // Axis 0 marches the rows (line k = row k, node p at (k, p)); axis 1
    // the columns (line k = column k, node p at (p, k)).
    const int n_lines = ax == 0 ? n0 : n1;
    const int len = ax == 0 ? n1 : n0;
    const int ls = ax == 0 ? ld : 1;
    const int ns = ax == 0 ? 1 : ld;
    const float* w_ax = ax == 0 ? sW0 : sW1;
    const float* w_ln = ax == 0 ? sW1 : sW0;
    // This lane's node offsets along a line, clamped into it, and which of
    // its in-line neighbours exist.
    int po[NPL];
    bool in[NPL], has_up[NPL], has_dn[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int p = lane * NPL + k;
      in[k] = p < len;
      has_up[k] = p + 1 < len;
      has_dn[k] = p > 0 && p < len;
      po[k] = (in[k] ? p : len - 1) * ns;
    }
    for (int dir = 0; dir < 2; ++dir) {
      for (int q = 0; q < n_lines; ++q) {
        const int line = dir == 0 ? q : n_lines - 1 - q;
        const bool has_prev = line > 0, has_next = line + 1 < n_lines;
        const int lo = line * ls;
        const int plo = (has_prev ? line - 1 : line) * ls;
        const int nlo = (has_next ? line + 1 : line) * ls;
        // Per node: lam, base, and its own in-line weight's two halves.
        float t[NPL], b[NPL], wp[NPL], wn[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
          const float fp = neg(w_ax[plo + po[k]]) * sL[plo + po[k]];
          const float fn = pos(w_ax[nlo + po[k]]) * sL[nlo + po[k]];
          const float axial =
              has_prev ? (has_next ? fp + fn : fp) : (has_next ? fn : 0.0f);
          b[k] = sG[lo + po[k]] + axial;
          t[k] = in[k] ? sL[lo + po[k]] : 0.0f;
          const float wl = w_ln[lo + po[k]];
          wp[k] = pos(wl);
          wn[k] = neg(wl);
        }
        // The weights node p's terms take: pos(w_ln[p + 1]), neg(w_ln[p - 1])
        // (at the line's ends the terms are not taken).
        float wn_dn, wp_up;
        line2d::lane_edges(wp[0], wn[NPL - 1], lane, 0.0f, wn_dn, wp_up);
        float wu[NPL], wd[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
          wu[k] = k + 1 < NPL ? wp[k + 1] : wp_up;
          wd[k] = k > 0 ? wn[k - 1] : wn_dn;
        }
        for (int it = 0; it < n_inner; ++it) {
          float dn, up;
          line2d::lane_edges(t[0], t[NPL - 1], lane, 0.0f, dn, up);
          float u[NPL];
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            const float nu = k + 1 < NPL ? t[k + 1] : up;
            const float nd = k > 0 ? t[k - 1] : dn;
            const float tlo = has_up[k] ? wu[k] * nu : 0.0f;
            const float thi = has_dn[k] ? wd[k] * nd : 0.0f;
            u[k] = in[k] ? b[k] + (tlo + thi) : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < NPL; ++k) t[k] = u[k];
        }
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          if (in[k]) sL[lo + po[k]] = t[k];
      }
    }
    __syncwarp();
  }
}

// One warp per CTA, one field per warp. Shared memory: lam, g, w0 and w1 of
// the field at row stride ld. `done` (cycle mode only, may be null) leaves
// a field's lam as it came; `cycles` (may be null) gets each field's cycle
// count, `count` (may be null) their sum, atomically.
template <int NPL>
__global__ void __launch_bounds__(32)
transport2d_kernel(const float* Lin, float* Lout, const float* __restrict__ G,
                   const float* __restrict__ W0, const float* __restrict__ W1,
                   const uint8_t* __restrict__ done, int* __restrict__ cycles,
                   unsigned long long* __restrict__ count, int n0, int n1,
                   int ld, int n_inner, int max_cycles, float tol,
                   int solve) {
  const int64_t base = (int64_t)blockIdx.x * n0 * n1;
  const int lane = threadIdx.x;
  const int nodes = n0 * n1;
  Lin += base;
  Lout += base;
  if (done != nullptr && done[blockIdx.x]) {
    line2d::copy_field(Lout, Lin, nodes, lane);
    if (lane == 0 && cycles != nullptr) cycles[blockIdx.x] = 0;
    return;
  }
  G += base;
  W0 += base;
  W1 += base;
  extern __shared__ float smem[];
  const int padded = n0 * ld;
  float* sL = smem;
  float* sG = smem + padded;
  float* sW0 = smem + 2 * padded;
  float* sW1 = smem + 3 * padded;
  line2d::load_field(sL, Lin, n0, n1, ld, lane);
  line2d::load_field(sG, G, n0, n1, ld, lane);
  line2d::load_field(sW0, W0, n0, n1, ld, lane);
  line2d::load_field(sW1, W1, n0, n1, ld, lane);
  const float tol_eff =
      solve ? tol * (1e-3f + line2d::field_absmax(G, nodes, lane)) : 0.0f;
  __syncwarp();

  int cyc = 0;
  bool diverged = false;
  float d0 = 0.0f;
  const float* old = Lin;  // the cycle-start field in device memory
  while (cyc < max_cycles) {
    transport_cycle<NPL>(sL, sG, sW0, sW1, n0, n1, ld, n_inner, lane);
    ++cyc;
    if (!solve) break;
    const float d = line2d::residual_pass(sL, old, Lout, n0, n1, ld, lane);
    old = Lout;
    if (cyc == 1) d0 = d;
    if (!isfinite(d) || d > kDivergenceFactor * d0) {
      diverged = true;
      break;
    }
    if (!(d > tol_eff)) break;
  }
  // A solve wrote lam at its last residual pass; a cycle, or no cycle, now.
  if (diverged)
    line2d::fill_field(Lout, __int_as_float(0x7fc00000), nodes, lane);
  else if (!solve || cyc == 0)
    line2d::store_field(Lout, sL, n0, n1, ld, lane);
  if (lane == 0) {
    if (cycles != nullptr) cycles[blockIdx.x] = cyc;
    if (count != nullptr) atomicAdd(count, (unsigned long long)cyc);
  }
}

}  // namespace

// C entry, loaded with ctypes. `ld` is the padded row stride and `smem` the
// dynamic shared memory in bytes (4 n0 ld floats), both computed by the
// wrapper. With `solve` 0: one cycle of every field whose `done` flag is
// clear (done may be null); with `solve` 1: each field's solve from lam =
// Lin (the wrapper passes g), at most max_cycles cycles, convergence at tol
// (done must be null). Reads Lin, writes Lout (distinct buffers); `cycles`
// and `count` may be null. Launches on `stream` of `device`; returns the
// CUDA error code of the set-up calls or of cudaGetLastError() after the
// launch (0 = launched), or -1 for a line longer than 1024 nodes. Does not
// synchronise.
extern "C" int transport2d_solve(const float* Lin, float* Lout,
                                 const float* G, const float* W0,
                                 const float* W1, const uint8_t* done,
                                 int* cycles, unsigned long long* count,
                                 int B, int n0, int n1, int ld, int n_inner,
                                 int max_cycles, float tol, int solve,
                                 int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int npl = line2d::npl_for(n0 > n1 ? n0 : n1);
  switch (npl) {
#define TRANSPORT2D_CASE(N)                                                  \
  case N:                                                                    \
    err = cudaFuncSetAttribute(transport2d_kernel<N>,                        \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               smem);                                        \
    if (err == cudaSuccess)                                                  \
      err = cudaFuncSetAttribute(                                            \
          transport2d_kernel<N>,                                             \
          cudaFuncAttributePreferredSharedMemoryCarveout,                    \
          (int)cudaSharedmemCarveoutMaxShared);                              \
    if (err != cudaSuccess) return (int)err;                                 \
    transport2d_kernel<N><<<B, line2d::kWarp, smem, (cudaStream_t)stream>>>( \
        Lin, Lout, G, W0, W1, done, cycles, count, n0, n1, ld, n_inner,      \
        max_cycles, tol, solve);                                             \
    break;
    LINE2D_NPL_CASES(TRANSPORT2D_CASE)
#undef TRANSPORT2D_CASE
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
