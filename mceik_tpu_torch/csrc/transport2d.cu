// K6: one full 2-D adjoint transport sweep cycle over a batch of fields,
// for sm_90a.
//
// Replaces the Pallas TPU kernel `_transport_axis0_kernel` /
// `transport_axis0` (mceik_tpu/eikonal/pallas_transport.py:61, :132) on 2-D
// fields, as `transport_cycle_pallas` (:148) drives it: the axis-0 march,
// then the same kernel on the transposed field for axis 1. It computes the
// plain reference `transport_cycle_plain` on a (B, n0, n1) batch
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
// would corrupt this linear system.
//
// Design, as K3 (csrc/sweep2d.cu). A 2-D field fits in shared memory whole:
// lam, g, w0 and w1 take 16 bytes per node at an odd row stride ld = n1 | 1
// (67.6 KB at 65^2, 36.9 KB at 48^2), so one CTA owns one field, loads it
// once, runs the cycle on shared memory and writes lam once. One thread
// owns one node position of a line (threads = the longest line rounded up
// to whole warps): a row of the axis-0 march, a column of the axis-1 march.
// The axial terms read only the thread's own position on the lines either
// side, which the thread itself last wrote, so they need no barrier. The
// Jacobi steps exchange line neighbours through two line buffers with one
// block barrier per step; the last step writes the line back into the
// field in place. The odd row stride puts a column's nodes in 32 distinct
// banks, so the axis swap needs no transpose. Done fields are copied
// through. The four fields cap a grid at 14,500-odd nodes (119^2 but not
// 120^2), where the wrapper refuses; a larger one needs a cluster of CTAs
// (distributed shared memory), later work.
//
// What bounds it. Each field is a dependent chain of 2 (n0 + n1) n_inner
// barriered line steps per cycle (520 at 65^2), each a few shared-memory
// loads and ~7 flops: latency and barriers per CTA, not bytes (a 65^2 field
// moves 85 KB per cycle). Config 1's 32 fields leave 100 of the 132 SMs
// idle. Several fields per CTA and a warp per line with shuffles in place
// of barriers are later work.
//
// Left out as TPU workarounds: the transposes between the axis marches,
// lane packing and seam masks, and the `i >= 1` guard spelling.
//
// NaN and inf propagate as in the reference: a zero weight still multiplies
// lam (0 * NaN = NaN), so a diverged field stays poisoned. Build with
// --fmad=false so that no product is contracted into an FMA the reference
// does not have.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float pos(float w) { return w > 0.0f ? w : 0.0f; }
__device__ __forceinline__ float neg(float w) { return w < 0.0f ? -w : 0.0f; }

// One CTA per field; blockDim.x >= max(n0, n1). Shared memory: lam, g, w0
// and w1 with row stride ld, then two line buffers of blockDim.x floats.
__global__ void __launch_bounds__(1024)
transport2d_cycle_kernel(const float* __restrict__ Lin,
                         float* __restrict__ Lout,
                         const float* __restrict__ G,
                         const float* __restrict__ W0,
                         const float* __restrict__ W1,
                         const uint8_t* __restrict__ done, int n0, int n1,
                         int ld, int n_inner) {
  const int64_t field = (int64_t)n0 * n1;
  const int64_t base = blockIdx.x * field;
  Lin += base;
  Lout += base;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nodes = n0 * n1;
  if (done[blockIdx.x]) {  // uniform per CTA: no barrier is skipped by half
    for (int m = tid; m < nodes; m += nthr) Lout[m] = Lin[m];
    return;
  }
  G += base;
  W0 += base;
  W1 += base;

  extern __shared__ float smem[];
  const int padded = n0 * ld;
  float* sL = smem;
  float* sG = smem + padded;
  float* sW[2] = {smem + 2 * padded, smem + 3 * padded};
  float* lb0 = smem + 4 * padded;  // line buffers, alternating by step
  float* lb1 = lb0 + nthr;
  for (int m = tid; m < nodes; m += nthr) {
    const int i = m / n1, j = m - i * n1;
    const int o = i * ld + j;
    sL[o] = Lin[m];
    sG[o] = G[m];
    sW[0][o] = W0[m];
    sW[1][o] = W1[m];
  }
  __syncthreads();

  for (int ax = 0; ax < 2; ++ax) {
    // Axis 0 marches the rows (line k = row k, node t at (k, t)); axis 1
    // the columns (line k = column k, node t at (t, k)).
    const int n_lines = ax == 0 ? n0 : n1;
    const int len = ax == 0 ? n1 : n0;
    const int line_stride = ax == 0 ? ld : 1;
    const int node_stride = ax == 0 ? 1 : ld;
    const float* w_ax = sW[ax];
    const float* w_ln = sW[1 - ax];
    const bool active = tid < len;
    for (int dir = 0; dir < 2; ++dir) {
      for (int k = 0; k < n_lines; ++k) {
        const int line = dir == 0 ? k : n_lines - 1 - k;
        const int off = line * line_stride + tid * node_stride;
        const bool has_prev = line > 0, has_next = line + 1 < n_lines;
        float b = 0.0f, lam = 0.0f;
        if (active) {
          float axial = 0.0f;
          if (has_prev && has_next) {
            const float fp = neg(w_ax[off - line_stride]) * sL[off - line_stride];
            const float fn = pos(w_ax[off + line_stride]) * sL[off + line_stride];
            axial = fp + fn;
          } else if (has_prev) {
            axial = neg(w_ax[off - line_stride]) * sL[off - line_stride];
          } else if (has_next) {
            axial = pos(w_ax[off + line_stride]) * sL[off + line_stride];
          }
          b = sG[off] + axial;
          lam = sL[off];
        }
        // Step 0 reads the line's neighbours in the field, later steps the
        // previous step's line buffer; the in-line weights stay in the
        // field.
        const float* src = sL + line * line_stride;
        int src_stride = node_stride;
        const float* wl = w_ln + line * line_stride;
        for (int it = 0; it < n_inner; ++it) {
          if (active) {
            const float lo = tid + 1 < len
                ? pos(wl[(tid + 1) * node_stride]) * src[(tid + 1) * src_stride]
                : 0.0f;
            const float hi = tid > 0
                ? neg(wl[(tid - 1) * node_stride]) * src[(tid - 1) * src_stride]
                : 0.0f;
            lam = b + (lo + hi);
          }
          float* dst = (it & 1) ? lb1 : lb0;
          if (it + 1 < n_inner) {
            if (active) dst[tid] = lam;
          } else {
            // The last step writes the node in place; with one step, its
            // own neighbour reads came from the field, so wait for them.
            if (it == 0) __syncthreads();
            if (active) sL[off] = lam;
          }
          __syncthreads();
          src = dst;
          src_stride = 1;
        }
      }
    }
  }

  for (int m = tid; m < nodes; m += nthr) {
    const int i = m / n1, j = m - i * n1;
    Lout[m] = sL[i * ld + j];
  }
}

}  // namespace

// C entry, loaded with ctypes. `ld` is the padded row stride and `smem` the
// dynamic shared memory in bytes, both computed by the wrapper. Reads Lin,
// writes Lout (distinct buffers). Launches on `stream` of `device`; returns
// the CUDA error code of the set-up calls or of cudaGetLastError() after
// the launch (0 = launched). Does not synchronise.
extern "C" int transport2d_cycle(const float* Lin, float* Lout, const float* G,
                                 const float* W0, const float* W1,
                                 const uint8_t* done, int B, int n0, int n1,
                                 int ld, int n_inner, int threads, int smem,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(transport2d_cycle_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  transport2d_cycle_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      Lin, Lout, G, W0, W1, done, n0, n1, ld, n_inner);
  return (int)cudaGetLastError();
}
