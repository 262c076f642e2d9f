// K4 and K5: one full 3-D adjoint transport sweep cycle over a batch of
// fields, for sm_90a. K4 stages the in-plane weights in shared memory; K5,
// for cross-sections K4's planes cannot hold, reads them from global memory.
//
// Replaces the Pallas TPU kernel `_transport_axis0_kernel` /
// `transport_axis0` (mceik_tpu/eikonal/pallas_transport.py:61, :132), which
// `transport_solve_pallas_packed` drives once per axis per cycle. It
// computes the plain reference `transport_cycle_plain`
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
// (the reference's `out += lo; out += hi` per dim). Past an edge nothing
// is read: unlike the monotone forward update, a self-read would corrupt
// this linear system, so the guards are exact index tests.
//
// Design, as K1 (csrc/sweep3d.cu). One CTA owns one field (128 fields of
// 64^3 on 132 SMs) and walks the whole cycle: the plane march is
// sequential. Shared memory holds five plane buffers: base, the lam plane
// double-buffered for the Jacobi steps, and the plane's two in-plane weight
// planes, which every Jacobi step reads at the neighbours (five 16 KB
// planes at 64^2, 80 KB). __syncthreads() separates micro-iterations and
// planes; lam is updated in place in global memory, and the next plane
// reads its upstream neighbour from there (visible to the CTA after the
// barrier). A field with its done flag set is skipped. The TPU kernel's
// lane packing, seam masks and `i >= 1` guard spelling are Mosaic
// workarounds and have no counterpart here.
//
// K5 is the same kernel with kStageWeights = false, for the blocked
// big-field route of the TPU kernel: `transport_solve_pallas_blocked`
// (pallas_transport.py:216) through `_transport_block_pass` (:181) and
// `_transport_block_cycle` (:164), which every gradient of a 128^3 field
// takes (config 5). The TPU splits axis 0 into blocks with halo planes and
// pinned rows because its VMEM holds 2 MB; here one CTA marches the whole
// field, so the fixed point is the unblocked one, and the blocks, halos and
// pins have no counterpart. Five planes at 128^2 are 320 KB, above the
// 227 KB a block may use; K5 keeps three (base and lam double-buffered,
// 192 KB at 128^2: one CTA of 1024 threads per SM, 16 nodes per thread) and
// reads wp and wq through the read-only path at every Jacobi step, at the
// plane's node at that in-plane offset (global o +- sp, o +- sq, not the
// shared index m +- nq, m +- 1). Three planes cap the cross-section at
// 232,448 / 12 = 19,370 nodes (139^2); a larger one needs a
// thread-block-cluster design (distributed shared memory), later work. The
// two routes share every operation, so they are bit-identical.
//
// What bounds it. Per plane visit the CTA loads g, the two axial
// neighbours of lam and of w_ax, lam itself and two weight planes (seven
// plane reads, one store) and crosses n_inner + 2 barriers; the Jacobi
// step is ~12 flops per node (K5 adds four weight loads per node and step
// from L1/L2). Like K1 it is bound by global-load latency and barriers,
// and its axis-2 sweep (planes strided by nz floats) does not coalesce.
// Speed is later work.
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

// An in-plane weight at shared index m (K4) or global offset o (K5).
template <bool kStageWeights>
__device__ __forceinline__ float weight(const float* staged, int m,
                                        const float* __restrict__ global,
                                        int64_t o) {
  return kStageWeights ? staged[m] : __ldg(global + o);
}

// lam is read and written by the CTA (no __restrict__/read-only path: later
// plane visits must see earlier stores of the same CTA).
template <bool kStageWeights>
__global__ void __launch_bounds__(1024)
transport3d_cycle_kernel(float* lam, const float* __restrict__ G,
                         const float* __restrict__ W0,
                         const float* __restrict__ W1,
                         const float* __restrict__ W2,
                         const uint8_t* __restrict__ done, int n0, int n1,
                         int n2, int n_inner) {
  const int b = blockIdx.x;
  if (done[b]) return;  // uniform per CTA: no barrier is skipped by half
  const int64_t field = (int64_t)n0 * n1 * n2;
  lam += b * field;
  G += b * field;
  const float* W[3] = {W0 + b * field, W1 + b * field, W2 + b * field};

  extern __shared__ float smem[];
  const int n[3] = {n0, n1, n2};
  const int64_t stride[3] = {(int64_t)n1 * n2, n2, 1};
  const int max_plane = max(n1 * n2, max(n0 * n2, n0 * n1));
  float* base = smem;
  float* buf_a = smem + max_plane;
  float* buf_b = smem + 2 * max_plane;
  float* wp = smem + 3 * max_plane;  // K4 only
  float* wq = smem + 4 * max_plane;
  const int tid = threadIdx.x, nthr = blockDim.x;

  for (int ax = 0; ax < 3; ++ax) {
    // Plane axes in grid order, as the reference's moveaxis layout.
    const int p = ax == 0 ? 1 : 0;
    const int q = ax == 2 ? 1 : 2;
    const int np_ = n[p], nq = n[q], nax = n[ax];
    const int plane = np_ * nq;
    const int64_t sa = stride[ax], sp = stride[p], sq = stride[q];
    const float* Wax = W[ax];
    const float* Wp = W[p];
    const float* Wq = W[q];

    for (int dir = 0; dir < 2; ++dir) {
      const int step = dir == 0 ? 1 : -1;
      const int first = dir == 0 ? 0 : nax - 1;
      for (int k = 0; k < nax; ++k) {
        const int i = first + step * k;
        const int64_t off_i = i * sa;
        const bool has_prev = i > 0, has_next = i + 1 < nax;
        float* cur = buf_a;
        float* nxt = buf_b;
        for (int m = tid; m < plane; m += nthr) {
          const int ip = m / nq, iq = m - ip * nq;
          const int64_t o = off_i + ip * sp + iq * sq;
          float axial = 0.0f;
          if (has_prev && has_next) {
            const float fp = neg(Wax[o - sa]) * lam[o - sa];
            const float fn = pos(Wax[o + sa]) * lam[o + sa];
            axial = fp + fn;
          } else if (has_prev) {
            axial = neg(Wax[o - sa]) * lam[o - sa];
          } else if (has_next) {
            axial = pos(Wax[o + sa]) * lam[o + sa];
          }
          base[m] = G[o] + axial;
          cur[m] = lam[o];
          if (kStageWeights) {
            wp[m] = Wp[o];
            wq[m] = Wq[o];
          }
        }
        __syncthreads();
        for (int it = 0; it < n_inner; ++it) {
          for (int m = tid; m < plane; m += nthr) {
            const int ip = m / nq, iq = m - ip * nq;
            const int64_t o = off_i + ip * sp + iq * sq;
            constexpr bool S = kStageWeights;
            float acc = ip + 1 < np_
                ? pos(weight<S>(wp, m + nq, Wp, o + sp)) * cur[m + nq] : 0.0f;
            acc = acc + (ip > 0
                ? neg(weight<S>(wp, m - nq, Wp, o - sp)) * cur[m - nq] : 0.0f);
            acc = acc + (iq + 1 < nq
                ? pos(weight<S>(wq, m + 1, Wq, o + sq)) * cur[m + 1] : 0.0f);
            acc = acc + (iq > 0
                ? neg(weight<S>(wq, m - 1, Wq, o - sq)) * cur[m - 1] : 0.0f);
            nxt[m] = base[m] + acc;
          }
          __syncthreads();
          float* tmp = cur; cur = nxt; nxt = tmp;
        }
        for (int m = tid; m < plane; m += nthr) {
          const int ip = m / nq, iq = m - ip * nq;
          lam[off_i + ip * sp + iq * sq] = cur[m];
        }
        // The next plane reads this one from global memory, and its loads
        // overwrite base, cur and (K4) the weight planes.
        __syncthreads();
      }
    }
  }
}

template <bool kStageWeights>
int launch(float* lam, const float* G, const float* W0, const float* W1,
           const float* W2, const uint8_t* done, int B, int n0, int n1,
           int n2, int n_inner, int threads, int device, void* stream) {
  int max_plane = n1 * n2;
  if (n0 * n2 > max_plane) max_plane = n0 * n2;
  if (n0 * n1 > max_plane) max_plane = n0 * n1;
  const int n_planes = kStageWeights ? 5 : 3;
  const size_t smem = n_planes * (size_t)max_plane * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(transport3d_cycle_kernel<kStageWeights>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  transport3d_cycle_kernel<kStageWeights>
      <<<B, threads, smem, (cudaStream_t)stream>>>(lam, G, W0, W1, W2, done,
                                                   n0, n1, n2, n_inner);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, loaded with ctypes: K4 (five planes in shared memory) and K5
// (three). Each launches on `stream` of `device` and returns the CUDA error
// code of the set-up calls or of cudaGetLastError() after the launch
// (0 = launched). Neither synchronises.
extern "C" int transport3d_cycle(float* lam, const float* G, const float* W0,
                                 const float* W1, const float* W2,
                                 const uint8_t* done, int B, int n0, int n1,
                                 int n2, int n_inner, int threads, int device,
                                 void* stream) {
  return launch<true>(lam, G, W0, W1, W2, done, B, n0, n1, n2, n_inner,
                      threads, device, stream);
}

extern "C" int transport3d_large_cycle(float* lam, const float* G,
                                       const float* W0, const float* W1,
                                       const float* W2, const uint8_t* done,
                                       int B, int n0, int n1, int n2,
                                       int n_inner, int threads, int device,
                                       void* stream) {
  return launch<false>(lam, G, W0, W1, W2, done, B, n0, n1, n2, n_inner,
                       threads, device, stream);
}
