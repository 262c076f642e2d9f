// K3: one full 2-D eikonal sweep cycle over a batch of fields, for sm_90a.
//
// Replaces the Pallas TPU kernel `_sweep2d_axis0_kernel` / `_sweep2d_axis0`
// (mceik_tpu/eikonal/pallas_sweep.py:849, :890) as
// `sweep_solve_pallas_2d_lanebatched` (:907) drives it: the row march, then
// the same kernel on the transposed batch with the spacing swapped for the
// column march. It computes the plain reference `sweep_cycle_plain` on a
// (B, n0, n1) batch (mceik_tpu_torch/eikonal/solve.py) operation for
// operation: for axis 0 and then axis 1, march the lines low -> high and
// then high -> low; each line takes a_ax = min(prev, next) (prev the line
// just updated, edges read BIG) and then n_inner Jacobi steps along the line
// T = max(min(T, local_solve(a_ax, a_line)), floor), a_line the minimum of
// the two line neighbours (edges read BIG).
//
// Design. A 2-D field fits in shared memory whole: T, s and floor take
// 3 * n0 * ld * 4 bytes (ld = n1 rounded up to an odd stride), 28.2 KB at
// 48^2 and 50.7 KB at 65^2, so one CTA owns one field and loads it once,
// runs the cycle on shared memory and writes T once. One thread owns one
// node position of a line (threads = the longest line rounded up to whole
// warps): a row of the axis-0 march, a column of the axis-1 march. The
// thread keeps its node in a register across a march, so a_ax needs no
// barrier (prev is its own register, next is a node no thread has written
// in this march). The Jacobi steps exchange line neighbours through two
// line buffers in shared memory with one block barrier per step; the last
// step writes the node back into the field in place. The odd row stride
// makes the column march's strided accesses hit 32 distinct banks, so the
// axis swap needs no transpose. Done fields are copied through.
//
// What bounds it. Each field is a dependent chain of 2 (n0 + n1) n_inner
// barriered line steps per cycle (4 n0 n_inner on a square grid, 384 at
// 48^2), each a few shared-memory loads and ~30 flops: latency and barriers
// per CTA, not bytes (a 48^2 field moves 37 KB per cycle). Throughput comes
// from CTAs in flight: up to 8 per SM at 48^2 (shared memory), so config
// 4's 80,000 fields fill the 132 SMs many times over, while config 1's 32
// fields leave most SMs idle. Several fields per CTA and a warp per line
// with shuffles in place of barriers are later work.
//
// Left out as TPU workarounds: the (n0, n1, B) lane layout and its
// transposes, the VMEM chunk gate and padding, and the `i >= 1` spelling.
//
// Arithmetic matches mceik_tpu_torch/eikonal/godunov.py (the 2-D branches)
// in operation order; build with --fmad=false so that no product is
// contracted into an FMA the reference does not have, and sqrtf/division
// are the IEEE ones (no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e10f;
constexpr float kDiscFloor = 1e-12f;

struct Sweep2dConsts {
  float h[2];   // spacing per grid axis
  float hh[2];  // h*h, rounded once from double (as torch's h*h scalar)
  float w[2];   // 1/(h*h), rounded once from double
  int iso;      // equal spacings -> closed form (godunov.py's choice)
  int n_inner;
};

__device__ __forceinline__ float sqrt_floored(float x) {
  return sqrtf(fmaxf(x, kDiscFloor));
}

// godunov.local_solve, D = 2: a_ax along the swept axis, a_ln along the
// line; h, hh and w_ax belong to the swept axis, w_ln to the line's.
__device__ __forceinline__ float local2(float a_ax, float a_ln, float s,
                                        bool iso, float h, float hh,
                                        float w_ax, float w_ln) {
  if (iso) {  // godunov._local_solve_iso, two neighbours
    const float s2h2 = (s * s) * hh;
    const float a1 = fminf(a_ax, a_ln), a2 = fmaxf(a_ax, a_ln);
    const float t1 = a1 + s * h;
    const float d12 = a1 - a2;
    const float t2 = 0.5f * ((a1 + a2) + sqrt_floored(2.0f * s2h2 - d12 * d12));
    return t1 <= a2 ? t1 : t2;
  }
  float a1 = a_ax, a2 = a_ln, w1 = w_ax, w2 = w_ln;
  if (a2 < a1) {
    float t = a1; a1 = a2; a2 = t;
    t = w1; w1 = w2; w2 = t;
  }
  const float s2 = s * s;
  const float t1 = a1 + s * sqrtf(1.0f / w1);
  const float A2 = w1 + w2;
  const float B2 = w1 * a1 + w2 * a2;
  const float d12 = a1 - a2;
  const float disc2 = A2 * s2 - w1 * w2 * (d12 * d12);
  const float t2 = (B2 + sqrt_floored(disc2)) / A2;
  return t1 <= a2 ? t1 : t2;
}

// One CTA per field; blockDim.x >= max(n0, n1). Shared memory: T, s and
// floor with row stride ld, then two line buffers of blockDim.x floats.
__global__ void __launch_bounds__(1024)
sweep2d_cycle_kernel(const float* __restrict__ Tin, float* __restrict__ Tout,
                     const float* __restrict__ S, const float* __restrict__ F,
                     const uint8_t* __restrict__ done, int n0, int n1, int ld,
                     Sweep2dConsts c) {
  const int64_t field = (int64_t)n0 * n1;
  const int64_t base = blockIdx.x * field;
  Tin += base;
  Tout += base;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nodes = n0 * n1;
  if (done[blockIdx.x]) {  // uniform per CTA: no barrier is skipped by half
    for (int m = tid; m < nodes; m += nthr) Tout[m] = Tin[m];
    return;
  }
  S += base;
  F += base;

  extern __shared__ float smem[];
  const int padded = n0 * ld;
  float* sT = smem;
  float* sS = smem + padded;
  float* sF = smem + 2 * padded;
  float* lb0 = smem + 3 * padded;  // line buffers, alternating by step
  float* lb1 = lb0 + nthr;
  for (int m = tid; m < nodes; m += nthr) {
    const int i = m / n1, j = m - i * n1;
    sT[i * ld + j] = Tin[m];
    sS[i * ld + j] = S[m];
    sF[i * ld + j] = F[m];
  }
  __syncthreads();

  for (int ax = 0; ax < 2; ++ax) {
    // Axis 0 marches the rows (line k = row k, node t at (k, t)); axis 1
    // the columns (line k = column k, node t at (t, k)).
    const int n_lines = ax == 0 ? n0 : n1;
    const int len = ax == 0 ? n1 : n0;
    const int line_stride = ax == 0 ? ld : 1;
    const int node_stride = ax == 0 ? 1 : ld;
    const bool active = tid < len;
    const bool iso = c.iso;
    const float h = c.h[ax], hh = c.hh[ax], w_ax = c.w[ax], w_ln = c.w[1 - ax];
    for (int dir = 0; dir < 2; ++dir) {
      float prev = kBig;  // the line just updated, at this thread's node
      for (int k = 0; k < n_lines; ++k) {
        const int line = dir == 0 ? k : n_lines - 1 - k;
        const int next = dir == 0 ? line + 1 : line - 1;
        const int off = line * line_stride + tid * node_stride;
        float Tp = 0.0f, s = 0.0f, f = 0.0f, a_ax = 0.0f;
        if (active) {
          const float nx = (next >= 0 && next < n_lines)
                               ? sT[next * line_stride + tid * node_stride]
                               : kBig;
          a_ax = fminf(prev, nx);
          Tp = sT[off];
          s = sS[off];
          f = sF[off];
        }
        // Step 0 reads the line's neighbours in the field, later steps the
        // previous step's line buffer.
        const float* src = sT + line * line_stride;
        int src_stride = node_stride;
        for (int it = 0; it < c.n_inner; ++it) {
          if (active) {
            const float up = tid + 1 < len ? src[(tid + 1) * src_stride] : kBig;
            const float dn = tid > 0 ? src[(tid - 1) * src_stride] : kBig;
            const float t = local2(a_ax, fminf(up, dn), s, iso, h, hh, w_ax,
                                   w_ln);
            Tp = fmaxf(fminf(Tp, t), f);
          }
          float* dst = (it & 1) ? lb1 : lb0;
          if (it + 1 < c.n_inner) {
            if (active) dst[tid] = Tp;
          } else {
            // The last step writes the node in place; with one step, its
            // own neighbour reads came from the field, so wait for them.
            if (it == 0) __syncthreads();
            if (active) sT[off] = Tp;
          }
          __syncthreads();
          src = dst;
          src_stride = 1;
        }
        prev = Tp;
      }
    }
  }

  for (int m = tid; m < nodes; m += nthr) {
    const int i = m / n1, j = m - i * n1;
    Tout[m] = sT[i * ld + j];
  }
}

}  // namespace

// C entry, loaded with ctypes. `consts` is a host array of 6 floats
// (h[2], hh[2], w[2]); `ld` the padded row stride and `smem` the dynamic
// shared memory in bytes, both computed by the wrapper. Reads Tin, writes
// Tout (distinct buffers). Launches on `stream` of `device`; returns the
// CUDA error code of the set-up calls or of cudaGetLastError() after the
// launch (0 = launched). Does not synchronise.
extern "C" int sweep2d_cycle(const float* Tin, float* Tout, const float* S,
                             const float* F, const uint8_t* done, int B,
                             int n0, int n1, int ld, const float* consts,
                             int iso, int n_inner, int threads, int smem,
                             int device, void* stream) {
  Sweep2dConsts c;
  for (int d = 0; d < 2; ++d) {
    c.h[d] = consts[d];
    c.hh[d] = consts[2 + d];
    c.w[d] = consts[4 + d];
  }
  c.iso = iso;
  c.n_inner = n_inner;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sweep2d_cycle_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep2d_cycle_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      Tin, Tout, S, F, done, n0, n1, ld, c);
  return (int)cudaGetLastError();
}
