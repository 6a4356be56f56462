// One D2Q9 BGK lattice-Boltzmann timestep on a CUDA device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_fused.py::_kernel (launched by
// _pallas_step in the CarryStep role): guarded forcing of row ny-2, periodic
// pull streaming, bounce-back, BGK relaxation and tot_u = sum |u| over fluid
// cells, all in one pass over a planar (9, ny, nx) float32 state.
//
// What bounds it: per cell-step the kernel reads 9 floats and the mask byte
// and writes 9 floats, 73 B, for ~130 flops: it is memory-bound on this card
// by a wide margin. The design moves nothing but those bytes:
//
// - One thread per cell, a 32x8 block with x fastest, so each speed's loads
//   and stores are coalesced 128 B rows (the pull shift moves a row by at
//   most one element). Periodic wrap is a modulo index per load; the TPU
//   kernel's edge-row arrays, DMA double-buffering and 0/1-indicator
//   products exist for its tiles and sequential grid and are not carried
//   over. Neighbouring blocks' rows are re-read through L1/L2, not HBM.
// - The cell update is lbm_cell.cuh's, shared with the many-step kernels:
//   forcing on the pulled copy (only destination rows ny-3..ny-1 take the
//   branch), bounce-back, and BGK in the association given at run time
//   (0 paired, 1 reference order, 2 omega-absorbed). Built without
//   --use_fast_math (division and sqrt stay IEEE) and with -fmad=false
//   (no multiply-add contraction), so every kernel rounds each cell as
//   the plain PyTorch version does.
// - tot_u is deterministic: each block reduces its fluid |u| in a fixed
//   shared-memory tree into one partial; lbm_reduce_tot, a launch of its
//   own, sums the partials in a fixed order (lbm_reduce.cuh) and writes
//   scale * sum to the device. No float atomics, so repeated runs are
//   bit-identical. (Summing in the kernel's epilogue, as the depth kernel
//   does, was measured slower here in the form that was tried, a
//   ticket behind a fence at the end of each of these short blocks.)
// - Seam mode (fused_step_seam_kernel, the twin of _kernel(seam=True,
//   dynamic_accel=True) on a shard of a row-sharded lattice): rows j-1 of
//   the first row and j+1 of the last come from halo buffers the caller
//   filled from the neighbouring shards (lbm_seam.cuh), and the forced row
//   is found by global row index.
// - Column mode (kCols, the transposed lattice of a wide grid: _kernel with
//   AccelSpec.lanes, lbm_tpu/ops/pallas_fused.py:358-374): the forced line
//   is the column accel of every row (lbm_cell.cuh), in the periodic and
//   in the seam kernel, where no row is forced by its index. Only the
//   warps holding columns accel-1..accel+1 take the forcing branch.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/fused.py. Every
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_reduce.cuh"
#include "lbm_seam.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;
// Width of the tot_u sum behind a one-step launch: its partials are many
// (one per 32 x 8 block), so the sum takes a whole block of lanes.
constexpr int kStepReduceWidth = 1024;

template <bool kCols>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ partials, int ny, int nx, int accel,
                  float w1, float w2, float omega, int mode) {
    __shared__ float red[kThreads];
    const int i = blockIdx.x * kBX + threadIdx.x;
    const int j = blockIdx.y * kBY + threadIdx.y;
    const int tid = threadIdx.y * kBX + threadIdx.x;
    float umag = 0.0f;

    if (i < nx && j < ny) {
        const size_t plane = (size_t)ny * (size_t)nx;
        // Source rows/columns of the pull: speed k reads
        // ((j - cy[k]) mod ny, (i - cx[k]) mod nx).
        const int jm = (j == 0) ? ny - 1 : j - 1;   // cy = +1
        const int jp = (j == ny - 1) ? 0 : j + 1;   // cy = -1
        const int iw = (i == 0) ? nx - 1 : i - 1;   // cx = +1
        const int ie = (i == nx - 1) ? 0 : i + 1;   // cx = -1
        const size_t rj = (size_t)j * nx, rm = (size_t)jm * nx,
                     rp = (size_t)jp * nx;
        auto ld = [&](int k, size_t o) { return src[k * plane + o]; };
        auto solid = [&](size_t o) { return mask[o] != 0; };
        float out[9];
        // The forced line: row accel, or in column mode column accel.
        const bool f0 = kCols ? i == accel : j == accel;
        const bool f1 = kCols ? iw == accel : jm == accel;
        const bool f2 = kCols ? ie == accel : jp == accel;
        umag = lbm_cell_update<kCols, size_t>(
            ld, solid, rj, rm, rp, (size_t)i, (size_t)iw, (size_t)ie, f0, f1,
            f2, w1, w2, omega, mode, out);
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = out[k];
    }

    red[tid] = umag;
    lbm_tree_sum<kThreads>(red, tid);
    if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// Seam mode: one step of a shard's h rows, row -1 and row h from the halo
// buffers (lbm_seam.cuh) instead of a periodic wrap, forcing by the global
// rule. The same grid, cell code and partials as the periodic kernel. The
// twin of _kernel(seam=True, dynamic_accel=True): JAX's i8 accel mask and
// ACC_CH channel are replaced by the global-row rule.
template <bool kCols>
__global__ void __launch_bounds__(kThreads)
fused_step_seam_kernel(SeamView v, float* __restrict__ dst,
                       float* __restrict__ partials, int row0, int ny_global,
                       int accel, float w1, float w2, float omega, int mode) {
    __shared__ float red[kThreads];
    const int i = blockIdx.x * kBX + threadIdx.x;
    const int j = blockIdx.y * kBY + threadIdx.y;
    const int tid = threadIdx.y * kBX + threadIdx.x;
    float umag = 0.0f;
    if (i < v.nx && j < v.h) {
        float out[9];
        umag = lbm_seam_cell<kCols>(v, j, i, row0, ny_global, accel, w1,
                                    w2, omega, mode, out);
        const size_t plane = (size_t)v.h * v.nx, o = (size_t)j * v.nx + i;
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k * plane + o] = out[k];
    }
    red[tid] = umag;
    lbm_tree_sum<kThreads>(red, tid);
    if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// out[0] = scale * sum(partials[0:n]), in lbm_reduce.cuh's fixed order at
// width kStepReduceWidth, by one block.
__global__ void __launch_bounds__(kStepReduceWidth)
reduce_tot_kernel(const float* __restrict__ partials, int n, float scale,
                  float* __restrict__ out) {
    lbm_sum_rows<1, kStepReduceWidth>(const_cast<float*>(partials), nullptr,
                                      n, scale, out, threadIdx.x);
}

dim3 step_grid(int ny, int nx) {
    return dim3((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
}

}  // namespace

extern "C" {

// Number of tot_u partials (one per block) the step kernel writes.
int lbm_num_partials(int ny, int nx) {
    const dim3 g = step_grid(ny, nx);
    return (int)(g.x * g.y);
}

// Largest ny a launch accepts (the grid's y dimension is at most 65535).
int lbm_max_rows(void) { return 65535 * kBY; }

const char* lbm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// dst = one step of src; partials[b] = block b's sum of fluid |u|. axis 0
// forces row accel, axis 1 (a transposed lattice) column accel.
int lbm_fused_step(const float* src, float* dst, const uint8_t* mask,
                   float* partials, int ny, int nx, int accel, float w1,
                   float w2, float omega, int mode, int axis, int device,
                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid = step_grid(ny, nx), block(kBX, kBY);
    cudaStream_t s = (cudaStream_t)stream;
    if (axis) {
        fused_step_kernel<true><<<grid, block, 0, s>>>(
            src, dst, mask, partials, ny, nx, accel, w1, w2, omega, mode);
    } else {
        fused_step_kernel<false><<<grid, block, 0, s>>>(
            src, dst, mask, partials, ny, nx, accel, w1, w2, omega, mode);
    }
    return (int)cudaGetLastError();
}

// Seam mode: dst = one step of a shard's h rows src, with k-row halos
// halo_s / halo_n ((9, k, nx)) and their mask rows; row0 is the global
// index of the shard's first row and ny_global the global (padded) row
// count. partials as lbm_fused_step (lbm_num_partials(h, nx) of them).
// axis 1: a shard of the transposed lattice; column nx-2 of every row is
// forced, and row0 / ny_global only bound the shard.
int lbm_fused_step_seam(const float* src, float* dst, const uint8_t* mask,
                        const float* halo_s, const float* halo_n,
                        const uint8_t* hmask_s, const uint8_t* hmask_n, int k,
                        float* partials, int h, int nx, int row0,
                        int ny_global, float w1, float w2, float omega,
                        int mode, int axis, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (k < 1 || h < 1 || ny_global < h) return (int)cudaErrorInvalidValue;
    const SeamView v{src, mask, halo_s, halo_n, hmask_s, hmask_n, h, nx, k};
    const dim3 grid = step_grid(h, nx), block(kBX, kBY);
    cudaStream_t s = (cudaStream_t)stream;
    if (axis) {
        fused_step_seam_kernel<true><<<grid, block, 0, s>>>(
            v, dst, partials, row0, ny_global, (nx - 2) % nx, w1, w2, omega,
            mode);
    } else {
        fused_step_seam_kernel<false><<<grid, block, 0, s>>>(
            v, dst, partials, row0, ny_global, (ny_global - 2) % ny_global, w1,
            w2, omega, mode);
    }
    return (int)cudaGetLastError();
}

// out[0] = scale * sum(partials[0:n]), summed in a fixed order: the
// one-step kernel's second launch.
int lbm_reduce_tot(const float* partials, int n, float scale, float* out,
                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidValue;
    reduce_tot_kernel<<<1, kStepReduceWidth, 0, (cudaStream_t)stream>>>(
        partials, n, scale, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
