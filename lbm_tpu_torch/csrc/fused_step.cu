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
// - tot_u is deterministic: each block of the periodic kernel reduces its
//   fluid |u| in a fixed shared-memory tree into one partial;
//   lbm_reduce_tot, a launch of its own, sums the partials in a fixed order (lbm_reduce.cuh) and writes
//   scale * sum to the device. No float atomics, so repeated runs are
//   bit-identical. (Summing in the kernel's epilogue, as the depth kernel
//   does, was measured slower here in the form that was tried, a
//   ticket behind a fence at the end of each of these short blocks.)
// - Seam mode (fused_step_seam_kernel, the twin of _kernel(seam=True,
//   dynamic_accel=True) on a shard of a row-sharded lattice): rows j-1 of
//   the first row and j+1 of the last come from halo rows wherever they
//   lie, read in place in the neighbouring shards' lattices or in buffers
//   the caller filled (lbm_seam.cuh), and the forced row is found by
//   global row index. Its design, for the shard path, where four or more
//   of these launches make one step and nothing else should:
//   - A block of 32 x 8 threads owns a 32-column tile of kSeamRows * 8
//     rows, a thread kSeamRows cells 8 rows apart (each warp's loads stay
//     128 B rows): one in row mode, two in column mode. Only the blocks whose tile touches the shard's first or
//     last row, or the wrap pad's aliased row, take lbm_seam.cuh's
//     branchy loads; every other block loads from the shard's planes
//     alone (a block-uniform choice between two instantiations).
//   - tot_u is summed inside the launch, as the depth kernel sums it: a
//     thread adds its cells in row order, a warp butterfly adds the warp,
//     thread 0 adds the 8 warps in order and publishes the tile's partial
//     into its slot; the block that started last reads the slots in
//     lbm_reduce.cuh's fixed order (lbm_sum_rows at kReduceWidth) and
//     writes scale * sum. So no second launch follows a seam step. The
//     sum's order is a function of the shard's shape (h, nx) alone: tiles
//     in row-major order of the (ceil(nx / 32), ceil(h / tile rows))
//     grid, cells within a tile as above.
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

// Rows a thread: 1 in row mode, 2 in column mode, the fastest of 1, 2
// and 4 in each (PERF.md): two cells a thread take row mode from 64
// to 78 registers, and so from four blocks an SM to three.
template <bool kCols>
constexpr int kSeamRows = kCols ? 2 : 1;
template <bool kCols>
constexpr int kSeamTileY = kBY * kSeamRows<kCols>;

// kSeamRows cells of column i from row j0 + threadIdx.y on, 8 rows apart;
// their |u| summed in row order.
template <bool kCols, bool kEdge>
__device__ __forceinline__ float seam_tile_cells(
        const SeamView& v, float* __restrict__ dst, int j0, int i, int row0,
        int ny_global, int accel, float w1, float w2, float omega, int mode) {
    const size_t plane = (size_t)v.h * v.nx;
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kSeamRows<kCols>; ++r) {
        const int j = j0 + threadIdx.y + r * kBY;
        if (!kEdge || j < v.h) {
            float out[9];
            acc += lbm_seam_cell<kCols, kEdge>(v, j, i, row0, ny_global,
                                               accel, w1, w2, omega, mode,
                                               out);
            const size_t o = (size_t)j * v.nx + i;
#pragma unroll
            for (int k = 0; k < 9; ++k) dst[k * plane + o] = out[k];
        }
    }
    return acc;
}

// Seam mode: one step of a shard's h rows, row -1 and row h from the halo
// rows (lbm_seam.cuh) instead of a periodic wrap, forcing by the global
// rule, tot_u summed in the launch (see the top of this file). The twin of
// _kernel(seam=True, dynamic_accel=True): JAX's i8 accel mask and ACC_CH
// channel are replaced by the global-row rule.
template <bool kCols>
__global__ void __launch_bounds__(kThreads)
fused_step_seam_kernel(const SeamView v, float* __restrict__ dst,
                       float* __restrict__ scratch, float* __restrict__ out,
                       float scale, int row0, int ny_global, int accel,
                       float w1, float w2, float omega, int mode) {
    __shared__ unsigned int entered;
    __shared__ float warp_tot[kThreads / 32];
    const int n = gridDim.x * gridDim.y;
    unsigned int* counter = reinterpret_cast<unsigned int*>(scratch + n);
    const int tid = threadIdx.y * kBX + threadIdx.x;
    if (tid == 0) entered = lbm_block_enters(counter);
    const int i = blockIdx.x * kBX + threadIdx.x;
    constexpr int kTileY = kSeamTileY<kCols>;
    const int j0 = blockIdx.y * kTileY;
    // Rows j0 - 1 .. j0 + kTileY are read.
    const bool edge = j0 == 0 || j0 + kTileY >= v.h ||
                      (v.wrap_row >= j0 - 1 && v.wrap_row <= j0 + kTileY);
    float umag = 0.0f;
    if (i < v.nx) {
        umag = edge ? seam_tile_cells<kCols, true>(v, dst, j0, i, row0,
                                                   ny_global, accel, w1, w2,
                                                   omega, mode)
                    : seam_tile_cells<kCols, false>(v, dst, j0, i, row0,
                                                    ny_global, accel, w1, w2,
                                                    omega, mode);
    }
    umag = lbm_warp_sum(umag);
    if ((tid & 31) == 0) warp_tot[tid >> 5] = umag;
    __syncthreads();
    if (tid == 0) {
        float tile = 0.0f;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) tile += warp_tot[w];
        lbm_publish_partial(scratch + blockIdx.y * gridDim.x + blockIdx.x,
                            tile);
    }
    lbm_last_block_sums<1>(scratch, scratch + n + 1, n, scale, out, counter,
                           entered, n, tid);
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

dim3 seam_grid(int h, int nx, int axis) {
    const int ty = axis ? kSeamTileY<true> : kSeamTileY<false>;
    return dim3((nx + kBX - 1) / kBX, (h + ty - 1) / ty);
}

}  // namespace

// The launch's arguments as the host hands them over (one struct, built
// once per buffer pairing, so a launch converts three arguments). scratch
// holds n slots (kNoPartial between launches), the block counter (zero
// between launches) and the n partials as the last block read them.
struct SeamStepArgs {
    const float* src;
    float* dst;
    const uint8_t* mask;
    const float* halo_s;
    const float* halo_n;
    const uint8_t* hmask_s;
    const uint8_t* hmask_n;
    float* scratch;
    float* out;
    long long plane_s, plane_n;
    float scale, w1, w2, omega;
    int h, nx, row0, ny_global, wrap_row, mode, axis;
};

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

// Tiles of the seam kernel on an h x nx shard (axis 1: column mode): its
// tot_u slots.
int lbm_seam_num_partials(int h, int nx, int axis) {
    const dim3 g = seam_grid(h, nx, axis);
    return (int)(g.x * g.y);
}

// Largest h the seam kernel accepts (the grid's y dimension).
int lbm_seam_max_rows(int axis) {
    return 65535 * (axis ? kSeamTileY<true> : kSeamTileY<false>);
}

// Seam mode: a->dst = one step of a shard's h rows a->src, row -1 from
// a->halo_s (speed q at q * plane_s) and row h from a->halo_n, their
// obstacle rows hmask_s / hmask_n; row0 is the global index of the
// shard's first row and ny_global the global (padded) row count; row
// wrap_row (or -1) reads its speeds from row -1. a->out[t] = scale *
// tot_u, summed in the launch in a->scratch (lbm_seam_num_partials(h, nx)
// slots, the counter, as many kept partials). axis 1: a shard of the
// transposed lattice; column nx-2 of every row is forced, and row0 /
// ny_global only bound the shard.
int lbm_fused_step_seam(const SeamStepArgs* a, int t, int device,
                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (a->h < 1 || a->ny_global < a->h || a->wrap_row >= a->h)
        return (int)cudaErrorInvalidValue;
    const SeamView v{a->src, a->mask, a->halo_s, a->halo_n, a->hmask_s,
                     a->hmask_n, a->plane_s, a->plane_n, a->h, a->nx,
                     a->wrap_row};
    const dim3 grid = seam_grid(a->h, a->nx, a->axis), block(kBX, kBY);
    cudaStream_t s = (cudaStream_t)stream;
    if (a->axis) {
        fused_step_seam_kernel<true><<<grid, block, 0, s>>>(
            v, a->dst, a->scratch, a->out + t, a->scale, a->row0,
            a->ny_global, (a->nx - 2) % a->nx, a->w1, a->w2, a->omega,
            a->mode);
    } else {
        fused_step_seam_kernel<false><<<grid, block, 0, s>>>(
            v, a->dst, a->scratch, a->out + t, a->scale, a->row0,
            a->ny_global, (a->ny_global - 2) % a->ny_global, a->w1, a->w2,
            a->omega, a->mode);
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
