// D D2Q9 BGK timesteps per pass over device memory (D = 2, 4 or 8), on a
// CUDA device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_fused.py::_kernel_fused
// (launched by _pallas_step_fused): temporal blocking, where each block
// loads a window of the lattice, runs D steps on it on chip, and writes
// its tile once, so device-memory bytes per step fall by about D. tot_u
// counts owned cells only, one value per step, so per-step av_vels stay
// exact.
//
// What bounds it: a pass moves the window in (37 B a cell, the window is
// larger than the tile) and the tile out (36 B a cell) for D steps, so
// device memory is no longer the limit. The D stages on shared memory
// are, and what limits them is instruction throughput: ~135 floating-point
// instructions a cell (built with -fmad=false, so no multiply-add fusion:
// every kernel rounds as the plain version does; two IEEE divisions and a
// square root among them) plus loads, stores, index arithmetic and
// branches, which the schedulers start at a rate that needs many warps
// to hide the update's dependent chains. The design spends few
// instructions a cell and keeps many warps resident:
//
// - A block owns a 32 x TY output tile and holds the (32 + 2 HX) x
//   (TY + 2 D) window of all 9 speeds and the mask in dynamic shared
//   memory, loaded with periodic indices (a grid smaller than one window
//   repeats cells, each computed consistently). HX is D rounded up to a
//   multiple of 4, so the tile starts on a 16-byte boundary of a window
//   row and a row is a whole number of groups of V x-neighbours. One
//   block per tile: the hardware hands tiles to SMs as they free up,
//   which spreads the dear tiles (those on the forced line) and lets one
//   block's load overlap its neighbour's stages.
// - One thread per group of V cells of the window (V = 2 in row mode, 4
//   in column mode: the faster in each), fixed for the whole launch: it
//   knows its row offset, its forced-line flags, which of its cells the
//   block owns and where they go in device memory once, not per cell and
//   stage. Threads 0 .. NQ*TY-1 hold the tile's rows in order, the
//   threads behind them the halo rows.
// - Stage s (1..D) reads one buffer and writes the other. A thread loads
//   nine aligned vectors of V floats (each speed from the one row it is
//   pulled from) and the mask as one vector of bytes; the six speeds
//   pulled from x-1 or x+1 need one more float each, a scalar load. It
//   then calls lbm_cell.cuh's update once per cell, reading those
//   registers (the rare forcing guard reads shared memory), with the
//   association a compile-time constant (the kernel switches on it once,
//   so the update's branches on it fold away), and stores nine vectors.
//   A stage needs the window shrunk by s cells a side; the threads
//   compute every group that touches that region, whole, and skip the
//   others. Cells computed outside the region hold values no needed cell
//   of a later stage reads: its region lies one cell further in. Stage
//   D's needed region is the tile, and it stores straight to device
//   memory, as vectors where nx is a multiple of 4.
// - One __syncthreads() a stage. tot_u of a step: each thread adds its
//   owned fluid cells in order, a shuffle butterfly adds the warp, one
//   slot per warp and stage; after the last stage one thread per stage
//   adds the slots in warp order and stores the sum as the tile's partial
//   of that stage, and the block is done. The block that started last
//   waits for the others' partials and adds each stage's in tile order
//   (lbm_reduce.cuh), then writes scale * sum. No float atomics, no
//   second launch, and no fence or ticket at the end of a block (that
//   form cost every block more than the launch it saved).
// - A step's total has the same bits at every stage and at D = 2 and
//   D = 4: both use the 32 x 24 tile and the 40-wide window, so an owned
//   cell sits in the same thread, warp and tile whatever the stage and
//   whichever of the two depths. A run cut into chunks at any even step
//   therefore sums as the uncut run does. D = 8 has its own tile
//   (32 x 16, window 48 x 32).
// - Forcing needs no special case at window edges or in the halo: each
//   thread knows whether its rows (in column mode: its columns, kCols,
//   the lane forcing of _kernel_fused, lbm_tpu/ops/pallas_fused.py:804-813,
//   829-833) are the forced line, and the cell update forces the copies
//   pulled from it at every stage.
// - Seam mode (a shard of a row-sharded lattice, the twin of
//   _kernel_fused(seam=True)): the lattice is the shard's h rows, and the
//   window rows outside them load from D-row halo buffers that the caller
//   filled from the neighbouring shards. Forcing is by global row index at
//   every stage. Tiles in the shard's interior are unchanged.
// - Threads, registers, blocks an SM: in row mode 576 / 640 / 768 threads
//   at D = 2 / 4 / 8 (one per pair of the 40 x 28 / 40 x 32 / 48 x 32
//   window, rounded up to whole warps), in column mode 288 / 320 / 384
//   (one per quad). The two buffers and the mask take 80 / 91 / 110 KB,
//   so two blocks fit an SM's 227 KB, and __launch_bounds__ holds the
//   registers to what two blocks leave: 40 warps an SM in row mode at
//   D = 4 (PERF.md has ptxas' counts and what was tried beside this: four
//   cells a thread everywhere, neighbour floats by shuffle, a persistent
//   grid that prefetches the next window with cp.async, a third buffer).
//
// A tile's window load and stages are lbm_depth.cuh's lbm_depth_tile,
// which the ring (ring.cu) runs too.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/fused_depth.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_depth.cuh"

namespace {

constexpr int kMaxDevices = 64;

// The epilogue's block counter: the word behind the D rows of slots.
template <int D>
__device__ __forceinline__ unsigned int* depth_counter(const Args& a) {
    return reinterpret_cast<unsigned int*>(a.partials +
                                           (size_t)D * a.n_tiles);
}

template <int D, bool kSeam, bool kCols, int kMode>
__device__ __forceinline__ void depth_block(const Args& a, float* buf) {
    // Where this block stands in the order of starting: asked here, read
    // after the stages (lbm_reduce.cuh).
    __shared__ unsigned int entered;
    if (threadIdx.x == 0) entered = lbm_block_enters(depth_counter<D>(a));
    lbm_depth_tile<D, kSeam, kCols, kMode>(a, buf, blockIdx.x, a.partials,
                                           a.n_tiles);
    lbm_last_block_sums<D>(a.partials, a.partials + (size_t)D * a.n_tiles + 1,
                           a.n_tiles, a.scale, a.out, depth_counter<D>(a),
                           entered, a.n_tiles, threadIdx.x);
}

template <int D, bool kSeam, bool kCols>
__global__ void __launch_bounds__(Geo<D, kCellsPerThread<kCols>>::kThreads, 2)
fused_depth_kernel(const Args a) {
    extern __shared__ float4 smem[];
    float* buf = reinterpret_cast<float*>(smem);
    switch (a.mode) {
        case 1: depth_block<D, kSeam, kCols, 1>(a, buf); break;
        case 2: depth_block<D, kSeam, kCols, 2>(a, buf); break;
        default: depth_block<D, kSeam, kCols, 0>(a, buf); break;
    }
}

bool aligned(const void* p, uintptr_t bytes) {
    return ((uintptr_t)p & (bytes - 1)) == 0;
}

template <int D, bool kSeam, bool kCols>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
    // Above 48 KB, dynamic shared memory needs an opt-in, once per device.
    static bool opted_in[kMaxDevices] = {};
    using G = Geo<D, kCellsPerThread<kCols>>;
    const size_t bytes = G::kBytes;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            fused_depth_kernel<D, kSeam, kCols>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
        opted_in[device] = true;
    }
    fused_depth_kernel<D, kSeam, kCols>
        <<<a.n_tiles, G::kThreads, bytes, stream>>>(a);
    return cudaGetLastError();
}

template <int D, bool kSeam>
cudaError_t launch_axis(const Args& a, int axis, int device,
                        cudaStream_t stream) {
    return axis ? launch<D, kSeam, true>(a, device, stream)
                : launch<D, kSeam, false>(a, device, stream);
}

template <bool kSeam>
int launch_depth(Args a, int depth, int axis, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (depth != 2 && depth != 4 && depth != 8) {
        return (int)cudaErrorInvalidValue;
    }
    depth_tiles(depth, a.ny, a.nx, &a.tiles_x, &a.n_tiles);
    if (a.n_tiles < 1) return (int)cudaErrorInvalidValue;
    a.vec = a.nx % 4 == 0 && aligned(a.src, 16) && aligned(a.dst, 16) &&
            aligned(a.mask, 4) &&
            (!kSeam || (aligned(a.halo.s, 16) && aligned(a.halo.n, 16) &&
                        aligned(a.halo.mask_s, 4) &&
                        aligned(a.halo.mask_n, 4)));
    cudaStream_t s = (cudaStream_t)stream;
    switch (depth) {
        case 2: return (int)launch_axis<2, kSeam>(a, axis, device, s);
        case 4: return (int)launch_axis<4, kSeam>(a, axis, device, s);
        default: return (int)launch_axis<8, kSeam>(a, axis, device, s);
    }
}

}  // namespace

extern "C" {

// Tot_u partials per step (one per tile) the depth kernel writes; it
// writes depth rows of them. 0 for a depth it does not take.
int lbm_depth_num_partials(int depth, int ny, int nx) {
    if (depth != 2 && depth != 4 && depth != 8) return 0;
    int tiles_x, n_tiles;
    depth_tiles(depth, ny, nx, &tiles_x, &n_tiles);
    return n_tiles;
}

// Largest ny a launch at this depth accepts: tiles are numbered along one
// grid axis, so only their count bounds a lattice
// (lbm_depth_num_partials returns 0 past it).
int lbm_depth_max_rows(int depth) {
    (void)depth;
    return INT_MAX;
}

// dst = depth steps of src; out[s] = scale * tot_u of step s. partials is
// scratch of 2 * depth * n + 1 32-bit words,
// n = lbm_depth_num_partials(depth, ny, nx): depth * n slots whose bits are
// all ones before the first launch (every launch leaves them so), the
// epilogue's block counter (zero before the first launch, and after every
// launch), and depth * n floats the launch fills:
// partials[depth * n + 1 + s * n + b] = tile b's sum of owned fluid |u| in
// step s. axis 0 forces row accel, axis 1 (a transposed lattice) column
// accel.
int lbm_fused_depth(const float* src, float* dst, const uint8_t* mask,
                    float* partials, int ny, int nx, int accel, float w1,
                    float w2, float omega, int mode, int depth, int axis,
                    float scale, float* out, int device, void* stream) {
    const Halo periodic{nullptr, nullptr, nullptr, nullptr, 0, 0, ny};
    const Args a{src, dst, mask, partials, scale, out, ny, nx, accel,
                 w1, w2, omega, mode, 0, 0, false, periodic};
    return launch_depth<false>(a, depth, axis, device, stream);
}

// Seam mode: dst = depth steps of a shard's h rows src, out-of-shard rows
// from the k-row halos (k >= depth) halo_s / halo_n and their mask rows;
// row0 is the global index of the shard's first row and ny_global the
// global (padded) row count. partials, scale and out as lbm_fused_depth
// with ny = h. axis 1: a shard of the transposed lattice; column nx-2 of
// every row is forced, halo rows included.
int lbm_fused_depth_seam(const float* src, float* dst, const uint8_t* mask,
                         const float* halo_s, const float* halo_n,
                         const uint8_t* hmask_s, const uint8_t* hmask_n,
                         int k, float* partials, int h, int nx, int row0,
                         int ny_global, float w1, float w2, float omega,
                         int mode, int depth, int axis, float scale,
                         float* out, int device, void* stream) {
    if (k < depth || h < 1 || ny_global < h) return (int)cudaErrorInvalidValue;
    const Halo halo{halo_s, halo_n, hmask_s, hmask_n, k, row0, ny_global};
    const int accel = axis ? (nx - 2) % nx : (ny_global - 2) % ny_global;
    const Args a{src, dst, mask, partials, scale, out, h, nx, accel,
                 w1, w2, omega, mode, 0, 0, false, halo};
    return launch_depth<true>(a, depth, axis, device, stream);
}

}  // extern "C"
