// G D2Q9 BGK timesteps per launch in one persistent kernel with the lattice
// in device memory, on a CUDA device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_resident.py::_kernel_resident
// (launched by _pallas_resident): G whole timesteps per call, ping-ponging
// between two lattice buffers, with a (G,) vector of per-step tot_u. On the
// TPU the lattice lives in VMEM for the whole call. The H100 has nothing on
// chip that large (50 MB of L2; 1024x1024 is 37.7 MB a buffer); where a
// block's strip of rows fits its shared memory, resident_onchip.cu holds
// it there. This is the form for every other lattice: the two buffers stay
// in device memory (L2 keeps what fits).
//
// What bounds it: a form that stepped the lattice in device memory once a
// step paid a pass over both buffers every step (73 B a cell, 1.35x its
// ceiling of one pass a step at 1024x1024: the form this replaces,
// PERF.md). This one steps up to 4 at a time in shared memory, as the
// depth kernel does (fused_depth.cu, lbm_depth.cuh), so the lattice
// crosses device memory once a round and what is left is the depth
// kernel's stage loop, issue-bound, plus one grid barrier a round. The
// design (each choice measured against the others named, PERF.md):
//
// - One cooperative launch of depth-kernel blocks: the (TY + 2D) x (32 +
//   2 HX) window of all nine speeds and the mask in dynamic shared memory,
//   one thread a group of V cells, sized for D = 4, two blocks an SM, as
//   many as can be co-resident and at most one a tile.
// - Rounds of 4, 2 and 1 steps (ops/resident.py: device_rounds): as many
//   of 4 as fit, and the count of rounds has G's parity, so the result is
//   in a after an even G and in b after an odd one, as the on-chip form
//   leaves it (G = 100: 24 rounds of 4, then 2 of 2). Round k reads a
//   when k is even and b when odd and writes the other, through
//   lbm_depth_tile, the periodic depth launch's own tile (windows wrap
//   modulo the lattice). The three depths share the 32 x 24 tile and the
//   40-wide window, so an owned cell sits in the same thread, warp and tile
//   at every depth. After the round, one grid barrier (cooperative groups'
//   grid sync; a counter-and-generation barrier was as fast or slower).
// - The tiles of a round of 4 are inlined into the round loop, with the
//   round's arguments in the kernel's __grid_constant__ parameters, so the
//   stage loop reads them as constant-bank operands and keeps its
//   registers (in row mode one copy of the round for each parity; a tile
//   that is a call of its own, or reads its arguments from shared memory,
//   lost 19-43 %). The rounds of 2 and 1 are calls of their own, and each
//   association has a kernel of its own.
// - Each block draws its tiles by ticket, one atomicAdd a tile, the next
//   drawn while the current one runs: the tiles on the forced line and the
//   obstacles cost more, and a fixed stride left blocks waiting at the
//   barrier (in column mode the forced column's tiles bunch on the blocks
//   a stride of 4 tile columns gives them; with the ticket a block count
//   coprime with the tile columns gains nothing).
// - Per-step tot_u: each (step, tile) gets the partial the periodic depth
//   kernel gives it (the same thread, warp and tile map); after the last
//   barrier the blocks sum each step's partials in tile order
//   (lbm_reduce.cuh's lbm_sum_rows, as the depth kernel's epilogue does),
//   so a step's tot has the bits of the depth plan's. No float atomics.
// - Coherence: round k + 1 reads what other blocks wrote in round k, in
//   the same launch. The buffers and the partials carry no __restrict__
//   and go through no read-only load path; the barrier orders them.
//
// The round loop is lbm_rounds.cuh's, which the stream-cost probe
// (probe.cu) runs around its own stage bodies.
//
// The shift mode (the JAX kernel's LBM_RESIDENT_SHIFT, _streamed_shifted,
// row mode and two buffers only, as there): on the TPU the whole previous
// state sits in one VMEM buffer, so a block's cy = +-1 windows are loads at
// row offsets instead of staged edge rows and a roll. Here it is a step at
// a time over blocks that each own a rectangle of whole depth tiles for
// the launch (lbm_rounds.cuh's shift_block, whose comment gives the
// schedule): where a block's cells fit its shared memory (the narrow
// channels 4096x64 and 8192x32, whose blocks are slabs of whole tile
// columns at full height, and 256x256) they stay there for the launch and
// only what a neighbour pulls crosses L2; else they stay in the two
// lattice buffers and each cell's nine speeds are loaded from the source
// buffer at offset rows and columns. No grid barrier a step: a block waits
// only on the step counters of the blocks whose cells its ring pulls. Each
// cell's partial keeps the depth tile's map (the 32 x 24 tile, the two
// cells of a quad in order, its warp and lane, the warps in order), so
// each step's tot_u has the depth plan's bits. Measured (PERF.md): the
// design it replaces, tiles dealt by block stride and a grid barrier a
// step, spent 42 % of a step at 4096x64 in the barrier and 29 % in its
// loads' L2 round trips; within that design the forcing guard's forced-row
// reads were loaded at once (1.44-1.49x faster than the guard's four
// dependent round trips), as the device residence's tile body still loads
// them.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/resident.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_rounds.cuh"

namespace {

// A kernel for each association: in one kernel that switched on it, the
// three copies of the round loop spilled four times as much and ran 4-15 %
// slower (PERF.md).
template <bool kCols, int kMode>
__global__ void __launch_bounds__(Block<kCols>::kThreads, 2)
resident_kernel(const __grid_constant__ Resident r) {
    extern __shared__ float4 smem[];
    resident_block<kCols, kMode>(r, reinterpret_cast<float*>(smem));
}

// The shift mode's kernel, a kernel for each association as above and for
// each residence: the device residence two blocks an SM (80 registers in
// the parent's tile body; launch bounds of three, 56 registers and 132 /
// 160 B spilled, ran 1.36x the time at 8192x32, 1.09x at 256x256), the
// shared residence one, its cells in the dynamic shared memory.
template <int kMode, bool kShared>
__global__ void __launch_bounds__(kShared ? kSlabThreads : kShiftThreads,
                                  kShared ? 1 : 2)
resident_shift_kernel(const __grid_constant__ Shift s) {
    extern __shared__ float4 smem[];
    shift_block<kMode, kShared>(s, reinterpret_cast<float*>(smem));
}

template <bool kShared>
const void* shift_kernel_of(int mode) {
    return mode == 1   ? (const void*)resident_shift_kernel<1, kShared>
           : mode == 2 ? (const void*)resident_shift_kernel<2, kShared>
                       : (const void*)resident_shift_kernel<0, kShared>;
}

template <bool kCols>
const void* kernel_of_mode(int mode) {
    return mode == 1   ? (const void*)resident_kernel<kCols, 1>
           : mode == 2 ? (const void*)resident_kernel<kCols, 2>
                       : (const void*)resident_kernel<kCols, 0>;
}

// The kernel of an axis and association, its threads and its dynamic
// shared memory.
void resident_kernel_of(int axis, int mode, const void** fn, int* threads,
                        size_t* bytes) {
    if (axis) {
        *fn = kernel_of_mode<true>(mode);
        *threads = Block<true>::kThreads;
        *bytes = Block<true>::kBytes;
    } else {
        *fn = kernel_of_mode<false>(mode);
        *threads = Block<false>::kThreads;
        *bytes = Block<false>::kBytes;
    }
}

// The shift mode's ownership of an ny x nx lattice over at most `blocks`
// blocks: its groups and the largest block's width, height and tiles.
struct ShiftShape {
    int tiles_x, tiles_y, ncg, nrg, w, h, tiles;
};
bool shift_shape(int ny, int nx, int blocks, ShiftShape* sh) {
    int n;
    depth_tiles(4, ny, nx, &sh->tiles_x, &n);
    if (n < 1 || blocks < 1) return false;
    sh->tiles_y = n / sh->tiles_x;
    shift_groups(sh->tiles_x, sh->tiles_y, blocks, &sh->ncg, &sh->nrg);
    int tc = 0, tr = 0;
    sh->w = sh->h = 0;
    for (int g = 0; g < sh->ncg; ++g) {
        const int t0 = group_start(g, sh->ncg, sh->tiles_x);
        const int t1 = group_start(g + 1, sh->ncg, sh->tiles_x);
        tc = t1 - t0 > tc ? t1 - t0 : tc;
        const int w = (t1 * ShiftGeo::TX < nx ? t1 * ShiftGeo::TX : nx) -
                      t0 * ShiftGeo::TX;
        sh->w = w > sh->w ? w : sh->w;
    }
    for (int g = 0; g < sh->nrg; ++g) {
        const int t0 = group_start(g, sh->nrg, sh->tiles_y);
        const int t1 = group_start(g + 1, sh->nrg, sh->tiles_y);
        tr = t1 - t0 > tr ? t1 - t0 : tr;
        const int h = (t1 * ShiftGeo::TY < ny ? t1 * ShiftGeo::TY : ny) -
                      t0 * ShiftGeo::TY;
        sh->h = h > sh->h ? h : sh->h;
    }
    sh->tiles = tc * tr;
    return true;
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on this device for an ny x nx lattice
// in forcing mode axis (0 rows, 1 columns) and, shift 1, of the shift
// mode's device residence (row mode only): as many as can be co-resident
// with their shared memory, at most one a tile. Negative: a CUDA error
// code, negated (no cooperative launch on this device is
// cudaErrorNotSupported; the shift mode in column mode
// cudaErrorInvalidValue).
int lbm_resident_blocks(int ny, int nx, int axis, int shift, int device) {
    if (shift && axis) return -(int)cudaErrorInvalidValue;
    const void* fn;
    int threads;
    size_t bytes;
    if (shift) {
        fn = shift_kernel_of<false>(0);
        threads = kShiftThreads;
        bytes = 0;
    } else {
        resident_kernel_of(axis, 0, &fn, &threads, &bytes);
    }
    return rounds_blocks(fn, threads, bytes, ny, nx, device);
}

// gsteps steps ping-ponging a -> b -> a ... in rounds4 rounds of 4 steps,
// then rounds2 of 2, then rounds1 of 1 (ops/resident.py: device_rounds),
// whose count has gsteps' parity: the result is in a when gsteps is even,
// in b when odd. partials holds gsteps * n floats, n =
// lbm_depth_num_partials(4, ny, nx); tickets two 32-bit words, zero before
// the first launch (every launch leaves them so); out gets
// gsteps values, out[s] = scale * step s's sum of fluid |u|. axis 0 forces
// row accel, axis 1 (a transposed lattice) column accel; blocks comes from
// lbm_resident_blocks for the same axis. A launch of more blocks than can
// be co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
int lbm_resident(float* a, float* b, const uint8_t* mask, float* partials,
                 unsigned* tickets, float* out, int ny, int nx, int accel,
                 float w1, float w2, float omega, int mode, int gsteps,
                 int rounds4, int rounds2, int rounds1, float scale,
                 int blocks, int axis, int device, void* stream) {
    Resident r;
    const cudaError_t err = resident_args(
        &r, a, b, mask, partials, tickets, out, ny, nx, accel, w1, w2, omega,
        mode, gsteps, rounds4, rounds2, rounds1, scale);
    if (err != cudaSuccess) return (int)err;
    const void* fn;
    int threads;
    size_t bytes;
    resident_kernel_of(axis, mode, &fn, &threads, &bytes);
    return (int)launch_rounds(fn, threads, bytes, r, blocks, device, stream);
}

// The shift mode (row mode only). Its ownership of an ny x nx lattice
// over at most `owners` blocks (ops/plan.py's shift_groups): the blocks
// that own tiles, the dynamic shared memory of a block in the shared
// residence (ops/plan.py's shift_smem_bytes) and the floats of its edge
// buffer; -1 where the lattice or the count has no ownership.
int lbm_shift_owners(int ny, int nx, int owners) {
    ShiftShape sh;
    return shift_shape(ny, nx, owners, &sh) ? sh.ncg * sh.nrg : -1;
}
long long lbm_shift_smem_bytes(int ny, int nx, int owners) {
    ShiftShape sh;
    return shift_shape(ny, nx, owners, &sh) ? slab_bytes(sh.w, sh.h, sh.tiles)
                                            : -1;
}
long long lbm_shift_edge_floats(int ny, int nx, int owners) {
    ShiftShape sh;
    return shift_shape(ny, nx, owners, &sh)
               ? 2 * edge_slot_floats(ny, nx, sh.ncg, sh.nrg)
               : -1;
}

// gsteps steps of the shift mode from a, the result in a when gsteps is
// even and in b when odd; partials, out and scale as lbm_resident's. The
// ownership is over `owners` blocks; `blocks` (at least the owning ones)
// are launched. done: one 32-bit counter a launched block, zero before the
// first launch (every launch leaves them so); shared 1 runs the shared
// residence, whose edges hold lbm_shift_edge_floats floats (shared 0: not
// read). A launch of more blocks than can be co-resident, or a block too
// large for the shared memory, is refused.
int lbm_resident_shift(float* a, float* b, const uint8_t* mask,
                       float* partials, unsigned* done, float* edges,
                       float* out, int ny, int nx, int accel, float w1,
                       float w2, float omega, int mode, int gsteps,
                       float scale, int blocks, int owners, int shared,
                       int device, void* stream) {
    ShiftShape sh;
    if (!shift_shape(ny, nx, owners, &sh) || blocks < sh.ncg * sh.nrg) {
        return (int)cudaErrorInvalidValue;
    }
    Shift s{};
    cudaError_t err = resident_args(&s.r, a, b, mask, partials, nullptr, out,
                                    ny, nx, accel, w1, w2, omega, mode,
                                    gsteps, 0, 0, gsteps, scale);
    if (err != cudaSuccess) return (int)err;
    s.done = done;
    s.edges = edges;
    s.ncg = sh.ncg;
    s.nrg = sh.nrg;
    s.w2 = slab_w2(sh.w);
    s.h2 = sh.h + 2;
    s.tiles_cap = sh.tiles;
    const void* fn = shared ? shift_kernel_of<true>(mode)
                            : shift_kernel_of<false>(mode);
    const int threads = shared ? kSlabThreads : kShiftThreads;
    const size_t bytes = shared ? (size_t)slab_bytes(sh.w, sh.h, sh.tiles) : 0;
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = depth_opt_in(fn, device);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&s};
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args,
                                      bytes, (cudaStream_t)stream);
    if (err != cudaSuccess) {
        // A refused launch never ran; its error must not stay behind.
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
