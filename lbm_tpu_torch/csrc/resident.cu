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
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/resident.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_depth.cuh"

namespace cg = cooperative_groups;

namespace {

// One launch's arguments: round k steps args[k & 1] (src a, dst b after an
// even number of rounds; src b, dst a after an odd one).
struct Resident {
    Args args[2];
    float* partials;           // (gsteps, n_tiles) per-tile partials
    unsigned* tickets;         // two tile tickets, by round parity
    float* out;                // out[s] = scale * tot_u of step s
    int gsteps, rounds4, rounds2, rounds1;
    float scale;
};

template <bool kCols>
using Block = Geo<4, kCellsPerThread<kCols>>;

// One round of D steps over every tile: the block draws its tiles by
// ticket, one atomicAdd a tile, the next drawn before the current one runs.
template <int D, bool kCols, int kMode>
__device__ __forceinline__ void run_round(const Args& a, const Resident& r,
                                          float* buf, float* part, int k) {
    // A slot is written again only after every thread has read it: the
    // draw two tiles on waits behind the next tile's barriers.
    __shared__ int drawn[2];
    const int tid = threadIdx.x, n = a.n_tiles;
    unsigned* ticket = r.tickets + (k & 1);
    if (tid == 0) drawn[0] = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    int tile = drawn[0];
    for (int i = 1; tile < n; ++i) {
        int* next = &drawn[i & 1];
        if (tid == 0) *next = (int)atomicAdd(ticket, 1u);
        lbm_depth_tile<D, false, kCols, kMode>(a, buf, tile, part, (size_t)n);
        tile = *next;
    }
    // The other ticket was last drawn in round k - 1.
    if (blockIdx.x == 0 && tid == 0) r.tickets[(k + 1) & 1] = 0;
}

// The rounds of 2 and 1 steps (at most three a launch) as calls of their
// own: inlined, their stage loops crowd the registers of the round loop
// and of the rounds of 4 (PERF.md).
template <int D, bool kCols, int kMode>
__device__ __noinline__ void round_call(const Args& a, const Resident& r,
                                        float* buf, float* part, int k) {
    run_round<D, kCols, kMode>(a, r, buf, part, k);
}

template <bool kCols, int kMode>
__device__ __forceinline__ void round_of(int d, const Args& a,
                                         const Resident& r, float* buf,
                                         float* part, int k) {
    if (d == 4) {
        run_round<4, kCols, kMode>(a, r, buf, part, k);
    } else if (d == 2) {
        round_call<2, kCols, kMode>(a, r, buf, part, k);
    } else {
        round_call<1, kCols, kMode>(a, r, buf, part, k);
    }
}

template <bool kCols, int kMode>
__device__ __forceinline__ void resident_block(const Resident& r, float* buf) {
    const int tid = threadIdx.x;
    const int rounds = r.rounds4 + r.rounds2 + r.rounds1;
    const int n = r.args[0].n_tiles;
    int step = 0;
    for (int k = 0; k < rounds; ++k) {
        const int d = k < r.rounds4 ? 4 : k < r.rounds4 + r.rounds2 ? 2 : 1;
        float* part = r.partials + (size_t)step * n;
        if constexpr (kCols) {
            round_of<kCols, kMode>(d, r.args[k & 1], r, buf, part, k);
        } else if (k & 1) {
            // Row mode: a copy of the round for each parity, whose
            // arguments are then operands in the constant bank (PERF.md).
            round_of<kCols, kMode>(d, r.args[1], r, buf, part, k);
        } else {
            round_of<kCols, kMode>(d, r.args[0], r, buf, part, k);
        }
        cg::this_grid().sync();
        step += d;
    }
    if (blockIdx.x == 0 && tid == 0) r.tickets[(rounds - 1) & 1] = 0;
    // Each step's partials, summed in tile order: block b takes steps b,
    // b + gridDim.x, ...
    for (int s = blockIdx.x; s < r.gsteps; s += gridDim.x) {
        lbm_sum_rows<1>(r.partials + (size_t)s * n, nullptr, n, r.scale,
                        r.out + s, tid);
        __syncthreads();
    }
}

// A kernel for each association: in one kernel that switched on it, the
// three copies of the round loop spilled four times as much and ran 4-15 %
// slower (PERF.md).
template <bool kCols, int kMode>
__global__ void __launch_bounds__(Block<kCols>::kThreads, 2)
resident_kernel(const __grid_constant__ Resident r) {
    extern __shared__ float4 smem[];
    resident_block<kCols, kMode>(r, reinterpret_cast<float*>(smem));
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

bool aligned(const void* p, uintptr_t bytes) {
    return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on this device for an ny x nx lattice
// in forcing mode axis (0 rows, 1 columns): as many as can be co-resident
// with their shared memory, at most one a tile. Negative: a CUDA error
// code, negated (no cooperative launch on this device is
// cudaErrorNotSupported).
int lbm_resident_blocks(int ny, int nx, int axis, int device) {
    const void* fn;
    int threads;
    size_t bytes;
    resident_kernel_of(axis, 0, &fn, &threads, &bytes);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return -(int)err;
    if (!coop) return -(int)cudaErrorNotSupported;
    err = depth_opt_in(fn, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        bytes);
    if (err != cudaSuccess) return -(int)err;
    int tiles_x, n_tiles;
    depth_tiles(4, ny, nx, &tiles_x, &n_tiles);
    if (n_tiles < 1) return -(int)cudaErrorInvalidValue;
    const long long blocks = (long long)per_sm * sms;
    if (blocks < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    return (int)(blocks < n_tiles ? blocks : n_tiles);
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
    if (gsteps < 1 || blocks < 1 || rounds4 < 0 || rounds2 < 0 ||
        rounds1 < 0 || 4 * rounds4 + 2 * rounds2 + rounds1 != gsteps ||
        (rounds4 + rounds2 + rounds1 - gsteps) % 2) {
        return (int)cudaErrorInvalidValue;
    }
    const void* fn;
    int threads;
    size_t bytes;
    resident_kernel_of(axis, mode, &fn, &threads, &bytes);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = depth_opt_in(fn, device);
    if (err != cudaSuccess) return (int)err;
    const Halo periodic{nullptr, nullptr, nullptr, nullptr, 0, 0, ny};
    Resident r{};
    r.args[0] = Args{a, b, mask, nullptr, 1.0f, nullptr, ny, nx, accel,
                     w1, w2, omega, mode, 0, 0,
                     nx % 4 == 0 && aligned(a, 16) && aligned(b, 16) &&
                         aligned(mask, 4),
                     periodic};
    depth_tiles(4, ny, nx, &r.args[0].tiles_x, &r.args[0].n_tiles);
    if (r.args[0].n_tiles < 1) return (int)cudaErrorInvalidValue;
    r.args[1] = r.args[0];
    r.args[1].src = b;
    r.args[1].dst = a;
    r.partials = partials;
    r.tickets = tickets;
    r.out = out;
    r.gsteps = gsteps;
    r.rounds4 = rounds4;
    r.rounds2 = rounds2;
    r.rounds1 = rounds1;
    r.scale = scale;
    void* args[] = {&r};
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args,
                                      bytes, (cudaStream_t)stream);
    if (err != cudaSuccess) {
        // A refused launch never ran; its error is returned here and must
        // not stay behind for the next launch's check.
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
