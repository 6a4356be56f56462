// The round loop of a persistent cooperative launch of depth-kernel blocks
// (lbm_depth.cuh): G steps of a periodic lattice in device memory as rounds
// of 4, 2 and 1 steps, one grid barrier a round, each step's per-tile
// partials summed in tile order after the last. Shared by the device-memory
// resident form (resident.cu, the production step, whose header comment
// gives the design and the measurements behind each choice) and the
// stream-cost probe (probe.cu, the same loop around another stage body).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_depth.cuh"

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

// The block of every round: sized for D = 4, whose tile, window and thread
// map D = 2 and D = 1 share.
template <bool kCols>
using Block = Geo<4, kCellsPerThread<kCols>>;

// One round of D steps over every tile: the block draws its tiles by
// ticket, one atomicAdd a tile, the next drawn before the current one runs.
template <int D, bool kCols, int kMode, int kStage>
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
        lbm_depth_tile<D, false, kCols, kMode, kStage>(a, buf, tile, part,
                                                       (size_t)n);
        tile = *next;
    }
    // The other ticket was last drawn in round k - 1.
    if (blockIdx.x == 0 && tid == 0) r.tickets[(k + 1) & 1] = 0;
}

// The rounds of 2 and 1 steps (at most three a launch) as calls of their
// own: inlined, their stage loops crowd the registers of the round loop
// and of the rounds of 4 (PERF.md).
template <int D, bool kCols, int kMode, int kStage>
__device__ __noinline__ void round_call(const Args& a, const Resident& r,
                                        float* buf, float* part, int k) {
    run_round<D, kCols, kMode, kStage>(a, r, buf, part, k);
}

template <bool kCols, int kMode, int kStage>
__device__ __forceinline__ void round_of(int d, const Args& a,
                                         const Resident& r, float* buf,
                                         float* part, int k) {
    if (d == 4) {
        run_round<4, kCols, kMode, kStage>(a, r, buf, part, k);
    } else if (d == 2) {
        round_call<2, kCols, kMode, kStage>(a, r, buf, part, k);
    } else {
        round_call<1, kCols, kMode, kStage>(a, r, buf, part, k);
    }
}

// A kernel's whole body: the rounds, a grid barrier after each, then each
// step's partials summed in tile order. buf: the block's dynamic shared
// memory, Block<kCols>::kBytes.
template <bool kCols, int kMode, int kStage = kStageFull>
__device__ __forceinline__ void resident_block(const Resident& r, float* buf) {
    const int tid = threadIdx.x;
    const int rounds = r.rounds4 + r.rounds2 + r.rounds1;
    const int n = r.args[0].n_tiles;
    int step = 0;
    for (int k = 0; k < rounds; ++k) {
        const int d = k < r.rounds4 ? 4 : k < r.rounds4 + r.rounds2 ? 2 : 1;
        float* part = r.partials + (size_t)step * n;
        if constexpr (kCols) {
            round_of<kCols, kMode, kStage>(d, r.args[k & 1], r, buf, part, k);
        } else if (k & 1) {
            // Row mode: a copy of the round for each parity, whose
            // arguments are then operands in the constant bank (PERF.md).
            round_of<kCols, kMode, kStage>(d, r.args[1], r, buf, part, k);
        } else {
            round_of<kCols, kMode, kStage>(d, r.args[0], r, buf, part, k);
        }
        cooperative_groups::this_grid().sync();
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

// The arguments of a launch of gsteps steps ping-ponging a -> b -> a ...
// in rounds4 rounds of 4, then rounds2 of 2, then rounds1 of 1, whose count
// has gsteps' parity (ops/resident.py: device_rounds); no halo, windows
// wrap modulo the lattice. cudaErrorInvalidValue where the rounds do not
// make gsteps or the lattice has too many tiles.
inline cudaError_t resident_args(Resident* r, float* a, float* b,
                                 const uint8_t* mask, float* partials,
                                 unsigned* tickets, float* out, int ny,
                                 int nx, int accel, float w1, float w2,
                                 float omega, int mode, int gsteps,
                                 int rounds4, int rounds2, int rounds1,
                                 float scale) {
    if (gsteps < 1 || rounds4 < 0 || rounds2 < 0 || rounds1 < 0 ||
        4 * rounds4 + 2 * rounds2 + rounds1 != gsteps ||
        (rounds4 + rounds2 + rounds1 - gsteps) % 2) {
        return cudaErrorInvalidValue;
    }
    auto aligned = [](const void* p, uintptr_t bytes) {
        return ((uintptr_t)p & (bytes - 1)) == 0;
    };
    const Halo periodic{nullptr, nullptr, nullptr, nullptr, 0, 0, ny};
    *r = Resident{};
    r->args[0] = Args{a, b, mask, nullptr, 1.0f, nullptr, ny, nx, accel,
                      w1, w2, omega, mode, 0, 0,
                      nx % 4 == 0 && aligned(a, 16) && aligned(b, 16) &&
                          aligned(mask, 4),
                      periodic};
    depth_tiles(4, ny, nx, &r->args[0].tiles_x, &r->args[0].n_tiles);
    if (r->args[0].n_tiles < 1) return cudaErrorInvalidValue;
    r->args[1] = r->args[0];
    r->args[1].src = b;
    r->args[1].dst = a;
    r->partials = partials;
    r->tickets = tickets;
    r->out = out;
    r->gsteps = gsteps;
    r->rounds4 = rounds4;
    r->rounds2 = rounds2;
    r->rounds1 = rounds1;
    r->scale = scale;
    return cudaSuccess;
}

// Blocks of a cooperative launch of kernel fn (threads threads, bytes of
// dynamic shared memory a block) for an ny x nx lattice on this device: as
// many as can be co-resident, at most one a tile. Negative: a CUDA error
// code, negated (no cooperative launch on this device is
// cudaErrorNotSupported).
inline int rounds_blocks(const void* fn, int threads, size_t bytes, int ny,
                         int nx, int device) {
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

// The cooperative launch of kernel fn over blocks blocks with r. A launch
// of more blocks than can be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge).
inline cudaError_t launch_rounds(const void* fn, int threads, size_t bytes,
                                 Resident r, int blocks, int device,
                                 void* stream) {
    if (blocks < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    err = depth_opt_in(fn, device);
    if (err != cudaSuccess) return err;
    void* args[] = {&r};
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args,
                                      bytes, (cudaStream_t)stream);
    if (err != cudaSuccess) {
        // A refused launch never ran; its error is returned here and must
        // not stay behind for the next launch's check.
        cudaGetLastError();
        return err;
    }
    return cudaGetLastError();
}
