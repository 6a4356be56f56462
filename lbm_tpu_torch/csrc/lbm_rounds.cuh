// The round loop of a persistent cooperative launch of depth-kernel blocks
// (lbm_depth.cuh): G steps of a periodic lattice in device memory as rounds
// of 4, 2 and 1 steps, one grid barrier a round, each step's per-tile
// partials summed in tile order after the last. Shared by the device-memory
// resident form (resident.cu, the production step, whose header comment
// gives the design and the measurements behind each choice) and the
// stream-cost probe (probe.cu, the same loop around another stage body).
// Also the device form's shift mode (shift_block): rounds of one step whose
// tile pulls each cell's speeds straight from the source buffer.

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

// The shift mode (the JAX kernel's LBM_RESIDENT_SHIFT, _streamed_shifted):
// every round is one step, and no window is staged: each owned cell's nine
// speeds are loaded straight from the source buffer at offset rows and
// columns, which every block can address. A cell's partial has the depth
// plan's bits: its quad is a quad of the depth tile's map (Geo<1, 2>:
// window rows of 20 quads of two cells, the first and last two of a row the
// x halo), its two cells are added in the same order, and the quad's
// partial is summed in the warp and at the lane the depth tile gives its
// thread, then the tile's 15 warps in order.
using ShiftGeo = Geo<1, kCellsPerThread<false>>;
// A thread for each owned quad of the tile, 24 rows of 16 (the depth tile's
// thread map has 20 a row, the halo's idle here).
constexpr int kShiftQuadsX = ShiftGeo::TX / kCellsPerThread<false>;
constexpr int kShiftThreads = ShiftGeo::TY * kShiftQuadsX;

// Depth-tile thread vtid's quad of tile `tile` (window row vtid / 20 + 1,
// two cells) for one step of a periodic row-mode lattice from src into
// dst; returns the thread's partial, its owned fluid cells' |u| added in
// order to 0 (0 for a quad that owns none). kVec: a.vec, the speeds moved
// as float2.
template <int kMode, bool kVec>
__device__ __forceinline__ float shift_quad(const Args& a, const float* src,
                                            float* dst, int tile, int vtid) {
    constexpr int kV = kCellsPerThread<false>;
    constexpr int TX = ShiftGeo::TX, TY = ShiftGeo::TY, HX = ShiftGeo::HX;
    constexpr int NQ = ShiftGeo::NQ;
    const int ny = a.ny, nx = a.nx;
    const int by = tile / a.tiles_x, bx = tile - by * a.tiles_x;
    // Lattice cells (y, x) and (y, x + 1).
    const int qrow = vtid / NQ, c0 = kV * (vtid - qrow * NQ);
    const int y = by * TY + qrow, x = bx * TX - HX + c0;
    if (y >= ny || x >= nx) return 0.0f;
    const unsigned int own = x + 1 < nx ? 3u : 1u;
    // No __restrict__ and no read-only path: other blocks wrote src in
    // the step before, behind the grid barrier.
    const size_t plane = (size_t)ny * (size_t)nx;
    const int ym = y == 0 ? ny - 1 : y - 1;
    const int yp = y == ny - 1 ? 0 : y + 1;
    const int rc = y * nx, rm = ym * nx, rp = yp * nx;
    // Columns x - 1, x + 1 and x + 2, periodic.
    const int xw = x == 0 ? nx - 1 : x - 1;
    const int x1 = x + 1 < nx ? x + 1 : x + 1 - nx;
    int xe = x + 2;
    while (xe >= nx) xe -= nx;
    // Each speed's pair from the row it is pulled from: k = 0, 1, 3 from
    // the cells' row, 2, 5, 6 from the row below, 4, 7, 8 from the row
    // above; 1, 5, 8 one more from x - 1, 3, 6, 7 from x + 2.
    float q[9][kV];
    uint8_t m[kV];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const int row = (k == 2 || k == 5 || k == 6) ? rm
                      : (k == 4 || k == 7 || k == 8) ? rp : rc;
        const float* p = src + k * plane + row;
        if constexpr (kVec) {
            load_vec(p + x, q[k]);
        } else {
            q[k][0] = p[x];
            q[k][1] = p[x1];
        }
    }
    if constexpr (kVec) {
        load_vec(a.mask + rc + x, m);
    } else {
        m[0] = a.mask[rc + x];
        m[1] = a.mask[rc + x1];
    }
    const float e1 = src[1 * plane + rc + xw];
    const float e5 = src[5 * plane + rm + xw];
    const float e8 = src[8 * plane + rp + xw];
    const float e3 = src[3 * plane + rc + xe];
    const float e6 = src[6 * plane + rm + xe];
    const float e7 = src[7 * plane + rp + xe];
    const bool f0 = y == a.accel, f1 = ym == a.accel, f2 = yp == a.accel;
    // The forcing guard's reads, all at once: speeds 3, 6, 7 and the
    // obstacle flag of the forced row (the one of rows y, y - 1, y + 1
    // that is; where two are, they are one row) at columns x - 1 .. x + 2.
    // Read one after another, as the guard's && reads them, they were four
    // round trips to L2.
    float g[3][4] = {};
    bool gs[4] = {};
    if (f0 || f1 || f2) {
        const int fr = f0 ? rc : f1 ? rm : rp;
        const int col[4] = {xw, x, x1, xe};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            g[0][j] = src[3 * plane + fr + col[j]];
            g[1][j] = src[6 * plane + fr + col[j]];
            g[2][j] = src[7 * plane + fr + col[j]];
            gs[j] = a.mask[fr + col[j]] != 0;
        }
    }
    float acc = 0.0f;
    float o[9][kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
        // The nine speeds cell i pulls, by speed.
        const int qw = i == 0 ? 0 : i - 1, qe = i == kV - 1 ? 0 : i + 1;
        const float v[9] = {
            q[0][i], i == 0 ? e1 : q[1][qw],
            q[2][i], i == kV - 1 ? e3 : q[3][qe],
            q[4][i], i == 0 ? e5 : q[5][qw],
            i == kV - 1 ? e6 : q[6][qe],
            i == kV - 1 ? e7 : q[7][qe],
            i == 0 ? e8 : q[8][qw]};
        const bool solid0 = m[i] != 0;
        // A speed pulled from a site is the register that holds it. The
        // guard reads speeds 3, 6 and 7 and the flag of a forced-row site
        // west (column tag 1: column x - 1 + i) or east (tag 2: x + 1 + i)
        // of the cell: g's column i or i + 2.
        auto ld = [&](int k, Site t) -> float {
            const int j = i + (t.tag % 3 == 1 ? 0 : 2);
            return t.tag == pull_tag(k) ? v[k]
                 : k == 3 ? g[0][j] : k == 6 ? g[1][j] : g[2][j];
        };
        auto solid = [&](Site t) -> bool {
            return t.tag == 0 ? solid0 : gs[i + (t.tag % 3 == 1 ? 0 : 2)];
        };
        const int ic = i == 0 ? x : x1;
        const int iw = i == 0 ? xw : x;
        const int ie = i == 0 ? x1 : xe;
        float out[9];
        const float um = lbm_cell_update<false, Site>(
            ld, solid, Site{rc, 0}, Site{rm, 3}, Site{rp, 6}, Site{ic, 0},
            Site{iw, 1}, Site{ie, 2}, f0, f1, f2, a.w1, a.w2, a.omega, kMode,
            out);
        if ((own >> i) & 1u) acc += um;
#pragma unroll
        for (int k = 0; k < 9; ++k) o[k][i] = out[k];
    }
    float* to = dst + rc;
    if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < 9; ++k) store_vec(to + k * plane + x, o[k]);
    } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            to[k * plane + x] = o[k][0];
            if (own & 2u) to[k * plane + x1] = o[k][1];
        }
    }
    return acc;
}

// One step of the lattice, src into dst, tile by tile (block b takes tiles
// b, b + gridDim.x, ...: a ticket a tile was slower here), each tile's
// partial into part[tile]. Thread t computes owned quad t (tile row t / 16,
// quad column t % 16) and stages its partial in vacc at its depth-tile
// thread's place (the halo's places hold 0); then the block's 12 warps sum
// vacc as the depth tile's 15 warps, and thread 0 adds their sums in order.
template <int kMode, bool kVec>
__device__ __forceinline__ void shift_round(const Args& a, const float* src,
                                            float* dst, float* part) {
    __shared__ float vacc[ShiftGeo::kOwnQuads];
    __shared__ float warp_tot[ShiftGeo::kOwnWarps];
    const int tid = threadIdx.x;
    const int vtid = (tid / kShiftQuadsX) * ShiftGeo::NQ + ShiftGeo::HX / 2 +
                     tid % kShiftQuadsX;
    // The halo's places, which no thread writes (a thread writes only its
    // own place, so zeroing none of those needs no barrier).
    constexpr int kHalo = ShiftGeo::NQ - kShiftQuadsX;
    if (tid < ShiftGeo::TY * kHalo) {
        const int c = tid % kHalo;
        vacc[(tid / kHalo) * ShiftGeo::NQ +
             (c < kHalo / 2 ? c : c + kShiftQuadsX)] = 0.0f;
    }
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        // vacc's last reads and warp_tot's last writes are behind the last
        // tile's second barrier.
        vacc[vtid] = shift_quad<kMode, kVec>(a, src, dst, tile, vtid);
        __syncthreads();
        for (int w = tid >> 5; w < ShiftGeo::kOwnWarps;
             w += kShiftThreads / 32) {
            const float v = lbm_warp_sum(vacc[32 * w + (tid & 31)]);
            if ((tid & 31) == 0) warp_tot[w] = v;
        }
        __syncthreads();
        if (tid == 0) {
            float tot = 0.0f;
#pragma unroll
            for (int w = 0; w < ShiftGeo::kOwnWarps; ++w) tot += warp_tot[w];
            lbm_publish_partial(part + tile, tot);
        }
    }
}

// The shift mode's kernel body (row mode only: JAX has no shift mode in
// column mode): r.gsteps rounds of one step, a grid barrier after each,
// then each step's partials summed in tile order. Blocks of kShiftThreads
// threads and no dynamic shared memory; the tickets are not used.
template <int kMode>
__device__ __forceinline__ void shift_block(const Resident& r) {
    const Args& a = r.args[0];
    const int n = a.n_tiles;
    for (int k = 0; k < r.gsteps; ++k) {
        const float* src = (k & 1) ? r.args[1].src : a.src;
        float* dst = (k & 1) ? r.args[1].dst : a.dst;
        float* part = r.partials + (size_t)k * n;
        if (a.vec) {
            shift_round<kMode, true>(a, src, dst, part);
        } else {
            shift_round<kMode, false>(a, src, dst, part);
        }
        cooperative_groups::this_grid().sync();
    }
    for (int s = blockIdx.x; s < r.gsteps; s += gridDim.x) {
        lbm_sum_rows<1>(r.partials + (size_t)s * n, nullptr, n, r.scale,
                        r.out + s, threadIdx.x);
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
