// The round loop of a persistent cooperative launch of depth-kernel blocks
// (lbm_depth.cuh): G steps of a periodic lattice in device memory as rounds
// of 4, 2 and 1 steps, one grid barrier a round, each step's per-tile
// partials summed in tile order after the last. Shared by the device-memory
// resident form (resident.cu, the production step, whose header comment
// gives the design and the measurements behind each choice) and the
// stream-cost probe (probe.cu, the same loop around another stage body),
// and the tensor-core equilibrium's kernel (mxu_eq.cu, another). Also the device form's shift mode (shift_block): a step at a time over
// blocks that own their tiles for the launch and wait only on their
// neighbours' step counters.

#pragma once

#include <cooperative_groups.h>
#include <cuda/atomic>
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
    // the step before, behind their step counters.
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

// The shift mode's schedule. Each block owns a rectangle of whole depth
// tiles for the launch (shift_groups: column groups of whole tile columns
// and row groups of whole tile rows, their sizes differing by at most one
// tile column or row, the larger groups last, where the ragged tile column
// and row fall). At the narrow channels the rectangles are slabs of whole
// tile columns at full height (4096x64: 128 blocks of 32 x 64 cells;
// 8192x32: 132 blocks of one or two tile columns), in which the y wrap and
// the forced row are internal. No grid barrier a step: each block keeps a
// step counter in device memory (done[b]: the steps it has finished) and
// waits, before it pulls a neighbour's cells of step k, until that
// neighbour's counter reaches k; first it updates the cells that pull
// nothing from another block.
//
// The ping-pong makes a write-after-read hazard: a block's step k + 1
// writes where its neighbours read in step k (the edge slot or lattice
// buffer of that parity). Its step k + 1 writes those cells only after it
// has waited, in step k + 1, for each neighbour's counter to reach k + 1:
// the neighbour has finished step k, its reads included (they come before
// its release). So the wait for data is the wait for the slot, and
// neighbours drift apart by at most one step. The cells no other block
// reads are written before the wait. The launch stays cooperative, so
// every block is on the card at once and a spin cannot deadlock. One grid
// barrier is left, after the last step, before each step's tile partials
// are summed in tile order (lbm_sum_rows, as the device form does).
//
// Two residences, a template parameter that the wrapper picks by the
// block's bytes (ops/plan.py's shift_residence), never after a failure:
// - shared (kShared): the block's cells in two buffers of shared memory
//   with a one-cell ring, loaded once a launch and written back once. A
//   step reads and writes shared memory; only what a neighbour pulls
//   crosses device memory, through an edge buffer by step parity (the
//   three speeds that leave through each side, and the forced row's
//   speeds 3, 6, 7 that the forcing guard reads across a side).
// - device: the cells stay in the two lattice buffers, loaded as the
//   depth tile's map loads them (shift_quad); a neighbour's cells are read
//   where they lie. The tiles whose cells pull nothing from another block
//   go first.
// Each step's tile partial keeps the depth plan's bits: a quad's |u| (the
// shared residence: its two cells' |u|, added in order) at its depth-map
// lane, summed by warps and then the warps in order, as the depth tile
// sums it.

// Column or row groups: group g of n over t tiles starts at tile
// group_start(g, n, t); the first n - t % n groups take t / n tiles, the
// rest one more.
__host__ __device__ inline int group_start(int g, int n, int t) {
    const int q = t / n, small = n - t % n;
    return g <= small ? g * q : small * q + (g - small) * (q + 1);
}
// The group of tile `tile`.
__host__ __device__ inline int group_of(int tile, int n, int t) {
    const int q = t / n, small = n - t % n;
    return tile < small * q ? tile / q : small + (tile - small * q) / (q + 1);
}
// Column and row groups for at most `blocks` blocks over a lattice of
// tiles_x x tiles_y tiles: one group of whole tile columns a block where
// there are as many tile columns as blocks, else each tile column cut
// into as many row groups as the blocks allow.
__host__ __device__ inline void shift_groups(int tiles_x, int tiles_y,
                                             int blocks, int* ncg, int* nrg) {
    if (tiles_x >= blocks) {
        *ncg = blocks;
        *nrg = 1;
    } else {
        *ncg = tiles_x;
        const int r = blocks / tiles_x;
        *nrg = r < tiles_y ? r : tiles_y;
    }
}

// The shared residence's block: threads, a tile's cells, and the plane of
// a speed: local cell (r, c), r in -1..h, c in -1..w (the ring around the
// block's h x w cells), sits at slab_at(w2, r, c), w2 = w + 2.
constexpr int kSlabThreads = 1024;
constexpr int kTileCells = ShiftGeo::TY * ShiftGeo::TX;  // 768
__host__ __device__ inline int slab_w2(int w) { return w + 2; }
__device__ __forceinline__ int slab_at(int w2, int r, int c) {
    return (r + 1) * w2 + c + 1;
}
// Dynamic shared memory of a block of at most w x h cells over at most
// tiles tiles: two 9-speed buffers, the cells' |u| and the tiles' warp
// sums by step parity, the mask.
__host__ __device__ inline long long slab_bytes(int w, int h, int tiles) {
    const long long plane = (long long)(h + 2) * slab_w2(w);
    return 2 * 9 * plane * 4 +
           2LL * tiles * (kTileCells + ShiftGeo::kOwnWarps) * 4 + plane;
}

// One launch of the shift mode.
struct Shift {
    Resident r;      // args[0]: a -> b; partials, out, gsteps, scale
    unsigned* done;  // a step counter a block, zero between launches
    float* edges;    // the shared residence's edge buffer, by step parity
    int ncg, nrg;    // column and row groups (block = rg * ncg + cg)
    int w2, h2;      // shared: the padded plane's row stride and rows
    int tiles_cap;   // shared: the partials' tiles a block
};

// The block's rectangle: columns [x0, x1), rows [y0, y1), tile columns
// [tc0, tc1), tile rows [tr0, tr1).
struct Rect {
    int cg, rg, x0, x1, y0, y1, tc0, tc1, tr0, tr1;
};
__device__ __forceinline__ Rect shift_rect(const Shift& s, int b) {
    const Args& a = s.r.args[0];
    const int tx = a.tiles_x, ty = a.n_tiles / a.tiles_x;
    Rect o;
    o.cg = b % s.ncg;
    o.rg = b / s.ncg;
    o.tc0 = group_start(o.cg, s.ncg, tx);
    o.tc1 = group_start(o.cg + 1, s.ncg, tx);
    o.tr0 = group_start(o.rg, s.nrg, ty);
    o.tr1 = group_start(o.rg + 1, s.nrg, ty);
    o.x0 = o.tc0 * ShiftGeo::TX;
    o.x1 = min(a.nx, o.tc1 * ShiftGeo::TX);
    o.y0 = o.tr0 * ShiftGeo::TY;
    o.y1 = min(a.ny, o.tr1 * ShiftGeo::TY);
    return o;
}
// The block that owns global cell (y, x).
__device__ __forceinline__ int shift_owner(const Shift& s, int y, int x) {
    const Args& a = s.r.args[0];
    const int tx = a.tiles_x, ty = a.n_tiles / a.tiles_x;
    return group_of(y / ShiftGeo::TY, s.nrg, ty) * s.ncg +
           group_of(x / ShiftGeo::TX, s.ncg, tx);
}

using StepFlag = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;
// Reads of a counter before a wait gives up and lets the step run on
// stale cells (seconds; no run comes near it, and the bit tests would
// show it): a fault then ends the launch instead of holding the card.
constexpr int kMaxStepReads = 1 << 26;
// Spin until block b has finished k steps. The acquire orders this
// thread's later loads (and, behind a barrier, its block's) after b's
// stores. (Relaxed reads and one acquire fence after them ran 1.05x the
// time.)
__device__ __forceinline__ void wait_steps(unsigned* done, int b, unsigned k) {
    StepFlag f(done[b]);
    for (int i = 0; f.load(cuda::memory_order_acquire) < k && i < kMaxStepReads;
         ++i) {
    }
}
// After a barrier behind the block's stores: one release for all of them,
// the counter's step added by an atomic (a release fence and a store took
// the device residence 1.05x the time at 256x256, 1.10x at 1024x1024).
__device__ __forceinline__ void release_steps(unsigned* done, int b) {
    StepFlag(done[b]).fetch_add(1u, cuda::memory_order_release);
}

// The foreign neighbours of rectangle o, the blocks whose cells its ring
// holds (up to eight, self left out), into nb; returns their count.
__device__ __forceinline__ int shift_neighbours(const Shift& s, const Rect& o,
                                                int self, int* nb) {
    const Args& a = s.r.args[0];
    const int xs[3] = {wrap(o.x0 - 1, a.nx), o.x0, wrap(o.x1, a.nx)};
    const int ys[3] = {wrap(o.y0 - 1, a.ny), o.y0, wrap(o.y1, a.ny)};
    int n = 0;
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            const int b = shift_owner(s, ys[i], xs[j]);
            bool seen = b == self;
            for (int m = 0; m < n; ++m) seen = seen || nb[m] == b;
            if (!seen) nb[n++] = b;
        }
    }
    return n;
}

// The edge buffer: per slot (step parity) the first column of each column
// group (speeds 3, 6, 7, all rows), its last column (1, 5, 8), the bottom
// row of each row group (4, 7, 8, all columns), its top row (2, 5, 6), and
// the forced row (3, 6, 7, all columns: the guard's reads across a side).
// Speed k of a side is its j-th, j = edge_index(k).
__host__ __device__ inline long long edge_slot_floats(int ny, int nx,
                                                      int ncg, int nrg) {
    return 6LL * ncg * ny + 6LL * nrg * nx + 3LL * nx;
}
enum EdgeSide { kColW = 0, kColE = 1, kRowS = 2, kRowN = 3, kForced = 4 };
__device__ __forceinline__ float* edge_at(const Shift& s, int slot, int side,
                                          int group, int j, int at) {
    const int ny = s.r.args[0].ny, nx = s.r.args[0].nx;
    float* e = s.edges + slot * edge_slot_floats(ny, nx, s.ncg, s.nrg);
    const long long cols = 3LL * s.ncg * ny, rows = 3LL * s.nrg * nx;
    switch (side) {
        case kColW: return e + (3LL * group + j) * ny + at;
        case kColE: return e + cols + (3LL * group + j) * ny + at;
        case kRowS: return e + 2 * cols + (3LL * group + j) * nx + at;
        case kRowN: return e + 2 * cols + rows + (3LL * group + j) * nx + at;
        default: return e + 2 * cols + 2 * rows + (long long)j * nx + at;
    }
}
// The speeds of each side, in order (selects: a table indexed at run time
// would sit in local memory).
__device__ __forceinline__ int edge_speed(int side, int j) {
    return side == kColE ? (j == 0 ? 1 : j == 1 ? 5 : 8)
         : side == kRowS ? (j == 0 ? 4 : j == 1 ? 7 : 8)
         : side == kRowN ? (j == 0 ? 2 : j == 1 ? 5 : 6)
                         : (j == 0 ? 3 : j == 1 ? 6 : 7);
}
// ---------------------------------------------------------------------
// The device residence.

// Tile `tile` of one step from src into dst: its 24 x 16 quads by the
// depth map's thread for each (shift_quad), the partial staged in vacc at
// the depth map's lanes (the halo's places hold 0), summed by the block's
// 12 warps as the depth tile's 15 warps, and thread 0 adds their sums in
// order into part[tile]. vacc's last reads and warp_tot's last writes are
// behind the last tile's second barrier.
template <int kMode, bool kVec>
__device__ __forceinline__ void shift_tile(const Args& a, const float* src,
                                           float* dst, float* part, int tile,
                                           float* vacc, float* warp_tot) {
    const int tid = threadIdx.x;
    const int vtid = (tid / kShiftQuadsX) * ShiftGeo::NQ + ShiftGeo::HX / 2 +
                     tid % kShiftQuadsX;
    vacc[vtid] = shift_quad<kMode, kVec>(a, src, dst, tile, vtid);
    __syncthreads();
    for (int w = tid >> 5; w < ShiftGeo::kOwnWarps; w += kShiftThreads / 32) {
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

// The device residence's step loop: blocks of kShiftThreads threads.
template <int kMode>
__device__ __forceinline__ void shift_device_steps(const Shift& s,
                                                   const Rect& o) {
    __shared__ float vacc[ShiftGeo::kOwnQuads];
    __shared__ float warp_tot[ShiftGeo::kOwnWarps];
    __shared__ int nb[8];
    __shared__ int nn;
    const Resident& r = s.r;
    const Args& a = r.args[0];
    const int tid = threadIdx.x, n = a.n_tiles;
    // The blocks whose counters the wait reads, and the partials' halo
    // places, which no tile pass writes.
    if (tid == 0) nn = shift_neighbours(s, o, blockIdx.x, nb);
    constexpr int kHalo = ShiftGeo::NQ - kShiftQuadsX;
    if (tid < ShiftGeo::TY * kHalo) {
        const int c = tid % kHalo;
        vacc[(tid / kHalo) * ShiftGeo::NQ +
             (c < kHalo / 2 ? c : c + kShiftQuadsX)] = 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < r.gsteps; ++k) {
        const float* src = (k & 1) ? r.args[1].src : a.src;
        float* dst = (k & 1) ? r.args[1].dst : a.dst;
        float* part = r.partials + (size_t)k * n;
        // Pass 0 the tiles whose cells pull nothing from another block,
        // pass 1, after the wait, the others.
        for (int pass = 0; pass < 2; ++pass) {
            if (pass == 1) {
                if (k > 0 && tid < nn) wait_steps(s.done, nb[tid], k);
                __syncthreads();
            }
            for (int ty = o.tr0; ty < o.tr1; ++ty) {
                for (int tx = o.tc0; tx < o.tc1; ++tx) {
                    const bool inner =
                        (s.nrg == 1 || (ty > o.tr0 && ty < o.tr1 - 1)) &&
                        (s.ncg == 1 || (tx > o.tc0 && tx < o.tc1 - 1));
                    if (inner != (pass == 0)) continue;
                    const int tile = ty * a.tiles_x + tx;
                    if (a.vec) {
                        shift_tile<kMode, true>(a, src, dst, part, tile, vacc,
                                                warp_tot);
                    } else {
                        shift_tile<kMode, false>(a, src, dst, part, tile,
                                                 vacc, warp_tot);
                    }
                }
            }
        }
        // Every store of the step is behind a tile's barrier or the wait's.
        if (tid == 0 && k + 1 < r.gsteps) {
            release_steps(s.done, blockIdx.x);
        }
    }
}

// ---------------------------------------------------------------------
// The shared residence.

// What one quad of a block's step needs besides its coordinates.
struct Slab {
    const float* cur;
    float* nxt;
    const uint8_t* msk;
    float* ucell;  // this step's parity: |u| a cell, tile by tile
    int P, w2, w, h;
    Rect o;
};

// The cell at local row rr, column c, from cur into nxt, as the depth
// tile's stage computes a cell: its nine pulled speeds, the forcing
// guard's reads of a forced-row site from shared memory where it is not a
// pulled site, its outputs. Its |u| (0 for an obstacle) goes to its slot
// of ucell, whose pairs make the depth map's quads. kRim: the cell reads
// the ring, and on a side or on the forced row publishes what a neighbour
// pulls into edge slot `slot` (slot < 0: none). One cell a thread: the
// rim, computed after the wait, is the step's critical path, and a cell's
// chain is half a quad's.
template <int kMode, bool kRim>
__device__ __forceinline__ void slab_cell(const Shift& s, const Slab& v,
                                          int rr, int c, int slot) {
    const Args& a = s.r.args[0];
    const int ny = a.ny, P = v.P, w2 = v.w2;
    const int gy = v.o.y0 + rr, x = v.o.x0 + c;
    const int rc = (rr + 1) * w2, rm = rc - w2, rp = rc + w2, ic = c + 1;
    const float* cur = v.cur;
    const int o0 = rc + ic;
    const float pv[9] = {
        cur[0 * P + o0],           cur[1 * P + o0 - 1],
        cur[2 * P + o0 - w2],      cur[3 * P + o0 + 1],
        cur[4 * P + o0 + w2],      cur[5 * P + o0 - w2 - 1],
        cur[6 * P + o0 - w2 + 1],  cur[7 * P + o0 + w2 + 1],
        cur[8 * P + o0 + w2 - 1]};
    const bool solid0 = v.msk[o0] != 0;
    const int ym = gy == 0 ? ny - 1 : gy - 1;
    const int yp = gy == ny - 1 ? 0 : gy + 1;
    const bool f0 = gy == a.accel, f1 = ym == a.accel, f2 = yp == a.accel;
    auto ld = [&](int k, Site t) -> float {
        return t.tag == pull_tag(k) ? pv[k] : cur[k * P + t.o];
    };
    auto solid = [&](Site t) -> bool {
        return t.tag == 0 ? solid0 : v.msk[t.o] != 0;
    };
    float out[9];
    const float um = lbm_cell_update<false, Site>(
        ld, solid, Site{rc, 0}, Site{rm, 3}, Site{rp, 6}, Site{ic, 0},
        Site{ic - 1, 1}, Site{ic + 1, 2}, f0, f1, f2, a.w1, a.w2, a.omega,
        kMode, out);
#pragma unroll
    for (int k = 0; k < 9; ++k) v.nxt[k * P + o0] = out[k];
    const int j = (gy / ShiftGeo::TY - v.o.tr0) * (v.o.tc1 - v.o.tc0) +
                  (x / ShiftGeo::TX - v.o.tc0);
    v.ucell[j * kTileCells + (gy % ShiftGeo::TY) * ShiftGeo::TX +
            x % ShiftGeo::TX] = um;
    if constexpr (kRim) {
        if (slot < 0) return;
        auto put = [&](int side, int group, int at) {
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
                *edge_at(s, slot, side, group, jj, at) =
                    out[edge_speed(side, jj)];
            }
        };
        if (s.ncg > 1 && c == 0) put(kColW, v.o.cg, gy);
        if (s.ncg > 1 && c == v.w - 1) put(kColE, v.o.cg, gy);
        if (s.nrg > 1 && rr == 0) put(kRowS, v.o.rg, x);
        if (s.nrg > 1 && rr == v.h - 1) put(kRowN, v.o.rg, x);
        if (f0) put(kForced, 0, x);
    }
}

// One float from global to shared memory, asynchronously (cp.async, L1
// allocating: the acquire before it left L1 without the neighbour's old
// lines), and the wait for every such copy of this thread.
__device__ __forceinline__ void copy_async(float* to, const float* from) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(to);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(from)
                 : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// Ring segment seg (0 west column, 1 east, 2 south row, 3 north, 4..7 the
// corners SW, SE, NW, NE) of an h x w block o: its cells (r0 + i dr,
// c0 + i dc), i < count, their owner, and the side and group of the edge
// buffer they come from. Where the rows wrap inside the block (one row
// group) the columns take the corners, whose owners are theirs; else where
// the columns do, the rows; a corner is a segment of its own only where
// both are cut (count 0 otherwise). Worked out once a launch.
struct RingSeg {
    int r0, c0, dr, dc, count, owner, side, group;
};
__device__ __forceinline__ RingSeg ring_seg(const Shift& s, const Rect& o,
                                            int w, int h, int seg) {
    const Args& a = s.r.args[0];
    const int ny = a.ny, nx = a.nx;
    const bool col_corners = s.nrg == 1;
    const bool row_corners = !col_corners && s.ncg == 1;
    RingSeg g;
    g.r0 = seg == 2 || seg == 4 || seg == 5 ? -1
         : seg == 3 || seg == 6 || seg == 7 ? h : 0;
    g.c0 = seg == 0 || seg == 4 || seg == 6 ? -1
         : seg == 1 || seg == 5 || seg == 7 ? w : 0;
    g.count = seg < 2 ? h : seg < 4 ? w : 1;
    if (seg < 2 && col_corners) g.r0 = -1, g.count = h + 2;
    if ((seg == 2 || seg == 3) && row_corners) g.c0 = -1, g.count = w + 2;
    if (seg >= 4 && (col_corners || row_corners)) g.count = 0;
    g.dr = seg < 2 ? 1 : 0;
    g.dc = seg == 2 || seg == 3 ? 1 : 0;
    // Every cell of a segment has one owner: its middle cell's.
    g.owner = shift_owner(s, wrap(o.y0 + g.r0 + g.dr * (g.count / 2), ny),
                          wrap(o.x0 + g.c0 + g.dc * (g.count / 2), nx));
    // A column side where the column groups are more than one (corners
    // too), else a row.
    const bool col = (g.c0 < 0 || g.c0 == w) && (s.ncg > 1 || seg < 2);
    g.side = col ? (g.c0 < 0 ? kColE : kColW) : (g.r0 < 0 ? kRowN : kRowS);
    g.group = col ? group_of(wrap(o.x0 + g.c0, nx) / ShiftGeo::TX, s.ncg,
                             a.tiles_x)
                  : group_of(wrap(o.y0 + g.r0, ny) / ShiftGeo::TY, s.nrg,
                             a.n_tiles / a.tiles_x);
    return g;
}

// Ring segment g of step k's buffer cur, by one warp: the speeds the
// block's cells pull from it and, on the forced row, the guard's 3, 6, 7.
// From the block's own cells where the lattice wraps inside the block;
// else, after lane 0's wait for the owner's counter, from the lattice a
// (step 0) or the edge slot of step k. A lane's work is a few additions a
// cell: the segment, its speeds and sources are worked out before the
// loop (one warp's index arithmetic, cell by cell, had held the step).
__device__ __forceinline__ void slab_ring(const Shift& s, const Slab& v,
                                          const RingSeg& g, float* cur,
                                          int k, int lane) {
    if (g.count == 0) return;
    const Args& a = s.r.args[0];
    const int ny = a.ny, nx = a.nx, P = v.P;
    const Rect& o = v.o;
    const bool mine = g.owner == (int)blockIdx.x;
    if (!mine && k > 0) {
        if (lane == 0) wait_steps(s.done, g.owner, k);
        __syncwarp();
    }
    // The own cells through registers; a neighbour's values (and the
    // lattice's at step 0) by asynchronous copies from global into shared
    // memory, waited for at the end: no register holds them, and no copy
    // waits for another (a load then a shared store a value, as the
    // compiler must order them, took 4 361 of a 14 094-cycle step at
    // 4096x64, and values held in registers spilled; PERF.md).
    const size_t plane = (size_t)ny * nx;
    const bool col = g.side == kColE || g.side == kColW;
    const int stride = col ? ny : nx;
    const bool guard = g.side != kColW;  // the west column's 3, 6, 7
    const float* sb = edge_at(s, k & 1, g.side, g.group, 0, 0);
    const float* fb = edge_at(s, k & 1, kForced, 0, 0, 0);
    const int d0 = edge_speed(g.side, 0) * P, d1 = edge_speed(g.side, 1) * P;
    const int d2 = edge_speed(g.side, 2) * P;
    for (int i = lane; i < g.count; i += 32) {
        const int rr = g.r0 + i * g.dr, c = g.c0 + i * g.dc;
        int gy = o.y0 + rr, gx = o.x0 + c;
        gy += gy < 0 ? ny : gy >= ny ? -ny : 0;
        gx += gx < 0 ? nx : gx >= nx ? -nx : 0;
        float* to = cur + slab_at(v.w2, rr, c);
        if (mine) {
            const int from = slab_at(v.w2, gy - o.y0, gx - o.x0);
            float val[9];
#pragma unroll
            for (int kk = 0; kk < 9; ++kk) val[kk] = cur[kk * P + from];
#pragma unroll
            for (int kk = 0; kk < 9; ++kk) to[kk * P] = val[kk];
        } else if (k == 0) {
            const float* at = a.src + (size_t)gy * nx + gx;
#pragma unroll
            for (int kk = 0; kk < 9; ++kk) {
                copy_async(to + kk * P, at + kk * plane);
            }
        } else {
            const float* from = sb + (col ? gy : gx);
            copy_async(to + d0, from);
            copy_async(to + d1, from + stride);
            copy_async(to + d2, from + 2 * stride);
            if (guard && gy == a.accel) {
                copy_async(to + 3 * P, fb + gx);
                copy_async(to + 6 * P, fb + nx + gx);
                copy_async(to + 7 * P, fb + 2 * nx + gx);
            }
        }
    }
    copy_async_wait();
}

// A barrier of the block's last kRimWarps warps alone (named barrier 1:
// __syncthreads is barrier 0).
constexpr int kRimWarps = 8;
__device__ __forceinline__ void rim_barrier() {
    asm volatile("bar.sync 1, %0;" ::"n"(kRimWarps * 32) : "memory");
}

// The shared residence's step loop: blocks of kSlabThreads threads, smem
// Shift::w2 * h2 planes (slab_bytes). One cell a thread at a time. The
// last kRimWarps warps (the rim group) wait for the neighbours, fill the
// ring, compute the rim (rows 0 and h - 1, columns 0 and w - 1: the cells
// that pull from the ring), publish its edges and release the step, each
// part behind a barrier of the group alone, while the other warps compute
// the interior (rows 1 .. h - 2, columns 1 .. w - 2), which pulls nothing
// from the ring; one block barrier a step, after both. So the rim, the
// step's critical path from a neighbour's release to this block's, runs
// beside the interior and not after it.
template <int kMode>
__device__ __forceinline__ void shift_shared_steps(const Shift& s,
                                                   const Rect& o,
                                                   float* smem) {
    const Resident& r = s.r;
    const Args& a = r.args[0];
    const int ny = a.ny, nx = a.nx, n = a.n_tiles, G = r.gsteps;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int kWarps = kSlabThreads / 32;
    constexpr int kInner = (kWarps - kRimWarps) * 32;
    constexpr int kSums = ShiftGeo::kOwnWarps;
    const int P = s.w2 * s.h2;
    const int w = o.x1 - o.x0, h = o.y1 - o.y0;
    const int ntc = o.tc1 - o.tc0, ntiles = ntc * (o.tr1 - o.tr0);
    const size_t plane = (size_t)ny * nx;
    float* const buf0 = smem;
    float* const buf1 = smem + 9 * P;
    float* const ucell = smem + 18 * P;
    float* const wtot = ucell + 2 * s.tiles_cap * kTileCells;
    uint8_t* msk = reinterpret_cast<uint8_t*>(wtot + 2 * s.tiles_cap * kSums);
    // Zero the buffers and the cells' |u| (a ragged tile's missing cells
    // stay 0), then load the cells of step 0 and the mask of the cells and
    // the ring.
    for (int i = tid; i < 18 * P + 2 * s.tiles_cap * kTileCells;
         i += kSlabThreads) {
        smem[i] = 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < h * w; i += kSlabThreads) {
        const int rr = i / w, c = i - rr * w;
        const size_t at = (size_t)(o.y0 + rr) * nx + o.x0 + c;
        const int to = slab_at(s.w2, rr, c);
#pragma unroll
        for (int k = 0; k < 9; ++k) buf0[k * P + to] = a.src[k * plane + at];
    }
    for (int i = tid; i < (h + 2) * (w + 2); i += kSlabThreads) {
        const int rr = i / (w + 2) - 1, c = i % (w + 2) - 1;
        msk[slab_at(s.w2, rr, c)] =
            a.mask[(size_t)wrap(o.y0 + rr, ny) * nx + wrap(o.x0 + c, nx)];
    }
    __syncthreads();
    const int iw = w > 2 ? w - 2 : 0, ih = h > 2 ? h - 2 : 0;
    const int n_in = iw * ih, rows2 = h > 1 ? 2 : 1, sides = w > 1 ? 2 : 1;
    const int n_rim = h * w - n_in;
    const bool rim_group = warp >= kWarps - kRimWarps;
    // Each rim warp's ring segment, once a launch.
    __shared__ RingSeg segs[kRimWarps];
    if (rim_group && lane == 0) {
        segs[kWarps - 1 - warp] = ring_seg(s, o, w, h, kWarps - 1 - warp);
    }
    __syncthreads();
    auto tile_of = [&](int j) {
        return (o.tr0 + j / ntc) * a.tiles_x + o.tc0 + j % ntc;
    };
    // Step `step`'s tile partials: the 15 warp sums of each tile added in
    // order, by a thread a tile.
    auto add_tiles = [&](int step) {
        if (tid < ntiles) {
            const float* sums =
                wtot + ((step & 1) * s.tiles_cap + tid) * kSums;
            float tot = 0.0f;
#pragma unroll
            for (int ww = 0; ww < kSums; ++ww) tot += sums[ww];
            lbm_publish_partial(r.partials + (size_t)step * n + tile_of(tid),
                                tot);
        }
    };
    for (int k = 0; k < G; ++k) {
        float* const cur = (k & 1) ? buf1 : buf0;
        float* const nxt = (k & 1) ? buf0 : buf1;
        float* const uc = ucell + (k & 1) * s.tiles_cap * kTileCells;
        const Slab v{cur, nxt, msk, uc, P, s.w2, w, h, o};
        if (rim_group) {
            slab_ring(s, v, segs[kWarps - 1 - warp], cur, k, lane);
            rim_barrier();
            const int slot = k + 1 < G ? (k + 1) & 1 : -1;
            for (int q = tid - kInner; q < n_rim; q += kRimWarps * 32) {
                // No division on the critical path (rows2, sides: 1 or 2).
                int rr, c;
                if (q < rows2 * w) {
                    rr = q < w ? 0 : h - 1;
                    c = q < w ? q : q - w;
                } else {
                    const int t = q - rows2 * w;
                    rr = 1 + (sides == 2 ? t >> 1 : t);
                    c = sides == 2 && (t & 1) ? w - 1 : 0;
                }
                slab_cell<kMode, true>(s, v, rr, c, slot);
            }
            // The group's edge stores, then one release for all of them.
            rim_barrier();
            if (tid == kInner && k + 1 < G) {
                release_steps(s.done, blockIdx.x);
            }
        } else {
            for (int q = tid; q < n_in; q += kInner) {
                slab_cell<kMode, false>(s, v, 1 + q / iw, 1 + q % iw, -1);
            }
        }
        __syncthreads();
        if (k > 0) add_tiles(k - 1);
        // The step's depth-tile warp sums, a warp each in turn of the
        // interior's (the rim group goes on to its next wait: 0.97x the
        // time): lane L of warp ww holds the depth map's quad 32 ww + L
        // (rows of 20, the first and last two the halo's, 0), its two
        // cells' |u| added.
        float* sums = wtot + (k & 1) * s.tiles_cap * kSums;
        for (int i = warp; !rim_group && i < ntiles * kSums;
             i += kWarps - kRimWarps) {
            const int j = i / kSums, vt = 32 * (i - j * kSums) + lane;
            const int qr = vt / ShiftGeo::NQ;
            const int qc = vt - qr * ShiftGeo::NQ - ShiftGeo::HX / 2;
            const float* cell = uc + j * kTileCells + qr * ShiftGeo::TX + 2 * qc;
            const float u = qc >= 0 && qc < kShiftQuadsX ? cell[0] + cell[1]
                                                         : 0.0f;
            const float sum = lbm_warp_sum(u);
            if (lane == 0) sums[i] = sum;
        }
    }
    __syncthreads();
    add_tiles(G - 1);
    // The cells of step G into the buffer the contract names.
    const float* fin = (G & 1) ? buf1 : buf0;
    float* out = (G & 1) ? a.dst : const_cast<float*>(a.src);
    for (int i = tid; i < h * w; i += kSlabThreads) {
        const int rr = i / w, c = i - rr * w;
        const size_t at = (size_t)(o.y0 + rr) * nx + o.x0 + c;
        const int from = slab_at(s.w2, rr, c);
#pragma unroll
        for (int k = 0; k < 9; ++k) out[k * plane + at] = fin[k * P + from];
    }
}

// The shift mode's kernel body (row mode only: JAX has no shift mode in
// column mode): the block's steps in its residence, one grid barrier, each
// step's partials summed in tile order, the step counter left at zero.
template <int kMode, bool kShared>
__device__ __forceinline__ void shift_block(const Shift& s, float* smem) {
    const Resident& r = s.r;
    const int n = r.args[0].n_tiles;
    if ((int)blockIdx.x < s.ncg * s.nrg) {
        const Rect o = shift_rect(s, blockIdx.x);
        if constexpr (kShared) {
            shift_shared_steps<kMode>(s, o, smem);
        } else {
            shift_device_steps<kMode>(s, o);
        }
    }
    cooperative_groups::this_grid().sync();
    for (int st = blockIdx.x; st < r.gsteps; st += gridDim.x) {
        lbm_sum_rows<1>(r.partials + (size_t)st * n, nullptr, n, r.scale,
                        r.out + st, threadIdx.x);
        __syncthreads();
    }
    // Every wait of the launch is behind the grid barrier.
    if (threadIdx.x == 0) s.done[blockIdx.x] = 0u;
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

// The cooperative launch of kernel fn over blocks blocks with its one
// parameter r (a Resident, or mxu_eq.cu's MxuResident). A launch of more
// blocks than can be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge).
template <class Params>
inline cudaError_t launch_rounds(const void* fn, int threads, size_t bytes,
                                 Params r, int blocks, int device,
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
