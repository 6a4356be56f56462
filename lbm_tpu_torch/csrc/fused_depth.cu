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
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/fused_depth.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_reduce.cuh"

namespace {

constexpr int kMaxDevices = 64;

// Periodic index: v mod n in [0, n), for any int v.
__device__ __forceinline__ int wrap(int v, int n) {
    const int m = v % n;
    return m < 0 ? m + n : m;
}

// Cells a thread updates per stage, V x-neighbours moved as one vector:
// two in row mode, four in column mode (the faster of the two in each).
template <bool kCols> constexpr int kCellsPerThread = kCols ? 4 : 2;

// The vector of V floats (mask bytes) and its unpacked form.
template <int V> struct Vec;
template <> struct Vec<4> {
    using F = float4;
    using M = uchar4;
    template <class T, class U>
    static __device__ __forceinline__ void unpack(const U& t, T (&v)[4]) {
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    }
    template <class T, class U>
    static __device__ __forceinline__ void pack(const T (&v)[4], U& t) {
        t.x = v[0], t.y = v[1], t.z = v[2], t.w = v[3];
    }
};
template <> struct Vec<2> {
    using F = float2;
    using M = uchar2;
    template <class T, class U>
    static __device__ __forceinline__ void unpack(const U& t, T (&v)[2]) {
        v[0] = t.x, v[1] = t.y;
    }
    template <class T, class U>
    static __device__ __forceinline__ void pack(const T (&v)[2], U& t) {
        t.x = v[0], t.y = v[1];
    }
};

// V floats (mask bytes) at p, p aligned to the vector.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
    Vec<V>::unpack(*reinterpret_cast<const typename Vec<V>::F*>(p), v);
}
template <int V>
__device__ __forceinline__ void load_vec(const uint8_t* p, uint8_t (&v)[V]) {
    Vec<V>::unpack(*reinterpret_cast<const typename Vec<V>::M*>(p), v);
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
    Vec<V>::pack(v, *reinterpret_cast<typename Vec<V>::F*>(p));
}
template <int V>
__device__ __forceinline__ void store_vec(uint8_t* p, const uint8_t (&v)[V]) {
    Vec<V>::pack(v, *reinterpret_cast<typename Vec<V>::M*>(p));
}

// The tile and window of depth D. D = 2 and D = 4 share TX, TY and HX
// (and with them the thread of every owned cell).
template <int D, int V>
struct Geo {
    static constexpr int TX = 32;
    static constexpr int TY = D == 8 ? 16 : 24;
    static constexpr int HX = D <= 4 ? 4 : 8;  // x halo, whole quads
    static constexpr int W = TX + 2 * HX;
    static constexpr int H = TY + 2 * D;
    static constexpr int C = W * H;
    static constexpr int NQ = W / V;           // quads a window row
    static constexpr int kQuads = NQ * H;
    static constexpr int kOwnQuads = NQ * TY;  // the tile's rows come first
    static constexpr int kThreads = (kQuads + 31) / 32 * 32;
    static constexpr int kOwnWarps = (kOwnQuads + 31) / 32;
    // Two 9-speed float buffers and the mask.
    static constexpr size_t kBytes = 2 * 9 * (size_t)C * sizeof(float) + C;
    static_assert(HX >= D && HX % V == 0 && TX % V == 0, "quad alignment");
    static_assert(kThreads >= kReduceWidth, "the epilogue's width");
};

// Halo inputs of the seam mode: k >= D rows on each side of a shard
// ((9, k, nx) speeds, (k, nx) obstacle rows), raw, as lbm_seam.cuh
// describes; the shard's first row has global index row0 of ny_global.
struct Halo {
    const float* s;
    const float* n;
    const uint8_t* mask_s;
    const uint8_t* mask_n;
    int k, row0, ny_global;
};

// One launch's arguments. partials holds D rows of one slot per tile,
// behind them the epilogue's block counter and behind that the D rows of
// partials as the epilogue read them (lbm_reduce.cuh);
// out[s] = scale * tot_u of step s. vec: nx is a multiple of 4 and every
// lattice pointer is 16-byte aligned, so a quad moves as one float4.
struct Args {
    const float* src;
    float* dst;
    const uint8_t* mask;
    float* partials;
    float scale;
    float* out;
    int ny, nx, accel;
    float w1, w2, omega;
    int mode;
    int tiles_x, n_tiles;
    bool vec;
    Halo halo;
};

// The epilogue's block counter: the word behind the D rows of slots.
template <int D>
__device__ __forceinline__ unsigned int* depth_counter(const Args& a) {
    return reinterpret_cast<unsigned int*>(a.partials +
                                           (size_t)D * a.n_tiles);
}

// A site of the window for lbm_cell_update: its offset in a speed plane
// and a tag that names it among the nine sites a cell pulls from (row tag
// 0 / 3 / 6 for the cell's own row, the one below, the one above, plus
// column tag 0 / 1 / 2 for its own column, west, east). After inlining
// the tags are constants, so a load of the speed a cell pulls from a site
// compiles to the register that holds it, and any other load (the forcing
// guard's) to a shared-memory read.
struct Site {
    int o, tag;
};
__device__ __forceinline__ Site operator+(Site a, Site b) {
    return Site{a.o + b.o, a.tag + b.tag};
}
// The tag of the site speed k is pulled from.
__device__ __forceinline__ constexpr int pull_tag(int k) {
    return k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 3 : k == 3 ? 2 : k == 4 ? 6
         : k == 5 ? 4 : k == 6 ? 5 : k == 7 ? 8 : 7;
}

// The tiles' stages for a compile-time association kMode (lbm_cell.cuh's
// mode: the update's branches on it fold away).
template <int D, bool kSeam, bool kCols, int kMode>
__device__ __forceinline__ void depth_block(const Args& a, float* buf_a) {
    constexpr int kV = kCellsPerThread<kCols>;
    using G = Geo<D, kV>;
    constexpr int TX = G::TX, TY = G::TY, HX = G::HX, NQ = G::NQ;
    constexpr int WW = G::W, WH = G::H, WC = G::C;
    float* buf_b = buf_a + 9 * WC;
    uint8_t* wmask = reinterpret_cast<uint8_t*>(buf_b + 9 * WC);
    __shared__ float warp_tot[D][G::kOwnWarps];
    // Where this block stands in the order of starting: asked here, read
    // after the stages (lbm_reduce.cuh).
    __shared__ unsigned int entered;
    if (threadIdx.x == 0) entered = lbm_block_enters(depth_counter<D>(a));

    const int ny = a.ny, nx = a.nx;
    const int tid = threadIdx.x;
    const int tile = blockIdx.x;
    const int by = tile / a.tiles_x, bx = tile - by * a.tiles_x;
    // Global coordinates of window cell (0, 0); negative near the origin.
    const int y0 = by * TY - D;
    const int x0 = bx * TX - HX;
    const size_t plane = (size_t)ny * (size_t)nx;

    // This thread's group of cells: window row r, columns c0 .. c0 + kV - 1.
    // The tile's rows first (r = D .. D + TY - 1), then the south halo
    // rows, then the north ones; threads past the last group only join
    // the barriers and the warp sums.
    const bool has_quad = tid < G::kQuads;
    const int qrow = has_quad ? tid / NQ : 0;
    const int c0 = kV * (has_quad ? tid - qrow * NQ : 0);
    const int r = qrow < TY ? qrow + D : (qrow < TY + D ? qrow - TY : qrow);
    const int base = r * WW + c0;

    // Load the window: this thread's quad of every speed and the mask.
    if (has_quad) {
        const int y = y0 + r;
        const float* row;
        const uint8_t* mrow;
        size_t stride;
        if (!kSeam || (y >= 0 && y < ny)) {
            const size_t o = (size_t)(kSeam ? y : wrap(y, ny)) * nx;
            row = a.src + o;
            mrow = a.mask + o;
            stride = plane;
        } else {
            // Out-of-shard rows come from the halos. Rows past the north
            // halo (a ragged last tile) feed no owned cell within D
            // stages; they repeat its last row.
            const bool south = y < 0;
            const int hr = south ? a.halo.k + y : min(y - ny, a.halo.k - 1);
            const size_t o = (size_t)hr * nx;
            row = (south ? a.halo.s : a.halo.n) + o;
            mrow = (south ? a.halo.mask_s : a.halo.mask_n) + o;
            stride = (size_t)a.halo.k * nx;
        }
        if (a.vec) {
            const int x = wrap(x0 + c0, nx);
            float v[kV];
            uint8_t m[kV];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                load_vec(row + k * stride + x, v);
                store_vec(buf_a + k * WC + base, v);
            }
            load_vec(mrow + x, m);
            store_vec(wmask + base, m);
        } else {
#pragma unroll
            for (int i = 0; i < kV; ++i) {
                const int x = wrap(x0 + c0 + i, nx);
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    buf_a[k * WC + base + i] = row[k * stride + x];
                }
                wmask[base + i] = mrow[x];
            }
        }
    }

    // Forced-line flags, bit j + 1 for line j of this thread: in row mode
    // the rows r - 1, r, r + 1 (j = -1, 0, 1; by global index: row0 = 0
    // and ny_global = ny when periodic), in column mode the columns
    // c0 - 1 .. c0 + kV (j = -1 .. kV).
    unsigned int fbits = 0;
    if constexpr (kCols) {
#pragma unroll
        for (int j = -1; j <= kV; ++j) {
            if (wrap(x0 + c0 + j, nx) == a.accel) fbits |= 1u << (j + 1);
        }
    } else {
#pragma unroll
        for (int j = -1; j <= 1; ++j) {
            if (wrap(a.halo.row0 + y0 + r + j, a.halo.ny_global) == a.accel) {
                fbits |= 1u << (j + 1);
            }
        }
    }
    // Owned cells of the quad (bit i): inside the tile and inside the
    // grid (a ragged last tile overhangs it).
    unsigned int own = 0;
    if (has_quad && qrow < TY && y0 + r < ny) {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
            const int c = c0 + i;
            if (c >= HX && c < HX + TX && x0 + c < nx) own |= 1u << i;
        }
    }
    __syncthreads();

    const float w1 = a.w1, w2 = a.w2, omega = a.omega;
    const float* cur = buf_a;
    float* nxt = buf_b;
#pragma unroll 1
    for (int s = 1; s <= D; ++s) {
        // The columns and rows stage s must produce: the window shrunk by
        // s rows a side, and in x the tile widened by D - s cells a side.
        const int lo = HX - D + s;
        const bool active = has_quad && r >= s && r < WH - s &&
                            c0 + kV - 1 >= lo && c0 < WW - lo;
        float acc = 0.0f;
        if (active) {
            const float* at = cur + base;
            // Each speed's quad from the row it is pulled from: k = 0, 1,
            // 3 from the cell's row, 2, 5, 6 from the row below, 4, 7, 8
            // from the row above.
            float q[9][kV];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int dr = (k == 2 || k == 5 || k == 6) ? -WW
                             : (k == 4 || k == 7 || k == 8) ? WW : 0;
                load_vec(at + k * WC + dr, q[k]);
            }
            // Speeds 1, 5, 8 are pulled from x - 1, speeds 3, 6, 7 from
            // x + 1: one more float each.
            const float e1 = at[1 * WC - 1];
            const float e5 = at[5 * WC - WW - 1];
            const float e8 = at[8 * WC + WW - 1];
            const float e3 = at[3 * WC + kV];
            const float e6 = at[6 * WC - WW + kV];
            const float e7 = at[7 * WC + WW + kV];
            uint8_t m[kV];
            load_vec(wmask + base, m);
            float o[9][kV];
#pragma unroll
            for (int i = 0; i < kV; ++i) {
                // The nine speeds cell i pulls, by speed.
                const int iw = i == 0 ? 0 : i - 1;
                const int ie = i == kV - 1 ? 0 : i + 1;
                const float v[9] = {
                    q[0][i],
                    i == 0 ? e1 : q[1][iw],
                    q[2][i],
                    i == kV - 1 ? e3 : q[3][ie],
                    q[4][i],
                    i == 0 ? e5 : q[5][iw],
                    i == kV - 1 ? e6 : q[6][ie],
                    i == kV - 1 ? e7 : q[7][ie],
                    i == 0 ? e8 : q[8][iw]};
                const bool solid0 = m[i] != 0;
                auto ld = [&](int k, Site t) -> float {
                    return t.tag == pull_tag(k) ? v[k]
                                                : cur[k * WC + t.o];
                };
                auto solid = [&](Site t) -> bool {
                    return t.tag == 0 ? solid0 : wmask[t.o] != 0;
                };
                // Line j's flag is bit j + 1.
                const bool f0 = (fbits >> (kCols ? i + 1 : 1)) & 1u;
                const bool f1 = (fbits >> (kCols ? i : 0)) & 1u;
                const bool f2 = (fbits >> (kCols ? i + 2 : 2)) & 1u;
                float out[9];
                const float um = lbm_cell_update<kCols, Site>(
                    ld, solid, Site{r * WW, 0}, Site{(r - 1) * WW, 3},
                    Site{(r + 1) * WW, 6}, Site{c0 + i, 0},
                    Site{c0 + i - 1, 1}, Site{c0 + i + 1, 2}, f0, f1, f2,
                    w1, w2, omega, kMode, out);
                if ((own >> i) & 1u) acc += um;
#pragma unroll
                for (int k = 0; k < 9; ++k) o[k][i] = out[k];
            }
            if (s < D) {
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    store_vec(nxt + k * WC + base, o[k]);
                }
            } else if (own) {
                // Stage D's needed region is the tile itself.
                float* to = a.dst + (size_t)(y0 + r) * nx + (x0 + c0);
                if (a.vec) {
#pragma unroll
                    for (int k = 0; k < 9; ++k) {
                        store_vec(to + k * plane, o[k]);
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < kV; ++i) {
                        if ((own >> i) & 1u) {
#pragma unroll
                            for (int k = 0; k < 9; ++k) {
                                to[k * plane + i] = o[k][i];
                            }
                        }
                    }
                }
            }
        }
        // The stage's sum over owned cells: per thread above, per warp
        // here, one slot a warp.
        if (tid < G::kOwnWarps * 32) {
            acc = lbm_warp_sum(acc);
            if ((tid & 31) == 0) warp_tot[s - 1][tid >> 5] = acc;
        }
        __syncthreads();  // the stage's one barrier: orders nxt's writes
        const float* t = cur;
        cur = nxt;
        nxt = const_cast<float*>(t);
    }
    if (tid < D) {
        float tot = 0.0f;
#pragma unroll
        for (int w = 0; w < G::kOwnWarps; ++w) tot += warp_tot[tid][w];
        lbm_publish_partial(a.partials + (size_t)tid * a.n_tiles + tile, tot);
    }
    lbm_last_block_sums<D>(a.partials, a.partials + (size_t)D * a.n_tiles + 1,
                           a.n_tiles, a.scale, a.out, depth_counter<D>(a),
                           entered, a.n_tiles, tid);
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

// Tiles along x and in all of an ny x nx lattice at this depth, 0 where
// the count is too large for the partials' index.
void depth_tiles(int depth, int ny, int nx, int* tiles_x, int* n_tiles) {
    const int ty = depth == 8 ? Geo<8, 2>::TY : Geo<4, 2>::TY;
    const long long tx = (nx + Geo<4, 2>::TX - 1) / Geo<4, 2>::TX;
    const long long n = tx * ((ny + ty - 1) / ty);
    *tiles_x = (int)tx;
    *n_tiles = n > INT_MAX / 8 ? 0 : (int)n;
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
