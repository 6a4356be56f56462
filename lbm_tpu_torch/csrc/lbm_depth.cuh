// The depth kernel's tile (fused_depth.cu): D D2Q9 BGK steps of a 32 x TY
// tile of the lattice on a window of all nine speeds and the mask in
// dynamic shared memory. Shared by the depth kernel, one block a tile, and
// the ring (ring.cu), the device-memory resident form (resident.cu), the
// stream-cost probe (probe.cu) and the tensor-core equilibrium's kernel
// (mxu_eq.cu), whose persistent blocks run many tiles a launch: all but the
// last give a cell and a step's per-tile partial the same bits.
// fused_depth.cu's header comment describes the window, the threads and
// the stages.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_reduce.cuh"

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

// The tile and window of depth D. D = 1, 2 and 4 share TX, TY and HX
// (and with them the thread of every owned cell; D = 1 runs only in
// resident.cu).
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

// Opt a kernel of depth-kernel blocks (ring.cu, resident.cu) into the
// card's limit of dynamic shared memory, less its static shared memory.
// The attribute is the function's, shared by every launch of it: set to
// one launch's size it would make another's larger launch fail.
inline cudaError_t depth_opt_in(const void* fn, int device) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)attr.sharedSizeBytes);
}

// Tiles along x and in all of an ny x nx lattice at this depth, 0 where
// the count is too large for the partials' index.
inline void depth_tiles(int depth, int ny, int nx, int* tiles_x,
                        int* n_tiles) {
    const int ty = depth == 8 ? Geo<8, 2>::TY : Geo<4, 2>::TY;
    const long long tx = (nx + Geo<4, 2>::TX - 1) / Geo<4, 2>::TX;
    const long long n = tx * ((ny + ty - 1) / ty);
    *tiles_x = (int)tx;
    *n_tiles = n > INT_MAX / 8 ? 0 : (int)n;
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

// The stage body of a tile, a compile-time parameter: the step every
// kernel runs, the two variants of it that the stream-cost probe
// (probe.cu) times under the same window load, stages, barriers, partials
// and stores, and the step with its equilibrium on the tensor cores
// (mxu_eq.cu).
//   kStageFull     pull streaming, forcing of the copies pulled from the
//                  forced line, bounce-back, BGK; partial: owned fluid |u|;
//   kStageCollide  bounce-back and BGK of each cell's own nine speeds, read
//                  at its own window site (no streaming, no forced line);
//                  the same partial;
//   kStageStream   the pulled speeds copied through (no collision, the
//                  mask unread); partial: speed 0 of every owned cell;
//   kStageMxu      kStageFull's pull and forcing, the nine equilibria as a
//                  (9, 6) x (6, N) product on the tensor cores (below), the
//                  relaxation s + omega (feq - s) (ops/mxu_eq.py's, the
//                  reference order's), bounce-back; the same partial. Row
//                  mode only; one more block barrier a stage.
constexpr int kStageFull = 0;
constexpr int kStageCollide = 1;
constexpr int kStageStream = 2;
constexpr int kStageMxu = 3;

// kStageMxu's equilibria. With phi = [rho, rho ux, rho uy, rho ux^2,
// rho uy^2, rho ux uy], a cell's nine feq are W phi, W the (9, 6) map of
// ops/mxu_eq.py's equilibrium_matrix in float32. A warp forms them for its
// cells as products D = A B of mma.m16n8k8 in f64 on the tensor cores
// (DMMA), one for each 8 of its cells: A is W padded to 16 x 8 (speeds x
// features), B the 8 cells' features (features x cells), both exact in
// f64; D their equilibria (speeds x cells), each rounded once to f32. The
// products and sums in f64 err by ~2^-50 (the card's f64 product equals a
// sequential fma in k order), so a cell's feq is within half an f32 ulp of
// W phi: the f32-faithful counterpart of JAX's Precision.HIGHEST. 3xTF32 on
// the f32 tensor path (2^-20 of |W| |phi| from exact, its sums rounded
// toward zero) took the 1024^2 scene 0.46 % from its golden in 20000
// steps, over the 0.3 % budget (PERF.md; scripts/mma_rounding_torch.py,
// scripts/mxu_ab_torch.py).
// The fragments follow the PTX ISA's layout of m16n8k8, with lane = 4 g +
// t: A's registers a0..a3 hold (row, column) (g, t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4); B's b0, b1 hold (t, g), (t + 4, g); D's d0..d3 hold
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
//
// A is a constant: W by register and lane (ops/mxu_eq.py's a_fragments),
// 4 x 32 doubles behind the window in the block's dynamic shared memory
// (kMxuTable). B and D go through the warp's scratch in the stage's
// output buffer, which no thread reads during the stage: plane p of the
// warp's cell c (2 lane + i for its cell i) at mxu_slot(p, c, P), P the
// warp's cells (64; the last warp of a depth-2 or depth-1 window fewer).
// The owners store their phi planes, each lane loads its B registers, and
// D's rows 0..8 are stored over them as feq planes, which the owners load.
// A wrong lane map shows on the CPU: ops/mxu_eq.py's mxu_device_emulated
// runs these maps.

// Floats from the start of a kStageMxu block's dynamic shared memory to its
// A fragments, behind the depth-4 window (16-byte aligned): 4 x 32
// doubles, registers a0..a3, each by lane.
template <int V>
constexpr size_t kMxuTable = (Geo<4, V>::kBytes + 15) / 16 * 4;
constexpr int kMxuTableWords = 4 * 32 * 2;

// Plane p of cell c in a warp's scratch of P cells (a power of two),
// skewed by 8 cells a plane: the fragments' loads and stores fall on
// distinct banks.
__device__ __forceinline__ int mxu_slot(int p, int c, int P) {
    return p * P + ((c + 8 * p) & (P - 1));
}

// d = A B + d for one m16n8k8 f64 product; every lane of the warp runs it.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                       double b0, double b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// A warp's equilibria: its cells' phi (planes 0..5 of the scratch sc of P
// cells) in, their feq (planes 0..8) out. Every lane of the warp calls it.
__device__ __forceinline__ void mxu_warp_products(float* sc, int P,
                                                  const double* table) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    double a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = table[i * 32 + lane];
#pragma unroll
    for (int T = 0; T < 8; ++T) {
        if (8 * T >= P) break;  // the same for the whole warp
        // B: features t and t + 4 (none past 5) of the tile's cell g.
        const int c = 8 * T + g;
        const double b0 = sc[mxu_slot(t, c, P)];
        const double b1 = t < 2 ? sc[mxu_slot(t + 4, c, P)] : 0.0;
        double d[4] = {0.0, 0.0, 0.0, 0.0};
        mma_f64(d, a, b0, b1);
        // Speed g of the tile's cells 2t and 2t + 1; speed 8 from lane g = 0
        // (rows 9..15 are W's padding).
        const int e = 8 * T + 2 * t;
        *reinterpret_cast<float2*>(sc + mxu_slot(g, e, P)) =
            make_float2(__double2float_rn(d[0]), __double2float_rn(d[1]));
        if (g == 0) {
            *reinterpret_cast<float2*>(sc + mxu_slot(8, e, P)) =
                make_float2(__double2float_rn(d[2]), __double2float_rn(d[3]));
        }
    }
}

// One tile's D stages for a compile-time association kMode (lbm_cell.cuh's
// mode: the update's branches on it fold away) and stage body kStage
// (kStageFull everywhere but in the probe and mxu_eq.cu): load the tile's
// window from a.src (rows outside the lattice from a.halo in seam mode), run
// the stages in shared memory, store the tile into a.dst, and store the
// tile's partial of stage s (its owned fluid cells' |u|, summed by thread,
// warp, then warps in order) at rows[s * row_stride + tile]. Every thread
// of the block calls it; the block may call it again for another tile
// right away (the window's last reads are behind the last stage's
// barrier). buf_a: the window's dynamic shared memory, Geo<D, V>::kBytes.
template <int D, bool kSeam, bool kCols, int kMode,
          int kStage = kStageFull>
__device__ __forceinline__ void lbm_depth_tile(const Args& a, float* buf_a,
                                               int tile, float* rows,
                                               size_t row_stride) {
    constexpr int kV = kCellsPerThread<kCols>;
    using G = Geo<D, kV>;
    constexpr int TX = G::TX, TY = G::TY, HX = G::HX, NQ = G::NQ;
    constexpr int WW = G::W, WH = G::H, WC = G::C;
    float* buf_b = buf_a + 9 * WC;
    uint8_t* wmask = reinterpret_cast<uint8_t*>(buf_b + 9 * WC);
    __shared__ float warp_tot[D][G::kOwnWarps];

    const int ny = a.ny, nx = a.nx;
    const int tid = threadIdx.x;
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
            // Every load first, then the stores: a store to shared memory
            // between them would hold each load behind the last (the
            // compiler cannot tell that row does not point there).
            float v[9][kV];
            uint8_t m[kV];
#pragma unroll
            for (int k = 0; k < 9; ++k) load_vec(row + k * stride + x, v[k]);
            load_vec(mrow + x, m);
#pragma unroll
            for (int k = 0; k < 9; ++k) store_vec(buf_a + k * WC + base, v[k]);
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
        // The stage's new speeds of this thread's cells: into nxt, or at
        // stage D, whose needed region is the tile itself, into a.dst.
        auto store = [&](const float (&o)[9][kV]) {
            if (s < D) {
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    store_vec(nxt + k * WC + base, o[k]);
                }
            } else if (own) {
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
        };
        if constexpr (kStage == kStageMxu) {
            static_assert(!kCols, "the tensor-core stage runs in row mode");
            static_assert(((G::kQuads % 32) & (G::kQuads % 32 - 1)) == 0,
                          "a warp's scratch is a power of two of cells");
            // The pulled, forced speeds of the thread's cells and their
            // obstacle flags. Pulled twice, before and after the products
            // (the window is not written this stage): the 18 speeds are
            // not held across them.
            auto pull = [&](float (&sp)[kV][9], bool (&solid0)[kV]) {
                const float* at = cur + base;
                float q[9][kV];
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    const int dr = (k == 2 || k == 5 || k == 6) ? -WW
                                 : (k == 4 || k == 7 || k == 8) ? WW : 0;
                    load_vec(at + k * WC + dr, q[k]);
                }
                const float e1 = at[1 * WC - 1];
                const float e5 = at[5 * WC - WW - 1];
                const float e8 = at[8 * WC + WW - 1];
                const float e3 = at[3 * WC + kV];
                const float e6 = at[6 * WC - WW + kV];
                const float e7 = at[7 * WC + WW + kV];
                uint8_t m[kV];
                load_vec(wmask + base, m);
#pragma unroll
                for (int i = 0; i < kV; ++i) {
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
                    solid0[i] = m[i] != 0;
                    auto ld = [&](int k, Site t) -> float {
                        return t.tag == pull_tag(k) ? v[k]
                                                    : cur[k * WC + t.o];
                    };
                    auto solid = [&](Site t) -> bool {
                        return t.tag == 0 ? solid0[i] : wmask[t.o] != 0;
                    };
                    lbm_cell_pull<false, Site>(
                        ld, solid, Site{r * WW, 0}, Site{(r - 1) * WW, 3},
                        Site{(r + 1) * WW, 6}, Site{c0 + i, 0},
                        Site{c0 + i - 1, 1}, Site{c0 + i + 1, 2},
                        (fbits >> 1) & 1u, fbits & 1u, (fbits >> 2) & 1u, w1,
                        w2, sp[i]);
                }
            };
            float usq[kV] = {}, phi[6][kV] = {};
            if (active) {
                float sp[kV][9];
                bool solid0[kV];
                pull(sp, solid0);
#pragma unroll
                for (int i = 0; i < kV; ++i) {
                    const float* f = sp[i];
                    const float rho = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] +
                                      f[6] + f[7] + f[8];
                    const float u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7]))
                                      / rho;
                    const float u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8]))
                                      / rho;
                    usq[i] = u_x * u_x + u_y * u_y;
                    const float rux = rho * u_x, ruy = rho * u_y;
                    phi[0][i] = rho;
                    phi[1][i] = rux;
                    phi[2][i] = ruy;
                    phi[3][i] = rux * u_x;
                    phi[4][i] = ruy * u_y;
                    phi[5][i] = rux * u_y;
                }
            }
            // The warp's scratch: its cells' planes in nxt, which no thread
            // reads this stage (the last warp of a shallower window holds
            // fewer cells; warps with none skip, as do warps with no
            // active cell).
            const int warp = tid >> 5, lane = tid & 31;
            const int P = warp < G::kQuads / 32 ? 64 : 2 * (G::kQuads % 32);
            float* sc = nxt + 9 * 64 * warp;
            float feq[9][kV];
            if (__any_sync(0xffffffffu, active)) {
                if (has_quad) {
#pragma unroll
                    for (int p = 0; p < 6; ++p) {
                        *reinterpret_cast<float2*>(sc +
                                                   mxu_slot(p, 2 * lane, P)) =
                            make_float2(phi[p][0], phi[p][1]);
                    }
                }
                __syncwarp();
                mxu_warp_products(
                    sc, P,
                    reinterpret_cast<const double*>(buf_a + kMxuTable<kV>));
                __syncwarp();
                if (has_quad) {
#pragma unroll
                    for (int k = 0; k < 9; ++k) {
                        const float2 f = *reinterpret_cast<const float2*>(
                            sc + mxu_slot(k, 2 * lane, P));
                        feq[k][0] = f.x;
                        feq[k][1] = f.y;
                    }
                }
            }
            float o[9][kV];
            if (active) {
                float sp[kV][9];
                bool solid0[kV];
                pull(sp, solid0);
                const int opp[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
#pragma unroll
                for (int i = 0; i < kV; ++i) {
#pragma unroll
                    for (int k = 0; k < 9; ++k) {
                        o[k][i] = solid0[i] ? sp[i][opp[k]]
                                            : sp[i][k] +
                                                  omega * (feq[k][i] - sp[i][k]);
                    }
                    if ((own >> i) & 1u) {
                        acc += solid0[i] ? 0.0f : sqrtf(usq[i]);
                    }
                }
            }
            // Every warp's scratch is read by now; nxt takes the stage.
            if (s < D) __syncthreads();
            if (active) store(o);
        } else if (active) {
            const float* at = cur + base;
            // Each speed's quad from the row it is pulled from: k = 0, 1,
            // 3 from the cell's row, 2, 5, 6 from the row below, 4, 7, 8
            // from the row above.
            float q[9][kV];
            if constexpr (kStage == kStageCollide) {
                // No streaming: each speed's quad from the cell's own row.
#pragma unroll
                for (int k = 0; k < 9; ++k) load_vec(at + k * WC, q[k]);
            } else {
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    const int dr = (k == 2 || k == 5 || k == 6) ? -WW
                                 : (k == 4 || k == 7 || k == 8) ? WW : 0;
                    load_vec(at + k * WC + dr, q[k]);
                }
            }
            // Speeds 1, 5, 8 are pulled from x - 1, speeds 3, 6, 7 from
            // x + 1: one more float each (the collide body reads none, and
            // the stream body no mask: the compiler drops unread loads).
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
                if constexpr (kStage == kStageCollide) {
                    // The cell's own nine speeds and obstacle flag; no
                    // forced line, so the update reads nothing else.
                    float v[9], out[9];
#pragma unroll
                    for (int k = 0; k < 9; ++k) v[k] = q[k][i];
                    const bool solid0 = m[i] != 0;
                    const float um = lbm_cell_update<kCols, int>(
                        [&](int k, int) { return v[k]; },
                        [&](int) { return solid0; }, 0, 0, 0, 0, 0, 0,
                        false, false, false, w1, w2, omega, kMode, out);
                    if ((own >> i) & 1u) acc += um;
#pragma unroll
                    for (int k = 0; k < 9; ++k) o[k][i] = out[k];
                    continue;
                }
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
                if constexpr (kStage == kStageStream) {
                    if ((own >> i) & 1u) acc += v[0];
#pragma unroll
                    for (int k = 0; k < 9; ++k) o[k][i] = v[k];
                    continue;
                }
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
            store(o);
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
        lbm_publish_partial(rows + (size_t)tid * row_stride + tile, tot);
    }
}
