// D D2Q9 BGK timesteps per pass over device memory (D = 2, 4 or 8), on a
// CUDA device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_fused.py::_kernel_fused
// (launched by _pallas_step_fused): temporal blocking, where each block
// loads a window of the lattice, runs D steps on it on chip, and writes
// its tile once, so device-memory bytes per step fall by about D. tot_u
// counts owned cells only, one value per stage, so per-step av_vels stay
// exact.
//
// What bounds it: one-step-per-pass (fused_step.cu) moves 73 B per
// cell-step and is memory-bound. Here a pass moves the window in (37 B a
// cell, the window is larger than the tile) and the tile out (36 B a cell)
// for D steps, and the on-chip work grows with the recomputed halo. The
// design:
//
// - A block owns a TX x TY output tile and loads the (TX+2D) x (TY+2D)
//   window of all 9 speeds and the mask into dynamic shared memory, with
//   periodic indices (so a grid smaller than one window simply repeats
//   cells, each computed consistently). The TPU kernel's full-lane row
//   blocks do not fit here: a 1024-wide 9-speed row stack is 36 KB a row,
//   so x is tiled too and gets its own D-wide halo.
// - Stage s (1..D) runs lbm_cell.cuh's update over the window shrunk by s
//   cells on each side, from one shared buffer into the other; its
//   neighbours lie in stage s-1's region. Stage D's region is exactly the
//   tile, and it stores straight to device memory.
// - Forcing needs no special case at window edges or in the halo: each
//   window row knows whether its global row is the forced row, and the
//   cell update forces the pulled copy from that row at every stage.
// - Each stage's owned, in-grid |u| is reduced by a fixed shared-memory
//   tree into partials[s][block]; lbm_reduce_tot (fused_step.cu) then sums
//   each stage's row of partials in a fixed order. No float atomics.
// - Seam mode (a shard of a row-sharded lattice, the twin of
//   _kernel_fused(seam=True)): the lattice is the shard's h rows, and the
//   window rows outside them load from D-row halo buffers that the caller
//   filled from the neighbouring shards. Forcing is by global row index at
//   every stage. Tiles in the shard's interior are unchanged.
// - Column mode (kCols, the transposed lattice of a wide grid: the lane
//   forcing of _kernel_fused, lbm_tpu/ops/pallas_fused.py:804-813,
//   829-833), in periodic and in seam mode: a flag per window column
//   (fcol, in place of frow: the flags take W bytes instead of H) marks
//   the forced column, and every stage forces the copies pulled from it,
//   in the window's x-halo columns too.
// - Tile shapes keep both shared buffers near 92-110 KB, so two blocks fit
//   an SM (227 KB), each of 512 threads (40 registers): 9-13 % faster per
//   step than 256 threads on the H100 (PERF.md).
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/fused_depth.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

// Periodic index: v mod n in [0, n), for any int v.
__device__ __forceinline__ int wrap(int v, int n) {
    const int m = v % n;
    return m < 0 ? m + n : m;
}

template <int D> struct Tile;
template <> struct Tile<2> { static constexpr int X = 32, Y = 32; };
template <> struct Tile<4> { static constexpr int X = 32, Y = 24; };
template <> struct Tile<8> { static constexpr int X = 32, Y = 16; };

template <int D, bool kCols>
struct Window {
    static constexpr int W = Tile<D>::X + 2 * D;
    static constexpr int H = Tile<D>::Y + 2 * D;
    static constexpr int C = W * H;
    // Two 9-speed float buffers, the mask, and a forced-line flag per row
    // (or, in column mode, per column).
    static constexpr size_t kBytes = 2 * 9 * (size_t)C * sizeof(float) +
                                     (size_t)C + (size_t)(kCols ? W : H);
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

template <int D, bool kSeam, bool kCols>
__global__ void __launch_bounds__(kThreads)
fused_depth_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ partials, int ny, int nx, int accel,
                   float w1, float w2, float omega, int mode, Halo halo) {
    constexpr int TX = Tile<D>::X, TY = Tile<D>::Y;
    constexpr int WW = Window<D, kCols>::W, WH = Window<D, kCols>::H;
    constexpr int WC = Window<D, kCols>::C;
    extern __shared__ float smem[];
    float* buf_a = smem;
    float* buf_b = smem + 9 * WC;
    uint8_t* wmask = reinterpret_cast<uint8_t*>(smem + 18 * WC);
    // frow[r]: window row r is the forced row; fcol[c], in column mode:
    // window column c is the forced column.
    uint8_t* flags = wmask + WC;
    __shared__ float red[kThreads];

    const int tid = threadIdx.x;
    const int n_blocks = gridDim.x * gridDim.y;
    const int block = blockIdx.y * gridDim.x + blockIdx.x;
    // Global coordinates of window cell (0, 0); negative near the origin.
    const int y0 = blockIdx.y * TY - D;
    const int x0 = blockIdx.x * TX - D;
    const size_t plane = (size_t)ny * (size_t)nx;

    for (int idx = tid; idx < WC; idx += kThreads) {
        const int r = idx / WW, c = idx - r * WW;
        const int x = wrap(x0 + c, nx), y = y0 + r;
        if (!kSeam || (y >= 0 && y < ny)) {
            const size_t o = (size_t)wrap(y, ny) * nx + x;
#pragma unroll
            for (int k = 0; k < 9; ++k) buf_a[k * WC + idx] = src[k * plane + o];
            wmask[idx] = mask[o];
        } else {
            // Out-of-shard rows come from the halos. Rows past the north
            // halo (a ragged last tile) feed no owned cell within D
            // stages; they repeat its last row.
            const bool south = y < 0;
            const int hr = south ? halo.k + y : min(y - ny, halo.k - 1);
            const size_t o = (size_t)hr * nx + x, hplane = (size_t)halo.k * nx;
            const float* hs = south ? halo.s : halo.n;
#pragma unroll
            for (int k = 0; k < 9; ++k) buf_a[k * WC + idx] = hs[k * hplane + o];
            wmask[idx] = (south ? halo.mask_s : halo.mask_n)[o];
        }
    }
    if constexpr (kCols) {
        for (int c = tid; c < WW; c += kThreads) {
            flags[c] = wrap(x0 + c, nx) == accel;
        }
    } else {
        // Forced rows by global index: row0 = 0 and ny_global = ny when
        // periodic.
        for (int r = tid; r < WH; r += kThreads) {
            flags[r] = wrap(halo.row0 + y0 + r, halo.ny_global) == accel;
        }
    }
    __syncthreads();

    auto solid = [&](int o) { return wmask[o] != 0; };
    const float* cur = buf_a;
    float* nxt = buf_b;
#pragma unroll 1
    for (int s = 1; s <= D; ++s) {
        const int rw = WW - 2 * s, rh = WH - 2 * s;
        auto ld = [&](int k, int o) { return cur[k * WC + o]; };
        float acc = 0.0f;
        // Walk the region's cells tid, tid + kThreads, ... in row-major
        // order, stepping (row, col) without a division per cell.
        const int step_r = kThreads / rw, step_c = kThreads % rw;
        int r = tid / rw + s, c = tid % rw + s;
        for (; r < s + rh; r += step_r, c += step_c) {
            if (c >= s + rw) {
                c -= rw;
                if (++r >= s + rh) break;
            }
            float out[9];
            const int l = kCols ? c : r;  // the cell's line in flags
            const float um = lbm_cell_update<kCols, int>(
                ld, solid, r * WW, (r - 1) * WW, (r + 1) * WW, c, c - 1,
                c + 1, flags[l] != 0, flags[l - 1] != 0, flags[l + 1] != 0,
                w1, w2, omega, mode, out);
            // Owned: inside the tile (rows/cols D..D+T-1 of the window)
            // and inside the grid (a ragged last tile overhangs it).
            const int gy = y0 + r, gx = x0 + c;
            const bool owned = r >= D && r < D + TY && c >= D && c < D + TX &&
                               gy < ny && gx < nx;
            if (owned) acc += um;
            if (s < D) {
#pragma unroll
                for (int k = 0; k < 9; ++k) nxt[k * WC + r * WW + c] = out[k];
            } else if (owned) {
                // Stage D's region is the tile itself.
                const size_t o = (size_t)gy * nx + gx;
#pragma unroll
                for (int k = 0; k < 9; ++k) dst[k * plane + o] = out[k];
            }
        }
        red[tid] = acc;
        lbm_tree_sum<kThreads>(red, tid);  // also orders nxt's writes
        if (tid == 0) partials[(size_t)(s - 1) * n_blocks + block] = red[0];
        const float* t = cur;
        cur = nxt;
        nxt = const_cast<float*>(t);
    }
}

dim3 depth_grid(int depth, int ny, int nx) {
    int tx, ty;
    switch (depth) {
        case 2: tx = Tile<2>::X; ty = Tile<2>::Y; break;
        case 4: tx = Tile<4>::X; ty = Tile<4>::Y; break;
        default: tx = Tile<8>::X; ty = Tile<8>::Y; break;
    }
    return dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty);
}

template <int D, bool kSeam, bool kCols>
cudaError_t launch(const float* src, float* dst, const uint8_t* mask,
                   float* partials, int ny, int nx, int accel, float w1,
                   float w2, float omega, int mode, const Halo& halo,
                   int device, cudaStream_t stream) {
    // Above 48 KB, dynamic shared memory needs an opt-in, once per device.
    static bool opted_in[kMaxDevices] = {};
    const size_t bytes = Window<D, kCols>::kBytes;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            fused_depth_kernel<D, kSeam, kCols>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
        opted_in[device] = true;
    }
    fused_depth_kernel<D, kSeam, kCols>
        <<<depth_grid(D, ny, nx), kThreads, bytes, stream>>>(
            src, dst, mask, partials, ny, nx, accel, w1, w2, omega, mode,
            halo);
    return cudaGetLastError();
}

template <int D, bool kSeam>
cudaError_t launch_axis(const float* src, float* dst, const uint8_t* mask,
                        float* partials, int ny, int nx, int accel, float w1,
                        float w2, float omega, int mode, int axis,
                        const Halo& halo, int device, cudaStream_t stream) {
    if (axis) {
        return launch<D, kSeam, true>(src, dst, mask, partials, ny, nx, accel,
                                      w1, w2, omega, mode, halo, device,
                                      stream);
    }
    return launch<D, kSeam, false>(src, dst, mask, partials, ny, nx, accel,
                                   w1, w2, omega, mode, halo, device, stream);
}

template <bool kSeam>
int launch_depth(const float* src, float* dst, const uint8_t* mask,
                 float* partials, int ny, int nx, int accel, float w1,
                 float w2, float omega, int mode, int depth, int axis,
                 const Halo& halo, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (depth) {
        case 2:
            return (int)launch_axis<2, kSeam>(src, dst, mask, partials, ny,
                                              nx, accel, w1, w2, omega, mode,
                                              axis, halo, device, s);
        case 4:
            return (int)launch_axis<4, kSeam>(src, dst, mask, partials, ny,
                                              nx, accel, w1, w2, omega, mode,
                                              axis, halo, device, s);
        case 8:
            return (int)launch_axis<8, kSeam>(src, dst, mask, partials, ny,
                                              nx, accel, w1, w2, omega, mode,
                                              axis, halo, device, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Tot_u partials per stage (one per block) the depth kernel writes; it
// writes depth rows of them. 0 for a depth it does not take.
int lbm_depth_num_partials(int depth, int ny, int nx) {
    if (depth != 2 && depth != 4 && depth != 8) return 0;
    const dim3 g = depth_grid(depth, ny, nx);
    return (int)(g.x * g.y);
}

// Largest ny a launch at this depth accepts (grid y is at most 65535).
int lbm_depth_max_rows(int depth) {
    return depth == 2 ? 65535 * Tile<2>::Y
         : depth == 4 ? 65535 * Tile<4>::Y
                      : 65535 * Tile<8>::Y;
}

// dst = depth steps of src; partials[s * n + b] = block b's sum of owned
// fluid |u| in stage s, n = lbm_depth_num_partials(depth, ny, nx). axis 0
// forces row accel, axis 1 (a transposed lattice) column accel.
int lbm_fused_depth(const float* src, float* dst, const uint8_t* mask,
                    float* partials, int ny, int nx, int accel, float w1,
                    float w2, float omega, int mode, int depth, int axis,
                    int device, void* stream) {
    const Halo periodic{nullptr, nullptr, nullptr, nullptr, 0, 0, ny};
    return launch_depth<false>(src, dst, mask, partials, ny, nx, accel, w1,
                               w2, omega, mode, depth, axis, periodic, device,
                               stream);
}

// Seam mode: dst = depth steps of a shard's h rows src, out-of-shard rows
// from the k-row halos (k >= depth) halo_s / halo_n and their mask rows;
// row0 is the global index of the shard's first row and ny_global the
// global (padded) row count. partials as lbm_fused_depth with ny = h.
// axis 1: a shard of the transposed lattice; column nx-2 of every row is
// forced, halo rows included.
int lbm_fused_depth_seam(const float* src, float* dst, const uint8_t* mask,
                         const float* halo_s, const float* halo_n,
                         const uint8_t* hmask_s, const uint8_t* hmask_n,
                         int k, float* partials, int h, int nx, int row0,
                         int ny_global, float w1, float w2, float omega,
                         int mode, int depth, int axis, int device,
                         void* stream) {
    if (k < depth || h < 1 || ny_global < h) return (int)cudaErrorInvalidValue;
    const Halo halo{halo_s, halo_n, hmask_s, hmask_n, k, row0, ny_global};
    const int accel = axis ? (nx - 2) % nx : (ny_global - 2) % ny_global;
    return launch_depth<true>(src, dst, mask, partials, h, nx, accel, w1, w2,
                              omega, mode, depth, axis, halo, device, stream);
}

}  // extern "C"
