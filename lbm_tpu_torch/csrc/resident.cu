// G D2Q9 BGK timesteps per launch in one persistent kernel, on a CUDA
// device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_resident.py::_kernel_resident
// (launched by _pallas_resident): G whole timesteps per call, ping-ponging
// between two lattice buffers, with a (G,) vector of per-step tot_u. On the
// TPU the lattice lives in VMEM for the whole call. The H100 has nothing on
// chip that large (50 MB of L2; 1024x1024 is 37.7 MB a buffer), so here the
// two buffers stay in device memory (L2 keeps what fits) and what the
// kernel removes is the host: one launch runs G steps, with no per-step
// launch, reduce launch or host round trip.
//
// What bounds it: each step still reads 37 B and writes 36 B per cell, as
// fused_step.cu does, plus one grid-wide barrier per step. The design:
//
// - A cooperative launch (cudaLaunchCooperativeKernel) of exactly as many
//   32x8 blocks as can be co-resident (occupancy x SMs, at most four an
//   SM, capped at the number of 32x8 tiles), so cooperative_groups'
//   grid.sync() is legal.
// - Each step is a grid-stride loop over 32x8 tiles of lbm_cell.cuh
//   updates from one buffer into the other, then grid.sync(). Step s reads
//   a when s is even and b when odd: the result is in a after an even G,
//   in b after an odd G.
// - Column mode (kCols, the transposed lattice of a wide grid: lane_accel,
//   lbm_tpu/ops/pallas_resident.py:123-139, 196-251): the column accel of
//   every row is the forced line (lbm_cell.cuh), and the block count is
//   coprime with the tile columns. Block b takes tiles b, b + blocks, ...;
//   were the count a multiple of the tile columns (528 blocks over 8 at
//   1024x256), every tile of the forced column would go to the same few
//   blocks, which then hold each step's barrier back.
// - Forcing needs no in-place pass: the shared cell code forces the pulled
//   copy, as fused_step.cu does.
// - Each block reduces its |u| per step in a fixed shared-memory tree into
//   partials[s][block]. After the last barrier, block b sums the partials
//   of steps b, b + gridDim.x, ... in a fixed order and writes
//   scale * sum into out[s]. No float atomics, so repeat runs are
//   bit-identical.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/resident.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;
constexpr int kMaxPerSm = 4;

// a, b and partials are written and then read by other blocks after a
// grid.sync(), so they carry no __restrict__: that keeps the compiler off
// the non-coherent read-only load path for them.
template <bool kCols>
__global__ void __launch_bounds__(kThreads)
resident_kernel(float* a, float* b, const uint8_t* __restrict__ mask,
                float* partials, float* __restrict__ out,
                int ny, int nx, int accel, float w1, float w2,
                float omega, int mode, int gsteps, float scale) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float red[kThreads];
    const int tid = threadIdx.y * kBX + threadIdx.x;
    const int tiles_x = (nx + kBX - 1) / kBX;
    const int n_tiles = tiles_x * ((ny + kBY - 1) / kBY);
    const size_t plane = (size_t)ny * (size_t)nx;
    auto solid = [&](size_t o) { return mask[o] != 0; };

    for (int s = 0; s < gsteps; ++s) {
        const float* src = (s & 1) ? b : a;
        float* dst = (s & 1) ? a : b;
        auto ld = [&](int k, size_t o) { return src[k * plane + o]; };
        float acc = 0.0f;
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
            const int i = (tile % tiles_x) * kBX + threadIdx.x;
            const int j = (tile / tiles_x) * kBY + threadIdx.y;
            if (i >= nx || j >= ny) continue;
            const int jm = (j == 0) ? ny - 1 : j - 1;
            const int jp = (j == ny - 1) ? 0 : j + 1;
            const int iw = (i == 0) ? nx - 1 : i - 1;
            const int ie = (i == nx - 1) ? 0 : i + 1;
            const size_t rj = (size_t)j * nx;
            float cell[9];
            const bool f0 = kCols ? i == accel : j == accel;
            const bool f1 = kCols ? iw == accel : jm == accel;
            const bool f2 = kCols ? ie == accel : jp == accel;
            acc += lbm_cell_update<kCols, size_t>(
                ld, solid, rj, (size_t)jm * nx, (size_t)jp * nx, (size_t)i,
                (size_t)iw, (size_t)ie, f0, f1, f2, w1, w2, omega, mode, cell);
#pragma unroll
            for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = cell[k];
        }
        red[tid] = acc;
        lbm_tree_sum<kThreads>(red, tid);
        if (tid == 0) partials[(size_t)s * gridDim.x + blockIdx.x] = red[0];
        grid.sync();
    }

    for (int s = blockIdx.x; s < gsteps; s += gridDim.x) {
        float acc = 0.0f;
        for (int p = tid; p < (int)gridDim.x; p += kThreads) {
            acc += partials[(size_t)s * gridDim.x + p];
        }
        red[tid] = acc;
        lbm_tree_sum<kThreads>(red, tid);
        if (tid == 0) out[s] = red[0] * scale;
        __syncthreads();
    }
}

long long gcd(long long a, long long b) {
    while (b) {
        const long long t = a % b;
        a = b;
        b = t;
    }
    return a;
}

const void* resident_fn(int axis) {
    return axis ? (const void*)resident_kernel<true>
                : (const void*)resident_kernel<false>;
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on this device for an ny x nx lattice
// in forcing mode axis (0 rows, 1 columns): as many as can be co-resident,
// at most four an SM and one per 32x8 tile, and in column mode coprime
// with the tile columns. Negative: a CUDA error code, negated (no
// cooperative launch on this device is cudaErrorNotSupported).
int lbm_resident_blocks(int ny, int nx, int axis, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return -(int)err;
    if (!coop) return -(int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resident_fn(axis), kThreads, 0);
    if (err != cudaSuccess) return -(int)err;
    // At most kMaxPerSm blocks an SM: every block arrives at each step's
    // grid barrier, and its cost grows with them. The column mode's 40
    // registers would fit six (1.42x the row mode's time per step at
    // 1024x256 on an H100, PERF.md); the row mode's 64 fit four.
    if (per_sm > kMaxPerSm) per_sm = kMaxPerSm;
    const long long tiles =
        (long long)((nx + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY);
    const long long blocks = (long long)per_sm * sms;
    if (blocks < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    long long n = blocks < tiles ? blocks : tiles;
    if (axis) {
        // Coprime with the tile columns: the forced column's tiles spread
        // over every block.
        const long long tiles_x = (nx + kBX - 1) / kBX;
        while (n > 1 && gcd(n, tiles_x) != 1) --n;
    }
    return (int)n;
}

// gsteps steps ping-ponging a -> b -> a ...; the result is in a when gsteps
// is even, in b when odd. partials holds gsteps * blocks floats, out
// gsteps; out[s] = scale * step s's sum of fluid |u|. axis 0 forces row
// accel, axis 1 (a transposed lattice) column accel; blocks comes from
// lbm_resident_blocks for the same axis.
int lbm_resident(float* a, float* b, const uint8_t* mask, float* partials,
                 float* out, int ny, int nx, int accel, float w1, float w2,
                 float omega, int mode, int gsteps, float scale, int blocks,
                 int axis, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (gsteps < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    void* args[] = {&a,    &b,  &mask, &partials, &out,  &ny,
                    &nx,   &accel, &w1, &w2,      &omega, &mode,
                    &gsteps, &scale};
    err = cudaLaunchCooperativeKernel(resident_fn(axis), dim3(blocks),
                                      dim3(kBX, kBY), args, 0,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
