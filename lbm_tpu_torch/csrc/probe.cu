// The stream-cost probe: G variant-steps of a D2Q9 lattice per launch in
// one persistent kernel, in one of three modes, on a CUDA device (sm_90a).
//
// Replaces the TPU kernel scripts/stream_cost_probe.py::_probe_call: the
// resident stepping kernel without forcing, periodic in both directions,
// ping-ponging between two lattice buffers, with a (G,) vector of per-step
// totals, built to split a step's time between its two halves:
//
//   full     pull streaming, then bounce-back and BGK collision (what
//            the resident kernel runs when no row is forced); total: the sum of
//            |u| over fluid cells;
//   collide  the same update of each cell from its own nine speeds, no
//            streaming (an obstacle bounces its own speeds); same total;
//   stream   the pulled speeds copied through, no collision, the mask
//            unread; total: the sum of speed 0 over all cells.
//
// collide and stream are wrong physics on purpose (values stay bounded:
// relaxation converges, streaming permutes). On the TPU the three differ
// in vector operations on a lattice held in VMEM. Here the lattice stays
// in device memory (L2 keeps what fits), so what the modes separate is the
// eight shifted, partly unaligned plane loads of pull streaming (stream,
// and full - collide) from the arithmetic of the collision (collide, whose
// nine loads are aligned and coalesced).
//
// What bounds it: 37 B read (36 in stream mode) and 36 B written per cell
// and step, plus one grid-wide barrier per step: a pass a step, the
// structure the device-memory resident form had before it stepped rounds
// of depth tiles (PERF.md), so that the modes compare: a cooperative
// launch of co-resident 32x8 blocks, a grid-stride loop over 32x8 tiles per
// step, grid.sync(), per-step block partials reduced in a fixed
// shared-memory tree and summed in a fixed order after the last barrier
// (no float atomics: repeat runs are bit-identical). The mode is a template
// parameter: the three kernels differ only in the per-cell body, and full
// and collide are lbm_cell.cuh's update, called with no forced line and,
// for collide, with every neighbour index the cell's own.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/probe.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;
constexpr int kMaxPerSm = 4;  // the barrier's cost grows with blocks

constexpr int kFull = 0;
constexpr int kCollide = 1;
constexpr int kStream = 2;

// a, b and partials are written and then read by other blocks after a
// grid.sync(), so they carry no __restrict__.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
probe_kernel(float* a, float* b, const uint8_t* __restrict__ mask,
             float* partials, float* __restrict__ out, int ny, int nx,
             float omega, int assoc, int gsteps) {
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
            const size_t rc = (size_t)j * nx, ic = (size_t)i;
            float cell[9];
            if constexpr (kMode == kCollide) {
                acc += lbm_cell_update<false, size_t>(
                    ld, solid, rc, rc, rc, ic, ic, ic, false, false, false,
                    0.0f, 0.0f, omega, assoc, cell);
            } else {
                const size_t rm = (size_t)((j == 0) ? ny - 1 : j - 1) * nx;
                const size_t rp = (size_t)((j == ny - 1) ? 0 : j + 1) * nx;
                const size_t iw = (size_t)((i == 0) ? nx - 1 : i - 1);
                const size_t ie = (size_t)((i == nx - 1) ? 0 : i + 1);
                if constexpr (kMode == kFull) {
                    acc += lbm_cell_update<false, size_t>(
                        ld, solid, rc, rm, rp, ic, iw, ie, false, false,
                        false, 0.0f, 0.0f, omega, assoc, cell);
                } else {
                    // The pulls of lbm_cell_update, copied through.
                    cell[0] = ld(0, rc + ic);
                    cell[1] = ld(1, rc + iw);
                    cell[2] = ld(2, rm + ic);
                    cell[3] = ld(3, rc + ie);
                    cell[4] = ld(4, rp + ic);
                    cell[5] = ld(5, rm + iw);
                    cell[6] = ld(6, rm + ie);
                    cell[7] = ld(7, rp + ie);
                    cell[8] = ld(8, rp + iw);
                    acc += cell[0];
                }
            }
#pragma unroll
            for (int k = 0; k < 9; ++k) dst[k * plane + rc + ic] = cell[k];
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
        if (tid == 0) out[s] = red[0];
        __syncthreads();
    }
}

const void* probe_fn(int probe_mode) {
    switch (probe_mode) {
        case kFull: return (const void*)probe_kernel<kFull>;
        case kCollide: return (const void*)probe_kernel<kCollide>;
        case kStream: return (const void*)probe_kernel<kStream>;
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on this device for an ny x nx lattice
// in probe mode 0 (full), 1 (collide) or 2 (stream): as many as can be
// co-resident, at most four an SM and one per 32x8 tile. Negative: a CUDA
// error code, negated.
int lbm_probe_blocks(int ny, int nx, int probe_mode, int device) {
    const void* fn = probe_fn(probe_mode);
    if (fn == nullptr) return -(int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return -(int)err;
    if (!coop) return -(int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        0);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm > kMaxPerSm) per_sm = kMaxPerSm;
    const long long tiles =
        (long long)((nx + kBX - 1) / kBX) * ((ny + kBY - 1) / kBY);
    const long long blocks = (long long)per_sm * sms;
    if (blocks < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    return (int)(blocks < tiles ? blocks : tiles);
}

// gsteps (even) variant-steps ping-ponging a -> b -> a ...; the result is
// in a. partials holds gsteps * blocks floats, out gsteps; out[s] is step
// s's total. assoc is the BGK association (lbm_cell.cuh's mode); blocks
// comes from lbm_probe_blocks for the same probe mode.
int lbm_probe(float* a, float* b, const uint8_t* mask, float* partials,
              float* out, int ny, int nx, float omega, int assoc, int gsteps,
              int probe_mode, int blocks, int device, void* stream) {
    const void* fn = probe_fn(probe_mode);
    if (fn == nullptr || gsteps < 2 || gsteps % 2 || blocks < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&a,  &b,  &mask,  &partials, &out,
                    &ny, &nx, &omega, &assoc,    &gsteps};
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBX, kBY), args,
                                      0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
