// The stream-cost probe: G variant-steps of a D2Q9 lattice per launch in
// one persistent kernel, in one of three modes, on a CUDA device (sm_90a).
//
// Replaces the TPU kernel scripts/stream_cost_probe.py::_probe_call: the
// resident stepping kernel without forcing, periodic in both directions,
// ping-ponging between two lattice buffers, with a (G,) vector of per-step
// totals, built to split a step's time between its two halves under an
// identical memory and loop structure, its modes differing only in the
// per-block stage body:
//
//   full     pull streaming, then bounce-back and BGK collision (what
//            the resident kernel runs when no row is forced); total: the
//            sum of |u| over fluid cells;
//   collide  the same update of each cell from its own nine speeds, no
//            streaming (an obstacle bounces its own speeds); same total;
//   stream   the pulled speeds copied through, no collision; total: the
//            sum of speed 0 over all cells.
//
// collide and stream are wrong physics on purpose (values stay bounded:
// relaxation converges, streaming permutes).
//
// The structure is the device-memory resident form's (resident.cu, whose
// header comment gives the design): a cooperative launch of depth-kernel
// blocks runs lbm_rounds.cuh's round loop, rounds of 4, 2 and 1 steps on
// the depth kernel's tiles drawn by ticket, one grid barrier a round, each
// step's partials summed in tile order after the last round. The stage body
// is lbm_depth_tile's kStage (lbm_depth.cuh): the window load of all nine
// speeds and the mask, the shrinking stages, the one barrier a stage, the
// owned-cell partials and the tile's store are the same in every mode, so
// what the modes separate is the stage loop's work: the shifted quads and
// edge floats of pull streaming (stream, and full - collide) and the
// arithmetic of the collision (collide). full is resident_kernel's code
// with no forced line (accel -1), so its cells and totals are the bits of
// the resident kernel's device-memory form with the forcing set to 0.
//
// What bounds it: as the resident form, 73 B a cell a launch over the card's
// memory rate, or its operations (90 a cell and step; stream mode one
// addition), whichever is larger; its design reaches one pass over device
// memory a round once both buffers and the mask outgrow the L2.
//
// Row mode only (the TPU probe has no lane mode). full and collide have a
// kernel per association, as the resident form has; stream has none. All
// seven kernels take the launch bounds of two blocks an SM, so the three
// modes launch the same block count from the same occupancy query.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/probe.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_rounds.cuh"

namespace {

using ProbeBlock = Block<false>;

template <int kStage, int kMode>
__global__ void __launch_bounds__(ProbeBlock::kThreads, 2)
probe_kernel(const __grid_constant__ Resident r) {
    extern __shared__ float4 smem[];
    resident_block<false, kMode, kStage>(r, reinterpret_cast<float*>(smem));
}

template <int kStage>
const void* kernel_of_assoc(int assoc) {
    return assoc == 1   ? (const void*)probe_kernel<kStage, 1>
           : assoc == 2 ? (const void*)probe_kernel<kStage, 2>
                        : (const void*)probe_kernel<kStage, 0>;
}

// The kernel of probe mode 0 (full), 1 (collide) or 2 (stream) and BGK
// association assoc (lbm_cell.cuh's mode; stream has none); nullptr for an
// unknown mode.
const void* probe_fn(int probe_mode, int assoc) {
    switch (probe_mode) {
        case kStageFull: return kernel_of_assoc<kStageFull>(assoc);
        case kStageCollide: return kernel_of_assoc<kStageCollide>(assoc);
        case kStageStream: return (const void*)probe_kernel<kStageStream, 0>;
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on this device for an ny x nx lattice
// in probe mode 0 (full), 1 (collide) or 2 (stream): as many as can be
// co-resident with their shared memory, at most one a tile. Negative: a
// CUDA error code, negated.
int lbm_probe_blocks(int ny, int nx, int probe_mode, int device) {
    const void* fn = probe_fn(probe_mode, 0);
    if (fn == nullptr) return -(int)cudaErrorInvalidValue;
    return rounds_blocks(fn, ProbeBlock::kThreads, ProbeBlock::kBytes, ny,
                         nx, device);
}

// gsteps (even) variant-steps ping-ponging a -> b -> a ... in rounds4
// rounds of 4, then rounds2 of 2, then rounds1 of 1 (ops/resident.py:
// device_rounds); the result is in a. partials holds gsteps * n floats, n =
// lbm_depth_num_partials(4, ny, nx); tickets two 32-bit words, zero before
// the first launch (every launch leaves them so); out[s] is step s's total.
// assoc is the BGK association (lbm_cell.cuh's mode); blocks comes from
// lbm_probe_blocks. A launch of more blocks than can be co-resident is
// refused (cudaErrorCooperativeLaunchTooLarge).
int lbm_probe(float* a, float* b, const uint8_t* mask, float* partials,
              unsigned* tickets, float* out, int ny, int nx, float omega,
              int assoc, int gsteps, int rounds4, int rounds2, int rounds1,
              int probe_mode, int blocks, int device, void* stream) {
    const void* fn = probe_fn(probe_mode, assoc);
    if (fn == nullptr || gsteps % 2) return (int)cudaErrorInvalidValue;
    Resident r;
    const cudaError_t err = resident_args(
        &r, a, b, mask, partials, tickets, out, ny, nx, -1, 0.0f, 0.0f,
        omega, assoc, gsteps, rounds4, rounds2, rounds1, 1.0f);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_rounds(fn, ProbeBlock::kThreads, ProbeBlock::kBytes, r,
                              blocks, device, stream);
}

}  // extern "C"
