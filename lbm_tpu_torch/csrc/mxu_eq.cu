// G D2Q9 BGK steps per launch in one persistent cooperative kernel whose
// stage body forms the nine equilibria of every cell as a (9, 6) x (6, N)
// contraction on the H100's tensor cores (sm_90a).
//
// Replaces no TPU kernel. It is the twin of the step that
// scripts/mxu_probe.py compiles and times: accelerate_flow +
// lbm_tpu/ops/mxu_eq.py::collide_stream_mxu in a jitted fori_loop, whose
// equilibrium is a dot_general at Precision.HIGHEST. The port has no XLA;
// its compiled steps are kernels written by hand, and this is that step's.
// The TPU experiment asked whether the matrix unit could take the
// equilibrium off the vector unit's issue slots; there XLA emitted no dot
// at all (K = 6 fills 6/128 of the MXU's contraction depth). Here
// mma.sync takes its operands from registers, so the contraction does
// reach the tensor cores (scripts/mxu_probe_torch.py counts the DMMA
// instructions), and the question becomes the depth kernel's (ROADMAP 2.2
// (3), instructions a cell): its stage loop is bound by instruction
// issue, and the collision's arithmetic is a third of it.
//
// The structure is the device-memory resident form's (resident.cu, whose
// header gives the design): a cooperative launch of depth-kernel blocks,
// rounds of 4, 2 and 1 steps on the depth tiles drawn by ticket, one grid
// barrier a round, the forced row as that form forces it, each step's
// partials summed in tile order. Only the stage body differs:
// lbm_depth.cuh's kStageMxu, whose comment gives the warp's products, their
// fragments and the scratch they pass through. Row mode only, as the
// probe. One kernel: its relaxation is the twin's one association.
//
// What bounds it: the device form's work, 73 B a cell a launch over the
// card's memory rate or 90 operations a cell and step over its f32 rate,
// whichever is longer (a bound reads the work, not the unit that does
// it). What it spends beyond the device form: the fragments' trips
// through shared memory, one f64 product (DMMA) for every 8 cells, the
// conversions to and from f64, and one more block barrier a stage (the
// scratch lives in the stage's output buffer, which the stores then take).
// Its equilibria are W phi in f64 rounded once to f32, which no plain
// version's f32 arithmetic rounds alike, so its cells are not the bits of
// any plain version; ops/mxu_eq.py states the tolerance. Measured on the
// H100 (PERF.md, row m): 2.34x the device form's time a step at 1024^2;
// the equilibrium stays on the CUDA cores in every planned kernel.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/mxu_eq.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "lbm_rounds.cuh"

namespace {

using MxuBlock = Block<false>;

// The window, then the A fragments (lbm_depth.cuh's kMxuTable).
constexpr size_t kMxuBytes =
    (kMxuTable<kCellsPerThread<false>> + kMxuTableWords) * sizeof(float);

// The launch's one parameter: the rounds, and W as A fragments by
// register and lane (kMxuTableWords 32-bit words: 4 x 32 doubles).
struct MxuResident {
    Resident r;
    uint32_t a[kMxuTableWords];
};

// One block an SM, 96 registers a thread: under the device form's two (48
// registers) ptxas cannot place the f64 product's fragments ("cannot be
// compiled with specified register target constraints").
__global__ void __launch_bounds__(MxuBlock::kThreads, 1)
mxu_resident_kernel(const __grid_constant__ MxuResident m) {
    extern __shared__ float4 smem[];
    float* buf = reinterpret_cast<float*>(smem);
    uint32_t* table =
        reinterpret_cast<uint32_t*>(buf + kMxuTable<kCellsPerThread<false>>);
    for (int i = threadIdx.x; i < kMxuTableWords; i += blockDim.x) {
        table[i] = m.a[i];
    }
    __syncthreads();
    resident_block<false, 0, kStageMxu>(m.r, buf);
}

}  // namespace

extern "C" {

// Blocks of the cooperative launch on this device for an ny x nx lattice:
// as many as can be co-resident with their shared memory, at most one a
// tile. Negative: a CUDA error code, negated.
int lbm_mxu_blocks(int ny, int nx, int device) {
    return rounds_blocks((const void*)mxu_resident_kernel, MxuBlock::kThreads,
                         kMxuBytes, ny, nx, device);
}

// gsteps steps ping-ponging a -> b -> a ... in rounds4 rounds of 4 steps,
// then rounds2 of 2, then rounds1 of 1 (ops/resident.py: device_rounds),
// forcing row accel: the result is in a when gsteps is even, in b when
// odd. partials holds gsteps * n floats, n = lbm_depth_num_partials(4, ny,
// nx); tickets two 32-bit words, zero before the first launch (every
// launch leaves them so); out[s] = scale * step s's sum of fluid |u|.
// a_frag: 256 words in host memory, ops/mxu_eq.py's a_fragments. blocks
// comes from lbm_mxu_blocks; a launch of more blocks than can be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
int lbm_mxu_resident(float* a, float* b, const uint8_t* mask, float* partials,
                     unsigned* tickets, float* out, int ny, int nx, int accel,
                     float w1, float w2, float omega, int gsteps, int rounds4,
                     int rounds2, int rounds1, float scale,
                     const uint32_t* a_frag, int blocks, int device,
                     void* stream) {
    MxuResident m;
    const cudaError_t err = resident_args(
        &m.r, a, b, mask, partials, tickets, out, ny, nx, accel, w1, w2, omega,
        1, gsteps, rounds4, rounds2, rounds1, scale);
    if (err != cudaSuccess) return (int)err;
    memcpy(m.a, a_frag, sizeof(m.a));
    return (int)launch_rounds((const void*)mxu_resident_kernel,
                              MxuBlock::kThreads, kMxuBytes, m, blocks, device,
                              stream);
}

}  // extern "C"
