// G D2Q9 BGK timesteps per launch with the lattice on chip: each block
// holds its strip of rows in shared memory for all G steps, on a CUDA
// device (sm_90a).
//
// Replaces the TPU kernel lbm_tpu/ops/pallas_resident.py::_kernel_resident
// (launched by _pallas_resident): the lattice copied on chip once, G steps
// between two buffers, a (G,) vector of per-step tot_u, one copy out. This
// is its on-chip form, for lattices whose strips fit a block's shared
// memory (ops/plan.py: resident_form); resident.cu is the device-memory
// form for the others. Both give the plain version's bits.
//
// What bounds it: while the strips fit, no lattice byte crosses L2 between
// the first load and the last store, so a step is the cell update (~150
// instructions a cell, issue-bound as the depth kernel's stages) plus what
// a block waits for its neighbours' rows. The design:
//
// - One cooperative block an SM at most (B <= SMs, co-resident, so a block
//   may spin on another's words). Block b owns rows [r0, r0 + h) at full
//   width, so the x wrap stays inside the block; ny is split so that
//   strips differ by at most one row. Dynamic shared memory holds the
//   strip's two buffers (SoA, [9][h][nx] f32) and its mask bytes, 73 B a
//   cell (the single-buffer mode below: one buffer, 37 B a cell); the
//   strip is read from a once and written once, into the buffer that G's
//   parity names (a after an even G, b after an odd one), as the
//   device-memory form leaves it.
// - No grid-wide barrier, no fence and no flag. Step t (slot t mod 2,
//   tag t + 1, t counted over the launches of one wrapper): the block's
//   top row's three north-going speeds (2, 5, 6) go into the north
//   neighbour's south slot and its bottom row's south-going speeds (4, 7,
//   8) into the south neighbour's north slot, each value one 64-bit word
//   with the step's tag in its high half, stored with one relaxed strong
//   access (lbm_onchip.cuh's put_word). Step 0 of a launch sends the
//   loaded strip; step t + 1's words are sent during step t by the thread
//   that updates the edge cell, from the new speeds in its registers, so
//   they leave as soon as the cell is computed and step G-1 sends nothing.
//   The block computes its interior rows while the words travel, then each
//   thread that updates an edge cell loads the (three, or six in a
//   one-row strip) words its cell pulls and spins on each, relaxed and
//   strong, until it holds the step's tag: one L2 handoff from the sender's
//   store to the value, no reload after a flag. One block barrier a step,
//   at its end (the next step's pulls read cells other threads wrote; warp
//   0 reads the warp sums behind it). Blocks wrap north-south, as the
//   lattice does.
// - Why two slots, word by word. The word of column c in slot s of a
//   direction is written at step t (its tag t + 1) only by the thread of
//   the sending strip that updates edge cell c at step t - 1 (or, t the
//   launch's first step, after the block's load barrier). That update
//   pulled the receiving strip's words of step t - 1 at columns c - 1, c
//   and c + 1, and each of those was sent by the receiving strip's thread
//   of that column from its update at step t - 2, which had read this
//   slot's word c of step t - 2 (tag t - 1) beforehand: the three threads
//   that read word c (columns c - 1, c, c + 1 pull it) are exactly those
//   whose words the overwrite waits on. Each send depends on the words its
//   thread read (a data dependency: the new speeds are computed from them),
//   so a read is never ordered after its own thread's send, and the
//   overwrite of step t lands after every read of step t - 2. A reader
//   waits for tag == t + 1, never >=: the slot holds tag t - 1 (stale) or
//   t + 1, never a later one. With one slot the overwrite would not wait
//   for the reads of step t - 1, and a >= test would take the next step's
//   value (tests/test_torch_onchip_tags.py models both, and a send placed
//   before its thread's reads). The single-buffer mode sends at the start
//   of each step, behind the block's barrier that follows every edge
//   cell's reads of the step before: the same argument with the barrier in
//   place of the thread. Across launches the tags go on (step_base), and a
//   launch starts behind the one before on its stream.
// - Forcing: the guard of a forced cell reads speeds 3, 6 and 7 (column
//   mode: 4, 8, 7) of that cell before the step, which do not travel. So
//   the owner forces the copies it sends: a site on the forced row (or
//   column) that passes the guard sends speed k + delta_k, the copy its
//   neighbour would have pulled from the forced lattice. The receiver
//   must not force it again: to lbm_cell_update's guard a halo site
//   reports itself solid (that flag is read for no other purpose there;
//   a cell's own obstacle flag is always in the strip). Three words a
//   halo cell instead of nine floats and a mask row.
// - tot_u: each block sums its |u| per step in a fixed order (warp
//   butterflies, then the warps' sums by a butterfly) into
//   partials[t][b]; the block that finishes last (an integer ticket after
//   a __threadfence() in each block, once per launch) sums each step's
//   partials in block order, a warp a step. No float atomics, so repeat
//   runs are bit-identical.
// - Column mode (kCols, the transposed lattice of a wide grid): the forced
//   column crosses every strip, so the load is even by construction.
// - The association is a template parameter, as in fused_depth.cu.
//
// The single-buffer mode (kBufs 1) replaces the same TPU kernel's in-place
// mode (pallas_resident.py::_kernel_resident with inplace=True,
// one_step_inplace; LBM_RESIDENT_INPLACE): one [9][h][nx] buffer a strip,
// 37 B a cell instead of 73, so strips twice as tall fit (a 4096-wide row,
// 768x768, the transposed 1024x512). The strip map, the halo slots and
// their words, the partials and the ticket are the two-buffer mode's; each
// thread updates the cells it updates there, in the same order, so a
// step's tot_u has the two-buffer mode's bits. What changes is the order
// of the stores:
// - the forced line is forced in place before the send (the guard reads
//   the cell's own pre-step speeds; x + w is the rounding the pulled
//   copy would get), so every pull, send and carried value below is
//   already forced and no update forces again; the send is at the start of
//   the step, from the strip, and a barrier follows it only in the strip
//   that forced a row in place;
// - the rows are updated in waves of kThreads cells in the two-buffer
//   mode's order (interior rows 1..h-2, then row 0 and row h-1), one
//   barrier phase a wave, split: a thread gathers its cell's pulls,
//   arrives at an mbarrier in shared memory, computes into registers,
//   waits for the phase (every thread has gathered), then stores the
//   wave before. So no wave pulls a cell whose store has landed: the row
//   above pulls a cell's speeds 2, 5, 6 at most nx + 1 positions later,
//   its other speeds come from a position away, and a wave of 1024
//   deferred once covers rows up to 1024 wide (where a row is wider,
//   speeds 2, 5, 6 wait in registers for three waves: rows up to 3071),
//   with no per-pull choice of source. The exceptions are two far pulls
//   across the x wrap, column nx-1's speed 6 from column 0 of the row
//   below (2 nx - 1 back) and, where a row is wider than a wave, its speed
//   3 from its own column 0 (nx - 1 back): where the cell's store may have
//   landed they come from a slot (two a pull, by row parity, the four
//   scalars of the carry), filled a wave or more before by a thread that
//   still reads the old value;
// - the edge rows pull what the interior overwrote from the carry: T,
//   row 1's old speeds 4, 7, 8, and R, row h-2's old 2, 5, 6, each copied
//   by its cell just before its store (with h = 2 row h-1 pulls row 0
//   from the buffer, as the interior pulls its row below). 12 nx floats a
//   carried row: none for one-row strips, R alone for two-row strips
//   (which pull no carried row, the footprint keeps it), R and T above
//   (ops/plan.py's onchip_smem_bytes mirrors smem_bytes).
// The TPU kernel carries the old rows in registers across its row blocks
// (prev_a, saved0); a block here is 1024 threads over a strip, so a wave's
// results wait in registers for the next wave's gather instead, and only
// what crosses more than a wave goes through shared memory.
//
// The strip step (both modes, the sends, the halo words and partials) lives in
// lbm_onchip.cuh, which the on-chip ring (ring_onchip.cu) runs too; this
// file places the strips of one lattice and binds the kernel.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/resident.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_onchip.cuh"

namespace {

using namespace onchip;

// halo: (B, 2, 2, kHalo, nx) words, [block][0 south / 1 north][slot],
// their tags below step_base + 1; partials: (G, B); ticket:
// one unsigned, zero between launches. a and res may be the same buffer
// (an even G, or any G with one buffer): each thread writes back exactly
// the cells it loaded. The strip step is lbm_onchip.cuh's; this kernel
// only places the strips: block b owns rows [r0, r0 + h), its neighbours
// the blocks b + 1 and b - 1, wrapping north-south as the lattice does.
template <bool kCols, int kMode, int kBufs>
__global__ void __launch_bounds__(kThreads, 1)
resident_onchip_kernel(const float* a, float* res,
                       const uint8_t* __restrict__ mask, Word* halo,
                       float* partials, unsigned* ticket,
                       float* __restrict__ tots, int ny, int nx, int accel,
                       float w1, float w2, float omega, int gsteps,
                       float scale, unsigned step_base) {
    const int nb = gridDim.x, b = blockIdx.x;
    const int base = ny / nb, rem = ny % nb;
    const int h = base + (b < rem ? 1 : 0);
    const int r0 = b * base + (b < rem ? b : rem);
    const int north = (b + 1 == nb) ? 0 : b + 1;
    const int south = (b == 0) ? nb - 1 : b - 1;
    const size_t pair = (size_t)2 * kHalo * nx;
    const Strip st{h, r0, ny,
                   halo + (size_t)(north * 2 + 0) * pair,
                   halo + (size_t)(south * 2 + 1) * pair,
                   halo + (size_t)(b * 2 + 0) * pair,
                   halo + (size_t)(b * 2 + 1) * pair};
    const size_t goff = (size_t)r0 * nx;
    const long long hmax_nx = strip_floats(ny, nx, nb);
    strip_steps<kCols, kMode, kBufs, DeviceScope>(
        st, a + goff, res + goff, mask + goff, (size_t)ny * nx, nx, accel, w1,
        w2, omega, gsteps, step_base, hmax_nx, carry_floats(ny, nx, nb),
        partials + b, nb);
    sum_partials_last(ticket, nb, partials, tots, gsteps, scale, hmax_nx,
                      kBufs);
}

template <int kBufs>
const void* onchip_fn_bufs(int axis, int mode) {
    if (axis) {
        return mode == 1 ? (const void*)resident_onchip_kernel<true, 1, kBufs>
               : mode == 2
                   ? (const void*)resident_onchip_kernel<true, 2, kBufs>
                   : (const void*)resident_onchip_kernel<true, 0, kBufs>;
    }
    return mode == 1 ? (const void*)resident_onchip_kernel<false, 1, kBufs>
           : mode == 2 ? (const void*)resident_onchip_kernel<false, 2, kBufs>
                       : (const void*)resident_onchip_kernel<false, 0, kBufs>;
}

const void* onchip_fn(int axis, int mode, int bufs) {
    return bufs == 1 ? onchip_fn_bufs<1>(axis, mode)
                     : onchip_fn_bufs<2>(axis, mode);
}

}  // namespace

extern "C" {

// The device's SM count and the shared memory a block may opt in to, for
// ops/plan.py's resident_form. Negative: a CUDA error code, negated.
int lbm_sm_count(int device) {
    int v = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    return err == cudaSuccess ? v : -(int)err;
}

int lbm_smem_optin(int device) {
    int v = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return err == cudaSuccess ? v : -(int)err;
}

// Dynamic shared memory of one block of the on-chip kernel for an ny x nx
// lattice over blocks strips in bufs (2, or 1: the single-buffer mode)
// buffers (ops/plan.py's onchip_smem_bytes).
long long lbm_onchip_smem_bytes(int ny, int nx, int blocks, int bufs) {
    return smem_bytes(ny, nx, blocks, bufs);
}

// Opt the kernel of forcing mode axis, association mode and buffer count
// into bytes of dynamic shared memory and check that blocks of them can be
// co-resident on this device. 0, or a CUDA error code
// (cudaErrorNotSupported: no cooperative launch;
// cudaErrorCooperativeLaunchTooLarge: too many blocks).
int lbm_onchip_prepare(int axis, int mode, int bufs, long long bytes,
                       int blocks, int device) {
    if (bufs != 1 && bufs != 2) return (int)cudaErrorInvalidValue;
    return prepare(onchip_fn(axis, mode, bufs), bytes, blocks, device);
}

// gsteps steps of the ny x nx lattice in a over blocks strips; the result
// goes to res (the caller passes a for an even gsteps, its other buffer
// for an odd one; any buffer in either mode). out[s] = scale * step s's
// sum of fluid |u|. step_base: steps this scratch (halo) has run before;
// its words must hold no tag above it. axis 0 forces row accel, axis 1
// (a transposed lattice) column accel; bufs 2 or 1 (the single-buffer
// mode); lbm_onchip_prepare has run for the same axis, mode, bufs, bytes
// and blocks.
int lbm_resident_onchip(const float* a, float* res, const uint8_t* mask,
                        Word* halo, float* partials,
                        unsigned* ticket, float* out, int ny, int nx,
                        int accel, float w1, float w2, float omega, int mode,
                        int gsteps, float scale, unsigned step_base,
                        int blocks, int axis, int bufs, int device,
                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (gsteps < 1 || blocks < 1 || blocks > ny || (bufs != 1 && bufs != 2)) {
        return (int)cudaErrorInvalidValue;
    }
    // One buffer defers stores by at most three waves (inplace_delay).
    if (bufs == 1 && (ny + blocks - 1) / blocks >= 2 && nx + 1 > 3 * kThreads) {
        return (int)cudaErrorInvalidValue;
    }
    void* args[] = {&a,  &res,   &mask,  &halo,  &partials,
                    &ticket, &out, &ny, &nx, &accel, &w1,
                    &w2, &omega, &gsteps, &scale, &step_base};
    return launch(onchip_fn(axis, mode, bufs), blocks, args,
                  smem_bytes(ny, nx, blocks, bufs), stream);
}

}  // extern "C"
