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
//   may spin on another's flag). Block b owns rows [r0, r0 + h) at full
//   width, so the x wrap stays inside the block; ny is split so that
//   strips differ by at most one row. Dynamic shared memory holds the
//   strip's two buffers (SoA, [9][h][nx] f32) and its mask bytes, 73 B a
//   cell (the single-buffer mode below: one buffer, 37 B a cell); the
//   strip is read from a once and written once, into the buffer that G's
//   parity names (a after an even G, b after an odd one), as the
//   device-memory form leaves it.
// - No grid-wide barrier. Step t (slot t mod 2, tag t + 1, t counted over
//   the launches of one wrapper): the block stores its top row's three
//   north-going speeds (2, 5, 6) into the north neighbour's south slot and
//   its bottom row's south-going speeds (4, 7, 8) into the south
//   neighbour's north slot, then publishes one flag per (direction, slot)
//   with release semantics (one fence, then relaxed stores, after the
//   block's barrier; the waiting side: acquire loads by one thread a
//   flag, then the barrier, as CUTLASS's GenericBarrier does); computes
//   its interior rows while the rows travel; waits with acquire semantics
//   until its own two flags for the slot hold the tag; computes its edge
//   rows, reading the halo copies through L2. Blocks wrap north-south, as
//   the lattice does.
// - Why two slots with a flag each (ring.cu's protocol): a block writes
//   slot s at step t only after waiting at step t-1 for both neighbours'
//   step t-1 flags, which they published after finishing step t-2, the
//   last step that read slot s. One flag shared by both slots lets a
//   step-t wait pass on the step-t+1 signal
//   (tests/test_torch_resident.py models both).
// - Forcing: the guard of a forced cell reads speeds 3, 6 and 7 (column
//   mode: 4, 8, 7) of that cell before the step, which do not travel. So
//   the owner forces the copies it sends: a site on the forced row (or
//   column) that passes the guard sends speed k + delta_k, the copy its
//   neighbour would have pulled from the forced lattice. The receiver
//   must not force it again: to lbm_cell_update's guard a halo site
//   reports itself solid (that flag is read for no other purpose there;
//   a cell's own obstacle flag is always in the strip). Three floats a
//   halo cell instead of nine and a mask row.
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
// flags, the partials and the ticket are the two-buffer mode's; each
// thread updates the cells it updates there, in the same order, so a
// step's tot_u has the two-buffer mode's bits. What changes is the order
// of the stores:
// - the forced line is forced in place before the send (the guard reads
//   the cell's own pre-step speeds; x + w is the rounding the pulled
//   copy would get), so every pull, send and carried value below is
//   already forced and no update forces again;
// - the rows are updated in waves of kThreads cells in the two-buffer
//   mode's order (interior rows 1..h-2, then row 0 and row h-1): a wave
//   reads every input and computes into registers, passes a barrier, then
//   stores, so no thread reads a cell that its own wave overwrote;
// - a cell that an earlier wave overwrote is read from the carry, which
//   the overwriting thread filled with its cell's pre-step value just
//   before its store: R, speeds 2, 5, 6 of the highest overwritten cell of
//   each column (the row below of the next interior row; after the
//   interior, row h-2's, which row h-1 reads; with h = 2, row 0's); T,
//   speeds 4, 7, 8 of row 1 (row 0 reads them after the interior); and
//   four scalars: speed 1 of a wave's last cell and speed 5 of the cell
//   below it (the next wave's first cell pulls them, its west neighbours),
//   and speed 3 of a row's column 0 and speed 6 of the cell below it (the
//   row's last column pulls them across the x wrap) where the row's ends
//   fall in different waves. 12 nx floats a carried row: none for
//   one-row strips, R alone for two-row strips, R and T above
//   (ops/plan.py's onchip_smem_bytes mirrors smem_bytes).
// The TPU kernel carries the old rows in registers across its row blocks
// (prev_a, saved0); a block here is 1024 threads over a strip, so what
// crosses a wave boundary goes through shared memory.
//
// Plain C interface, bound with ctypes by lbm_tpu_torch/ops/resident.py.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_reduce.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Floats of dynamic shared memory beside the strip: the per-step warp sums
// of two steps and the ticket's answer. ops/plan.py's ONCHIP_SCRATCH_BYTES.
constexpr int kScratch = 2 * kWarps + 4;
// Speeds a halo cell carries (ops/plan.py's ONCHIP_HALO_SPEEDS).
constexpr int kHalo = 3;

using Flag = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

__host__ __device__ long long strip_floats(int ny, int nx, int blocks) {
    const long long hmax = (ny + blocks - 1) / blocks;
    return hmax * nx;
}

// Floats the single-buffer mode carries across its waves: four scalars,
// then R and T (three speeds of a row each) as far as the tallest strip
// needs them.
__host__ __device__ long long carry_floats(int ny, int nx, int blocks) {
    const long long hmax = (ny + blocks - 1) / blocks;
    const long long rows = hmax - 1 < 2 ? hmax - 1 : 2;
    return 4 + 3 * nx * rows;
}

long long smem_bytes(int ny, int nx, int blocks, int bufs) {
    // bufs buffers of 9 speeds, the scratch floats, the single-buffer
    // mode's carry, then the mask bytes.
    const long long carry = bufs == 1 ? carry_floats(ny, nx, blocks) : 0;
    return (9 * bufs * strip_floats(ny, nx, blocks) + kScratch + carry) * 4 +
           strip_floats(ny, nx, blocks);
}

// The scalars of the carry (see the single-buffer mode above).
enum { kE1, kE5, kZ3, kZ6 };

// Slot of speed k in a halo row: north-going rows carry 2, 5, 6 and
// south-going rows 4, 7, 8, in that order. Other speeds are never read
// from a halo (its sites are solid to the guard); they map to 0 so that
// any address the compiler forms stays in the row.
__device__ __forceinline__ int halo_q(int k) {
    return (k == 5 || k == 7) ? 1 : ((k == 6 || k == 8) ? 2 : 0);
}

// The guard of a forced site (lbm_cell.cuh): fluid, and its guarded
// speeds each strictly above their weight after the subtraction.
template <bool kCols>
__device__ __forceinline__ bool guard(const float* src, int plane, int o,
                                      bool solid, float w1, float w2) {
    if constexpr (kCols) {
        return !solid && (src[4 * plane + o] - w1 > 0.0f) &&
               (src[8 * plane + o] - w2 > 0.0f) &&
               (src[7 * plane + o] - w2 > 0.0f);
    } else {
        return !solid && (src[3 * plane + o] - w1 > 0.0f) &&
               (src[6 * plane + o] - w2 > 0.0f) &&
               (src[7 * plane + o] - w2 > 0.0f);
    }
}

// Forces the site at o in place where it passes the guard (the single-
// buffer mode's forcing, before the step reads the strip): the deltas of
// ops/reference.forcing, the additions the two-buffer mode makes to the
// pulled copies.
template <bool kCols>
__device__ __forceinline__ void force_in_place(float* buf, int plane, int o,
                                               bool solid, float w1,
                                               float w2) {
    if (!guard<kCols>(buf, plane, o, solid, w1, w2)) return;
    float* f = buf + o;
    if constexpr (kCols) {
        f[2 * plane] = f[2 * plane] + w1;
        f[4 * plane] = f[4 * plane] - w1;
        f[5 * plane] = f[5 * plane] + w2;
        f[6 * plane] = f[6 * plane] + w2;
        f[7 * plane] = f[7 * plane] - w2;
        f[8 * plane] = f[8 * plane] - w2;
    } else {
        f[plane] = f[plane] + w1;
        f[3 * plane] = f[3 * plane] - w1;
        f[5 * plane] = f[5 * plane] + w2;
        f[6 * plane] = f[6 * plane] - w2;
        f[7 * plane] = f[7 * plane] - w2;
        f[8 * plane] = f[8 * plane] + w2;
    }
}

// The update of one cell from its nine pulled speeds s, already forced:
// lbm_cell_update with no forcing left to do. out: the new speeds; the
// return value |u|, 0 for an obstacle.
template <bool kCols>
__device__ __forceinline__ float update_pulled(const float s[9], bool solid,
                                               float w1, float w2,
                                               float omega, int mode,
                                               float out[9]) {
    auto ld = [&](int k, int) { return s[k]; };
    auto is_solid = [&](int) { return solid; };
    return lbm_cell_update<kCols, int>(ld, is_solid, 0, 0, 0, 0, 0, 0, false,
                                       false, false, w1, w2, omega, mode,
                                       out);
}

// The three copies that row j's column c sends, forced where the site is
// on the forced line and passes the guard (the deltas of
// ops/reference.forcing; a zero delta is not added). kNorth: speeds 2, 5,
// 6 to the block above; else 4, 7, 8 to the block below.
template <bool kCols, bool kNorth>
__device__ __forceinline__ void send_cell(const float* src,
                                          const uint8_t* m, int plane,
                                          int j, int c, int nx, bool row_on,
                                          int accel, float w1, float w2,
                                          float* to) {
    const int o = j * nx + c;
    const bool on = kCols ? c == accel : row_on;
    const bool g = on && guard<kCols>(src, plane, o, m[o] != 0, w1, w2);
    float q0, q1, q2;
    if constexpr (kNorth) {
        q0 = src[2 * plane + o];
        q1 = src[5 * plane + o];
        q2 = src[6 * plane + o];
        if (g) {
            if constexpr (kCols) {
                q0 = q0 + w1;
                q1 = q1 + w2;
                q2 = q2 + w2;
            } else {
                q1 = q1 + w2;
                q2 = q2 - w2;
            }
        }
    } else {
        q0 = src[4 * plane + o];
        q1 = src[7 * plane + o];
        q2 = src[8 * plane + o];
        if (g) {
            if constexpr (kCols) {
                q0 = q0 - w1;
                q1 = q1 - w2;
                q2 = q2 - w2;
            } else {
                q1 = q1 - w2;
                q2 = q2 + w2;
            }
        }
    }
    __stcg(to + c, q0);
    __stcg(to + nx + c, q1);
    __stcg(to + 2 * nx + c, q2);
}

// halo: (B, 2, 2, kHalo, nx) floats, [block][0 south / 1 north][slot];
// flags: (B, 2, 2) unsigned, the same order; partials: (G, B); ticket:
// one unsigned, zero between launches. a and res may be the same buffer
// (an even G, or any G with one buffer): each thread writes back exactly
// the cells it loaded.
template <bool kCols, int kMode, int kBufs>
__global__ void __launch_bounds__(kThreads, 1)
resident_onchip_kernel(const float* a, float* res,
                       const uint8_t* __restrict__ mask, float* halo,
                       unsigned* flags, float* partials, unsigned* ticket,
                       float* __restrict__ tots, int ny, int nx, int accel,
                       float w1, float w2, float omega, int gsteps,
                       float scale, unsigned step_base) {
    extern __shared__ float smem[];
    const int nb = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int base = ny / nb, rem = ny % nb;
    const int h = base + (b < rem ? 1 : 0);
    const int r0 = b * base + (b < rem ? b : rem);
    const int plane = h * nx;
    const long long hmax_nx = strip_floats(ny, nx, nb);
    float* buf0 = smem;
    float* buf1 = smem + 9 * hmax_nx;  // kBufs 2 only
    float* red = smem + 9 * kBufs * hmax_nx;
    // kBufs 1 only: the carry (the scalars, R, T), then the mask.
    float* spec = red + kScratch;
    float* carry_r = spec + 4;
    float* carry_t = carry_r + 3 * nx;
    uint8_t* m = reinterpret_cast<uint8_t*>(
        spec + (kBufs == 1 ? carry_floats(ny, nx, nb) : 0));
    const size_t gplane = (size_t)ny * nx, goff = (size_t)r0 * nx;

    for (int idx = tid; idx < 9 * plane; idx += kThreads) {
        const int k = idx / plane, o = idx - k * plane;
        buf0[idx] = a[k * gplane + goff + o];
    }
    for (int o = tid; o < plane; o += kThreads) m[o] = mask[goff + o];
    __syncthreads();

    const int north = (b + 1 == nb) ? 0 : b + 1;
    const int south = (b == 0) ? nb - 1 : b - 1;
    const size_t hrow = (size_t)kHalo * nx;
    auto halo_at = [&](int blk, int dir, int slot) {
        return halo + ((size_t)(blk * 2 + dir) * 2 + slot) * hrow;
    };
    auto wrap = [&](int g) { return g < 0 ? g + ny : (g >= ny ? g - ny : g); };

    for (int s = 0; s < gsteps; ++s) {
        const unsigned step = step_base + (unsigned)s, tag = step + 1u;
        const int slot = (int)(step & 1u);
        const float* src = (kBufs == 2 && (s & 1)) ? buf1 : buf0;
        float* dst = kBufs == 2 ? ((s & 1) ? buf0 : buf1) : buf0;

        if constexpr (kBufs == 1) {
            // Force the line in place; the sends and pulls below read it.
            if constexpr (kCols) {
                for (int j = tid; j < h; j += kThreads) {
                    const int o = j * nx + accel;
                    force_in_place<true>(dst, plane, o, m[o] != 0, w1, w2);
                }
            } else if (r0 <= accel && accel < r0 + h) {
                const int rj = (accel - r0) * nx;
                for (int c = tid; c < nx; c += kThreads) {
                    force_in_place<false>(dst, plane, rj + c, m[rj + c] != 0,
                                          w1, w2);
                }
            }
            __syncthreads();
        }

        // Send: the top row north, the bottom row south, then the flags.
        // (One buffer: the strip is forced already, so the copies are not.)
        {
            float* to_n = halo_at(north, 0, slot);
            float* to_s = halo_at(south, 1, slot);
            const bool top_on = kBufs == 2 && r0 + h - 1 == accel;
            const bool bot_on = kBufs == 2 && r0 == accel;
            const int send_accel = kBufs == 2 ? accel : -1;
            for (int c = tid; c < nx; c += kThreads) {
                send_cell<kCols, true>(src, m, plane, h - 1, c, nx, top_on,
                                       send_accel, w1, w2, to_n);
                send_cell<kCols, false>(src, m, plane, 0, c, nx, bot_on,
                                        send_accel, w1, w2, to_s);
            }
            __syncthreads();
            if (tid == 0) {
                // One release fence for the block's stores (ordered before
                // it by the barrier), then both flags.
                cuda::atomic_thread_fence(cuda::memory_order_release,
                                          cuda::thread_scope_device);
                Flag(flags[(north * 2 + 0) * 2 + slot])
                    .store(tag, cuda::memory_order_relaxed);
                Flag(flags[(south * 2 + 1) * 2 + slot])
                    .store(tag, cuda::memory_order_relaxed);
            }
        }

        float acc = 0.0f;
        float cell[9];
        const int n_inner = (h - 2) * nx;
        // Interior rows 1 .. h-2 read the strip alone.
        if constexpr (kBufs == 2) {
            auto ld = [&](int k, int o) { return src[k * plane + o]; };
            auto solid = [&](int o) { return m[o] != 0; };
            for (int idx = tid; idx < n_inner; idx += kThreads) {
                const int j = 1 + idx / nx, i = idx - (j - 1) * nx;
                const int iw = (i == 0) ? nx - 1 : i - 1;
                const int ie = (i == nx - 1) ? 0 : i + 1;
                const int rj = j * nx, g = r0 + j;
                const bool f0 = kCols ? i == accel : g == accel;
                const bool f1 = kCols ? iw == accel : g - 1 == accel;
                const bool f2 = kCols ? ie == accel : g + 1 == accel;
                acc += lbm_cell_update<kCols, int>(
                    ld, solid, rj, rj - nx, rj + nx, i, iw, ie, f0, f1, f2,
                    w1, w2, omega, kMode, cell);
#pragma unroll
                for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = cell[k];
            }
        } else {
            // In waves: interior position p = (j - 1) nx + i, wave
            // [L, wend). A cell at a position below L is overwritten.
            float* buf = dst;
            for (int L = 0; L < n_inner; L += kThreads) {
                const int p = L + tid;
                const int wend = min(L + kThreads, n_inner);
                const bool act = p < n_inner;
                const int j = act ? 1 + p / nx : 1;
                const int i = act ? p - (j - 1) * nx : 0;
                const int o = j * nx + i;
                float e5 = 0.0f, z6 = 0.0f;
                if (act) {
                    const int iw = (i == 0) ? nx - 1 : i - 1;
                    const int ie = (i == nx - 1) ? 0 : i + 1;
                    const int rm = o - nx - i, rp = o + nx - i;
                    // Speed k (2, 5 or 6; q its slot in R) of the cell
                    // below at column c, q_pos its position: row 0 is not
                    // overwritten in this phase.
                    auto below = [&](int k, int q, int c, int q_pos) {
                        return (j == 1 || q_pos >= L) ? buf[k * plane + rm + c]
                                                      : carry_r[q * nx + c];
                    };
                    // The row's column 0 is in an earlier wave.
                    const bool z = i == nx - 1 && p - nx + 1 < L;
                    float sp[9];
                    sp[0] = buf[o];
                    sp[1] = (i == 0) ? buf[plane + o + nx - 1]
                            : (p == L ? spec[kE1] : buf[plane + o - 1]);
                    sp[2] = below(2, 0, i, p - nx);
                    sp[3] = (i == nx - 1)
                                ? (z ? spec[kZ3] : buf[3 * plane + o - nx + 1])
                                : buf[3 * plane + o + 1];
                    sp[4] = buf[4 * plane + o + nx];
                    sp[5] = (j > 1 && i > 0 && p == L)
                                ? spec[kE5]
                                : below(5, 1, iw, i ? p - nx - 1 : p - 1);
                    sp[6] = (j > 1 && z)
                                ? spec[kZ6]
                                : below(6, 2, ie,
                                        i < nx - 1 ? p - nx + 1
                                                   : p - 2 * nx + 1);
                    sp[7] = buf[7 * plane + rp + ie];
                    sp[8] = buf[8 * plane + rp + iw];
                    acc += update_pulled<kCols>(sp, m[o] != 0, w1, w2, omega,
                                                kMode, cell);
                    // What the next wave's first cell and this row's last
                    // column pull from below after this wave's stores.
                    if (p == wend - 1 && wend < n_inner) {
                        e5 = below(5, 1, i, p - nx);
                    }
                    if (i == 0 && p + nx - 1 >= wend) z6 = below(6, 2, 0, p - nx);
                }
                __syncthreads();
                if (act) {
                    if (p + nx >= wend) {  // the top of its column here
                        carry_r[i] = buf[2 * plane + o];
                        carry_r[nx + i] = buf[5 * plane + o];
                        carry_r[2 * nx + i] = buf[6 * plane + o];
                    }
                    if (j == 1) {
                        carry_t[i] = buf[4 * plane + o];
                        carry_t[nx + i] = buf[7 * plane + o];
                        carry_t[2 * nx + i] = buf[8 * plane + o];
                    }
                    if (p == wend - 1 && wend < n_inner) {
                        spec[kE1] = buf[plane + o];
                        spec[kE5] = e5;
                    }
                    if (i == 0 && p + nx - 1 >= wend) {
                        spec[kZ3] = buf[3 * plane + o];
                        spec[kZ6] = z6;
                    }
#pragma unroll
                    for (int k = 0; k < 9; ++k) buf[k * plane + o] = cell[k];
                }
                __syncthreads();
            }
        }

        // Receive: both halo slots hold this step's rows. Two threads wait
        // on the two flags at once; the barrier orders the block's halo
        // loads after their acquires.
        if (tid == 0 || tid == 32) {
            Flag from(flags[(b * 2 + (tid ? 1 : 0)) * 2 + slot]);
            while (from.load(cuda::memory_order_acquire) < tag) {
            }
        }
        __syncthreads();

        // Edge rows 0 and h-1 (one row when h is 1), row -1 from the south
        // slot and row h from the north slot.
        const float* hs = halo_at(b, 0, slot);
        const float* hn = halo_at(b, 1, slot);
        const int n_edge = (h == 1 ? 1 : 2) * nx;
        if constexpr (kBufs == 2) {
            auto ld = [&](int k, int o) -> float {
                if (o < 0) return __ldcg(hs + halo_q(k) * nx + (o + nx));
                if (o >= plane) {
                    return __ldcg(hn + halo_q(k) * nx + (o - plane));
                }
                return src[k * plane + o];
            };
            auto solid = [&](int o) {
                return o < 0 || o >= plane || m[o] != 0;
            };
            for (int idx = tid; idx < n_edge; idx += kThreads) {
                const bool top = idx >= nx;
                const int j = top ? h - 1 : 0, i = top ? idx - nx : idx;
                const int iw = (i == 0) ? nx - 1 : i - 1;
                const int ie = (i == nx - 1) ? 0 : i + 1;
                const int rj = j * nx, g = r0 + j;
                const bool f0 = kCols ? i == accel : g == accel;
                const bool f1 = kCols ? iw == accel : wrap(g - 1) == accel;
                const bool f2 = kCols ? ie == accel : wrap(g + 1) == accel;
                acc += lbm_cell_update<kCols, int>(
                    ld, solid, rj, rj - nx, rj + nx, i, iw, ie, f0, f1, f2,
                    w1, w2, omega, kMode, cell);
#pragma unroll
                for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = cell[k];
            }
        } else {
            // In waves over edge position e: row 0 at e = i, row h-1 at
            // e = nx + i. Row 0 pulls row 1 from T (h > 2), the buffer
            // (h = 2: row 1 comes after it) or the north slot (h = 1); row
            // h-1 pulls row h-2 from R (h > 2: complete since the
            // interior) or, with h = 2, from R where row 0 is overwritten.
            float* buf = dst;
            for (int L = 0; L < n_edge; L += kThreads) {
                const int e = L + tid;
                const int wend = min(L + kThreads, n_edge);
                const bool act = e < n_edge;
                const bool top = e >= nx;
                const int i = top ? e - nx : e;
                const int o = (top ? h - 1 : 0) * nx + i;
                if (act) {
                    const int iw = (i == 0) ? nx - 1 : i - 1;
                    const int ie = (i == nx - 1) ? 0 : i + 1;
                    float sp[9];
                    sp[0] = buf[o];
                    sp[1] = (i == 0) ? buf[plane + o + nx - 1]
                            : (e == L ? spec[kE1] : buf[plane + o - 1]);
                    sp[3] = (i == nx - 1)
                                ? (e - nx + 1 < L ? spec[kZ3]
                                                  : buf[3 * plane + o - nx + 1])
                                : buf[3 * plane + o + 1];
                    if (!top) {
                        sp[2] = __ldcg(hs + i);
                        sp[5] = __ldcg(hs + nx + iw);
                        sp[6] = __ldcg(hs + 2 * nx + ie);
                        if (h == 1) {
                            sp[4] = __ldcg(hn + i);
                            sp[7] = __ldcg(hn + nx + ie);
                            sp[8] = __ldcg(hn + 2 * nx + iw);
                        } else if (h == 2) {
                            sp[4] = buf[4 * plane + nx + i];
                            sp[7] = buf[7 * plane + nx + ie];
                            sp[8] = buf[8 * plane + nx + iw];
                        } else {
                            sp[4] = carry_t[i];
                            sp[7] = carry_t[nx + ie];
                            sp[8] = carry_t[2 * nx + iw];
                        }
                    } else {
                        auto below = [&](int k, int q, int c) {
                            return (h == 2 && c >= L) ? buf[k * plane + c]
                                                      : carry_r[q * nx + c];
                        };
                        sp[2] = below(2, 0, i);
                        sp[5] = below(5, 1, iw);
                        sp[6] = below(6, 2, ie);
                        sp[4] = __ldcg(hn + i);
                        sp[7] = __ldcg(hn + nx + ie);
                        sp[8] = __ldcg(hn + 2 * nx + iw);
                    }
                    acc += update_pulled<kCols>(sp, m[o] != 0, w1, w2, omega,
                                                kMode, cell);
                }
                __syncthreads();
                if (act) {
                    if (h == 2 && !top) {
                        carry_r[i] = buf[2 * plane + o];
                        carry_r[nx + i] = buf[5 * plane + o];
                        carry_r[2 * nx + i] = buf[6 * plane + o];
                    }
                    if (e == wend - 1 && wend < n_edge) {
                        spec[kE1] = buf[plane + o];
                    }
                    if (i == 0 && e + nx - 1 >= wend) {
                        spec[kZ3] = buf[3 * plane + o];
                    }
#pragma unroll
                    for (int k = 0; k < 9; ++k) buf[k * plane + o] = cell[k];
                }
                __syncthreads();
            }
        }

        // The block's sum of this step: warps, then the warps' sums. The
        // two steps' scratch alternate, so warp 0 reads this step's while
        // the others start the next.
        acc = lbm_warp_sum(acc);
        float* wsum = red + (s & 1) * kWarps;
        if (lane == 0) wsum[warp] = acc;
        __syncthreads();
        if (warp == 0) {
            const float v = lbm_warp_sum(lane < kWarps ? wsum[lane] : 0.0f);
            if (lane == 0) partials[(size_t)s * nb + b] = v;
        }
    }

    const float* fin = (kBufs == 2 && (gsteps & 1)) ? buf1 : buf0;
    for (int idx = tid; idx < 9 * plane; idx += kThreads) {
        const int k = idx / plane, o = idx - k * plane;
        res[k * gplane + goff + o] = fin[idx];
    }

    // The block that finishes last sums the partials, step by step.
    unsigned* last = reinterpret_cast<unsigned*>(red + 2 * kWarps);
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        *last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int s = warp; s < gsteps; s += kWarps) {
        float v = 0.0f;
        for (int p = lane; p < nb; p += 32) {
            v += __ldcg(partials + (size_t)s * nb + p);
        }
        v = lbm_warp_sum(v);
        if (lane == 0) tots[s] = v * scale;
    }
    if (tid == 0) *ticket = 0u;
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
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int coop = 0, sms = 0, per_sm = 0, optin = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    // The attribute is the function's, shared by every wrapper of this
    // instantiation: raise it to the card's limit once, never to one
    // lattice's size, which another wrapper's launch would then exceed.
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(onchip_fn(axis, mode, bufs),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onchip_fn(axis, mode, bufs), kThreads, (size_t)bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1 || (long long)per_sm * sms < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    return 0;
}

// gsteps steps of the ny x nx lattice in a over blocks strips; the result
// goes to res (the caller passes a for an even gsteps, its other buffer
// for an odd one; any buffer in either mode). out[s] = scale * step s's
// sum of fluid |u|. step_base: steps this scratch (halo, flags) has run
// before; flags must hold no tag above it. axis 0 forces row accel, axis 1
// (a transposed lattice) column accel; bufs 2 or 1 (the single-buffer
// mode); lbm_onchip_prepare has run for the same axis, mode, bufs, bytes
// and blocks.
int lbm_resident_onchip(const float* a, float* res, const uint8_t* mask,
                        float* halo, unsigned* flags, float* partials,
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
    void* args[] = {&a,  &res, &mask,  &halo,   &flags, &partials,
                    &ticket, &out, &ny, &nx, &accel, &w1,
                    &w2, &omega, &gsteps, &scale, &step_base};
    err = cudaLaunchCooperativeKernel(
        onchip_fn(axis, mode, bufs), dim3(blocks), dim3(kThreads), args,
        (size_t)smem_bytes(ny, nx, blocks, bufs), (cudaStream_t)stream);
    if (err != cudaSuccess) {
        // A refused launch never ran; its error is returned here and must
        // not stay behind for the next launch's check.
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
