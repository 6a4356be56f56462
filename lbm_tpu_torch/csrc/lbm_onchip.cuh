// The on-chip form's strip step (resident_onchip.cu), shared by the
// single-device kernel and the on-chip ring (ring_onchip.cu): one block of
// kThreads threads holds a strip of whole rows in dynamic shared memory
// for all G steps and trades its edge rows with the strips above and below
// through two halo slots and a flag per (direction, slot), in either of
// the two modes (two buffers, or one buffer updated in place in waves with
// a carry). resident_onchip.cu's header comment describes the design;
// what differs between the two kernels is where a strip's neighbours are:
// the Strip a kernel hands to strip_steps names the slots and flags it
// sends into and reads from, the global row of its row 0 (forcing) and
// the memory scope of its flags (Scope).

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_cell.cuh"
#include "lbm_reduce.cuh"

namespace onchip {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Floats of dynamic shared memory beside the strip: the per-step warp sums
// of two steps and the ticket's answer. ops/plan.py's ONCHIP_SCRATCH_BYTES.
constexpr int kScratch = 2 * kWarps + 4;
// Speeds a halo cell carries (ops/plan.py's ONCHIP_HALO_SPEEDS).
constexpr int kHalo = 3;

__host__ __device__ inline long long strip_floats(int ny, int nx,
                                                  int blocks) {
    const long long hmax = (ny + blocks - 1) / blocks;
    return hmax * nx;
}

// Floats the single-buffer mode carries across its waves: four scalars,
// then R and T (three speeds of a row each) as far as the tallest strip
// needs them.
__host__ __device__ inline long long carry_floats(int ny, int nx,
                                                  int blocks) {
    const long long hmax = (ny + blocks - 1) / blocks;
    const long long rows = hmax - 1 < 2 ? hmax - 1 : 2;
    return 4 + 3 * nx * rows;
}

// Dynamic shared memory of a block whose strips split ny x nx over blocks:
// bufs buffers of 9 speeds, the scratch floats, the single-buffer mode's
// carry, then the mask bytes (ops/plan.py's onchip_smem_bytes).
inline long long smem_bytes(int ny, int nx, int blocks, int bufs) {
    const long long carry = bufs == 1 ? carry_floats(ny, nx, blocks) : 0;
    return (9 * bufs * strip_floats(ny, nx, blocks) + kScratch + carry) * 4 +
           strip_floats(ny, nx, blocks);
}

// The scalars of the carry (see the single-buffer mode).
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
// 6 to the strip above; else 4, 7, 8 to the strip below.
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

// One strip and its links. Each slot pointer is a direction's slot 0, its
// slot 1 kHalo * nx floats on; each flag pointer a direction's flag of
// slot 0, slot 1's the next word.
struct Strip {
    int h;                // rows
    int row0;             // global row of row 0 (row-mode forcing)
    int ny;               // global rows (the wrap of the forcing flags)
    float* to_n;          // the north neighbour's south slots
    float* to_s;          // the south neighbour's north slots
    unsigned* flag_n;     // the north neighbour's south flags
    unsigned* flag_s;     // the south neighbour's north flags
    const float* from_s;  // this strip's south slots (row -1)
    const float* from_n;  // this strip's north slots (row h)
    unsigned* own;        // this strip's flags, south then north
};

// The flags' scope and the release before a publish: one card.
struct DeviceScope {
    using Flag = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;
    __device__ static void release(bool) {
        cuda::atomic_thread_fence(cuda::memory_order_release,
                                  cuda::thread_scope_device);
    }
};

// Neighbours that may be on another card (peer pointers): system-scope
// flags, and a system-scope release where some neighbour is (cross).
struct SystemScope {
    using Flag = cuda::atomic_ref<unsigned, cuda::thread_scope_system>;
    __device__ static void release(bool cross) {
        if (cross) {
            cuda::atomic_thread_fence(cuda::memory_order_release,
                                      cuda::thread_scope_system);
        } else {
            cuda::atomic_thread_fence(cuda::memory_order_release,
                                      cuda::thread_scope_device);
        }
    }
};

// gsteps steps of the strip st whose rows start at a (its row 0's speed 0;
// speed k at k * gplane), the result to res at the same offsets (a and res
// may be the same buffer: each thread writes back exactly the cells it
// loaded), its mask rows at mask. hmax_nx and carry: the tallest strip's
// floats and carry floats (every strip of a launch lays out its shared
// memory alike). Step s's sum of |u| over the strip's fluid cells goes to
// partials[s * pstride]. step_base: steps these slots and flags have run
// before. cross: passed to Scope::release.
template <bool kCols, int kMode, int kBufs, class Scope>
__device__ __forceinline__ void strip_steps(
    const Strip& st, const float* a, float* res,
    const uint8_t* __restrict__ mask, size_t gplane, int nx, int accel,
    float w1, float w2, float omega,
    int gsteps, unsigned step_base, long long hmax_nx, long long carry,
    float* partials, int pstride, bool cross) {
    using Flag = typename Scope::Flag;
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int h = st.h, r0 = st.row0, ny = st.ny;
    const int plane = h * nx;
    float* buf0 = smem;
    float* buf1 = smem + 9 * hmax_nx;  // kBufs 2 only
    float* red = smem + 9 * kBufs * hmax_nx;
    // kBufs 1 only: the carry (the scalars, R, T), then the mask.
    float* spec = red + kScratch;
    float* carry_r = spec + 4;
    float* carry_t = carry_r + 3 * nx;
    uint8_t* m = reinterpret_cast<uint8_t*>(spec + (kBufs == 1 ? carry : 0));

    for (int idx = tid; idx < 9 * plane; idx += kThreads) {
        const int k = idx / plane, o = idx - k * plane;
        buf0[idx] = a[k * gplane + o];
    }
    for (int o = tid; o < plane; o += kThreads) m[o] = mask[o];
    __syncthreads();

    const size_t hrow = (size_t)kHalo * nx;
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
            float* to_n = st.to_n + slot * hrow;
            float* to_s = st.to_s + slot * hrow;
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
                Scope::release(cross);
                Flag(st.flag_n[slot]).store(tag, cuda::memory_order_relaxed);
                Flag(st.flag_s[slot]).store(tag, cuda::memory_order_relaxed);
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
            Flag from(st.own[(tid ? 2 : 0) + slot]);
            while (from.load(cuda::memory_order_acquire) < tag) {
            }
        }
        __syncthreads();

        // Edge rows 0 and h-1 (one row when h is 1), row -1 from the south
        // slot and row h from the north slot.
        const float* hs = st.from_s + slot * hrow;
        const float* hn = st.from_n + slot * hrow;
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
            if (lane == 0) partials[(size_t)s * pstride] = v;
        }
    }

    const float* fin = (kBufs == 2 && (gsteps & 1)) ? buf1 : buf0;
    for (int idx = tid; idx < 9 * plane; idx += kThreads) {
        const int k = idx / plane, o = idx - k * plane;
        res[k * gplane + o] = fin[idx];
    }
}

// The block of count that finishes last (an integer ticket after a
// __threadfence() in each block) sums each step's count partials
// (partials[s * count + b], b in order), a warp a step, into tots[s] *
// scale, and zeroes the ticket for the next launch. No float atomics, so
// repeat runs are bit-identical. Call after strip_steps, whose scratch it
// takes for the ticket's answer.
__device__ __forceinline__ void sum_partials_last(unsigned* ticket,
                                                  int count,
                                                  const float* partials,
                                                  float* tots, int gsteps,
                                                  float scale,
                                                  long long hmax_nx,
                                                  int bufs) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    unsigned* last = reinterpret_cast<unsigned*>(smem + 9 * bufs * hmax_nx +
                                                 2 * kWarps);
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        *last = atomicAdd(ticket, 1u) == (unsigned)(count - 1);
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int s = warp; s < gsteps; s += kWarps) {
        float v = 0.0f;
        for (int p = lane; p < count; p += 32) {
            v += __ldcg(partials + (size_t)s * count + p);
        }
        v = lbm_warp_sum(v);
        if (lane == 0) tots[s] = v * scale;
    }
    if (tid == 0) *ticket = 0u;
}

// Opt fn (an on-chip kernel of kThreads threads) into the card's shared
// memory limit and check that blocks of bytes each can be co-resident on
// device. 0, or a CUDA error code (cudaErrorNotSupported: no cooperative
// launch; cudaErrorCooperativeLaunchTooLarge: too many blocks).
inline int prepare(const void* fn, long long bytes, int blocks, int device) {
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
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        (size_t)bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1 || (long long)per_sm * sms < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    return 0;
}

// A cooperative launch of fn over blocks blocks of kThreads threads and
// bytes of dynamic shared memory; a refused launch never ran, and its
// error is returned here and must not stay behind for the next launch's
// check.
inline int launch(const void* fn, int blocks, void** args, long long bytes,
                  void* stream) {
    cudaError_t err = cudaLaunchCooperativeKernel(
        fn, dim3(blocks), dim3(kThreads), args, (size_t)bytes,
        (cudaStream_t)stream);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace onchip
