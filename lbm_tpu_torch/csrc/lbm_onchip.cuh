// The on-chip form's strip step (resident_onchip.cu), shared by the
// single-device kernel and the on-chip ring (ring_onchip.cu): one block of
// kThreads threads holds a strip of whole rows in dynamic shared memory
// for all G steps and trades its edge rows with the strips above and below
// through two halo slots per direction, each halo value a 64-bit word that
// carries its step's tag, in either of the two modes (two buffers, or one
// buffer updated in place in waves with a carry). resident_onchip.cu's
// header comment describes the design; what differs between the two
// kernels is where a strip's neighbours are: the Strip a kernel hands to
// strip_steps names the slots it sends into and reads from and the global
// row of its row 0 (forcing), and Scope the memory scope of its words.

#pragma once

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

// Floats the single-buffer mode carries across its waves: four scalars
// (the x wrap's slots), then R and T (three speeds of a row each) as far as
// the tallest strip needs them.
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

// The scalars of the carry (see the single-buffer mode): two slots, by
// row parity, of a row's column-0 speed 3 (kZ3) and of the row below's
// column-0 speed 6 (kZ6), which column nx-1 pulls across the x wrap.
enum { kZ3 = 0, kZ6 = 2 };

// Waves by which the single-buffer mode defers the stores of a wave's
// speeds 2, 5, 6 in a strip of h rows of nx cells (ops/resident.py's
// inplace_delay; its other speeds wait one): the row above pulls them up
// to nx + 1 positions later, so where a strip has two rows or more and a
// row is wider than a wave, three waves (rows up to 3 kThreads - 1 wide;
// smem_bytes allows no wider two-row strip on an H100); else one.
__host__ __device__ inline int inplace_delay(int h, int nx) {
    return (h >= 2 && nx > kThreads) ? 3 : 1;
}

// A compile-time delay for a generic lambda.
template <int D>
struct Delay {
    static constexpr int value = D;
};

// A block-wide barrier in shared memory split into arrive and wait: every
// thread arrives once a phase and waits on the phase's parity. A thread
// arrives for phase k + 1 only after its wait on phase k returned, so one
// barrier serves every wave.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
    asm volatile(
        "{\n\t.reg .b64 st;\n\t"
        "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(a)
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
    unsigned done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}

// A halo value as one 64-bit word: the float's bits in the low half, the
// tag of the step it is for (step + 1) in the high half. A word is stored
// and loaded with one 64-bit access, which the PTX memory model makes
// single-copy atomic, so a reader that sees its step's tag sees that
// step's value: the word is its own flag.
using Word = unsigned long long;

__device__ __forceinline__ Word halo_word(float v, unsigned tag) {
    Word w;
    asm("mov.b64 %0, {%1, %2};" : "=l"(w) : "r"(__float_as_uint(v)), "r"(tag));
    return w;
}

// Relaxed strong accesses at device scope, or at system scope (sys) where
// a neighbour may be on another card. Strong: a load is never served from
// a stale L1 line, so a poll sees the store once it lands in L2. Volatile:
// each poll is issued as often as the loop asks. No memory clobber: what a
// reader needs is in the word itself, so nothing else is ordered by them
// (a send's order after its thread's reads is a data dependency, and the
// block barrier orders one buffer's sends and the first step's).
__device__ __forceinline__ void put_word(Word* p, Word w, bool sys) {
    if (sys) {
        asm volatile("st.relaxed.sys.global.b64 [%0], %1;" ::"l"(p), "l"(w));
    } else {
        asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w));
    }
}

__device__ __forceinline__ Word get_word(const Word* p, bool sys) {
    Word w;
    if (sys) {
        asm volatile("ld.relaxed.sys.global.b64 %0, [%1];" : "=l"(w) : "l"(p));
    } else {
        asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p));
    }
    return w;
}

// The halo values an edge cell at column i pulls, each once its word holds
// tag: south (row 0) speeds 2, 5, 6 from the south slot hs at i, iw, ie
// into v[0..2]; north (row h-1) speeds 4, 7, 8 from the north slot hn at
// i, ie, iw into v[3..5]; the other entries of v are left alone. Every
// load issues before the first test, and one loop reloads every word whose
// tag is not there yet at once: a loop a word would split a warp's lanes
// over up to six spin loops, which the warp runs one after another.
__device__ __forceinline__ void pull_halo(const Word* hs, const Word* hn,
                                          bool south, bool north, int nx,
                                          int i, int iw, int ie,
                                          unsigned tag, bool sys,
                                          float v[6]) {
    const Word* p[6] = {hs + i,  hs + nx + iw, hs + 2 * nx + ie,
                        hn + i,  hn + nx + ie, hn + 2 * nx + iw};
    Word w[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
        if (q < 3 ? south : north) w[q] = get_word(p[q], sys);
    }
    for (;;) {
        bool late = false;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            late |= (q < 3 ? south : north) && (unsigned)(w[q] >> 32) != tag;
        }
        if (!late) break;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            if ((q < 3 ? south : north) && (unsigned)(w[q] >> 32) != tag) {
                w[q] = get_word(p[q], sys);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
        v[q] = (q < 3 ? south : north) ? __uint_as_float((unsigned)w[q])
                                       : v[q];
    }
}

// The three halo words an edge cell pulls from one slot (row, kHalo rows
// of nx words): speed slot q's word at column c[q] (row 0 pulls speeds 2,
// 5, 6 from the south slot at i, iw, ie; row h-1 speeds 4, 7, 8 from the
// north slot at i, ie, iw). fetch issues their loads; settle reloads, in
// one loop, every word whose tag is not there yet, until all hold it. The
// single-buffer gathers read shared memory between the two, while the
// words travel.
struct HaloWords {
    const Word* row;
    int nx, c0, c1, c2;
    Word w[3];

    __device__ __forceinline__ const Word* at(int q) const {
        return row + q * nx + (q == 0 ? c0 : (q == 1 ? c1 : c2));
    }
    __device__ __forceinline__ void fetch(bool sys) {
#pragma unroll
        for (int q = 0; q < 3; ++q) w[q] = get_word(at(q), sys);
    }
    __device__ __forceinline__ void settle(unsigned tag, bool sys) {
        for (;;) {
            bool late = false;
#pragma unroll
            for (int q = 0; q < 3; ++q) late |= (unsigned)(w[q] >> 32) != tag;
            if (!late) break;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                if ((unsigned)(w[q] >> 32) != tag) w[q] = get_word(at(q), sys);
            }
        }
    }
    __device__ __forceinline__ float value(int q) const {
        return __uint_as_float((unsigned)w[q]);
    }
};

// The guard of a forced site (lbm_cell.cuh) whose speed k is at(k):
// fluid, and its guarded speeds each strictly above their weight after
// the subtraction.
template <bool kCols, class At>
__device__ __forceinline__ bool guard(const At& at, bool solid, float w1,
                                      float w2) {
    if constexpr (kCols) {
        return !solid && (at(4) - w1 > 0.0f) && (at(8) - w2 > 0.0f) &&
               (at(7) - w2 > 0.0f);
    } else {
        return !solid && (at(3) - w1 > 0.0f) && (at(6) - w2 > 0.0f) &&
               (at(7) - w2 > 0.0f);
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
    float* f = buf + o;
    auto at = [&](int k) { return f[k * plane]; };
    if (!guard<kCols>(at, solid, w1, w2)) return;
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

// The three copies a cell at column c sends, its speed k at(k), as words
// of tag into the slot to (kHalo rows of nx words), forced where the cell
// is on the forced line (on) and passes the guard (the deltas of
// ops/reference.forcing; a zero delta is not added). kNorth: speeds 2, 5,
// 6 to the strip above; else 4, 7, 8 to the strip below.
template <bool kCols, bool kNorth, class At>
__device__ __forceinline__ void send_cell(const At& at, bool solid, bool on,
                                          float w1, float w2, Word* to,
                                          int c, int nx, unsigned tag,
                                          bool sys) {
    const bool g = on && guard<kCols>(at, solid, w1, w2);
    float q0, q1, q2;
    if constexpr (kNorth) {
        q0 = at(2);
        q1 = at(5);
        q2 = at(6);
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
        q0 = at(4);
        q1 = at(7);
        q2 = at(8);
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
    put_word(to + c, halo_word(q0, tag), sys);
    put_word(to + nx + c, halo_word(q1, tag), sys);
    put_word(to + 2 * nx + c, halo_word(q2, tag), sys);
}

// What a deferred store of the single-buffer mode writes: a cell's nine
// speeds, the six the row above does not pull, or that row's three (2, 5,
// 6, given in that order).
enum { kAll, kEarly, kLate };

__device__ __forceinline__ void store_cell(float* buf, int plane, int o,
                                           const float* v, int part) {
    if (part == kLate) {
        buf[2 * plane + o] = v[0];
        buf[5 * plane + o] = v[1];
        buf[6 * plane + o] = v[2];
        return;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        if (part == kAll || (k != 2 && k != 5 && k != 6)) {
            buf[k * plane + o] = v[k];
        }
    }
}

// One phase of the single-buffer mode: n positions in waves of kThreads,
// thread t at positions t, t + kThreads, ... in that order. Wave k:
// gather(k, p, sp, solid) pulls position p's nine speeds and returns its
// offset in the strip; the thread arrives, computes the cell into
// registers, waits until every thread has gathered wave k, then stores
// wave k - 1 (put(o, v, part)). The row above pulls a cell's speeds 2, 5
// and 6 up to nx + 1 positions later, the others come from at most a
// position away (but for column 0's speed 3, which column nx-1 pulls nx - 1
// back), so with kD > 1 (rows wider than a wave) wave k - 1 stores its
// other six and speeds 2, 5, 6 wait in registers until wave k - 1 + kD.
// So at wave k's gather no speed 2, 5 or 6 of a position at or above
// (k - kD) kThreads, and no other speed of one at or above (k - 1)
// kThreads, has landed. The last waves are stored after the last wait;
// the caller's next __syncthreads orders them.
template <bool kCols, int kMode, int kD, class Gather, class Put>
__device__ __forceinline__ void inplace_waves(int n, uint64_t* bar,
                                              unsigned& phase, float w1,
                                              float w2, float omega,
                                              float& acc, Gather gather,
                                              Put put) {
    constexpr int kL = kD > 1 ? kD - 1 : 1;
    const int tid = threadIdx.x;
    const int waves = (n + kThreads - 1) / kThreads;
    // Wave k - 1's cell, and speeds 2, 5, 6 of waves k - 2 .. k - kD.
    float held[9], late[kL][3];
    int held_o = -1, late_o[kL];
    for (int k = 0; k < waves; ++k) {
        const int p = k * kThreads + tid;
        float sp[9], cell[9];
        bool solid = false;
        const int o = p < n ? gather(k, p, sp, solid) : -1;
        mbar_arrive(bar);
        if (o >= 0) {
            acc += update_pulled<kCols>(sp, solid, w1, w2, omega, kMode,
                                        cell);
        }
        mbar_wait(bar, phase & 1u);
        ++phase;
        if constexpr (kD == 1) {
            if (k >= 1) put(held_o, held, kAll);
        } else {
            if (k >= kD) put(late_o[kD - 2], late[kD - 2], kLate);
#pragma unroll
            for (int s = kD - 2; s > 0; --s) {
                late_o[s] = late_o[s - 1];
#pragma unroll
                for (int v = 0; v < 3; ++v) late[s][v] = late[s - 1][v];
            }
            if (k >= 1) {
                late_o[0] = held_o;
                late[0][0] = held[2];
                late[0][1] = held[5];
                late[0][2] = held[6];
                put(held_o, held, kEarly);
            }
        }
        held_o = o;
        if (o >= 0) {
#pragma unroll
            for (int v = 0; v < 9; ++v) held[v] = cell[v];
        }
    }
    if (waves >= 1) put(held_o, held, kAll);
    if constexpr (kD > 1) {
#pragma unroll
        for (int s = 0; s < kD - 1; ++s) {
            if (waves - 2 - s >= 0) put(late_o[s], late[s], kLate);
        }
    }
}

// One strip and its links. Each slot pointer is a direction's slot 0,
// its slot 1 kHalo * nx words on.
struct Strip {
    int h;                // rows
    int row0;             // global row of row 0 (row-mode forcing)
    int ny;               // global rows (the wrap of the forcing flags)
    Word* to_n;           // the north neighbour's south slots
    Word* to_s;           // the south neighbour's north slots
    const Word* from_s;   // this strip's south slots (row -1)
    const Word* from_n;   // this strip's north slots (row h)
};

// The scope of the halo words: one card, or (SystemScope, a launch where
// some neighbour is on another card: peer pointers) the system.
struct DeviceScope {
    static constexpr bool kSystem = false;
};

struct SystemScope {
    static constexpr bool kSystem = true;
};

// gsteps steps of the strip st whose rows start at a (its row 0's speed 0;
// speed k at k * gplane), the result to res at the same offsets (a and res
// may be the same buffer: each thread writes back exactly the cells it
// loaded), its mask rows at mask. hmax_nx and carry: the tallest strip's
// floats and carry floats (every strip of a launch lays out its shared
// memory alike). Step s's sum of |u| over the strip's fluid cells goes to
// partials[s * pstride]. step_base: steps these slots have run before.
//
// The exchange (both modes). Step t's halo words carry tag t + 1 in slot
// t mod 2. Two buffers: step 0 of a launch sends the loaded strip's edge
// rows; each later step's words are sent by the thread that updates the
// edge cell, from the new speeds in its registers, during the step before
// (step G-1 sends nothing: the next launch sends its own first step). One
// buffer: each step sends its edge rows, forced in place, at its start.
// The receiver waits, thread by thread, only on the words its cell pulls,
// until each holds the step's tag; no fence, no flag, no barrier. A word
// a thread sends depends on the words it read (a data dependency: the new
// speeds are computed from them; one buffer: behind the block's barrier
// after every edge cell's update), so its reads of a slot come before its
// send in memory order (resident_onchip.cu: the two-slot argument).
template <bool kCols, int kMode, int kBufs, class Scope>
__device__ __forceinline__ void strip_steps(
    const Strip& st, const float* a, float* res,
    const uint8_t* __restrict__ mask, size_t gplane, int nx, int accel,
    float w1, float w2, float omega,
    int gsteps, unsigned step_base, long long hmax_nx, long long carry,
    float* partials, int pstride) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int h = st.h, r0 = st.row0, ny = st.ny;
    const int plane = h * nx;
    constexpr bool sys = Scope::kSystem;
    float* buf0 = smem;
    float* buf1 = smem + 9 * hmax_nx;  // kBufs 2 only
    float* red = smem + 9 * kBufs * hmax_nx;
    // kBufs 1 only: the carry (the wrap's slots, R, T), then the mask; its
    // barrier in the scratch's last three floats (red[64] is the ticket's
    // answer), where they hold 8-aligned bytes.
    float* wrap_slot = red + kScratch;
    float* carry_r = wrap_slot + 4;
    float* carry_t = carry_r + 3 * nx;
    uint8_t* m =
        reinterpret_cast<uint8_t*>(wrap_slot + (kBufs == 1 ? carry : 0));
    uint64_t* bar = reinterpret_cast<uint64_t*>(
        red + 2 * kWarps + ((hmax_nx & 1) ? 1 : 2));
    unsigned phase = 0;
    if constexpr (kBufs == 1) {
        if (tid == 0) mbar_init(bar, kThreads);
    }

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
            // Column mode: the forced column, a cell a row, then a barrier.
            // Row mode: an interior row here (the send barrier orders it
            // before the interior's pulls), an edge row by the threads
            // that send it, each its column just before its send.
            if constexpr (kCols) {
                for (int j = tid; j < h; j += kThreads) {
                    const int o = j * nx + accel;
                    force_in_place<true>(dst, plane, o, m[o] != 0, w1, w2);
                }
                __syncthreads();
            } else if (r0 < accel && accel < r0 + h - 1) {
                const int rj = (accel - r0) * nx;
                for (int c = tid; c < nx; c += kThreads) {
                    force_in_place<false>(dst, plane, rj + c, m[rj + c] != 0,
                                          w1, w2);
                }
            }
        }

        // Send from the strip: the top row north, the bottom row south (two
        // buffers: step 0 only, the copies forced by the sender; one
        // buffer: every step, the strip forced in place already).
        if (kBufs == 1 || s == 0) {
            Word* to_n = st.to_n + slot * hrow;
            Word* to_s = st.to_s + slot * hrow;
            const bool top_on = kBufs == 2 && r0 + h - 1 == accel;
            const bool bot_on = kBufs == 2 && r0 == accel;
            const int last = (h - 1) * nx;
            for (int c = tid; c < nx; c += kThreads) {
                const bool col_on = kBufs == 2 && c == accel;
                if constexpr (kBufs == 1 && !kCols) {
                    if (r0 == accel) {
                        force_in_place<false>(dst, plane, c, m[c] != 0, w1,
                                              w2);
                    } else if (r0 + h - 1 == accel) {
                        force_in_place<false>(dst, plane, last + c,
                                              m[last + c] != 0, w1, w2);
                    }
                }
                auto top = [&](int k) { return src[k * plane + last + c]; };
                auto bot = [&](int k) { return src[k * plane + c]; };
                send_cell<kCols, true>(top, m[last + c] != 0,
                                       kCols ? col_on : top_on, w1, w2, to_n,
                                       c, nx, tag, sys);
                send_cell<kCols, false>(bot, m[c] != 0,
                                        kCols ? col_on : bot_on, w1, w2, to_s,
                                        c, nx, tag, sys);
            }
            // One buffer, row mode: the interior pulls the row forced in
            // place above (column mode: behind the forcing's barrier).
            if (kBufs == 1 && !kCols && r0 <= accel && accel < r0 + h) {
                __syncthreads();
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
            // In place, in waves over interior position p = r nx + i (row
            // j = 1 + r). Every pull reads the buffer: no position that a
            // wave pulls has been stored yet (inplace_waves), but for the
            // x wrap's speed 6, which column nx-1 pulls from column 0 of
            // the row below, 2 nx - 1 positions back, from its slot where
            // that cell's store may have landed; column nx-1 of the row
            // below fills the slot at its own gather, a wave or more
            // before; where a row is wider than a wave, its speed 3 from
            // its column 0 likewise (z3). Row 1 copies its old speeds 4,
            // 7, 8 into T and row
            // h-2 its old 2, 5, 6 into R just before their stores land:
            // the edge rows pull them there.
            float* buf = dst;
            float* z3 = wrap_slot + kZ3;
            float* z6 = wrap_slot + kZ6;
            auto interior = [&](auto delay) {
                constexpr int kD = decltype(delay)::value;
                auto gather = [&](int k, int p, float* sp, bool& solid) {
                    const int r = p / nx, i = p - r * nx;
                    const int rj = (1 + r) * nx, o = rj + i;
                    const int rm = rj - nx, rp = rj + nx;
                    const int iw = (i == 0) ? nx - 1 : i - 1;
                    const int ie = (i == nx - 1) ? 0 : i + 1;
                    const int lo = (k - kD) * kThreads;
                    sp[0] = buf[o];
                    sp[1] = buf[plane + rj + iw];
                    sp[2] = buf[2 * plane + rm + i];
                    sp[3] = (kD > 1 && i == nx - 1 &&
                             p - nx + 1 < (k - 1) * kThreads)
                                ? z3[r & 1]
                                : buf[3 * plane + rj + ie];
                    sp[4] = buf[4 * plane + rp + i];
                    sp[5] = buf[5 * plane + rm + iw];
                    sp[6] = (r > 0 && i == nx - 1 && p - 2 * nx + 1 < lo)
                                ? z6[(r - 1) & 1]
                                : buf[6 * plane + rm + ie];
                    sp[7] = buf[7 * plane + rp + ie];
                    sp[8] = buf[8 * plane + rp + iw];
                    if (i == nx - 1 && r + 1 < h - 2 &&
                        p - nx + 1 < ((p + nx) / kThreads - kD) * kThreads) {
                        z6[r & 1] = buf[6 * plane + rj];
                    }
                    if (kD > 1 && i == 0 &&
                        p < ((p + nx - 1) / kThreads - 1) * kThreads) {
                        z3[r & 1] = buf[3 * plane + rj];
                    }
                    solid = m[o] != 0;
                    return o;
                };
                auto put = [&](int o, const float* v, int part) {
                    if (o < 0) return;
                    if (part != kLate && o < 2 * nx) {
                        const int i = o - nx;
                        carry_t[i] = buf[4 * plane + o];
                        carry_t[nx + i] = buf[7 * plane + o];
                        carry_t[2 * nx + i] = buf[8 * plane + o];
                    }
                    if (part != kEarly && o >= (h - 2) * nx) {
                        const int i = o - (h - 2) * nx;
                        carry_r[i] = buf[2 * plane + o];
                        carry_r[nx + i] = buf[5 * plane + o];
                        carry_r[2 * nx + i] = buf[6 * plane + o];
                    }
                    store_cell(buf, plane, o, v, part);
                };
                inplace_waves<kCols, kMode, kD>(n_inner, bar, phase, w1, w2,
                                                omega, acc, gather, put);
            };
            if (inplace_delay(h, nx) == 1) {
                interior(Delay<1>{});
            } else {
                interior(Delay<3>{});
            }
        }

        // One buffer: the interior's last stores land before the edge
        // waves pull (inplace_waves).
        if constexpr (kBufs == 1) __syncthreads();

        // Edge rows 0 and h-1 (one row when h is 1), row -1 from the south
        // slot and row h from the north slot, each value once its word
        // holds this step's tag.
        const Word* hs = st.from_s + slot * hrow;
        const Word* hn = st.from_n + slot * hrow;
        const int n_edge = (h == 1 ? 1 : 2) * nx;
        if constexpr (kBufs == 2) {
            // Step s + 1's words, sent from the update.
            const bool send = s + 1 < gsteps;
            Word* to_n = st.to_n + (slot ^ 1) * hrow;
            Word* to_s = st.to_s + (slot ^ 1) * hrow;
            auto solid = [&](int o) {
                return o < 0 || o >= plane || m[o] != 0;
            };
            for (int idx = tid; idx < n_edge; idx += kThreads) {
                const bool top = idx >= nx;
                const int j = top ? h - 1 : 0, i = top ? idx - nx : idx;
                const int iw = (i == 0) ? nx - 1 : i - 1;
                const int ie = (i == nx - 1) ? 0 : i + 1;
                const int rj = j * nx, g = r0 + j;
                const bool south = j == 0, north = j == h - 1;
                float hv[6] = {};
                pull_halo(hs, hn, south, north, nx, i, iw, ie, tag, sys, hv);
                // A halo site is solid to the guard: only the pulled
                // speeds 2, 5, 6 (row -1) and 4, 7, 8 (row h) are read.
                auto ld = [&](int k, int o) -> float {
                    if (o < 0) return k == 2 ? hv[0] : (k == 5 ? hv[1] : hv[2]);
                    if (o >= plane) {
                        return k == 4 ? hv[3] : (k == 7 ? hv[4] : hv[5]);
                    }
                    return src[k * plane + o];
                };
                const bool f0 = kCols ? i == accel : g == accel;
                const bool f1 = kCols ? iw == accel : wrap(g - 1) == accel;
                const bool f2 = kCols ? ie == accel : wrap(g + 1) == accel;
                acc += lbm_cell_update<kCols, int>(
                    ld, solid, rj, rj - nx, rj + nx, i, iw, ie, f0, f1, f2,
                    w1, w2, omega, kMode, cell);
#pragma unroll
                for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = cell[k];
                if (send) {
                    auto at = [&](int k) { return cell[k]; };
                    const bool sc = m[rj + i] != 0;
                    if (north) {
                        send_cell<kCols, true>(
                            at, sc, kCols ? i == accel : r0 + h - 1 == accel,
                            w1, w2, to_n, i, nx, tag + 1u, sys);
                    }
                    if (south) {
                        send_cell<kCols, false>(
                            at, sc, kCols ? i == accel : r0 == accel, w1, w2,
                            to_s, i, nx, tag + 1u, sys);
                    }
                }
            }
        } else {
            // In place, in waves over edge position e: row 0 at e = i, row
            // h-1 at e = nx + i. Row 0 pulls row 1 from T (h > 2), the
            // buffer (h = 2: row 1 is stored after it) or the north slot
            // (h = 1); row h-1 pulls row h-2 from R (h > 2) or, h = 2, row
            // 0 from the buffer as the interior pulls its row below, the
            // x wrap's speed 6 from its slot. A one-row strip's column nx-1
            // pulls speed 3 from its own column 0, nx - 1 back: from the
            // z3 slot where that cell's store may have landed.
            float* buf = dst;
            float* z3 = wrap_slot + kZ3;
            float* z6 = wrap_slot + kZ6;
            auto edge = [&](auto delay) {
                constexpr int kD = decltype(delay)::value;
                auto gather = [&](int k, int e, float* sp, bool& solid) {
                    const bool top = e >= nx;
                    const int r = top ? 1 : 0, i = top ? e - nx : e;
                    const int rj = top ? (h - 1) * nx : 0, o = rj + i;
                    const int iw = (i == 0) ? nx - 1 : i - 1;
                    const int ie = (i == nx - 1) ? 0 : i + 1;
                    const int lo = (k - kD) * kThreads;
                    // The cell's halo words: their loads first, the
                    // shared memory gathers while they travel, then the
                    // wait (a one-row strip's north words after its
                    // south words: three words live at once).
                    HaloWords hw{top ? hn : hs, nx, i, top ? ie : iw,
                                 top ? iw : ie};
                    hw.fetch(sys);
                    sp[0] = buf[o];
                    sp[1] = buf[plane + rj + iw];
                    sp[3] = (i == nx - 1 && e - nx + 1 < (k - 1) * kThreads)
                                ? z3[r]
                                : buf[3 * plane + rj + ie];
                    if (!top) {
                        if (h == 2) {
                            sp[4] = buf[4 * plane + nx + i];
                            sp[7] = buf[7 * plane + nx + ie];
                            sp[8] = buf[8 * plane + nx + iw];
                        } else if (h > 2) {
                            sp[4] = carry_t[i];
                            sp[7] = carry_t[nx + ie];
                            sp[8] = carry_t[2 * nx + iw];
                        }
                    } else {
                        if (h == 2) {
                            sp[2] = buf[2 * plane + i];
                            sp[5] = buf[5 * plane + iw];
                            sp[6] = (i == nx - 1 && e - 2 * nx + 1 < lo)
                                        ? z6[0]
                                        : buf[6 * plane + ie];
                        } else {
                            sp[2] = carry_r[i];
                            sp[5] = carry_r[nx + iw];
                            sp[6] = carry_r[2 * nx + ie];
                        }
                    }
                    hw.settle(tag, sys);
                    if (!top) {
                        sp[2] = hw.value(0);
                        sp[5] = hw.value(1);
                        sp[6] = hw.value(2);
                        if (h == 1) {
                            HaloWords up{hn, nx, i, ie, iw};
                            up.fetch(sys);
                            up.settle(tag, sys);
                            sp[4] = up.value(0);
                            sp[7] = up.value(1);
                            sp[8] = up.value(2);
                        }
                    } else {
                        sp[4] = hw.value(0);
                        sp[7] = hw.value(1);
                        sp[8] = hw.value(2);
                    }
                    if (i == 0 &&
                        e < ((e + nx - 1) / kThreads - 1) * kThreads) {
                        z3[r] = buf[3 * plane + rj];
                    }
                    if (h == 2 && i == nx - 1 && !top &&
                        e - nx + 1 < ((e + nx) / kThreads - kD) * kThreads) {
                        z6[0] = buf[6 * plane];
                    }
                    solid = m[o] != 0;
                    return o;
                };
                auto put = [&](int o, const float* v, int part) {
                    if (o >= 0) store_cell(buf, plane, o, v, part);
                };
                inplace_waves<kCols, kMode, kD>(n_edge, bar, phase, w1, w2,
                                                omega, acc, gather, put);
            };
            if (inplace_delay(h, nx) == 1) {
                edge(Delay<1>{});
            } else {
                edge(Delay<3>{});
            }
        }

        // The block's sum of this step: warps, then the warps' sums. The
        // step's one barrier (two buffers) orders the warp sums before
        // the last warp reads them and this step's cells before the next
        // step's pulls; the two steps' scratch alternate, so the last warp
        // reads this step's while the others start the next. The last
        // warp: the edge cells are the first threads', which the sum would
        // hold back where a strip's edge rows have fewer cells than the
        // block has threads.
        acc = lbm_warp_sum(acc);
        float* wsum = red + (s & 1) * kWarps;
        if (lane == 0) wsum[warp] = acc;
        __syncthreads();
        if (warp == kWarps - 1) {
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
