// A shard's rows with one halo row on each side, for the seam modes
// (fused_step.cu's seam kernel, ring.cu). Shared so both address a shard
// the same way and feed lbm_cell.cuh the same loads.
//
// One signed offset addresses the shard: row r in [-1, h] at column c is
// r * nx + c. Row -1 is the south halo, the last of the k rows of halo_s
// ((9, k, nx), global rows row0-k .. row0-1); row h is the north halo, the
// first row of halo_n ((9, k, nx), global rows row0+h ..). hmask_s and
// hmask_n are the halos' obstacle rows, static copies of the neighbours'
// mask rows, so forcing a halo copy needs no obstacle channel.
//
// Halo rows are raw (pre-step, not forced): the kernel forces every row,
// halo rows included, by the global rule, a row whose global index
// (row0 + r) mod ny_global is the forced row (or, in column mode, the
// forced column of every row). Halo loads go through L2
// only (__ldcg): another block, kernel or card writes them.

#pragma once

#include <stdint.h>

#include "lbm_cell.cuh"

__device__ __forceinline__ int lbm_wrap(int v, int n) {
    const int m = v % n;
    return m < 0 ? m + n : m;
}

struct SeamView {
    const float* src;        // (9, h, nx)
    const uint8_t* mask;     // (h, nx)
    const float* halo_s;     // (9, k, nx)
    const float* halo_n;     // (9, k, nx)
    const uint8_t* hmask_s;  // (k, nx)
    const uint8_t* hmask_n;  // (k, nx)
    int h, nx, k;

    __device__ __forceinline__ float ld(int q, long long o) const {
        const long long plane = (long long)h * nx, hplane = (long long)k * nx;
        if (o < 0) return __ldcg(halo_s + q * hplane + (long long)k * nx + o);
        if (o >= plane) return __ldcg(halo_n + q * hplane + (o - plane));
        return src[q * plane + o];
    }
    __device__ __forceinline__ bool solid(long long o) const {
        const long long plane = (long long)h * nx;
        if (o < 0) return hmask_s[(long long)k * nx + o] != 0;
        if (o >= plane) return hmask_n[o - plane] != 0;
        return mask[o] != 0;
    }
};

// The update of local cell (j, i), j in [0, h), into out[9]; returns |u|
// (0 for an obstacle). Rows j-1 = -1 and j+1 = h read the halos. Row mode
// (kCols false): a row whose global index is accel is forced. Column mode
// (kCols true, a shard of the transposed lattice of a wide grid, sharded
// over its rows): the column accel of every row is forced, halo rows
// included, and row0 / ny_global are not read.
template <bool kCols>
__device__ __forceinline__ float lbm_seam_cell(const SeamView& v, int j, int i,
                                               int row0, int ny_global,
                                               int accel, float w1,
                                               float w2, float omega,
                                               int mode, float out[9]) {
    const int nx = v.nx;
    const int iw = (i == 0) ? nx - 1 : i - 1;
    const int ie = (i == nx - 1) ? 0 : i + 1;
    auto ld = [&](int q, long long o) { return v.ld(q, o); };
    auto solid = [&](long long o) { return v.solid(o); };
    bool f0, f1, f2;
    if constexpr (kCols) {
        f0 = i == accel;
        f1 = iw == accel;
        f2 = ie == accel;
    } else {
        f0 = lbm_wrap(row0 + j, ny_global) == accel;
        f1 = lbm_wrap(row0 + j - 1, ny_global) == accel;
        f2 = lbm_wrap(row0 + j + 1, ny_global) == accel;
    }
    return lbm_cell_update<kCols, long long>(
        ld, solid, (long long)j * nx, (long long)(j - 1) * nx,
        (long long)(j + 1) * nx, (long long)i, (long long)iw, (long long)ie,
        f0, f1, f2, w1, w2, omega, mode, out);
}
