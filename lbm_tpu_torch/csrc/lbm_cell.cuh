// The D2Q9 BGK update of one lattice cell, shared by every kernel in this
// directory (fused_step.cu, fused_depth.cu, resident.cu), so all of them
// compute each cell with the same code. Built with -fmad=false (see
// lbm_tpu_torch/ops/_build.py), the same code gives the same bits in
// every kernel.
//
// One call pulls the cell's nine incoming speeds, forces the pulled copy
// of any speed whose source lies on the forced line (the source cell must
// pass the guard: fluid, and its pre-forcing guarded speeds each strictly
// above their weight), then applies bounce-back or BGK relaxation in one
// of three associations, written term by term as
// lbm_tpu/ops/reference.py::_bgk_update_planes:
//   mode 0 paired, mode 1 reference order, mode 2 omega-absorbed.
// Forcing the pulled copy equals forcing first and streaming after, with
// no extra pass or in-place write.
//
// The caller says where the lattice lives. ld(k, o) is speed k of the site
// with linear index o; solid(o) is that site's obstacle flag. A site's
// index is a row offset plus a column: rc/rm/rp are the offsets of the
// cell's own row, the row below (j-1, source of cy=+1) and the row above
// (j+1, source of cy=-1); ic/iw/ie are its own column, the column to the
// west (i-1, source of cx=+1) and to the east (i+1, source of cx=-1).
// The new speeds go to out[9]; the return value is |u|, 0 for an obstacle.
//
// Two forcing modes, a template parameter, so the row mode compiles to the
// code it always was:
// - row mode (kCols false, the physical lattice): f0/f1/f2 say whether
//   rows rc/rm/rp are the forced row;
// - column mode (kCols true, the transposed lattice of a wide grid, the
//   twin of AccelSpec.lanes): f0/f1/f2 say whether columns ic/iw/ie are
//   the forced column. Transposed speed k stores physical speed SIGMA[k]
//   (lbm_tpu_torch/state.py), so the copies pulled from the forced column
//   take +w1 on 2, -w1 on 4, +w2 on 5 and 6, -w2 on 7 and 8, and the
//   guard reads speeds 4, 8 and 7. Streaming and BGK are unchanged:
//   transposed speed k moves in transposed coordinates as physical speed k
//   moves in physical ones.

#pragma once

// The first half of lbm_cell_update: the cell's nine pulled speeds, the
// copies pulled from the forced line forced, into s. The tensor-core stage
// body (lbm_depth.cuh's kStageMxu) runs it and its own equilibrium.
template <bool kCols, class I, class Load, class Solid>
__device__ __forceinline__ void lbm_cell_pull(
    const Load& ld, const Solid& solid, I rc, I rm, I rp, I ic, I iw, I ie,
    bool f0, bool f1, bool f2, float w1, float w2, float (&s)[9]) {
    const float s0 = ld(0, rc + ic);
    float s1 = ld(1, rc + iw);
    float s2 = ld(2, rm + ic);
    float s3 = ld(3, rc + ie);
    float s4 = ld(4, rp + ic);
    float s5 = ld(5, rm + iw);
    float s6 = ld(6, rm + ie);
    float s7 = ld(7, rp + ie);
    float s8 = ld(8, rp + iw);
    // x + (-w) is exactly x - w in IEEE arithmetic.
    if constexpr (!kCols) {
        // The forcing guard of a source site on the forced row.
        auto forced = [&](I o) -> bool {
            return !solid(o) && (ld(3, o) - w1 > 0.0f) &&
                   (ld(6, o) - w2 > 0.0f) && (ld(7, o) - w2 > 0.0f);
        };
        // Deltas: +w1 on 1, -w1 on 3, +w2 on 5 and 8, -w2 on 6 and 7.
        if (f0) {
            if (forced(rc + iw)) s1 = s1 + w1;
            if (forced(rc + ie)) s3 = s3 - w1;
        }
        if (f1) {
            if (forced(rm + iw)) s5 = s5 + w2;
            if (forced(rm + ie)) s6 = s6 - w2;
        }
        if (f2) {
            if (forced(rp + ie)) s7 = s7 - w2;
            if (forced(rp + iw)) s8 = s8 + w2;
        }
    } else {
        // The forcing guard of a source site on the forced column.
        auto forced = [&](I o) -> bool {
            return !solid(o) && (ld(4, o) - w1 > 0.0f) &&
                   (ld(8, o) - w2 > 0.0f) && (ld(7, o) - w2 > 0.0f);
        };
        // Deltas: +w1 on 2, -w1 on 4, +w2 on 5 and 6, -w2 on 7 and 8.
        // The three lanes next to the forced column each pull from it
        // (flags f0, f1, f2 in turn), so one warp holds all three cases.
        // The guards of the two source cells, rm and rp of the forced
        // column, are evaluated once on one path for all three; a flag
        // only picks the speeds. (Two flags hold only where two of
        // ic/iw/ie are the same column, so one pair of guards serves.)
        if (f0 || f1 || f2) {
            const I col = f0 ? ic : (f1 ? iw : ie);
            const bool gm = forced(rm + col), gp = forced(rp + col);
            if (f0) {
                if (gm) s2 = s2 + w1;
                if (gp) s4 = s4 - w1;
            }
            if (f1) {
                if (gm) s5 = s5 + w2;
                if (gp) s8 = s8 - w2;
            }
            if (f2) {
                if (gm) s6 = s6 + w2;
                if (gp) s7 = s7 - w2;
            }
        }
    }
    s[0] = s0, s[1] = s1, s[2] = s2, s[3] = s3, s[4] = s4;
    s[5] = s5, s[6] = s6, s[7] = s7, s[8] = s8;
}

template <bool kCols, class I, class Load, class Solid>
__device__ __forceinline__ float lbm_cell_update(
    const Load& ld, const Solid& solid, I rc, I rm, I rp, I ic, I iw, I ie,
    bool f0, bool f1, bool f2, float w1, float w2, float omega, int mode,
    float out[9]) {
    float p[9];
    lbm_cell_pull<kCols>(ld, solid, rc, rm, rp, ic, iw, ie, f0, f1, f2, w1,
                         w2, p);
    const float s0 = p[0], s1 = p[1], s2 = p[2], s3 = p[3], s4 = p[4];
    const float s5 = p[5], s6 = p[6], s7 = p[7], s8 = p[8];

    const float rho = s0 + s1 + s2 + s3 + s4 + s5 + s6 + s7 + s8;
    const float u_x = (s1 + s5 + s8 - (s3 + s6 + s7)) / rho;
    const float u_y = (s2 + s5 + s6 - (s4 + s7 + s8)) / rho;
    const float u_sq = u_x * u_x + u_y * u_y;

    const float w0 = 4.0f / 9.0f, wa = 1.0f / 9.0f, wd = 1.0f / 36.0f;
    float f[9];
    if (mode == 1) {
        // Reference order: w * rho * (1 + uc*3 + uc*uc*4.5 - u_sq*1.5).
        const float sq = u_sq * 1.5f;
        const float ra = wa * rho, rd = wd * rho;
        auto feq = [&](float wr, float uc) {
            return wr * (1.0f + uc * 3.0f + (uc * uc) * 4.5f - sq);
        };
        f[0] = w0 * rho * (1.0f - sq);
        f[1] = feq(ra, u_x);
        f[2] = feq(ra, u_y);
        f[3] = feq(ra, -u_x);
        f[4] = feq(ra, -u_y);
        f[5] = feq(rd, u_x + u_y);
        f[6] = feq(rd, -u_x + u_y);
        f[7] = feq(rd, -u_x + -u_y);
        f[8] = feq(rd, u_x + -u_y);
    } else {
        // Paired: feq_k = E + O, feq_opp(k) = E - O; mode 2 folds
        // omega into the weight constants.
        const float scale = (mode == 2) ? omega : 1.0f;
        const float base = 1.0f - u_sq * 1.5f;
        const float wrho_a = (wa * scale) * rho;
        const float wrho_d = (wd * scale) * rho;
        const float odd_a = 3.0f * wrho_a;
        const float odd_d = 3.0f * wrho_d;
        auto pair = [&](float wrho, float oddw, float uc, float& plus,
                        float& minus) {
            const float even = wrho * (base + (uc * uc) * 4.5f);
            const float odd = oddw * uc;
            plus = even + odd;
            minus = even - odd;
        };
        f[0] = (w0 * scale) * rho * base;
        pair(wrho_a, odd_a, u_x, f[1], f[3]);
        pair(wrho_a, odd_a, u_y, f[2], f[4]);
        pair(wrho_d, odd_d, u_x + u_y, f[5], f[7]);
        pair(wrho_d, odd_d, u_y - u_x, f[6], f[8]);
    }

    const float s[9] = {s0, s1, s2, s3, s4, s5, s6, s7, s8};
    const int opp[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
    const bool obstacle = solid(rc + ic);
    const float one_m_omega = 1.0f - omega;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        if (obstacle) {
            out[k] = s[opp[k]];
        } else if (mode == 2) {
            out[k] = s[k] * one_m_omega + f[k];
        } else {
            out[k] = s[k] + omega * (f[k] - s[k]);
        }
    }
    return obstacle ? 0.0f : sqrtf(u_sq);
}

// Fixed-order tree over kN shared floats; the sum ends in buf[0]. The
// caller has written buf[0:kN] and not yet synchronised.
template <int kN>
__device__ __forceinline__ void lbm_tree_sum(float* buf, int tid) {
    __syncthreads();
#pragma unroll
    for (int s = kN / 2; s > 0; s >>= 1) {
        if (tid < s) buf[tid] += buf[tid + s];
        __syncthreads();
    }
}
