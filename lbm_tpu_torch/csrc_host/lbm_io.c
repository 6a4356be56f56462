/*
 * lbm_tpu_torch host I/O: the .dat writers and the obstacle parser in C.
 *
 * final_state.dat is nx*ny lines of seven fields, four of them %.12E
 * (16.8M lines, ~1.5 GB at 16384x1024); formatting it in Python costs
 * several times the whole scene's compute on the card. This file writes
 * the same bytes as the numpy writers of lbm_tpu_torch/io.py (the plain
 * versions the tests hold it to) and parses obstacle files with the
 * errors of lbm_tpu_torch/obstacles.py.
 *
 * Plain C with a C ABI: no Python.h, bound with ctypes by io.py and
 * obstacles.py, built by ops/_build.py:build_host with the host
 * compiler. Every entry point returns 0, an errno value (> 0) for a
 * failed open, read or write, or a parse code (< 0, lbm_read_obstacles).
 */

#include <errno.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef unsigned __int128 u128;

/* 10^s and floor(max u128 / 10^s) for s = 0..38, filled once when the
 * library is loaded, before any call can read them. */
static u128 POW10[39], LIMIT[39];

__attribute__((constructor)) static void init_pow10(void)
{
    u128 p = 1;
    for (int s = 0; s <= 38; s++) {
        POW10[s] = p;
        LIMIT[s] = ~(u128)0 / p;
        p *= 10;
    }
}

static int put_uint(char *out, uint64_t v)
{
    char tmp[24];
    int n = 0;
    do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    for (int i = 0; i < n; i++) out[i] = tmp[n - 1 - i];
    return n;
}

static int put_int(char *out, int64_t v)
{
    if (v < 0) {
        out[0] = '-';
        return 1 + put_uint(out + 1, (uint64_t)0 - (uint64_t)v);
    }
    return put_uint(out, (uint64_t)v);
}

/*
 * floor(m * 2^e * 10^s) into *q and the rounding of the rest: 1 when it
 * is above one half, 0 at exactly one half, -1 below (and for no rest).
 * Returns 0 when the exact product does not fit 128 bits.
 */
static int scaled(uint64_t m, int e, int s, u128 *q, int *rest)
{
    u128 num, den;
    if (s >= 0) {
        if (s > 38 || (u128)m > LIMIT[s]) return 0;
        num = (u128)m * POW10[s];
        if (e >= 0) {
            if (e > 126 || num > (~(u128)0 >> e)) return 0;
            *q = num << e;
            *rest = -1;
            return 1;
        }
        if (-e > 126) return 0;
        /* The common case: a shift, no division. */
        const int sh = -e;
        const u128 mask = ((u128)1 << sh) - 1, half = (u128)1 << (sh - 1);
        const u128 r = num & mask;
        *q = num >> sh;
        *rest = r > half ? 1 : (r == half ? 0 : -1);
        return 1;
    }
    if (-s > 38) return 0;
    den = POW10[-s];
    if (e >= 0) {
        if (e > 126 || (u128)m > (~(u128)0 >> e)) return 0;
        num = (u128)m << e;
    } else {
        if (-e > 126 || den > (~(u128)0 >> -e)) return 0;
        num = m;
        den <<= -e;
    }
    *q = num / den;
    const u128 r = num % den, r2 = r << 1;
    *rest = (r >> 127) || r2 > den ? 1 : (r2 == den ? 0 : -1);
    return 1;
}

static const char DIGIT_PAIRS[201] =
    "00010203040506070809101112131415161718192021222324252627282930313233"
    "34353637383940414243444546474849505152535455565758596061626364656667"
    "6869707172737475767778798081828384858687888990919293949596979899";

/* The six digits of v < 10^6. */
static void put6(char *out, uint32_t v)
{
    const uint32_t a = v / 10000, b = v % 10000;
    memcpy(out, DIGIT_PAIRS + 2 * a, 2);
    memcpy(out + 2, DIGIT_PAIRS + 2 * (b / 100), 2);
    memcpy(out + 4, DIGIT_PAIRS + 2 * (b % 100), 2);
}

/*
 * Python's "%.12E" % v: 13 significant digits of the exact binary value,
 * rounded half to even, as glibc's printf rounds them; a NaN of either
 * sign prints "NAN" (printf would print "-NAN"). Returns the length.
 */
static int fmt_e12(char *out, double v)
{
    uint64_t bits;
    memcpy(&bits, &v, 8);
    const int biased = (int)((bits >> 52) & 0x7ff);
    uint64_t m = bits & ((1ULL << 52) - 1);
    char *p = out;
    if (biased == 0x7ff) {
        if (m) { memcpy(out, "NAN", 3); return 3; }
        if (bits >> 63) *p++ = '-';
        memcpy(p, "INF", 3);
        return (int)(p - out) + 3;
    }
#ifdef LBM_IO_PRINTF_ONLY
    /* The printf-only build that scripts/writer_ab_torch.py times
     * against this formatter: the same bytes, glibc for every field. */
    return snprintf(out, 32, "%.12E", v);
#endif
    if (bits >> 63) *p++ = '-';
    if (biased == 0 && m == 0) {
        memcpy(p, "0.000000000000E+00", 18);
        return (int)(p - out) + 18;
    }
    if (biased == 0) {
        /* Subnormal doubles: glibc's printf, exact too. */
        return (int)(p - out) + snprintf(p, 32, "%.12E", fabs(v));
    }
    m |= 1ULL << 52;
    int e = biased - 1075;  /* |v| = m * 2^e */
    const int tz = __builtin_ctzll(m);
    m >>= tz;
    e += tz;
    /* floor(log10 |v|) or one less: floor(log2 |v|) * log10(2). */
    const int e_bin = 63 - __builtin_clzll(m) + e;
    int k = (e_bin * 78913) >> 18;
    for (int tries = 0; tries < 3; tries++) {
        u128 q;
        int rest;
        if (!scaled(m, e, 12 - k, &q, &rest)) break;
        if (q >= (u128)10000000000000ULL) { k++; continue; }
        if (q < (u128)1000000000000ULL) { k--; continue; }
        uint64_t d = (uint64_t)q;
        if (rest > 0 || (rest == 0 && (d & 1))) d++;
        if (d == 10000000000000ULL) { d = 1000000000000ULL; k++; }
        const uint64_t lo = d % 1000000000000ULL;
        p[0] = (char)('0' + d / 1000000000000ULL);
        p[1] = '.';
        put6(p + 2, (uint32_t)(lo / 1000000));
        put6(p + 8, (uint32_t)(lo % 1000000));
        p[14] = 'E';
        p[15] = k < 0 ? '-' : '+';
        const int ak = k < 0 ? -k : k;
        int n = 16;
        if (ak < 10) p[n++] = '0';
        n += put_uint(p + n, (uint64_t)ak);
        return (int)(p - out) + n;
    }
    /* Outside the exact 128-bit range (|v| below ~1e-26 or above
     * ~1e25): glibc's printf, exact too. */
    return (int)(p - out) + snprintf(p, 32, "%.12E", fabs(v));
}

enum { BUF_BYTES = 1 << 22, LINE_MAX_BYTES = 256 };

typedef struct {
    FILE *fp;
    char *buf;
    size_t len;
    int err;
} Out;

static int out_open(Out *o, const char *path)
{
    o->len = 0;
    o->err = 0;
    o->buf = malloc(BUF_BYTES);
    if (o->buf == NULL) return ENOMEM;
    o->fp = fopen(path, "wb");
    if (o->fp == NULL) {
        const int err = errno ? errno : EIO;
        free(o->buf);
        return err;
    }
    return 0;
}

static void out_flush(Out *o)
{
    if (o->len && !o->err && fwrite(o->buf, 1, o->len, o->fp) != o->len)
        o->err = errno ? errno : EIO;
    o->len = 0;
}

static char *out_reserve(Out *o)
{
    if (o->len + LINE_MAX_BYTES > BUF_BYTES) out_flush(o);
    return o->buf + o->len;
}

/* A failed flush mid-file and a failed close both report. */
static int out_close(Out *o)
{
    out_flush(o);
    int err = o->err;
    if (fclose(o->fp) != 0 && !err) err = errno ? errno : EIO;
    free(o->buf);
    return err;
}

static double field(const void *a, int f64, size_t i)
{
    return f64 ? ((const double *)a)[i] : (double)((const float *)a)[i];
}

/*
 * final_state.dat: "ii jj u_x u_y |u| pressure obstacle" per cell,
 * row-major over (jj, ii) (d2q9-bgk.c:710-741). The four fields are
 * C-contiguous (ny, nx) float32 (f64 == 0) or float64 (f64 == 1);
 * obstacles is int32 (ny, nx).
 */
int lbm_write_final_state(const char *path, int nx, int ny, const void *u_x,
                          const void *u_y, const void *u,
                          const void *pressure, const int32_t *obstacles,
                          int f64)
{
    Out o;
    const int err = out_open(&o, path);
    if (err) return err;
    for (int jj = 0; jj < ny; jj++) {
        for (int ii = 0; ii < nx; ii++) {
            const size_t c = (size_t)jj * (size_t)nx + (size_t)ii;
            char *p = out_reserve(&o), *s = p;
            p += put_uint(p, (uint64_t)ii);
            *p++ = ' ';
            p += put_uint(p, (uint64_t)jj);
            *p++ = ' ';
            p += fmt_e12(p, field(u_x, f64, c));
            *p++ = ' ';
            p += fmt_e12(p, field(u_y, f64, c));
            *p++ = ' ';
            p += fmt_e12(p, field(u, f64, c));
            *p++ = ' ';
            p += fmt_e12(p, field(pressure, f64, c));
            *p++ = ' ';
            p += put_int(p, obstacles[c]);
            *p++ = '\n';
            o.len += (size_t)(p - s);
        }
    }
    return out_close(&o);
}

/* av_vels.dat: "tt:\t%.12E" per step (d2q9-bgk.c:744-749). */
int lbm_write_av_vels(const char *path, long long n, const void *av_vels,
                      int f64)
{
    Out o;
    const int err = out_open(&o, path);
    if (err) return err;
    for (long long tt = 0; tt < n; tt++) {
        char *p = out_reserve(&o), *s = p;
        p += put_uint(p, (uint64_t)tt);
        *p++ = ':';
        *p++ = '\t';
        p += fmt_e12(p, field(av_vels, f64, (size_t)tt));
        *p++ = '\n';
        o.len += (size_t)(p - s);
    }
    return out_close(&o);
}

/* The parse codes of lbm_read_obstacles, in the order obstacles.py
 * checks them: a token that is no integer, an integer beyond int64, a
 * token count that is no multiple of 3, then any x, any y, any blocked
 * flag out of range. */
enum {
    OBS_BAD_TOKEN = -1,
    OBS_OVERFLOW = -2,
    OBS_NOT_TRIPLETS = -3,
    OBS_X_RANGE = -4,
    OBS_Y_RANGE = -5,
    OBS_BLOCKED = -6,
};

static int is_space(unsigned char c)
{
    return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

/* One whitespace-free token as Python's int() reads it: an optional
 * sign, then ASCII digits with single underscores between them. Returns
 * 0 for no integer; sets *overflow beyond int64. */
static int parse_token(const char *s, const char *end, int64_t *value,
                       int *overflow)
{
    int neg = 0;
    if (s < end && (*s == '+' || *s == '-')) neg = *s++ == '-';
    if (s == end || *s < '0' || *s > '9') return 0;
    uint64_t mag = 0;
    int big = 0;
    for (; s < end; s++) {
        if (*s == '_') {
            if (s + 1 == end || s[1] < '0' || s[1] > '9') return 0;
            continue;
        }
        if (*s < '0' || *s > '9') return 0;
        const uint64_t d = (uint64_t)(*s - '0');
        if (mag > (UINT64_MAX - d) / 10) big = 1;
        else mag = mag * 10 + d;
    }
    if (big || mag > (uint64_t)INT64_MAX + (uint64_t)neg) {
        *overflow = 1;
        return 1;
    }
    *value = neg ? (int64_t)(0 - mag) : (int64_t)mag;
    return 1;
}

/*
 * Parse "x y 1" triplets (the reference's fscanf token stream,
 * d2q9-bgk.c:626-644: newlines are not significant) into the caller's
 * zeroed uint8 (ny, nx) mask. Nothing is written unless the whole file
 * is valid.
 */
int lbm_read_obstacles(const char *path, int nx, int ny, uint8_t *mask)
{
    FILE *fp = fopen(path, "rb");
    if (fp == NULL) return errno ? errno : EIO;
    size_t cap = 1 << 20, len = 0;
    char *text = malloc(cap);
    int err = text == NULL ? ENOMEM : 0;
    while (!err) {
        if (len == cap) {
            char *grown = realloc(text, cap * 2);
            if (grown == NULL) { err = ENOMEM; break; }
            text = grown;
            cap *= 2;
        }
        const size_t got = fread(text + len, 1, cap - len, fp);
        len += got;
        if (got == 0) {
            if (ferror(fp)) err = errno ? errno : EIO;
            break;
        }
    }
    fclose(fp);
    if (err) { free(text); return err; }

    size_t count = 0, cap_vals = 3 * 4096;
    int64_t *vals = malloc(cap_vals * sizeof(int64_t));
    int bad_token = 0, overflow = 0;
    if (vals == NULL) { free(text); return ENOMEM; }
    for (size_t i = 0; i < len;) {
        while (i < len && is_space((unsigned char)text[i])) i++;
        if (i == len) break;
        size_t j = i;
        while (j < len && !is_space((unsigned char)text[j])) j++;
        int64_t v = 0;
        int big = 0;
        if (!parse_token(text + i, text + j, &v, &big)) bad_token = 1;
        overflow |= big;
        if (count == cap_vals) {
            int64_t *grown = realloc(vals, 2 * cap_vals * sizeof(int64_t));
            if (grown == NULL) { free(vals); free(text); return ENOMEM; }
            vals = grown;
            cap_vals *= 2;
        }
        vals[count++] = v;
        i = j;
    }
    free(text);
    int code = bad_token ? OBS_BAD_TOKEN : overflow ? OBS_OVERFLOW
             : count % 3 ? OBS_NOT_TRIPLETS : 0;
    for (size_t t = 0; !code && t < count; t += 3)
        if (vals[t] < 0 || vals[t] > nx - 1) code = OBS_X_RANGE;
    for (size_t t = 0; !code && t < count; t += 3)
        if (vals[t + 1] < 0 || vals[t + 1] > ny - 1) code = OBS_Y_RANGE;
    for (size_t t = 0; !code && t < count; t += 3)
        if (vals[t + 2] != 1) code = OBS_BLOCKED;
    for (size_t t = 0; !code && t < count; t += 3)
        mask[(size_t)vals[t + 1] * (size_t)nx + (size_t)vals[t]] = 1;
    free(vals);
    return code;
}
