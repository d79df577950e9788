// Native host-side kernels for stark-rings-tpu.
//
// The device compute path is JAX/XLA; this library is the *runtime-side*
// native component: a fast CPU implementation of the Goldilocks field and
// power-of-two negacyclic NTT used as
//   * the high-speed oracle for verifying large-degree device transforms
//     (a python-int schoolbook at deg 2^16 is O(N^2) bigint ops — minutes;
//     this is milliseconds), and
//   * a host fallback / data-preparation path (e.g. twiddle generation,
//     canonical byte codecs) that does not need a device roundtrip.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).
//
// Field: q = 2^64 - 2^32 + 1 (Goldilocks).  Reduction identities:
//   2^64 == 2^32 - 1 (mod q),  2^96 == -1 (mod q).

#include <cstdint>
#include <cstring>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
#if defined(__SIZEOF_INT128__)
using u128 = unsigned __int128;
#else
#error "need __int128"
#endif

static const u64 Q = 0xFFFFFFFF00000001ULL;

static inline u64 add_q(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a || s >= Q) s -= Q;
    return s;
}

static inline u64 sub_q(u64 a, u64 b) {
    u64 d = a - b;
    if (a < b) d += Q;
    return d;
}

static inline u64 reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u32 hi_hi = (u32)(hi >> 32);
    u64 hi_lo = (u32)hi;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= 0xFFFFFFFFULL;  // borrow: -2^64 == -(2^32-1)
    u64 t1 = hi_lo * 0xFFFFFFFFULL;
    u64 t2 = t0 + t1;
    if (t2 < t1) t2 += 0xFFFFFFFFULL;     // carry: +2^64 == +(2^32-1)
    if (t2 >= Q) t2 -= Q;
    return t2;
}

static inline u64 mul_q(u64 a, u64 b) {
    return reduce128((u128)a * (u128)b);
}

static inline u64 pow_q(u64 a, u64 e) {
    u64 r = 1;
    while (e) {
        if (e & 1) r = mul_q(r, a);
        a = mul_q(a, a);
        e >>= 1;
    }
    return r;
}

extern "C" {

u64 srh_goldilocks_q() { return Q; }
u64 srh_mul(u64 a, u64 b) { return mul_q(a, b); }
u64 srh_pow(u64 a, u64 e) { return pow_q(a, e); }

// In-place forward negacyclic NTT, leaf-order output; identical stage
// recursion as ops/ntt.py (stage s, m=2^s blocks, table entries [m, 2m)).
// w: [n] stage-twiddle table in the m+i layout.
void srh_ntt_forward(u64* x, const u64* w, u64 n_batch, u64 n) {
    for (u64 row = 0; row < n_batch; ++row) {
        u64* a = x + row * n;
        for (u64 m = 1; m < n; m <<= 1) {
            u64 t = n / (2 * m);
            for (u64 i = 0; i < m; ++i) {
                u64 tw = w[m + i];
                u64* blk = a + i * 2 * t;
                for (u64 j = 0; j < t; ++j) {
                    u64 u = blk[j];
                    u64 v = mul_q(tw, blk[j + t]);
                    blk[j] = add_q(u, v);
                    blk[j + t] = sub_q(u, v);
                }
            }
        }
    }
}

// In-place inverse (leaf-order input), wi: inverse stage table, ninv = 1/n.
void srh_ntt_inverse(u64* x, const u64* wi, u64 ninv, u64 n_batch, u64 n) {
    for (u64 row = 0; row < n_batch; ++row) {
        u64* a = x + row * n;
        for (u64 m = n >> 1; m >= 1; m >>= 1) {
            u64 t = n / (2 * m);
            for (u64 i = 0; i < m; ++i) {
                u64 tw = wi[m + i];
                u64* blk = a + i * 2 * t;
                for (u64 j = 0; j < t; ++j) {
                    u64 u = blk[j];
                    u64 v = blk[j + t];
                    blk[j] = add_q(u, v);
                    blk[j + t] = mul_q(tw, sub_q(u, v));
                }
            }
        }
        for (u64 j = 0; j < n; ++j) a[j] = mul_q(a[j], ninv);
    }
}

// Elementwise c[i] = a[i] * b[i] mod q.
void srh_pointwise_mul(const u64* a, const u64* b, u64* c, u64 count) {
    for (u64 i = 0; i < count; ++i) c[i] = mul_q(a[i], b[i]);
}

// c = a *_negacyclic b (schoolbook; the independent O(n^2) oracle).
void srh_negacyclic_mul_schoolbook(const u64* a, const u64* b, u64* c,
                                   u64 n) {
    std::vector<u64> out(n, 0);
    for (u64 i = 0; i < n; ++i) {
        if (!a[i]) continue;
        for (u64 j = 0; j < n; ++j) {
            u64 p = mul_q(a[i], b[j]);
            u64 k = i + j;
            if (k < n) out[k] = add_q(out[k], p);
            else out[k - n] = sub_q(out[k - n], p);
        }
    }
    std::memcpy(c, out.data(), n * sizeof(u64));
}

// ---- generic odd-prime variants (any q < 2^64) -------------------------
// The same stage recursion parameterized by the modulus: the host oracle
// for power-of-two rings over OTHER u64-word primes (BabyBear).  These
// operate on CANONICAL values — Montgomery storage fields decode first
// (native/host.py HostRing).

static inline u64 addm(u64 a, u64 b, u64 q) {
    u64 s = a + b;                 // a,b < q < 2^64; wrap iff s < a
    if (s < a || s >= q) s -= q;   // wrap-sub is exact mod 2^64
    return s;
}

static inline u64 subm(u64 a, u64 b, u64 q) {
    return a >= b ? a - b : a + (q - b);
}

static inline u64 mulm(u64 a, u64 b, u64 q) {
    return (u64)(((u128)a * (u128)b) % q);
}

void srh_ntt_forward_q(u64* x, const u64* w, u64 n_batch, u64 n, u64 q) {
    for (u64 row = 0; row < n_batch; ++row) {
        u64* a = x + row * n;
        for (u64 m = 1; m < n; m <<= 1) {
            u64 t = n / (2 * m);
            for (u64 i = 0; i < m; ++i) {
                u64 tw = w[m + i];
                u64* blk = a + i * 2 * t;
                for (u64 j = 0; j < t; ++j) {
                    u64 u = blk[j];
                    u64 v = mulm(tw, blk[j + t], q);
                    blk[j] = addm(u, v, q);
                    blk[j + t] = subm(u, v, q);
                }
            }
        }
    }
}

void srh_ntt_inverse_q(u64* x, const u64* wi, u64 ninv, u64 n_batch,
                       u64 n, u64 q) {
    for (u64 row = 0; row < n_batch; ++row) {
        u64* a = x + row * n;
        for (u64 m = n >> 1; m >= 1; m >>= 1) {
            u64 t = n / (2 * m);
            for (u64 i = 0; i < m; ++i) {
                u64 tw = wi[m + i];
                u64* blk = a + i * 2 * t;
                for (u64 j = 0; j < t; ++j) {
                    u64 u = blk[j];
                    u64 v = blk[j + t];
                    blk[j] = addm(u, v, q);
                    blk[j + t] = mulm(tw, subm(u, v, q), q);
                }
            }
        }
        for (u64 j = 0; j < n; ++j) a[j] = mulm(a[j], ninv, q);
    }
}

void srh_pointwise_mul_q(const u64* a, const u64* b, u64* c, u64 count,
                         u64 q) {
    for (u64 i = 0; i < count; ++i) c[i] = mulm(a[i], b[i], q);
}

void srh_negacyclic_mul_schoolbook_q(const u64* a, const u64* b, u64* c,
                                     u64 n, u64 q) {
    std::vector<u64> out(n, 0);
    for (u64 i = 0; i < n; ++i) {
        if (!a[i]) continue;
        for (u64 j = 0; j < n; ++j) {
            u64 p = mulm(a[i], b[j], q);
            u64 k = i + j;
            if (k < n) out[k] = addm(out[k], p, q);
            else out[k - n] = subm(out[k - n], p, q);
        }
    }
    std::memcpy(c, out.data(), n * sizeof(u64));
}

// Balanced base-b digit of the signed representative (reference
// balanced_decomposition/mod.rs:62-103 fixed-k reformulation).
void srh_decompose_balanced(const u64* x, int64_t* digits, u64 count,
                            u64 base, u64 k) {
    u64 half = (Q - 1) / 2;
    for (u64 i = 0; i < count; ++i) {
        u64 v = x[i];
        int neg = v > half;
        u64 cur = neg ? Q - v : v;
        for (u64 j = 0; j < k; ++j) {
            u64 m = cur % base;
            int64_t d = (2 * m <= base) ? (int64_t)m
                                        : (int64_t)m - (int64_t)base;
            cur = (cur - (u64)d) / base;
            digits[i * k + j] = neg ? -d : d;
        }
    }
}

}  // extern "C"
