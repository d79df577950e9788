#!/usr/bin/env python
"""Benchmark: degree-2^16 Goldilocks negacyclic ring multiplication
throughput on one device (BASELINE north star / config 1 scaled), plus
the fixed-operand / challenge / square protocol rates, the four
reference models' fused-CRT multiply rates, the BabyBear / Stark-prime
deg-2^12 rings, the big degrees and the 20-variable MLE evaluation.

Every path is the portable XLA engine the library uses
(PowerRing.mxu_ctx: int8 digit matmuls + fused elementwise folds), and
each section checks its output bit-exactly against an oracle before it
records a rate; a failed check fails the section.

Timing is IN-MODULE DEPTH-DIFFERENCED (chain_rate): a dependent chain
of k multiplies with distinct operands inside one jit module, measured
at two depths; the difference cancels the per-dispatch cost.

WALL-CLOCK BUDGET: ``SRT_BENCH_BUDGET_S`` (default 1500 s) bounds the
run.  A watchdog THREAD emits the running result dict as the one JSON
line and exits 0 when the budget expires; SIGTERM/SIGINT do the same.
The headline is measured first; every later section is budget-gated and
lands its keys incrementally, with explicit "skipped_budget" /
"failed:<error>" section markers.  JAX's persistent compilation cache is
on (stark_rings_tpu.utils.compile_cache).

The result names the device: platform, device_kind, device count, and
the card's name and power limit from nvidia-smi.  Prints ONE JSON line.
"""

import json
import os
import signal
import sys
import threading
import time

import numpy as np

BUDGET_S = float(os.environ.get("SRT_BENCH_BUDGET_S", "1500"))
T0 = time.monotonic()
DEADLINE = T0 + BUDGET_S

# RLock: a SIGTERM handler runs ON the main thread and may interrupt a
# put()/mark() that already holds the lock — a plain Lock would deadlock
# exactly where the one-JSON-line contract matters most.
_LOCK = threading.RLock()
_EMIT_ONCE = threading.Lock()   # acquire(blocking=False) = atomic once
_EMITTED = threading.Event()

RESULT = {
    "metric": "goldilocks_deg2^16_ring_mults_per_sec_per_device",
    "value": None,
    "unit": "ring mults/s",
    "timing": "in_module_chain_depth_differenced_checksum_forced",
    "budget_s": BUDGET_S,
    "sections": {},
}


def put(**kv):
    with _LOCK:
        RESULT.update(kv)


def mark(name, status):
    with _LOCK:
        RESULT["sections"][name] = status


def emit(rc=0):
    """Print the single JSON line exactly once and hard-exit.

    os._exit (not sys.exit): the main thread may be blocked inside a
    compile; this must terminate the process from the watchdog thread
    regardless."""
    if not _EMIT_ONCE.acquire(blocking=False):
        return   # another thread (watchdog vs signal) already emitting
    _EMITTED.set()
    with _LOCK:
        RESULT["elapsed_s"] = round(time.monotonic() - T0, 1)
        line = json.dumps(RESULT)
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    os._exit(rc)


def _watchdog():
    while True:
        left = DEADLINE - time.monotonic()
        if left <= 0:
            break
        time.sleep(min(left, 5.0))
    put(budget_expired=True)
    emit(0)


def install_guards():
    threading.Thread(target=_watchdog, daemon=True).start()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: emit(0))
        except (ValueError, OSError):
            pass


def run_section(name, est_s, fn):
    """Budget-gated section: skip if the estimated time does not fit in
    the remaining budget; record elapsed or failure class either way."""
    if DEADLINE - time.monotonic() < est_s:
        print(f"section {name}: skipped (budget)", file=sys.stderr)
        mark(name, "skipped_budget")
        return None
    t0 = time.monotonic()
    try:
        out = fn()
        mark(name, round(time.monotonic() - t0, 1))
        return out
    except Exception as exc:  # noqa: BLE001 — sections are independent
        print(f"section {name} failed ({type(exc).__name__}: {exc})",
              file=sys.stderr)
        mark(name, f"failed:{type(exc).__name__}")
        return None


def chain_rate(build, B, lo=2, hi=6, reps=3):
    """In-module depth-differenced rate: mults/s net of dispatch latency.

    ``build(depth)`` returns (fn, args) where fn runs a DEPENDENT chain
    of ``depth`` multiplies inside ONE jit module (distinct second
    operands, so nothing can be elided).  The dispatch and readback cost
    appears once per call regardless of depth, so
        per_mul = (t_hi - t_lo) / (hi - lo)
    cancels it.  The diff is the MEDIAN over paired back-to-back
    (lo, hi) reps, so one outlier pair cannot move it."""
    import jax
    import jax.numpy as jnp

    cs = jax.jit(lambda x: jnp.bitwise_xor.reduce(
        x.reshape(-1, x.shape[-1])).max())
    fns = {}
    for k in (lo, hi):
        fn, args = build(k)
        out = fn(*args)
        _ = int(jax.device_get(cs(out)))   # warm incl. checksum graph
        fns[k] = (fn, args)

    def once(k):
        fn, args = fns[k]
        t0 = time.perf_counter()
        out = fn(*args)
        _ = int(jax.device_get(cs(out)))
        return time.perf_counter() - t0

    def measure(nreps):
        diffs, tlos, this_ = [], [], []
        for _ in range(nreps):
            tl = once(lo)
            th = once(hi)
            diffs.append(th - tl)
            tlos.append(tl)
            this_.append(th)
        diffs.sort()
        n = len(diffs)
        # middle-half band: drop floor(n/4) extremes each side; at
        # n <= 3 this degenerates to the full range
        quart = (diffs[n // 4], diffs[n - 1 - n // 4])
        return diffs[(n - 1) // 2], quart, min(tlos), min(this_)

    def band(quart):
        """Paired-diff middle-half spread -> a [low, high] rate band
        (None where a bound diff is nonpositive — noise swamped it)."""
        out = []
        for dq in reversed(quart):      # large diff -> low rate
            pm = dq / (hi - lo)
            out.append(round(B / pm, 1) if pm > 0 else None)
        return out

    d, quart, tlo, thi = measure(reps)
    per_mul = d / (hi - lo)
    if per_mul <= 0:       # noise swamped the diff; be conservative
        per_mul = thi / hi
    rate = B / per_mul
    return rate, {lo: tlo, hi: thi, "reps": reps,
                  "iqr_rate_band": band(quart)}


class Headline:
    """Shared state for the deg-2^16 sections: the power ring's
    multiplier, its device-resident tables, and the operand generator."""

    def __init__(self, N, B):
        import jax

        from stark_rings_tpu.fields import get_field
        from stark_rings_tpu.rings import get_power_ring

        self.N, self.B = N, B
        self.f = get_field("goldilocks")
        self.rng = np.random.default_rng(0)
        self.tp = get_power_ring("goldilocks",
                                 N.bit_length() - 1).mxu_ctx()
        self.c = jax.device_put(self.tp.consts())
        self.jax = jax

    def operand(self, nb):
        """ONE operand tensor (chain steps that reuse a cached second
        operand need no second ~40 MB tensor per build call)."""
        return self.jax.device_put(
            self.rng.integers(0, self.f.q, size=(nb, self.N),
                              dtype=np.uint64))

    def operands(self, nb, depth=0):
        jax, f, N = self.jax, self.f, self.N
        aa = jax.device_put(
            self.rng.integers(0, f.q, size=(nb, N), dtype=np.uint64))
        if not depth:
            bb = jax.device_put(
                self.rng.integers(0, f.q, size=(nb, N), dtype=np.uint64))
            return aa, bb
        bs = [jax.device_put(
            self.rng.integers(0, f.q, size=(nb, N), dtype=np.uint64))
            for _ in range(depth)]
        return aa, bs

    def oracle_gate(self, fn, label, b_override=None):
        """Bit-exactness vs the native oracle BEFORE recording any rate:
        a mismatching path must never become the headline.  The oracle
        must build: a missing toolchain fails the section."""
        from stark_rings_tpu.native.host import HostGoldilocks

        a, b = self.operands(2)
        if b_override is not None:
            b = b_override(b)
        hg = HostGoldilocks(self.N)
        got = np.asarray(fn(a, b))
        assert np.array_equal(got, hg.mul(np.asarray(a), np.asarray(b))), \
            f"{label} mismatch vs host oracle"


def sec_headline(st):
    """The gate metric: single-module multiply, measured first so it
    lands even if everything after times out."""
    jax, tp, c, B = st.jax, st.tp, st.c, st.B

    st.oracle_gate(
        lambda a, b: jax.jit(lambda cc, x, y: tp.mul(x, y, cc))(c, a, b),
        "mxu2 digit multiply")

    def build(depth):
        a, bs = st.operands(B, depth)

        def fn(cc, x, bs):
            for i in range(depth):
                x = tp.mul(x, bs[i], cc)
            return x
        return jax.jit(fn), (c, a, bs)

    rate, info = chain_rate(build, B, lo=2, hi=8, reps=4)
    N = st.N
    put(value=round(rate, 3),
        value_iqr_band=info.get("iqr_rate_band"),
        path="mxu2",
        batch=B,
        equiv_butterflies_per_sec=round(
            rate * 3 * (N // 2) * (N.bit_length() - 1), 0),
        path_rates_by_batch={"mxu2": [B, round(rate, 1)]})
    return rate


def _merge_path_rate(name, B, rate):
    with _LOCK:
        prr = RESULT.setdefault("path_rates_by_batch", {})
        prr[name] = [B, round(rate, 1)]
        # headline value = best measured exact full-multiply path
        if RESULT["value"] is None or rate > RESULT["value"]:
            RESULT["value"] = round(rate, 3)
            RESULT["path"] = name
            RESULT["batch"] = B


def sec_fixed_operand(st):
    """Fixed-operand multiply (protocol pattern: many elements times the
    SAME ring element — gadget columns, challenge powers): the fixed
    operand's forward transform is precomputed once; every chain step
    runs 1 forward + slot product + 1 inverse."""
    from stark_rings_tpu.native.host import HostGoldilocks

    jax, tp, c, B = st.jax, st.tp, st.c, st.B
    pre = jax.jit(lambda cc, y: tp.precompute(y, cc))
    a0, b0 = st.operands(B)
    vb = jax.block_until_ready(pre(c, b0))

    hg = HostGoldilocks(st.N)
    got = np.asarray(jax.jit(
        lambda cc, x, v: tp.mul_cached(x, v, cc))(c, a0, vb))
    assert np.array_equal(got, hg.mul(np.asarray(a0), np.asarray(b0))), \
        "mul_cached mismatch vs host oracle"

    def build(depth):
        a = st.operand(B)

        def fn(cc, x, v):
            for _ in range(depth):
                x = tp.mul_cached(x, v, cc)
            return x
        return jax.jit(fn), (c, a, vb)

    rate, _ = chain_rate(build, B, lo=2, hi=8, reps=4)
    put(fixed_operand_ring_mults_per_sec=round(rate, 1))
    return rate


def sec_challenge(st):
    """Challenge multiply: ONE fixed element times the whole batch — the
    cached batch-1 evaluations broadcast across the live batch in the
    slot product."""
    from stark_rings_tpu.native.host import HostGoldilocks

    jax, tp, c, B = st.jax, st.tp, st.c, st.B
    pre = jax.jit(lambda cc, y: tp.precompute(y, cc))
    a0, b0 = st.operands(B)
    v1 = jax.block_until_ready(pre(c, b0[:1]))

    hg = HostGoldilocks(st.N)
    got = np.asarray(jax.jit(
        lambda cc, x, v: tp.mul_cached(x, v, cc))(c, a0, v1))
    bfull = np.broadcast_to(np.asarray(b0[:1]), (B, st.N))
    assert np.array_equal(got, hg.mul(np.asarray(a0), bfull)), \
        "challenge mul_cached mismatch vs host oracle"

    def build(depth):
        a = st.operand(B)

        def fn(cc, x, v):
            for _ in range(depth):
                x = tp.mul_cached(x, v, cc)
            return x
        return jax.jit(fn), (c, a, v1)

    rate, _ = chain_rate(build, B, lo=2, hi=8, reps=4)
    put(challenge_ring_mults_per_sec=round(rate, 1))
    return rate


def sec_square(st):
    """Squaring: one forward transform feeds both slot-product operands
    — the repeated-squaring / power-table protocol pattern."""
    from stark_rings_tpu.native.host import HostGoldilocks

    jax, tp, c, B = st.jax, st.tp, st.c, st.B

    hg = HostGoldilocks(st.N)
    a0, _ = st.operands(B)
    got = np.asarray(jax.jit(lambda cc, x: tp.square(x, cc))(c, a0))
    assert np.array_equal(got, hg.mul(np.asarray(a0), np.asarray(a0))), \
        "square mismatch vs host oracle"

    def build(depth):
        a = st.operand(B)

        def fn(cc, x):
            for _ in range(depth):
                x = tp.square(x, cc)
            return x
        return jax.jit(fn), (c, a)

    rate, _ = chain_rate(build, B, lo=2, hi=8, reps=4)
    put(square_ring_mults_per_sec=round(rate, 1))
    return rate


def sec_radix4(st):
    """Round-1 jnp radix-4 path (comparison / regression guard)."""
    import jax

    from stark_rings_tpu.ops.ntt import get_ntt

    ctx = get_ntt("goldilocks", st.N, negacyclic=True)
    B = st.B
    st.oracle_gate(
        lambda a, b: jax.jit(lambda x, y: ctx.mul(x, y))(a, b),
        "jnp radix4")

    def build(depth):
        a, bs = st.operands(B, depth)

        def fn(x, bs):
            for i in range(depth):
                x = ctx.mul(x, bs[i])
            return x
        return jax.jit(fn), (a, bs)

    rate, _ = chain_rate(build, B, lo=1, hi=3)
    _merge_path_rate("jnp_radix4", B, rate)
    return rate


def sec_pointwise(st):
    """NTT-form pointwise rate (folding-prover hot loop): in-module
    depth-differenced chain of slotwise 64-bit modular multiplies."""
    import jax

    f, B = st.f, st.B

    def build(depth):
        a, b = st.operands(B)

        def fn(x, y):
            for _ in range(depth):
                x = f.mul(x, y)
            return x
        return jax.jit(fn), (a, b)

    rate, _ = chain_rate(build, B, lo=16, hi=64, reps=2)
    put(ntt_form_pointwise_ring_mults_per_sec=round(rate, 1),
        pointwise_path="xla")
    return rate


def sec_models():
    """Per-reference-model fused-CRT multiply throughput: in-module
    depth-differenced chains of icrt(ntt_mul(crt(x), crt(y))).

    All four models run in the batch-trailing layout
    (ops/model_mul.TModelMul) with the digit tables passed as jit
    arguments.  Each model's path is gated bit-exact vs the
    integer spec before its rate is recorded; each model lands its key
    incrementally so a mid-section timeout keeps the finished ones."""
    import jax

    from stark_rings_tpu.ops.model_mul import TModelMul
    from stark_rings_tpu.rings import get_ring

    out = {}
    layouts = {}
    for name, B, lo, hi in (("goldilocks", 65536, 2, 34),
                            ("babybear", 16384, 2, 34),
                            ("frog", 65536, 2, 34),
                            ("stark_prime", 4096, 2, 26)):
        if DEADLINE - time.monotonic() < 30:
            out[name] = "skipped_budget"
            put(model_crt_mults_per_sec=dict(out))
            continue
        try:
            ring = get_ring(name)
            f = ring.field
            rng = np.random.default_rng(1)
            tm = TModelMul(ring)

            def rand(nb):
                if f.limbed:
                    limbs = rng.integers(0, 1 << 32, size=(nb, ring.D, 8),
                                         dtype=np.uint64)
                    limbs[..., 7] &= (1 << 26) - 1
                    return f.from_canon(
                        jax.device_put(limbs.astype(np.uint32)))
                dt_ = np.uint32 if f.dtype == np.uint32 else np.uint64
                return f.from_canon(jax.device_put(
                    rng.integers(0, f.q, size=(nb, ring.D), dtype=dt_)))

            # exactness gate vs the integer spec (host oracle) BEFORE
            # any rate is recorded on this path
            a0, b0 = rand(2), rand(2)
            got = ring.decode(jax.jit(tm.mul)(a0, b0))
            ai, bi = ring.decode(a0), ring.decode(b0)
            for r in range(2):
                want = ring.spec.coeff_mul([int(v) for v in ai[r]],
                                           [int(v) for v in bi[r]])
                assert [int(v) for v in got[r]] == \
                    [int(v) % ring.q for v in want], \
                    f"{name} model-mul mismatch vs spec"

            cm = jax.device_put(tm.consts())

            def build(depth):
                a = jax.device_put(tm.to_t(rand(B)))
                bs = [jax.device_put(tm.to_t(rand(B)))
                      for _ in range(depth)]

                def fn(cc, x, bs):
                    for i in range(depth):
                        x = tm.mul_t(x, bs[i], cc)
                    return x
                return jax.jit(fn), (cm, a, bs)

            rate, _ = chain_rate(build, B, lo=lo, hi=hi, reps=3)
            out[name] = round(rate, 1)
            layouts[name] = "batch_trailing"
        except Exception as exc:  # noqa: BLE001
            print(f"model {name} failed ({type(exc).__name__}: {exc})",
                  file=sys.stderr)
            out[name] = f"failed:{type(exc).__name__}"
        put(model_crt_mults_per_sec=dict(out),
            model_crt_layouts=dict(layouts))
    return out


def sec_babybear_pow2(N=1 << 12, B=4096):
    """BASELINE config 2: BabyBear deg-2^12 batched negacyclic multiply
    via the digit-plane engine (ops/mxu_bb.py), in-module chained.
    Operands in Montgomery storage (the ring's native form)."""
    import jax

    from stark_rings_tpu.native.host import HostRing
    from stark_rings_tpu.rings import get_power_ring

    ring = get_power_ring("babybear", N.bit_length() - 1)
    tx = ring.mxu_ctx()
    c = jax.device_put(tx.consts())   # tables as jit ARGUMENTS
    rng = np.random.default_rng(2)
    q = ring.field.q

    def build(depth):
        a = jax.device_put(rng.integers(0, q, size=(B, N),
                                        dtype=np.uint32))
        bs = [jax.device_put(rng.integers(0, q, size=(B, N),
                                          dtype=np.uint32))
              for _ in range(depth)]

        def fn(cc, x, bs):
            for i in range(depth):
                x = tx.mul(x, bs[i], cc)
            return x
        return jax.jit(fn), (c, a, bs)

    # bit-exactness vs the native generic-prime oracle first
    hr = HostRing("babybear", N)
    a0 = jax.device_put(rng.integers(0, q, size=(2, N), dtype=np.uint32))
    b0 = jax.device_put(rng.integers(0, q, size=(2, N), dtype=np.uint32))
    got = np.asarray(ring.field.decode(
        jax.jit(lambda cc, x, y: tx.mul(x, y, cc))(c, a0, b0)),
        dtype=np.uint64)
    assert np.array_equal(got, hr.mul_storage(a0, b0)), \
        "babybear digit multiply mismatch vs native oracle"

    rate, _ = chain_rate(build, B, lo=1, hi=5, reps=2)
    put(**{"babybear_deg2^12_ring_mults_per_sec": round(rate, 1)})
    return rate


def sec_stark_pow2(N=1 << 12, B=256):
    """252-bit stark-prime deg-2^12 negacyclic multiply via the limbed
    digit-plane four-step (ops/mxu_limb.py MxuLimbNTT), in-module chained —
    beyond-reference capability (its stark_prime model stops at D=16)."""
    import jax
    import jax.numpy as jnp

    from stark_rings_tpu.rings import get_power_ring

    ring = get_power_ring("stark_prime", N.bit_length() - 1)
    tx = ring.mxu_ctx()
    c = jax.device_put(tx.consts())
    rng = np.random.default_rng(3)

    def rand(nb):
        limbs = rng.integers(0, 1 << 32, size=(nb, N, 8),
                             dtype=np.uint64).astype(np.uint32)
        limbs[..., 7] &= (1 << 26) - 1        # < q guaranteed
        return jax.device_put(jnp.asarray(limbs))

    def build(depth):
        a = rand(B)
        bs = [rand(B) for _ in range(depth)]

        def fn(cc, x, bs):
            for i in range(depth):
                x = tx.mul(x, bs[i], cc)
            return x
        return jax.jit(fn), (c, a, bs)

    rate, _ = chain_rate(build, B, lo=1, hi=3, reps=2)
    put(**{"stark_prime_deg2^12_ring_mults_per_sec": round(rate, 1)})
    return rate


def sec_bigdeg():
    """deg-2^18 / 2^20 Goldilocks ring mults on one device through the
    power ring's digit engine, plus the single-device four-step at 2^20
    (PowerRing.fourstep_ctx); each path is gated exact vs the native
    oracle and the bigdeg key reports the best exact path at 2^20."""
    import jax

    from stark_rings_tpu.native.host import HostGoldilocks
    from stark_rings_tpu.parallel import ShardedNTT
    from stark_rings_tpu.rings import get_power_ring

    q = 2**64 - 2**32 + 1
    rng = np.random.default_rng(4)
    out = {}

    def gate(mul, N, to=lambda x: x, back=lambda x: x):
        a = rng.integers(0, q, size=(1, N), dtype=np.uint64)
        b = rng.integers(0, q, size=(1, N), dtype=np.uint64)
        got = np.asarray(back(jax.jit(mul)(to(a), to(b))))
        assert np.array_equal(got, HostGoldilocks(N).mul(a, b)), \
            f"deg-{N} multiply mismatch vs host oracle"

    for logN, B in ((18, 32), (20, 8)):
        if DEADLINE - time.monotonic() < 60:
            out[f"deg2^{logN}"] = "skipped_budget"
            put(goldilocks_bigdeg_ring_mults_per_sec=dict(out))
            continue
        try:
            N = 1 << logN
            tp = get_power_ring("goldilocks", logN).mxu_ctx()
            c = jax.device_put(tp.consts())
            gate(lambda x, y: tp.mul(x, y, c), N)

            def build(depth):
                a = jax.device_put(rng.integers(0, q, size=(B, N),
                                                dtype=np.uint64))
                bs = [jax.device_put(rng.integers(0, q, size=(B, N),
                                                  dtype=np.uint64))
                      for _ in range(depth)]

                def fn(cc, x, bs):
                    for i in range(depth):
                        x = tp.mul(x, bs[i], cc)
                    return x
                return jax.jit(fn), (c, a, bs)

            rate, _ = chain_rate(build, B, lo=1, hi=3, reps=2)
            out[f"deg2^{logN}"] = round(rate, 1)
        except Exception as exc:  # noqa: BLE001
            print(f"bigdeg 2^{logN} failed ({type(exc).__name__}: {exc})",
                  file=sys.stderr)
            out[f"deg2^{logN}"] = f"failed:{type(exc).__name__}"
        put(goldilocks_bigdeg_ring_mults_per_sec=dict(out))

    if DEADLINE - time.monotonic() >= 120:
        try:
            N, B = 1 << 20, 8
            sn = ShardedNTT("goldilocks", N, 1, single_chip=True)
            _, _, fmul = sn.make_single_chip_fns()
            gate(fmul, N, sn.to_matrix, sn.from_matrix)

            def build(depth):
                am = jax.device_put(sn.to_matrix(rng.integers(
                    0, q, size=(B, N), dtype=np.uint64)))
                bms = [jax.device_put(sn.to_matrix(rng.integers(
                    0, q, size=(B, N), dtype=np.uint64)))
                    for _ in range(depth)]

                def fn(x, bms):
                    for i in range(depth):
                        x = fmul(x, bms[i])
                    return x
                return jax.jit(fn), (am, bms)

            rate, _ = chain_rate(build, B, lo=1, hi=3, reps=3)
            out["deg2^20_fourstep"] = round(rate, 1)
            prev = out.get("deg2^20")
            if not isinstance(prev, (int, float)) or rate > prev:
                out["deg2^20"] = round(rate, 1)
                out["deg2^20_path"] = "fourstep"
        except Exception as exc:  # noqa: BLE001
            print(f"bigdeg fourstep failed ({type(exc).__name__}: {exc})",
                  file=sys.stderr)
            out["deg2^20_fourstep"] = f"failed:{type(exc).__name__}"
        put(goldilocks_bigdeg_ring_mults_per_sec=dict(out))
    return out


def sec_mle20():
    """20-var dense-MLE full evaluation via the two-contraction int8 path
    (mle/mxu_eval.py: eval = u^T M v with int8 digit-plane dots) — the
    BASELINE config-4 hot loop; gated exact vs DenseMLE.evaluate (the
    halving path) before the rate is recorded."""
    import jax
    import jax.numpy as jnp

    from stark_rings_tpu.fields import GOLDILOCKS as f
    from stark_rings_tpu.linalg import FieldElems
    from stark_rings_tpu.mle import DenseMLE
    from stark_rings_tpu.mle.mxu_eval import evaluate_goldilocks_mxu

    nv = 20
    rng = np.random.default_rng(5)
    pts = [np.uint64(int(x)) for x in
           rng.integers(0, f.q, size=(nv,), dtype=np.uint64)]

    ev0 = jax.device_put(rng.integers(0, f.q, size=(1 << nv,),
                                      dtype=np.uint64))
    a = int(jax.device_get(jax.jit(
        lambda e: evaluate_goldilocks_mxu(e, pts))(ev0)))
    b = int(jax.device_get(jax.jit(
        lambda e: DenseMLE(FieldElems(f), nv, e).evaluate(pts))(ev0)))
    assert a == b, "int8 MLE evaluation mismatch vs DenseMLE.evaluate"

    def build(depth):
        ev = jax.device_put(rng.integers(0, f.q, size=(1 << nv,),
                                         dtype=np.uint64))

        def fn(e):
            for _ in range(depth):
                v = evaluate_goldilocks_mxu(e, pts)
                e = f.add(e, jnp.broadcast_to(v, e.shape))
            return e
        return jax.jit(fn), (ev,)

    rate, _ = chain_rate(build, 1, lo=2, hi=258, reps=3)
    put(mle20_full_evaluate_per_sec=round(rate, 1),
        mle20_eval_path="mxu_two_contractions")
    return rate


def device_info():
    """What the numbers were measured on: JAX's view of the device, and
    the card's name and power limit where nvidia-smi exists."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": None}
    try:
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


def main():
    install_guards()

    from stark_rings_tpu.utils.compile_cache import enable_compile_cache

    put(compile_cache=enable_compile_cache(), **device_info())

    N, B = 1 << 16, 80

    st = None
    try:
        st = Headline(N, B)
    except Exception as exc:  # noqa: BLE001
        print(f"headline setup failed ({type(exc).__name__}: {exc})",
              file=sys.stderr)
        mark("headline", f"failed:{type(exc).__name__}")

    if st is not None:
        run_section("headline", 0, lambda: sec_headline(st))
        run_section("fixed_operand", 45, lambda: sec_fixed_operand(st))
        run_section("challenge", 45, lambda: sec_challenge(st))
        run_section("square", 45, lambda: sec_square(st))
        run_section("pointwise", 45, lambda: sec_pointwise(st))
    run_section("models", 120, sec_models)
    run_section("babybear_pow2", 60, sec_babybear_pow2)
    run_section("stark_pow2", 60, sec_stark_pow2)
    run_section("bigdeg", 120, sec_bigdeg)
    run_section("mle20", 60, sec_mle20)
    # comparison path last: it informs, it does not gate
    if st is not None:
        run_section("jnp_radix4", 60, lambda: sec_radix4(st))

    emit(0)


if __name__ == "__main__":
    main()
