#!/usr/bin/env python
"""Smoke test of the library's main path on one NVIDIA GPU.

Runs every phase below through the public entry points, compares each
bit-exactly with a reference that does not use the path under test,
and prints each phase's steady-state time with the card's name and
power limit.  The whole system is integer arithmetic, so every
comparison is exact equality.

    ring16    get_power_ring("goldilocks", 2^16).mxu_ctx(): jit_mul,
              mul_cached, challenge broadcast, square  vs the native
              HostGoldilocks oracle (csrc/, built with g++)
    pow2      BabyBear / Stark-prime deg-2^12 power rings  vs HostRing /
              a python-integer NTT multiply
    models    get_ring(m) crt -> ntt_mul -> icrt, four models  vs
              ring.coeff_mul (schoolbook) and the integer spec
    mle       evaluate_goldilocks_mxu / evaluate_many_goldilocks_mxu
              vs DenseMLE.evaluate (the halving path)
    sumcheck  the XLA product-claim prover  vs a host verifier and a
              host integer sum
    protocol  FoldingTree / FoldingStep  vs FoldingTree.verify (run on
              JAX's CPU backend, as a host verifier would)

Run:  python chip_smoke.py           one card, every phase above
      python chip_smoke.py --four    four cards: ShardedNTT, the
                                     witness-sharded folding tree and the
                                     sharded sumcheck, nothing else

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed.  With no GPU the script exits
non-zero before any phase runs.
"""

from __future__ import annotations

import json
import random
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

import jax
import jax.numpy as jnp

REPS = 5


# -- reporting ---------------------------------------------------------------
def card_label() -> str:
    """`name, power limit` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def steady(fn, *args, reps: int = REPS):
    """(output, median seconds) of ``fn(*args)`` after one warm-up call
    (which compiles); every call ends in block_until_ready."""
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


def report(phase: str, what: str, seconds: float, card: str,
           per: int | None = None, unit: str = "") -> None:
    rate = f", {per / seconds:.1f} {unit}/s" if per else ""
    print(f"[{phase}] {what}: {seconds * 1e3:.3f} ms median of {REPS}"
          f"{rate} | {card}", flush=True)


def gemm_report(hlo: str) -> list[str]:
    """How the compiled HLO implements each dot: a cuBLAS / cuBLASLt
    custom call, a Triton GEMM fusion, or XLA's plain dot emitter (no
    tensor cores), with operand and result types."""
    types = {}
    comp_of = {}
    comp = None
    calls = {}
    for ln in hlo.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%([\w.\-]+)\s+\(.*\{\s*$", ln)
        if m:
            comp = m.group(1)
            continue
        m = re.match(r"\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\(?[a-z0-9]+\[[^\]]*\])",
                     ln)
        if not m:
            continue
        types[m.group(1)] = m.group(2).lstrip("(")
        comp_of[m.group(1)] = comp
        c = re.search(r"calls=%([\w.\-]+)", ln)
        k = re.search(r'"kind":"([^"]+)"', ln)
        if c:
            calls[c.group(1)] = k.group(1) if k else "fusion"
    out = []
    for ln in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%([\w.\-]+)\s*=.*?\b(custom-call|dot)"
                     r"\(([^)]*)\)", ln)
        if not m:
            continue
        name, op, args = m.groups()
        ops = [types.get(a.strip().lstrip("%"), "?")
               for a in args.split(",")[:2]]
        if op == "custom-call":
            tgt = re.search(r'custom_call_target="([^"]+)"', ln)
            if not tgt or "cublas" not in tgt.group(1):
                continue
            impl = tgt.group(1)
        else:
            kind = calls.get(comp_of.get(name), "")
            impl = (f"Triton GEMM fusion ({kind})" if "triton" in kind
                    else "XLA dot emitter (not a tensor-core GEMM)")
        out.append(f"{impl}: {' x '.join(ops)} -> {types.get(name, '?')}")
    return out


def _eq(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    assert np.array_equal(got, want), f"{what}: values differ"


# -- phases ------------------------------------------------------------------
def phase_ring16(B: int = 80, logN: int = 16, card: str = "", seed: int = 0):
    from stark_rings_tpu.native import HostGoldilocks
    from stark_rings_tpu.rings import get_power_ring

    ring = get_power_ring("goldilocks", logN)
    eng = ring.mxu_ctx()
    N, q = ring.D, ring.q
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, (B, N), dtype=np.uint64)
    b = rng.integers(0, q, (B, N), dtype=np.uint64)
    host = HostGoldilocks(N)
    ad, bd = jax.device_put(a), jax.device_put(b)

    mul = eng.jit_mul()
    got, t = steady(mul, ad, bd)
    _eq(got, host.mul(a, b), "ring16 jit_mul")
    report("ring16", f"jit_mul B={B} N=2^{logN}", t, card, B, "mults")

    cc = jax.device_put(eng.consts())
    hlo = jax.jit(lambda c, x, y: eng.mul(x, y, c)).lower(
        cc, ad, bd).compile().as_text()
    dots = gemm_report(hlo)
    for d in dots:
        print(f"[ring16] digit dot -> {d}", flush=True)

    mc = eng.jit_mul_cached()
    fb = mc.precompute(bd)
    got, t = steady(mc, ad, fb)
    _eq(got, host.mul(a, b), "ring16 mul_cached")
    report("ring16", f"mul_cached B={B}", t, card, B, "mults")

    f1 = mc.precompute(bd[:1])
    got, t = steady(mc, ad, f1)
    _eq(got, host.mul(a, np.broadcast_to(b[:1], a.shape)),
        "ring16 challenge broadcast")
    report("ring16", f"challenge (batch-1 cached) B={B}", t, card, B,
           "mults")

    sq = eng.jit_square()
    got, t = steady(sq, ad)
    _eq(got, host.mul(a, a), "ring16 square")
    report("ring16", f"square B={B}", t, card, B, "mults")
    return {"dots": dots}


def _negacyclic_mul_ints(a, b, q):
    """a*b mod (q, X^N + 1) on python ints: twist by psi^i, cyclic NTT
    with omega = psi^2, slot product, inverse, untwist."""
    from stark_rings_tpu.ops.ntt import find_primitive_root

    N = len(a)
    psi = pow(find_primitive_root(q), (q - 1) // (2 * N), q)

    def ntt(x, w):
        x = list(x)
        j = 0
        for i in range(1, N):                  # bit-reversal permutation
            bit = N >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                x[i], x[j] = x[j], x[i]
        m = 2
        while m <= N:
            wm = pow(w, N // m, q)
            for k in range(0, N, m):
                t = 1
                for i in range(k, k + m // 2):
                    u, v = x[i], x[i + m // 2] * t % q
                    x[i], x[i + m // 2] = (u + v) % q, (u - v) % q
                    t = t * wm % q
            m <<= 1
        return x

    tw = [pow(psi, i, q) for i in range(N)]
    fa = ntt([v * t % q for v, t in zip(a, tw)], psi * psi % q)
    fb = ntt([v * t % q for v, t in zip(b, tw)], psi * psi % q)
    c = ntt([x * y % q for x, y in zip(fa, fb)], pow(psi * psi, q - 2, q))
    n_inv, psi_inv = pow(N, q - 2, q), pow(psi, q - 2, q)
    return [v * n_inv * pow(psi_inv, i, q) % q for i, v in enumerate(c)]


def _rand_limbed(f, rng, shape):
    """Uniform-ish canonical values < 2^250 < q, to storage form."""
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (f.N_LIMBS,),
                         dtype=np.uint64).astype(np.uint32)
    limbs[..., -1] &= (1 << 26) - 1
    return f.from_canon(jnp.asarray(limbs))


def _rand_storage(f, rng, shape):
    if f.limbed:
        return _rand_limbed(f, rng, shape)
    return jnp.asarray(rng.integers(0, f.q, size=shape, dtype=f.dtype))


def phase_pow2(B_bb: int = 4096, B_stark: int = 256, logN: int = 12,
               n_stark_check: int = 2, card: str = "", seed: int = 1):
    from stark_rings_tpu.native import HostRing
    from stark_rings_tpu.rings import get_power_ring

    rng = np.random.default_rng(seed)
    bb = get_power_ring("babybear", logN)
    N = bb.D
    a = rng.integers(0, bb.q, (B_bb, N), dtype=np.uint32)
    b = rng.integers(0, bb.q, (B_bb, N), dtype=np.uint32)
    got, t = steady(bb.mxu_ctx().jit_mul(), jax.device_put(a),
                    jax.device_put(b))
    want = HostRing("babybear", N).mul_storage(a, b)
    _eq(np.asarray(bb.field.decode(got), dtype=np.uint64), want,
        "pow2 babybear")
    report("pow2", f"babybear jit_mul B={B_bb} N=2^{logN}", t, card, B_bb,
           "mults")

    sp = get_power_ring("stark_prime", logN)
    a = _rand_limbed(sp.field, rng, (B_stark, N))
    b = _rand_limbed(sp.field, rng, (B_stark, N))
    got, t = steady(sp.mxu_ctx().jit_mul(), a, b)
    ga, gb, gg = (sp.decode(x[:n_stark_check]) for x in (a, b, got))
    for i in range(n_stark_check):
        want = _negacyclic_mul_ints([int(v) for v in ga[i]],
                                    [int(v) for v in gb[i]], sp.q)
        assert [int(v) for v in gg[i]] == want, \
            f"pow2 stark_prime element {i} vs python-int NTT"
    report("pow2", f"stark_prime jit_mul B={B_stark} N=2^{logN}", t, card,
           B_stark, "mults")
    return {}


def phase_models(n: int = 1 << 16, n_check: int = 64, n_spec: int = 4,
                 card: str = "", seed: int = 2):
    from stark_rings_tpu.rings import get_ring
    from stark_rings_tpu.spec import get_model

    rng = np.random.default_rng(seed)
    for name in ("goldilocks", "babybear", "frog", "stark_prime"):
        ring = get_ring(name)
        f = ring.field
        a = _rand_storage(f, rng, (n, ring.D))
        b = _rand_storage(f, rng, (n, ring.D))
        cc = jax.device_put(ring.mul_consts())
        fn = jax.jit(lambda c, x, y, ring=ring: ring.icrt(
            ring.ntt_mul(ring.crt(x, c), ring.crt(y, c)), c))
        got, t = steady(fn, cc, a, b)
        want = jax.jit(ring.coeff_mul)(a[:n_check], b[:n_check])
        _eq(np.asarray(got)[:n_check], want, f"models {name} vs coeff_mul")
        spec = get_model(name)
        ga, gb, gg = (ring.decode(x[:n_spec]) for x in (a, b, got))
        for i in range(n_spec):
            want_i = spec.coeff_mul([int(v) for v in ga[i]],
                                    [int(v) for v in gb[i]])
            assert [int(v) for v in gg[i]] == [v % ring.q for v in want_i], \
                f"models {name} vs spec, element {i}"
        report("models", f"{name} crt->ntt_mul->icrt n={n}", t, card, n,
               "mults")
    return {}


def phase_mle(nv: int = 20, W: int = 8, card: str = "", seed: int = 3):
    from stark_rings_tpu.fields import GOLDILOCKS as F
    from stark_rings_tpu.linalg import FieldElems
    from stark_rings_tpu.mle import DenseMLE
    from stark_rings_tpu.mle.mxu_eval import (evaluate_goldilocks_mxu,
                                              evaluate_many_goldilocks_mxu)

    rng = np.random.default_rng(seed)
    ev = jax.device_put(rng.integers(0, F.q, (1 << nv,), dtype=np.uint64))
    pts = jax.device_put(rng.integers(0, F.q, (W, nv), dtype=np.uint64))
    fe = FieldElems(F)
    dense = jax.jit(lambda e, p: DenseMLE(fe, nv, e).evaluate(
        [p[i] for i in range(nv)]))
    want = np.array([np.asarray(dense(ev, pts[w])) for w in range(W)])

    one = jax.jit(lambda e, p: evaluate_goldilocks_mxu(
        e, [p[i] for i in range(nv)]))
    got, t = steady(one, ev, pts[0])
    _eq(got, want[0], "mle evaluate")
    report("mle", f"evaluate_goldilocks_mxu nv={nv}", t, card, 1, "evals")

    got, t = steady(jax.jit(evaluate_many_goldilocks_mxu), ev, pts)
    _eq(got, want, "mle evaluate_many")
    report("mle", f"evaluate_many_goldilocks_mxu nv={nv} W={W}", t, card,
           W, "evals")
    return {}


def _interp2(p0: int, p1: int, p2: int, r: int, q: int) -> int:
    """Degree-2 polynomial through (0,p0),(1,p1),(2,p2), at r (mod q)."""
    inv2 = pow(2, q - 2, q)
    return (p0 * (r - 1) * (r - 2) * inv2 - p1 * r * (r - 2)
            + p2 * r * (r - 1) * inv2) % q


def phase_sumcheck(nv: int = 20, card: str = "", seed: int = 4):
    from stark_rings_tpu.fields import GOLDILOCKS as F
    from stark_rings_tpu.mle.mxu_eval import evaluate_goldilocks_mxu
    from stark_rings_tpu.mle.sumcheck import sumcheck_prove_with_challenges

    q = F.q
    rng = np.random.default_rng(seed)
    G = rng.integers(0, q, (1 << nv,), dtype=np.uint64)
    H = rng.integers(0, q, (1 << nv,), dtype=np.uint64)
    ch = rng.integers(0, q, (nv,), dtype=np.uint64)
    prove = jax.jit(lambda g, h, c: sumcheck_prove_with_challenges(
        F, g, h, [c[i] for i in range(nv)]))
    (msgs, gv, hv), t = steady(prove, jax.device_put(G), jax.device_put(H),
                               jax.device_put(ch))
    report("sumcheck", f"XLA prover, product claim nv={nv}", t, card, 1,
           "proofs")
    # host verifier: the claim is a host integer sum, every round
    # message must satisfy p(0) + p(1) == claim, and the last claim
    # must equal g(r) h(r)
    claim = int((G.astype(object) * H.astype(object)).sum() % q)
    msgs = np.asarray(msgs)
    for i in range(nv):
        p0, p1, p2 = (int(v) for v in msgs[i])
        assert (p0 + p1) % q == claim, f"sumcheck round {i} rejected"
        claim = _interp2(p0, p1, p2, int(ch[i]), q)
    assert claim == int(gv) * int(hv) % q, "sumcheck final check rejected"
    # the bound values are the MLEs at the challenge point (lsb order:
    # challenge i binds variable i), through the int8 eq contraction
    ev = jax.jit(lambda e, c: evaluate_goldilocks_mxu(
        e, [c[i] for i in range(nv)]))
    assert int(ev(G, ch)) == int(gv) and int(ev(H, ch)) == int(hv), \
        "sumcheck bound values differ from the MLE evaluations"
    return {}


def _tree_case(ring, leaves, n, L, base, rng_seed):
    from stark_rings_tpu.protocol import FoldingTree

    rng = random.Random(rng_seed)
    ft = FoldingTree(ring, n_rows=n, wit_len=L, base=base)
    c = jax.device_put(ft.init_tables(rng))
    wt = ft.rand_witnesses(leaves, rng)
    ct = jax.jit(ft.commit_witnesses)(c, wt)
    levels = leaves.bit_length() - 1
    rts = ft.precompute_challenges(
        [jnp.asarray(ring.rand_coeff((), rng)) for _ in range(levels)])
    return ft, c, wt, ct, rts


def _host_verify(ft, c, wt, ct, levels, rts) -> bool:
    """FoldingTree.verify on JAX's CPU backend: the host verifier's many
    small eager operations would each compile for the GPU."""
    args = jax.tree.map(np.asarray, jax.device_get((c, wt, ct, levels, rts)))
    with jax.default_device(jax.devices("cpu")[0]):
        return ft.verify(*args)


def _tampered(levels, ring):
    """The levels with one digit-commitment word of the first level
    changed (the verifier meets it first, so rejection is quick)."""
    bad = [dict(o) for o in levels]
    v = np.asarray(bad[0]["cd"]).copy()
    v.reshape(-1)[0] = (int(v.reshape(-1)[0]) + 1) % ring.q
    bad[0]["cd"] = jnp.asarray(v)
    return bad


def phase_protocol(step_W: int = 16, step_n: int = 8, step_L: int = 1024,
                   tree_leaves: int = 16, tree_n: int = 8,
                   tree_L: int = 256, card: str = ""):
    from stark_rings_tpu.rings import get_ring

    # FoldingStep.step on goldilocks (base 256): one tree level folding
    # 2*step_W leaves, i.e. the step at witness batch step_W
    gl = get_ring("goldilocks")
    ft, c, wt, ct, rts = _tree_case(gl, 2 * step_W, step_n, step_L, 256, 5)
    step = jax.jit(ft.fs.step)
    args = (c, wt[:, 0::2], wt[:, 1::2], ct[:, 0::2], ct[:, 1::2], rts[0])
    out, t = steady(step, *args)
    report("protocol", f"goldilocks FoldingStep.step W={step_W} "
           f"n={step_n} L={step_L} base=256", t, card, step_W, "witnesses")
    peak = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in peak:
        print(f"[protocol] peak device memory after the step: "
              f"{peak['peak_bytes_in_use'] / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    assert _host_verify(ft, c, wt, ct, [out], rts), \
        "goldilocks step rejected"
    assert not _host_verify(ft, c, wt, ct, _tampered([out], gl), rts), \
        "goldilocks step: tampered commitment accepted"
    print(f"[protocol] goldilocks step host verify: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # FoldingTree on frog (X^16 + 1): psi range check live at every level
    fr = get_ring("frog")
    ft, c, wt, ct, rts = _tree_case(fr, tree_leaves, tree_n, tree_L, 8, 6)
    assert ft.fs.psi_check, "frog is negacyclic: psi check must be on"
    prove = jax.jit(lambda c, w, x: ft.prove(c, w, x, rts))
    (levels, _, _), t = steady(prove, c, wt, ct)
    report("protocol", f"frog FoldingTree.prove leaves={tree_leaves} "
           f"n={tree_n} L={tree_L} base=8 psi", t, card, tree_leaves,
           "leaves")
    t0 = time.perf_counter()
    assert _host_verify(ft, c, wt, ct, levels, rts), "frog tree rejected"
    assert not _host_verify(ft, c, wt, ct, _tampered(levels, fr), rts), \
        "frog tree: tampered commitment accepted"
    print(f"[protocol] frog tree host verify: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {}


PHASES = {
    "ring16": phase_ring16,
    "pow2": phase_pow2,
    "models": phase_models,
    "mle": phase_mle,
    "sumcheck": phase_sumcheck,
    "protocol": phase_protocol,
}


# -- four cards ----------------------------------------------------------------
def phase_four_ntt(P: int = 4, logN: int = 20, B: int = 16,
                   n_host: int = 2, card: str = "", seed: int = 7):
    from jax.sharding import NamedSharding

    from stark_rings_tpu.native import HostGoldilocks
    from stark_rings_tpu.parallel import ShardedNTT, make_mesh
    from stark_rings_tpu.rings import get_power_ring

    mesh = make_mesh(P)
    N = 1 << logN
    sn = ShardedNTT("goldilocks", N, P)
    _, _, mul = sn.make_fns(mesh, batch_ndim=1)
    cspec, _ = sn.shard_specs(batch_ndim=1)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, sn.f.q, (B, N), dtype=np.uint64)
    b = rng.integers(0, sn.f.q, (B, N), dtype=np.uint64)
    sh = NamedSharding(mesh, cspec)
    am = jax.device_put(sn.to_matrix(a), sh)
    bm = jax.device_put(sn.to_matrix(b), sh)
    got, t = steady(mul, am, bm)
    report("four", f"ShardedNTT goldilocks mul P={P} B={B} N=2^{logN}", t,
           card, B, "mults")
    got = np.asarray(sn.from_matrix(got))
    _eq(got[:n_host], HostGoldilocks(N).mul(a[:n_host], b[:n_host]),
        "four ShardedNTT vs host oracle")
    one = jax.devices()[0]
    _, _, fmul = get_power_ring("goldilocks", logN).fourstep_ctx()
    want, t1 = steady(jax.jit(fmul), jax.device_put(a, one),
                      jax.device_put(b, one))
    report("four", f"one-card fourstep_ctx mul B={B} N=2^{logN}", t1, card,
           B, "mults")
    _eq(got, want, "four ShardedNTT vs one-card fourstep_ctx")
    return {}


def phase_four_tree(P: int = 4, leaves: int = 16, n: int = 8, L: int = 256,
                    card: str = ""):
    from stark_rings_tpu.parallel import make_mesh
    from stark_rings_tpu.rings import get_ring

    mesh = make_mesh(P)
    fr = get_ring("frog")
    ft, c, wt, ct, rts = _tree_case(fr, leaves, n, L, 8, 8)
    (lv, rw, rc), t = steady(
        lambda: ft.prove_sharded(mesh, c, wt, ct, rts))
    report("four", f"frog FoldingTree.prove_sharded P={P} leaves={leaves} "
           f"n={n} L={L}", t, card, leaves, "leaves")
    (ll, lw, lc), t1 = steady(jax.jit(lambda c, w, x: ft.prove(c, w, x, rts)),
                              c, wt, ct)
    report("four", f"one-card FoldingTree.prove leaves={leaves}", t1, card,
           leaves, "leaves")
    for i, (x, y) in enumerate(zip(lv, ll)):
        for key in y:
            _eq(x[key], y[key], f"four tree level {i} {key}")
    _eq(rw, lw, "four tree root witness")
    _eq(rc, lc, "four tree root commitment")
    assert _host_verify(ft, c, wt, ct, lv, rts), \
        "four sharded tree rejected"
    return {}


def phase_four_sumcheck(P: int = 4, nv: int = 20, card: str = "",
                        seed: int = 9):
    from jax.sharding import NamedSharding

    from stark_rings_tpu.fields import GOLDILOCKS as F
    from stark_rings_tpu.mle.sumcheck import sumcheck_prove_with_challenges
    from stark_rings_tpu.parallel import ShardedMLE, make_mesh

    mesh = make_mesh(P)
    sm = ShardedMLE(F, nv, mesh)
    fn = sm.make_sumcheck_fn()
    rng = np.random.default_rng(seed)
    G = rng.integers(0, F.q, (1 << nv,), dtype=np.uint64)
    H = rng.integers(0, F.q, (1 << nv,), dtype=np.uint64)
    ch = [jnp.asarray(np.uint64(v)) for v in
          rng.integers(0, F.q, (nv,), dtype=np.uint64)]
    sh = NamedSharding(mesh, sm.spec())
    Gs, Hs = jax.device_put(G, sh), jax.device_put(H, sh)
    got, t = steady(fn, Gs, Hs, *ch)
    report("four", f"ShardedMLE sumcheck P={P} nv={nv}", t, card, 1,
           "proofs")
    one = jax.devices()[0]
    want, t1 = steady(jax.jit(lambda g, h: sumcheck_prove_with_challenges(
        F, g, h, ch)), jax.device_put(G, one), jax.device_put(H, one))
    report("four", f"one-card sumcheck nv={nv}", t1, card, 1, "proofs")
    for x, y, what in zip(got, want, ("messages", "g(r)", "h(r)")):
        _eq(x, y, f"four sumcheck {what}")
    return {}


FOUR_PHASES = {
    "four_ntt": phase_four_ntt,
    "four_tree": phase_four_tree,
    "four_sumcheck": phase_four_sumcheck,
}


# -- driver ----------------------------------------------------------------------
def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    if four and len(jax.devices()) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1

    from stark_rings_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    card = card_label()
    print(f"card: {card}", flush=True)
    phases = FOUR_PHASES if four else PHASES
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            fn(card=card)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s "
                  "(compile included)", flush=True)
        except Exception:  # noqa: BLE001 — every phase runs; any failure fails the run
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
