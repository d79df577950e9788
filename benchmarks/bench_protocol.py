#!/usr/bin/env python
"""Protocol-layer throughput on the device: the operations a
lattice-folding prover actually spends time in, above the raw ring
multiply — Ajtai commitments (ring mat-vec), gadget decomposition,
batched monomial range checks, and 20-var MLE evaluation.

Timing: in-module dependent chains, depth-differenced (see bench.py
chain_rate) — net of the per-dispatch cost.

Writes chiprun_out/PROTO.json and prints it.  Budget-guarded
like bench.py: SRT_PROTO_BUDGET_S (default 900 s) bounds the run; the
artifact is (re)written after EVERY section and a watchdog thread emits
whatever has been measured and exits 0 at the deadline, so a timeout can
never lose the finished sections.  The persistent compile cache makes
re-runs cheap.

Run:  python benchmarks/bench_protocol.py
"""
import json
import os
import pathlib
import random
import sys
import threading
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

BUDGET_S = float(os.environ.get("SRT_PROTO_BUDGET_S", "900"))
DEADLINE = time.monotonic() + BUDGET_S
ARTIFACT = pathlib.Path(__file__).resolve().parent.parent / "chiprun_out" \
    / "PROTO.json"


def main():
    import jax
    import jax.numpy as jnp

    from bench import chain_rate, device_info
    from stark_rings_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from stark_rings_tpu.decomp import gadget_decompose
    from stark_rings_tpu.linalg import FieldElems, Matrix, RingElems
    from stark_rings_tpu.mle import DenseMLE
    from stark_rings_tpu.rings import get_ring
    from stark_rings_tpu.rings.monomial import psi_range_check_batched

    out = {"budget_s": BUDGET_S, **device_info()}
    ARTIFACT.parent.mkdir(exist_ok=True)
    # the watchdog thread serializes `out` while the main thread inserts
    # keys; json.dumps iterating a dict that grows raises RuntimeError
    # and would kill the deadline enforcement — all writes AND dumps
    # hold this lock
    out_lock = threading.Lock()

    def setk(key, val):
        with out_lock:
            out[key] = val

    def flush():
        with out_lock:
            line = json.dumps(out)
        ARTIFACT.write_text(line + "\n")

    def watchdog():
        while True:
            left = DEADLINE - time.monotonic()
            if left <= 0:
                break
            time.sleep(min(left, 5.0))
        setk("budget_expired", True)
        with out_lock:
            line = json.dumps(out)
        ARTIFACT.write_text(line + "\n")
        print(line)
        sys.stdout.flush()
        os._exit(0)

    threading.Thread(target=watchdog, daemon=True).start()

    rng = random.Random(11)
    nrng = np.random.default_rng(11)

    # ---- Ajtai commitment: c = A s over NTT-form goldilocks elements ----
    ring = get_ring("goldilocks")
    f = ring.field
    e = RingElems(ring)
    n, L = 8, 1024                      # commitment rows x witness length
    A = Matrix(e, np.asarray(ring.rand_ntt((n, L), rng)))

    W = 16                              # witness batch per chain step

    # transposed mat-vec with lazy broadcasts and the contraction axis
    # major (ops/model_mul.matvec_t): measured 35.1k vs 28.5k commits/s
    # for the batch-leading formulation (e29b); gated equal to it below.
    from stark_rings_tpu.ops.model_mul import TModelMul

    tm = TModelMul(ring)
    At = jax.device_put(jnp.moveaxis(jnp.asarray(A.vals), -1, 0))

    def commit_step_lead(s):
        # c[w, r] = sum_l A[r,l]*s[w,l], batch-leading reference shape
        prod = ring.ntt_mul(A.vals[None], s[:, None])      # [W,n,L,D]
        c = f.sum(prod, axis=2)                            # [W,n,D]
        return ring.ntt_mul(s, jnp.broadcast_to(c[:, :1], s.shape))

    def commit_step_t(s):                                  # s [D, W, L]
        c = tm.matvec_t(At, s)                             # [D, W, n]
        return tm.ntt_mul_bt(s, c[:, :, 0][:, :, None])

    def build_commit(depth):
        s = jax.device_put(
            tm.to_t(jnp.asarray(np.asarray(ring.rand_ntt((W, L), rng)))))

        def fn(s):
            for _ in range(depth):
                s = commit_step_t(s)
            return s
        return jax.jit(fn), (s,)

    try:
        s0 = jnp.asarray(np.asarray(ring.rand_ntt((W, L), rng)))
        want = ring.decode(jax.jit(commit_step_lead)(s0))
        got = ring.decode(tm.from_t(jax.jit(commit_step_t)(tm.to_t(s0))))
        assert got.tolist() == want.tolist(), "commit paths disagree"
        rate, _ = chain_rate(build_commit, W, lo=2, hi=34, reps=3)
        setk("ajtai_commit_n8_L1024_per_s", round(rate, 2))
        setk("ajtai_commit_layout", "matvec_t_lazy")
    except Exception as exc:  # noqa
        print(f"commit bench failed: {exc}", file=sys.stderr)
        setk("ajtai_commit_n8_L1024_per_s", None)
    flush()

    # ---- gadget decomposition throughput (coeff-form witnesses) --------
    B, base, k = 4096, 256, 9

    def build_decomp(depth):
        x = jax.device_put(nrng.integers(0, f.q, size=(B, ring.D),
                                         dtype=np.uint64))

        def fn(x):
            for _ in range(depth):
                digits = gadget_decompose(f, x, base, k)   # [B*k, D]
                # dependent re-entry: fold digits back into an element
                x = f.add(x, digits.reshape(B, k, ring.D)[:, 0])
            return x
        return jax.jit(fn), (x,)

    try:
        rate, _ = chain_rate(build_decomp, B, lo=1, hi=9, reps=3)
        setk("gadget_decompose_elems_per_s", round(rate, 1))
    except Exception as exc:  # noqa
        print(f"decomp bench failed: {exc}", file=sys.stderr)
        setk("gadget_decompose_elems_per_s", None)
    flush()

    # ---- batched psi range check (monomial.rs:82-93 on tensors) --------
    # ct(psi * X^p) is a precomputed D-entry table gather, not a D^2
    # coeff_mul per element — batch and depth sized so the fast path
    # still produces a tens-of-ms differenced signal
    fr = get_ring("frog")
    Brc = 32768

    def build_rc(depth):
        digits = jax.device_put(np.asarray(
            fr.encode_coeffs(np.array([[rng.randrange(-2, 3) % fr.q
                                        for _ in range(fr.D)]
                                       for _ in range(Brc)],
                                      dtype=object))))

        def fn(d):
            acc = jnp.zeros((), jnp.uint32)
            for _ in range(depth):
                ok = psi_range_check_batched(fr, d)
                acc = acc + ok.sum().astype(jnp.uint32)
                d = fr.field.add(d, jnp.zeros_like(d) + acc.astype(d.dtype))
            return d
        return jax.jit(fn), (digits,)

    try:
        rate, _ = chain_rate(build_rc, Brc, lo=2, hi=66, reps=3)
        setk("psi_range_check_elems_per_s", round(rate, 1))
    except Exception as exc:  # noqa
        print(f"range-check bench failed: {exc}", file=sys.stderr)
        setk("psi_range_check_elems_per_s", None)
    flush()

    # ---- 20-var dense MLE full evaluation (config 4's hot loop) --------
    fe = FieldElems(f)
    nv = 20

    def build_mle(depth):
        evals = jax.device_put(nrng.integers(0, f.q, size=(1 << nv,),
                                             dtype=np.uint64))
        pts = [jax.device_put(np.uint64(rng.randrange(f.q)))
               for _ in range(nv)]

        def fn(ev, pts):
            for _ in range(depth):
                m = DenseMLE(fe, nv, ev)
                v = m.evaluate(list(pts))
                # dependent: shift the table by the value
                ev = f.add(ev, jnp.broadcast_to(v, ev.shape))
            return ev
        return jax.jit(fn), (evals, pts)

    try:
        rate, _ = chain_rate(build_mle, 1, lo=1, hi=5, reps=3)
        setk("mle20_full_evaluate_xla_halving_per_s", round(rate, 2))
    except Exception as exc:  # noqa
        print(f"mle bench failed: {exc}", file=sys.stderr)
        setk("mle20_full_evaluate_xla_halving_per_s", None)
    flush()

    # ---- same, via the int8 two-contraction path (mle/mxu_eval) --------
    from stark_rings_tpu.mle.mxu_eval import evaluate_goldilocks_mxu

    def build_mle_mxu(depth):
        evals = jax.device_put(nrng.integers(0, f.q, size=(1 << nv,),
                                             dtype=np.uint64))
        pts = [np.uint64(rng.randrange(f.q)) for _ in range(nv)]

        def fn(ev):
            for _ in range(depth):
                v = evaluate_goldilocks_mxu(ev, pts)
                ev = f.add(ev, jnp.broadcast_to(v, ev.shape))
            return ev
        return jax.jit(fn), (evals,)

    try:
        rate, _ = chain_rate(build_mle_mxu, 1, lo=2, hi=258, reps=3)
        setk("mle20_full_evaluate_mxu_per_s", round(rate, 2))
    except Exception as exc:  # noqa
        print(f"mle mxu bench failed: {exc}", file=sys.stderr)
        setk("mle20_full_evaluate_mxu_per_s", None)
    flush()

    # ---- point-BATCHED evaluation: one shared table contraction --------
    from stark_rings_tpu.mle.mxu_eval import evaluate_many_goldilocks_mxu

    W = 16

    def build_mle_many(depth):
        evals = jax.device_put(nrng.integers(0, f.q, size=(1 << nv,),
                                             dtype=np.uint64))
        P = jax.device_put(nrng.integers(0, f.q, size=(W, nv),
                                         dtype=np.uint64))

        def fn(ev, P):
            for _ in range(depth):
                v = evaluate_many_goldilocks_mxu(ev, P)
                # dependent re-entry: perturb table AND points
                ev = f.add(ev, jnp.broadcast_to(v[0], ev.shape))
                P = f.add(P, jnp.broadcast_to(v[:1, None], P.shape))
            return ev
        return jax.jit(fn), (evals, P)

    try:
        rate, _ = chain_rate(build_mle_many, W, lo=2, hi=34, reps=3)
        setk(f"mle20_evaluate_many_W{W}_points_per_s", round(rate, 2))
    except Exception as exc:  # noqa
        print(f"mle many bench failed: {exc}", file=sys.stderr)
        setk(f"mle20_evaluate_many_W{W}_points_per_s", None)
    flush()

    # ---- full 20-var sumcheck prover arithmetic (one jit module) -------
    from stark_rings_tpu.mle.sumcheck import sumcheck_prove_with_challenges

    nv_sc = 20

    def build_sumcheck(depth):
        G0 = jax.device_put(nrng.integers(0, f.q, size=(1 << nv_sc,),
                                          dtype=np.uint64))
        H0 = jax.device_put(nrng.integers(0, f.q, size=(1 << nv_sc,),
                                          dtype=np.uint64))
        chals = [jax.device_put(np.uint64(rng.randrange(f.q)))
                 for _ in range(nv_sc)]

        def fn(G, H):
            for _ in range(depth):
                msgs, gv, hv = sumcheck_prove_with_challenges(
                    f, G, H, chals)
                # dependent re-entry: perturb the tables by the outputs
                G = f.add(G, jnp.broadcast_to(gv, G.shape))
                H = f.add(H, jnp.broadcast_to(f.add(hv, msgs[0, 0]),
                                              H.shape))
            return G
        return jax.jit(fn), (G0, H0)

    try:
        rate, _ = chain_rate(build_sumcheck, 1, lo=2, hi=34, reps=3)
        setk("sumcheck20_product_proofs_per_s", round(rate, 2))
    except Exception as exc:  # noqa
        print(f"sumcheck bench failed: {exc}", file=sys.stderr)
        setk("sumcheck20_product_proofs_per_s", None)
    flush()

    # ---- folding combine: w' = c*w + v with a FIXED challenge c --------
    # the LatticeFold-line fold step over deg-2^16 witnesses; c's forward
    # transform is cached once (mul_cached), so each combine is one
    # forward + slot product + one inverse + an add.
    from stark_rings_tpu.rings import get_power_ring

    Nbig, Bw = 1 << 16, 80
    tp = get_power_ring("goldilocks", 16).mxu_ctx()
    cbig = jax.device_put(tp.consts())

    def build_fold(depth):
        w = jax.device_put(nrng.integers(0, f.q, size=(Bw, Nbig),
                                         dtype=np.uint64))
        v = jax.device_put(nrng.integers(0, f.q, size=(Bw, Nbig),
                                         dtype=np.uint64))
        ch = jax.device_put(nrng.integers(0, f.q, size=(1, Nbig),
                                          dtype=np.uint64))
        vc = jax.jit(lambda cc, y: tp.precompute(y, cc))(cbig, ch)

        def fn(cc, w, v, vc):
            for _ in range(depth):
                w = f.add(tp.mul_cached(w, vc, cc), v)
            return w
        return jax.jit(fn), (cbig, w, v, vc)

    try:
        rate, _ = chain_rate(build_fold, Bw, lo=2, hi=8, reps=3)
        setk("fold_combine_deg2^16_witnesses_per_s", round(rate, 1))
    except Exception as exc:  # noqa
        print(f"fold combine bench failed: {exc}", file=sys.stderr)
        setk("fold_combine_deg2^16_witnesses_per_s", None)
    flush()

    # ---- composed folding step (protocol/folding.py): ONE jit module ---
    # challenge fold + icrt + gadget decompose + traced exact L2 + crt +
    # Ajtai digit commitment, all inside one trace.  The per-stage rates
    # above leave dispatch fusion on the table; this is the rate a prover
    # actually gets per folding step.
    from stark_rings_tpu.protocol import FoldingStep

    Lf, nf = 1024, 8
    # psi ON: the full LatticeFold-style step includes its range proof
    # (monomial.rs:79-93); the nopsi variant measures what it costs
    fs_psi = FoldingStep(ring, n_rows=nf, wit_len=Lf, base=256,
                         psi_check=True)
    fs_nopsi = FoldingStep(ring, n_rows=nf, wit_len=Lf, base=256)

    def build_foldstep_W(fs, Wf):
        def build(depth):
            r2 = random.Random(13)
            cP = jax.device_put(fs.init_tables(r2))
            rt = jax.device_put(
                fs.precompute_challenge(ring.rand_coeff((), r2)))
            s0 = jax.device_put(fs.rand_witness(Wf, r2))
            s1 = jax.device_put(fs.rand_witness(Wf, r2))
            c0 = jax.device_put(fs.tm.to_t(jnp.asarray(
                np.asarray(ring.rand_ntt((Wf, nf), r2)))))
            c1 = jax.device_put(fs.tm.to_t(jnp.asarray(
                np.asarray(ring.rand_ntt((Wf, nf), r2)))))

            def fn(cP, s0, s1, c0, c1, rt):
                for _ in range(depth):
                    o = fs.step(cP, s0, s1, c0, c1, rt)
                    # dependent chain: folded witness + digit commitment
                    # feed the next step; the L2 check bit perturbs an
                    # operand so no stage can be elided
                    mask = o["ok_l2"].astype(jnp.uint64)[None, :, None]
                    if fs.psi_check:
                        mask = mask + o["ok_psi"].astype(
                            jnp.uint64)[None, :, None]
                    s1 = f.add(s1, mask)
                    s0, c0 = o["s"], o["cd"]
                return s0
            return jax.jit(fn), (cP, s0, s1, c0, c1, rt)
        return build

    # W=8 and W=16 witnesses per step, with and without the range check
    for key, fs, Wf in (
            ("folding_step_composed_psi_W8_L1024_per_s", fs_psi, 8),
            ("folding_step_composed_psi_W16_L1024_per_s", fs_psi, 16),
            ("folding_step_composed_W8_L1024_per_s", fs_nopsi, 8)):
        try:
            rate, _ = chain_rate(build_foldstep_W(fs, Wf), Wf, lo=1,
                                 hi=5, reps=3)
            setk(key, round(rate, 2))
        except Exception as exc:  # noqa
            print(f"folding step {key} bench failed: {exc}",
                  file=sys.stderr)
            setk(key, None)
        flush()
    setk("folding_step_stages", "challenge_fold+icrt+gadget_decompose"
         "+l2_check+crt+commit_n8+psi_range_check")
    flush()

    # ---- multi-level folding tree (protocol.FoldingTree) -----------------
    # 16 committed witnesses fold pairwise to one in ONE jit module (4
    # chained composed steps, W = 8+4+2+1 = 15 step-witnesses); rate in
    # LEAVES folded per second.  psi is auto-off on goldilocks (non-
    # power-of-two cyclotomic; examples/folding_tree.py runs the psi-
    # complete frog tree with a full verifier).
    from stark_rings_tpu.protocol import FoldingTree

    Wt, Lt = 16, 256
    ft = FoldingTree(ring, n_rows=nf, wit_len=Lt, base=256)

    def build_tree(depth):
        r2 = random.Random(29)
        cT = jax.device_put(ft.init_tables(r2))
        rts = [jax.device_put(r) for r in ft.precompute_challenges(
            [jnp.asarray(ring.rand_coeff((), r2))
             for _ in range(Wt.bit_length() - 1)])]
        wt = jax.device_put(ft.rand_witnesses(Wt, r2))
        ct = jax.jit(ft.commit_witnesses)(cT, wt)

        def fn(cT, wt, ct, rts):
            for _ in range(depth):
                levels, rw, rc = ft.prove(cT, wt, ct, rts)
                # dependent chain: the root witness perturbs the leaves
                wt = f.add(wt, jnp.broadcast_to(rw[:, :1], wt.shape))
                ct = f.add(ct, jnp.broadcast_to(rc[:, :1], ct.shape))
            return wt
        return jax.jit(fn), (cT, wt, ct, rts)

    try:
        rate, _ = chain_rate(build_tree, Wt, lo=1, hi=5, reps=3)
        setk(f"folding_tree_W{Wt}_L{Lt}_leaves_per_s", round(rate, 2))
    except Exception as exc:  # noqa
        print(f"folding tree bench failed: {exc}", file=sys.stderr)
        setk(f"folding_tree_W{Wt}_L{Lt}_leaves_per_s", None)
    flush()

    line = json.dumps(out)
    print(line)
    flush()


if __name__ == "__main__":
    main()
